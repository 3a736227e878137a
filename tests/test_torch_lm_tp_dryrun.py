"""The dry run's count of the tensor-parallel train step (ROADMAP item 19a):
qwen3-0.6b × ``train_4k`` (256 × 4,096) on the production mesh, a fake
16 × 16 ``('data','model')`` group, under ``fsdp`` and under ``dp``.

Under ``fsdp`` each device holds 256 / 16 = 16 sequences and multiplies a
sixteenth of every projection (q, k, v, o, the MLP, the tied table's rows);
under ``dp`` it holds one sequence and multiplies every weight whole.  The
per-device matmul flops worked out from the specs are then equal for the
two, a sixteenth of a step that gathers every weight whole, and the dry run must
count them within 1 %.  The logits stay vocab-sharded: no all-gather in the
step is as large as the (B, S, V) logits.  The cells run in one subprocess
(the dry run needs a process without a process group)."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, SHAPE, MESH = "qwen3-0.6b", "train_4k", (16, 16)

_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import plan_cell
    from repro_torch.train import TrainConfig

    arch, shape = sys.argv[1], sys.argv[2]
    out = {}
    dryrun._fake_group(256)
    try:
        mesh = dryrun._mesh_for(False, None)
        for profile in ("fsdp", "dp"):
            plan = plan_cell(get_config(arch), SHAPES[shape], mesh,
                             train_cfg=TrainConfig(sharding_profile=profile))
            run = dryrun.run_plan(plan, mesh)
            out[profile] = {"flops": run["cost"]["flops"], "records": run["records"],
                            "parallelism": plan.parallelism, "seconds": run["seconds"]}
    finally:
        dist.destroy_process_group()
    print(json.dumps(out))
""")


def worked_flops(cfg, batch: int, seq: int, model: int, block: int = 1024) -> int:
    """Per-device matmul flops of one train step of a dense GQA model whose
    projections, heads and vocabulary divide ``model`` (each device: its
    ``batch`` sequences, a ``1/model`` share of each product), under
    ``remat="full"``: each block's products run in the forward, again in
    the recompute (less the last, the MLP's down projection: the recompute
    stops once the backward's saved inputs are rebuilt) and twice in the
    backward; the logits once forward and twice backward.  Attention counts
    the causal block-wise loop's ``(S/block)(S/block + 1)/2`` tiles, scores
    and weighted sum each ``2·block²·hd`` a head."""
    hd, d = cfg.resolved_head_dim, cfg.d_model
    q, kv = cfg.n_heads * hd // model, cfg.n_kv_heads * hd // model
    f, vocab = cfg.d_ff // model, cfg.vocab_size // model
    tokens = batch * seq
    proj = 2 * tokens * d * (2 * q + 2 * kv + 3 * f)          # q, o, k, v, gate, up, down
    n = seq // block
    attn = 2 * 2 * batch * (cfg.n_heads // model) * block * block * hd * n * (n + 1) // 2
    layer = 4 * (proj + attn) - 2 * tokens * f * d
    return cfg.n_layers * layer + 3 * 2 * tokens * d * vocab


@pytest.fixture(scope="module")
def counted():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", _SCRIPT, ARCH, SHAPE], capture_output=True,
                       text=True, env=env, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _worked(profile: str) -> int:
    shape, (data, model) = SHAPES[SHAPE], MESH
    if profile == "dp":        # the batch over both axes, every weight whole
        return worked_flops(get_config(ARCH), shape.global_batch // (data * model),
                            shape.seq_len, 1)
    return worked_flops(get_config(ARCH), shape.global_batch // data, shape.seq_len, model)


@pytest.mark.parametrize("profile", ("fsdp", "dp"))
def test_per_device_flops_equal_the_worked_count(counted, profile):
    got, want = counted[profile]["flops"], _worked(profile)
    assert abs(got - want) <= 0.01 * want, (got, want)
    assert counted[profile]["parallelism"] == ("tensor-parallel" if profile == "fsdp"
                                               else "gather-on-use")


def test_tensor_parallel_divides_the_flops_by_the_model_axis(counted):
    shape, (data, model) = SHAPES[SHAPE], MESH
    gathered = worked_flops(get_config(ARCH), shape.global_batch // data, shape.seq_len, 1)
    assert gathered / counted["fsdp"]["flops"] == pytest.approx(model, rel=0.01)
    assert counted["fsdp"]["flops"] == counted["dp"]["flops"]


def test_no_all_gather_of_the_logits(counted):
    cfg, shape, (data, _) = get_config(ARCH), SHAPES[SHAPE], MESH
    logits_bytes = shape.global_batch // data * shape.seq_len * cfg.vocab_size * 2   # bf16
    gathers = [b for kind, b, _ in counted["fsdp"]["records"] if kind == "all-gather"]
    assert gathers and max(gathers) < logits_bytes // 16, max(gathers)
