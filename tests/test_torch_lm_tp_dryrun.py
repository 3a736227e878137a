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


# ---------------------------------------------------------------------------
# ROADMAP item 19b: the decode plan and the SSM mixer on the same fake mesh
# ---------------------------------------------------------------------------
#
# qwen3-0.6b × ``decode_32k`` (B = 128, T = 32,768): under ``fsdp`` each
# device decodes 128 / 16 = 8 rows; the 8 kv heads do not divide 16, so the
# cache's T goes on 'model' (2,048 slots a device) and every q head scores
# the rank's slots; every projection and the tied head multiply a sixteenth.
# Under ``dp`` (gather-on-use) each device gathers the weights, the cache
# and the tokens whole and decodes the whole batch: 256× the flops.
#
# mamba2-1.3b × ``train_4k`` at one and two layers (the difference is one
# layer): under ``fsdp`` each device runs a sixteenth of the mixer (4 of 64
# heads) on 16 sequences, under ``dp`` the whole mixer on one sequence; the
# two differ only by what every 'model' rank computes whole, on 15 more
# sequences: ``dt``'s product (``wdt`` is whole over 'model') and the SSD
# scan's C·Bᵀ within each chunk (B and C are whole on every rank, and have
# no head axis); four products a step each under remat "full".

_SCRIPT_19B = textwrap.dedent("""
    import dataclasses, json
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import plan_cell
    from repro_torch.train import TrainConfig

    out = {}
    dryrun._fake_group(256)
    try:
        mesh = dryrun._mesh_for(False, None)
        cells = [("decode", get_config("qwen3-0.6b"), "decode_32k")]
        cells += [(f"ssm{n}", dataclasses.replace(get_config("mamba2-1.3b"), n_layers=n),
                   "train_4k") for n in (1, 2)]
        for name, cfg, shape in cells:
            for profile in ("fsdp", "dp"):
                plan = plan_cell(cfg, SHAPES[shape], mesh,
                                 train_cfg=TrainConfig(sharding_profile=profile))
                run = dryrun.run_plan(plan, mesh)
                out[f"{name}/{profile}"] = {"flops": run["cost"]["flops"],
                                            "records": run["records"],
                                            "parallelism": plan.parallelism}
    finally:
        dist.destroy_process_group()
    print(json.dumps(out))
""")


def worked_decode_flops(cfg, batch: int, slots: int, model: int) -> int:
    """Per-device matmul flops of one decode step of a dense GQA model: each
    device's ``batch`` rows, a ``1/model`` share of every projection and of
    the tied head, every q head scoring ``slots`` cache slots (scores and
    weighted sum, ``2·hd`` flops a head a slot each)."""
    hd, d = cfg.resolved_head_dim, cfg.d_model
    q, kv = cfg.n_heads * hd // model, cfg.n_kv_heads * hd // model
    f, vocab = cfg.d_ff // model, cfg.vocab_size // model
    proj = 2 * batch * d * (2 * q + 2 * kv + 3 * f)            # q, o, k, v, gate, up, down
    attn = 2 * 2 * batch * cfg.n_heads * slots * hd
    return cfg.n_layers * (proj + attn) + 2 * batch * d * vocab


@pytest.fixture(scope="module")
def counted_19b():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", _SCRIPT_19B], capture_output=True, text=True,
                       env=env, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_decode_plan_divides_the_flops_by_data_and_model(counted_19b):
    cfg, shape, (data, model) = get_config(ARCH), SHAPES["decode_32k"], MESH
    rows, slots = shape.global_batch // data, shape.seq_len // model
    assert counted_19b["decode/fsdp"]["parallelism"] == "tensor-parallel"
    assert counted_19b["decode/dp"]["parallelism"] == "gather-on-use"
    sharded = worked_decode_flops(cfg, rows, slots, model)          # 4,354,080,768
    whole = worked_decode_flops(cfg, shape.global_batch, shape.seq_len, 1)
    assert counted_19b["decode/fsdp"]["flops"] == pytest.approx(sharded, rel=0.01)
    assert counted_19b["decode/dp"]["flops"] == pytest.approx(whole, rel=0.01)
    assert whole / counted_19b["decode/fsdp"]["flops"] == pytest.approx(data * model, rel=0.01)


def test_decode_plan_gathers_no_cache(counted_19b):
    """The cache stays placed: under ``fsdp`` no all-gather's result comes
    near a device's cache shard (the largest is a weight's 'model' shard
    over 'data'); gathering on use moves the whole cache."""
    cfg, shape, (data, model) = get_config(ARCH), SHAPES["decode_32k"], MESH
    cache = cfg.n_layers * shape.global_batch * shape.seq_len * cfg.n_kv_heads \
        * cfg.resolved_head_dim * 2 * 2                          # k and v, bf16: 481 GB
    shard = cache // (data * model)
    gathers = [b for kind, b, _ in counted_19b["decode/fsdp"]["records"] if kind == "all-gather"]
    assert gathers and max(gathers) < shard // 16, (max(gathers), shard)
    whole = [b for kind, b, _ in counted_19b["decode/dp"]["records"] if kind == "all-gather"]
    assert max(whole) >= cache // 2                              # k (or v) gathered whole


def test_ssm_mixer_divides_its_flops_by_the_model_axis(counted_19b):
    """One mamba2-1.3b layer of the step under ``fsdp`` (a sixteenth of the
    mixer on 16 sequences) costs the ``dp`` layer (the whole mixer on one
    sequence) plus, on 15 more sequences, what stays whole on every rank:
    the ``dt`` product and the scan's C·Bᵀ.  Gathering the mixer whole
    would cost 16 ``dp`` layers."""
    cfg, shape, (data, model) = get_config("mamba2-1.3b"), SHAPES["train_4k"], MESH
    layer = {p: counted_19b[f"ssm2/{p}"]["flops"] - counted_19b[f"ssm1/{p}"]["flops"]
             for p in ("fsdp", "dp")}
    heads = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    # forward, recompute, and the backward's two products, per sequence
    dt = 4 * 2 * shape.seq_len * cfg.d_model * heads
    cb = 4 * 2 * shape.seq_len * cfg.ssd_chunk * cfg.ssm_groups * cfg.ssm_state
    per_device = shape.global_batch // data
    assert layer["fsdp"] == pytest.approx(layer["dp"] + (per_device - 1) * (dt + cb),
                                          rel=0.001)
    # the mixer's products and its scan on the rank's heads fall 16×; what
    # stays whole keeps the layer at 14.6× below gathering the mixer whole
    gathered = per_device * layer["dp"]
    assert 14 < gathered / layer["fsdp"] < model
    assert counted_19b["ssm1/fsdp"]["parallelism"] == "tensor-parallel"
