"""The dry run and the layer extrapolation (ROADMAP item 18d):
``repro_torch.launch.{dryrun,extrapolate}`` against the JAX package's.

The reference compiles each cell against 512 placeholder XLA devices and
parses the HLO's collectives; the port runs each cell's plan on fake tensors
in a ``fake`` process group and counts the functional collectives it
calls.  ``count_collectives`` applies the reference's formulas, so it is
held against ``parse_collectives`` on HLO lines carrying the same
collectives.  The dry run needs a process without a process group, so the
cells run in one subprocess: the extrapolation of a dense, a hybrid and a
VLM smoke config against their direct counts (within the reference's own
2 %), ``run_cell`` on a fake 2 × 2 × 2 mesh writing the reference's keys for
a train and a decode cell, and a prefill plan at a shorter sequence (the
32k prefill's attention loop takes half a minute of fake ops)."""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch.distributed as dist

from repro.launch import extrapolate as JX
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import dryrun as TD
from repro_torch.launch import extrapolate as TX

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("qwen3-0.6b", "hymba-1.5b", "llama-3.2-vision-11b")
COST_KEYS = ("flops", "bytes accessed", "transcendentals", "coll_operand", "coll_wire")

_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch.distributed as dist
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun, extrapolate
    from repro_torch.launch.specs import plan_cell

    out = {"cells": {}}
    for shape in ("train_4k", "decode_32k"):
        out["cells"][shape] = dryrun.run_cell("qwen3-0.6b", shape, True, verbose=False,
                                              analysis="extrapolate" if shape == "decode_32k"
                                              else True, smoke=True, mesh_dims=(2, 2, 2))
    dryrun._fake_group(4)
    try:
        mesh = dryrun._mesh_for(False, (2, 2))
        plan = plan_cell(get_smoke_config("qwen3-0.6b"), ShapeSpec("p", 256, 8, "prefill"), mesh)
        prefill = dryrun.run_plan(plan, mesh)
        out["cells"]["prefill"] = dict(prefill, ok=True, seconds=None,
                                       parallelism=plan.parallelism)
        shape = ShapeSpec("t", 32, 8, "train")
        for arch in sys.argv[1:]:
            cfg = get_smoke_config(arch)
            run = dryrun.run_plan(plan_cell(cfg, shape, mesh), mesh)
            direct = dict(run["cost"], coll_operand=run["collectives"]["total_operand_bytes"],
                          coll_wire=run["collectives"]["total_wire_bytes"])
            est = extrapolate.extrapolate_cell(cfg, shape, mesh, dryrun.count_collectives)
            out[arch] = {"direct": direct, "extrapolated": est}
    finally:
        dist.destroy_process_group()
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def counted():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", _SCRIPT, *ARCHS], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _reference_dryrun():
    """The reference's dry-run module; its import sets ``XLA_FLAGS`` for
    512 placeholder devices, which is put back at once (this process's JAX
    keeps its one device and no subprocess inherits the flag)."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as JD
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return JD


def test_count_collectives_applies_the_reference_formulas():
    JD = _reference_dryrun()
    ops = {"all-gather": "all-gather", "all-reduce": "all-reduce",
           "reduce-scatter": "reduce-scatter", "all-to-all": "all-to-all",
           "collective-permute": "collective-permute"}
    records, lines = [], []
    for i, (kind, op) in enumerate(ops.items()):
        for j, (n, g) in enumerate(((1024, 16), (48, 2), (4096, 512), (7, 3))):
            records.append((kind, 4 * n, g))
            groups = (f"replica_groups=[{512 // g},{g}]<=[512]" if j % 2 == 0 else
                      "replica_groups={{" + ",".join(map(str, range(g))) + "}}")
            lines.append(f"  %c{i}_{j} = f32[{n}]{{0}} {op}(f32[{n}]{{0}} %x), {groups}")
    records.append(("all-gather", 2 * 4 * 8, 4))
    lines.append("  %ag = bf16[4,8]{1,0} all-gather-start(bf16[1,8] %y), "
                 "replica_groups=[128,4]<=[512]")
    lines.append("  %agd = bf16[4,8]{1,0} all-gather-done(%ag)")
    assert TD.count_collectives(records) == JD.parse_collectives("\n".join(lines))


def test_cell_filename_is_the_reference_s():
    JD = _reference_dryrun()
    for arch, shape, pod in (("qwen3-0.6b", "train_4k", False),
                             ("phi3.5-moe-42b-a6.6b", "decode_32k", True)):
        assert TD.cell_filename(arch, shape, pod) == JD.cell_filename(arch, shape, pod)


def test_layer_fit_is_the_reference_s():
    m2 = {"flops": 10.0, "coll_operand": 7.0, "bytes accessed": 3.0}
    m4 = {"flops": 16.0, "coll_operand": 7.0, "bytes accessed": 1.0}
    for L in (2, 3, 28, 64):
        assert TX._lin(m2, m4, 2, 4, L) == JX._lin(m2, m4, 2, 4, L)
    cfg = get_config("hymba-1.5b")
    assert TX._reduced(cfg, 4, global_layers=(0,)).n_layers == 4
    assert TX._reduced(cfg, 4, global_layers=(0,)).global_layers == (0,)


@pytest.mark.parametrize("arch", ARCHS)
def test_extrapolation_matches_the_direct_count(counted, arch):
    """The reference validates its fit against full unrolled compiles
    within 2 %; the port's forward is a loop, so the direct count is exact
    and the fit must land within the same 2 %."""
    direct, est = counted[arch]["direct"], counted[arch]["extrapolated"]
    assert direct["flops"] > 0 and direct["coll_operand"] > 0
    for k in COST_KEYS:
        assert abs(est[k] - direct[k]) <= 0.02 * direct[k], (k, est[k], direct[k])


def test_prefill_plan_runs_gathered_on_use(counted):
    """The prefill plan under ``fsdp`` (ROADMAP item 19b): each weight
    gathered on use over the fsdp axis only, and the forward tensor-parallel
    over 'model': one all-reduce for the vocab-parallel embedding and two a
    layer (attention's and the MLP's row-parallel sums), no other (no
    gradient, no loss sums)."""
    rec = counted["cells"]["prefill"]
    assert rec["parallelism"] == "tensor-parallel"
    assert rec["cost"]["flops"] > 0
    assert rec["collectives"]["all-gather"]["count"] > 0
    n_layers = get_smoke_config("qwen3-0.6b").n_layers
    assert rec["collectives"]["all-reduce"]["count"] == 1 + 2 * n_layers
    assert rec["memory"]["output_size_in_bytes"] > 0


@pytest.mark.parametrize("shape", ("train_4k", "decode_32k"))
def test_run_cell_writes_the_reference_keys(counted, shape):
    rec = counted["cells"][shape]
    assert rec["ok"], rec.get("traceback")
    assert {"arch", "shape", "mesh", "multi_pod", "n_devices", "ok", "time_lower_s",
            "time_compile_s", "memory", "cost", "collectives"} <= set(rec)
    assert rec["mesh"] == "pod=2 × data=2 × model=2" and rec["n_devices"] == 8
    # the train step computes tensor-parallel over 'model' (ROADMAP item
    # 19a), and so does the decode plan (item 19b)
    assert rec["parallelism"] == "tensor-parallel"
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["memory"]["output_size_in_bytes"] > 0
    assert "temp_size_in_bytes" not in rec["memory"]
    assert set(rec["cost"]) == {"flops", "bytes accessed", "transcendentals"}
    assert rec["cost"]["flops"] > 0
    coll = rec["collectives"]
    assert coll["all-gather"]["count"] > 0          # the weights, gathered over 'data' on use
    assert coll["total_operand_bytes"] == sum(v["operand_bytes"] for v in coll.values()
                                              if isinstance(v, dict))
    if shape == "train_4k":
        # the gradients summed over 'data', and the po2 pod mean's int8
        # all-gather over 'pod' on top of the weight gathers
        assert coll["all-reduce"]["count"] > 0
        assert coll["all-gather"]["count"] > len(rec["memory"]) and rec["cost_unrolled"] == \
            rec["cost"]
    else:
        assert set(rec["cost_extrapolated"]) == {"flops", "bytes accessed", "transcendentals"}
        assert rec["collectives_extrapolated"]["total_operand_bytes"] > 0


def test_dry_run_refuses_a_process_that_holds_a_group(monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="process of its own"):
        TD.run_cell("qwen3-0.6b", "train_4k", False, smoke=True)


def test_dry_run_without_the_fake_backend_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.testing._internal.distributed.fake_pg", None)
    with pytest.raises(RuntimeError, match="fake process group"):
        TD._fake_group(4)
    assert not dist.is_initialized()
