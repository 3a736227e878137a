"""Multi-pod dry run (port of ``repro.launch.dryrun``): run every
(architecture × input shape × mesh) cell's plan against a ``fake`` process
group of 256 or 512 ranks in one process, on fake tensors, and count what
one device does.

Per cell, in a process that holds no process group (the cell joins a
``fake`` group of ``n_devices`` ranks, as rank 0, and leaves it):

    mesh   = make_production_mesh(multi_pod=..., device="cpu")
    plan   = specs.plan_cell(cfg, shape, mesh)
    with FakeTensorMode(), FlopCounterMode(), collective counter:
        plan.fn(*args placed on the mesh)

The fake group answers every collective at once and the fake tensors hold
no storage, so a full-size cell runs in seconds on the host.  The counts
are rank 0's:

  * ``cost``: ``flops`` from ``torch.utils.flop_counter``; ``bytes
    accessed`` (each aten op's tensor inputs and outputs, op by op: no
    fusion, so larger than XLA's count) and ``transcendentals`` (output
    elements of exp, log, sqrt, tanh, … ops);
  * ``collectives``: every ``_c10d_functional`` collective the step calls,
    with the reference's per-kind operand and wire formulas
    (:func:`count_collectives`);
  * ``memory``: ``argument_size_in_bytes`` and ``output_size_in_bytes``
    from the shard shapes of the inputs and outputs.  XLA's temp and alias
    sizes have no counterpart here and are not written.

The torch program is a Python loop, not a scan, so the direct count is the
exact count: ``--analysis on`` records it as the reference's
``cost_unrolled``, and ``extrapolate`` fits the reference's layer model to
2- and 4-layer runs (``launch.extrapolate``), a speed-up, never a repair.
The ``fake`` backend comes from a private PyTorch module
(``torch.testing._internal.distributed.fake_pg``): without it the dry run
raises.  It must not run in a process that already holds a default group.

Outputs one JSON per cell under ``--out`` (default ``experiments/dryrun/``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k --mesh single --analysis extrapolate
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all   # every cell, both meshes
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Shard
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config, shapes_for
from repro_torch.configs.shapes import SHAPES
from repro_torch.distributed.sharding import map_with_path, mesh_shape, use_mesh
from repro_torch.launch.mesh import describe, make_production_mesh
from repro_torch.launch.specs import plan_cell

# ---------------------------------------------------------------------------
# Collective counting
# ---------------------------------------------------------------------------

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# functional collective op → the reference's HLO collective kind
_OP_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

_TRANSCENDENTAL = frozenset({
    "exp", "exp2", "expm1", "log", "log2", "log1p", "tanh", "sigmoid", "rsqrt", "sqrt",
    "sin", "cos", "erf", "pow", "_softmax", "_log_softmax", "logsumexp", "silu", "gelu"})


def count_collectives(records) -> dict:
    """Per-kind operand and wire bytes of ``(kind, result bytes, group
    size)`` records, by the reference's formulas (``parse_collectives``):
    all-gather operand = result/g, reduce-scatter operand = result·g, the
    others operand = result; ``wire`` is the ring algorithm's per-device
    estimate (all-reduce 2·result·(g−1)/g, …)."""
    stats = {k: {"count": 0, "operand_bytes": 0, "wire_bytes": 0} for k in _COLLECTIVES}
    for kind, result_bytes, g in records:
        g = max(int(g), 1)
        if kind == "all-gather":
            operand = result_bytes // g
            wire = result_bytes * (g - 1) // g
        elif kind == "reduce-scatter":
            operand = result_bytes * g
            wire = result_bytes * (g - 1)
        elif kind == "all-reduce":
            operand = result_bytes
            wire = 2 * result_bytes * (g - 1) // g
        elif kind == "all-to-all":
            operand = result_bytes
            wire = result_bytes * (g - 1) // g
        else:  # collective-permute
            operand = result_bytes
            wire = result_bytes
        stats[kind]["count"] += 1
        stats[kind]["operand_bytes"] += operand
        stats[kind]["wire_bytes"] += wire
    stats["total_operand_bytes"] = sum(v["operand_bytes"] for v in stats.values()
                                       if isinstance(v, dict))
    stats["total_wire_bytes"] = sum(v["wire_bytes"] for v in stats.values()
                                    if isinstance(v, dict))
    return stats


def _nbytes(x) -> int:
    if isinstance(x, DTensor):
        x = x.to_local()
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _tensors(tree) -> list:
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


class _Counter(TorchDispatchMode):
    """Records every functional collective as ``(kind, result bytes, group
    size)``, sums each aten op's tensor bytes in and out, and counts the
    output elements of transcendental ops."""

    def __init__(self):
        super().__init__()
        self.collectives: list[tuple[str, int, int]] = []
        self.bytes_accessed = 0
        self.transcendentals = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ns, name = func.namespace, func._opname
        if ns in ("_c10d_functional", "c10d_functional"):
            if name in _OP_KINDS:
                from torch.distributed.distributed_c10d import _resolve_process_group
                group = [a for a in args if isinstance(a, str)][-1]
                g = _resolve_process_group(group).size()
                self.collectives.append((_OP_KINDS[name], sum(map(_nbytes, _tensors(out))), g))
            return out
        if ns == "aten":
            self.bytes_accessed += sum(map(_nbytes, _tensors((args, kwargs, out))))
            if name.rstrip("_") in _TRANSCENDENTAL:
                self.transcendentals += sum(t.numel() for t in _tensors(out))
        return out


# ---------------------------------------------------------------------------
# Running a plan on fake tensors
# ---------------------------------------------------------------------------

def _local_shape(shape, placements, mesh) -> tuple[int, ...]:
    sizes = tuple(mesh_shape(mesh).values())
    out = list(shape)
    for md, pl in enumerate(placements):
        if isinstance(pl, Shard):
            out[pl.dim] //= sizes[md]
    return tuple(out)


def _place(arg, shardings, mesh):
    """An abstract (meta) argument tree as fake tensors, each leaf a DTensor
    shard by its sharding (a 0-d leaf, or one without a sharding, plain)."""
    if not isinstance(arg, (torch.Tensor, dict, tuple, list)):
        return arg
    by_path: dict = {}
    if shardings is not None:
        map_with_path(by_path.__setitem__, shardings)

    def leaf(path, x):
        sh = by_path.get(path)
        if sh is None or x.dim() == 0:
            return torch.empty(x.shape, dtype=x.dtype)
        pl = sh.placements
        local = torch.empty(_local_shape(tuple(x.shape), pl, mesh), dtype=x.dtype)
        return DTensor.from_local(local, mesh, pl, run_check=False)
    return map_with_path(leaf, arg)


def run_plan(plan, mesh) -> dict:
    """Run a cell's plan once on fake tensors placed on ``mesh`` and count
    it: ``{"cost", "collectives", "memory", "seconds", "records"}``, the
    last every collective's ``(kind, result bytes, group size)`` in order."""
    t0 = time.perf_counter()
    # the kernels' cached constants are real tensors
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = tuple(_place(a, sh, mesh) for a, sh in zip(plan.args, plan.in_shardings))
        counter, flops = _Counter(), FlopCounterMode(display=False)
        with use_mesh(mesh), flops, counter:
            out = plan.fn(*args)
        memory = {"argument_size_in_bytes": sum(map(_nbytes, _tensors(args))),
                  "output_size_in_bytes": sum(map(_nbytes, _tensors(out)))}
    return {"cost": {"flops": float(flops.get_total_flops()),
                     "bytes accessed": float(counter.bytes_accessed),
                     "transcendentals": float(counter.transcendentals)},
            "collectives": count_collectives(counter.collectives), "memory": memory,
            "seconds": time.perf_counter() - t0, "records": counter.collectives}


def _fake_group(n_devices: int) -> None:
    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process of its own: this one already holds a "
                           "default process group")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("the dry run needs PyTorch's fake process group "
                           "(torch.testing._internal.distributed.fake_pg), which this "
                           "PyTorch lacks") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n_devices)


def _mesh_for(multi_pod: bool, shape: tuple[int, ...] | None):
    if shape is None:
        return make_production_mesh(multi_pod=multi_pod, device="cpu")
    from torch.distributed.device_mesh import init_device_mesh
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=names)


# ---------------------------------------------------------------------------
# Per-cell dry run
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, multi_pod: bool, verbose: bool = True,
             analysis: bool | str = True, *, smoke: bool = False,
             mesh_dims: tuple[int, ...] | None = None) -> dict:
    """Run and count one cell in a ``fake`` group of its own.

    ``analysis=True`` records the direct count again as ``cost_unrolled``
    (the port's program has no scan to undercount); ``"extrapolate"`` adds
    the 2-/4-layer calibration of ``launch.extrapolate``.  ``smoke`` takes
    the architecture's reduced config and ``mesh_dims`` a smaller mesh
    with the same axis names (for tests)."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    shape = SHAPES[shape_name]
    n = 1
    for s in (mesh_dims or ((2, 16, 16) if multi_pod else (16, 16))):
        n *= s
    _fake_group(n)
    rec = {"arch": arch, "shape": shape_name, "multi_pod": multi_pod, "n_devices": n,
           "ok": False}
    try:
        mesh = _mesh_for(multi_pod, mesh_dims)
        rec["mesh"] = describe(mesh)
        t0 = time.perf_counter()
        plan = plan_cell(cfg, shape, mesh)
        rec["parallelism"] = plan.parallelism
        rec["time_lower_s"] = round(time.perf_counter() - t0, 2)
        run = run_plan(plan, mesh)
        rec["time_compile_s"] = round(run["seconds"], 2)
        rec.update(memory=run["memory"], cost=run["cost"], collectives=run["collectives"])
        if analysis == "extrapolate":
            from repro_torch.launch.extrapolate import extrapolate_cell
            est = extrapolate_cell(cfg, shape, mesh, count_collectives)
            rec["cost_extrapolated"] = {"flops": est["flops"],
                                        "bytes accessed": est["bytes accessed"],
                                        "transcendentals": est.get("transcendentals", 0.0)}
            rec["collectives_extrapolated"] = {
                "total_operand_bytes": est["coll_operand"],
                "total_wire_bytes": est["coll_wire"],
                **{k: {"operand_bytes": v} for k, v in est.items()
                   if k.startswith("coll_") and k not in ("coll_operand", "coll_wire")}}
            rec["time_extrapolate_s"] = est["extrapolation_seconds"]
        elif analysis:
            rec["time_unrolled_s"] = 0.0
            rec["cost_unrolled"] = dict(run["cost"])
            rec["collectives_unrolled"] = run["collectives"]
            rec["memory_unrolled"] = dict(run["memory"])
        rec["ok"] = True
        if verbose:
            cu = rec.get("cost_unrolled") or rec.get("cost_extrapolated") or rec["cost"]
            coll = (rec.get("collectives_unrolled") or rec.get("collectives_extrapolated")
                    or rec["collectives"])
            print(f"[ok] {arch} × {shape_name} × {'multi' if multi_pod else 'single'}-pod  "
                  f"plan {rec['time_lower_s']}s run {rec['time_compile_s']}s  "
                  f"flops={cu.get('flops', 0):.3e}  "
                  f"coll={coll.get('total_operand_bytes', 0):.3e}B "
                  f"args={rec['memory']['argument_size_in_bytes']:.3e}B", flush=True)
    except Exception as e:  # noqa: BLE001 — report, continue the sweep
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[FAIL] {arch} × {shape_name} × {'multi' if multi_pod else 'single'}-pod: "
                  f"{rec['error']}", flush=True)
    finally:
        dist.destroy_process_group()
    return rec


def cell_filename(arch: str, shape: str, multi_pod: bool) -> str:
    pod = "multipod" if multi_pod else "singlepod"
    return f"{arch.replace('.', '_')}__{shape}__{pod}.json"


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--analysis", choices=("auto", "on", "off", "extrapolate"), default="auto",
                    help="measurement pass: on = the direct count again (exact); "
                         "extrapolate = 2-/4-layer calibration; auto = extrapolate on "
                         "single-pod cells only")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    if args.all:
        cells = [(a, s.name) for a in ARCH_NAMES for s in shapes_for(get_config(a))]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    pods = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    n_fail = 0
    multi_cell = len(cells) * len(pods) > 1
    for arch, shape in cells:
        for multi_pod in pods:
            analysis = {"auto": "extrapolate" if not multi_pod else False,
                        "on": True, "off": False, "extrapolate": "extrapolate"}[args.analysis]
            path = os.path.join(args.out, cell_filename(arch, shape, multi_pod))
            if args.skip_existing and os.path.exists(path):
                with open(path) as f:
                    prev = json.load(f)
                has_analysis = bool(prev.get("cost_unrolled") or prev.get("cost_extrapolated"))
                if prev.get("ok") and (not analysis or has_analysis):
                    continue
            if multi_cell:
                # one subprocess per cell: each cell's fake group lives and
                # dies with its process, and a crash does not end the sweep
                mode = "extrapolate" if analysis == "extrapolate" else (
                    "on" if analysis else "off")
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                       "--shape", shape, "--mesh", "multi" if multi_pod else "single",
                       "--out", args.out, "--analysis", mode]
                r = subprocess.run(cmd, capture_output=True, text=True)
                tail = (r.stdout + r.stderr).strip().splitlines()
                print("\n".join(t for t in tail[-2:] if t), flush=True)
                if r.returncode != 0 and not os.path.exists(path):
                    rec = {"arch": arch, "shape": shape, "multi_pod": multi_pod, "ok": False,
                           "error": f"fatal crash rc={r.returncode}",
                           "stderr_tail": "\n".join(tail[-8:])}
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=1)
                with open(path) as f:
                    n_fail += 0 if json.load(f).get("ok") else 1
            else:
                rec = run_cell(arch, shape, multi_pod, analysis=analysis)
                n_fail += 0 if rec["ok"] else 1
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
    print(f"dry-run complete: {n_fail} failures")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
