"""Graph contract audit of the rule × backend × layer-kind matrix (port of
``repro.analysis.jaxpr_audit``).

Each *valid* matrix cell's state is built eagerly at the reference audit's
tiny shapes, and one step of it (``engine_step``, or ``snn_step`` with
``train=True``) is traced with ``make_fx(tracing_mode="fake")``: nothing
runs, and each kernel shows up as its registered operator
(``torch.ops.repro_torch.*``, ``kernels/_ops.py``) through its fake kernel,
the counterpart of a Pallas kernel's abstract eval.  The graph is checked
against the dataflow contracts the paper's hardware makes statically:

* the cell traces (a trace failure is itself the finding: :func:`audit_cell`
  never raises),
* the timing state keeps its dtypes across the step (the uint8 words and
  planes never silently promote),
* a uint8 value appears in the graph wherever the packed datapath claims
  one (``uint8_expected``: the history rules always, the counter rules on
  the kernel and sparse backends),
* no float64 value except where the port computes in float64 on purpose:
  each float64 result is attributed to the innermost port function that
  made it, and that function must be in :data:`FLOAT64_ALLOWLIST`, which
  ratchets as the reference's lint allowlist does (an entry no cell uses is
  stale and fails :func:`run_audit`),
* a ``fused`` cell holds its kernel's operator exactly once per learnable
  layer per step (each audit cell has one), a ``reference`` or
  ``fused_interpret`` cell none: the port's counterpart of ``pallas_call``
  in the reference's primitive counts.

The reference's weak-type check is dropped: torch has no weak types (a
Python scalar never makes a tensor whose dtype changes on retrace).  Each
cell also records its ``aten`` op counts (``primitives``), as the reference
records its primitive counts; a tracked ``BENCH_torch_static.json`` waits
for the port's benchmarks.
"""
from __future__ import annotations

import collections
import sys
from pathlib import Path
from typing import Any, Callable, Iterable

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.fx.experimental.proxy_tensor import make_fx
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree

import repro_torch
from repro_torch import plasticity
from repro_torch.core.engine import EngineConfig, engine_step, init_engine
from repro_torch.device import resolve_device
from repro_torch.kernels.dispatch import BACKENDS
from repro_torch.models.snn import SNNConfig, SNNLayerSpec, init_snn, snn_step

KINDS = ("engine", "fc", "conv2d", "conv1d")

# the reference audit's shapes: big enough to exercise the packing (n > 8)
# and conv patch extraction, small enough that 84 traces stay cheap
_SPARSE_EVENTS = 4
_SNN_SHAPES = {
    "fc": ((16,), SNNLayerSpec("fc", out_features=8)),
    "conv2d": ((8, 8, 1), SNNLayerSpec("conv2d", out_features=4, kernel=3)),
    "conv1d": ((16, 2), SNNLayerSpec("conv1d", out_features=4, kernel=3, stride=2)),
}

# (port file, function) → why it computes in float64.  The attribution is the
# innermost port frame of the torch call that made the value, so a function
# that only calls these (the counter windows of ``kernels/itp_counter/ref.py``,
# the conv kernels' callers) needs no entry of its own.  The conv kernels'
# float64 partials are scratch inside their operators' CUDA kernels and never
# reach a graph.
_WINDOW = ("the counter windows round as float32 arithmetic does, one operation "
           "at a time: each step taken in float64 on float32 operands and rounded "
           "once, so every device gives the same bits (core/stdp.py:53-69)")
FLOAT64_ALLOWLIST: dict[tuple[str, str], str] = {
    ("core/stdp.py", "_quotient"): _WINDOW,
    ("core/stdp.py", "_times"): _WINDOW,
    ("core/stdp.py", "exp_decay"): _WINDOW + "; exp is taken in float64",
    ("core/stdp.py", "pwl_decay"): _WINDOW,
    ("kernels/itp_stdp_conv/ref.py", "gated_contraction"):
        "the plain conv deltas (and the reference backend's fc delta) sum the "
        "{0,1}-gated float32 terms exactly in float64 and round once, as the "
        "conv kernels do, so the two agree bit for bit",
    ("kernels/itp_counter/ref.py", "counter_fc_delta_ref"):
        "the plain counter fc delta (fused_interpret, and the counter fc kernel's "
        "CPU version) sums its per-lane array over the batch exactly in float64 and "
        "rounds once, as the kernel's float64 accumulators do, so the two agree bit "
        "for bit",
    ("plasticity/base.py", "lane_sum"):
        "the sparse backend's fc delta sums its per-sample array over the batch "
        "exactly in float64 and rounds once, so it gives the bits of the other "
        "backends' gated contraction",
}

_PACKAGE = Path(repro_torch.__file__).resolve().parent
_SELF = Path(__file__).resolve()


def valid_cells(kinds: Iterable[str] = KINDS) -> list[tuple[str, str, str]]:
    """All (rule, backend, kind) combinations the shared validator accepts."""
    out = []
    for kind in kinds:
        for rule in plasticity.rule_names():
            for backend in BACKENDS:
                max_events = _SPARSE_EVENTS if backend == "sparse" else None
                try:
                    plasticity.validate_update_config(rule=rule, backend=backend,
                                                      pairing="nearest",
                                                      max_events=max_events)
                except ValueError:
                    continue
                out.append((rule, backend, kind))
    return out


def cell_program(rule: str, backend: str, kind: str, *,
                 device: torch.device | str = "cuda", packed_history: bool = True
                 ) -> tuple[Any, torch.Tensor, Callable]:
    """→ ``(state, input spikes, step)`` of one cell on ``device`` (CUDA
    unless the caller asks for the CPU).

    The state is built eagerly from a seeded generator (the init functions
    size buffers with Python ints, as the reference's do); the input is a
    float32 {0,1} raster row, seeded too.  ``step(state, spikes)`` returns
    ``(state', out)``.  ``packed_history=False`` feeds the history rules'
    kernels bitplanes instead of words."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    max_events = _SPARSE_EVENTS if backend == "sparse" else None
    if kind == "engine":
        cfg = EngineConfig(n_pre=16, n_post=8, rule=rule, backend=backend,
                           max_events=max_events, packed_history=packed_history)
        state = init_engine(cfg, generator=gen, device=device)
        shape = (cfg.n_pre,)
        step = lambda s, sp: engine_step(s, sp, cfg)
    else:
        input_shape, spec = _SNN_SHAPES[kind]
        cfg = SNNConfig(name=f"audit-{kind}", input_shape=input_shape, layers=(spec,),
                        rule=rule, backend=backend, max_events=max_events,
                        packed_history=packed_history)
        state = init_snn(cfg, 1, generator=gen, device=device)
        shape = (1, *input_shape)
        step = lambda s, sp: snn_step(s, sp, cfg, train=True)
    spikes = (torch.rand(shape, generator=gen) < 0.3).to(torch.float32).to(device)
    return state, spikes, step


def trace(step: Callable, state: Any, spikes: torch.Tensor) -> torch.fx.GraphModule:
    """One step traced on fake tensors; the cached constants the step reads
    (built eagerly, ``device.eager``) stay in the graph as constants."""
    return make_fx(step, tracing_mode="fake", _allow_non_fake_inputs=True)(state, spikes)


def _site() -> tuple[str, str]:
    """(file, function) of the innermost port frame on the caller's stack,
    this module's own frames skipped."""
    frame = sys._getframe(2)
    while frame is not None:
        path = Path(frame.f_code.co_filename)
        if _PACKAGE in path.parents and path != _SELF:
            return str(path.relative_to(_PACKAGE)), frame.f_code.co_name
        frame = frame.f_back
    return "?", "?"


class _Float64Sites(TorchFunctionMode):
    """Counts, by port function, the torch calls of a trace that return a
    float64 value made inside it (fake); eagerly built constants are not."""

    def __init__(self):
        super().__init__()
        self.sites: collections.Counter = collections.Counter()

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if any(isinstance(t, torch.Tensor) and t.dtype == torch.float64 and is_fake(t)
               for t in pytree.tree_leaves(out)):
            self.sites[_site()] += 1
        return out


def _dtype(value: Any) -> str:
    return str(value.dtype) if isinstance(value, torch.Tensor) else type(value).__name__


def kernel_ops(graph_module: torch.fx.GraphModule) -> dict[str, int]:
    """Counts of the port's kernel operators (``repro_torch::<name>``) in a graph."""
    counts: collections.Counter = collections.Counter()
    for node in graph_module.graph.nodes:
        if isinstance(node.target, torch._ops.OpOverload) and \
                node.target.namespace == "repro_torch":
            counts[node.target._schema.name] += 1
    return dict(sorted(counts.items()))


def audit_cell(rule: str, backend: str, kind: str, *,
               device: torch.device | str = "cuda") -> dict:
    """Trace one matrix cell on ``device`` and check its contracts.  Past the
    device's resolution (CUDA unless the caller asks for the CPU, raising
    without it) it never raises: a trace failure is a violation."""
    device = resolve_device(device)
    cell: dict[str, Any] = {"rule": rule, "backend": backend, "kind": kind,
                            "violations": []}
    sites = _Float64Sites()
    try:
        state, spikes, step = cell_program(rule, backend, kind, device=device)
        with sites:
            gm = trace(step, state, spikes)
    except Exception as e:  # noqa: BLE001 — any trace failure is the finding
        cell["violations"].append(f"trace failed: {type(e).__name__}: {e}")
        return cell

    nodes = list(gm.graph.nodes)
    values = [v for n in nodes for v in pytree.tree_leaves(n.meta.get("val"))]
    dtypes = {_dtype(v) for v in values}
    calls = [n for n in nodes if n.op == "call_function"]
    counts = collections.Counter(str(n.target) for n in calls)
    cell["n_ops"] = len(calls)
    cell["primitives"] = dict(sorted(counts.items()))
    cell["kernel_ops"] = kernel_ops(gm)
    cell["has_uint8"] = "torch.uint8" in dtypes
    cell["has_f64"] = "torch.float64" in dtypes
    cell["f64_sites"] = sorted(f"{f}:{fn}" for f, fn in sites.sites)

    state_in = [_dtype(v) for v in pytree.tree_leaves(state)]
    outputs = pytree.tree_leaves(nodes[-1].args)
    state_out = [_dtype(o.meta.get("val") if isinstance(o, torch.fx.Node) else o)
                 for o in outputs[:len(state_in)]]
    cell["state_dtypes_preserved"] = state_in == state_out

    uint8_expected = plasticity.get_rule(rule).has_sparse or backend != "reference"
    cell["uint8_expected"] = uint8_expected

    if not cell["state_dtypes_preserved"]:
        cell["violations"].append(f"state dtypes changed across the step: {state_in} → "
                                  f"{state_out}")
    if uint8_expected and not cell["has_uint8"]:
        cell["violations"].append("no uint8 value in a packed-register cell")
    for site in sites.sites:
        if site not in FLOAT64_ALLOWLIST:
            cell["violations"].append(f"float64 made at {site[0]}:{site[1]}, which the "
                                      f"allowlist does not hold")
    if cell["has_f64"] and not sites.sites:
        cell["violations"].append("float64 value in the graph made by no port function")
    n_kernel_ops = sum(cell["kernel_ops"].values())
    if backend == "fused" and n_kernel_ops != 1:
        cell["violations"].append(f"a fused cell should hold one kernel op, holds "
                                  f"{cell['kernel_ops']}")
    if backend in ("reference", "fused_interpret") and n_kernel_ops:
        cell["violations"].append(f"a {backend} cell holds kernel ops {cell['kernel_ops']}")
    return cell


def run_audit(kinds: Iterable[str] = KINDS, *, device: torch.device | str = "cuda") -> dict:
    """Audit every valid cell of ``kinds`` on ``device``; the allowlist entries
    no cell used are reported as ``stale_allowlist`` and count as a failure
    only when every kind was audited (a slice of the matrix need not use
    them all)."""
    kinds, device = tuple(kinds), resolve_device(device)
    cells = [audit_cell(rule, backend, kind, device=device)
             for rule, backend, kind in valid_cells(kinds)]
    used = {tuple(site.split(":")) for c in cells for site in c.get("f64_sites", ())}
    stale = sorted(f"{f}:{fn}" for f, fn in set(FLOAT64_ALLOWLIST) - used)
    return {
        "torch_version": torch.__version__,
        "device": str(device),
        "kinds": list(kinds),
        "n_cells": len(cells),
        "n_violating": sum(1 for c in cells if c["violations"]),
        "stale_allowlist": stale if set(kinds) == set(KINDS) else [],
        "cells": cells,
    }
