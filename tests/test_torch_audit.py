"""The port's graph audit (``repro_torch.analysis.graph_audit``) of the rule ×
backend × kind matrix, the twin of ``repro.analysis.jaxpr_audit`` held against
``BENCH_static.json``; and the trace-cache fault it needed mended: a cache
that kept a tensor built inside a trace broke every later eager step and
every later trace in the process.

Each of the 84 cells is traced once per module (``make_fx`` on fake tensors,
the CPU), and the tests read the one audit.
"""
import json
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import FLOAT64_ALLOWLIST, KINDS, audit_cell, graph_audit, run_audit
from repro_torch.analysis.graph_audit import cell_program, kernel_ops, trace
from repro_torch.core import stdp
from repro_torch.kernels.itp_counter import ref as counter_ref
from repro_torch.kernels.itp_stdp_conv import ops as conv_ops
from repro_torch.plasticity import apply

STATIC = json.loads((Path(__file__).resolve().parents[1] / "BENCH_static.json")
                    .read_text())["static_audit"]
HISTORY_RULES = ("itp", "itp_nocomp")
COUNTER_RULES = ("exact", "linear", "imstdp")


def expected_kernel_op(rule: str, backend: str, kind: str, packed: bool = True) -> str | None:
    """The one kernel operator a step of the cell holds per learnable layer:
    the history rules' packed or bitplane update (kernels 1-2, the engine)
    or conv delta (kernels 3-4, the conv layers and the fc layers' batch
    sum), the counter rules' (5, 6 and the fc delta's batch sum), mstdp's on
    magnitude planes (2, 4); the
    sparse backend's conv delta runs kernel 4 on the gathered rows, its fc
    and engine updates no kernel; ``reference`` and ``fused_interpret``
    none."""
    conv = kind in ("conv2d", "conv1d")
    if backend == "sparse":
        return "repro_torch::itp_stdp_conv_delta" if conv else None
    if backend != "fused":
        return None
    if rule in COUNTER_RULES:
        return {"engine": "repro_torch::counter_stdp_update",
                "fc": "repro_torch::counter_fc_delta"}.get(kind, "repro_torch::counter_conv_delta")
    base = ("repro_torch::itp_stdp_update" if kind == "engine"
            else "repro_torch::itp_stdp_conv_delta")
    return base + "_packed" if rule in HISTORY_RULES and packed else base


@pytest.fixture(scope="module")
def audit():
    return run_audit(device="cpu")


def _cell(audit, rule, backend, kind):
    return next(c for c in audit["cells"]
                if (c["rule"], c["backend"], c["kind"]) == (rule, backend, kind))


def test_audited_set_is_the_static_file(audit):
    cells = {(c["rule"], c["backend"], c["kind"]) for c in audit["cells"]}
    assert audit["n_cells"] == len(cells) == 84
    assert cells == {(c["rule"], c["backend"], c["kind"]) for c in STATIC["cells"]}
    assert audit["kinds"] == list(KINDS)


def test_no_cell_violates_a_contract(audit):
    assert audit["n_violating"] == 0, [c for c in audit["cells"] if c["violations"]]
    assert all(c["state_dtypes_preserved"] for c in audit["cells"])


def test_uint8_wherever_the_static_file_expects_it(audit):
    for c in STATIC["cells"]:
        got = _cell(audit, c["rule"], c["backend"], c["kind"])
        assert got["uint8_expected"] == c["uint8_expected"], got
        if c["uint8_expected"]:
            assert got["has_uint8"], got
    # the counter reference cells read float magnitudes: no uint8 claim
    assert not _cell(audit, "exact", "reference", "engine")["uint8_expected"]


@pytest.mark.parametrize("cell", STATIC["cells"],
                         ids=[f"{c['rule']}-{c['backend']}-{c['kind']}"
                              for c in STATIC["cells"]])
def test_one_kernel_op_per_learnable_layer_per_step(audit, cell):
    got = _cell(audit, cell["rule"], cell["backend"], cell["kind"])["kernel_ops"]
    want = expected_kernel_op(cell["rule"], cell["backend"], cell["kind"])
    assert got == ({want: 1} if want else {})


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rule", HISTORY_RULES)
def test_unpacked_history_cells_hold_the_bitplane_kernel(rule, kind):
    state, spikes, step = cell_program(rule, "fused", kind, device="cpu", packed_history=False)
    gm = trace(step, state, spikes)
    want = expected_kernel_op(rule, "fused", kind, packed=False)
    assert kernel_ops(gm) == {want: 1}


def test_float64_only_where_allowed_and_no_stale_entry(audit):
    assert audit["stale_allowlist"] == []
    used = {s for c in audit["cells"] for s in c["f64_sites"]}
    assert used == {f"{f}:{fn}" for f, fn in FLOAT64_ALLOWLIST}
    assert all(reason.strip() for reason in FLOAT64_ALLOWLIST.values())
    # the kernel cells hold no float64 of their own: the conv kernels' scratch
    # lives inside their operators, and every rule's fc layer sums the batch
    # inside its kernel (the conv kernel, or the counter rules' fc kernel)
    for c in audit["cells"]:
        if c["backend"] == "fused":
            assert not c["has_f64"], c
    # the fc cells that keep a per-sample array (sparse, and the counter
    # rules' plain version) hold some: the check has work to do
    assert any(c["has_f64"] for c in audit["cells"] if c["kind"] == "fc")


def test_an_unlisted_float64_site_is_a_violation(monkeypatch):
    monkeypatch.delitem(FLOAT64_ALLOWLIST, ("plasticity/base.py", "lane_sum"))
    cell = audit_cell("itp", "sparse", "fc", device="cpu")
    assert any("plasticity/base.py:lane_sum" in v for v in cell["violations"])


def test_a_slice_of_the_matrix_reports_no_stale_entry():
    r = run_audit(kinds=("engine",), device="cpu")
    assert r["n_cells"] == 21 and r["n_violating"] == 0 and r["stale_allowlist"] == []


def test_audit_detects_trace_failure(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("synthetic trace failure")

    monkeypatch.setattr(graph_audit, "engine_step", boom)
    cell = audit_cell("itp", "reference", "engine", device="cpu")
    assert any("trace failed" in v for v in cell["violations"])


# ---------------------------------------------------------------------------
# the trace-cache fault: one trace must not break the process
# ---------------------------------------------------------------------------

CACHES = (stdp._po2_weights_on, counter_ref.window_lut, conv_ops._index_2d,
          conv_ops._index_1d, apply._plan)


def _clear_caches():
    for cache in CACHES:
        cache.cache_clear()


def _leaves(tree):
    return torch.utils._pytree.tree_leaves(tree)


@pytest.mark.parametrize("rule,backend,kind", [
    ("itp", "fused", "engine"), ("itp", "reference", "engine"), ("itp", "fused", "fc"),
    ("itp", "fused", "conv2d"), ("exact", "fused", "conv1d"), ("imstdp", "reference", "fc"),
    ("mstdp", "sparse", "conv2d")])
def test_trace_then_eager_is_bit_equal_to_eager_before_any_trace(rule, backend, kind):
    state, spikes, step = cell_program(rule, backend, kind, device="cpu")
    _clear_caches()
    before = _leaves(step(state, spikes))            # eager, before any trace
    _clear_caches()                                  # the trace builds every constant
    first = trace(step, state, spikes)
    after = _leaves(step(state, spikes))
    second = trace(step, state, spikes)              # a second trace of the same cell
    again = _leaves(step(state, spikes))
    assert len(before) == len(after) == len(again)
    for a, b, c in zip(before, after, again):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert kernel_ops(first) == kernel_ops(second)
    # the traced graph computes the eager step
    for a, b in zip(before, _leaves(first(state, spikes))):
        assert torch.equal(a, b)
