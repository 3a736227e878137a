"""The rule × backend × kind matrix: every cell of ``BENCH_static.json`` (84:
21 (rule, backend) pairs × engine, fc, conv2d, conv1d) runs on the port on
the CPU and matches the JAX package on the same inputs.

Each cell is built at the reference audit's shapes
(``src/repro/analysis/jaxpr_audit.py``: a 16 → 8 engine; one-layer nets with
a 16 → 8 fc, an 8×8×1 conv2d with 4 channels of 3×3, a 16×2 conv1d with 4
channels of 3 at stride 2; batch 1; the sparse cells capped at 4 events) and
driven for 6 steps from one state, the weights made by the reference and
carried across by ``repro_torch.convert``, the rasters made by numpy.  The
reference runs ``fused`` as ``fused_interpret``, as its own tests do on the
CPU.  Its fused counter cells (``exact``, ``linear``, ``imstdp``) do not run
on this JAX (the Pallas kernel asks for ``pltpu.TPUMemorySpace``; ROADMAP
"Reference caveats"), so those cells are held against the reference's
``reference`` backend, as ``tests/test_torch_counter.py`` does.

Spikes and timing-state words are held exactly; engine and fc weights at
rtol=1e-5, atol=1e-6 (the ROADMAP parity contract), conv weights at
rtol=atol=1e-5 (the conv tolerance: the reference sums conv terms in
float32, the port in float64); membranes and θ at rtol=1e-5, atol=1e-6.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.models import snn as JS
from repro_torch.convert import (engine_state_from_arrays, engine_state_to_numpy,
                                 snn_state_from_arrays, snn_state_to_numpy)
from repro_torch.core import engine as TE
from repro_torch.models import snn as TS

CELLS = json.loads((Path(__file__).resolve().parents[1] / "BENCH_static.json")
                   .read_text())["static_audit"]["cells"]
COUNTER_RULES = ("exact", "linear", "imstdp")
SPARSE_EVENTS = 4
STEPS = 6
TOL = dict(rtol=1e-5, atol=1e-6)
CONV_TOL = dict(rtol=1e-5, atol=1e-5)
# kind → (input shape, layer spec keywords)
SNN_SHAPES = {
    "fc": ((16,), dict(kind="fc", out_features=8)),
    "conv2d": ((8, 8, 1), dict(kind="conv2d", out_features=4, kernel=3)),
    "conv1d": ((16, 2), dict(kind="conv1d", out_features=4, kernel=3, stride=2)),
}


def _jax_backend(rule: str, backend: str) -> str:
    if backend == "fused":
        backend = "fused_interpret"
    if rule in COUNTER_RULES and backend == "fused_interpret":
        return "reference"
    return backend


def _assert_tree(got, want, tol):
    """Two numpy state trees: float arrays within ``tol``, the rest exact."""
    got_flat, got_tree = jax.tree_util.tree_flatten(got)
    want_flat, want_tree = jax.tree_util.tree_flatten(want)
    assert got_tree == want_tree
    for a, b in zip(got_flat, want_flat):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, **tol)
        else:
            np.testing.assert_array_equal(a, b)


def _engine_cell(rule, backend, jax_backend, raster):
    max_events = SPARSE_EVENTS if backend == "sparse" else None
    jcfg = JE.EngineConfig(n_pre=16, n_post=8, rule=rule, backend=jax_backend,
                           max_events=SPARSE_EVENTS if jax_backend == "sparse" else None)
    tcfg = TE.EngineConfig(n_pre=16, n_post=8, rule=rule, backend=backend,
                           max_events=max_events)
    js0 = JE.init_engine(jax.random.PRNGKey(0), jcfg)
    js, jpost = JE.run_engine(js0, jnp.asarray(raster), jcfg)
    ts, tpost = TE.run_engine(engine_state_from_arrays(js0, device="cpu"),
                              torch.from_numpy(raster), tcfg)
    np.testing.assert_array_equal(tpost.numpy(), np.asarray(jpost))
    _assert_tree(engine_state_to_numpy(ts),
                 engine_state_to_numpy(engine_state_from_arrays(js, device="cpu")), TOL)
    return js0.w, ts.w


def _snn_cell(rule, backend, jax_backend, kind, raster):
    input_shape, spec = SNN_SHAPES[kind]

    def cfg(pkg, be):
        return pkg.SNNConfig(name=f"audit-{kind}", input_shape=input_shape,
                             layers=(pkg.SNNLayerSpec(**spec),), rule=rule, backend=be,
                             max_events=SPARSE_EVENTS if be == "sparse" else None)

    jcfg, tcfg = cfg(JS, jax_backend), cfg(TS, backend)
    js0 = JS.init_snn(jax.random.PRNGKey(0), jcfg, 1)
    js, jcounts = JS.run_snn(js0, jnp.asarray(raster), jcfg, train=True)
    ts, tcounts = TS.run_snn(snn_state_from_arrays(js0, device="cpu"),
                             torch.from_numpy(raster), tcfg, train=True)
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    tw, tl = snn_state_to_numpy(ts)
    jw, jl = snn_state_to_numpy(snn_state_from_arrays(js, device="cpu"))
    _assert_tree(tw, jw, TOL if kind == "fc" else CONV_TOL)
    _assert_tree(tl, jl, TOL)
    return js0.weights[0], ts.weights[0]


def test_the_file_lists_every_valid_cell():
    from repro_torch import plasticity

    assert len(CELLS) == 84
    pairs = {(c["rule"], c["backend"]) for c in CELLS}
    valid = set()
    for rule in plasticity.rule_names():
        for backend in plasticity.BACKENDS:
            try:
                plasticity.validate_update_config(rule=rule, backend=backend,
                                                  pairing="nearest", max_events=4)
            except ValueError:
                continue
            valid.add((rule, backend))
    assert pairs == valid
    assert {c["kind"] for c in CELLS} == {"engine", "fc", "conv2d", "conv1d"}


@pytest.mark.parametrize("cell", CELLS, ids=[f"{c['rule']}-{c['backend']}-{c['kind']}"
                                             for c in CELLS])
def test_cell_matches_reference(cell):
    rule, backend, kind = cell["rule"], cell["backend"], cell["kind"]
    rng = np.random.default_rng(len(rule) * 7 + len(backend) * 3 + len(kind))
    if kind == "engine":
        raster = (rng.random((STEPS, 16)) < 0.3).astype(np.float32)
        w0, w = _engine_cell(rule, backend, _jax_backend(rule, backend), raster)
    else:
        raster = (rng.random((STEPS, 1, *SNN_SHAPES[kind][0])) < 0.3).astype(np.float32)
        w0, w = _snn_cell(rule, backend, _jax_backend(rule, backend), kind, raster)
    assert not np.array_equal(w.numpy(), np.asarray(w0)), "the cell should learn"
