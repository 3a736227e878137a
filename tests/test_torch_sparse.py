"""The sparse backend of repro_torch against the JAX package: the event lists
(``kernels/itp_sparse/events.py``), the ops (``kernels/itp_sparse/ops.py``),
the plan's sparse branches through the engine, the three paper nets, serving
and the training launcher.

Mirrors ``tests/test_sparse_events.py`` (all of it) and
``tests/test_sparse_backend.py``, feeding the same numpy-made inputs to both
packages.  Event lists, spikes and history words are held exactly; float32
weights and deltas at rtol=1e-5, atol=1e-6 (the ROADMAP parity contract);
the conv delta and the nets' weights at rtol=atol=1e-5, since the reference
sums conv terms in float32 and the port in float64.  Within the port the
sparse engine is bit-equal to the fused one while ``w`` lies inside the
clip window.  Left out: the sharded case (ROADMAP queue 1 item 15) and the
launcher's ``--engine`` mode (item 16).
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro import serve as JV
from repro.core import engine as JE
from repro.core import history as JH
from repro.core import stdp as JSTDP
from repro.core.engine import EngineConfig as JEngineConfig
from repro.kernels.itp_sparse import events as JEV
from repro.kernels.itp_sparse import ops as JOPS
from repro.models import snn as JS
from repro_torch import plasticity
from repro_torch import serve as TV
from repro_torch.convert import (session_state_from_arrays, snn_state_from_arrays,
                                 snn_state_to_numpy)
from repro_torch.core import engine as TE
from repro_torch.core import history as TH
from repro_torch.core import stdp as TSTDP
from repro_torch.kernels import dispatch
from repro_torch.kernels.itp_sparse import events as TEV
from repro_torch.kernels.itp_sparse import ops as TOPS
from repro_torch.kernels.itp_stdp_conv.ref import itp_stdp_conv_delta_ref
from repro_torch.launch import train as train_launcher
from repro_torch.models import snn as TS

TOL = dict(rtol=1e-5, atol=1e-6)
CONV_TOL = dict(rtol=1e-5, atol=1e-5)
DEPTH = 7


def _oracle(spikes: np.ndarray, cap: int) -> tuple[np.ndarray, int]:
    """First ``cap`` active indices ascending, sentinel-padded to ``cap``."""
    (active,) = np.nonzero(spikes)
    kept = active[:cap]
    idx = np.full((cap,), spikes.shape[-1], dtype=np.int64)
    idx[: len(kept)] = kept
    return idx, len(kept)


# ---------------------------------------------------------------------------
# Event lists (tests/test_sparse_events.py)
# ---------------------------------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(data=st.data(), n=st.integers(1, 40), cap=st.integers(1, 45))
def test_spike_events_matches_nonzero_prefix(data, n, cap):
    spikes = np.asarray(data.draw(st.lists(st.integers(0, 1), min_size=n, max_size=n)))
    idx, count = TEV.spike_events(torch.from_numpy(spikes), cap)
    want_idx, want_count = _oracle(spikes, TEV.event_cap(n, cap))
    assert idx.shape == (TEV.event_cap(n, cap),) and idx.dtype == torch.int64
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    assert int(count) == want_count
    jidx, jcount = JEV.spike_events(jnp.asarray(spikes), cap)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert int(count) == int(jcount)


@settings(max_examples=40, deadline=None)
@given(data=st.data(), n=st.integers(1, 32))
def test_spike_events_saturates_at_cap(data, n):
    """All-ones input: the cap keeps the lowest indices, count saturates."""
    cap = data.draw(st.integers(1, n))
    idx, count = TEV.spike_events(torch.ones((n,)), cap)
    np.testing.assert_array_equal(idx.numpy(), np.arange(cap))
    assert int(count) == cap


def test_spike_events_shapes_are_density_invariant():
    n, cap = 16, 5
    shapes = set()
    for raster in (np.zeros(n), np.eye(n)[3], np.ones(n)):
        idx, _ = TEV.spike_events(torch.from_numpy(raster), cap)
        shapes.add((tuple(idx.shape), idx.dtype))
    assert shapes == {((cap,), torch.int64)}
    idx, count = TEV.spike_events(torch.zeros((n,)), cap)
    assert int(count) == 0 and bool((idx == n).all())          # all sentinel


def test_event_cap_validation():
    assert TEV.event_cap(10, None) == 10
    assert TEV.event_cap(10, 99) == 10
    assert TEV.event_cap(10, 3) == 3
    for bad in (0, -1):
        with pytest.raises(ValueError):
            TEV.event_cap(10, bad)
        with pytest.raises(ValueError):
            JEV.event_cap(10, bad)


@settings(max_examples=60, deadline=None)
@given(data=st.data(), depth=st.integers(1, 8), n=st.integers(1, 24))
def test_word_events_reads_packed_slots(data, depth, n):
    """Packed-word extraction ≡ extraction on the unpacked bit slot."""
    row = st.lists(st.integers(0, 1), min_size=n, max_size=n)
    bits = np.asarray(data.draw(st.lists(row, min_size=depth, max_size=depth)))
    words = TH.pack_bitplanes(torch.from_numpy(bits))
    slot = data.draw(st.integers(0, depth - 1))
    cap = data.draw(st.integers(1, n + 2))
    idx, count = TEV.word_events(words, depth, cap, slot=slot)
    want_idx, want_count = _oracle(bits[slot], TEV.event_cap(n, cap))
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    assert int(count) == want_count
    jidx, _ = JEV.word_events(JH.pack_bitplanes(jnp.asarray(bits)), depth, cap, slot=slot)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def test_word_events_slot_validation():
    words = torch.zeros((4,), dtype=torch.uint8)
    with pytest.raises(ValueError):
        TEV.word_events(words, 4, None, slot=4)
    with pytest.raises(ValueError):
        TEV.word_events(words, 4, None, slot=-1)
    with pytest.raises(ValueError):
        TEV.word_events(words, 9)


@pytest.mark.parametrize("cap", (None, 1, 4))
def test_event_lists_per_lane(cap):
    """A ``(*lanes, n)`` tensor gives each lane the list it gives alone; the
    dispatch module re-exports the primitives."""
    rng = np.random.default_rng(3)
    spikes = (rng.random((2, 3, 12)) < 0.3).astype(np.float32)
    spikes[0, 1] = 0.0                                  # a silent lane
    idx, count = dispatch.spike_events(torch.from_numpy(spikes), cap)
    assert idx.shape == (2, 3, dispatch.event_cap(12, cap))
    for a in range(2):
        for b in range(3):
            want_idx, want_count = _oracle(spikes[a, b], dispatch.event_cap(12, cap))
            np.testing.assert_array_equal(idx[a, b].numpy(), want_idx)
            assert int(count[a, b]) == want_count
    assert dispatch.word_events is TEV.word_events


# ---------------------------------------------------------------------------
# Ops (tests/test_sparse_backend.py, ops level)
# ---------------------------------------------------------------------------

def _rand_case(seed, n_pre=12, n_post=9, density=0.4, lanes=()):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    w = rng.uniform(0.2, 0.8, (*lanes, n_pre, n_post)).astype(f32)
    pre = (rng.random((*lanes, n_pre)) < density).astype(f32)
    post = (rng.random((*lanes, n_post)) < density).astype(f32)
    pre_h = (rng.random((*lanes, DEPTH, n_pre)) < 0.3).astype(f32)    # depth-major
    post_h = (rng.random((*lanes, DEPTH, n_post)) < 0.3).astype(f32)
    return w, pre, post, pre_h, post_h


def _magnitudes(pre_h, post_h, pairing):
    p = TSTDP.STDPParams()
    kw = dict(pairing=pairing, compensate=True)
    return (TSTDP.magnitudes_depth_major(torch.from_numpy(pre_h), p.a_plus, p.tau_plus, **kw),
            TSTDP.magnitudes_depth_major(torch.from_numpy(post_h), p.a_minus, p.tau_minus,
                                         **kw))


def _dense_delta(pre, post, ltp, ltd, pre_gate=None, post_gate=None):
    """``(1-pre)·ltp·post − pre·(1-post)·ltd``; the gates default to the spikes."""
    pre_gate = pre if pre_gate is None else pre_gate
    post_gate = post if post_gate is None else post_gate
    return ((1.0 - pre)[..., :, None] * ltp[..., :, None] * post_gate[..., None, :]
            - pre_gate[..., :, None] * (1.0 - post)[..., None, :] * ltd[..., None, :])


@pytest.mark.parametrize("pairing", ["nearest", "all"])
@pytest.mark.parametrize("density", [0.05, 0.4, 1.0])
def test_sparse_weight_update_matches_dense(pairing, density):
    w, pre, post, pre_h, post_h = _rand_case(int(density * 100), density=density)
    ltp, ltd = _magnitudes(pre_h, post_h, pairing)
    got = TOPS.sparse_weight_update(torch.from_numpy(w), torch.from_numpy(pre),
                                    torch.from_numpy(post), ltp, ltd, eta=1 / 16)
    dense = TSTDP.synapse_update(torch.from_numpy(w), torch.from_numpy(pre),
                                 torch.from_numpy(post), torch.from_numpy(pre_h.T),
                                 torch.from_numpy(post_h.T), TSTDP.STDPParams(),
                                 pairing=pairing, eta=1 / 16)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), **TOL)
    want = JOPS.sparse_weight_update(jnp.asarray(w), jnp.asarray(pre), jnp.asarray(post),
                                     jnp.asarray(ltp.numpy()), jnp.asarray(ltd.numpy()),
                                     eta=1 / 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sparse_synapse_delta_matches_dense_formula():
    _, pre, post, pre_h, post_h = _rand_case(7)
    ltp, ltd = _magnitudes(pre_h, post_h, "nearest")
    pre_t, post_t = torch.from_numpy(pre), torch.from_numpy(post)
    got = TOPS.sparse_synapse_delta(pre_t, post_t, ltp, ltd)
    np.testing.assert_allclose(got.numpy(), _dense_delta(pre_t, post_t, ltp, ltd).numpy(),
                               **TOL)
    want = JOPS.sparse_synapse_delta(jnp.asarray(pre), jnp.asarray(post),
                                     jnp.asarray(ltp.numpy()), jnp.asarray(ltd.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sparse_update_overflow_truncates_highest_indices():
    """Capped lists keep the first ``max_events`` active indices: the update
    equals the dense formula with the dropped (highest-indexed) spikes masked
    out of the scatter sides but still present in the pair gate."""
    cap = 2
    w, pre, post, pre_h, post_h = _rand_case(11, density=0.9)
    ltp, ltd = _magnitudes(pre_h, post_h, "nearest")
    pre_t, post_t = torch.from_numpy(pre), torch.from_numpy(post)

    def trunc(spikes):
        idx, _ = TEV.spike_events(spikes, cap)
        kept = torch.zeros_like(spikes)
        kept[idx[idx < spikes.shape[-1]]] = 1.0
        return spikes * kept

    dw = _dense_delta(pre_t, post_t, ltp, ltd, trunc(pre_t), trunc(post_t))
    want = torch.clamp(torch.from_numpy(w) + (1 / 16) * dw, 0.0, 1.0)
    got = TOPS.sparse_weight_update(torch.from_numpy(w), pre_t, post_t, ltp, ltd,
                                    eta=1 / 16, max_events=cap)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    jgot = JOPS.sparse_weight_update(jnp.asarray(w), jnp.asarray(pre), jnp.asarray(post),
                                     jnp.asarray(ltp.numpy()), jnp.asarray(ltd.numpy()),
                                     eta=1 / 16, max_events=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), **TOL)


@pytest.mark.parametrize("cap", (None, 3))
def test_sparse_ops_take_lanes(cap):
    """Every lane is an independent update, silent lanes included, and the
    input is left untouched."""
    w, pre, post, pre_h, post_h = _rand_case(13, lanes=(2, 3))
    pre[1, 2] = 0.0
    post[1, 2] = 0.0
    post[0, 1] = 0.0
    ltp, ltd = _magnitudes(pre_h, post_h, "nearest")
    w_t = torch.from_numpy(w)
    got = TOPS.sparse_weight_update(w_t, torch.from_numpy(pre), torch.from_numpy(post),
                                    ltp, ltd, eta=0.25, max_events=cap)
    delta = TOPS.sparse_synapse_delta(torch.from_numpy(pre), torch.from_numpy(post), ltp,
                                      ltd, max_events=cap)
    assert torch.equal(w_t, torch.from_numpy(w))
    for a in range(2):
        for b in range(3):
            one = TOPS.sparse_weight_update(w_t[a, b], torch.from_numpy(pre[a, b]),
                                            torch.from_numpy(post[a, b]), ltp[a, b],
                                            ltd[a, b], eta=0.25, max_events=cap)
            assert torch.equal(got[a, b], one)
            d = TOPS.sparse_synapse_delta(torch.from_numpy(pre[a, b]),
                                          torch.from_numpy(post[a, b]), ltp[a, b], ltd[a, b],
                                          max_events=cap)
            assert torch.equal(delta[a, b], d)
    assert torch.equal(got[1, 2], w_t[1, 2])


@pytest.mark.parametrize("cap", (None, 20))
@pytest.mark.parametrize("nearest", (True, False))
def test_sparse_conv_delta_matches_dense_and_reference(cap, nearest):
    """Active rows only: with every active row inside the cap the delta equals
    the dense conv delta bit for bit; against the reference within the conv
    tolerance, capped or not."""
    rng = np.random.default_rng(17)
    m, k, c = 60, 9, 4
    pre = (rng.random((m, k)) < 0.08).astype(np.float32)
    post = (rng.random((m, c)) < 0.05).astype(np.float32)
    pre_b = (rng.random((DEPTH, m, k)) < 0.3).astype(np.float32)
    post_b = (rng.random((DEPTH, m, c)) < 0.3).astype(np.float32)
    po2 = [TSTDP.po2_weights(DEPTH, 4.0) * a for a in (1.0, 1.125)]
    args = [torch.from_numpy(x) for x in (pre, post, pre_b, post_b)]
    got = TOPS.sparse_conv_delta(*args, *po2, nearest=nearest, max_events=cap)
    active = int(((pre != 0).any(1) | (post != 0).any(1)).sum())
    assert 0 < active
    if cap is None or active <= cap:
        assert torch.equal(got, itp_stdp_conv_delta_ref(*args, *po2, nearest=nearest))
    want = JOPS.sparse_conv_delta(*map(jnp.asarray, (pre, post, pre_b, post_b)),
                                  *(jnp.asarray(x.numpy()) for x in po2), nearest=nearest,
                                  max_events=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **CONV_TOL)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

N_PRE, N_POST, T_STEPS = 24, 16, 48


def _engine_inputs(seed, density, lanes=()):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.2, 0.8, (*lanes, N_PRE, N_POST)).astype(np.float32)
    x = (rng.random((*lanes, T_STEPS, N_PRE)) < density).astype(np.float32)
    return w, x


def _engine_pair(jax_backend, port_backend, *, density=0.35, seed=0, **kw):
    """(JAX final state, JAX posts, port final state, port posts)."""
    w, x = _engine_inputs(seed, density)
    jcfg = JEngineConfig(n_pre=N_PRE, n_post=N_POST, backend=jax_backend, **kw)
    tcfg = TE.EngineConfig(n_pre=N_PRE, n_post=N_POST, backend=port_backend, **kw)
    js, jpost = JE.run_engine(JE.init_engine(jax.random.PRNGKey(0), jcfg, w_init=w),
                              jnp.asarray(x), jcfg)
    ts, tpost = TE.run_engine(TE.init_engine(tcfg, w_init=w, device="cpu"),
                              torch.from_numpy(x), tcfg)
    return js, jpost, ts, tpost


def _assert_engine_match(js, jpost, ts, tpost):
    np.testing.assert_array_equal(np.asarray(jpost), tpost.numpy())
    np.testing.assert_allclose(ts.w.numpy(), np.asarray(js.w), **TOL)
    for jh, th in ((js.pre_hist, ts.pre_hist), (js.post_hist, ts.post_hist)):
        np.testing.assert_array_equal(np.asarray(JH.pack_words(jh)), TH.pack_words(th).numpy())


@pytest.mark.parametrize("pairing", ["nearest", "all"])
@pytest.mark.parametrize("quantise", [False, True])
def test_engine_sparse_matches_reference(pairing, quantise):
    for density in (0.02, 0.3, 0.9):
        kw = dict(pairing=pairing, quantise=quantise, density=density)
        js, jpost, ts, tpost = _engine_pair("reference", "sparse", **kw)
        _assert_engine_match(js, jpost, ts, tpost)
        js, jpost, _, _ = _engine_pair("sparse", "sparse", **kw)
        _assert_engine_match(js, jpost, ts, tpost)
        # the port's sparse update is the fused kernel's, bit for bit
        w, x = _engine_inputs(0, density)
        cfg = TE.EngineConfig(n_pre=N_PRE, n_post=N_POST, backend="fused",
                              pairing=pairing, quantise=quantise)
        fs, fpost = TE.run_engine(TE.init_engine(cfg, w_init=w, device="cpu"),
                                  torch.from_numpy(x), cfg)
        assert torch.equal(fs.w, ts.w) and torch.equal(fpost, tpost)


def test_engine_sparse_itp_nocomp_matches_reference():
    _assert_engine_match(*_engine_pair("reference", "sparse", rule="itp_nocomp"))


def test_engine_sparse_silent_raster_is_noop():
    cfg = TE.EngineConfig(n_pre=8, n_post=6, backend="sparse")
    state = TE.init_engine(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    out, post = TE.run_engine(state, torch.zeros((20, cfg.n_pre)), cfg)
    assert torch.equal(out.w, state.w)
    assert not bool(post.any())


def test_engine_sparse_capped_is_deterministic_and_bounded():
    a = _engine_pair("sparse", "sparse", density=0.8, max_events=3)
    _, _, b_st, b_post = _engine_pair("sparse", "sparse", density=0.8, max_events=3)
    _assert_engine_match(*a)
    assert torch.equal(a[2].w, b_st.w) and torch.equal(a[3], b_post)
    w = b_st.w
    assert bool(torch.isfinite(w).all()) and float(w.min()) >= 0.0 and float(w.max()) <= 1.0


def test_engine_max_events_validation():
    for bad in (0, -3):
        with pytest.raises(ValueError, match="max_events"):
            TE.EngineConfig(max_events=bad)
    TE.EngineConfig(max_events=1)
    TE.EngineConfig(max_events=None)
    plan = plasticity.make_plan(TE.EngineConfig(backend="sparse", max_events=5), "cpu")
    assert (plan.sparse, plan.use_kernel, plan.max_events) == (True, False, 5)
    assert plasticity.resolve_rule_backend("itp", "sparse") == (False, False)


def test_engine_population_lanes_are_independent():
    cfg = TE.EngineConfig(n_pre=N_PRE, n_post=N_POST, backend="sparse", max_events=6)
    w, x = _engine_inputs(21, 0.3, lanes=(3,))
    pop = TE.init_engine_population(cfg, 3, device="cpu")._replace(w=torch.from_numpy(w))
    ps, ppost = TE.run_engine_population(pop, torch.from_numpy(x), cfg)
    for r in range(3):
        s, post = TE.run_engine(TE.init_engine(cfg, w_init=w[r], device="cpu"),
                                torch.from_numpy(x[r]), cfg)
        assert torch.equal(ps.w[r], s.w) and torch.equal(ppost[r], post)


# ---------------------------------------------------------------------------
# Networks
# ---------------------------------------------------------------------------

NET_CASES = {
    "2layer": ("2layer-snn", (14, 14, 1), {"n_hidden": 30}),
    "dcsnn": ("6layer-dcsnn", (12, 12, 1), {}),
    "csnn": ("5layer-csnn", (64, 2), {"length": 64}),
}


def _net_cfgs(net, shape, kw, backend, jax_backend, **extra):
    jcfg = dataclasses.replace(JS.PAPER_NETWORKS[net]("itp", **kw), input_shape=shape,
                               backend=jax_backend, **extra)
    tcfg = dataclasses.replace(TS.PAPER_NETWORKS[net]("itp", **kw), input_shape=shape,
                               backend=backend, **extra)
    return jcfg, tcfg


def _run_nets(jcfg, tcfg, shape, t=10, batch=2, rate=0.25):
    rng = np.random.default_rng(3)
    raster = (rng.random((t, batch) + shape) < rate).astype(np.float32)
    js0 = JS.init_snn(jax.random.PRNGKey(1), jcfg, batch)
    js, jout = JS.run_snn(js0, jnp.asarray(raster), jcfg, train=True)
    ts, tout = TS.run_snn(snn_state_from_arrays(js0, device="cpu"),
                          torch.from_numpy(raster), tcfg, train=True)
    return js, jout, ts, tout


def _assert_nets_match(js, jout, ts, tout):
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    tw, tl = snn_state_to_numpy(ts)
    jw, jl = snn_state_to_numpy(snn_state_from_arrays(js, device="cpu"))
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a, b, **CONV_TOL)
    for tlay, jlay in zip(tl, jl):
        for th, jh in zip(tlay[1:3], jlay[1:3]):
            if th is not None:
                np.testing.assert_array_equal(th[0], jh[0])


@pytest.mark.parametrize("case", sorted(NET_CASES))
def test_snn_sparse_matches_reference(case):
    net, shape, kw = NET_CASES[case]
    for jax_backend in ("reference", "sparse"):
        jcfg, tcfg = _net_cfgs(net, shape, kw, "sparse", jax_backend)
        js, jout, ts, tout = _run_nets(jcfg, tcfg, shape)
        w0 = JS.init_snn(jax.random.PRNGKey(1), jcfg, 2).weights[0]
        assert not np.array_equal(ts.weights[0].numpy(), np.asarray(w0)), "should learn"
        _assert_nets_match(js, jout, ts, tout)


def test_snn_sparse_capped_is_deterministic():
    net, shape, kw = NET_CASES["2layer"]
    jcfg, tcfg = _net_cfgs(net, shape, kw, "sparse", "sparse", max_events=8)
    js, jout, a, aout = _run_nets(jcfg, tcfg, shape)
    _assert_nets_match(js, jout, a, aout)
    _, _, b, bout = _run_nets(jcfg, tcfg, shape)
    assert torch.equal(aout, bout)
    for wa, wb in zip(a.weights, b.weights):
        assert torch.equal(wa, wb) and bool(torch.isfinite(wa).all())


def test_snn_max_events_validation():
    with pytest.raises(ValueError, match="max_events"):
        TS.mnist_2layer("itp", backend="sparse", max_events=0)
    TS.mnist_2layer("itp", backend="sparse", max_events=4)


# ---------------------------------------------------------------------------
# Serving and the launcher
# ---------------------------------------------------------------------------

def test_serving_sparse_matches_reference():
    """One slice on the reference's sparse serving, carried into the port,
    then one slice on both: post rasters and words exact."""
    n_pre, n_post, t = 16, 8, 6
    rng = np.random.default_rng(5)
    ras = [(rng.random((t, n_pre)) < 0.2).astype(np.float32) for _ in range(6)]
    jstore = JV.SessionStore(JEngineConfig(n_pre=n_pre, n_post=n_post, backend="sparse",
                                           max_events=4))
    tstore = TV.SessionStore(TE.EngineConfig(n_pre=n_pre, n_post=n_post, backend="sparse",
                                             max_events=4), device="cpu")
    scfg_j, scfg_t = JV.ServeConfig(max_batch=4, t_steps=t), TV.ServeConfig(max_batch=4,
                                                                             t_steps=t)
    sids = ("alice", "bob", "carol")
    JV.serve_step(jstore, [JV.Request(s, r) for s, r in zip(sids, ras[:3])], scfg_j)
    for sid in sids:
        tstore.put(sid, session_state_from_arrays(jstore.peek(sid), device="cpu"))
    reqs = list(zip(sids, ras[3:]))
    rj = JV.serve_step(jstore, [JV.Request(s, r) for s, r in reqs], scfg_j)
    rt = TV.serve_step(tstore, [TV.Request(s, r) for s, r in reqs], scfg_t)
    for a, b in zip(rj, rt):
        np.testing.assert_array_equal(np.asarray(a.post), b.post)
    for sid in sids:
        j, p = jstore.peek(sid), tstore.peek(sid)
        for jw, tw in zip((*j.pre_words, *j.post_words), (*p.pre_words, *p.post_words)):
            np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
        np.testing.assert_allclose(p.w.numpy(), np.asarray(j.w), **TOL)


def test_launcher_snn_mode_sparse_smoke(capsys):
    ns = argparse.Namespace(rule="itp", backend="sparse", snn="2layer-snn", steps=4,
                            batch=2, max_events=None, device="cpu")
    summary = train_launcher.run_snn_training(ns)
    assert summary["backend"] == "sparse" and summary["sops_per_s"] > 0
    train_launcher.main(["--snn", "2layer-snn", "--device", "cpu", "--backend", "sparse",
                         "--max-events", "8", "--epochs", "1", "--batches-per-epoch", "1",
                         "--batch", "2", "--t-raster", "4", "--assign-batches", "1",
                         "--eval-batches", "1", "--hidden", "12"])
    assert "itp / sparse / cpu" in capsys.readouterr().out
