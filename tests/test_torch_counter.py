"""The counter rules (``exact``, ``linear``, ``imstdp``) of repro_torch against
the JAX package: the windows and their ops (kernels 5-6's plain versions),
the rule's state, the engine, the three paper nets, the accuracy protocol,
serving, the deprecated CounterEngine aliases, and the apply layer's choice
of layout from the readout's shape.

The same numpy-made inputs go through both packages; the reference's fused
counter cells do not run on this JAX (its Pallas kernel asks for
``pltpu.TPUMemorySpace``), so the port is held against the reference's
oracles (``repro.kernels.itp_counter.ref``) and its ``reference`` backend.
Tolerances: at the default τ = 4 and depth ≤ 8 (the nets' settings) every
window is bit-exact; at τ = 3 and 7, and for the exponential of delays up to
255, XLA's compiled division and ``exp`` move the last bit of some entries,
held at rtol=atol=1e-6 (the reference's own window tolerance); conv deltas,
whose sums the reference takes in float32, at rtol=atol=1e-5 (its own
kernel-vs-oracle tolerance); multi-step weights at rtol=1e-5, atol=1e-6,
with spikes and counter words exact."""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st
from test_torch_snn import _digit_raster
from test_torch_trainer import ReplaySource, reference_product  # noqa: F401 (fixture)

from repro import serve as JV
from repro.core import engine as JE
from repro.core import stdp as JSTDP
from repro.core.engine import EngineConfig as JEngineConfig
from repro.kernels.itp_counter import ops as JO
from repro.kernels.itp_counter import ref as JR
from repro.kernels.itp_counter.kernel import counter_delays
from repro.launch import cli as JC
from repro.models import snn as JS
from repro.plasticity import apply as JA
from repro.plasticity import get_rule as jget_rule
from repro.train import stdp_trainer as JT
from repro_torch import plasticity
from repro_torch import serve as TV
from repro_torch.convert import (engine_state_from_arrays, engine_state_to_numpy,
                                 session_state_from_arrays, snn_state_from_arrays,
                                 snn_state_to_numpy)
from repro_torch.core import baseline as TB
from repro_torch.core import engine as TE
from repro_torch.core import stdp as TSTDP
from repro_torch.kernels.itp_counter import kernel as TK
from repro_torch.kernels.itp_counter import ops as TO
from repro_torch.kernels.itp_counter import ref as TR
from repro_torch.kernels.itp_stdp_conv.ops import im2col_1d, im2col_2d
from repro_torch.launch import cli as TC
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import snn as TS
from repro_torch.plasticity import apply as TA
from repro_torch.train import stdp_trainer as TT

RULES = ("exact", "linear", "imstdp")
WINDOW_TOL = dict(rtol=1e-6, atol=1e-6)     # the reference's _assert_window_close
CONV_TOL = dict(rtol=1e-5, atol=1e-5)       # the reference's conv kernel-vs-oracle
TOL = dict(rtol=1e-5, atol=1e-6)            # the ROADMAP parity contract
T_STEPS = 48


def _assert_window(got, want, *, exact: bool):
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **WINDOW_TOL)


def _params_kw(p, depth, window):
    return dict(depth=depth, window=window, a_plus=p.a_plus, a_minus=p.a_minus,
                tau_plus=p.tau_plus, tau_minus=p.tau_minus)


# ---------------------------------------------------------------------------
# Windows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", RULES)
@pytest.mark.parametrize("depth", (1, 7, 8, 255))
@pytest.mark.parametrize("tau", (4.0, 3.0, 7.0))
def test_window_magnitudes_match_reference(window, depth, tau):
    """Counter magnitudes over every counter value, validity included, against
    the reference's compiled oracle: bit-exact at τ = 4 up to depth 8."""
    t = np.arange(depth + 1, dtype=np.int32)
    ref = jax.jit(lambda x: JR.counter_magnitudes(x, 1.125, tau, depth=depth,
                                                  window=window))(jnp.asarray(t))
    got = TR.counter_magnitudes(torch.from_numpy(t), 1.125, tau, depth=depth, window=window)
    assert got.dtype == torch.float32 and float(got[-1]) == 0.0     # saturated: gated
    _assert_window(got.numpy(), np.asarray(ref), exact=tau == 4.0 and depth <= 8)
    lut = TR.window_lut(1.125, tau, depth)
    np.testing.assert_allclose(lut.numpy(), np.asarray(JR.window_lut(1.125, tau, depth)),
                               **WINDOW_TOL)
    assert TR.window_lut(1.125, tau, depth) is lut        # built once


@pytest.mark.parametrize("name", ("exact", "itp", "itp_nocomp", "linear", "imstdp"))
def test_stdp_rule_windows_match_reference(name):
    """The explicit-Δt rule family of core/stdp.py (eqs. 17-20) on fractional
    and integer Δt of both signs."""
    dt = np.concatenate([np.linspace(-9.0, 9.0, 73), np.arange(-8, 9)]).astype(np.float32)
    p = JSTDP.STDPParams(tau_plus=3.0)
    want = np.asarray(JSTDP.get_rule(name)(jnp.asarray(dt), p))
    got = TSTDP.get_rule(name)(torch.from_numpy(dt), TSTDP.STDPParams(tau_plus=3.0))
    _assert_window(got.numpy(), want, exact=name in ("linear", "imstdp"))
    np.testing.assert_array_equal(TSTDP.make_imstdp_lut(TSTDP.STDPParams(), 8).numpy(),
                                  np.asarray(JSTDP.make_imstdp_lut(JSTDP.STDPParams(), 8)))
    with pytest.raises(ValueError, match="unknown STDP rule"):
        TSTDP.get_rule("bogus")


def test_compensated_itp_equals_exact_within_an_ulp():
    """eq. 18 on the integer grid: the port's po2 read (exp2 of the
    compensated τ) and the exact window differ by at most one ulp, at k=3 and
    k=7 for τ=4 (ROADMAP queue 3)."""
    k = torch.arange(8, dtype=torch.float32)
    po2 = TSTDP.po2_weights(8, 4.0, compensate=True)
    ex = TR.window_exact(k, 1.0, 4.0, 8)
    np.testing.assert_allclose(po2.numpy(), ex.numpy(), rtol=1.2e-7, atol=0)
    assert torch.nonzero(po2 != ex).flatten().tolist() == [3, 7]


# ---------------------------------------------------------------------------
# Ops: the plain versions of kernels 5-6 through every port path
# ---------------------------------------------------------------------------

def _counter_words(rng, shape, depth):
    # the full live range and the saturated-invalid value
    return rng.integers(0, depth + 1, shape).astype(np.uint8)


@pytest.mark.parametrize("window", RULES)
@pytest.mark.parametrize("n_pre,n_post", [(32, 24), (130, 70)])
@pytest.mark.parametrize("depth", (1, 7, 8, 255))
def test_counter_weight_update_matches_reference(window, n_pre, n_post, depth):
    lanes = 3
    rng = np.random.default_rng(depth + n_pre)
    w = rng.random((lanes, n_pre, n_post)).astype(np.float32)
    pre_s = (rng.random((lanes, n_pre)) < 0.4).astype(np.float32)
    post_s = (rng.random((lanes, n_post)) < 0.4).astype(np.float32)
    pre_t = _counter_words(rng, (lanes, n_pre), depth)
    post_t = _counter_words(rng, (lanes, n_post), depth)
    p = TSTDP.STDPParams()
    kw = dict(depth=depth, window=window, eta=0.25)
    want = np.stack([np.asarray(JR.counter_stdp_update_ref(
        jnp.asarray(w[i]), jnp.asarray(pre_s[i]), jnp.asarray(post_s[i]),
        jnp.asarray(pre_t[i]), jnp.asarray(post_t[i]), **_params_kw(p, depth, window),
        eta=0.25)) for i in range(lanes)])
    args = [torch.from_numpy(x) for x in (w, pre_s, post_s, pre_t, post_t)]
    for path in (dict(), dict(interpret=True), dict(use_kernel=False)):
        got = TO.counter_weight_update(*args, p, **kw, **path)
        assert got.shape == w.shape and got.dtype == torch.float32
        _assert_window(got.numpy(), want, exact=depth <= 8)


@pytest.mark.parametrize("window", RULES)
def test_counter_synapse_delta_matches_reference(window):
    """The fc layers' raw delta: zero weights, eta 1, an unbounded clip,
    every lane in one call."""
    depth, lanes, n_pre, n_post = 7, 4, 48, 40
    rng = np.random.default_rng(3)
    pre_s = (rng.random((lanes, n_pre)) < 0.4).astype(np.float32)
    post_s = (rng.random((lanes, n_post)) < 0.4).astype(np.float32)
    pre_t = _counter_words(rng, (lanes, n_pre), depth)
    post_t = _counter_words(rng, (lanes, n_post), depth)
    p = TSTDP.STDPParams()
    got = TO.counter_synapse_delta(*(torch.from_numpy(x) for x in (pre_s, post_s, pre_t,
                                                                     post_t)),
                                   p, depth=depth, window=window)
    for i in range(lanes):
        want = JO.counter_synapse_delta(jnp.asarray(pre_s[i]), jnp.asarray(post_s[i]),
                                        jnp.asarray(pre_t[i]), jnp.asarray(post_t[i]),
                                        JSTDP.STDPParams(), depth=depth, window=window,
                                        use_kernel=False)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
    assert (got < 0).any() and (got > 0).any()


@pytest.mark.parametrize("window", RULES)
@pytest.mark.parametrize("m,kk,cc", [(48, 18, 12), (130, 50, 24)])
@pytest.mark.parametrize("depth", (1, 7, 8, 255))
def test_conv_counter_delta_matches_reference(window, m, kk, cc, depth):
    rng = np.random.default_rng(m + depth)
    pre = (rng.random((m, kk)) < 0.3).astype(np.float32)
    post = (rng.random((m, cc)) < 0.3).astype(np.float32)
    pre_t, post_t = _counter_words(rng, (m, kk), depth), _counter_words(rng, (m, cc), depth)
    p = TSTDP.STDPParams()
    want = JO.conv_counter_synapse_delta(*(jnp.asarray(x) for x in (pre, post, pre_t, post_t)),
                                         JSTDP.STDPParams(), depth=depth, window=window,
                                         use_kernel=False)
    args = [torch.from_numpy(x) for x in (pre, post, pre_t, post_t)]
    runs = [TO.conv_counter_synapse_delta(*args, p, depth=depth, window=window, **path)
            for path in (dict(), dict(interpret=True), dict(use_kernel=False))]
    for got in runs:
        assert got.shape == (kk, cc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **CONV_TOL)
        assert torch.equal(got, runs[0])
    # the plain version's float64 contraction of the same window values
    ltp = TR.counter_magnitudes(args[2].to(torch.int32), p.a_plus, p.tau_plus, depth=depth,
                                window=window)
    ltd = TR.counter_magnitudes(args[3].to(torch.int32), p.a_minus, p.tau_minus,
                                depth=depth, window=window)
    exact = ((1 - args[0].double()) * ltp.double()).T @ args[1].double() - \
        args[0].double().T @ ((1 - args[1].double()) * ltd.double())
    assert torch.equal(runs[0], exact.float())


def test_counter_ops_check_depth():
    z = torch.zeros(4)
    words = torch.zeros(4, dtype=torch.uint8)
    with pytest.raises(ValueError, match="uint8"):
        TO._check_depth(256)
    TO._check_depth(TO.MAX_COUNTER_DEPTH)
    with pytest.raises(ValueError, match="uint8"):
        TO.counter_weight_update(torch.zeros((4, 4)), z, z, words, words,
                                 TSTDP.STDPParams(), depth=300, window="exact")
    with pytest.raises(ValueError, match="uint8"):
        TO.conv_counter_synapse_delta(torch.zeros((2, 4)), torch.zeros((2, 4)),
                                      torch.zeros((2, 4), dtype=torch.uint8),
                                      torch.zeros((2, 4), dtype=torch.uint8),
                                      TSTDP.STDPParams(), depth=256, window="linear")
    assert TO.counter_lut(TSTDP.STDPParams(), 7).shape == (2, 7)


def test_kernel_wrappers_run_plain_versions_on_cpu_and_count_no_launch():
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.random((2, 6, 5)).astype(np.float32))
    s_pre, s_post = torch.ones((2, 6)), torch.zeros((2, 5))
    t_pre = torch.from_numpy(_counter_words(rng, (2, 6), 7))
    t_post = torch.from_numpy(_counter_words(rng, (2, 5), 7))
    lut = TO.counter_lut(TSTDP.STDPParams(), 7)
    kw = _params_kw(TSTDP.STDPParams(), 7, "imstdp")
    TK.counter_stdp_update.launches = TK.counter_conv_delta.launches = 0
    out = TK.counter_stdp_update(w, s_pre, s_post, t_pre, t_post, lut, **kw)
    assert torch.equal(out, TR.counter_stdp_update_ref(w, s_pre, s_post, t_pre, t_post,
                                                       lut=lut, **kw))
    d = TK.counter_conv_delta(s_pre, s_post, t_pre, t_post, lut, **kw)
    assert torch.equal(d, TR.counter_conv_delta_ref(s_pre, s_post, t_pre, t_post, lut=lut,
                                                    **kw))
    assert (TK.counter_stdp_update.launches, TK.counter_conv_delta.launches) == (0, 0)
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        TK.counter_stdp_update(w.to("meta"), s_pre, s_post, t_pre, t_post, lut, **kw)


# ---------------------------------------------------------------------------
# The rule: state, stepping, words, registry, validation
# ---------------------------------------------------------------------------

@settings(max_examples=40, deadline=None)
@given(data=st.data(), depth=st.integers(1, 8), n=st.integers(1, 9))
def test_counter_word_round_trips_through_delay_formation(data, depth, n):
    """A counter value (the saturated ``depth`` included) survives the port's
    word view and round trip, as it survives the reference's word readout and
    its kernel's in-register Δt formation."""
    ts = data.draw(st.lists(st.integers(0, depth), min_size=n, max_size=n))
    rule, jrule = plasticity.get_rule("exact"), jget_rule("exact")
    state = torch.tensor(ts, dtype=torch.int32)
    words = rule.kernel_view(state, packed=False)
    assert words.dtype == torch.uint8 and torch.equal(words, rule.to_words(state)[0])
    jwords = jrule.readout_packed(jnp.asarray(ts, jnp.int32))
    np.testing.assert_array_equal(words.numpy(), np.asarray(jwords))
    dt, valid = counter_delays(jwords, depth)
    np.testing.assert_array_equal(rule.from_words_state((words,), depth=depth).numpy(),
                                  np.asarray(dt))
    mag = rule.read_magnitudes(rule.readout(state), 1.0, 4.0, depth=depth)
    np.testing.assert_array_equal((mag.numpy() > 0).astype(np.float32), np.asarray(valid))


@settings(max_examples=20, deadline=None)
@given(data=st.data(), depth=st.integers(1, 8), steps=st.integers(0, 12))
def test_counter_state_saturates_and_round_trips_under_stepping(data, depth, steps):
    """The port's step (reset on spike, saturate at ``depth``) follows the
    reference's, never leaves the word range, and its word view stays the
    identity on the counter state."""
    rule, jrule = plasticity.get_rule("linear"), jget_rule("linear")
    n = 4
    state, jstate = rule.init_state(n, depth, device="cpu"), jrule.init_state(n, depth)
    for _ in range(steps):
        spikes = data.draw(st.lists(st.integers(0, 1), min_size=n, max_size=n))
        state = rule.step(state, torch.tensor(spikes), depth=depth)
        jstate = jrule.step(jstate, jnp.asarray(spikes), depth=depth)
    assert state.dtype == torch.int32 and int(state.max()) <= depth
    np.testing.assert_array_equal(state.numpy(), np.asarray(jstate))
    (words,) = rule.to_words(state)
    assert torch.equal(rule.from_words_state((words,), depth=depth), state)
    np.testing.assert_array_equal(rule.last_spikes(state).numpy(),
                                  np.asarray(jrule.last_spikes(jstate)))


def test_counter_state_layout():
    rule = plasticity.get_rule("imstdp")
    state = rule.init_state(5, 255, batch=(3,), device="cpu")
    assert state.shape == (3, 5) and state.dtype == torch.int32 and int(state.min()) == 255
    assert rule.readout(state).shape == (3, 1, 5)
    assert rule.to_words(state)[0].dtype == torch.uint8
    assert rule.words_per_neuron() == 1
    assert rule.read_table(TSTDP.STDPParams(), 9).shape == (2, 9)
    assert plasticity.get_rule("itp").read_table(TSTDP.STDPParams(), 9) is None


def test_registry_and_validation_match_reference():
    assert set(RULES) <= set(plasticity.rule_names())
    assert set(RULES) <= set(plasticity.kernel_rule_names())
    assert isinstance(plasticity.get_rule("exact"), plasticity.CounterRule)
    assert "mstdp" in plasticity.UNPORTED_RULES
    for rule in RULES:
        for backend in ("reference", "fused", "fused_interpret"):
            TE.EngineConfig(rule=rule, backend=backend)
            TS.mnist_2layer(rule, backend=backend)
        with pytest.raises(ValueError) as port:
            TE.EngineConfig(rule=rule, pairing="all")
        with pytest.raises(ValueError) as ref:
            JEngineConfig(rule=rule, pairing="all")
        assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError, match="ROADMAP queue 1 item 11"):
        TE.EngineConfig(rule="exact", backend="sparse")


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

def _engine_data(seed, n_pre=64, n_post=16, lanes=()):
    rng = np.random.default_rng(seed)
    w = (0.1 * rng.random((*lanes, n_pre, n_post))).astype(np.float32)
    x = (rng.random((*lanes, T_STEPS, n_pre)) < 0.3).astype(np.float32)
    return w, x


def _assert_engine_match(js, jpost, ts, tpost, *, exact_windows=True):
    np.testing.assert_array_equal(tpost.numpy(), np.asarray(jpost))
    if exact_windows:
        np.testing.assert_allclose(ts.w.numpy(), np.asarray(js.w), **TOL)
    np.testing.assert_allclose(ts.neurons.v.numpy(), np.asarray(js.neurons.v), **TOL)
    np.testing.assert_array_equal(ts.pre_hist.numpy(), np.asarray(js.pre_hist))
    np.testing.assert_array_equal(ts.post_hist.numpy(), np.asarray(js.post_hist))


ENGINE_CELLS = {
    "reference": ("reference", {}),
    "fused": ("fused", {}),
    "fused_interpret": ("fused_interpret", {}),
    "fused_unpacked": ("fused", {"packed_history": False}),
    "fused_quantise": ("fused", {"quantise": True}),
    "fused_depth255": ("fused", {"depth": 255}),
    "reference_depth12": ("reference", {"depth": 12}),
}


@pytest.mark.parametrize("cell", sorted(ENGINE_CELLS))
@pytest.mark.parametrize("rule", RULES)
def test_engine_matches_reference(rule, cell):
    """48 steps from the same weights and raster: the port (reference, fused
    and fused_interpret, on the CPU) against the JAX reference backend."""
    backend, extra = ENGINE_CELLS[cell]
    w, x = _engine_data(seed=len(cell) + len(rule))
    kw = dict(n_pre=64, n_post=16, rule=rule, eta=0.25, **extra)
    jcfg = JEngineConfig(**kw)
    tcfg = TE.EngineConfig(backend=backend, **kw)
    js, jpost = JE.run_engine(JE.init_engine(jax.random.PRNGKey(0), jcfg, w_init=w),
                              jnp.asarray(x), jcfg)
    ts, tpost = TE.run_engine(TE.init_engine(tcfg, w_init=w, device="cpu"),
                              torch.from_numpy(x), tcfg)
    assert 0.0 < float(tpost.float().mean()) < 1.0
    assert ts.pre_hist.dtype == torch.int32
    _assert_engine_match(js, jpost, ts, tpost)


def test_engine_population_lanes_are_independent():
    lanes = 3
    w, x = _engine_data(seed=5, lanes=(lanes,))
    cfg = TE.EngineConfig(n_pre=64, n_post=16, rule="exact", eta=0.25, backend="fused")
    pop = TE.init_engine_population(cfg, lanes, device="cpu")
    assert pop.pre_hist.shape == (lanes, 64)
    states, posts = TE.run_engine_population(pop._replace(w=torch.from_numpy(w)),
                                             torch.from_numpy(x), cfg)
    jcfg = JEngineConfig(n_pre=64, n_post=16, rule="exact", eta=0.25)
    for i in range(lanes):
        one, post = TE.run_engine(TE.init_engine(cfg, w_init=w[i], device="cpu"),
                                  torch.from_numpy(x[i]), cfg)
        assert torch.equal(post, posts[i]) and torch.equal(one.w, states.w[i])
        assert torch.equal(one.post_hist, states.post_hist[i])
        js, jpost = JE.run_engine(JE.init_engine(jax.random.PRNGKey(0), jcfg, w_init=w[i]),
                                  jnp.asarray(x[i]), jcfg)
        np.testing.assert_array_equal(np.asarray(jpost), posts[i].numpy())


def test_exact_matches_compensated_itp_trajectory():
    """eq. 18 in the port, kernel path against kernel path: the counter rule
    'exact' and the compensated intrinsic-timing rule give the same run
    (their reads differ by one ulp at two delays, below the tolerance)."""
    w, x = _engine_data(seed=9, n_pre=20, n_post=12)
    runs = {}
    for rule in ("itp", "exact"):
        cfg = TE.EngineConfig(n_pre=20, n_post=12, eta=0.25, rule=rule, backend="fused")
        runs[rule] = TE.run_engine(TE.init_engine(cfg, w_init=w, device="cpu"),
                                   torch.from_numpy(x[:, :20]), cfg)
    (s_itp, p_itp), (s_ex, p_ex) = runs["itp"], runs["exact"]
    assert torch.equal(p_itp, p_ex)
    np.testing.assert_allclose(s_ex.w.numpy(), s_itp.w.numpy(), **TOL)


def test_engine_state_conversion_carries_counters():
    w, x = _engine_data(seed=11)
    jcfg = JEngineConfig(n_pre=64, n_post=16, rule="linear", eta=0.25)
    tcfg = TE.EngineConfig(n_pre=64, n_post=16, rule="linear", eta=0.25, backend="fused")
    js, _ = JE.run_engine(JE.init_engine(jax.random.PRNGKey(0), jcfg, w_init=w),
                          jnp.asarray(x[:20]), jcfg)
    ts = engine_state_from_arrays(js, device="cpu")
    assert ts.pre_hist.dtype == torch.int32
    js, jpost = JE.run_engine(js, jnp.asarray(x[20:34]), jcfg)
    ts, tpost = TE.run_engine(ts, torch.from_numpy(x[20:34]), tcfg)
    _assert_engine_match(js, jpost, ts, tpost)
    w_, pre, post, neurons = engine_state_to_numpy(ts)
    assert pre.dtype == np.int32 and pre.shape == (64,)
    back = JE.EngineState(jnp.asarray(w_), jnp.asarray(pre), jnp.asarray(post),
                          type(js.neurons)(*map(jnp.asarray, neurons)))
    js, jpost = JE.run_engine(back, jnp.asarray(x[34:]), jcfg)
    ts, tpost = TE.run_engine(ts, torch.from_numpy(x[34:]), tcfg)
    _assert_engine_match(js, jpost, ts, tpost)


def test_counter_engine_aliases_warn_and_run_the_registry_path():
    with pytest.warns(DeprecationWarning, match=r"rule='exact'"):
        cfg = TB.CounterEngineConfig(n_pre=12, n_post=8, window=7)
    assert isinstance(cfg, TE.EngineConfig) and cfg.rule == "exact" and cfg.depth == 8
    w, x = _engine_data(seed=2, n_pre=12, n_post=8)
    x = x[:25, :12]
    with pytest.warns(DeprecationWarning, match="init_engine"):
        state = TB.init_counter_engine(cfg, w_init=w, device="cpu")
    with pytest.warns(DeprecationWarning, match="run_engine"):
        s_alias, post_alias = TB.run_counter_engine(state, torch.from_numpy(x), cfg)
    with pytest.warns(DeprecationWarning, match="engine_step"):
        _, p1 = TB.counter_engine_step(state, torch.from_numpy(x[0]), cfg)
    assert p1.shape == (8,)
    direct = TE.EngineConfig(n_pre=12, n_post=8, depth=8, rule="exact")
    s_direct, post_direct = TE.run_engine(TE.init_engine(direct, w_init=w, device="cpu"),
                                          torch.from_numpy(x), direct)
    assert torch.equal(s_alias.w, s_direct.w) and torch.equal(post_alias, post_direct)
    # and the reference's aliases compute the same trajectory
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro.core import baseline as JB
        jcfg = JB.CounterEngineConfig(n_pre=12, n_post=8, window=7)
        js, jpost = JB.run_counter_engine(
            JB.init_counter_engine(jax.random.PRNGKey(0), jcfg, w_init=w),
            jnp.asarray(x), jcfg)
    _assert_engine_match(js, jpost, s_alias, post_alias)
    with pytest.warns(DeprecationWarning), pytest.raises(ValueError, match="exact"):
        TB.init_counter_engine(TE.EngineConfig(rule="itp"), device="cpu")
    with pytest.warns(DeprecationWarning), pytest.raises(TypeError, match="returns"):
        TB.run_counter_engine(state, torch.from_numpy(x), object())


# ---------------------------------------------------------------------------
# The apply layer picks the layout from the readout (the repair)
# ---------------------------------------------------------------------------

def _counter_states(seed, n, depth=7, steps=9, rate=0.3):
    """One numpy raster stepped through both packages' counter rules."""
    rng = np.random.default_rng(seed)
    rule, jrule = plasticity.get_rule("exact"), jget_rule("exact")
    state, jstate = rule.init_state(n, depth, device="cpu"), jrule.init_state(n, depth)
    for _ in range(steps):
        s = (rng.random(n) < rate).astype(np.uint8)
        state = rule.step(state, torch.from_numpy(s), depth=depth)
        jstate = jrule.step(jstate, jnp.asarray(s), depth=depth)
    return jstate, state


# every port cell that hands a counter rule's words to the plan: the reference
# backend (history rules read rows there) and unpacked or deep fused cells
# (history rules read bitplanes there)
PLAN_CELLS = [("reference", {}), ("fused", {}), ("fused_interpret", {}),
              ("fused", {"packed_history": False}),
              ("fused_interpret", {"packed_history": False}),
              ("fused", {"depth": 12})]


@pytest.mark.parametrize("cell", PLAN_CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
@pytest.mark.parametrize("kind", ["conv2d", "conv1d"])
@pytest.mark.parametrize("rule", RULES)
def test_plan_conv_delta_reads_counter_words_on_every_cell(rule, kind, cell):
    backend, extra = cell
    depth = extra.get("depth", 7)
    B, k, stride, C = 2, 3, (1 if kind == "conv2d" else 2), 5
    in_shape = (7, 6, 2) if kind == "conv2d" else (21, 3)
    rng = np.random.default_rng(11)
    s_in = (rng.random((B, *in_shape)) < 0.3).astype(np.float32)
    p = (im2col_2d if kind == "conv2d" else im2col_1d)(torch.from_numpy(s_in), k, stride)
    patches = p.reshape(B, -1, p.shape[-1])
    s_out = (rng.random((B, *p.shape[1:-1], C)) < 0.25).astype(np.float32)
    jpre, tpre = _counter_states(1, B * int(np.prod(in_shape)), depth)
    jpost, tpost = _counter_states(2, s_out.size, depth)
    layers = (JS.SNNLayerSpec(kind, out_features=C, kernel=k, stride=stride),)
    net = dict(name="t", input_shape=in_shape, layers=layers, rule=rule, depth=depth)
    jcfg = JS.SNNConfig(backend="reference", **net)
    tcfg = TS.SNNConfig(backend=backend, **{**net, **extra})
    kw = dict(in_shape=in_shape, kind=kind, kernel=k, stride=stride)
    jd = JA.make_plan(jcfg).conv_delta(jpre, jpost, jnp.asarray(patches.numpy()),
                                       jnp.asarray(s_out), **kw)
    td = TA.make_plan(tcfg, "cpu").conv_delta(tpre, tpost, patches,
                                              torch.from_numpy(s_out), **kw)
    assert td.shape == (k * k * in_shape[-1] if kind == "conv2d" else k * in_shape[-1], C)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **CONV_TOL)


@pytest.mark.parametrize("cell", PLAN_CELLS, ids=lambda c: f"{c[0]}-{c[1]}")
@pytest.mark.parametrize("rule", RULES)
def test_plan_fc_delta_reads_counter_words_on_every_cell(rule, cell):
    backend, extra = cell
    depth = extra.get("depth", 7)
    B, n_in, n_out = 3, 40, 12
    rng = np.random.default_rng(4)
    s_in = (rng.random((B, n_in)) < 0.3).astype(np.float32)
    s_out = (rng.random((B, n_out)) < 0.3).astype(np.float32)
    jpre, tpre = _counter_states(5, B * n_in, depth)
    jpost, tpost = _counter_states(6, B * n_out, depth)
    layers = (JS.SNNLayerSpec("fc", out_features=n_out),)
    net = dict(name="t", input_shape=(n_in,), layers=layers, rule=rule, depth=depth)
    jcfg = JS.SNNConfig(backend="reference", **net)
    tcfg = TS.SNNConfig(backend=backend, **{**net, **extra})
    jd = JA.make_plan(jcfg).fc_delta(jpre, jpost, jnp.asarray(s_in), jnp.asarray(s_out))
    td = TA.make_plan(tcfg, "cpu").fc_delta(tpre, tpost, torch.from_numpy(s_in),
                                            torch.from_numpy(s_out))
    assert td.shape == (n_in, n_out)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)


def test_plan_builds_the_window_table_once():
    cfg = TE.EngineConfig(rule="imstdp", backend="fused", depth=9)
    plan = plasticity.make_plan(cfg, "cpu")
    assert plan.table.shape == (2, 9) and plan.table.dtype == torch.float32
    assert plan is plasticity.make_plan(cfg, "cpu")
    np.testing.assert_array_equal(plan.table.numpy(), TO.counter_lut(cfg.stdp, 9).numpy())
    assert plasticity.make_plan(TE.EngineConfig(backend="fused"), "cpu").table is None


# ---------------------------------------------------------------------------
# The paper nets
# ---------------------------------------------------------------------------

def _net_makers(net):
    if net == "2layer-snn":
        return (lambda r, **k: JS.mnist_2layer(r, n_hidden=24, **k),
                lambda r, **k: TS.mnist_2layer(r, n_hidden=24, **k))
    if net == "5layer-csnn":
        return (lambda r, **k: JS.fault_csnn(r, length=128, **k),
                lambda r, **k: TS.fault_csnn(r, length=128, **k))
    return (lambda r, **k: JS.fmnist_dcsnn(r, **k), lambda r, **k: TS.fmnist_dcsnn(r, **k))


NET_CELLS = [("2layer-snn", "exact"), ("2layer-snn", "linear"), ("2layer-snn", "imstdp"),
             ("5layer-csnn", "exact"), ("5layer-csnn", "linear"), ("6layer-dcsnn", "imstdp")]


@pytest.mark.parametrize("backend", ("reference", "fused"))
@pytest.mark.parametrize("net,rule", NET_CELLS)
def test_net_trajectory_matches_reference(net, rule, backend):
    """Batch 2 over 8 steps (16 for the DCSNN, whose output layer is slower
    to fire; batch 4 over 10 for the fc net) from one state carried across:
    spike counts and counters exact, weights within the parity tolerance."""
    jmk, tmk = _net_makers(net)
    jcfg, tcfg = jmk(rule), tmk(rule, backend=backend)
    batch, t_steps = {"2layer-snn": (4, 10), "5layer-csnn": (2, 8),
                      "6layer-dcsnn": (2, 16)}[net]
    n_in = int(np.prod(jcfg.input_shape))
    raster = _digit_raster(7, batch, t_steps, n_in)
    js0 = JS.init_snn(jax.random.PRNGKey(0), jcfg, batch)
    js, jcounts = JS.run_snn(js0, jnp.asarray(raster), jcfg, train=True)
    ts, tcounts = TS.run_snn(snn_state_from_arrays(js0, device="cpu"),
                             torch.from_numpy(raster), tcfg, train=True)
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    assert tcounts.sum() > 0
    tw, tl = snn_state_to_numpy(ts)
    jw, jl = snn_state_to_numpy(snn_state_from_arrays(js, device="cpu"))
    for w0, a, b in zip(js0.weights, tw, jw):
        assert not np.array_equal(a, np.asarray(w0))
        np.testing.assert_allclose(a, b, **TOL)
    for tlay, jlay in zip(tl, jl):
        if tlay[0] is not None:
            np.testing.assert_array_equal(tlay[1], jlay[1])      # counters
            np.testing.assert_array_equal(tlay[2], jlay[2])


@pytest.mark.parametrize("net,rule", [("6layer-dcsnn", "exact"), ("5layer-csnn", "imstdp")])
def test_fused_net_bit_identical_to_reference_and_unpacked(net, rule):
    """Windows bit-equal and exact float64 sums: fused and reference
    trajectories agree bit for bit; packed_history does not change a
    counter rule's path."""
    _, tmk = _net_makers(net)
    cfg = tmk(rule, backend="fused", quantise=False)
    st_ = TS.init_snn(cfg, 2, generator=torch.Generator().manual_seed(6), device="cpu")
    t_steps = 16 if net == "6layer-dcsnn" else 8
    raster = torch.from_numpy(_digit_raster(6, 2, t_steps, int(np.prod(cfg.input_shape))))
    runs = [TS.run_snn(st_, raster, dataclasses.replace(cfg, **kw))
            for kw in ({}, {"backend": "reference"}, {"packed_history": False})]
    (sf, cf) = runs[0]
    assert cf.sum() > 0
    for s, c in runs[1:]:
        assert torch.equal(cf, c)
        assert all(torch.equal(a, b) for a, b in zip(sf.weights, s.weights))


# ---------------------------------------------------------------------------
# The accuracy protocol with rule="exact"
# ---------------------------------------------------------------------------

def test_bench_accuracy_protocol_exact_on_reference_arrays(reference_product):
    """BENCH_accuracy.json's 2layer-snn protocol (6 epochs × 8 batches × 16 ×
    30 steps, theta_plus 0.05, hard WTA) with the counter rule 'exact', on the
    reference's arrays: the port's curve is the one the JAX package computes,
    epoch for epoch."""
    tcfg_kw = dict(epochs=6, batches_per_epoch=8, batch=16, t_steps=30, assign_batches=6,
                   eval_batches=8, seed=0)
    net_kw = dict(theta_plus=0.05, hard_wta=True)
    jcfg, jt = JS.mnist_2layer("exact", **net_kw), JT.TrainerConfig(**tcfg_kw)
    sampler, n_classes = JC.sampler_for("2layer-snn")
    ref = JT.train_to_accuracy(jcfg, sampler, n_classes, jt)
    got = TT.train_to_accuracy(TS.mnist_2layer("exact", backend="fused", **net_kw),
                               TC.sampler_for("2layer-snn")[0], n_classes,
                               TT.TrainerConfig(**tcfg_kw), device="cpu",
                               source=ReplaySource(jcfg, jt, sampler))
    assert got["rule"] == "exact" and len(got["accuracy_curve"]) == 6
    assert got["accuracy_curve"] == ref["accuracy_curve"]
    assert got["final_accuracy"] > 4 * got["chance"]
    np.testing.assert_array_equal(got["state"].weights[0].numpy(),
                                  np.asarray(ref["state"].weights[0]))


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

N_PRE, N_POST = 16, 8


def _rasters(seed, count, t, rate=0.15):
    rng = np.random.default_rng(seed)
    return [(rng.random((t, N_PRE)) < rate).astype(np.float32) for _ in range(count)]


@pytest.mark.parametrize("rule", RULES)
def test_serving_matches_reference_and_costs_one_byte_per_neuron(rule):
    t = 6
    jcfg = JEngineConfig(n_pre=N_PRE, n_post=N_POST, rule=rule)
    jstore = JV.SessionStore(jcfg)
    scfg_j = JV.ServeConfig(max_batch=4, t_steps=t, theta_plus=0.05)
    scfg_t = TV.ServeConfig(max_batch=4, t_steps=t, theta_plus=0.05)
    sids = ("alice", "bob", "carol")
    ras = _rasters(1, 6, t)
    JV.serve_step(jstore, [JV.Request(s, r) for s, r in zip(sids, ras[:3])], scfg_j)
    stores = {}
    for backend in ("reference", "fused"):
        store = TV.SessionStore(TE.EngineConfig(n_pre=N_PRE, n_post=N_POST, rule=rule,
                                                backend=backend), device="cpu")
        assert store.state_bytes_per_session() == N_PRE + N_POST
        for sid in sids:
            store.put(sid, session_state_from_arrays(jstore.peek(sid), device="cpu"))
        stores[backend] = store
    reqs = list(zip(sids, ras[3:]))
    rj = JV.serve_step(jstore, [JV.Request(s, r) for s, r in reqs], scfg_j)
    results = {b: TV.serve_step(s, [TV.Request(sid, r) for sid, r in reqs], scfg_t)
               for b, s in stores.items()}
    for i, a in enumerate(rj):
        for b in results.values():
            np.testing.assert_array_equal(np.asarray(a.post), b[i].post)
    assert 0 < sum(int(r.post.sum()) for r in results["fused"]) < 3 * t * N_POST
    for sid in sids:
        js = jstore.peek(sid)
        for store in stores.values():
            s = store.peek(sid)
            assert all(x.dtype == torch.uint8 for x in (*s.pre_words, *s.post_words))
            np.testing.assert_array_equal(s.pre_words[0].numpy(), np.asarray(js.pre_words[0]))
            np.testing.assert_array_equal(s.post_words[0].numpy(),
                                          np.asarray(js.post_words[0]))
            np.testing.assert_allclose(s.w.numpy(), np.asarray(js.w), **TOL)
            np.testing.assert_allclose(s.theta.numpy(), np.asarray(js.theta), **TOL)


@pytest.mark.parametrize("backend", ("reference", "fused"))
def test_exact_sessions_interleaved_match_solo_bitwise(backend):
    cfg = TE.EngineConfig(n_pre=N_PRE, n_post=N_POST, rule="exact", backend=backend)
    scfg = TV.ServeConfig(max_batch=4, t_steps=6, theta_plus=0.05)
    ras = _rasters(2, 6, 6)
    inter = TV.Server(cfg, scfg, device="cpu")
    t0 = inter.submit(TV.Request("alice", ras[0]))
    inter.submit(TV.Request("bob", ras[1]))
    inter.submit(TV.Request("carol", ras[2]))
    inter.step()
    t1 = inter.submit(TV.Request("alice", ras[3]))
    inter.submit(TV.Request("bob", ras[4]))
    inter.step()
    solo = TV.Server(cfg, scfg, device="cpu")
    s0 = solo.submit(TV.Request("alice", ras[0]))
    solo.step()
    s1 = solo.submit(TV.Request("alice", ras[3]))
    solo.step()
    np.testing.assert_array_equal(inter.poll(t0).post, solo.poll(s0).post)
    np.testing.assert_array_equal(inter.poll(t1).post, solo.poll(s1).post)
    a, b = inter.store.peek("alice"), solo.store.peek("alice")
    for x, y in zip((a.w, *a.pre_words, *a.post_words, a.v, a.theta),
                    (b.w, *b.pre_words, *b.post_words, b.v, b.theta)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# Launchers
# ---------------------------------------------------------------------------

def test_launchers_run_counter_rules_on_cpu(capsys):
    serve_launcher.main(["--device", "cpu", "--rule", "exact", "--backend", "fused",
                         "--n-pre", "32", "--n-post", "8", "--sessions", "3",
                         "--requests", "5", "--t-steps", "4", "--max-batch", "2",
                         "--depth", "200"])
    out = capsys.readouterr().out
    assert "served 5/5 requests" in out and "plasticity cache: 40 B/session" in out
    train_launcher.main(["--snn", "2layer-snn", "--device", "cpu", "--rule", "imstdp",
                         "--backend", "fused", "--epochs", "1", "--batches-per-epoch", "2",
                         "--batch", "4", "--t-raster", "6", "--hidden", "12",
                         "--assign-batches", "1", "--eval-batches", "1"])
    out = capsys.readouterr().out
    assert "snn training" in out and "imstdp" in out
