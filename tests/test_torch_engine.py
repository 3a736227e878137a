"""repro_torch.core.engine against repro.core.engine: 64×16 trajectories over
32 steps from the same weights and rasters (post spikes, history words and
heads exact; weights and membranes within rtol=1e-5, atol=1e-6), frozen
learning, independent population lanes, packed ≡ unpacked."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.core import history as JH
from repro_torch import plasticity
from repro_torch.core import engine as TE
from repro_torch.core import history as TH
from repro_torch.convert import engine_state_from_arrays, engine_state_to_numpy

TOL = dict(rtol=1e-5, atol=1e-6)
N_PRE, N_POST, T = 64, 16, 32

# (port backend, reference backend, extra config): the port's fused kernel on
# CPU tensors runs its plain version; the reference's runs Pallas interpret
CELLS = {
    "reference": ("reference", "reference", {}),
    "fused": ("fused", "fused_interpret", {}),
    "fused_interpret": ("fused_interpret", "fused_interpret", {}),
    "quantise": ("fused", "fused_interpret", {"quantise": True}),
    "reference_quantise": ("reference", "reference", {"quantise": True}),
    "fused_unpacked": ("fused", "fused_interpret", {"packed_history": False}),
    "fused_all_pairing": ("fused", "fused_interpret", {"pairing": "all"}),
    "itp_nocomp": ("fused", "fused_interpret", {"rule": "itp_nocomp"}),
    "fused_depth10": ("fused", "fused_interpret", {"depth": 10}),
}


def _data(seed, lanes=()):
    rng = np.random.default_rng(seed)
    w = (0.1 * rng.random((*lanes, N_PRE, N_POST))).astype(np.float32)
    x = (rng.random((*lanes, T, N_PRE)) < 0.3).astype(np.float32)
    return w, x


def _words(h):
    """Packed words for depth <= 8, else the depth-major registers."""
    if h.planes.shape[-2] <= 8:
        return TH.pack_words(h).numpy()
    return TH.registers_depth_major(h).numpy()


def _jwords(h):
    if h.planes.shape[0] <= 8:
        return np.asarray(JH.pack_words(h))
    return np.asarray(JH.registers_depth_major(h))


def _assert_match(jstate, jpost, tstate, tpost):
    np.testing.assert_array_equal(np.asarray(jpost), tpost.numpy())
    np.testing.assert_allclose(tstate.w.numpy(), np.asarray(jstate.w), **TOL)
    np.testing.assert_allclose(tstate.neurons.v.numpy(), np.asarray(jstate.neurons.v), **TOL)
    for jh, th in ((jstate.pre_hist, tstate.pre_hist), (jstate.post_hist, tstate.post_hist)):
        np.testing.assert_array_equal(_jwords(jh), _words(th))
        np.testing.assert_array_equal(np.asarray(jh.head), th.head.numpy())


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_trajectory_matches_reference(cell):
    port_backend, jax_backend, extra = CELLS[cell]
    w, x = _data(seed=len(cell))
    jcfg = JE.EngineConfig(n_pre=N_PRE, n_post=N_POST, backend=jax_backend, **extra)
    tcfg = TE.EngineConfig(n_pre=N_PRE, n_post=N_POST, backend=port_backend, **extra)
    js, jpost = JE.run_engine(JE.init_engine(jax.random.PRNGKey(0), jcfg, w_init=w),
                              jnp.asarray(x), jcfg)
    ts, tpost = TE.run_engine(TE.init_engine(tcfg, w_init=w, device="cpu"),
                              torch.from_numpy(x), tcfg)
    assert 0.0 < float(tpost.float().mean()) < 1.0, "trajectory should spike sparsely"
    _assert_match(js, jpost, ts, tpost)


@pytest.mark.parametrize("backend", ("reference", "fused"))
def test_learn_false_freezes_weights(backend):
    w, x = _data(seed=3)
    cfg = TE.EngineConfig(n_pre=N_PRE, n_post=N_POST, backend=backend)
    state = TE.init_engine(cfg, w_init=w, device="cpu")
    frozen, post = TE.run_engine(state, torch.from_numpy(x), cfg, learn=False)
    assert torch.equal(frozen.w, state.w)
    jcfg = JE.EngineConfig(n_pre=N_PRE, n_post=N_POST)
    js, jpost = JE.run_engine(JE.init_engine(jax.random.PRNGKey(0), jcfg, w_init=w),
                              jnp.asarray(x), jcfg, learn=False)
    _assert_match(js, jpost, frozen, post)


def test_population_lanes_are_independent():
    lanes = 3
    w, x = _data(seed=5, lanes=(lanes,))
    cfg = TE.EngineConfig(n_pre=N_PRE, n_post=N_POST, backend="fused")
    pop = TE.init_engine_population(cfg, lanes, device="cpu")
    assert pop.w.shape == (lanes, N_PRE, N_POST) and pop.pre_hist.head.shape == (lanes,)
    pop = pop._replace(w=torch.from_numpy(w))
    states, posts = TE.run_engine_population(pop, torch.from_numpy(x), cfg)
    for i in range(lanes):
        one, post = TE.run_engine(TE.init_engine(cfg, w_init=w[i], device="cpu"),
                                  torch.from_numpy(x[i]), cfg)
        assert torch.equal(post, posts[i])
        assert torch.equal(one.w, states.w[i])
        assert torch.equal(TH.pack_words(one.post_hist), TH.pack_words(states.post_hist)[i])
    # and against the reference's vmapped population
    jcfg = JE.EngineConfig(n_pre=N_PRE, n_post=N_POST, backend="fused_interpret")
    jpop = jax.vmap(lambda wi: JE.init_engine(jax.random.PRNGKey(0), jcfg, w_init=wi))(
        jnp.asarray(w))
    js, jposts = JE.run_engine_population(jpop, jnp.asarray(x), jcfg)
    np.testing.assert_array_equal(np.asarray(jposts), posts.numpy())
    np.testing.assert_allclose(states.w.numpy(), np.asarray(js.w), **TOL)


def test_packed_trajectory_bit_identical_to_unpacked():
    w, x = _data(seed=8)
    cfg = TE.EngineConfig(n_pre=N_PRE, n_post=N_POST, backend="fused")
    runs = [TE.run_engine(TE.init_engine(dataclasses.replace(cfg, packed_history=p),
                                         w_init=w, device="cpu"),
                          torch.from_numpy(x), dataclasses.replace(cfg, packed_history=p))
            for p in (True, False)]
    (a, pa), (b, pb) = runs
    assert torch.equal(pa, pb) and torch.equal(a.w, b.w)
    assert cfg.use_packed_history()
    assert not dataclasses.replace(cfg, depth=10).use_packed_history()


def test_state_conversion_round_trip():
    """A reference state carried into the port continues the same trajectory,
    and the port's state carried back continues it in the reference."""
    w, x = _data(seed=11)
    jcfg = JE.EngineConfig(n_pre=N_PRE, n_post=N_POST, backend="fused_interpret")
    tcfg = TE.EngineConfig(n_pre=N_PRE, n_post=N_POST, backend="fused")
    js, _ = JE.run_engine(JE.init_engine(jax.random.PRNGKey(0), jcfg, w_init=w),
                          jnp.asarray(x[:10]), jcfg)
    ts = engine_state_from_arrays(js, device="cpu")
    js, jpost = JE.run_engine(js, jnp.asarray(x[10:20]), jcfg)
    ts, tpost = TE.run_engine(ts, torch.from_numpy(x[10:20]), tcfg)
    _assert_match(js, jpost, ts, tpost)
    w_, pre, post, neurons = engine_state_to_numpy(ts)
    back = JE.EngineState(jnp.asarray(w_), JH.SpikeHistory(*map(jnp.asarray, pre)),
                          JH.SpikeHistory(*map(jnp.asarray, post)),
                          type(js.neurons)(*map(jnp.asarray, neurons)))
    js, jpost = JE.run_engine(back, jnp.asarray(x[20:]), jcfg)
    ts, tpost = TE.run_engine(ts, torch.from_numpy(x[20:]), tcfg)
    _assert_match(js, jpost, ts, tpost)


def test_unported_cells_fail_at_config_construction():
    for rule in ("mstdp",):
        with pytest.raises(ValueError, match="ROADMAP queue 1 item 12"):
            TE.EngineConfig(rule=rule)
    with pytest.raises(ValueError, match="ROADMAP queue 1 item 11"):
        TE.EngineConfig(backend="sparse")
    with pytest.raises(ValueError, match="unknown learning rule"):
        TE.EngineConfig(rule="bogus")
    with pytest.raises(ValueError, match="pairing"):
        TE.EngineConfig(pairing="bogus")
    with pytest.raises(ValueError, match="max_events"):
        TE.EngineConfig(max_events=0)
    ported = ("exact", "imstdp", "itp", "itp_nocomp", "linear")
    assert plasticity.rule_names() == ported
    assert plasticity.kernel_rule_names() == ported


def test_plan_reads_the_config():
    cfg = TE.EngineConfig(backend="fused_interpret", rule="itp_nocomp", depth=5)
    plan = plasticity.make_plan(cfg, "cpu")
    assert (plan.use_kernel, plan.interpret, plan.packed, plan.compensate) == (
        True, True, True, False)
    assert plan is plasticity.make_plan(cfg, "cpu")          # cached per (cfg, device)
    assert plan.po2[0].dtype == torch.float32 and plan.po2[0].shape == (5,)
    assert plasticity.resolve_rule_backend("itp", "reference") == (False, False)
