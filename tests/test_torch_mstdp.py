"""Reward-modulated ITP-STDP (``rule="mstdp"``) and the port's
:class:`~repro_torch.plasticity.Rank1Rule` against the JAX package.

Mirrors ``tests/test_mstdp.py``: the eligibility word's arithmetic, the
readout row, every backend running and matching the reference, ``r = 0``
freezing learning, ``r < 0`` flipping it, ``replace`` and re-registration,
and the trainer run; and ``tests/test_apply.py``'s third-party rules
(``DecayTraceRule``, ``DenseOnlyRule``), declared again on the port's
``Rank1Rule``, on their declared backends, the undeclared ones refused at
config construction with the reference's messages.  Beyond the reference's
tests: the three nets, serving at 2 B/neuron, the launchers, and the state
carried across by ``repro_torch.convert``.  The sharded crossing is
``tests/test_torch_sharded.py::test_mstdp_sharded_engine_single_device``.

The same numpy-made weights and rasters go to both packages.  Spikes, history
words and eligibility words are held exactly; weights at rtol=1e-5,
atol=1e-6 (the ROADMAP parity contract; the reference's own mstdp tests use
rtol=atol=1e-6), the nets' weights at rtol=atol=1e-5 (the conv tolerance).
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import plasticity as JP
from repro import serve as JV
from repro.core import engine as JE
from repro.core import history as JH
from repro.core.engine import EngineConfig as JEngineConfig
from repro.models import snn as JS
from repro.plasticity import mstdp as JM
from repro_torch import plasticity as TP
from repro_torch import serve as TV
from repro_torch.convert import (engine_state_from_arrays, engine_state_to_numpy,
                                 session_state_from_arrays, snn_state_from_arrays,
                                 snn_state_to_numpy)
from repro_torch.core import engine as TE
from repro_torch.core import history as TH
from repro_torch.kernels.itp_stdp import kernel as TK
from repro_torch.kernels.itp_stdp_conv import kernel as TCK
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import snn as TS
from repro_torch.plasticity import mstdp as TM
from repro_torch.train.stdp_trainer import TrainerConfig, train_to_accuracy

TOL = dict(rtol=1e-5, atol=1e-6)
NET_TOL = dict(rtol=1e-5, atol=1e-5)
T_STEPS = 32
N_PRE, N_POST = 16, 8
BACKENDS = ("reference", "fused", "fused_interpret", "sparse")
# the reference's fused kernels run in interpret mode on the CPU
JAX_BACKEND = {"reference": "reference", "fused": "fused_interpret",
               "fused_interpret": "fused_interpret", "sparse": "sparse"}


def _inputs(seed, rate=0.3, n_pre=N_PRE, n_post=N_POST, t=T_STEPS):
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.2, 0.8, (n_pre, n_post)).astype(np.float32)
    x = (rng.random((t, n_pre)) < rate).astype(np.float32)
    return w, x


def _run_port(backend, w, x, rule="mstdp", **kw):
    cfg = TE.EngineConfig(n_pre=w.shape[0], n_post=w.shape[1], rule=rule,
                          backend=backend, **kw)
    state = TE.init_engine(cfg, w_init=w, device="cpu")
    return state, *TE.run_engine(state, torch.from_numpy(x), cfg)


def _run_jax(backend, w, x, rule="mstdp", **kw):
    cfg = JEngineConfig(n_pre=w.shape[0], n_post=w.shape[1], rule=rule, backend=backend,
                        **kw)
    state = JE.init_engine(jax.random.PRNGKey(0), cfg, w_init=w)
    return JE.run_engine(state, jnp.asarray(x), cfg)


def _assert_mstdp_state(jst, tst):
    np.testing.assert_array_equal(np.asarray(JH.pack_words(jst.hist)),
                                  TH.pack_words(tst.hist).numpy())
    np.testing.assert_array_equal(np.asarray(jst.elig), tst.elig.numpy())


@pytest.fixture
def reward(request):
    """Re-register mstdp in both packages with another reward scalar."""
    TP.RULES["mstdp"] = TM.MSTDPRule(reward=request.param)
    JP.RULES["mstdp"] = JM.MSTDPRule(reward=request.param)
    yield request.param
    TP.RULES["mstdp"] = TM.MSTDP
    JP.RULES["mstdp"] = JM.MSTDP


# ---------------------------------------------------------------------------
# The eligibility word
# ---------------------------------------------------------------------------

def test_eligibility_word_shift_decay_and_saturation():
    rule = TP.get_rule("mstdp")
    state = rule.init_state(4, 7, device="cpu")
    assert isinstance(state, TM.MSTDPState) and state.elig.dtype == torch.uint8
    ones = torch.ones((4,))
    for _ in range(10):                 # repeated spiking saturates, never wraps
        state = rule.step(state, ones, depth=7)
    assert bool((state.elig == TM.ELIG_MAX).all())
    state = rule.step(state, torch.zeros((4,)), depth=7)
    assert bool((state.elig == TM.ELIG_MAX >> 1).all())
    state = rule.step(state, torch.zeros((4,)), depth=7)
    assert bool((state.elig == TM.ELIG_MAX >> 2).all())
    state = rule.step(state, ones, depth=7)
    assert bool((state.elig == (TM.ELIG_MAX >> 3) + TM.ELIG_INJECT).all())
    assert (TM.ELIG_INJECT, TM.ELIG_MAX, TM.ELIG_SCALE) == (JM.ELIG_INJECT, JM.ELIG_MAX,
                                                            JM.ELIG_SCALE)


def test_eligibility_and_history_match_reference_on_random_spikes():
    rng = np.random.default_rng(0)
    spikes = (rng.random((40, 3, 11)) < 0.35).astype(np.float32)
    trule, jrule = TP.get_rule("mstdp"), JP.get_rule("mstdp")
    tst = trule.init_state(11, 5, batch=(3,), device="cpu")
    jst = [jrule.init_state(11, 5) for _ in range(3)]
    for t in range(spikes.shape[0]):
        tst = trule.step(tst, torch.from_numpy(spikes[t]), depth=5)
        for lane in range(3):
            jst[lane] = jrule.step(jst[lane], jnp.asarray(spikes[t, lane]), depth=5)
            np.testing.assert_array_equal(np.asarray(jst[lane].elig), tst.elig[lane].numpy())
    for lane in range(3):
        np.testing.assert_array_equal(
            np.asarray(jrule.readout(jst[lane])),
            trule.readout(tst)[lane].numpy())


def test_readout_is_one_extra_register_row():
    rule = TP.get_rule("mstdp")
    state = rule.step(rule.init_state(6, 5, device="cpu"), torch.ones((6,)), depth=5)
    arr = rule.readout(state)
    assert arr.shape == (6, 6) and arr.dtype == torch.uint8
    assert torch.equal(arr[:-1], TH.registers_depth_major(state.hist))
    assert torch.equal(arr[-1], state.elig)
    assert torch.equal(rule.last_spikes(state), torch.ones(6))
    # Rank1Rule's kernel view is the rows whatever `packed` is: the packed
    # kernels 1 and 3 are never reached
    assert torch.equal(rule.kernel_view(state, packed=True), arr)


def test_magnitudes_match_reference():
    rng = np.random.default_rng(1)
    tstate = TP.get_rule("mstdp").init_state(30, 7, device="cpu")
    for _ in range(9):
        spikes = torch.from_numpy((rng.random(30) < 0.4).astype(np.float32))
        tstate = TP.get_rule("mstdp").step(tstate, spikes, depth=7)
    jstate = JM.MSTDPState(JH.SpikeHistory(jnp.asarray(tstate.hist.planes.numpy()),
                                           jnp.int32(int(tstate.hist.head))),
                           jnp.asarray(tstate.elig.numpy()))
    for pairing in ("nearest", "all"):
        for compensate in (True, False):
            kw = dict(depth=7, pairing=pairing, compensate=compensate)
            got = TP.get_rule("mstdp").magnitudes(tstate, 1.125, 4.0, **kw)
            want = JP.get_rule("mstdp").magnitudes(jstate, 1.125, 4.0, **kw)
            assert float(got.abs().max()) > 0.0
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# Every backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_mstdp_runs_on_every_backend(backend):
    w, x = _inputs(2)
    state0, final, _ = _run_port(backend, w, x)
    assert bool(torch.isfinite(final.w).all())
    assert float(final.w.min()) >= 0.0 and float(final.w.max()) <= 1.0
    assert not torch.equal(final.w, state0.w)
    assert final.pre_hist.elig.dtype == torch.uint8


@pytest.mark.parametrize("backend", BACKENDS)
def test_mstdp_backends_match_reference(backend):
    """The port's cell against the reference's ``reference`` backend and
    against its own cell of the same name."""
    w, x = _inputs(3)
    _, got, post = _run_port(backend, w, x)
    for jax_backend in {"reference", JAX_BACKEND[backend]}:
        ref, jpost = _run_jax(jax_backend, w, x)
        np.testing.assert_array_equal(post.numpy(), np.asarray(jpost))
        np.testing.assert_allclose(got.w.numpy(), np.asarray(ref.w), **TOL)
        _assert_mstdp_state(ref.pre_hist, got.pre_hist)
        _assert_mstdp_state(ref.post_hist, got.post_hist)


@pytest.mark.parametrize("cfg_kw", ({"pairing": "all"}, {"quantise": True},
                                    {"compensate": False}, {"max_events": 3}))
def test_mstdp_fused_and_sparse_options_match_reference(cfg_kw):
    w, x = _inputs(4, rate=0.5)
    for backend in ("fused", "sparse"):
        if "max_events" in cfg_kw and backend != "sparse":
            continue
        _, got, post = _run_port(backend, w, x, **cfg_kw)
        ref, jpost = _run_jax(JAX_BACKEND[backend], w, x, **cfg_kw)
        np.testing.assert_array_equal(post.numpy(), np.asarray(jpost))
        np.testing.assert_allclose(got.w.numpy(), np.asarray(ref.w), **TOL)


def test_fused_mstdp_reads_a_depth1_magnitude_plane(monkeypatch):
    """The fused engine runs kernel 2's body on a one-row plane with the unit
    po2 vector, and never the packed kernels (1, 3)."""
    seen = []
    real = TK.itp_stdp_update_ref

    def spy(w, pre, post, pre_hist, post_hist, po2_ltp, po2_ltd, **kw):
        seen.append((tuple(pre_hist.shape), po2_ltp.tolist(), po2_ltd.tolist(), kw["nearest"]))
        return real(w, pre, post, pre_hist, post_hist, po2_ltp, po2_ltd, **kw)

    def refuse(*args, **kw):
        raise AssertionError("a Rank1Rule reached a packed kernel")

    # on CPU tensors the kernel wrappers run these plain versions
    monkeypatch.setattr(TK, "itp_stdp_update_ref", spy)
    monkeypatch.setattr(TK, "itp_stdp_update_packed_ref", refuse)
    monkeypatch.setattr(TCK, "itp_stdp_conv_delta_packed_ref", refuse)
    w, x = _inputs(5, t=4)
    _run_port("fused", w, x)
    assert seen and all(s == ((1, N_PRE), [1.0], [1.0], False) for s in seen)
    cfg = TS.fmnist_dcsnn("mstdp", backend="fused")
    cfg = dataclasses.replace(cfg, input_shape=(10, 10, 1))
    st = TS.init_snn(cfg, 1, generator=torch.Generator().manual_seed(0), device="cpu")
    TS.run_snn(st, (torch.rand((3, 1, 10, 10, 1)) < 0.3).float(), cfg)


def test_mstdp_state_carries_across_packages():
    """A JAX mstdp engine state becomes the port's and comes back unchanged;
    the continued trajectories agree."""
    w, x = _inputs(6)
    js, _ = _run_jax("reference", w, x[:16])
    ts = engine_state_from_arrays(js, device="cpu")
    assert isinstance(ts.pre_hist, TM.MSTDPState)
    back = engine_state_to_numpy(ts)
    (planes, head), elig = back[1]
    np.testing.assert_array_equal(planes, np.asarray(js.pre_hist.hist.planes))
    assert int(head) == int(js.pre_hist.hist.head)
    np.testing.assert_array_equal(elig, np.asarray(js.pre_hist.elig))
    cfg = TE.EngineConfig(n_pre=N_PRE, n_post=N_POST, rule="mstdp", backend="sparse")
    ts, tpost = TE.run_engine(ts, torch.from_numpy(x[16:]), cfg)
    jcfg = JEngineConfig(n_pre=N_PRE, n_post=N_POST, rule="mstdp", backend="reference")
    js, jpost = JE.run_engine(js, jnp.asarray(x[16:]), jcfg)
    np.testing.assert_array_equal(tpost.numpy(), np.asarray(jpost))
    np.testing.assert_allclose(ts.w.numpy(), np.asarray(js.w), **TOL)
    _assert_mstdp_state(js.pre_hist, ts.pre_hist)


# ---------------------------------------------------------------------------
# Reward semantics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reward", [0.0], indirect=True)
@pytest.mark.parametrize("backend", ("reference", "fused", "sparse"))
def test_zero_reward_freezes_learning(reward, backend):
    w, x = _inputs(7)
    state0, final, _ = _run_port(backend, w, x)
    assert torch.equal(final.w, state0.w)


@pytest.mark.parametrize("reward", [-1.0], indirect=True)
def test_negative_reward_flips_update_direction(reward):
    w, x = _inputs(8)
    state0, neg, _ = _run_port("reference", w, x)
    jneg, _ = _run_jax("reference", w, x)
    np.testing.assert_allclose(neg.w.numpy(), np.asarray(jneg.w), **TOL)
    TP.RULES["mstdp"] = TM.MSTDP                 # reward=+1 for the comparison run
    _, pos, _ = _run_port("reference", w, x)
    TP.RULES["mstdp"] = TM.MSTDPRule(reward=-1.0)
    dw_pos = (pos.w - state0.w).numpy()
    dw_neg = (neg.w - state0.w).numpy()
    moved = dw_pos != 0.0
    assert moved.any()
    assert (np.sign(dw_neg[moved]) != np.sign(dw_pos[moved])).mean() > 0.5


@pytest.mark.parametrize("reward", [0.5], indirect=True)
def test_reward_is_static_replace_field(reward):
    assert TP.get_rule("mstdp").reward == 0.5
    assert dataclasses.replace(TM.MSTDP, reward=0.25).reward == 0.25
    # a plan is built for the rule registered now, not for the config alone
    cfg = TE.EngineConfig(rule="mstdp")
    assert TP.make_plan(cfg, "cpu").rule.reward == 0.5
    TP.register_rule(TM.MSTDPRule(reward=2.0))
    assert TP.make_plan(cfg, "cpu").rule.reward == 2.0


# ---------------------------------------------------------------------------
# Networks, the trainer, serving and the launchers
# ---------------------------------------------------------------------------

NET_CASES = {
    "2layer": ("2layer-snn", (14, 14, 1), {"n_hidden": 30}),
    "dcsnn": ("6layer-dcsnn", (12, 12, 1), {}),
    "csnn": ("5layer-csnn", (64, 2), {"length": 64}),
}


@pytest.mark.parametrize("backend", ("fused", "sparse"))
@pytest.mark.parametrize("case", sorted(NET_CASES))
def test_mstdp_nets_match_reference(case, backend):
    net, shape, kw = NET_CASES[case]
    jcfg = dataclasses.replace(JS.PAPER_NETWORKS[net]("mstdp", **kw), input_shape=shape)
    tcfg = dataclasses.replace(TS.PAPER_NETWORKS[net]("mstdp", **kw), input_shape=shape,
                               backend=backend)
    rng = np.random.default_rng(9)
    raster = (rng.random((10, 2) + shape) < 0.25).astype(np.float32)
    js0 = JS.init_snn(jax.random.PRNGKey(1), jcfg, 2)
    js, jout = JS.run_snn(js0, jnp.asarray(raster), jcfg, train=True)
    ts, tout = TS.run_snn(snn_state_from_arrays(js0, device="cpu"), torch.from_numpy(raster),
                          tcfg, train=True)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert not np.array_equal(ts.weights[0].numpy(), np.asarray(js0.weights[0]))
    tw, tl = snn_state_to_numpy(ts)
    jw, jl = snn_state_to_numpy(snn_state_from_arrays(js, device="cpu"))
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a, b, **NET_TOL)
    for tlay, jlay in zip(tl, jl):
        for th, jh in zip(tlay[1:3], jlay[1:3]):
            if th is not None:
                np.testing.assert_array_equal(th[0][0], jh[0][0])     # planes
                np.testing.assert_array_equal(th[1], jh[1])           # eligibility


def test_mstdp_through_stdp_trainer():
    from repro_torch.launch import cli

    sampler, n_classes = cli.sampler_for("2layer-snn")
    cfg = TS.mnist_2layer("mstdp", n_hidden=16, backend="fused", theta_plus=0.05,
                          hard_wta=True)
    tcfg = TrainerConfig(epochs=1, batches_per_epoch=2, batch=4, t_steps=10,
                         assign_batches=2, eval_batches=2)
    r = train_to_accuracy(cfg, sampler, n_classes, tcfg, device="cpu")
    assert len(r["accuracy_curve"]) == 1
    assert np.isfinite(r["final_accuracy"])
    assert r["sim_steps"] == 2 * 10


@pytest.mark.parametrize("backend", ("reference", "fused", "sparse"))
def test_mstdp_serving_matches_reference_at_two_bytes_per_neuron(backend):
    t = 6
    rng = np.random.default_rng(10)
    ras = [(rng.random((t, N_PRE)) < 0.25).astype(np.float32) for _ in range(6)]
    jstore = JV.SessionStore(JEngineConfig(n_pre=N_PRE, n_post=N_POST, rule="mstdp",
                                           backend=JAX_BACKEND[backend]))
    tstore = TV.SessionStore(TE.EngineConfig(n_pre=N_PRE, n_post=N_POST, rule="mstdp",
                                             backend=backend), device="cpu")
    assert tstore.plan.words_per_neuron() == 2
    assert tstore.state_bytes_per_session() == 2 * (N_PRE + N_POST)
    scfg_j = JV.ServeConfig(max_batch=4, t_steps=t, theta_plus=0.05)
    scfg_t = TV.ServeConfig(max_batch=4, t_steps=t, theta_plus=0.05)
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
        assert len(p.pre_words) == 2
        for jw, tw in zip((*j.pre_words, *j.post_words), (*p.pre_words, *p.post_words)):
            np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
        np.testing.assert_allclose(p.w.numpy(), np.asarray(j.w), **TOL)


def test_mstdp_interleaved_matches_solo_bitwise():
    cfg = TE.EngineConfig(n_pre=N_PRE, n_post=N_POST, rule="mstdp", backend="fused")
    scfg = TV.ServeConfig(max_batch=4, t_steps=6)
    rng = np.random.default_rng(11)
    ras = [(rng.random((6, N_PRE)) < 0.25).astype(np.float32) for _ in range(3)]
    inter = TV.Server(cfg, scfg, device="cpu")
    t0 = inter.submit(TV.Request("alice", ras[0]))
    inter.submit(TV.Request("bob", ras[1]))
    inter.step()
    t1 = inter.submit(TV.Request("alice", ras[2]))
    inter.step()
    solo = TV.Server(cfg, scfg, device="cpu")
    s0 = solo.submit(TV.Request("alice", ras[0]))
    solo.step()
    s1 = solo.submit(TV.Request("alice", ras[2]))
    solo.step()
    np.testing.assert_array_equal(inter.poll(t0).post, solo.poll(s0).post)
    np.testing.assert_array_equal(inter.poll(t1).post, solo.poll(s1).post)
    a, b = inter.store.peek("alice"), solo.store.peek("alice")
    for x, y in zip((a.w, *a.pre_words, *a.post_words), (b.w, *b.pre_words, *b.post_words)):
        assert torch.equal(x, y)


def test_launchers_run_mstdp_on_cpu(capsys):
    serve_launcher.main(["--device", "cpu", "--rule", "mstdp", "--backend", "fused",
                         "--n-pre", "32", "--n-post", "8", "--sessions", "3",
                         "--requests", "5", "--t-steps", "4", "--max-batch", "2"])
    out = capsys.readouterr().out
    assert "served 5/5 requests" in out and "rule=mstdp" in out
    assert "plasticity cache: 80 B/session" in out            # 2 B × (32 + 8)
    summary = train_launcher.run_snn_training(argparse.Namespace(
        rule="mstdp", backend="sparse", snn="2layer-snn", steps=4, batch=2,
        max_events=16, device="cpu"))
    assert (summary["rule"], summary["backend"]) == ("mstdp", "sparse")


# ---------------------------------------------------------------------------
# Third-party rules on the port's Rank1Rule (tests/test_apply.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DecayTraceRule(TP.Rank1Rule):
    """A per-neuron decaying uint8 trace: a spike injects 64, each step
    halves it (saturating at 127); the magnitude is ``amplitude·trace/128``."""

    name: str = "thirdparty_trace"

    def init_state(self, n, depth, *, batch=(), device=None):
        return torch.zeros((*batch, n), dtype=torch.uint8, device=device)

    def step(self, state, spikes, *, depth):
        fired = torch.as_tensor(spikes, device=state.device).to(torch.uint8)
        return torch.clamp((state >> 1) + fired * 64, max=127)

    def readout(self, state):
        return state.unsqueeze(-2)

    def read_magnitudes(self, arr, amplitude, tau, *, depth, pairing="nearest",
                        compensate=True):
        return amplitude * arr[..., 0, :].to(torch.float32) / 128.0

    def last_spikes(self, state):
        return (state >= 64).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class DenseOnlyRule(DecayTraceRule):
    """The same trace, declaring the reference datapath only."""

    name: str = "thirdparty_dense"
    has_kernel: bool = False
    has_sparse: bool = False


@dataclasses.dataclass(frozen=True)
class JaxDecayTraceRule(JP.Rank1Rule):
    """The reference's ``tests/test_apply.py`` rule, for the parity runs."""

    name: str = "thirdparty_trace"

    def init_state(self, n, depth):
        return jnp.zeros((n,), jnp.uint8)

    def step(self, state, spikes, *, depth):
        fired = jnp.asarray(spikes).astype(jnp.uint8)
        return jnp.minimum((state >> 1) + fired * jnp.uint8(64), jnp.uint8(127))

    def readout(self, state):
        return state[None, :]

    def magnitudes_from_readout(self, arr, amplitude, tau, *, depth, pairing="nearest",
                                compensate=True):
        return amplitude * arr[0].astype(jnp.float32) / 128.0

    def last_spikes(self, state):
        return (state >= jnp.uint8(64)).astype(jnp.float32)


@dataclasses.dataclass(frozen=True)
class JaxDenseOnlyRule(JaxDecayTraceRule):
    name: str = "thirdparty_dense"
    has_kernel: bool = False
    has_sparse: bool = False


@pytest.fixture
def third_party_rules():
    rules = [(TP, TP.register_rule(DecayTraceRule())), (TP, TP.register_rule(DenseOnlyRule())),
             (JP, JP.register_rule(JaxDecayTraceRule())),
             (JP, JP.register_rule(JaxDenseOnlyRule()))]
    yield
    for pkg, rule in rules:
        pkg.RULES.pop(rule.name, None)


@pytest.mark.parametrize("backend", BACKENDS)
def test_third_party_rule_runs_on_declared_backends(backend, third_party_rules):
    w, x = _inputs(12, rate=0.4, t=24)
    state0, final, post = _run_port(backend, w, x, rule="thirdparty_trace", eta=0.25)
    assert bool(torch.isfinite(final.w).all())
    assert float(final.w.min()) >= 0.0 and float(final.w.max()) <= 1.0
    assert not torch.equal(final.w, state0.w)
    assert final.pre_hist.dtype == torch.uint8
    ref, jpost = _run_jax(JAX_BACKEND[backend], w, x, rule="thirdparty_trace", eta=0.25)
    np.testing.assert_array_equal(post.numpy(), np.asarray(jpost))
    np.testing.assert_allclose(final.w.numpy(), np.asarray(ref.w), **TOL)
    np.testing.assert_array_equal(final.pre_hist.numpy(), np.asarray(ref.pre_hist))


def test_undeclared_backends_fail_at_config_construction(third_party_rules):
    for backend in ("fused_interpret", "fused", "sparse"):
        with pytest.raises(ValueError) as port:
            TE.EngineConfig(rule="thirdparty_dense", backend=backend)
        with pytest.raises(ValueError) as ref:
            JEngineConfig(rule="thirdparty_dense", backend=backend)
        assert str(port.value) == str(ref.value)
        assert ("no fused kernel" if backend != "sparse" else "no event-driven") in str(
            port.value)
    assert "thirdparty_trace" in TP.sparse_rule_names()
    assert "thirdparty_dense" not in TP.kernel_rule_names()


def test_dense_only_rule_runs_on_reference(third_party_rules):
    w, x = _inputs(13, rate=0.4, n_pre=12, n_post=6, t=12)
    _, final, _ = _run_port("reference", w, x, rule="thirdparty_dense", eta=0.25)
    ref, _ = _run_jax("reference", w, x, rule="thirdparty_dense", eta=0.25)
    np.testing.assert_allclose(final.w.numpy(), np.asarray(ref.w), **TOL)
