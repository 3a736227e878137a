"""repro_torch.models.snn against repro.models.snn: layer shapes and state
layout of the three paper nets; the Izhikevich neuron; OR-pooling; the hard
WTA tie; θ homeostasis; frozen eval; quantised weights on the grid; the
ridge readout; and a trajectory of each paper net from one state carried
across by ``repro_torch.convert`` on the reference, fused and fused_interpret
backends, packed and unpacked, quantise on and off (spike counts and
history words exact, weights rtol=1e-5, atol=1e-5 as in the reference's
tests/test_conv_backend.py, θ and LIF membranes rtol=1e-5, atol=1e-5).

Izhikevich membranes are held within atol=1e-2: jitted XLA on the CPU fuses
the Euler step into FMAs, so the reference's step is off the op-by-op float32
result (which the port, eager JAX and numpy all give bit for bit) by one ulp
in about a fifth of the neurons, and the quadratic term roughly doubles that
gap each step (2.8e-3 after the 16 steps here).  The DCSNN's spikes are
exact on the inputs used here; on other seeds a neuron that close to its
threshold fires in one package only (ROADMAP queue 3 lists such inputs)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import history as JH
from repro.core import lif as JL
from repro.models import snn as JS
from repro_torch.convert import snn_state_from_arrays, snn_state_to_numpy
from repro_torch.core import history as TH
from repro_torch.core import lif as TL
from repro_torch.models import snn as TS

TOL = dict(rtol=1e-5, atol=1e-5)
IZH_TOL = dict(rtol=0.0, atol=1e-2)   # see the module docstring


def _makers(net):
    """(JAX maker, port maker) at a CPU-sized width: the conv nets keep their
    published widths (the CSNN's series is cut to 128 steps), the 2-layer SNN
    has 24 hidden neurons."""
    if net == "2layer-snn":
        return (lambda **k: JS.mnist_2layer(n_hidden=24, **k),
                lambda **k: TS.mnist_2layer(n_hidden=24, **k))
    if net == "5layer-csnn":
        return (lambda **k: JS.fault_csnn(length=128, **k),
                lambda **k: TS.fault_csnn(length=128, **k))
    return JS.PAPER_NETWORKS[net], TS.PAPER_NETWORKS[net]


NETS = ("2layer-snn", "6layer-dcsnn", "5layer-csnn")


@pytest.mark.parametrize("net", NETS)
def test_layer_shapes_and_fan_in_match_reference(net):
    jcfg, tcfg = JS.PAPER_NETWORKS[net](), TS.PAPER_NETWORKS[net]()
    assert TS._layer_shapes(tcfg) == JS._layer_shapes(jcfg)
    assert TS.feature_size(tcfg) == JS.feature_size(jcfg)
    in_shapes = [tuple(jcfg.input_shape)] + JS._layer_shapes(jcfg)
    for spec, in_shape in zip(jcfg.layers, in_shapes):
        assert TS._fan_in(spec, in_shape) == JS._fan_in(spec, in_shape)


@pytest.mark.parametrize("net", NETS)
def test_init_snn_has_the_reference_state_layout(net):
    jmk, tmk = _makers(net)
    js = JS.init_snn(jax.random.PRNGKey(0), jmk(), 3)
    ts = TS.init_snn(tmk(), 3, generator=torch.Generator().manual_seed(0), device="cpu")
    jw, jl = snn_state_to_numpy(snn_state_from_arrays(js, device="cpu"))
    tw, tl = snn_state_to_numpy(ts)
    assert [w.shape for w in tw] == [w.shape for w in jw]
    assert all(w.dtype == np.float32 and 0.2 <= w.min() and w.max() < 0.8 for w in tw)
    flat_j, tree_j = jax.tree_util.tree_flatten(jl)
    flat_t, tree_t = jax.tree_util.tree_flatten(tl)
    assert tree_t == tree_j
    for a, b in zip(flat_t, flat_j):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)      # fresh neurons, histories, θ


def test_init_snn_takes_w_init_and_checks_it():
    cfg = TS.mnist_2layer(n_hidden=5)
    w = np.full((784, 5), 0.25, np.float32)
    st = TS.init_snn(cfg, 2, w_init=[w], device="cpu")
    assert torch.equal(st.weights[0], torch.from_numpy(w))
    with pytest.raises(ValueError, match="shape"):
        TS.init_snn(cfg, 2, w_init=[w[:, :4]], device="cpu")
    with pytest.raises(ValueError, match="learnable layers"):
        TS.init_snn(cfg, 2, w_init=[w, w], device="cpu")


def test_izhikevich_step_matches_reference():
    rng = np.random.default_rng(0)
    v = rng.uniform(-80.0, 35.0, (4, 50)).astype(np.float32)
    u = rng.uniform(-20.0, 5.0, (4, 50)).astype(np.float32)
    i_in = rng.uniform(-5.0, 60.0, (4, 50)).astype(np.float32)
    theta = rng.uniform(0.0, 3.0, (50,)).astype(np.float32)
    for p_kw, offset in (({}, 0.0), ({"dt": 0.5}, theta)):
        jp, tp = JL.IzhikevichParams(**p_kw), TL.IzhikevichParams(**p_kw)

        def ref(v, u, i_in, offset, jp=jp):
            return JL.izhikevich_step(JL.IzhikevichState(v, u), i_in, jp, v_th_offset=offset)

        args = (jnp.asarray(v), jnp.asarray(u), jnp.asarray(i_in), jnp.asarray(offset))
        (tv, tu), ts = TL.izhikevich_step(TL.IzhikevichState(torch.from_numpy(v),
                                                             torch.from_numpy(u)),
                                          torch.from_numpy(i_in), tp,
                                          v_th_offset=torch.as_tensor(offset))
        assert 0 < ts.sum() < ts.numel()
        # op by op (eager) the reference rounds exactly as the port does ...
        (ev, eu), es = ref(*args)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(es))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(ev))
        np.testing.assert_array_equal(tu.numpy(), np.asarray(eu))
        # ... and jitted (fused into FMAs) within float32 rounding
        (jv, ju), js = jax.jit(ref)(*args)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
        np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **TOL)
    jst = JL.izhikevich_init((2, 3), JL.IzhikevichParams())
    tst = TL.izhikevich_init((2, 3), TL.IzhikevichParams(), device="cpu")
    np.testing.assert_array_equal(tst.v.numpy(), np.asarray(jst.v))
    np.testing.assert_array_equal(tst.u.numpy(), np.asarray(jst.u))


@pytest.mark.parametrize("kind,shape", [("pool2d", (2, 9, 7, 3)), ("pool1d", (2, 11, 4))])
def test_pool_step_matches_reference(kind, shape):
    x = np.random.default_rng(1).random(shape) < 0.2
    spec = JS.SNNLayerSpec(kind, pool=2)
    np.testing.assert_array_equal(TS._pool_step(spec, torch.from_numpy(x)).numpy(),
                                  np.asarray(JS._pool_step(spec, jnp.asarray(x))))


def _wta_net(mod, **kw):
    return mod.SNNConfig(name="wta", input_shape=(6,),
                         layers=(mod.SNNLayerSpec("fc", out_features=4),),
                         hard_wta=True, gain=1.0, lif=mod.LIFParams(tau=2.0, v_th=0.1), **kw)


def test_hard_wta_tie_keeps_the_first_index():
    """Neurons 1 and 2 get the same drive, above neuron 0's; both cross the
    threshold, and only neuron 1, the first of the tie, keeps its spike."""
    w = np.zeros((6, 4), np.float32)
    w[:, 0], w[:, 1], w[:, 2], w[:, 3] = 0.3, 0.5, 0.5, 0.0
    x = np.ones((1, 2, 6), np.uint8)
    jcfg, tcfg = _wta_net(JS), _wta_net(TS)
    js = JS.init_snn(jax.random.PRNGKey(0), jcfg, 2)._replace(weights=(jnp.asarray(w),))
    ts = TS.init_snn(tcfg, 2, w_init=[w], device="cpu")
    _, jc = JS.run_snn(js, jnp.asarray(x), jcfg, train=False)
    _, tc = TS.run_snn(ts, torch.from_numpy(x), tcfg, train=False)
    np.testing.assert_array_equal(tc.numpy(), [[0, 1, 0, 0], [0, 1, 0, 0]])
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("tau", [200.0, 50.0, 7.0])
def test_theta_decay_constant_matches_reference(tau):
    got = np.float32(TS.mnist_2layer(theta_tau=tau).theta_decay)
    assert got == np.float32(jnp.exp(-1.0 / tau))


def _digit_raster(seed, batch, t_steps, n_in=784, rate=0.3):
    return (np.random.default_rng(seed).random((t_steps, batch, n_in)) < rate).astype(np.uint8)


def test_train_false_freezes_weights_and_theta():
    cfg = TS.mnist_2layer(n_hidden=16, theta_plus=0.1, backend="fused")
    st = TS.init_snn(cfg, 2, generator=torch.Generator().manual_seed(0), device="cpu")
    x = torch.from_numpy(_digit_raster(0, 2, 10))
    trained, counts = TS.run_snn(st, x, cfg, train=True)
    assert not torch.equal(trained.weights[0], st.weights[0])
    assert trained.layers[0].theta.max() > 0
    frozen, _ = TS.run_snn(trained, x, cfg, train=False)
    assert torch.equal(frozen.weights[0], trained.weights[0])
    assert torch.equal(frozen.layers[0].theta, trained.layers[0].theta)
    assert not torch.equal(frozen.layers[0].neurons.v, trained.layers[0].neurons.v)


def test_reset_dynamics_keeps_weights_and_theta_and_draws_nothing():
    cfg = TS.mnist_2layer(n_hidden=16, theta_plus=0.1)
    gen = torch.Generator().manual_seed(3)
    st = TS.init_snn(cfg, 2, generator=gen, device="cpu")
    st, _ = TS.run_snn(st, torch.from_numpy(_digit_raster(1, 2, 8)), cfg)
    gen_state = gen.get_state()
    torch_state = torch.get_rng_state()
    reset = TS.reset_dynamics(st, cfg, 2)
    assert torch.equal(gen.get_state(), gen_state)
    assert torch.equal(torch.get_rng_state(), torch_state)
    assert reset.weights[0] is st.weights[0]
    assert torch.equal(reset.layers[0].theta, st.layers[0].theta)
    assert not reset.layers[0].post_hist.planes.any()
    assert torch.equal(reset.layers[0].neurons.v, torch.zeros_like(st.layers[0].neurons.v))


@pytest.mark.parametrize("maker", [TS.fmnist_dcsnn, lambda **k: TS.fault_csnn(length=128, **k)],
                         ids=["6layer-dcsnn", "5layer-csnn"])
def test_quantised_conv_weights_stay_on_grid(maker):
    cfg = maker(backend="fused")
    st = TS.init_snn(cfg, 2, generator=torch.Generator().manual_seed(0), device="cpu")
    n_in = int(np.prod(cfg.input_shape))
    st, _ = TS.run_snn(st, torch.from_numpy(_digit_raster(2, 2, 12, n_in)), cfg)
    levels = (1 << (cfg.w_bits - 1)) - 1
    for w in st.weights:
        scaled = w.numpy() * levels
        np.testing.assert_allclose(scaled, np.round(scaled), atol=1e-4)


def test_snn_config_validates_like_the_reference():
    with pytest.raises(ValueError, match="theta_plus"):
        TS.mnist_2layer(theta_plus=-1.0)
    with pytest.raises(ValueError, match="theta_tau"):
        TS.mnist_2layer(theta_tau=0.0)
    cfg = TS.mnist_2layer(n_hidden=10, backend="sparse", max_events=20)
    st = TS.init_snn(cfg, 2, generator=torch.Generator().manual_seed(0), device="cpu")
    raster = (torch.rand((3, 2, 784), generator=torch.Generator().manual_seed(1)) < 0.1)
    st2, counts = TS.run_snn(st, raster.to(torch.float32), cfg)
    assert counts.shape == (2, 10) and not torch.equal(st2.weights[0], st.weights[0])
    assert TS.mnist_2layer(rule="itp_nocomp").compensate is False
    assert TS.mnist_2layer().compensate is True


def test_ridge_readout_matches_reference():
    rng = np.random.default_rng(0)
    feats = rng.poisson(3.0, (60, 12)).astype(np.float32)
    labels = rng.integers(0, 4, 60)
    feats[np.arange(60), labels] += 6.0          # class-selective features
    jw = JS.fit_readout(jnp.asarray(feats), jnp.asarray(labels), 4)
    tw = TS.fit_readout(torch.from_numpy(feats), torch.from_numpy(labels), 4)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-4, atol=1e-4)
    acc = TS.readout_accuracy(tw, torch.from_numpy(feats), torch.from_numpy(labels))
    assert acc == JS.readout_accuracy(jw, jnp.asarray(feats), jnp.asarray(labels)) > 0.9


# --- whole-net trajectories against the reference ---------------------------

# (port backend, reference backend, config overrides); the port's fused
# kernels run their plain versions on CPU tensors, the reference's Pallas
# kernels run in interpret mode
CELLS = {
    "reference": ("reference", "reference", {}),
    "reference-float": ("reference", "reference", {"quantise": False}),
    "fused": ("fused", "fused_interpret", {}),
    "fused-float-wta-theta": ("fused", "fused_interpret",
                              {"quantise": False, "theta_plus": 0.05, "hard_wta": True}),
    "fused-unpacked": ("fused", "fused_interpret", {"packed_history": False}),
    "fused_interpret-float": ("fused_interpret", "fused_interpret", {"quantise": False}),
}


def _assert_states_match(ts, js):
    tw, tl = snn_state_to_numpy(ts)
    jw, jl = snn_state_to_numpy(snn_state_from_arrays(js, device="cpu"))
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a, b, **TOL)
    for tlay, jlay in zip(tl, jl):
        if tlay[0] is None:
            assert jlay[0] is None
            continue
        izhikevich = len(tlay[0]) == 2                       # (v, u) vs LIF (v,)
        for a, b in zip(tlay[0], jlay[0]):                   # neuron state
            np.testing.assert_allclose(a, b, **(IZH_TOL if izhikevich else TOL))
        for th, jh in ((tlay[1], jlay[1]), (tlay[2], jlay[2])):   # histories
            reg_t = TH.registers_depth_major(TH.SpikeHistory(torch.from_numpy(th[0]),
                                                             torch.tensor(int(th[1]))))
            reg_j = JH.registers_depth_major(JH.SpikeHistory(jnp.asarray(jh[0]),
                                                             jnp.int32(jh[1])))
            np.testing.assert_array_equal(reg_t.numpy(), np.asarray(reg_j))
        np.testing.assert_allclose(tlay[3], jlay[3], **TOL)   # θ


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("net", NETS)
def test_net_trajectory_matches_reference(net, cell):
    port_backend, jax_backend, extra = CELLS[cell]
    jmk, tmk = _makers(net)
    jcfg, tcfg = jmk(backend=jax_backend, **extra), tmk(backend=port_backend, **extra)
    batch, t_steps = 2, (16 if net == "6layer-dcsnn" else 8)
    n_in = int(np.prod(jcfg.input_shape))
    raster = _digit_raster(100, batch, t_steps, n_in)
    js0 = JS.init_snn(jax.random.PRNGKey(0), jcfg, batch)
    js, jcounts = JS.run_snn(js0, jnp.asarray(raster), jcfg, train=True)
    ts, tcounts = TS.run_snn(snn_state_from_arrays(js0, device="cpu"),
                             torch.from_numpy(raster), tcfg, train=True)
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    assert tcounts.sum() > 0, "the last layer should spike"
    for w0, w in zip(js0.weights, ts.weights):
        assert not np.array_equal(w.numpy(), np.asarray(w0)), "every layer should learn"
    _assert_states_match(ts, js)


@pytest.mark.parametrize("net", NETS)
def test_packed_trajectory_bit_identical_to_unpacked(net):
    _, tmk = _makers(net)
    cfg = tmk(backend="fused")
    st = TS.init_snn(cfg, 2, generator=torch.Generator().manual_seed(5), device="cpu")
    raster = torch.from_numpy(_digit_raster(5, 2, 10, int(np.prod(cfg.input_shape))))
    sp, cp = TS.run_snn(st, raster, cfg)
    su, cu = TS.run_snn(st, raster, dataclasses.replace(cfg, packed_history=False))
    assert torch.equal(cp, cu)
    assert all(torch.equal(a, b) for a, b in zip(sp.weights, su.weights))


@pytest.mark.parametrize("net", NETS)
def test_fused_trajectory_bit_identical_to_reference(net):
    """The kernels and the reference path sum exact float32 terms in float64
    and round once, so without quantisation the two backends' trajectories
    agree bit for bit (spike flips cannot start from a rounding gap)."""
    _, tmk = _makers(net)
    cfg = tmk(backend="fused", quantise=False)
    st = TS.init_snn(cfg, 2, generator=torch.Generator().manual_seed(6), device="cpu")
    t_steps = 16 if net == "6layer-dcsnn" else 8
    raster = torch.from_numpy(_digit_raster(6, 2, t_steps, int(np.prod(cfg.input_shape))))
    sf, cf = TS.run_snn(st, raster, cfg)
    sr, cr = TS.run_snn(st, raster, dataclasses.replace(cfg, backend="reference"))
    assert cf.sum() > 0
    assert torch.equal(cf, cr)
    assert all(torch.equal(a, b) for a, b in zip(sf.weights, sr.weights))
