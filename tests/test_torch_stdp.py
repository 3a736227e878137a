"""repro_torch.core.stdp / core.lif against the JAX reference: the po2 read
vector bit for bit, the magnitude reads, the pair gate, the dense
reference update and the LIF step."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lif as JL
from repro.core import stdp as JS
from repro_torch.core import lif as TL
from repro_torch.core import stdp as TS

TAUS = (4.0, 2.0, 7.3)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("compensate", (True, False))
@pytest.mark.parametrize("tau", TAUS)
def test_po2_weights_bit_exact(tau, compensate):
    """The port's po2 vector is exp2 of the float32 exponent, correctly
    rounded to float32, bit for bit (float64 exp2 as the oracle)."""
    for depth in range(1, 9):
        t = TS.po2_weights(depth, tau, compensate=compensate).numpy()
        tau_eff = tau * TS.LN2 if compensate else tau
        x = -np.arange(depth, dtype=np.float32) / np.float32(tau_eff)
        assert t.dtype == np.float32
        np.testing.assert_array_equal(t, np.exp2(x.astype(np.float64)).astype(np.float32))


@pytest.mark.parametrize("compensate", (True, False))
@pytest.mark.parametrize("tau", TAUS)
def test_po2_weights_within_two_ulps_of_reference(tau, compensate):
    """XLA's CPU exp2 misses the correctly rounded value by a few ulps on
    some entries (tau=4 compensated: k=3 and k=7 by one ulp; tau=2
    compensated: k=6 by two): a reference gap recorded in ROADMAP queue 3.
    Here both packages agree to within two ulps."""
    for depth in range(1, 9):
        j = np.asarray(JS.po2_weights(depth, tau, compensate=compensate))
        t = TS.po2_weights(depth, tau, compensate=compensate).numpy()
        assert _ulps(j, t).max() <= 2


def test_params_compensation_matches():
    p = TS.STDPParams(tau_plus=3.0, tau_minus=5.0).compensated()
    q = JS.STDPParams(tau_plus=3.0, tau_minus=5.0).compensated()
    assert (p.tau_plus, p.tau_minus) == (q.tau_plus, q.tau_minus)


@pytest.mark.parametrize("depth", range(1, 9))
@pytest.mark.parametrize("pairing", ("nearest", "all"))
def test_magnitudes_depth_major(depth, pairing):
    rng = np.random.default_rng(depth)
    planes = (rng.random((depth, 37)) < 0.4).astype(np.uint8)
    j = JS.magnitudes_depth_major(jnp.asarray(planes), 1.125, 4.0, pairing=pairing)
    t = TS.magnitudes_depth_major(torch.from_numpy(planes), 1.125, 4.0, pairing=pairing)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("depth", (1, 4, 7, 8))
def test_history_magnitude_reads(depth):
    rng = np.random.default_rng(10 + depth)
    hist = (rng.random((23, depth)) < 0.4).astype(np.uint8)
    for jf, tf in ((JS.nn_delta_from_history, TS.nn_delta_from_history),
                   (JS.a2a_delta_from_history, TS.a2a_delta_from_history)):
        for comp in (True, False):
            j = jf(jnp.asarray(hist), 1.0, 4.0, compensate=comp)
            t = tf(torch.from_numpy(hist), 1.0, 4.0, compensate=comp)
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)


def test_pair_gate_exact():
    pre = np.array([0, 1, 0, 1], bool)[:, None]
    post = np.array([0, 0, 1, 1], bool)[None, :]
    jltp, jltd = JS.pair_gate(jnp.asarray(pre), jnp.asarray(post))
    tltp, tltd = TS.pair_gate(torch.from_numpy(pre), torch.from_numpy(post))
    np.testing.assert_array_equal(np.asarray(jltp), tltp.numpy())
    np.testing.assert_array_equal(np.asarray(jltd), tltd.numpy())


@pytest.mark.parametrize("pairing", ("nearest", "all"))
@pytest.mark.parametrize("compensate", (True, False))
def test_synapse_update(pairing, compensate):
    rng = np.random.default_rng(7)
    n_pre, n_post, depth = 19, 11, 7
    w = rng.random((n_pre, n_post)).astype(np.float32)
    pre_s = (rng.random(n_pre) < 0.4).astype(np.float32)
    post_s = (rng.random(n_post) < 0.4).astype(np.float32)
    pre_h = (rng.random((n_pre, depth)) < 0.4).astype(np.uint8)
    post_h = (rng.random((n_post, depth)) < 0.4).astype(np.uint8)
    kw = dict(pairing=pairing, compensate=compensate, eta=0.3)
    j = JS.synapse_update(*map(jnp.asarray, (w, pre_s, post_s, pre_h, post_h)),
                          JS.STDPParams(), **kw)
    t = TS.synapse_update(*map(torch.from_numpy, (w, pre_s, post_s, pre_h, post_h)),
                          TS.STDPParams(), **kw)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)


def test_synapse_update_rejects_unknown_pairing():
    z = torch.zeros(2, 2)
    with pytest.raises(ValueError, match="pairing"):
        TS.synapse_update(z, z[0], z[0], z, z, TS.STDPParams(), pairing="bogus")


@pytest.mark.parametrize("with_offset", (False, True))
def test_lif_step(with_offset):
    rng = np.random.default_rng(3)
    p_j, p_t = JL.LIFParams(tau=3.0), TL.LIFParams(tau=3.0)
    v = rng.random(64).astype(np.float32)
    i_in = (2.0 * rng.random(64)).astype(np.float32)
    theta = (0.5 * rng.random(64)).astype(np.float32) if with_offset else 0.0
    js, jsp = JL.lif_step(JL.LIFState(jnp.asarray(v)), jnp.asarray(i_in), p_j,
                          v_th_offset=jnp.asarray(theta) if with_offset else 0.0)
    ts, tsp = TL.lif_step(TL.LIFState(torch.from_numpy(v)), torch.from_numpy(i_in), p_t,
                          v_th_offset=torch.from_numpy(theta) if with_offset else 0.0)
    np.testing.assert_array_equal(np.asarray(jsp), tsp.numpy())
    np.testing.assert_allclose(ts.v.numpy(), np.asarray(js.v), rtol=1e-5, atol=1e-6)
    assert p_t.alpha == p_j.alpha
    np.testing.assert_array_equal(
        np.asarray(JL.lif_init((3,), p_j).v), TL.lif_init((3,), p_t).v.numpy())
