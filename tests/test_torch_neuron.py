"""The fused LIF step of repro_torch (kernel 7's plain version,
``kernels/lif/ref.py``, and ``kernels.lif.ops.lif_step_kernel``) against the
JAX package.

The port rounds every operation to float32 on its own, as the eager JAX
``repro.core.lif.lif_step`` does: against that the step is bit-exact.  The
Pallas kernel in interpret mode, like the jitted ``lif_update_ref``, runs
under XLA, which contracts ``α·(v−E) + E`` into an FMA: against it the
membranes agree within rtol=atol=1e-6 (the reference's own kernel-vs-step
tolerance), one ulp apart on some neurons, and the spikes exactly on these
inputs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lif as JL
from repro.kernels.lif import ops as JO
from repro.kernels.lif.kernel import lif_update as jax_lif_update
from repro_torch.core import lif as TL
from repro_torch.kernels.lif import kernel as TK
from repro_torch.kernels.lif import ops as TO
from repro_torch.kernels.lif.ref import lif_update_ref

PARAMS = {"tau2": dict(tau=2.0, v_th=0.7), "defaults": dict(),
          "tau20_rest": dict(tau=20.0, v_th=1.0, e_rest=-0.5)}


def _inputs(b, n, seed):
    rng = np.random.default_rng(seed)
    v = rng.uniform(-0.5, 1.2, size=(b, n)).astype(np.float32)
    i_in = rng.uniform(0.0, 0.8, size=(b, n)).astype(np.float32)
    return v, i_in


@pytest.mark.parametrize("b,n", [(1, 128), (3, 100), (8, 512), (16, 1024)])
@pytest.mark.parametrize("params", list(PARAMS))
def test_plain_version_bit_equal_to_eager_reference(b, n, params):
    jp, tp = JL.LIFParams(**PARAMS[params]), TL.LIFParams(**PARAMS[params])
    v, i_in = _inputs(b, n, b * n)
    js, jspk = JL.lif_step(JL.LIFState(v=jnp.asarray(v)), jnp.asarray(i_in), jp)
    v2, s = lif_update_ref(torch.from_numpy(v), torch.from_numpy(i_in), alpha=tp.alpha,
                           e_rest=tp.e_rest, v_th=tp.v_th)
    np.testing.assert_array_equal(v2.numpy(), np.asarray(js.v))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jspk).astype(np.float32))
    ts, tspk = TO.lif_step_kernel(TL.LIFState(v=torch.from_numpy(v)), torch.from_numpy(i_in), tp)
    assert tspk.dtype == torch.bool
    np.testing.assert_array_equal(ts.v.numpy(), np.asarray(js.v))
    np.testing.assert_array_equal(tspk.numpy(), np.asarray(jspk))
    # the port's own lif_step too
    ps, pspk = TL.lif_step(TL.LIFState(v=torch.from_numpy(v)), torch.from_numpy(i_in), tp)
    assert torch.equal(ps.v, ts.v) and torch.equal(pspk, tspk)


@pytest.mark.parametrize("b,n", [(1, 128), (3, 100), (8, 512), (16, 1024)])
@pytest.mark.parametrize("params", list(PARAMS))
def test_kernel_step_matches_pallas_kernel(b, n, params):
    """Against ``lif_step_kernel(interpret=True)`` and the Pallas kernel itself:
    membranes within 1e-6, spikes exact; the ulps that differ are counted."""
    jp, tp = JL.LIFParams(**PARAMS[params]), TL.LIFParams(**PARAMS[params])
    v, i_in = _inputs(b, n, b * n + 1)
    js, jspk = JO.lif_step_kernel(JL.LIFState(v=jnp.asarray(v)), jnp.asarray(i_in), jp,
                                  use_kernel=True, interpret=True)
    ts, tspk = TO.lif_step_kernel(TL.LIFState(v=torch.from_numpy(v)), torch.from_numpy(i_in), tp)
    np.testing.assert_allclose(ts.v.numpy(), np.asarray(js.v), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tspk.numpy(), np.asarray(jspk))
    if b % 8 == 0 and n % 512 == 0:   # the Pallas kernel's own tiling, no padding
        kv, ks = jax_lif_update(jnp.asarray(v), jnp.asarray(i_in), alpha=jp.alpha,
                                e_rest=jp.e_rest, v_th=jp.v_th, interpret=True)
        np.testing.assert_allclose(ts.v.numpy(), np.asarray(kv), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(tspk.numpy().astype(np.float32), np.asarray(ks))
    apart = int((ts.v.numpy() != np.asarray(js.v)).sum())
    print(f"lif {params} {b}x{n}: {apart} of {b * n} membranes differ from op-by-op float32 (XLA FMA)")


def test_trajectory_bit_equal_to_eager_reference():
    """30 steps of the kernel step from rest, fed the same currents."""
    jp, tp = JL.LIFParams(), TL.LIFParams()
    rng = np.random.default_rng(30)
    currents = rng.uniform(0.0, 0.8, size=(30, 4, 300)).astype(np.float32)
    js, ts = JL.lif_init((4, 300), jp), TL.lif_init((4, 300), tp, device="cpu")
    for i_in in currents:
        js, jspk = JL.lif_step(js, jnp.asarray(i_in), jp)
        ts, tspk = TO.lif_step_kernel(ts, torch.from_numpy(i_in), tp)
        np.testing.assert_array_equal(ts.v.numpy(), np.asarray(js.v))
        np.testing.assert_array_equal(tspk.numpy(), np.asarray(jspk))


@pytest.mark.parametrize("use_kernel", [True, False])
def test_lif_kernel_1d_api(use_kernel):
    p = TL.LIFParams()
    st = TL.lif_init((40,), p, device="cpu")
    i_in = torch.from_numpy(np.random.default_rng(0).uniform(0, 1.5, 40).astype(np.float32))
    s1, sp1 = TO.lif_step_kernel(st, i_in, p, use_kernel=use_kernel)
    assert s1.v.shape == (40,) and sp1.shape == (40,) and sp1.dtype == torch.bool
    s2, sp2 = TL.lif_step(st, i_in, p)
    assert torch.equal(s1.v, s2.v) and torch.equal(sp1, sp2)


def test_lif_step_kernel_rejects_other_ranks():
    p = TL.LIFParams()
    with pytest.raises(ValueError, match=r"\(batch, n\)"):
        TO.lif_step_kernel(TL.lif_init((2, 3, 4), p, device="cpu"), torch.zeros(2, 3, 4), p)


def test_wrapper_runs_the_plain_version_on_cpu_tensors():
    v, i_in = (torch.from_numpy(x) for x in _inputs(2, 77, 5))
    before = TK.lif_update.launches
    got = TK.lif_update(v, i_in, alpha=0.5, e_rest=0.1, v_th=0.9)
    want = lif_update_ref(v, i_in, alpha=0.5, e_rest=0.1, v_th=0.9)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert TK.lif_update.launches == before
