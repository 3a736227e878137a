"""The LLSMU multiplier and the fixed-point LIF step of repro_torch against the
JAX package: ``core.llsmu`` function by function, the plain version of the
LLSMU kernel (``kernels/llsmu/ref.py``) against the Pallas kernel in
interpret mode, the signed ops wrapper, and ``core.lif.lif_step_llsmu``.

Every result is an integer and is compared exactly.  The Pallas kernel and
the reference oracle ``llsmu_fixed`` saturate their leading-one counts at
different bits, so beyond 2N-bit operands they part at some widths; the
kernel's plain version follows the kernel there, and equals ``llsmu_fixed``
wherever the reference's two agree."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.core import lif as JL
from repro.core import llsmu as JM
from repro.kernels.llsmu import ops as JO
from repro.kernels.llsmu.kernel import llsmu_multiply as jax_llsmu_multiply
from repro_torch.convert import lif_fixed_state_from_arrays
from repro_torch.core import lif as TL
from repro_torch.core import llsmu as TM
from repro_torch.kernels.llsmu import kernel as TK
from repro_torch.kernels.llsmu import ops as TO
from repro_torch.kernels.llsmu.ref import llsmu_multiply_ref


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x))


def _np(x) -> np.ndarray:
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _edges(top_bit: int) -> np.ndarray:
    """0, 1, and 2^k − 1, 2^k, 2^k + 1 up to bit ``top_bit``."""
    ks = 1 << np.arange(1, top_bit + 1, dtype=np.int64)
    return np.unique(np.concatenate([[0, 1], ks - 1, ks, ks + 1])).clip(0, 2**31 - 1) \
        .astype(np.int32)


def _operands(seed: int, n: int, top: int) -> tuple[np.ndarray, np.ndarray]:
    """``n`` operand pairs below 2^top, log-uniform so every width appears,
    the edge values first."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, top + 1, size=(2, n))
    vals = (rng.integers(0, 2**31 - 1, size=(2, n)) % (1 << bits)).astype(np.int32)
    e = _edges(top - 1)
    k = min(len(e), n)
    vals[0, :k] = e[:k]
    vals[1, :k] = e[::-1][:k]
    return vals[0], vals[1]


# ---------------------------------------------------------------------------
# core.llsmu, function by function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_bits", [18, 24, 31])
def test_floor_log2_matches_reference(max_bits):
    a, b = _operands(max_bits, 2048, 31)
    x = np.concatenate([_edges(30), a, b])
    want = JM.floor_log2(jnp.asarray(x), max_bits=max_bits)
    got = TM.floor_log2(_t(x), max_bits=max_bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), np.asarray(want))


@settings(max_examples=200, deadline=None)
@given(x=st.integers(0, 1 << 16))
def test_floor_log2_exact(x):
    want = x.bit_length() - 1 if x > 0 else 0
    assert int(TM.floor_log2(torch.tensor(x), max_bits=18)) == max(want, 0)


@pytest.mark.parametrize("frac_bits", [8, 12, 14])
@pytest.mark.parametrize("top", [9, 16, 30])
def test_mitchell_fixed_matches_reference(frac_bits, top):
    x, y = _operands(top + frac_bits, 4096, top)
    want = JM.mitchell_fixed(jnp.asarray(x), jnp.asarray(y), frac_bits=frac_bits)
    got = TM.mitchell_fixed(_t(x), _t(y), frac_bits=frac_bits)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_mitchell_float_matches_reference():
    xx, yy = np.meshgrid(np.arange(0, 256, dtype=np.float32), np.arange(0, 256, dtype=np.float32))
    want = np.asarray(JM.mitchell_float(jnp.asarray(xx), jnp.asarray(yy)))
    got = _np(TM.mitchell_float(_t(xx), _t(yy)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_mitchell_error_bound():
    """Minimally-biased Mitchell: |err| ≤ c ≈ 8.34 % worst case, < 3 % mean."""
    xx, yy = torch.meshgrid(torch.arange(1, 256.0), torch.arange(1, 256.0), indexing="xy")
    rel = torch.abs(TM.mitchell_float(xx, yy) - xx * yy) / (xx * yy)
    assert float(rel.max()) < 0.0834
    assert float(rel.mean()) < 0.03


@pytest.mark.parametrize("n_bits", [3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("top", ["2n", 30])
def test_llsmu_fixed_matches_reference(n_bits, top):
    top = 2 * n_bits if top == "2n" else top
    a, b = _operands(10 * n_bits + top, 4096, top)
    want = JM.llsmu_fixed(jnp.asarray(a), jnp.asarray(b), n_bits=n_bits)
    got = TM.llsmu_fixed(_t(a), _t(b), n_bits=n_bits)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_llsmu_signed_matches_reference_on_every_8bit_pair():
    aa, bb = np.meshgrid(np.arange(-255, 256, dtype=np.int32), np.arange(-255, 256, dtype=np.int32))
    want = JM.llsmu_signed(jnp.asarray(aa), jnp.asarray(bb))
    got = TM.llsmu_signed(_t(aa), _t(bb))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_relative_error_matches_reference():
    aa, bb = np.meshgrid(np.arange(256, dtype=np.int32), np.arange(256, dtype=np.int32))
    want = np.asarray(JM.relative_error(jnp.asarray(aa), jnp.asarray(bb), n_bits=4))
    got = _np(TM.relative_error(_t(aa), _t(bb), n_bits=4))
    np.testing.assert_array_equal(got, want)


def test_llsmu_8bit_error():
    """8×8-bit LLSMU: population error small (the paper's NRMSD 0.761 % [29])."""
    aa, bb = torch.meshgrid(torch.arange(256), torch.arange(256), indexing="xy")
    assert float(TM.relative_error(aa, bb, n_bits=4).mean()) < 0.05
    exact = (aa * bb).float()
    approx = TM.llsmu_fixed(aa, bb).float()
    nrmsd = torch.sqrt(torch.mean((approx - exact) ** 2)) / torch.sqrt(torch.mean(exact ** 2))
    assert float(nrmsd) < 0.04


@settings(max_examples=200, deadline=None)
@given(a=st.integers(-255, 255), b=st.integers(-255, 255))
def test_llsmu_signed_sign_correct(a, b):
    got = int(TM.llsmu_signed(torch.tensor(a), torch.tensor(b)))
    want = a * b
    if want == 0:
        assert got == 0
    else:
        assert np.sign(got) == np.sign(want)
        assert abs(got - want) <= 0.7 * abs(want) + 4


def test_llsmu_zero_identity():
    assert int(TM.llsmu_fixed(torch.tensor(0), torch.tensor(77))) == 0
    assert int(TM.llsmu_fixed(torch.tensor(77), torch.tensor(0))) == 0


# ---------------------------------------------------------------------------
# kernel 8's plain version against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_bits", [3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("top", ["2n", 20, 24, 30])
def test_plain_version_matches_pallas_kernel(n_bits, top):
    top = 2 * n_bits if top == "2n" else top
    a, b = _operands(n_bits * 100 + top, 1024, top)
    want = jax_llsmu_multiply(jnp.asarray(a), jnp.asarray(b), n_bits=n_bits, tile=128,
                              interpret=True)
    got = llsmu_multiply_ref(_t(a), _t(b), n_bits=n_bits)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    # the wrapper runs the plain version on CPU tensors, and launches nothing
    before = TK.llsmu_multiply.launches
    assert torch.equal(TK.llsmu_multiply(_t(a), _t(b), n_bits=n_bits), got)
    assert TK.llsmu_multiply.launches == before


@pytest.mark.parametrize("n_bits", [3, 4, 5, 6, 7, 8])
def test_plain_version_equals_oracle_where_the_reference_agrees(n_bits):
    """In range (2N-bit operands) the kernel equals ``llsmu_fixed``; beyond
    it the port's plain version and oracle part exactly where the Pallas
    kernel and the JAX oracle part (none at n_bits=4 up to 2^30)."""
    a, b = _operands(n_bits, 4096, 2 * n_bits)
    assert torch.equal(llsmu_multiply_ref(_t(a), _t(b), n_bits=n_bits),
                       TM.llsmu_fixed(_t(a), _t(b), n_bits=n_bits))
    top = 30 if n_bits == 4 else 2 * n_bits + 14
    a, b = _operands(n_bits + 1, 4096, top)
    port_apart = _np(llsmu_multiply_ref(_t(a), _t(b), n_bits=n_bits)
                     != TM.llsmu_fixed(_t(a), _t(b), n_bits=n_bits))
    jax_apart = (np.asarray(jax_llsmu_multiply(jnp.asarray(a), jnp.asarray(b), n_bits=n_bits,
                                               tile=128, interpret=True))
                 != np.asarray(JM.llsmu_fixed(jnp.asarray(a), jnp.asarray(b), n_bits=n_bits)))
    np.testing.assert_array_equal(port_apart, jax_apart)
    if n_bits == 4:
        assert not port_apart.any()
    print(f"llsmu n_bits={n_bits}: kernel and oracle part on {int(port_apart.sum())} of "
          f"{port_apart.size} products, operands below 2^{top}")


@pytest.mark.parametrize("n_bits", [3, 4, 5, 8])
@pytest.mark.parametrize("top", ["2n", 30])
def test_wrapper_takes_one_element_b(n_bits, top):
    """The kernel wrapper with one ``b`` for every element (the kernel's
    scalar-``b`` variant; its plain version on the CPU) equals the Pallas
    kernel and the plain version on ``b`` broadcast in memory."""
    top = 2 * n_bits if top == "2n" else top
    a, b = _operands(n_bits * 10 + top + 1, 512, top)
    for bv in (0, 1, int(b[-1]), (1 << top) - 1):
        full = np.full_like(a, bv)
        want = np.asarray(jax_llsmu_multiply(jnp.asarray(a), jnp.asarray(full), n_bits=n_bits,
                                             tile=128, interpret=True))
        np.testing.assert_array_equal(_np(llsmu_multiply_ref(_t(a), _t(full), n_bits=n_bits)),
                                      want)
        for one in (torch.tensor(bv, dtype=torch.int32), torch.tensor([bv], dtype=torch.int32)):
            got = TK.llsmu_multiply(_t(a), one, n_bits=n_bits)
            assert got.shape == a.shape and got.dtype == torch.int32
            np.testing.assert_array_equal(_np(got), want)


def test_kernel_constants_reject_widths_the_chain_cannot_hold():
    x = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="n_bits"):
        llsmu_multiply_ref(x, x, n_bits=11)
    with pytest.raises(ValueError, match="frac_bits"):
        llsmu_multiply_ref(x, x, frac_bits=30)


# ---------------------------------------------------------------------------
# the signed ops wrapper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(100,), (128,), (3, 40), (2, 2, 17)])
@pytest.mark.parametrize("n_bits", [3, 4])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_llsmu_ops_matches_reference(shape, n_bits, use_kernel):
    rng = np.random.default_rng(sum(shape) + n_bits)
    hi = 1 << (2 * n_bits)
    a = rng.integers(-hi + 1, hi, size=shape).astype(np.int32)
    b = rng.integers(-hi + 1, hi, size=shape).astype(np.int32)
    want = JO.llsmu(jnp.asarray(a), jnp.asarray(b), n_bits=n_bits, use_kernel=True,
                    interpret=True)
    got = TO.llsmu(_t(a), _t(b), n_bits=n_bits, use_kernel=use_kernel)
    assert got.shape == shape and got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_llsmu_ops_broadcasts_a_scalar_operand():
    a = np.arange(-300, 300, dtype=np.int32).reshape(4, 150)
    want = JO.llsmu(jnp.asarray(a), jnp.asarray(155, jnp.int32), use_kernel=False)
    np.testing.assert_array_equal(_np(TO.llsmu(_t(a), 155)), np.asarray(want))
    np.testing.assert_array_equal(_np(TO.llsmu(_t(a), torch.tensor(155))), np.asarray(want))


@pytest.mark.parametrize("n_bits", [3, 4])
@pytest.mark.parametrize("scalar", [155, -77, 0, 1, -255])
@pytest.mark.parametrize("form", ["int", "0-d", "(1,)"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_llsmu_ops_scalar_operand_equals_materialised_and_reference(n_bits, scalar, form,
                                                                    use_kernel):
    """A one-element ``b`` (a Python int, a 0-d or (1,) tensor) is not
    broadcast in memory, and the int32 product equals the one on ``b``
    broadcast by hand and the JAX package's ``core.llsmu.llsmu_signed`` on
    the same numpy inputs, exactly."""
    rng = np.random.default_rng(n_bits * 1000 + scalar)
    hi = 1 << (2 * n_bits)
    a = rng.integers(-hi + 1, hi, size=(3, 50)).astype(np.int32)
    want = np.asarray(JM.llsmu_signed(jnp.asarray(a), jnp.full(a.shape, scalar, jnp.int32),
                                      n_bits=n_bits))
    full = TO.llsmu(_t(a), _t(np.full_like(a, scalar)), n_bits=n_bits, use_kernel=use_kernel)
    one = {"int": scalar, "0-d": torch.tensor(scalar), "(1,)": torch.tensor([scalar])}[form]
    got = TO.llsmu(_t(a), one, n_bits=n_bits, use_kernel=use_kernel)
    assert got.shape == a.shape and got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(_np(full), want)


# ---------------------------------------------------------------------------
# the fixed-point LIF step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("params", [dict(), dict(tau=20.0, v_th=0.7, e_rest=-0.5)],
                         ids=["defaults", "tau20"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_lif_step_llsmu_matches_reference(params, use_kernel):
    """30 steps at 4×100: Q8 membranes and spikes exact at every step."""
    jp, tp = JL.LIFParams(**params), TL.LIFParams(**params)
    rng = np.random.default_rng(7)
    currents = rng.uniform(-0.3, 0.9, size=(30, 4, 100)).astype(np.float32)
    currents[0, 0, :8] = [0.5 / 256, 1.5 / 256, 2.5 / 256, -0.5 / 256, 0, 1, -1, 3]  # ties
    js = JL.lif_fixed_init((4, 100), jp)
    ts = TL.lif_fixed_init((4, 100), tp)
    np.testing.assert_array_equal(_np(ts.v_q), np.asarray(js.v_q))
    fired = 0
    for i_in in currents:
        js, jspk = JL.lif_step_llsmu(js, jnp.asarray(i_in), jp)
        ts, tspk = TL.lif_step_llsmu(ts, _t(i_in), tp, use_kernel=use_kernel)
        assert ts.v_q.dtype == torch.int32 and tspk.dtype == torch.bool
        np.testing.assert_array_equal(_np(ts.v_q), np.asarray(js.v_q))
        np.testing.assert_array_equal(_np(tspk), np.asarray(jspk))
        fired += int(tspk.sum())
    assert 0 < fired < currents.size


def test_lif_fixed_state_converts_from_reference():
    js = JL.lif_fixed_init((3, 5), JL.LIFParams(e_rest=-0.25), frac_bits=6)
    ts = lif_fixed_state_from_arrays(js, device="cpu")
    assert ts.v_q.dtype == torch.int32
    np.testing.assert_array_equal(_np(ts.v_q), np.asarray(js.v_q))
    assert torch.equal(ts.v_q, TL.lif_fixed_init((3, 5), TL.LIFParams(e_rest=-0.25),
                                                 frac_bits=6).v_q)
