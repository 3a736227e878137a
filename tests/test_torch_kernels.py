"""The port's fused ITP-STDP ops against the JAX package's.

On CPU tensors the port's kernel wrappers run the kernel's plain version;
the JAX side runs its Pallas kernels in interpret mode (as
tests/test_kernels.py does).  Ragged shapes (200×72, 130×257), depths 1..8
and both pairings; weights within rtol=1e-5, atol=1e-6.  Inside the port the
packed and unpacked paths are bit-identical.  The CUDA kernels are held
against their plain versions on the card by tests/test_torch_gpu.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import history as JH
from repro.core.stdp import STDPParams as JParams
from repro.kernels.itp_stdp import ops as JO
from repro_torch.core import history as TH
from repro_torch.core.stdp import STDPParams as TParams
from repro_torch.kernels import _build
from repro_torch.kernels import dispatch as D
from repro_torch.kernels.itp_stdp import kernel as TK
from repro_torch.kernels.itp_stdp import ops as TO

TOL = dict(rtol=1e-5, atol=1e-6)
PAIRINGS = ("nearest", "all")


def _inputs(n_pre, n_post, depth, seed, lanes=()):
    rng = np.random.default_rng(seed)
    mask = np.uint8((0xFF << (8 - depth)) & 0xFF)
    return dict(
        w=rng.random((*lanes, n_pre, n_post)).astype(np.float32),
        pre_s=(rng.random((*lanes, n_pre)) < 0.4).astype(np.float32),
        post_s=(rng.random((*lanes, n_post)) < 0.4).astype(np.float32),
        pre_w=rng.integers(0, 256, (*lanes, n_pre)).astype(np.uint8) & mask,
        post_w=rng.integers(0, 256, (*lanes, n_post)).astype(np.uint8) & mask,
    )


def _t(x):
    return {k: torch.from_numpy(v) for k, v in x.items()}


def _bits(words, depth):
    return TH.unpack_words(words, depth).transpose(-1, -2).to(torch.float32)


@pytest.mark.parametrize("pairing", PAIRINGS)
@pytest.mark.parametrize("depth", range(1, 9))
@pytest.mark.parametrize("shape", ((200, 72), (130, 257)))
def test_packed_update_matches_pallas_interpret(shape, depth, pairing):
    x = _inputs(*shape, depth, seed=depth)
    kw = dict(depth=depth, pairing=pairing, eta=0.3, w_min=0.0, w_max=1.0)
    j = JO.weight_update_packed(*map(jnp.asarray, x.values()), JParams(),
                                use_kernel=True, interpret=True, **kw)
    t = TO.weight_update_packed(*_t(x).values(), TParams(), **kw)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("pairing", PAIRINGS)
@pytest.mark.parametrize("depth", (1, 7, 8, 11))
@pytest.mark.parametrize("shape", ((200, 72), (130, 257)))
def test_depth_major_update_matches_pallas_interpret(shape, depth, pairing):
    rng = np.random.default_rng(depth)
    x = _inputs(*shape, 1, seed=depth)
    pre_b = (rng.random((depth, shape[0])) < 0.4).astype(np.float32)
    post_b = (rng.random((depth, shape[1])) < 0.4).astype(np.float32)
    kw = dict(pairing=pairing, eta=0.3)
    args = (x["w"], x["pre_s"], x["post_s"], pre_b, post_b)
    j = JO.weight_update_depth_major(*map(jnp.asarray, args), JParams(),
                                     use_kernel=True, interpret=True, **kw)
    t = TO.weight_update_depth_major(*map(torch.from_numpy, args), TParams(), **kw)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("pairing", PAIRINGS)
@pytest.mark.parametrize("depth", range(1, 9))
def test_packed_bit_identical_to_unpacked(depth, pairing):
    """One kernel body: words and their bitplanes give the same bits, also
    through the fused_interpret route and with a lane axis."""
    x = _t(_inputs(61, 45, depth, seed=50 + depth, lanes=(3,)))
    kw = dict(pairing=pairing, eta=0.3)
    packed = TO.weight_update_packed(x["w"], x["pre_s"], x["post_s"], x["pre_w"],
                                     x["post_w"], TParams(), depth=depth, **kw)
    unpacked = TO.weight_update_depth_major(
        x["w"], x["pre_s"], x["post_s"], _bits(x["pre_w"], depth),
        _bits(x["post_w"], depth), TParams(), **kw)
    interp = TO.weight_update_packed(x["w"], x["pre_s"], x["post_s"], x["pre_w"],
                                     x["post_w"], TParams(), depth=depth,
                                     interpret=True, **kw)
    assert torch.equal(packed, unpacked)
    assert torch.equal(packed, interp)
    for lane in range(3):   # lanes never interact
        one = TO.weight_update_packed(x["w"][lane], x["pre_s"][lane], x["post_s"][lane],
                                      x["pre_w"][lane], x["post_w"][lane], TParams(),
                                      depth=depth, **kw)
        assert torch.equal(one, packed[lane])


@pytest.mark.parametrize("packed", (True, False))
def test_engine_weight_update_and_deltas(packed):
    rng = np.random.default_rng(5)
    n_pre, n_post, depth = 40, 24, 7
    jpre, jpost = JH.init_history(n_pre, depth), JH.init_history(n_post, depth)
    tpre, tpost = TH.init_history(n_pre, depth), TH.init_history(n_post, depth)
    for _ in range(5):
        a, b = rng.random(n_pre) < 0.4, rng.random(n_post) < 0.4
        jpre, jpost = JH.push(jpre, jnp.asarray(a)), JH.push(jpost, jnp.asarray(b))
        tpre, tpost = TH.push(tpre, torch.from_numpy(a)), TH.push(tpost, torch.from_numpy(b))
    x = _inputs(n_pre, n_post, depth, seed=9)
    j = JO.engine_weight_update(jnp.asarray(x["w"]), jnp.asarray(x["pre_s"]),
                                jnp.asarray(x["post_s"]), jpre, jpost, JParams(),
                                eta=0.25, packed=packed, interpret=True)
    t = TO.engine_weight_update(torch.from_numpy(x["w"]), torch.from_numpy(x["pre_s"]),
                                torch.from_numpy(x["post_s"]), tpre, tpost, TParams(),
                                eta=0.25, packed=packed)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)

    jd = JO.synapse_delta_packed(jnp.asarray(x["pre_s"]), jnp.asarray(x["post_s"]),
                                 JH.pack_words(jpre), JH.pack_words(jpost), JParams(),
                                 depth=depth, interpret=True)
    td = TO.synapse_delta_packed(torch.from_numpy(x["pre_s"]), torch.from_numpy(x["post_s"]),
                                 TH.pack_words(tpre), TH.pack_words(tpost), TParams(),
                                 depth=depth)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    tu = TO.synapse_delta(torch.from_numpy(x["pre_s"]), torch.from_numpy(x["post_s"]),
                          TH.registers_depth_major(tpre), TH.registers_depth_major(tpost),
                          TParams())
    assert torch.equal(td, tu)


def test_reference_oracle_matches_kernel_plain_version():
    """use_kernel=False (the oracle) and the kernel's plain version agree."""
    x = _t(_inputs(33, 17, 6, seed=2))
    kw = dict(depth=6, pairing="all", eta=0.5)
    a = TO.weight_update_packed(x["w"], x["pre_s"], x["post_s"], x["pre_w"], x["post_w"],
                                TParams(), use_kernel=False, **kw)
    b = TO.weight_update_packed(x["w"], x["pre_s"], x["post_s"], x["pre_w"], x["post_w"],
                                TParams(), **kw)
    assert torch.equal(a, b)


def test_zero_padding_is_exact():
    """Zero words, spikes and weight padding add nothing to the real block."""
    x = _t(_inputs(50, 30, 7, seed=4))
    kw = dict(depth=7, pairing="nearest", eta=0.3)
    ref = TO.weight_update_packed(x["w"], x["pre_s"], x["post_s"], x["pre_w"], x["post_w"],
                                  TParams(), **kw)
    p_pre, p_post = D.round_up(50, D.LANE), D.round_up(30, D.LANE)
    padded = TO.weight_update_packed(
        D.pad_axis(D.pad_axis(x["w"], p_pre, 0), p_post, 1),
        D.pad_axis(x["pre_s"], p_pre, 0), D.pad_axis(x["post_s"], p_post, 0),
        D.pad_axis(x["pre_w"], p_pre, 0), D.pad_axis(x["post_w"], p_post, 0),
        TParams(), **kw)
    assert padded.shape == (128, 128)
    assert torch.equal(padded[:50, :30], ref)


def test_dispatch_matches_reference():
    from repro.kernels import dispatch as JD

    for b in D.BACKENDS:
        assert D.resolve_backend(b) == JD.resolve_backend(b)
    for depth in (1, 8, 9):
        for packed in (True, False):
            for use_kernel in (True, False):
                assert (D.resolve_packed(packed, depth=depth, use_kernel=use_kernel)
                        == JD.resolve_packed(packed, depth=depth, use_kernel=use_kernel))
    with pytest.raises(ValueError, match="unknown backend"):
        D.resolve_backend("bogus")
    assert D.round_up(130, 128) == JD.round_up(130, 128) == 256


def test_cuda_path_raises_instead_of_falling_back():
    """A non-CPU tensor never takes the plain version: the wrapper launches
    the kernel or raises; a host without nvcc cannot build the kernels."""
    x = {k: v.to("meta") for k, v in _t(_inputs(8, 4, 7, seed=1)).items()}
    po2 = [p.to("meta") for p in TO.po2_vectors(TParams(), 7)]
    before = TK.itp_stdp_update_packed.launches
    with pytest.raises(ValueError, match="CUDA device"):
        TK.itp_stdp_update_packed(x["w"], x["pre_s"], x["post_s"], x["pre_w"], x["post_w"],
                                  *po2, depth=7)
    with pytest.raises(ValueError, match="packed history words support"):
        TK.itp_stdp_update_packed(x["w"], x["pre_s"], x["post_s"], x["pre_w"], x["post_w"],
                                  *po2, depth=9)
    assert TK.itp_stdp_update_packed.launches == before
    try:
        _build._nvcc()
    except RuntimeError:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.library("itp_stdp")
