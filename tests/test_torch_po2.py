"""The po2 quantiser of repro_torch (kernels 9-10's plain versions and their
ops), the int8 gradient wire codec and ITP-AdamW, against the JAX package.

The port's encoder reads the code off the float's bits (the encoder
circuit); the reference's goes through XLA's ``log2``, which is not
correctly rounded within a few ulps of √2·2^k.  So the codes are compared
exactly wherever the float64 ``log2|x|`` lies more than 2^-20 from k+½;
inside that band the port's code is the correctly rounded one, and the
tests print how many of the reference's differ.  Subnormals, NaN, ±inf, ±0
and the clip ends are exact.  The decoder is exact on every code.  AdamW
runs 3 steps on a small tree, with and without the po2 update, within
rtol=1e-5, atol=1e-6 (the parity tolerance); elements whose reference update
``u`` falls in the tie band are counted, not compared."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.distributed import compression as JC
from repro.kernels.po2_quant import kernel as JK
from repro.kernels.po2_quant import ops as JO
from repro.kernels.po2_quant import ref as JR
from repro.train import optimizer as JOPT
from repro_torch.convert import (opt_state_from_arrays, opt_state_to_numpy, tree_from_arrays,
                                 tree_to_numpy)
from repro_torch.distributed import compression as TC
from repro_torch.kernels.po2_quant import kernel as TK
from repro_torch.kernels.po2_quant import ops as TO
from repro_torch.kernels.po2_quant import ref as TR
from repro_torch.train import optimizer as TOPT
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

BAND = 2.0 ** -20


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def in_tie_band(x: np.ndarray) -> np.ndarray:
    """Where float64 log2|x| lies within 2^-20 of k+½ (finite, non-zero x)."""
    mag = np.abs(x.astype(np.float64))
    with np.errstate(divide="ignore", invalid="ignore"):
        lg = np.log2(mag)
    frac = lg - np.floor(lg)
    return np.isfinite(lg) & (np.abs(frac - 0.5) <= BAND)


def correctly_rounded_codes(x: np.ndarray) -> np.ndarray:
    """The code of the correctly rounded round(log2|x|), from float64."""
    x64 = x.astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        e = np.clip(np.round(np.log2(np.abs(x64))), -63, 63)
    code = np.where(np.isfinite(e), e, 0).astype(np.int64) + 64
    code |= np.where(x64 < 0, 128, 0)
    tiny = ~np.isfinite(x64) | (np.abs(x64) < np.finfo(np.float32).tiny)
    return np.where(tiny & ~np.isinf(x64), 0, np.where(np.isinf(x64), 127 | code & 128, code))


def _values(seed: int, n: int) -> np.ndarray:
    """Normals scaled by e^U(−20, 20), both signs, and log-uniform values over
    the whole float32 range."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n) * np.exp(rng.uniform(-20, 20, n))
    b = np.exp2(rng.uniform(-149, 128, n)) * rng.choice([-1.0, 1.0], n)
    with np.errstate(over="ignore"):
        return np.concatenate([a, b]).astype(np.float32)


def _tie_band_values() -> np.ndarray:
    """The float32 values within 6 ulps of √2·2^k, k ∈ [−70, 69]."""
    centres = np.float32(np.sqrt(2.0) * np.exp2(np.arange(-70, 70))).view(np.int32)
    vals = (centres[:, None] + np.arange(-6, 7, dtype=np.int32)[None, :]).astype(np.int32)
    vals = vals.reshape(-1).view(np.float32)
    return np.concatenate([vals, -vals])


# ---------------------------------------------------------------------------
# the encoder: codes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_codes_match_reference_outside_the_tie_band(seed):
    x = _values(seed, 100_000)
    want = np.asarray(JR.po2_encode_ref(jnp.asarray(x)))
    got = TR.po2_encode_ref(_t(x)).numpy()
    band = in_tie_band(x)
    np.testing.assert_array_equal(got[~band], want[~band])
    np.testing.assert_array_equal(got, correctly_rounded_codes(x))
    print(f"po2 seed {seed}: {int(band.sum())} of {x.size} values in the tie band, "
          f"{int((got != want).sum())} reference codes differ")


def test_codes_match_pallas_kernel_outside_the_tie_band():
    x = _values(3, 2048)
    want = np.asarray(JK.po2_encode(jnp.asarray(x), tile=128, interpret=True))
    got = TR.po2_encode_ref(_t(x)).numpy()
    band = in_tie_band(x)
    np.testing.assert_array_equal(got[~band], want[~band])


def test_tie_band_codes_are_correctly_rounded():
    x = _tie_band_values()
    got = TR.po2_encode_ref(_t(x)).numpy()
    # the side of √2·2^k decides; float64 holds both exactly enough
    above = np.abs(x.astype(np.float64)) >= np.sqrt(2.0) * np.exp2(np.floor(np.log2(np.abs(
        x.astype(np.float64)))))
    e = np.clip(np.floor(np.log2(np.abs(x.astype(np.float64)))) + above, -63, 63)
    want = (e.astype(np.int64) + 64) | np.where(x < 0, 128, 0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, correctly_rounded_codes(x))
    ref = np.asarray(JR.po2_encode_ref(jnp.asarray(x)))
    torch_log2 = (torch.clamp(torch.round(torch.log2(torch.abs(_t(x)))), -63, 63).to(torch.int64)
                  + 64).numpy() | np.where(x < 0, 128, 0)
    print(f"po2 tie band: {x.size} values; {int((ref != got).sum())} reference codes "
          f"(XLA log2) differ from the correctly rounded ones; a torch.log2 encoder "
          f"would differ from the reference on {int((torch_log2 != ref).sum())}")


EDGES = {
    "+0": (0.0, 0), "-0": (-0.0, 0), "nan": (math.nan, 0), "-nan": (-math.nan, 0),
    "+inf": (math.inf, 127), "-inf": (-math.inf, 255),
    "min_subnormal": (1e-45, 0), "subnormal": (1e-40, 0), "-subnormal": (-1e-40, 0),
    "large_subnormal": (5e-39, 0), "min_normal": (1.1754944e-38, 1),
    "-min_normal": (-1.1754944e-38, 129), "1e-38": (1e-38, 0),
    "2^-64": (2.0 ** -64, 1), "2^-63": (2.0 ** -63, 1), "2^-62": (2.0 ** -62, 2),
    "2^62": (2.0 ** 62, 126), "2^63": (2.0 ** 63, 127), "2^64": (2.0 ** 64, 127),
    "max": (3.4028235e38, 127), "-max": (-3.4028235e38, 255), "1": (1.0, 64),
    "-1": (-1.0, 192), "1.5": (1.5, 65), "1.4": (1.4, 64),
}


@pytest.mark.parametrize("name", list(EDGES))
def test_edge_value_codes(name):
    """Each on its own: the port's code, the reference's, the literal."""
    value, code = EDGES[name]
    x = np.array([value], np.float32)
    got = int(TR.po2_encode_ref(_t(x))[0])
    assert got == code
    assert got == int(np.asarray(JR.po2_encode_ref(jnp.asarray(x)))[0])


def test_encoder_keeps_shape_and_dtype():
    x = _t(_values(4, 60).reshape(2, 3, 20))
    codes = TR.po2_encode_ref(x)
    assert codes.shape == (2, 3, 20) and codes.dtype == torch.int32
    assert int(codes.min()) >= 0 and int(codes.max()) <= 255
    assert torch.equal(TR.po2_encode_ref(x[:, 1]), codes[:, 1])   # strided input


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------

def test_decoder_exact_on_every_code():
    codes = np.arange(256, dtype=np.int32)
    got = TR.po2_decode_ref(_t(codes)).numpy()
    np.testing.assert_array_equal(
        got.view(np.int32), np.asarray(JR.po2_decode_ref(jnp.asarray(codes))).view(np.int32))
    np.testing.assert_array_equal(
        got, np.asarray(JK.po2_decode(jnp.asarray(codes), tile=128, interpret=True)))
    mag = codes & 127
    want = np.where(mag == 0, 0.0, np.where(codes & 128, -1.0, 1.0) * np.exp2(mag - 64.0))
    np.testing.assert_array_equal(got, want.astype(np.float32))
    # only the low byte is read; code 0 and 128 decode to +0
    np.testing.assert_array_equal(TR.po2_decode_ref(_t(codes + 256 * 7)).numpy(), got)
    assert np.signbit(got[[0, 128]]).sum() == 0


def test_exact_exp2_int_matches_reference():
    e = np.arange(-126, 128, dtype=np.int32)
    np.testing.assert_array_equal(TR.exact_exp2_int(_t(e)).numpy(),
                                  np.asarray(JR.exact_exp2_int(jnp.asarray(e))))
    np.testing.assert_array_equal(TR.exact_exp2_int(_t(e)).numpy(),
                                  np.exp2(e.astype(np.float64)).astype(np.float32))


# ---------------------------------------------------------------------------
# the round trip, the ops and the wrappers on the CPU
# ---------------------------------------------------------------------------

@settings(max_examples=100, deadline=None)
@given(x=st.floats(-1e6, 1e6, allow_nan=False, width=32))
def test_po2_roundtrip_properties(x):
    q = float(TR.po2_roundtrip_ref(torch.tensor(x, dtype=torch.float32)))
    if x == 0.0 or abs(x) < 1.2e-38:   # zero / f32-subnormal underflow → 0
        assert q == 0.0 or np.sign(q) == np.sign(x)
    else:
        assert np.sign(q) == np.sign(x)
        if 1e-15 < abs(x) < 1e15:
            ratio = q / x
            assert 0.7071 / 1.001 <= ratio <= 1.4143 * 1.001
            m, _ = np.frexp(abs(q))
            assert m == 0.5


@settings(max_examples=100, deadline=None)
@given(x=st.floats(-1e10, 1e10, allow_nan=False, width=32))
def test_po2_wire_format_byte_range(x):
    c = int(TR.po2_encode_ref(torch.tensor(x, dtype=torch.float32)))
    assert 0 <= c < 256


@pytest.mark.parametrize("n", [1, 77, 128, 500])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_po2_quantize_matches_reference(n, use_kernel):
    x = _values(n, n)[:n]
    want = np.asarray(JO.po2_quantize(jnp.asarray(x), use_kernel=True, interpret=True))
    got = TO.po2_quantize(_t(x), use_kernel=use_kernel).numpy()
    band = in_tie_band(x)
    np.testing.assert_array_equal(got[~band], want[~band])
    np.testing.assert_array_equal(got, TR.po2_roundtrip_ref(_t(x)).numpy())


def test_po2_quantize_tree():
    rng = np.random.default_rng(5)
    tree = {"b": {"c": rng.standard_normal((8, 9)).astype(np.float32)},
            "a": rng.standard_normal(37).astype(np.float32)}
    want = JO.po2_quantize_tree(jax.tree_util.tree_map(jnp.asarray, tree))
    got = TO.po2_quantize_tree(tree_from_arrays(tree, device="cpu"), use_kernel=True)
    assert sorted(got) == ["a", "b"]
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        nz = np.abs(g.numpy())[g.numpy() != 0]
        assert (np.frexp(nz)[0] == 0.5).all()


def test_wrappers_run_the_plain_versions_on_cpu_tensors():
    x = _t(_values(6, 300))
    before = (TK.po2_encode.launches, TK.po2_decode.launches)
    codes = TK.po2_encode(x)
    assert torch.equal(codes, TR.po2_encode_ref(x))
    assert torch.equal(TK.po2_decode(codes), TR.po2_decode_ref(codes))
    assert (TK.po2_encode.launches, TK.po2_decode.launches) == before


# ---------------------------------------------------------------------------
# the int8 wire codec
# ---------------------------------------------------------------------------

def test_wire_codec_matches_reference():
    x = _values(7, 20_000)
    band = in_tie_band(x)
    wire = TC._encode_int8(_t(x))
    assert wire.dtype == torch.int8
    want = np.asarray(JC._encode_int8(jnp.asarray(x)))
    np.testing.assert_array_equal(wire.numpy()[~band], want[~band])
    back = TC._decode_int8(wire).numpy()
    np.testing.assert_array_equal(back, TR.po2_roundtrip_ref(_t(x)).numpy())
    np.testing.assert_array_equal(back[~band],
                                  np.asarray(JC._decode_int8(jnp.asarray(want)))[~band])


def test_po2_relative_error_bound():
    g = (np.random.default_rng(8).standard_normal(10_000) * 1e-3).astype(np.float32)
    err = float(TC.compression_error({"g": _t(g)}))
    assert err < 0.25
    want = float(JC.compression_error({"g": jnp.asarray(g)}))
    assert err == pytest.approx(want, rel=1e-5)


def test_po2_signs_and_zeros():
    q = TR.po2_roundtrip_ref(torch.tensor([0.0, 1.5, -1.5, 3e-7, -3e-7]))
    assert float(q[0]) == 0.0
    assert float(q[1]) > 0 > float(q[2])
    assert float(q[3]) > 0 > float(q[4])


# ---------------------------------------------------------------------------
# trees and ITP-AdamW
# ---------------------------------------------------------------------------

def _tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    shapes = {"embed": {"tok": (64, 32)}, "final_norm": {"scale": (32,)},
              "blocks": {"attn": {"wq": (2, 32, 48), "q_norm": (2, 16)},
                         "mlp": {"up": (2, 32, 40)}}}
    return jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s) * 0.5).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))


def test_tree_leaves_in_reference_order():
    tree = _tree(0)
    ours = tree_leaves(tree_from_arrays(tree, device="cpu"))
    theirs = jax.tree_util.tree_leaves(tree)
    assert len(ours) == len(theirs) == 5
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a.numpy(), b)
    back = tree_to_numpy(tree_unflatten(tree, ours))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    with pytest.raises(ValueError, match="more leaves"):
        tree_unflatten({"a": 0}, [1, 2])
    assert tree_map(lambda x: x + 1, {"b": (1, [2]), "a": 3}) == {"a": 4, "b": (2, [3])}


@pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 101, 5000, 9999, 10_000, 20_000])
@pytest.mark.parametrize("warmup", [100, 0])
def test_lr_schedule_matches_reference(step, warmup):
    cfg = dict(warmup_steps=warmup, total_steps=10_000)
    want = float(JOPT.lr_schedule(JOPT.OptimizerConfig(**cfg), jnp.asarray(step, jnp.int32)))
    got = float(TOPT.lr_schedule(TOPT.OptimizerConfig(**cfg), torch.tensor(step, dtype=torch.int32)))
    assert got == pytest.approx(want, rel=1e-6, abs=0)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    tree = _tree(1)
    want, wnorm = JOPT.clip_by_global_norm(jax.tree_util.tree_map(jnp.asarray, tree), max_norm)
    got, norm = TOPT.clip_by_global_norm(tree_from_arrays(tree, device="cpu"), max_norm)
    assert float(norm) == pytest.approx(float(wnorm), rel=1e-6)
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)


def _reference_u(cfg, params, grads, state, new_state):
    """The reference's update ``u`` before quantisation, from its own moments
    (eager jnp, the same operations as inside ``adamw_update``)."""
    grads = jax.tree_util.tree_map(lambda g: g.astype(jnp.float32), grads)
    step = new_state.step.astype(jnp.float32)
    bc1, bc2 = 1 - cfg.beta1 ** step, 1 - cfg.beta2 ** step
    out = []
    for p, m, v in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(new_state.mu),
                       jax.tree_util.tree_leaves(new_state.nu)):
        u = (m / bc1) / (jnp.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p
        out.append(np.asarray(u))
    return out


@pytest.mark.parametrize("po2_update", [False, True])
@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
def test_adamw_matches_reference_for_three_steps(po2_update, grad_clip):
    kw = dict(po2_update=po2_update, grad_clip=grad_clip, warmup_steps=2, lr=1e-2)
    jcfg, tcfg = JOPT.OptimizerConfig(**kw), TOPT.OptimizerConfig(**kw)
    params = _tree(2)
    # weights that put the step-1 update u ≈ 1 + 0.1·w around √2, one ulp of w
    # (≈ 4.8e-8 of u) apart, so that some fall in the tie band
    tok = params["embed"]["tok"].reshape(-1)
    tok[:96] = np.float32((np.sqrt(2.0) - 1.0) / 0.1) + np.arange(-48, 48) * 4.77e-7
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = tree_from_arrays(params, device="cpu")
    js, ts = JOPT.init_opt_state(jp), TOPT.init_opt_state(tp)
    assert ts.step.dtype == torch.int32 and float(ts.step) == 0
    masks = [np.zeros(x.shape, bool) for x in jax.tree_util.tree_leaves(params)]
    in_band = 0
    for step in range(3):
        g = _tree(10 + step)
        g["embed"]["tok"].reshape(-1)[:96] = 0.3
        jg, tg = jax.tree_util.tree_map(jnp.asarray, g), tree_from_arrays(g, device="cpu")
        jp_new, js_new, jm = JOPT.adamw_update(jcfg, jp, jg, js)
        tp_new, ts_new, tm = TOPT.adamw_update(tcfg, tp, tg, ts)
        if po2_update:
            for i, u in enumerate(_reference_u(jcfg, jp, jg, js, js_new)):
                band = in_tie_band(u)
                in_band += int((band & ~masks[i]).sum())
                masks[i] |= band
        assert int(ts_new.step) == int(js_new.step) == step + 1
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
        leaves = zip(tree_leaves(tp_new), tree_leaves(ts_new.mu), tree_leaves(ts_new.nu),
                     jax.tree_util.tree_leaves(jp_new), jax.tree_util.tree_leaves(js_new.mu),
                     jax.tree_util.tree_leaves(js_new.nu), masks)
        for p, m, v, wp, wm, wv, mask in leaves:
            np.testing.assert_allclose(m.numpy(), np.asarray(wm), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(v.numpy(), np.asarray(wv), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(p.numpy()[~mask], np.asarray(wp)[~mask],
                                       rtol=1e-5, atol=1e-6)
        jp, js, tp, ts = jp_new, js_new, tp_new, ts_new
    if po2_update:
        assert in_band > 0
        for p in tree_leaves(tp):
            assert p.dtype == torch.float32
    print(f"adamw po2_update={po2_update} grad_clip={grad_clip}: {in_band} elements in the "
          f"tie band counted, not compared")


def test_adamw_kernel_and_plain_quantiser_agree_on_cpu():
    cfg = TOPT.OptimizerConfig(po2_update=True)
    params = tree_from_arrays(_tree(3), device="cpu")
    grads = tree_from_arrays(_tree(4), device="cpu")
    state = TOPT.init_opt_state(params)
    a = TOPT.adamw_update(cfg, params, grads, state, use_kernel=True)
    b = TOPT.adamw_update(cfg, params, grads, state, use_kernel=False)
    for x, y in zip(tree_leaves(a[:2]), tree_leaves(b[:2])):
        assert torch.equal(x, y)


def test_opt_state_converts_both_ways():
    params = _tree(5)
    js = JOPT.init_opt_state(jax.tree_util.tree_map(jnp.asarray, params))
    js = js._replace(step=jnp.asarray(7, jnp.int32),
                     mu=jax.tree_util.tree_map(lambda x: x + 1.5, js.mu))
    ts = opt_state_from_arrays(js, device="cpu")
    assert ts.step.dtype == torch.int32 and int(ts.step) == 7
    step, mu, nu = opt_state_to_numpy(ts)
    assert step == np.int32(7) and step.dtype == np.int32
    back = JOPT.OptState(step=step, mu=mu, nu=nu)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(js)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
