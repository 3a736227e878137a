"""The LM stack's shared layers and KV cache (ROADMAP item 18b):
``repro_torch.models.layers`` and ``repro_torch.models.kvcache`` against
the JAX package's, on the same inputs drawn from a numpy seed.

Float32 is held to the LM parity clause, ``assert_allclose(rtol=1e-4,
atol=1e-5)``; int8 codes exactly.  A bfloat16 output rounds a float32 value
that both packages compute in float32, so it is held within one bfloat16
ulp (``rtol=2**-7``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import kvcache as JK
from repro.models import layers as JL
from repro_torch import convert
from repro_torch.models import kvcache as TK
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

F32 = dict(rtol=1e-4, atol=1e-5)
BF16_ULP = dict(rtol=2 ** -7, atol=0)


def _cfg(arch, **kw):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def _pair(a, dtype):
    """One numpy array as the reference's array and the port's tensor, both
    in ``dtype`` ('float32' or 'bfloat16')."""
    return jnp.asarray(a, dtype), _t(a.astype(np.float32), getattr(torch, dtype))


def _shapes(tree):
    return [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for x in jax.tree_util.tree_leaves(tree)]


def test_dtype_names_map_to_torch():
    cfg = get_smoke_config("qwen3-0.6b")
    assert TL.cdtype(cfg) is torch.bfloat16 and TL.pdtype(cfg) is torch.float32
    assert TL.cdtype(dataclasses.replace(cfg, dtype="float32")) is torch.float32
    for name in ("float8", "Tensor"):
        with pytest.raises(ValueError, match="unknown dtype"):
            TL.cdtype(dataclasses.replace(cfg, dtype=name))


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_norm_matches_reference(norm, dtype):
    cfg = _cfg("qwen3-0.6b", norm=norm)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)) * 3 + 0.5
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    if norm == "rmsnorm":
        del p["bias"]
    jx, tx = _pair(x, dtype)
    want = _np(JL.apply_norm(jax.tree_util.tree_map(jnp.asarray, p), jx, cfg))
    got = TL.apply_norm(convert.lm_params_from_arrays(p, device="cpu"), tx, cfg)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(), want, **(F32 if dtype == "float32"
                                                            else BF16_ULP))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_head_norm_matches_reference(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 4, 32))
    scale = rng.standard_normal(32).astype(np.float32)
    jx, tx = _pair(x, dtype)
    want = _np(JL.rms_head_norm(jnp.asarray(scale), jx, 1e-6))
    got = TL.rms_head_norm(_t(scale), tx, 1e-6)
    np.testing.assert_allclose(got.float().numpy(), want,
                               **(F32 if dtype == "float32" else BF16_ULP))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_reference(theta):
    np.testing.assert_allclose(TL.rope_freqs(32, theta).numpy(),
                               np.asarray(JL.rope_freqs(32, theta)), rtol=1e-6)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 4, 32)).astype(np.float32)
    pos = np.stack([np.arange(9), np.arange(50, 59)]).astype(np.int32)
    want = np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = TL.apply_rope(_t(x), _t(pos), theta)
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_sinusoidal_positions_match_reference():
    pos = np.arange(64, dtype=np.int32)[None].repeat(2, 0)
    want = np.asarray(JL.sinusoidal_positions(jnp.asarray(pos), 64))
    got = TL.sinusoidal_positions(_t(pos), 64)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "musicgen-medium"])   # swiglu, gelu
def test_apply_mlp_matches_reference(arch):
    cfg = _cfg(arch)
    rng = np.random.default_rng(4)
    p = convert.lm_params_to_numpy(TL.init_mlp(torch.Generator().manual_seed(4), cfg,
                                               cfg.d_model, cfg.d_ff, device="cpu"))
    for name in ("up_bias", "down_bias"):
        if name in p:
            p[name] = rng.standard_normal(p[name].shape).astype(np.float32)
    x = (rng.standard_normal((2, 7, cfg.d_model)) * 2).astype(np.float32)
    want = np.asarray(JL.apply_mlp(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
                                   cfg))
    got = TL.apply_mlp(convert.lm_params_from_arrays(p, device="cpu"), _t(x), cfg)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    if cfg.mlp == "gelu":
        # jax.nn.gelu is the tanh approximation: torch's erf default would
        # miss the clause
        h = _t(x) @ _t(p["up"]) + _t(p["up_bias"])
        erf = torch.nn.functional.gelu(h) @ _t(p["down"]) + _t(p["down_bias"])
        assert np.abs(erf.numpy() - want).max() > 1e-4


@pytest.mark.parametrize("case", ["tied", "untied", "softcap"])
def test_embed_and_unembed_match_reference(case):
    arch = "qwen3-0.6b" if case == "tied" else "yi-9b"
    cfg = _cfg(arch, logit_softcap=30.0 if case == "softcap" else 0.0)
    assert cfg.tie_embeddings == (case == "tied")
    arrays = convert.lm_params_to_numpy(TL.init_embedding(torch.Generator().manual_seed(5), cfg,
                                                          device="cpu"))
    jp = jax.tree_util.tree_map(jnp.asarray, arrays)
    tp = convert.lm_params_from_arrays(arrays, device="cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    x = (rng.standard_normal((2, 6, cfg.d_model)) * 20).astype(np.float32)
    assert np.array_equal(TL.embed(tp, _t(toks).long(), cfg).numpy(),
                          np.asarray(JL.embed(jp, jnp.asarray(toks), cfg)))
    want = np.asarray(JL.unembed(jp, jnp.asarray(x), cfg))
    got = TL.unembed(tp, _t(x), cfg)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    if case == "softcap":
        assert np.abs(want).max() < 30.0 < np.abs(x @ np.asarray(jp["out"])).max()


def test_embed_gathers_then_casts_the_same_bits():
    """The reference casts the whole float32 table to bfloat16 and then
    gathers (``layers.py:142``); the port gathers the rows and casts them."""
    cfg = get_smoke_config("qwen2-1.5b")
    jp = JL.init_embedding(jax.random.PRNGKey(6), cfg)
    tp = convert.lm_params_from_arrays(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (3, 11)).astype(np.int32)
    got = TL.embed(tp, _t(toks).long(), cfg)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), _np(JL.embed(jp, jnp.asarray(toks), cfg)))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "musicgen-medium", "yi-9b"])
def test_init_trees_match_reference_shapes(arch):
    cfg = get_smoke_config(arch)
    key = jax.random.PRNGKey(0)
    gen = torch.Generator().manual_seed(0)
    for ref, port in ((JL.init_norm(cfg, 64), TL.init_norm(cfg, 64, device="cpu")),
                      (JL.init_mlp(key, cfg, cfg.d_model, cfg.d_ff),
                       TL.init_mlp(gen, cfg, cfg.d_model, cfg.d_ff, device="cpu")),
                      (JL.init_embedding(key, cfg), TL.init_embedding(gen, cfg, device="cpu"))):
        assert jax.tree_util.tree_structure(ref) == jax.tree_util.tree_structure(port)
        assert _shapes(ref) == _shapes(port)


def test_dense_init_is_a_seeded_truncated_normal():
    a = TL.dense_init(torch.Generator().manual_seed(7), 256, 64, torch.float32, device="cpu")
    b = TL.dense_init(torch.Generator().manual_seed(7), 256, 64, torch.float32, device="cpu")
    assert torch.equal(a, b) and a.shape == (256, 64)
    assert a.abs().max() <= 2.0 / 16 and 0.8 / 16 < a.std() < 1.0 / 16
    meta = TL.dense_init(None, 256, 64, torch.float32, device="meta")
    assert meta.is_meta and meta.shape == (256, 64)


def test_init_functions_default_to_cuda():
    cfg = get_smoke_config("qwen3-0.6b")
    gen = torch.Generator().manual_seed(0)
    makers = (lambda: TT.init_model(gen, cfg), lambda: TT.init_decode_cache(cfg, 2, 8),
                lambda: TK.init_kv_cache(1, 2, 8, 2, 32), lambda: TL.init_norm(cfg, 8))
    if torch.cuda.is_available():
        assert TT.init_model(gen, cfg)["embed"]["tok"].device.type == "cuda"
        return
    for make in makers:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def test_kv_int8_roundtrip_error():
    """Mirrors ``test_models.py::test_kv_int8_roundtrip_error``."""
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((2, 16, 4, 32))
                         .astype(np.float32))
    q, s = TK.quantise_kv(x)
    back = TK.dequantise_kv(q, s, torch.float32)
    rel = float((back - x).square().mean().sqrt() / x.square().mean().sqrt())
    assert rel < 0.01


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantise_kv_codes_equal_reference(dtype):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 16, 4, 32)) * np.exp(rng.standard_normal((2, 16, 4, 1)))
    x[0, 0, 0] = 0.0                                    # an all-zero head: the 1e-6 floor
    jx, tx = _pair(x, dtype)
    jq, js = JK.quantise_kv(jx)
    tq, ts = TK.quantise_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    for out in ("float32", "bfloat16"):
        want = _np(JK.dequantise_kv(jq, js, getattr(jnp, out)))
        got = TK.dequantise_kv(tq, ts, getattr(torch, out))
        assert np.array_equal(got.float().numpy(), want)


def test_init_kv_cache_matches_reference():
    for jd, td in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32),
                   (jnp.int8, torch.int8)):
        ref = JK.init_kv_cache(3, 2, 8, 2, 16, jd)
        port = TK.init_kv_cache(3, 2, 8, 2, 16, td, device="cpu")
        assert port.quantised == ref.quantised == (td == torch.int8)
        for a, b in zip(ref, port):
            assert (a is None) == (b is None)
            if a is not None:
                assert tuple(a.shape) == tuple(b.shape) and np.array_equal(_np(a), _np(b.float()))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int8"])
def test_cache_write_and_read_match_reference(dtype):
    """Writes at three slots, the last past the end: the reference's
    ``dynamic_update_slice`` clamps it to slot T-1, and so does the port."""
    B, T, K, hd = 2, 8, 2, 16
    ref = JK.init_kv_cache(1, B, T, K, hd, getattr(jnp, dtype))
    port = TK.init_kv_cache(1, B, T, K, hd, getattr(torch, dtype), device="cpu")
    jc = tuple(None if a is None else a[0] for a in ref)
    tc = tuple(None if a is None else a[0] for a in port)
    rng = np.random.default_rng(10)
    for slot in (0, 5, T, T + 3):
        k = rng.standard_normal((B, 1, K, hd)).astype(np.float32)
        v = rng.standard_normal((B, 1, K, hd)).astype(np.float32)
        jc = JK.cache_write(*jc, jnp.asarray(k), jnp.asarray(v), jnp.asarray(slot))
        out = TK.cache_write(*tc, _t(k), _t(v), slot)
        assert all(a is b for a, b in zip(out, tc))        # written in place
    for a, b in zip(jc, tc):
        if a is not None:
            assert np.array_equal(_np(a), b.float().numpy())
    got = TK.cache_read(*tc, torch.float32)
    want = JK.cache_read(*jc, jnp.float32)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **F32)
    assert np.array_equal(tc[0][:, T - 1].float().numpy(), _np(jc[0][:, T - 1]))
    assert tc[0][:, 6].float().abs().sum() == 0       # the clamped writes hit slot 7 only
