"""The LM stack's attention (ROADMAP item 18b): ``repro_torch.models.attention``
against a naive attention and against the JAX package's, on the same
inputs drawn from a numpy seed.

The naive comparisons mirror ``tests/test_models.py`` at its tolerance
(``rtol=2e-4, atol=2e-5``); the reference comparisons are held to the LM
float32 clause (``rtol=1e-4, atol=1e-5``)."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import attention as JA
from repro_torch import convert
from repro_torch.models import attention as TA

F32 = dict(rtol=1e-4, atol=1e-5)
NAIVE = dict(rtol=2e-4, atol=2e-5)      # test_models.py's tolerance

# the reference's functions, jitted (one compile a config, not one per op)
_blockwise = jax.jit(JA.blockwise_attention,
                     static_argnames=("window", "block_q", "block_kv", "q_offset"))
_project_qkv = jax.jit(JA.project_qkv, static_argnums=(3,), static_argnames=("rope",))
_self_attention = jax.jit(JA.self_attention_train, static_argnums=(2,),
                          static_argnames=("window", "block_q", "block_kv"))
_decode_attention = jax.jit(JA.decode_attention, static_argnums=(5,), static_argnames=("window",))


def _cfg(arch, **kw):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)


def _t(x):
    return torch.from_numpy(np.array(x))


def _qkv(B, S, H, K, hd, seed, T=None):
    rng = np.random.default_rng(seed)
    T = S if T is None else T
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, T, K, hd)).astype(np.float32),
            rng.standard_normal((B, T, K, hd)).astype(np.float32))


def _naive_attention(q, k, v, window=0, q_offset=0):
    """GQA by repeating the K/V heads, a dense causal (optionally windowed)
    mask, softmax in float32 (the reference test's ``_naive_attention``)."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    kk = k.repeat_interleave(G, dim=2)
    vv = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bthd->bhqt", q, kk) / math.sqrt(hd)
    qi = torch.arange(S)[:, None] + q_offset
    ti = torch.arange(k.shape[1])[None, :]
    mask = qi >= ti
    if window > 0:
        mask &= (qi - ti) < window
    s = torch.where(mask[None, None], s, -1e30)
    return torch.einsum("bhqt,bthd->bqhd", torch.softmax(s, -1), vv)


def _params(arch, seed, *, cross=False, **kw):
    """One seeded draw of the attention parameters for both packages, every
    bias, norm scale and gate drawn away from its init (zeros and ones would
    hide them)."""
    cfg = _cfg(arch, **kw)
    p = convert.lm_params_to_numpy(TA.init_attention(torch.Generator().manual_seed(seed), cfg,
                                                     cross=cross, device="cpu"))
    rng = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv", "q_norm", "k_norm", "gate_attn"):
        if name in p:
            p[name] = (p[name] + 0.5 * rng.standard_normal(p[name].shape)).astype(np.float32)
    return cfg, p, jax.tree_util.tree_map(jnp.asarray, p), convert.lm_params_from_arrays(
        p, device="cpu")


@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("S,bq", [(32, 16), (64, 16)])
def test_blockwise_attention_matches_naive(window, S, bq):
    """Mirrors ``test_models.py::test_blockwise_attention_matches_naive``
    (both cases: the reference marks the second slow)."""
    q, k, v = map(_t, _qkv(2, S, 4, 2, 16, seed=S + window))
    got = TA.blockwise_attention(q, k, v, window=window, block_q=bq, block_kv=bq)
    np.testing.assert_allclose(got.numpy(), _naive_attention(q, k, v, window).numpy(), **NAIVE)


def test_dense_attention_matches_naive():
    """Mirrors ``test_models.py::test_dense_attention_matches_naive``."""
    q, k, v = map(_t, _qkv(2, 16, 4, 2, 8, seed=3))
    idx = torch.arange(16)
    mask = (idx[:, None] >= idx[None, :])[None, None, None]
    got = TA.dense_attention(q, k, v, mask)
    np.testing.assert_allclose(got.numpy(), _naive_attention(q, k, v).numpy(), **NAIVE)


@pytest.mark.parametrize("window,q_offset", [(0, 0), (8, 0), (0, 16), (12, 16)])
def test_blockwise_attention_matches_reference(window, q_offset):
    """Chunked prefill too: a query block at ``q_offset`` against a longer KV."""
    q, k, v = _qkv(2, 32, 4, 2, 16, seed=4, T=32 + q_offset)
    kw = dict(window=window, block_q=8, block_kv=16, q_offset=q_offset)
    want = np.asarray(_blockwise(*map(jnp.asarray, (q, k, v)), **kw))
    got = TA.blockwise_attention(*map(_t, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    np.testing.assert_allclose(got.numpy(), _naive_attention(
        *map(_t, (q, k, v)), window, q_offset).numpy(), **NAIVE)


def test_blockwise_attention_rejects_ragged_blocks():
    q, k, v = map(_t, _qkv(1, 24, 2, 1, 8, seed=5))
    with pytest.raises(ValueError, match="must divide"):
        TA.blockwise_attention(q, k, v, block_q=16, block_kv=16)


def test_gqa_products_accumulate_in_float32():
    """The reference's ``preferred_element_type=jnp.float32``
    (``attention.py:79,86``): bfloat16 operands, float32 scores and sums."""
    q, k, v = _qkv(2, 8, 4, 2, 16, seed=6)
    qb = q.reshape(2, 8, 2, 2, 16)
    for jd, td in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        js = JA._gqa_scores(jnp.asarray(qb, jd), jnp.asarray(k, jd), 0.25)
        ts = TA._gqa_scores(_t(qb).to(td), _t(k).to(td), 0.25)
        assert ts.dtype == torch.float32
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), **F32)
        p = np.asarray(jax.nn.softmax(js, -1))
        ja = JA._gqa_accum(jnp.asarray(p), jnp.asarray(v, jd))
        ta = TA._gqa_accum(_t(p), _t(v).to(td))
        assert ta.dtype == torch.float32
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **F32)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-0.6b", "musicgen-medium"])
def test_project_qkv_matches_reference(arch):
    """QKV bias (qwen2), qk-norm (qwen3), no RoPE (musicgen's sinusoidal)."""
    cfg, _, jp, tp = _params(arch, 7)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    pos = np.stack([np.arange(6), np.arange(10, 16)]).astype(np.int32)
    rope = cfg.pos_embedding == "rope"
    want = _project_qkv(jp, jnp.asarray(x), jnp.asarray(x), cfg,
                        positions=jnp.asarray(pos), rope=rope)
    got = TA.project_qkv(tp, _t(x), _t(x), cfg, positions=_t(pos), rope=rope)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **F32)


@pytest.mark.parametrize("arch,S,window,block", [
    ("qwen2-1.5b", 16, 0, 1024),        # dense path, bias
    ("qwen3-0.6b", 32, 0, 8),           # blockwise path, qk-norm
    ("hymba-1.5b", 32, 8, 8),           # blockwise, sliding window
    ("hymba-1.5b", 16, 8, 1024),        # dense, sliding window
])
def test_self_attention_train_matches_reference(arch, S, window, block):
    cfg, _, jp, tp = _params(arch, 8)
    x = np.random.default_rng(8).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    kw = dict(window=window, block_q=block, block_kv=block)
    want = np.asarray(_self_attention(jp, jnp.asarray(x), cfg, positions=jnp.asarray(pos),
                                      **kw))
    got = TA.self_attention_train(tp, _t(x), cfg, positions=_t(pos), **kw)
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_cross_attention_and_vision_kv_match_reference():
    cfg, _, jp, tp = _params("llama-3.2-vision-11b", 9, cross=True)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    vis = rng.standard_normal((2, 17, cfg.vis_dim)).astype(np.float32)
    jkv = JA.vision_kv(jp, jnp.asarray(vis), cfg)
    tkv = TA.vision_kv(tp, _t(vis), cfg)
    for a, b in zip(jkv, tkv):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **F32)
    want = np.asarray(JA.cross_attention(jp, jnp.asarray(x), jkv, cfg))
    got = TA.cross_attention(tp, _t(x), tkv, cfg)
    assert np.abs(want).max() > 0.1                  # the tanh gate is open
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("window", [0, 8])
def test_decode_attention_matches_reference(window):
    """A linear cache (window 0) and a ring (window 8 over 8 slots), ten
    steps: the ring wraps; outputs and caches as the reference's, the
    port's caches written in place."""
    cfg, _, jp, tp = _params("yi-9b", 10)
    T, B = 8, 2
    hd, K = cfg.resolved_head_dim, cfg.n_kv_heads
    jk = jv = jnp.zeros((B, T, K, hd), jnp.float32)
    tk, tv = torch.zeros((B, T, K, hd)), torch.zeros((B, T, K, hd))
    rng = np.random.default_rng(10)
    steps = range(10) if window else range(T)
    for pos in steps:
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        want, jk, jv = _decode_attention(jp, jnp.asarray(x), jk, jv, jnp.asarray(pos), cfg,
                                         window=window)
        got, k_out, v_out = TA.decode_attention(tp, _t(x), tk, tv, pos, cfg, window=window)
        assert k_out is tk and v_out is tv
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **F32)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **F32)


def test_decode_attention_past_the_end_clamps_as_the_reference():
    """``pos = T`` on a linear cache: the reference's ``dynamic_update_slice``
    writes slot T-1 (``attention.py:222-225``), silently, and attends over
    every slot; the port does the same (ROADMAP queue 3)."""
    cfg, _, jp, tp = _params("qwen2-1.5b", 11)
    T, B = 4, 2
    rng = np.random.default_rng(11)
    shape = (B, T, cfg.n_kv_heads, cfg.resolved_head_dim)
    k0, v0 = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    for pos in (T, T + 2):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        want, jk, jv = _decode_attention(jp, jnp.asarray(x), jnp.asarray(k0), jnp.asarray(v0),
                                         jnp.asarray(pos), cfg)
        tk, tv = _t(k0), _t(v0)
        got, _, _ = TA.decode_attention(tp, _t(x), tk, tv, pos, cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), **F32)
        assert np.array_equal(tk[:, :T - 1].numpy(), k0[:, :T - 1])     # only slot T-1 moved
        assert not np.array_equal(tk[:, T - 1].numpy(), k0[:, T - 1])


def test_init_attention_matches_reference_shapes():
    gen = torch.Generator().manual_seed(0)
    for arch, cross in (("qwen2-1.5b", False), ("qwen3-0.6b", False),
                        ("llama-3.2-vision-11b", True)):
        cfg = get_smoke_config(arch)
        ref = JA.init_attention(jax.random.PRNGKey(0), cfg, cross=cross)
        port = TA.init_attention(gen, cfg, cross=cross, device="cpu")
        assert sorted(ref) == sorted(port)
        for name in ref:
            assert tuple(ref[name].shape) == tuple(port[name].shape), name
            assert port[name].dtype == torch.float32
