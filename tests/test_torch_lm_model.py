"""The LM stack end to end at float32 (ROADMAP item 18b):
``repro_torch.models.transformer`` against the JAX package's for each of
the ten smoke configs, given the reference's parameters through
``repro_torch.convert``.

The LM float32 clause: logits, aux losses and caches within
``assert_allclose(rtol=1e-4, atol=1e-5)``, the SSM family within the
reference's own ``rtol=atol=2e-3``; argmax tokens and int8 codes exactly.
Both packages get the same arrays: one seeded draw of the port's
``init_model`` through numpy, every bias, norm scale, gate and SSM vector
drawn away from its init (zeros and ones would hide them).  The reference
runs jitted, its arithmetic unchanged."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES, get_smoke_config
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.models import transformer as TT
from repro_torch.models.kvcache import KVCache
from repro_torch.models.ssm import SSMCache

F32 = dict(rtol=1e-4, atol=1e-5)
SSM = dict(rtol=2e-3, atol=2e-3)
PERTURBED = {"scale", "bias", "bq", "bk", "bv", "q_norm", "k_norm", "gate_attn", "conv_b",
             "d_skip", "dt_bias", "norm_scale", "up_bias", "down_bias"}

_forward = jax.jit(JT.forward, static_argnums=(1,),
                   static_argnames=("remat", "last_logits_only", "unroll"))
_decode = jax.jit(JT.decode_step, static_argnums=(1,))


def _perturbed(tree, rng):
    if isinstance(tree, dict):
        return {k: (_perturbed(v, rng) if isinstance(v, dict) else
                    (v + 0.3 * rng.standard_normal(v.shape)).astype(v.dtype)
                    if k in PERTURBED else v)
                for k, v in tree.items()}
    return tree


def _model(arch, seed=0, **kw):
    """(cfg, reference params, port params), at float32 unless ``kw`` sets
    the dtype: the same arrays in both packages' trees."""
    cfg = dataclasses.replace(get_smoke_config(arch), **{"dtype": "float32", **kw})
    arrays = convert.lm_params_to_numpy(
        TT.init_model(torch.Generator().manual_seed(seed), cfg, device="cpu"))
    arrays = _perturbed(arrays, np.random.default_rng(seed))
    return (cfg, jax.tree_util.tree_map(jnp.asarray, arrays),
            convert.lm_params_from_arrays(arrays, device="cpu"))


def _inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.family != "vlm":
        return toks, {}, {}
    vis = (rng.standard_normal((B, 8, cfg.vis_dim)) * 0.5).astype(np.float32)
    return toks, {"vis_embed": jnp.asarray(vis)}, {"vis_embed": torch.from_numpy(vis)}


def _flat(x):
    if x is None:
        return []
    if isinstance(x, (tuple, list)):
        return [leaf for kid in x for leaf in _flat(kid)]
    return [np.asarray(x)]


def _tol(cfg):
    return SSM if cfg.family == "ssm" else F32


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_init_model_tree_matches_reference(arch):
    cfg = get_smoke_config(arch)
    ref = jax.eval_shape(lambda k: JT.init_model(k, cfg), jax.random.PRNGKey(0))
    port = TT.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert jax.tree_util.tree_structure(ref) == jax.tree_util.tree_structure(port)
    for a, b in zip(jax.tree_util.tree_leaves(ref), jax.tree_util.tree_leaves(port)):
        assert tuple(a.shape) == tuple(b.shape) and b.dtype == torch.float32
    again = TT.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(port),
                                                 jax.tree_util.tree_leaves(again)))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_forward_and_decode_match_reference_float32(arch):
    """``forward`` (logits, aux losses, argmax) and four ``decode_step``s on
    float32 caches (logits and every cache leaf) against the reference."""
    cfg, jp, tp = _model(arch)
    B, S = 2, 16
    toks, jkw, tkw = _inputs(cfg, B, S, 1)
    jl, jaux = _forward(jp, cfg, tokens=jnp.asarray(toks), **jkw)
    tl, taux = TT.forward(tp, cfg, tokens=torch.from_numpy(toks).long(), **tkw)
    gap = np.abs(tl.numpy() - np.asarray(jl))
    tol = _tol(cfg)
    print(f"[gap] {arch} float32 forward: max|dlogit| {gap.max():.3g}, "
          f"{(gap / (tol['atol'] + tol['rtol'] * np.abs(np.asarray(jl)))).max():.3g} of the "
          f"clause")                                 # the sizes ROADMAP queue 3 quotes (-s)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    assert np.array_equal(tl.numpy().argmax(-1), np.asarray(jl).argmax(-1))
    for name in jaux:
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]), **F32)
    if cfg.is_moe:
        assert float(taux["moe_aux"]) > 0 and float(taux["moe_z"]) > 0

    jc = JT.init_decode_cache(cfg, B, 8, kv_dtype=jnp.float32)
    tc = TT.init_decode_cache(cfg, B, 8, torch.float32, device="cpu")
    for t in range(4):
        jd, jc = _decode(jp, cfg, jc, jnp.asarray(t), tokens=jnp.asarray(toks[:, t:t + 1]),
                         **jkw)
        td, tc = TT.decode_step(tp, cfg, tc, t, tokens=torch.from_numpy(toks[:, t:t + 1]).long(),
                                **tkw)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), **_tol(cfg))
        assert np.array_equal(td.numpy().argmax(-1), np.asarray(jd).argmax(-1))
    want, got = _flat(tuple(jc)), _flat(convert.decode_cache_to_numpy(tc))
    assert len(want) == len(got) > 0
    for a, b in zip(want, got):
        np.testing.assert_allclose(b, a, **_tol(cfg))


def test_decode_cache_is_written_in_place():
    """The cache passed in is consumed: the returned cache holds the same
    tensors, and the slots this step wrote changed in them."""
    cfg, _, tp = _model("qwen3-0.6b")
    cache = TT.init_decode_cache(cfg, 2, 8, torch.float32, device="cpu")
    k = cache.kv.k
    _, out = TT.decode_step(tp, cfg, cache, 3, tokens=torch.zeros((2, 1), dtype=torch.long))
    assert out.kv.k is k and k[:, :, 3].abs().sum() > 0 and k[:, :, 4:].abs().sum() == 0
    cfg, _, tp = _model("mamba2-1.3b")
    cache = TT.init_decode_cache(cfg, 2, 8, device="cpu")
    state = cache.ssm.state
    _, out = TT.decode_step(tp, cfg, cache, 0, tokens=torch.zeros((2, 1), dtype=torch.long))
    assert out.ssm.state is state and state.abs().sum() > 0


def test_int8_decode_matches_reference():
    """Four steps on an int8 KV cache at float32 compute: logits within the
    clause, the cached codes exactly, their scales within the clause."""
    cfg, jp, tp = _model("yi-9b", seed=2)
    toks, _, _ = _inputs(cfg, 2, 4, 2)
    jc = JT.init_decode_cache(cfg, 2, 8, kv_dtype=jnp.int8)
    tc = TT.init_decode_cache(cfg, 2, 8, torch.int8, device="cpu")
    for t in range(4):
        jd, jc = _decode(jp, cfg, jc, jnp.asarray(t), tokens=jnp.asarray(toks[:, t:t + 1]))
        td, tc = TT.decode_step(tp, cfg, tc, t, tokens=torch.from_numpy(toks[:, t:t + 1]).long())
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), **F32)
    assert tc.kv.quantised
    got = convert.decode_cache_to_numpy(tc)[0]
    for a, b in zip(jc.kv[:2], got[:2]):
        assert b.dtype == np.int8 and np.array_equal(b, np.asarray(a))
    for a, b in zip(jc.kv[2:], got[2:]):
        np.testing.assert_allclose(b, np.asarray(a), **F32)


def test_lm_params_and_decode_caches_cross_both_ways():
    """bfloat16 leaves through float32 (exact), int8 and float32 as they
    are; a VLM cache with its cross K/V; back to numpy unchanged."""
    cfg, ref, _ = _model("llama-3.2-vision-11b", seed=3)
    bf = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), ref)
    tp = convert.lm_params_from_arrays(jax.tree_util.tree_map(np.asarray, bf), device="cpu")
    assert all(x.dtype == torch.bfloat16 for x in jax.tree_util.tree_leaves(tp))
    back = convert.lm_params_to_numpy(tp)
    for a, b in zip(jax.tree_util.tree_leaves(bf), jax.tree_util.tree_leaves(back)):
        assert b.dtype == np.float32 and np.array_equal(b, np.asarray(a, np.float32))

    B = 2
    rng = np.random.default_rng(3)
    cross = JT.precompute_cross_kv(ref, cfg, jnp.ones((B, 8, cfg.vis_dim), jnp.float32) * 0.1)
    for kv_dtype in (jnp.bfloat16, jnp.float32, jnp.int8):
        jc = JT.init_decode_cache(cfg, B, 8, kv_dtype=kv_dtype)
        jc = jc._replace(kv=jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.standard_normal(a.shape) * 50, a.dtype), jc.kv),
            cross_k=cross[0], cross_v=cross[1])
        tc = convert.decode_cache_from_arrays(jax.tree_util.tree_map(np.asarray, jc),
                                              device="cpu")
        assert isinstance(tc.kv, KVCache) and tc.ssm is None and tc.cross_k is not None
        assert tc.kv.k.dtype == {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32,
                                 jnp.int8: torch.int8}[kv_dtype]
        for a, b in zip(_flat(tuple(jc)), _flat(convert.decode_cache_to_numpy(tc))):
            assert np.array_equal(b, np.asarray(a, b.dtype))
    jc = JT.init_decode_cache(get_smoke_config("hymba-1.5b"), B, 8)
    tc = convert.decode_cache_from_arrays(jax.tree_util.tree_map(np.asarray, jc), device="cpu")
    assert isinstance(tc.ssm, SSMCache) and tc.global_kv.k.dtype == torch.bfloat16
