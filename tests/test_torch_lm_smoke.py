"""The LM stack's smoke tests in bfloat16, the reference's own checks
mirrored on the port (ROADMAP item 18b), and parameter counting on meta
tensors for the ten full configs.

bfloat16 is the models' default dtype.  It is a smoke at the reference's
own thresholds (``tests/test_models.py:110-112,249``): against the JAX
package's logits, argmax agreement ≥ 0.5 and correlation > 0.98; int8
against bfloat16 decode, relative RMSE < 0.05.  The reference marks several
of the mirrored tests ``slow``; here they run in tier-1."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES, get_config, get_smoke_config
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.models import transformer as TT
from test_torch_lm_model import F32, _decode, _flat, _forward, _model

FULL_COUNTS = {
    "llama-3.2-vision-11b": 9_833_879_560, "qwen1.5-32b": 35_197_096_960,
    "yi-9b": 8_829_407_232, "qwen3-0.6b": 596_049_920, "qwen2-1.5b": 1_543_714_304,
    "hymba-1.5b": 1_640_974_720, "qwen2-moe-a2.7b": 15_146_256_384,
    "phi3.5-moe-42b-a6.6b": 41_872_990_208, "mamba2-1.3b": 1_343_740_928,
    "musicgen-medium": 1_365_912_576}


def _vis(cfg, B):
    """The reference test's vision stub, ``ones * 0.1``, in both packages."""
    if cfg.family != "vlm":
        return {}, {}
    return ({"vis_embed": jnp.ones((B, 8, cfg.vis_dim), jnp.float32) * 0.1},
            {"vis_embed": torch.ones((B, 8, cfg.vis_dim)) * 0.1})


def _agree(a, b):
    """The reference's bfloat16 smoke: argmax agreement and correlation."""
    a, b = (np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor)
            else x.float().numpy() for x in (a, b))
    return (a.argmax(-1) == b.argmax(-1)).mean(), np.corrcoef(a.ravel(), b.ravel())[0, 1]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_arch_smoke_forward_and_decode_bf16(arch):
    """Mirrors ``test_arch_smoke_forward`` (B=2, S=32; shapes, no NaN, and
    here the reference's bfloat16 logits within the smoke's thresholds) and
    ``test_arch_smoke_decode`` (one step at pos 3 on a bfloat16 cache:
    shapes, no NaN; ``test_torch_lm_model.py`` holds decode against the
    reference at float32)."""
    cfg, jp, tp = _model(arch, dtype="bfloat16")
    B, S = 2, 32
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jkw, tkw = _vis(cfg, B)
    tl, _ = TT.forward(tp, cfg, tokens=torch.from_numpy(toks).long(), **tkw)
    assert tl.shape == (B, S, cfg.vocab_size) and tl.dtype == torch.bfloat16
    assert not tl.isnan().any()
    jl, _ = _forward(jp, cfg, tokens=jnp.asarray(toks), **jkw)
    agree, corr = _agree(jl, tl)
    gap = np.abs(np.asarray(jnp.asarray(jl, jnp.float32)) - tl.float().numpy()).max()
    print(f"[gap] {arch} bfloat16 forward: max|dlogit| {gap:.3g}, argmax agreement "
          f"{agree:.4f}, corr {corr:.6f}")       # the sizes ROADMAP queue 3 quotes (-s)
    assert agree >= 0.5 and corr > 0.98, (agree, corr)

    tc = TT.init_decode_cache(cfg, B, 64, device="cpu")
    assert tc.kv is None or tc.kv.k.dtype == torch.bfloat16
    td, _ = TT.decode_step(tp, cfg, tc, 3, tokens=torch.zeros((B, 1), dtype=torch.long), **tkw)
    assert td.shape == (B, 1, cfg.vocab_size) and td.dtype == torch.bfloat16
    assert not td.isnan().any()


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-1.3b", "hymba-1.5b",
                                  "musicgen-medium"])
def test_decode_matches_forward(arch):
    """Mirrors ``test_models.py::test_decode_matches_forward``: S tokens
    through decode one at a time (bfloat16 compute, float32 KV cache), the
    last step's logits against ``forward``'s at that position."""
    cfg = get_smoke_config(arch)
    params = TT.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    B, S = 2, 16
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(1))
    _, kw = _vis(cfg, B)
    fwd, _ = TT.forward(params, cfg, tokens=toks, remat="none", **kw)
    cache = TT.init_decode_cache(cfg, B, 32, torch.float32, device="cpu")
    for t in range(S):
        dec, cache = TT.decode_step(params, cfg, cache, t, tokens=toks[:, t:t + 1], **kw)
    agree, corr = _agree(fwd[:, -1], dec[:, 0])
    assert agree >= 0.5 and corr > 0.98, (agree, corr)


def test_unroll_matches_scan():
    """Mirrors ``test_models.py::test_unroll_matches_scan``: the port's loop
    is always unrolled, so both flags give the same logits; an unknown
    ``remat`` policy is refused."""
    cfg = get_smoke_config("qwen3-0.6b")
    params = TT.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(2))
    a, _ = TT.forward(params, cfg, tokens=toks, remat="none")
    b, _ = TT.forward(params, cfg, tokens=toks, remat="none", unroll=True)
    np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), atol=1e-2)
    for remat in ("full", "dots", None):
        c, _ = TT.forward(params, cfg, tokens=toks, remat=remat)
        assert torch.equal(a, c)
    with pytest.raises(ValueError, match="unknown remat"):
        TT.forward(params, cfg, tokens=toks, remat="everything")


def test_last_logits_only():
    """Mirrors ``test_models.py::test_last_logits_only``."""
    cfg = get_smoke_config("yi-9b")
    params = TT.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(3))
    full, _ = TT.forward(params, cfg, tokens=toks, remat="none")
    last, _ = TT.forward(params, cfg, tokens=toks, remat="none", last_logits_only=True)
    assert last.shape == (2, 1, cfg.vocab_size)
    np.testing.assert_allclose(full[:, -1:].float().numpy(), last.float().numpy(), atol=1e-2)


def test_int8_decode_close_to_bf16():
    """Mirrors ``test_models.py::test_int8_decode_close_to_bf16``."""
    cfg = get_smoke_config("yi-9b")
    params = TT.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    B, S = 2, 8
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(4))
    outs = []
    for dt in (torch.bfloat16, torch.int8):
        cache = TT.init_decode_cache(cfg, B, 16, dt, device="cpu")
        for t in range(S):
            logits, cache = TT.decode_step(params, cfg, cache, t, tokens=toks[:, t:t + 1])
        outs.append(logits.float().numpy())
    a, b = outs
    assert np.sqrt(np.mean((a - b) ** 2)) / np.sqrt(np.mean(a ** 2)) < 0.05

@pytest.mark.parametrize("glb", ["none", "all"])
def test_hybrid_decode_degenerate_layer_mixes_match_reference(glb):
    """Mirrors ``test_models.py::test_hybrid_decode_degenerate_layer_mixes``
    (hymba with no global layer, or only global layers), held against the
    reference at float32 for two steps."""
    base = get_smoke_config("hymba-1.5b")
    layers = () if glb == "none" else tuple(range(base.n_layers))
    cfg, jp, tp = _model("hymba-1.5b", global_layers=layers)
    jc = JT.init_decode_cache(cfg, 2, 32, kv_dtype=jnp.float32)
    tc = TT.init_decode_cache(cfg, 2, 32, torch.float32, device="cpu")
    assert (tc.kv.k.shape[0], tc.global_kv.k.shape[0]) == (
        (base.n_layers, 0) if glb == "none" else (0, base.n_layers))
    for pos in (2, 3):
        toks = np.full((2, 1), pos, np.int32)
        jd, jc = _decode(jp, cfg, jc, jnp.asarray(pos), tokens=jnp.asarray(toks))
        td, tc = TT.decode_step(tp, cfg, tc, pos, tokens=torch.from_numpy(toks).long())
        assert td.shape == (2, 1, cfg.vocab_size) and not td.isnan().any()
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), **F32)
    for a, b in zip(_flat(tuple(jc)), _flat(convert.decode_cache_to_numpy(tc))):
        np.testing.assert_allclose(b, a, **F32)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_init_model_on_meta_counts_the_full_configs(arch):
    """``init_model(device="meta")`` builds the full config's tree with no
    storage: the reference's ``jax.eval_shape(init_model)`` leaf for leaf,
    and its exact parameter count."""
    cfg = get_config(arch)
    ref = jax.eval_shape(lambda k: JT.init_model(k, cfg), jax.random.PRNGKey(0))
    port = TT.init_model(None, cfg, device="meta")
    assert jax.tree_util.tree_structure(ref) == jax.tree_util.tree_structure(port)
    leaves = jax.tree_util.tree_leaves(port)
    assert all(x.is_meta and x.dtype == torch.float32 for x in leaves)
    assert [tuple(a.shape) for a in jax.tree_util.tree_leaves(ref)] == \
        [tuple(x.shape) for x in leaves]
    assert sum(x.numel() for x in leaves) == FULL_COUNTS[arch]
