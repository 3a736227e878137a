"""The LM stack's Mamba2 mixer and MoE layer (ROADMAP item 18b):
``repro_torch.models.ssm`` and ``repro_torch.models.moe`` against a naive
recurrence and against the JAX package's, on the same inputs drawn from a
numpy seed.

The SSD scan and the SSM mixer are held to the reference's own
``rtol=atol=2e-3`` (``tests/test_models.py:216-218``: their three-operand
einsums may contract in another order); the MoE layer to the LM float32
clause (``rtol=1e-4, atol=1e-5``).  The MoE inputs are drawn untied: a tie
among positive router scores would let ``torch.topk`` and ``lax.top_k``
keep different tokens."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_smoke_config
from repro.models import moe as JM
from repro.models import ssm as JS
from repro_torch import convert
from repro_torch.models import moe as TM
from repro_torch.models import ssm as TS

F32 = dict(rtol=1e-4, atol=1e-5)
SSM = dict(rtol=2e-3, atol=2e-3)

# the reference's layers, jitted (one compile a config, not one per op)
_ssm_train = jax.jit(JS.apply_ssm_train, static_argnums=(2,))
_ssm_decode = jax.jit(JS.apply_ssm_decode, static_argnums=(3,))
_moe_apply = jax.jit(JM.apply_moe, static_argnums=(2,))


def _cfg(arch, **kw):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32", **kw)


def _t(x):
    return torch.from_numpy(np.array(x))


def _ssd_inputs(seed, B=2, L=32, g=1, r=4, P=8, N=16):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, L, g, r, P)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, L, g, r)))).astype(np.float32)
    a = -np.exp(rng.standard_normal((g, r)) * 0.3).astype(np.float32)
    b_in = (rng.standard_normal((B, L, g, N)) * 0.5).astype(np.float32)
    c_in = (rng.standard_normal((B, L, g, N)) * 0.5).astype(np.float32)
    return x, dt, a, b_in, c_in


def test_ssd_scan_matches_naive_recurrence():
    """Mirrors ``test_models.py::test_ssd_scan_matches_naive_recurrence``."""
    x, dt, a, b_in, c_in = map(_t, _ssd_inputs(1))
    y_ssd, s_ssd = TS.ssd_scan(x, dt, a, b_in, c_in, 8)
    B, L, g, r, P = x.shape
    S = torch.zeros((B, g, r, b_in.shape[-1], P))
    ys = []
    for t in range(L):
        decay = torch.exp(dt[:, t] * a)
        xb = x[:, t] * dt[:, t][..., None]
        S = S * decay[..., None, None] + torch.einsum("bgn,bgrp->bgrnp", b_in[:, t], xb)
        ys.append(torch.einsum("bgn,bgrnp->bgrp", c_in[:, t], S))
    np.testing.assert_allclose(y_ssd.numpy(), torch.stack(ys, 1).numpy(), **SSM)
    np.testing.assert_allclose(s_ssd.numpy(), S.numpy(), **SSM)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("g", [1, 2])
def test_ssd_scan_matches_reference(with_state, g):
    x, dt, a, b_in, c_in = _ssd_inputs(2 + g, g=g, r=2)
    s0 = (np.random.default_rng(5).standard_normal((2, g, 2, 16, 8)).astype(np.float32)
          if with_state else None)
    jy, js = JS.ssd_scan(*map(jnp.asarray, (x, dt, a, b_in, c_in)), 8,
                         None if s0 is None else jnp.asarray(s0))
    ty, ts = TS.ssd_scan(*map(_t, (x, dt, a, b_in, c_in)), 8, None if s0 is None else _t(s0))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **SSM)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **SSM)
    with pytest.raises(ValueError, match="must divide"):
        TS.ssd_scan(*map(_t, (x, dt, a, b_in, c_in)), 7)


def test_ssd_scan_masks_in_log_space():
    """Steep decays make the anti-causal half of a chunk's segment sums
    large and positive; the -inf mask keeps exp() from producing inf·0."""
    x, dt, a, b_in, c_in = map(_t, _ssd_inputs(6))
    y, s = TS.ssd_scan(x, dt * 200, a * 5, b_in, c_in, 8)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()


def _ssm_params(arch, seed):
    cfg = _cfg(arch)
    p = convert.lm_params_to_numpy(TS.init_ssm(torch.Generator().manual_seed(seed), cfg,
                                               device="cpu"))
    rng = np.random.default_rng(seed)
    for name in ("conv_b", "d_skip", "dt_bias", "norm_scale"):
        p[name] = (p[name] + 0.3 * rng.standard_normal(p[name].shape)).astype(np.float32)
    return cfg, jax.tree_util.tree_map(jnp.asarray, p), convert.lm_params_from_arrays(
        p, device="cpu")


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b"])
def test_apply_ssm_train_matches_reference(arch):
    cfg, jp, tp = _ssm_params(arch, 7)
    u = np.random.default_rng(7).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    want = np.asarray(_ssm_train(jp, jnp.asarray(u), cfg))
    got = TS.apply_ssm_train(tp, _t(u), cfg)
    np.testing.assert_allclose(got.numpy(), want, **SSM)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "hymba-1.5b"])
def test_apply_ssm_decode_matches_reference(arch):
    """Four steps from a random cache: outputs, conv window and state."""
    cfg, jp, tp = _ssm_params(arch, 8)
    rng = np.random.default_rng(8)
    c0 = TS.init_ssm_cache(cfg, 2, device="cpu")
    ref = JS.init_ssm_cache(cfg, 2)
    assert [tuple(a.shape) for a in c0] == [tuple(a.shape) for a in ref]
    conv = rng.standard_normal(tuple(c0.conv.shape)).astype(np.float32)
    state = rng.standard_normal(tuple(c0.state.shape)).astype(np.float32)
    jc = JS.SSMCache(jnp.asarray(conv), jnp.asarray(state))
    tc = TS.SSMCache(_t(conv), _t(state))
    for _ in range(4):
        u = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jc = _ssm_decode(jp, jnp.asarray(u), jc, cfg)
        ty, tc = TS.apply_ssm_decode(tp, _t(u), tc, cfg)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **SSM)
    for a, b in zip(jc, tc):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **SSM)


def test_init_ssm_matches_reference_shapes():
    cfg = get_smoke_config("mamba2-1.3b")
    ref = JS.init_ssm(jax.random.PRNGKey(0), cfg)
    port = TS.init_ssm(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert sorted(ref) == sorted(port)
    assert all(tuple(ref[k].shape) == tuple(port[k].shape) for k in ref)
    assert TS.ssm_dims(cfg) == JS.ssm_dims(cfg)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe(arch, padded, seed):
    cfg = _cfg(arch)
    if padded:
        cfg = dataclasses.replace(cfg, n_experts_padded=cfg.n_experts + 4)
    p = convert.lm_params_to_numpy(TM.init_moe(torch.Generator().manual_seed(seed), cfg,
                                               device="cpu"))
    # a wider router spreads the scores: no near-ties among the kept ones
    p["router"] = p["router"] * 50
    return cfg, jax.tree_util.tree_map(jnp.asarray, p), convert.lm_params_from_arrays(
        p, device="cpu")


@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b"])
def test_apply_moe_matches_reference(arch, padded, decode):
    """Output and both losses; padding experts never routed; the decode
    grouping (1, B, D), where the batch forms one group."""
    cfg, jp, tp = _moe(arch, padded, 9)
    assert cfg.experts_alloc == cfg.n_experts + 4 * padded
    shape = (1, 8, cfg.d_model) if decode else (2, 16, cfg.d_model)
    x = np.random.default_rng(9).standard_normal(shape).astype(np.float32)
    jo, jl = _moe_apply(jp, jnp.asarray(x), cfg)
    to, tl = TM.apply_moe(tp, _t(x), cfg)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **F32)
    assert sorted(jl) == sorted(tl)
    for name in jl:
        np.testing.assert_allclose(float(tl[name]), float(jl[name]), **F32)


def test_moe_combine_is_fixed_order_and_sums_every_kept_slot():
    """The combine has no atomics: two runs are bit-equal, and it equals
    the scatter-add of the same slots (float64 here, so the order does not
    round) within the float32 clause; a token over capacity adds nothing."""
    cfg, _, tp = _moe("qwen2-moe-a2.7b", True, 10)
    cfg = dataclasses.replace(cfg, capacity_factor=0.5)      # drop some tokens
    x = _t(np.random.default_rng(10).standard_normal((2, 16, cfg.d_model)).astype(np.float32))
    a, _ = TM.apply_moe(tp, x, cfg)
    b, _ = TM.apply_moe(tp, x, cfg)
    assert torch.equal(a, b)

    B, S, D = x.shape
    C = TM.moe_capacity(cfg, S)
    probs = torch.softmax(x @ tp["router"], -1)
    top_p, top_i = torch.topk(probs, cfg.n_experts_per_tok)
    scores = torch.zeros((B, S, cfg.experts_alloc)).scatter_(-1, top_i, top_p)
    gate_ec, tok_ec = torch.topk(scores.transpose(1, 2), C)
    live = gate_ec > 0
    xg = x[torch.arange(B)[:, None, None], tok_ec]
    h = torch.einsum("becd,edf->becf", xg, tp["gate"])
    u = torch.einsum("becd,edf->becf", xg, tp["up"])
    y = torch.einsum("becf,efd->becd", F.silu(h) * u, tp["down"]) * (gate_ec * live)[..., None]
    combined = TM._combine(y, tok_ec, live, top_i)
    want = torch.zeros((B, S, D), dtype=torch.float64)
    for bi in range(B):
        want[bi].index_add_(0, tok_ec[bi].reshape(-1), y[bi].reshape(-1, D).double())
    np.testing.assert_allclose(combined.numpy(), want.numpy(), **F32)
    kept = torch.zeros((B, S), dtype=torch.bool)
    for bi in range(B):
        kept[bi, tok_ec[bi][live[bi]]] = True
    assert not kept.all() and combined[~kept].abs().sum() == 0


def test_moe_capacity_and_init_match_reference():
    for arch in ("qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b"):
        cfg = get_smoke_config(arch)
        for tokens in (1, 7, 16, 4096):
            assert TM.moe_capacity(cfg, tokens) == JM.moe_capacity(cfg, tokens)
        ref = JM.init_moe(jax.random.PRNGKey(0), cfg)
        port = TM.init_moe(torch.Generator().manual_seed(0), cfg, device="cpu")
        assert jax.tree_util.tree_structure(ref) == jax.tree_util.tree_structure(port)
        assert [tuple(a.shape) for a in jax.tree_util.tree_leaves(ref)] == \
            [tuple(a.shape) for a in jax.tree_util.tree_leaves(port)]
    assert not TM._ep_active(get_smoke_config("qwen2-moe-a2.7b"))
