"""Mamba2 mixer with SSD (state-space duality) — arXiv:2405.21060 (port of
``repro.models.ssm``; ROADMAP item 18b).

Training/prefill uses the chunked dual form: within a chunk a masked,
attention-like quadratic einsum; across chunks a linear recurrence over the
carried (heads, d_state, head_dim) state, here a Python loop over the
chunks where the reference runs a ``lax.scan``.  Groups stay factorised
inside the einsums (B/C are never broadcast per head).

The three-operand einsums (``ssm.py:128,131,137``) may contract in another
order than XLA's, which changes rounding: they are held to the reference's
own ``rtol=atol=2e-3`` (``tests/test_models.py:216-218``).

Decode is the O(1) recurrent form: S' = exp(AΔ)·S + Δ·B⊗x, y = C·S' + D·x.
The reference's ``constrain(...)`` hints (``ssm.py:81-82``) are identities
on one process and are left out.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, dense_init, draw_normal, init_device, pdtype


def ssm_dims(cfg):
    di = cfg.ssm_expand * cfg.d_model
    heads = di // cfg.ssm_head_dim
    g = cfg.ssm_groups
    conv_dim = di + 2 * g * cfg.ssm_state
    return di, heads, g, conv_dim


def init_ssm(gen, cfg, *, device: str | torch.device = "cuda") -> Params:
    dev = init_device(device)
    di, heads, g, conv_dim = ssm_dims(cfg)
    dt_p = pdtype(cfg)
    # z / xBC / dt projections are separate matrices, as in the reference
    return {
        "wz": dense_init(gen, cfg.d_model, di, dt_p, device=dev),
        "wxbc": dense_init(gen, cfg.d_model, conv_dim, dt_p, device=dev),
        "wdt": dense_init(gen, cfg.d_model, heads, dt_p, device=dev),
        "conv_w": (draw_normal(gen, (cfg.d_conv, conv_dim), dev) * 0.1).to(dt_p),
        "conv_b": torch.zeros((conv_dim,), dtype=dt_p, device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, heads, device=dev)).to(dt_p),
        "d_skip": torch.ones((heads,), dtype=dt_p, device=dev),
        "dt_bias": torch.zeros((heads,), dtype=dt_p, device=dev),
        "norm_scale": torch.ones((di,), dtype=dt_p, device=dev),
        "out_proj": dense_init(gen, di, cfg.d_model, dt_p, device=dev),
    }


class SSMCache(NamedTuple):
    conv: torch.Tensor    # (B, d_conv-1, conv_dim)
    state: torch.Tensor   # (B, g, r, N, P) — r = heads per group


def init_ssm_cache(cfg, batch: int, dtype: torch.dtype = torch.float32, *,
                   device: str | torch.device = "cuda") -> SSMCache:
    dev = init_device(device)
    di, heads, g, conv_dim = ssm_dims(cfg)
    r = heads // g
    return SSMCache(
        conv=torch.zeros((batch, cfg.d_conv - 1, conv_dim), dtype=dtype, device=dev),
        state=torch.zeros((batch, g, r, cfg.ssm_state, cfg.ssm_head_dim), dtype=dtype,
                          device=dev))


def _gated_rmsnorm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                   eps: float) -> torch.Tensor:
    yf = (y * F.silu(z)).float()
    ms = yf.square().mean(-1, keepdim=True)
    return (yf * torch.rsqrt(ms + eps) * scale.float()).to(y.dtype)


def _split_proj(p: Params, u: torch.Tensor, cfg):
    z = u @ p["wz"].to(u.dtype)
    xbc = u @ p["wxbc"].to(u.dtype)
    dt = u @ p["wdt"].to(u.dtype)
    return z, xbc, dt


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_in: torch.Tensor,
             c_in: torch.Tensor, chunk: int, s0: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.

    x:  (B, L, g, r, P) inputs per head
    dt: (B, L, g, r)    positive step sizes
    a:  (g, r)          negative decay rates
    b_in/c_in: (B, L, g, N)
    Returns (y (B,L,g,r,P), final state (B,g,r,N,P)).
    """
    B, L, g, r, P = x.shape
    N = b_in.shape[-1]
    if L % chunk:
        raise ValueError(f"chunk {chunk} must divide L={L}")
    nc = L // chunk

    S = (torch.zeros((B, g, r, N, P), dtype=torch.float32, device=x.device)
         if s0 is None else s0)
    ii = torch.arange(chunk, device=x.device)
    causal = ii[:, None] >= ii[None, :]
    ys = []
    for ci in range(nc):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        x_k, dt_k, b_k, c_k = x[:, sl], dt[:, sl], b_in[:, sl], c_in[:, sl]
        a_bar = dt_k.float() * a                       # (B,Lc,g,r) ≤ 0
        a_cum = torch.cumsum(a_bar, dim=1)
        a_sum = a_cum[:, -1]                           # (B,g,r)
        xb = (x_k * dt_k[..., None]).float()

        # intra-chunk quadratic (diagonal block); mask in log space so the
        # anti-causal half never evaluates exp(+large) (inf·0 = NaN); the
        # reference's -inf (ssm.py:122-125), kept as it is
        seg = a_cum[:, :, None] - a_cum[:, None]       # (B,i,j,g,r)
        seg = torch.where(causal[None, :, :, None, None], seg, -torch.inf)
        l_mat = torch.exp(seg)
        cf, bf = c_k.float(), b_k.float()
        cb = torch.einsum("bign,bjgn->bijg", cf, bf)
        y = torch.einsum("bijg,bijgr,bjgrp->bigrp", cb, l_mat, xb)

        # inter-chunk contribution from the carried state
        y = y + torch.einsum("bign,bgrnp,bigr->bigrp", cf, S, torch.exp(a_cum))

        # state update for the next chunk
        decay = torch.exp(a_sum[:, None] - a_cum)      # (B,j,g,r)
        S = S * torch.exp(a_sum)[..., None, None] \
            + torch.einsum("bjgn,bjgr,bjgrp->bgrnp", bf, decay, xb)
        ys.append(y.to(x.dtype))
    return torch.cat(ys, dim=1), S


def apply_ssm_train(p: Params, u: torch.Tensor, cfg) -> torch.Tensor:
    """Full-sequence mixer (training/prefill).  u: (B, L, d_model)."""
    di, heads, g, conv_dim = ssm_dims(cfg)
    n, P = cfg.ssm_state, cfg.ssm_head_dim
    r = heads // g
    B, L, _ = u.shape
    z, xbc, dt_raw = _split_proj(p, u, cfg)

    # causal depthwise conv (width d_conv) + silu
    w = p["conv_w"].to(xbc.dtype)                      # (d_conv, conv_dim)
    xp = F.pad(xbc, (0, 0, cfg.d_conv - 1, 0))
    conv = sum(xp[:, i:i + L] * w[i] for i in range(cfg.d_conv))
    xbc = F.silu(conv + p["conv_b"].to(xbc.dtype))

    x = xbc[..., :di].reshape(B, L, g, r, P)
    b_in = xbc[..., di:di + g * n].reshape(B, L, g, n)
    c_in = xbc[..., di + g * n:].reshape(B, L, g, n)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    dt = dt.reshape(B, L, g, r)
    a = -torch.exp(p["a_log"].float()).reshape(g, r)

    y, _ = ssd_scan(x, dt, a, b_in, c_in, cfg.ssd_chunk)
    y = y + p["d_skip"].to(y.dtype).reshape(g, r)[None, None, :, :, None] * x
    y = y.reshape(B, L, di)
    y = _gated_rmsnorm(y, z, p["norm_scale"], cfg.norm_eps)
    return y @ p["out_proj"].to(u.dtype)


def apply_ssm_decode(p: Params, u: torch.Tensor, cache: SSMCache, cfg
                     ) -> tuple[torch.Tensor, SSMCache]:
    """Single-token recurrent step.  u: (B, 1, d_model).  Returns the new
    cache as new tensors; ``transformer.decode_step`` copies them into the
    stacked cache in place."""
    di, heads, g, conv_dim = ssm_dims(cfg)
    n, P = cfg.ssm_state, cfg.ssm_head_dim
    r = heads // g
    B = u.shape[0]
    z, xbc_new, dt_raw = _split_proj(p, u, cfg)        # (B,1,·)

    # conv ring: window = [conv_state, x_new]; the cache stays float32, the
    # conv computes in the activation dtype
    win = torch.cat([cache.conv.to(xbc_new.dtype), xbc_new], dim=1)
    w = p["conv_w"].to(win.dtype)                      # (d_conv,·)
    conv = torch.einsum("bkc,kc->bc", win, w) + p["conv_b"].to(win.dtype)
    xbc = F.silu(conv)[:, None, :]                     # (B,1,conv_dim)
    conv_cache = win[:, 1:].to(cache.conv.dtype)

    x = xbc[..., :di].reshape(B, g, r, P)
    b_in = xbc[..., di:di + g * n].reshape(B, g, n)
    c_in = xbc[..., di + g * n:].reshape(B, g, n)
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"].float()).reshape(B, g, r)
    a = -torch.exp(p["a_log"].float()).reshape(g, r)

    decay = torch.exp(dt * a)                          # (B,g,r)
    xb = (x * dt[..., None]).float()
    state = cache.state * decay[..., None, None] \
        + torch.einsum("bgn,bgrp->bgrnp", b_in.float(), xb)
    y = torch.einsum("bgn,bgrnp->bgrp", c_in.float(), state)
    y = y.to(u.dtype) + p["d_skip"].to(u.dtype).reshape(g, r)[None, :, :, None] * x
    y = y.reshape(B, 1, di)
    y = _gated_rmsnorm(y, z, p["norm_scale"], cfg.norm_eps)
    return y @ p["out_proj"].to(u.dtype), SSMCache(conv=conv_cache, state=state)
