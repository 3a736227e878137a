"""Mamba2 mixer with SSD (state-space duality) — arXiv:2405.21060 (port of
``repro.models.ssm``; ROADMAP item 18b).

Training/prefill uses the chunked dual form: within a chunk a masked,
attention-like quadratic einsum; across chunks a linear recurrence over the
carried (heads, d_state, head_dim) state, here a Python loop over the
chunks where the reference runs a ``lax.scan``.  Everything but the carried
state is computed for every chunk at once, the chunks a batch dimension
(each chunk's diagonal block, the state it hands on, its read of the state
it is handed), so the loop holds two small ops a chunk and a step's host
work does not grow with the chunk count's ops.  Groups stay factorised
inside the einsums (B/C are never broadcast per head).

The three-operand einsums (``ssm.py:128,131,137``) may contract in another
order than XLA's, which changes rounding: they are held to the reference's
own ``rtol=atol=2e-3`` (``tests/test_models.py:216-218``).

Decode is the O(1) recurrent form: S' = exp(AΔ)·S + Δ·B⊗x, y = C·S' + D·x.

Tensor-parallel (ROADMAP item 19b, inside ``use_tensor_parallel``: the
sharded train step, the prefill and the decode plans).  The reference's
``constrain`` sites (``ssm.py:80-84``) put ``z`` and ``xbc`` on 'model',
and the specs shard ``wz``/``wxbc`` by columns, ``conv_w``/``conv_b``/
``norm_scale`` by channels and ``out_proj`` by rows (``wdt`` stays whole).
The route chosen here keeps every gradient whole:

  * ``z`` and ``xbc`` are column-parallel products, and the depthwise conv,
    its bias and the silu run on the rank's stored channels (per channel);
  * ``xbc``'s columns are ``[x | B | C]``, and an even cut crosses from
    ``x`` into ``B``/``C`` (mamba2-1.3b: 4,352 columns, 272 a rank on 16),
    so after the silu ``xbc`` is all-gathered over 'model'.  Where the model
    axis divides the heads of a group (``r``, the axis the decode state
    shards, ``sharding.ssm_cache_specs``) each rank then runs the SSD scan
    on its own heads of every group, with ``B`` and ``C`` whole, entering
    through ``copy_to_model``; ``dt`` (from the whole ``wdt``), ``a_log``,
    ``d_skip`` and ``dt_bias`` are cut to those heads the same way.  Where
    it does not (hymba-1.5b's 50 heads on 16), every rank runs every head,
    as ``attention._heads`` gathers heads that do not divide, and cuts its
    columns of ``y`` for the gate;
  * ``_gated_rmsnorm``'s mean runs over all of ``d_inner``: the rank's sum
    of squares is summed over 'model' forward and its gradient backward
    (``reduce_from_model`` then ``copy_to_model``);
  * ``out_proj`` is row-parallel, summed over 'model' before the residual.

Every branch depends on shapes and the mesh alone, so every rank issues the
same collectives in the same order, in the recompute under remat too.  On a
one-rank axis no head or column is cut and the ops are the unsharded ones.
Decode runs the same route on its one token against the rank's cache shard
(conv channels and state heads placed by ``ssm_cache_specs``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (column_parallel, copy_to_model, gather_from_model,
                                              model_dim, model_slice, on_model,
                                              reduce_from_model, row_parallel, tp_rank, tp_size)
from repro_torch.models.layers import Params, dense_init, draw_normal, init_device, pdtype
from repro_torch.spans import span


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


def _gated_rmsnorm_split(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, eps: float,
                         di: int) -> torch.Tensor:
    """:func:`_gated_rmsnorm` on the rank's columns of ``d_inner``: the sum
    of squares summed over 'model' both ways (module docstring)."""
    yf = (y * F.silu(z)).float()
    ss = copy_to_model(reduce_from_model(yf.square().sum(-1, keepdim=True)))
    return on_model((yf * torch.rsqrt(ss / di + eps) * scale.float()).to(y.dtype), -1)


def _split_proj(p: Params, u: torch.Tensor, cfg):
    """z, xbc (column-parallel where the specs split them) and dt (whole)."""
    di, _, _, conv_dim = ssm_dims(cfg)
    dt_ = u.dtype
    z, xbc = column_parallel(u, (p["wz"].to(dt_), di, "ssm/wz"),
                             (p["wxbc"].to(dt_), conv_dim, "ssm/wxbc"))
    dt = u @ p["wdt"].to(dt_)
    return z, xbc, dt


def _heads_split(cfg) -> bool:
    """Whether each rank runs its own heads of every group: the model axis
    (of more than one rank) divides the heads per group."""
    _, heads, g, _ = ssm_dims(cfg)
    return tp_size() > 1 and (heads // g) % tp_size() == 0


def _rank_inputs(p: Params, xbc: torch.Tensor, split_cols: bool, dt_raw: torch.Tensor, cfg):
    """The scan's inputs on this rank from the conv's output ``xbc`` (…,
    conv_dim or its 'model' shard) and ``dt_raw`` (…, heads): x (…, g, r',
    P), B and C (…, g, N) whole, dt (…, g, r') float32, a and D (g, r'),
    where r' is the rank's heads per group (all of them unless
    :func:`_heads_split`)."""
    di, heads, g, _ = ssm_dims(cfg)
    n, P = cfg.ssm_state, cfg.ssm_head_dim
    r = heads // g
    lead = xbc.shape[:-1]
    if split_cols:
        xbc = gather_from_model(xbc, -1)
    dt_bias, a_log, d_skip = p["dt_bias"], p["a_log"], p["d_skip"]
    split = _heads_split(cfg)
    if split:
        # every rank reads its heads of x and all of B and C: their
        # gradients are summed over 'model'
        xbc, dt_raw = copy_to_model(xbc), copy_to_model(dt_raw)
        dt_bias, a_log, d_skip = (copy_to_model(t) for t in (dt_bias, a_log, d_skip))
    x = xbc[..., :di].reshape(*lead, g, r, P)
    b_in = xbc[..., di:di + g * n].reshape(*lead, g, n)
    c_in = xbc[..., di + g * n:].reshape(*lead, g, n)
    dt = F.softplus(dt_raw.float() + dt_bias.float()).reshape(*lead, g, r)
    a = -torch.exp(a_log.float()).reshape(g, r)
    d = d_skip.reshape(g, r)
    if split:
        rl = r // tp_size()
        r0 = tp_rank() * rl
        x = x.narrow(-2, r0, rl)
        dt, a, d = (t.narrow(-1, r0, rl) for t in (dt, a, d))
    return x, b_in, c_in, dt, a, d


def _mixer_out(p: Params, y: torch.Tensor, z: torch.Tensor, cfg) -> torch.Tensor:
    """The scan's output y (…, g, r', P), gated by z, normalised and
    projected back to d_model (row-parallel where ``out_proj`` is split)."""
    di, heads, g, _ = ssm_dims(cfg)
    lead = y.shape[:-3]
    if _heads_split(cfg):
        if g == 1:       # the rank's heads are its d_inner columns
            y = on_model(y.reshape(*lead, -1), -1)
        else:            # its heads of every group: gather, then cut columns
            y = gather_from_model(y.reshape(*lead, g, -1), -1).reshape(*lead, di)
    else:
        y = y.reshape(*lead, di)
    if model_dim(z) is not None and tp_size() > 1:
        if model_dim(y) is None:
            y = model_slice(y, -1)
        y = _gated_rmsnorm_split(y, z, p["norm_scale"], cfg.norm_eps, di)
    else:
        y = _gated_rmsnorm(y, z, p["norm_scale"], cfg.norm_eps)
    return row_parallel(y, p["out_proj"].to(y.dtype), di, "ssm/out_proj")


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

    # every chunk at once: (B, nc, Q, ...), Q = chunk
    x_c = x.reshape(B, nc, chunk, g, r, P)
    dt_c = dt.reshape(B, nc, chunk, g, r)
    bf = b_in.reshape(B, nc, chunk, g, N).float()
    cf = c_in.reshape(B, nc, chunk, g, N).float()
    a_bar = dt_c.float() * a                           # (B,nc,Q,g,r) ≤ 0
    a_cum = torch.cumsum(a_bar, dim=2)
    a_sum = a_cum[:, :, -1]                            # (B,nc,g,r)
    xb = (x_c * dt_c[..., None]).float()

    # intra-chunk quadratic (diagonal blocks); mask in log space so the
    # anti-causal half never evaluates exp(+large) (inf·0 = NaN); the
    # reference's -inf (ssm.py:122-125), kept as it is
    ii = torch.arange(chunk, device=x.device)
    causal = ii[:, None] >= ii[None, :]
    seg = a_cum[:, :, :, None] - a_cum[:, :, None]     # (B,nc,i,j,g,r)
    seg = torch.where(causal[:, :, None, None], seg, -torch.inf)
    l_mat = torch.exp(seg)
    cb = torch.einsum("bcign,bcjgn->bcijg", cf, bf)
    y = torch.einsum("bcijg,bcijgr,bcjgrp->bcigrp", cb, l_mat, xb)

    # what each chunk adds to the state it hands on
    decay = torch.exp(a_sum[:, :, None] - a_cum)       # (B,nc,j,g,r)
    added = torch.einsum("bcjgn,bcjgr,bcjgrp->bcgrnp", bf, decay, xb)

    # the carried state, chunk by chunk: the state each chunk is handed
    S = (torch.zeros((B, g, r, N, P), dtype=torch.float32, device=x.device)
         if s0 is None else s0)
    held = []
    for ci in range(nc):
        held.append(S)
        S = S * torch.exp(a_sum[:, ci])[..., None, None] + added[:, ci]

    # inter-chunk contribution from the state each chunk was handed
    y = y + torch.einsum("bcign,bcgrnp,bcigr->bcigrp", cf, torch.stack(held, 1),
                         torch.exp(a_cum))
    return y.reshape(B, L, g, r, P).to(x.dtype), S


def apply_ssm_train(p: Params, u: torch.Tensor, cfg) -> torch.Tensor:
    """Full-sequence mixer (training/prefill).  u: (B, L, d_model);
    tensor-parallel as the module docstring says.  The whole mixer is the
    span ``repro_torch.lm.ssm``, the scan ``repro_torch.lm.ssd_scan``
    (``repro_torch.spans``: no-ops with no profiler running)."""
    with span("repro_torch.lm.ssm"):
        return _ssm_train(p, u, cfg)


def _ssm_train(p: Params, u: torch.Tensor, cfg) -> torch.Tensor:
    L = u.shape[1]
    z, xbc, dt_raw = _split_proj(p, u, cfg)
    split_cols = model_dim(xbc) is not None

    # causal depthwise conv (width d_conv) + silu, on the rank's channels
    w = p["conv_w"].to(xbc.dtype)                      # (d_conv, conv_dim)
    xp = F.pad(xbc, (0, 0, cfg.d_conv - 1, 0))
    conv = sum(xp[:, i:i + L] * w[i] for i in range(cfg.d_conv))
    xbc = F.silu(conv + p["conv_b"].to(xbc.dtype))

    x, b_in, c_in, dt, a, d = _rank_inputs(p, xbc, split_cols, dt_raw, cfg)
    with span("repro_torch.lm.ssd_scan"):
        y, _ = ssd_scan(x, dt, a, b_in, c_in, cfg.ssd_chunk)
    y = y + d.to(y.dtype)[None, None, :, :, None] * x
    return _mixer_out(p, y, z, cfg)


def apply_ssm_decode(p: Params, u: torch.Tensor, cache: SSMCache, cfg
                     ) -> tuple[torch.Tensor, SSMCache]:
    """Single-token recurrent step.  u: (B, 1, d_model).  Returns the new
    cache as new tensors; ``transformer.decode_step`` copies them into the
    stacked cache in place.  Tensor-parallel, ``cache`` is the rank's shard
    (its conv channels and state heads, ``sharding.ssm_cache_specs``)."""
    z, xbc_new, dt_raw = _split_proj(p, u, cfg)        # (B,1,·)
    split_cols = model_dim(xbc_new) is not None
    if cache.conv.shape[-1] != xbc_new.shape[-1]:
        raise ValueError(f"ssm decode: a conv cache of {cache.conv.shape[-1]} channels for "
                         f"{xbc_new.shape[-1]} columns of xbc")

    # conv ring: window = [conv_state, x_new]; the cache stays float32, the
    # conv computes in the activation dtype
    win = torch.cat([cache.conv.to(xbc_new.dtype), xbc_new], dim=1)
    w = p["conv_w"].to(win.dtype)                      # (d_conv,·)
    conv = torch.einsum("bkc,kc->bc", win, w) + p["conv_b"].to(win.dtype)
    xbc = F.silu(conv)[:, None, :]                     # (B,1,conv_dim)
    conv_cache = win[:, 1:].to(cache.conv.dtype)

    x, b_in, c_in, dt, a, d = _rank_inputs(p, xbc, split_cols, dt_raw, cfg)
    x, b_in, c_in, dt = x[:, 0], b_in[:, 0], c_in[:, 0], dt[:, 0]
    if cache.state.shape[2] != x.shape[2]:
        raise ValueError(f"ssm decode: a state of {cache.state.shape[2]} heads a group for "
                         f"this rank's {x.shape[2]}")

    decay = torch.exp(dt * a)                          # (B,g,r)
    xb = (x * dt[..., None]).float()
    state = cache.state * decay[..., None, None] \
        + torch.einsum("bgn,bgrp->bgrnp", b_in.float(), xb)
    y = torch.einsum("bgn,bgrnp->bgrp", c_in.float(), state)
    y = y.to(u.dtype) + d.to(u.dtype)[None, :, :, None] * x
    return _mixer_out(p, y[:, None], z, cfg), SSMCache(conv=conv_cache, state=state)
