"""Shared model layers: norms, rotary/sinusoidal positions, MLPs, embeddings
(port of ``repro.models.layers``; ROADMAP item 18b).

Plain functions on dict parameter trees: ``init_*`` builds a tree, the
matching apply function consumes it.  Compute runs in ``cfg.dtype``
(bfloat16 by default) over float32 master parameters, cast on each call as
the reference casts them; norm statistics and softmax accumulate in
float32.  Every ``init_*`` takes an explicit ``torch.Generator`` and a
``device`` (default ``"cuda"``, through :func:`repro_torch.device.resolve_device`);
``device="meta"`` builds the tree of shapes alone, draws nothing and needs
no generator.  A draw runs on the generator's device and moves to
``device``.

Inside the sharded train step's tensor-parallel context (ROADMAP item
19a, ``distributed.sharding.use_tensor_parallel``) the MLP, the embedding
and the LM head compute the rank's 'model' share, as GSPMD partitions the
reference's at its ``constrain`` sites (``layers.py:119-123``): the MLP's
gate/up column-parallel and its down row-parallel, the token table
vocab-parallel both ways.  Elsewhere they compute whole.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (column_parallel, constrain, model_dim, on_model,
                                              reduce_from_model, row_parallel, tp_rank,
                                              tp_size, tp_width)
from repro_torch.models.config import multiplier

Params = dict[str, Any]


def _dtype(name: str) -> torch.dtype:
    """The torch dtype a config's dtype string names ("bfloat16", ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def cdtype(cfg) -> torch.dtype:
    return _dtype(cfg.dtype)


def pdtype(cfg) -> torch.dtype:
    return _dtype(cfg.param_dtype)


def init_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` for an ``init_*``: ``"meta"`` as it is (shapes only),
    anything else through :func:`resolve_device` (CUDA unless the caller
    asks for the CPU)."""
    dev = torch.device(device)
    return dev if dev.type == "meta" else resolve_device(dev)


def draw_normal(gen: torch.Generator | None, shape: tuple, device: torch.device, *,
                truncate: bool = False) -> torch.Tensor:
    """Standard normal float32 draws (truncated to [-2, 2] when asked, as
    ``jax.random.truncated_normal(key, -2, 2, shape)``) on ``gen``'s device,
    moved to ``device``; an empty tensor on the meta device."""
    if device.type == "meta":
        return torch.empty(shape, device=device)
    x = torch.empty(shape, device=gen.device)
    if truncate:
        torch.nn.init.trunc_normal_(x, a=-2.0, b=2.0, generator=gen)
    else:
        x.normal_(generator=gen)
    return x.to(device)


def dense_init(gen, d_in: int, d_out: int, dtype, scale: float | None = None, *,
               device: str | torch.device = "cuda") -> torch.Tensor:
    dev = init_device(device)
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return (draw_normal(gen, (d_in, d_out), dev, truncate=True) * scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(cfg, d: int, *, device: str | torch.device = "cuda") -> Params:
    dev = init_device(device)
    p = {"scale": torch.ones((d,), dtype=pdtype(cfg), device=dev)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=pdtype(cfg), device=dev)
    return p


def apply_norm(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * p["scale"].float()
    return y.to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """Per-head RMSNorm on (..., head_dim) — qwen3 qk_norm."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Positions
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, *, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE.  x: (..., seq, heads, head_dim); positions: (..., seq).
    Angles, cos and sin in float32."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)   # (hd/2,)
    angles = positions[..., None].float() * freqs              # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]                      # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Classic transformer sinusoidal embedding (musicgen)."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10_000.0)
                      * torch.arange(half, dtype=torch.float32, device=positions.device)
                      / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen, cfg, d_model: int, d_ff: int, *,
             device: str | torch.device = "cuda") -> Params:
    dev = init_device(device)
    dt = pdtype(cfg)
    if cfg.mlp == "swiglu":
        return {"gate": dense_init(gen, d_model, d_ff, dt, device=dev),
                "up": dense_init(gen, d_model, d_ff, dt, device=dev),
                "down": dense_init(gen, d_ff, d_model, dt, device=dev)}
    return {"up": dense_init(gen, d_model, d_ff, dt, device=dev),
            "up_bias": torch.zeros((d_ff,), dtype=dt, device=dev),
            "down": dense_init(gen, d_ff, d_model, dt, device=dev),
            "down_bias": torch.zeros((d_model,), dtype=dt, device=dev)}


def apply_mlp(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """The block MLP (width ``cfg.d_ff``); tensor-parallel: gate/up
    column-parallel, down row-parallel, ``up_bias`` on the rank's columns
    and ``down_bias`` added once, after the reduction."""
    dt, f = x.dtype, cfg.d_ff
    spec = ("batch", None, "tp")
    if cfg.mlp == "swiglu":
        g, u = column_parallel(x, (p["gate"].to(dt), f, "mlp/gate"),
                               (p["up"].to(dt), f, "mlp/up"))
        return row_parallel(F.silu(constrain(g, spec)) * constrain(u, spec), p["down"].to(dt),
                            f, "mlp/down")
    h, = column_parallel(x, (p["up"].to(dt), f, "mlp/up"))
    h = constrain(h, spec) + p["up_bias"].to(dt)
    # jax.nn.gelu defaults to the tanh approximation (reference layers.py:123);
    # torch's default is the erf form
    h = F.gelu(h, approximate="tanh")
    return row_parallel(h, p["down"].to(dt), f, "mlp/down") + p["down_bias"].to(dt)


# ---------------------------------------------------------------------------
# Embeddings / LM head
# ---------------------------------------------------------------------------

def init_embedding(gen, cfg, *, device: str | torch.device = "cuda") -> Params:
    dev = init_device(device)
    dt = pdtype(cfg)
    p = {"tok": (draw_normal(gen, (cfg.vocab_size, cfg.d_model), dev) * 0.02).to(dt)}
    if not cfg.tie_embeddings:
        p["out"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dt, device=dev)
    return p


def embed(p: Params, tokens: torch.Tensor, cfg) -> torch.Tensor:
    """Token rows, times ``cfg.embedding_multiplier`` in the compute dtype
    where it sets one.  Tensor-parallel with the table's rows on 'model':
    each rank looks up the tokens its rows hold, zeroes the others, and the
    ranks' rows are summed (the backward writes the rank's rows only)."""
    # the reference casts the whole table, then gathers (layers.py:142);
    # gathering first and casting the rows gives the same bits
    tok = p["tok"]
    if not tp_width(tok.shape[0], cfg.vocab_size, "embed/tok") or tp_size() == 1:
        x = tok[tokens].to(cdtype(cfg))
    else:
        lo = tp_rank() * tok.shape[0]
        mine = (tokens >= lo) & (tokens < lo + tok.shape[0])
        rows = tok[torch.where(mine, tokens - lo, 0)].to(cdtype(cfg))
        x = reduce_from_model(torch.where(mine[..., None], rows, 0.0))
    scale = multiplier(cfg, "embedding_multiplier")
    return x * scale if scale else x


def unembed(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """Logits, divided by ``cfg.logits_scaling`` where it sets one;
    tensor-parallel, column-parallel over the vocabulary (a tied table's
    rank rows, as in :func:`embed`), left vocab-sharded."""
    # the reference casts the float32 table on every call; so does the port
    w = p["tok"].to(x.dtype).T if cfg.tie_embeddings else p["out"].to(x.dtype)
    logits, = column_parallel(x, (w, cfg.vocab_size, "unembed"))
    if cfg.logit_softcap:
        logits = on_model(cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap),
                          model_dim(logits))
    scaling = multiplier(cfg, "logits_scaling")
    if scaling:
        logits = on_model(logits / scaling, model_dim(logits))
    return logits
