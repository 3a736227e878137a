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

The reference's ``constrain(...)`` sharding hints (``layers.py:119-123``)
are identities on one process and are left out (item 18d brings the LM
sharding rules).
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device

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
    dt = x.dtype
    if cfg.mlp == "swiglu":
        g = x @ p["gate"].to(dt)
        u = x @ p["up"].to(dt)
        return (F.silu(g) * u) @ p["down"].to(dt)
    h = x @ p["up"].to(dt) + p["up_bias"].to(dt)
    # jax.nn.gelu defaults to the tanh approximation (reference layers.py:123);
    # torch's default is the erf form
    h = F.gelu(h, approximate="tanh")
    return h @ p["down"].to(dt) + p["down_bias"].to(dt)


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
    # the reference casts the whole table, then gathers (layers.py:142);
    # gathering first and casting the rows gives the same bits
    return p["tok"][tokens].to(cdtype(cfg))


def unembed(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    # the reference casts the float32 table on every call; so does the port
    if cfg.tie_embeddings:
        logits = x @ p["tok"].to(x.dtype).T
    else:
        logits = x @ p["out"].to(x.dtype)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits
