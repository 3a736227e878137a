"""Mixture-of-Experts layer: top-k routing with per-group expert capacity
(port of ``repro.models.moe``; ROADMAP item 18b).

Tokens are grouped (training: one group per batch row), each expert takes
its top-C tokens per group (C = S·k/E·capacity_factor), the selected tokens
are gathered into a dense (G, E, C, D) block, the experts run as batched
einsums, and the results return to their tokens.  Tokens beyond capacity
are dropped; their combine weight is zero, so the residual path carries
them unchanged.  Padding experts (``n_experts_padded > n_experts``) are
allocated but never routed.

The combine is deterministic.  The reference scatter-adds
(``out.at[b, tok].add(y, mode="drop")``, ``moe.py:103-105``); on CUDA
``index_add_``/``scatter_add_`` use float atomics, so a bfloat16 sum would
change from run to run.  Here the (B, E, C) assignment is inverted into each
token's k slots and the slots are summed in a fixed order, by expert index,
with no atomics: two CUDA runs are bit-equal.

There is no mesh before item 18d, so expert parallelism is off
(:func:`_ep_active`), and the reference's ``constrain(...)`` hints
(``moe.py:94-99``) are left out.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, dense_init, draw_normal, init_device, pdtype


def _ep_active(cfg) -> bool:
    """Expert parallelism: no mesh in the port until item 18d."""
    return False


def moe_capacity(cfg, tokens_per_group: int) -> int:
    c = int(tokens_per_group * cfg.n_experts_per_tok * cfg.capacity_factor
            / cfg.n_experts)
    return min(max(c, 1), tokens_per_group)


def init_moe(gen, cfg, *, device: str | torch.device = "cuda") -> Params:
    dev = init_device(device)
    dt = pdtype(cfg)
    # expert tables allocate experts_alloc rows: padding experts (never
    # routed: their scores stay 0) buy EP divisibility in the reference
    d, e, f = cfg.d_model, cfg.experts_alloc, cfg.moe_d_ff
    p = {
        "router": dense_init(gen, d, cfg.n_experts, dt, scale=0.02, device=dev),
        "gate": (draw_normal(gen, (e, d, f), dev, truncate=True) / math.sqrt(d)).to(dt),
        "up": (draw_normal(gen, (e, d, f), dev, truncate=True) / math.sqrt(d)).to(dt),
        "down": (draw_normal(gen, (e, f, d), dev, truncate=True) / math.sqrt(f)).to(dt),
    }
    if cfg.shared_d_ff:
        p["shared"] = {
            "gate": dense_init(gen, d, cfg.shared_d_ff, dt, device=dev),
            "up": dense_init(gen, d, cfg.shared_d_ff, dt, device=dev),
            "down": dense_init(gen, cfg.shared_d_ff, d, dt, device=dev),
            "route": dense_init(gen, d, 1, dt, scale=0.02, device=dev),
        }
    return p


def _combine(y: torch.Tensor, tok_ec: torch.Tensor, live: torch.Tensor,
             top_i: torch.Tensor) -> torch.Tensor:
    """The experts' weighted outputs y (B,E,C,D) summed back to token
    positions (B,S,D) without atomics.

    Within one (b, e) row ``tok_ec`` holds distinct tokens, so scattering
    each live slot's capacity index to (b, e, token) writes every cell at
    most once.  A token's live slots lie among its top-k experts; its k
    contributions are read at (expert, capacity index) and added to zero in
    ascending expert order (the order of the reference's scatter-add), a
    dropped one as an exact zero."""
    B, E, C, D = y.shape
    S = top_i.shape[1]
    cap = torch.full((B, E, S), C, dtype=torch.int64, device=y.device)  # C: no slot
    c_idx = torch.arange(C, device=y.device).expand(B, E, C)
    cap.scatter_(2, tok_ec, torch.where(live, c_idx, C))
    experts, _ = top_i.sort(dim=-1)                                     # (B,S,K)
    slot = cap.gather(1, experts.transpose(1, 2)).transpose(1, 2)       # (B,S,K)
    flat = torch.cat([y.reshape(B, E * C, D), y.new_zeros((B, 1, D))], dim=1)
    index = torch.where(slot < C, experts * C + slot, E * C)            # (B,S,K)
    picked = flat.gather(1, index.reshape(B, -1, 1).expand(-1, -1, D)).reshape(B, S, -1, D)
    out = torch.zeros((B, S, D), dtype=y.dtype, device=y.device)
    for k in range(picked.shape[2]):
        out = out + picked[:, :, k]
    return out


def apply_moe(p: Params, x: torch.Tensor, cfg) -> tuple[torch.Tensor, dict]:
    """x: (B, S, D) → (out (B,S,D), aux losses dict).

    B is the group axis; decode callers reshape (B,1,D) → (1,B,D) first so
    the batch forms one group.
    """
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.n_experts_per_tok
    E_alloc = cfg.experts_alloc
    C = moe_capacity(cfg, S)
    dt = x.dtype

    logits = (x @ p["router"].to(dt)).float()                  # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, K, dim=-1)                # (B,S,K)
    if cfg.norm_topk:
        top_p = top_p / top_p.sum(-1, keepdim=True)

    # (B,S,E_alloc) combine scores: prob where chosen else 0; padding
    # experts (index ≥ E) keep all-zero scores → capacity rows dead.  The
    # reference's one-hot einsum adds one nonzero term per cell: the same
    # bits as this scatter.
    scores = torch.zeros((B, S, E_alloc), dtype=torch.float32, device=x.device)
    scores.scatter_(-1, top_i, top_p)

    # per-expert top-C tokens per group.  Dead slots tie at score 0 and
    # torch.topk may order them otherwise than lax.top_k; ``live`` masks
    # them, so they add exact zeros
    gate_ec, tok_ec = torch.topk(scores.transpose(1, 2), C, dim=-1)   # (B,E,C)
    live = gate_ec > 0.0                                         # capacity fill

    # gather selected tokens: (B,E,C,D)
    b_idx = torch.arange(B, device=x.device)[:, None, None]
    xg = x[b_idx, tok_ec]
    h = torch.einsum("becd,edf->becf", xg, p["gate"].to(dt))
    u = torch.einsum("becd,edf->becf", xg, p["up"].to(dt))
    y = torch.einsum("becf,efd->becd", F.silu(h) * u, p["down"].to(dt))
    y = y * (gate_ec * live)[..., None].to(dt)
    out = _combine(y, tok_ec, live, top_i)

    if cfg.shared_d_ff:
        sp = p["shared"]
        g = F.silu(x @ sp["gate"].to(dt)) * (x @ sp["up"].to(dt))
        shared = g @ sp["down"].to(dt)
        route = torch.sigmoid((x @ sp["route"].to(dt)).float())
        out = out + shared * route.to(dt)

    # aux losses: Switch load-balance + router z-loss (real experts only)
    chosen = torch.zeros((B, S, E), dtype=torch.float32, device=x.device)
    chosen.scatter_(-1, top_i, 1.0)
    density = chosen.mean(dim=(0, 1))
    router_mean = probs.mean(dim=(0, 1))
    aux = E * (density * router_mean).sum()
    zloss = torch.logsumexp(logits, dim=-1).square().mean()
    losses = {"moe_aux": cfg.router_aux_weight * aux,
              "moe_z": cfg.router_z_weight * zloss}
    return out, losses
