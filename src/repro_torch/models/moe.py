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

On a mesh (ROADMAP item 18d) :func:`_ep_active` reads it as the reference
does and picks the ``constrain`` specs.  Inside the train step's
tensor-parallel context (item 19a) they place the experts' compute: with
the expert tables expert-parallel (``experts_alloc`` divisible by the
model axis) each rank runs its own experts on the tokens routed to them,
the router replicated; otherwise the expert hidden is split, gate/up
column-parallel and down row-parallel.  Under expert parallelism the
weighted outputs are all-gathered over the expert dim and combined in the
full order above, so the combine adds the same terms in the same order as
on one rank (an all-reduce of per-rank partial combines would change that
order).  The shared expert is a tensor-parallel MLP.  The balance loss is a product of two
batch means, so with the batch sharded over ranks both means, and the
router z-loss, are reduced over the batch shards inside the forward
(``distributed.sharding.batch_mean``): each rank's loss is then the whole
batch's, as under GSPMD.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (batch_mean, column_parallel, constrain,
                                              copy_to_model, current_mesh, gather_from_model,
                                              mesh_shape, on_model, reduce_from_model,
                                              row_parallel, tp_rank, tp_width)
from repro_torch.models.layers import Params, dense_init, draw_normal, init_device, pdtype


def _ep_active(cfg) -> bool:
    mesh = current_mesh()
    return mesh is not None and cfg.experts_alloc % mesh_shape(mesh)["model"] == 0


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
    ep = _ep_active(cfg)
    e_spec = ("batch", "tp", None, None) if ep else ("batch", None, None, None)
    f_spec = ("batch", "tp", None, None) if ep else ("batch", None, None, "tp")
    b_idx = torch.arange(B, device=x.device)[:, None, None]
    gate, up, down = p["gate"].to(dt), p["up"].to(dt), p["down"].to(dt)
    weight = gate_ec * live
    # tensor-parallel (module docstring): the rank's experts, or its slice
    # of every expert's hidden; neither outside the context
    ep_split = ep and tp_width(gate.shape[0], E_alloc, "moe/gate")
    f_split = not ep and tp_width(gate.shape[-1], cfg.moe_d_ff, "moe/gate")
    if ep_split:
        lo, n = tp_rank() * gate.shape[0], gate.shape[0]
        xg = on_model(copy_to_model(x)[b_idx, tok_ec[:, lo:lo + n]], 1)
        weight = copy_to_model(weight)[:, lo:lo + n]
    else:
        xg = x[b_idx, tok_ec]
    xg = constrain(xg, e_spec)
    xs = copy_to_model(xg) if f_split else xg
    hidden = 1 if ep_split else (-1 if f_split else None)
    h = constrain(on_model(torch.einsum("becd,edf->becf", xs, gate), hidden), f_spec)
    u = constrain(on_model(torch.einsum("becd,edf->becf", xs, up), hidden), f_spec)
    y = torch.einsum("becf,efd->becd", F.silu(h) * u, down)
    y = constrain(reduce_from_model(y) if f_split else on_model(y, 1 if ep_split else None),
                  e_spec)
    y = y * weight[..., None].to(dt)
    if ep_split:
        y = gather_from_model(y, 1)
    out = _combine(y, tok_ec, live, top_i)

    if cfg.shared_d_ff:
        sp, f = p["shared"], cfg.shared_d_ff
        g, su = column_parallel(x, (sp["gate"].to(dt), f, "shared/gate"),
                                (sp["up"].to(dt), f, "shared/up"))
        shared = row_parallel(F.silu(g) * su, sp["down"].to(dt), f, "shared/down")
        route = torch.sigmoid((x @ sp["route"].to(dt)).float())
        out = out + shared * route.to(dt)

    # aux losses: Switch load-balance + router z-loss (real experts only)
    chosen = torch.zeros((B, S, E), dtype=torch.float32, device=x.device)
    chosen.scatter_(-1, top_i, 1.0)
    density = chosen.mean(dim=(0, 1))
    router_mean = probs.mean(dim=(0, 1))
    zloss = torch.logsumexp(logits, dim=-1).square().mean()
    # the three means of the whole batch (one reduction when it is sharded)
    stats = batch_mean(torch.cat([density, router_mean, zloss[None]]))
    density, router_mean, zloss = stats[:E], stats[E:2 * E], stats[2 * E]
    aux = E * (density * router_mean).sum()
    losses = {"moe_aux": cfg.router_aux_weight * aux,
              "moe_z": cfg.router_z_weight * zloss}
    return out, losses
