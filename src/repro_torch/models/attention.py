"""Attention: GQA/MHA with RoPE, qk-norm, QKV bias, sliding windows,
cross-attention (VLM), and block-wise online softmax for long sequences
(port of ``repro.models.attention``; ROADMAP item 18b).

Long-sequence path: query blocks are unrolled in Python, each with a static
KV extent (no work on fully masked KV blocks); within a query block the KV
blocks run in a Python loop with the streaming-softmax recurrence of the
reference's ``lax.scan`` (``attention.py:124-142``), so peak memory is
O(block_q · block_kv) per head.

Scores and the probability-weighted sum accumulate in float32, as the
reference's ``preferred_element_type=jnp.float32`` (``attention.py:79,86``)
asks.  Torch has no such argument and a bfloat16 ``einsum`` returns
bfloat16, so the operands are upcast first: a bfloat16 × bfloat16 product
is exact in float32, so only the summation order can differ (TF32 stays
off, ``device.py``).  The reference's ``constrain(...)`` hints
(``attention.py:64-66``) are identities on one process and are left out.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.kvcache import clamped_start
from repro_torch.models.layers import (Params, apply_rope, dense_init, init_device,
                                       pdtype, rms_head_norm)

# the reference's mask value (attention.py:22); a finite one keeps a fully
# masked row's softmax finite, as the reference's does
NEG_INF = -1e30


def init_attention(gen, cfg, *, cross: bool = False,
                   device: str | torch.device = "cuda") -> Params:
    dev = init_device(device)
    hd = cfg.resolved_head_dim
    dt = pdtype(cfg)
    kv_in = cfg.vis_dim if cross else cfg.d_model
    p = {"wq": dense_init(gen, cfg.d_model, cfg.n_heads * hd, dt, device=dev),
         "wk": dense_init(gen, kv_in, cfg.n_kv_heads * hd, dt, device=dev),
         "wv": dense_init(gen, kv_in, cfg.n_kv_heads * hd, dt, device=dev),
         "wo": dense_init(gen, cfg.n_heads * hd, cfg.d_model, dt, device=dev)}
    if cfg.qkv_bias and not cross:
        p["bq"] = torch.zeros((cfg.n_heads * hd,), dtype=dt, device=dev)
        p["bk"] = torch.zeros((cfg.n_kv_heads * hd,), dtype=dt, device=dev)
        p["bv"] = torch.zeros((cfg.n_kv_heads * hd,), dtype=dt, device=dev)
    if cfg.qk_norm or cross:
        # llama-3.2 vision cross-attn normalises q/k as well
        p["q_norm"] = torch.ones((hd,), dtype=dt, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=dt, device=dev)
    if cross:
        p["gate_attn"] = torch.zeros((), dtype=dt, device=dev)   # tanh-gated residual
    return p


def project_qkv(p: Params, x: torch.Tensor, kv_src: torch.Tensor, cfg, *,
                positions: torch.Tensor | None,
                kv_positions: torch.Tensor | None = None,
                rope: bool = True) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns q (B,S,H,hd), k,v (B,T,K,hd); applies qk-norm + RoPE."""
    hd = cfg.resolved_head_dim
    B, S, _ = x.shape
    T = kv_src.shape[1]
    q = x @ p["wq"].to(x.dtype)
    k = kv_src @ p["wk"].to(x.dtype)
    v = kv_src @ p["wv"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, T, cfg.n_kv_heads, hd)
    v = v.reshape(B, T, cfg.n_kv_heads, hd)
    if "q_norm" in p:
        q = rms_head_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_head_norm(p["k_norm"], k, cfg.norm_eps)
    if rope and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        kp = kv_positions if kv_positions is not None else positions
        k = apply_rope(k, kp, cfg.rope_theta)
    return q, k, v


def _gqa_scores(qb: torch.Tensor, kb: torch.Tensor, scale: float) -> torch.Tensor:
    """(B,bq,K,G,hd) × (B,bt,K,hd) → float32 (B,K,G,bq,bt); operands upcast
    (the reference's ``preferred_element_type``, module docstring)."""
    return torch.einsum("bqkgd,btkd->bkgqt", qb.float(), kb.float()) * scale


def _gqa_accum(pb: torch.Tensor, vb: torch.Tensor) -> torch.Tensor:
    """(B,K,G,bq,bt) × (B,bt,K,hd) → float32 (B,K,G,bq,hd); the
    probabilities cast to v's dtype first, as the reference casts them, then
    both upcast."""
    return torch.einsum("bkgqt,btkd->bkgqd", pb.to(vb.dtype).float(), vb.float())


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        window: int = 0, block_q: int = 1024, block_kv: int = 1024,
                        q_offset: int = 0) -> torch.Tensor:
    """Causal (optionally sliding-window) attention, O(block²) memory.

    q: (B,S,H,hd); k,v: (B,T,K,hd) with T ≥ S (self-attention uses T=S;
    chunked prefill may pass a longer KV with ``q_offset``).
    """
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    bq = min(block_q, S)
    bkv = min(block_kv, T)
    if S % bq or T % bkv:
        raise ValueError(f"blocks ({bq},{bkv}) must divide (S={S}, T={T})")
    # the upcasts _gqa_scores makes, once for all blocks (v's stays per
    # block: _gqa_accum rounds the probabilities to v's dtype first)
    qr = q.reshape(B, S, K, G, hd).float()
    kf = k.float()
    ar_q = torch.arange(bq, device=q.device)
    ar_kv = torch.arange(bkv, device=q.device)

    out_blocks = []
    for qi in range(S // bq):
        q_lo = q_offset + qi * bq                       # absolute start row
        qb = qr[:, qi * bq:(qi + 1) * bq]
        # static KV extent for this query block
        hi_blk = min((q_lo + bq + bkv - 1) // bkv, T // bkv)
        lo_blk = 0 if window <= 0 else max(0, (q_lo - window + 1) // bkv)
        m = torch.full((B, K, G, bq), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, K, G, bq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, K, G, bq, hd), dtype=torch.float32, device=q.device)
        q_pos = q_lo + ar_q
        for bi in range(lo_blk, hi_blk):
            kb = kf[:, bi * bkv:(bi + 1) * bkv]
            vb = v[:, bi * bkv:(bi + 1) * bkv]
            s = _gqa_scores(qb, kb, scale)              # (B,K,G,bq,bkv)
            kv_pos = bi * bkv + ar_kv
            mask = q_pos[:, None] >= kv_pos[None, :]
            if window > 0:
                mask &= (q_pos[:, None] - kv_pos[None, :]) < window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            pexp = torch.exp(s - m_new[..., None])
            l = l * corr + pexp.sum(-1)
            acc = acc * corr[..., None] + _gqa_accum(pexp, vb)
            m = m_new
        ob = acc / torch.clamp_min(l, 1e-30)[..., None]  # (B,K,G,bq,hd)
        out_blocks.append(ob.permute(0, 3, 1, 2, 4).reshape(B, bq, H, hd))
    return torch.cat(out_blocks, dim=1).to(q.dtype)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor | None) -> torch.Tensor:
    """Unblocked attention (cross-attention / decode / short sequences)."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    s = _gqa_scores(q.reshape(B, S, K, G, hd), k, scale)   # (B,K,G,S,T)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = _gqa_accum(p, v)                                     # (B,K,G,S,hd)
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)


def self_attention_train(p: Params, x: torch.Tensor, cfg, *, positions: torch.Tensor,
                         window: int = 0, block_q: int = 1024,
                         block_kv: int = 1024) -> torch.Tensor:
    """Causal self-attention for the training/prefill path."""
    q, k, v = project_qkv(p, x, x, cfg, positions=positions,
                          rope=cfg.pos_embedding == "rope")
    B, S = x.shape[:2]
    if S <= block_q:  # short sequence: dense with causal mask
        pos = positions[0] if positions.ndim > 1 else positions
        mask = pos[:, None] >= pos[None, :]
        if window > 0:
            mask &= (pos[:, None] - pos[None, :]) < window
        o = dense_attention(q, k, v, mask)
    else:
        o = blockwise_attention(q, k, v, window=window, block_q=block_q,
                                block_kv=block_kv)
    hd = cfg.resolved_head_dim
    return o.reshape(B, S, cfg.n_heads * hd) @ p["wo"].to(x.dtype)


def cross_attention(p: Params, x: torch.Tensor,
                    vis_kv: tuple[torch.Tensor, torch.Tensor], cfg) -> torch.Tensor:
    """Cross-attention to precomputed vision K/V (B,Nv,K,hd); tanh-gated."""
    hd = cfg.resolved_head_dim
    B, S, _ = x.shape
    q = (x @ p["wq"].to(x.dtype)).reshape(B, S, cfg.n_heads, hd)
    q = rms_head_norm(p["q_norm"], q, cfg.norm_eps)
    k, v = vis_kv
    o = dense_attention(q, k, v, None)
    o = o.reshape(B, S, cfg.n_heads * hd) @ p["wo"].to(x.dtype)
    return torch.tanh(p["gate_attn"].float()).to(x.dtype) * o


def vision_kv(p: Params, vis_embed: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """Project vision embeddings to K/V once (shared across decode steps)."""
    hd = cfg.resolved_head_dim
    B, Nv, _ = vis_embed.shape
    k = (vis_embed @ p["wk"].to(vis_embed.dtype)).reshape(B, Nv, cfg.n_kv_heads, hd)
    v = (vis_embed @ p["wv"].to(vis_embed.dtype)).reshape(B, Nv, cfg.n_kv_heads, hd)
    k = rms_head_norm(p["k_norm"], k, cfg.norm_eps)
    return k, v


def decode_attention(p: Params, x: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, cfg, *,
                     window: int = 0) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode: query length 1 against the (possibly ring) cache.

    x: (B,1,D); caches: (B,T,K,hd), consumed: this step's K/V is written
    into them in place at ``pos`` (mod T for a ring), clamped to slot T-1
    past the end of a linear cache as the reference's
    ``dynamic_update_slice`` clamps it (``attention.py:222-225``); then
    attend.  Returns (out (B,1,D), k_cache, v_cache).
    """
    B = x.shape[0]
    T = k_cache.shape[1]
    hd = cfg.resolved_head_dim
    pos = int(pos)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = project_qkv(p, x, x, cfg, positions=positions,
                                  rope=cfg.pos_embedding == "rope")
    slot = clamped_start(pos % T if window > 0 else pos, 1, T)   # ring for SWA
    k_cache[:, slot:slot + 1] = k_new.to(k_cache.dtype)
    v_cache[:, slot:slot + 1] = v_new.to(v_cache.dtype)
    # validity: ring cache → all written slots; linear cache → idx ≤ pos
    idx = torch.arange(T, device=x.device)
    valid = idx < min(pos + 1, T) if window > 0 else idx <= pos
    o = dense_attention(q, k_cache.to(q.dtype), v_cache.to(q.dtype),
                        valid[None, None, None, None, :])
    return (o.reshape(B, 1, cfg.n_heads * hd) @ p["wo"].to(x.dtype), k_cache, v_cache)
