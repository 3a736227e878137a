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
off, ``device.py``).

Tensor-parallel (ROADMAP item 19a, inside the sharded train step's
``use_tensor_parallel``): q, k and v are column-parallel products, and the
reference's ``constrain`` on the heads (``attention.py:64-66``) places
them: heads the model axis divides stay sharded; where the weight's columns
divide but the heads do not (qwen2-1.5b's 6 heads, a GQA model's kv heads
on a wide model axis), the projection runs split and its output is
all-gathered.  Head counts are read from the local tensors.  Sharded q
heads meet their own kv heads (global head ``h`` → kv ``h // (H/K)``): cut
from replicated k and v when those are whole.  The output projection is
row-parallel, its sum over 'model' taken before the residual.

Decode on the tensor-parallel decode plan (ROADMAP item 19b) reads the
rank's cache shard as ``sharding.kv_cache_spec`` places it: its kv heads
where the model axis divides them (the rank's q heads meet their own kv
heads), else its slice of the context T (over 'model', and with one
sequence over 'data' too).  A rank holding a slice of T scores every q head
(q is all-gathered over 'model' first) against its slots, and the softmax
over T becomes a log-sum-exp combine over the T axes
(:func:`decode_attend`): the global maximum of the ranks' maxima, then each
rank's sum of exponentials and weighted V from it, summed.  The combine runs
only where T is cut over more than one rank, so a one-rank mesh runs the
unsharded arithmetic.
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed.sharding import (column_parallel, constrain, copy_to_model,
                                              cut_of, gather_from_model, model_dim, on_model,
                                              over_decode_axes, row_parallel, tp_mesh, tp_rank,
                                              tp_size, tp_splits)
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


_HEADS = ("batch", None, "tp", None)


def _heads(t: torch.Tensor, bias: torch.Tensor | None, n_heads: int, hd: int) -> torch.Tensor:
    """A projection's output (B,T,cols) + ``bias`` → heads (B,T,n,hd), at
    the reference's head constraint: columns sharded over 'model' whose
    heads the axis does not divide are all-gathered first."""
    dim = model_dim(t)
    if bias is not None:
        t = on_model(t + bias, dim)
    if dim is not None and not tp_splits(n_heads):
        t, dim = constrain(t, ("batch", None, None)), None
    h = on_model(t.reshape(*t.shape[:2], -1, hd), None if dim is None else 2)
    return constrain(h, _HEADS)


def _head_norm(scale: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """:func:`rms_head_norm` of heads ``x``; a replicated ``scale`` applied
    to 'model'-sharded heads enters through ``copy_to_model``."""
    dim = model_dim(x)
    if dim is not None:
        scale = copy_to_model(scale)
    return on_model(rms_head_norm(scale, x, eps), dim)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    return on_model(apply_rope(x, positions, theta), model_dim(x))


def project_qkv(p: Params, x: torch.Tensor, kv_src: torch.Tensor, cfg, *,
                positions: torch.Tensor | None,
                kv_positions: torch.Tensor | None = None,
                rope: bool = True) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns q (B,S,H,hd), k,v (B,T,K,hd); applies qk-norm + RoPE.
    Tensor-parallel: the rank's heads of each (module docstring)."""
    hd = cfg.resolved_head_dim
    dt = x.dtype
    q_cols, kv_cols = cfg.n_heads * hd, cfg.n_kv_heads * hd
    wq = (p["wq"].to(dt), q_cols, "attn/wq")
    wk, wv = (p["wk"].to(dt), kv_cols, "attn/wk"), (p["wv"].to(dt), kv_cols, "attn/wv")
    if kv_src is x:
        q, k, v = column_parallel(x, wq, wk, wv)
    else:
        (q,), (k, v) = column_parallel(x, wq), column_parallel(kv_src, wk, wv)
    bq, bk, bv = ((p["bq"].to(dt), p["bk"].to(dt), p["bv"].to(dt)) if "bq" in p
                  else (None, None, None))
    q = _heads(q, bq, cfg.n_heads, hd)
    k = _heads(k, bk, cfg.n_kv_heads, hd)
    v = _heads(v, bv, cfg.n_kv_heads, hd)
    if "q_norm" in p:
        q = _head_norm(p["q_norm"], q, cfg.norm_eps)
        k = _head_norm(p["k_norm"], k, cfg.norm_eps)
    if rope and positions is not None:
        q = _rope(q, positions, cfg.rope_theta)
        kp = kv_positions if kv_positions is not None else positions
        k = _rope(k, kp, cfg.rope_theta)
    return q, k, v


def kv_for_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """k and v as the heads ``q`` holds attend to them.  Outside
    tensor-parallel compute, or with all three sharded alike, as they are.
    With q's heads sharded over 'model' and k, v replicated, the rank's q
    heads ``h0 ..`` (global) need kv heads ``h // G``: a contiguous run of
    whole groups is cut as it is; otherwise each local q head gets its own
    kv head (one group each)."""
    if model_dim(q) is None or model_dim(k) is not None:
        if model_dim(k) is not None and model_dim(q) is None:
            raise ValueError("sharded kv heads need sharded q heads")
        return k, v
    n_local = q.shape[2]
    h0 = tp_rank() * n_local
    group = cfg.n_heads // cfg.n_kv_heads
    if n_local % group == 0:
        lo, n = h0 // group, n_local // group
        return (copy_to_model(k).narrow(2, lo, n), copy_to_model(v).narrow(2, lo, n))
    idx = torch.arange(h0, h0 + n_local, device=k.device) // group
    return copy_to_model(k)[:, :, idx], copy_to_model(v)[:, :, idx]


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
    k, v = kv_for_heads(q, k, v, cfg)
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
    return _out_proj(p, o, cfg)


def _out_proj(p: Params, o: torch.Tensor, cfg) -> torch.Tensor:
    """(B,S,heads,hd) → (B,S,D) through ``wo``, row-parallel (replicated out)."""
    return row_parallel(o.reshape(*o.shape[:2], -1), p["wo"].to(o.dtype),
                        cfg.n_heads * cfg.resolved_head_dim, "attn/wo")


def cached_heads(t: torch.Tensor, cfg) -> torch.Tensor:
    """A cache's keys or values (…, K', hd), marked as the 'model' shard of
    the kv heads where they hold fewer than all (``kv_cache_spec`` puts them
    there when the axis divides them), replicated otherwise."""
    if tp_mesh() is None:
        return t
    n, k = t.shape[-2], cfg.n_kv_heads
    if n == k:
        return on_model(t, None)
    if not tp_splits(k) or n * tp_size() != k:
        raise ValueError(f"a cache of {n} kv heads of {k} on a model axis of {tp_size()}")
    return on_model(t, -2)


def decode_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid: torch.Tensor,
                  cfg, seq: tuple[str, ...] = ()) -> torch.Tensor:
    """One decode step's attention: q (B,1,H',hd) against the rank's cache
    slots k, v (B,T',K',hd) where ``valid`` (T',) holds; ``seq`` names the
    mesh axes the cache's T is cut over (module docstring)."""
    mask = valid[None, None, None, None, :]
    if cut_of(seq)[1] == 1:
        k, v = kv_for_heads(q, k, v, cfg)
        return dense_attention(q, k, v, mask)
    if "model" in seq and model_dim(q) is not None:
        q = gather_from_model(q, 2)            # every head scores the rank's slots
    k, v = kv_for_heads(q, k, v, cfg)
    B, S, H, hd = q.shape
    K = k.shape[2]
    s = _gqa_scores(q.reshape(B, S, K, H // K, hd), k, 1.0 / math.sqrt(hd))
    s = torch.where(mask, s, NEG_INF)                        # (B,K,G,S,T')
    m = over_decode_axes(s.amax(-1, keepdim=True), "max", seq)
    pexp = torch.exp(s - m)
    both = torch.cat([_gqa_accum(pexp, v), pexp.sum(-1)[..., None]], dim=-1)
    both = over_decode_axes(both, "sum", seq)                # (B,K,G,S,hd+1)
    o = both[..., :hd] / torch.clamp_min(both[..., hd:], 1e-30)
    return on_model(o.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype), model_dim(q))


def cross_attention(p: Params, x: torch.Tensor,
                    vis_kv: tuple[torch.Tensor, torch.Tensor], cfg) -> torch.Tensor:
    """Cross-attention to precomputed vision K/V (B,Nv,K,hd); tanh-gated
    (tensor-parallel as self-attention; the gate applies after the sum)."""
    hd = cfg.resolved_head_dim
    q, = column_parallel(x, (p["wq"].to(x.dtype), cfg.n_heads * hd, "attn/wq"))
    q = _head_norm(p["q_norm"], _heads(q, None, cfg.n_heads, hd), cfg.norm_eps)
    k, v = kv_for_heads(q, *vis_kv, cfg)
    o = _out_proj(p, dense_attention(q, k, v, None), cfg)
    return torch.tanh(p["gate_attn"].float()).to(x.dtype) * o


def vision_kv(p: Params, vis_embed: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """Project vision embeddings to K/V once (shared across decode steps)."""
    hd = cfg.resolved_head_dim
    cols = cfg.n_kv_heads * hd
    dt = vis_embed.dtype
    k, v = column_parallel(vis_embed, (p["wk"].to(dt), cols, "attn/wk"),
                           (p["wv"].to(dt), cols, "attn/wv"))
    k = _heads(k, None, cfg.n_kv_heads, hd)
    v = _heads(v, None, cfg.n_kv_heads, hd)
    return _head_norm(p["k_norm"], k, cfg.norm_eps), v


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
