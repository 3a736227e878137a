"""Decoder backbone covering all six architecture families (port of
``repro.models.transformer``; ROADMAP item 18b).

Parameters keep the reference's tree: every block leaf is stacked over
layers, so ``convert.lm_params_from_arrays`` carries a JAX tree across
unchanged.  Where the reference scans the stack (``_scan_layers``), the
port runs a Python loop over the stacked leaves.

  dense / moe / audio : one loop over n_layers
  ssm (mamba2)        : one loop, no attention, no MLP (d_ff=0)
  hybrid (hymba)      : global-attention layers between runs of
                        sliding-window layers
  vlm (llama-vision)  : a loop over periods of (self layers + 1 cross layer)

Decode writes each layer's cache slot in place: the cache passed to
:func:`decode_step` is consumed, and the cache it returns holds the same
tensors.  Nothing restacks the cache (the reference rides it in the scan
carry for buffer donation, ``transformer.py:385-390``).

``unroll`` is kept for signature parity: the loop is always unrolled.
``remat`` maps the reference's policies (``_maybe_remat``,
``transformer.py:35-40,176-180``) onto each block call of :func:`forward`
when autograd records it: ``"none"`` saves every activation, ``"full"``
(``nothing_saveable``) checkpoints the block and recomputes it in the
backward, ``"dots"`` (``dots_with_no_batch_dims_saveable``) checkpoints it
but saves the outputs of the contractions with no batch dimensions, the
``aten.mm`` / ``aten.addmm`` a 3-D activation times a 2-D weight folds to,
and recomputes everything else (``bmm`` and batched einsums included).  A
recomputed block runs the same kernels on the same inputs, so the loss and
the gradients are bit-equal under all three.  Under remat a block's
'model' collectives (tensor-parallel, ROADMAP item 19a) run again in the
backward's recompute, in the same order on every rank: every rank records
the same graph.

On the tensor-parallel decode plan (ROADMAP item 19b, ``launch.specs``)
:func:`decode_step` runs on the rank's batch rows against its cache shard
(``sharding.use_decode_layout``): each attention layer writes its slot where
the rank's shard of T holds it (``_attn_decode``), and an MoE layer routes
the whole batch as one group, as on one rank (the rows all-gathered over the
batch axes, the rank's rows kept).

The reference's ``constrain`` sites (``transformer.py:138,151,157,264``)
are kept: the residual stream replicated over 'model' at each block (each
row-parallel product's sum was taken where it was made), the logits left
vocab-sharded for the loss.  Outside the train step's tensor-parallel
context they are identities.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.distributed.sharding import (constrain, cut_of, decode_batch_rows, decode_seq,
                                              gather_decode_batch)
from repro_torch.models import attention as attn
from repro_torch.models import kvcache as kvc
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (apply_mlp, apply_norm, cdtype, embed, init_device,
                                       init_embedding, init_mlp, init_norm,
                                       sinusoidal_positions, unembed)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Params = dict[str, Any]

REMAT_POLICIES = ("none", "full", "dots")


# the contractions with no batch dimensions, which "dots" saves
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _check_remat(policy: str | None) -> None:
    if policy is not None and policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; have {REMAT_POLICIES}")


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn: Callable, policy: str | None) -> Callable:
    """``fn`` (one block) under the ``remat`` policy, when autograd records
    it (grad mode on and an input that requires grad)."""
    if policy is None or policy == "none":
        return fn
    kw = {} if policy == "full" else {
        "context_fn": lambda: create_selective_checkpoint_contexts(_dots_policy)}

    def remat(*args):
        if not (torch.is_grad_enabled() and any(
                isinstance(t, torch.Tensor) and t.requires_grad for t in tree_leaves(args))):
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return remat


def _layer(stacked: Params, i: int) -> Params:
    """Layer ``i`` of a stacked tree (views, no copy)."""
    return tree_map(lambda a: a[i], stacked)


def _layers(stacked: Params) -> list[Params]:
    """Every layer of a stacked tree (views, no copy).  One ``unbind`` a
    leaf, so the backward stacks each leaf's gradient once (``a[i]`` for
    each layer would write a zero-filled stacked gradient per layer)."""
    leaves = tree_leaves(stacked)
    per_leaf = [a.unbind(0) for a in leaves]
    return [tree_unflatten(stacked, [u[i] for u in per_leaf])
            for i in range(leaves[0].shape[0])]


def _n_stacked(stacked: Params) -> int:
    return tree_leaves(stacked)[0].shape[0]


def _stack(trees: list) -> Params:
    return tree_unflatten(trees[0], [torch.stack(leaves)
                                     for leaves in zip(*map(tree_leaves, trees))])


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_block(gen, cfg, *, cross: bool = False, device: torch.device) -> Params:
    p: Params = {"norm1": init_norm(cfg, cfg.d_model, device=device)}
    if cfg.family == "ssm":
        p["ssm"] = ssm_mod.init_ssm(gen, cfg, device=device)
        return p
    p["attn"] = attn.init_attention(gen, cfg, cross=cross, device=device)
    if cfg.family == "hybrid":
        p["ssm"] = ssm_mod.init_ssm(gen, cfg, device=device)
        p["norm_attn"] = init_norm(cfg, cfg.d_model, device=device)
        p["norm_ssm"] = init_norm(cfg, cfg.d_model, device=device)
    p["norm2"] = init_norm(cfg, cfg.d_model, device=device)
    if cfg.is_moe and not cross:
        p["moe"] = moe_mod.init_moe(gen, cfg, device=device)
    else:
        p["mlp"] = init_mlp(gen, cfg, cfg.d_model, cfg.d_ff, device=device)
    return p


def _stack_init(gen, cfg, n: int, *, device: torch.device) -> Params:
    """``n`` blocks, each leaf stacked over them (leading axis ``n``, 0 too)."""
    if n == 0:
        proto = _init_block(None, cfg, device=torch.device("meta"))
        return tree_map(lambda a: torch.empty((0, *a.shape), dtype=a.dtype, device=device),
                        proto)
    return _stack([_init_block(gen, cfg, device=device) for _ in range(n)])


def hymba_layer_groups(cfg) -> tuple[list[int], list[list[int]]]:
    """Global layer ids + the sliding-window runs between them."""
    glb = sorted(cfg.global_layers)
    runs, prev = [], 0
    for g in glb + [cfg.n_layers]:
        runs.append(list(range(prev, g)))
        prev = g + 1
    return glb, runs


def init_model(gen: torch.Generator | None, cfg, *,
               device: str | torch.device = "cuda") -> Params:
    """The parameter tree, drawn from ``gen`` (on its device, then moved to
    ``device``).  ``device="meta"`` gives the tree of shapes and dtypes alone
    (``gen`` may be None): the port's ``jax.eval_shape(init_model)``."""
    dev = init_device(device)
    params: Params = {"embed": init_embedding(gen, cfg, device=dev),
                      "final_norm": init_norm(cfg, cfg.d_model, device=dev)}
    if cfg.family == "vlm":
        n_cross = len(cfg.cross_attn_layers)
        period = cfg.n_layers // n_cross
        params["periods"] = _stack([
            {"self": _stack_init(gen, cfg, period - 1, device=dev),
             "cross": _init_block(gen, cfg, cross=True, device=dev)}
            for _ in range(n_cross)])
    elif cfg.family == "hybrid":
        glb, _ = hymba_layer_groups(cfg)
        params["global_blocks"] = _stack_init(gen, cfg, len(glb), device=dev)
        params["swa_blocks"] = _stack_init(gen, cfg, cfg.n_layers - len(glb), device=dev)
    else:
        params["blocks"] = _stack_init(gen, cfg, cfg.n_layers, device=dev)
    return params


# ---------------------------------------------------------------------------
# Train / prefill forward
# ---------------------------------------------------------------------------

_REPLICATED = ("batch", None, None)


def _dense_block_train(bp: Params, x: torch.Tensor, cfg, positions, window: int):
    x = constrain(x, _REPLICATED)
    h = apply_norm(bp["norm1"], x, cfg)
    x = x + attn.self_attention_train(bp["attn"], h, cfg, positions=positions,
                                      window=window)
    h = apply_norm(bp["norm2"], x, cfg)
    if "moe" in bp:
        m, losses = moe_mod.apply_moe(bp["moe"], h, cfg)
    else:
        m, losses = apply_mlp(bp["mlp"], h, cfg), {}
    return x + m, losses


def _ssm_block_train(bp: Params, x: torch.Tensor, cfg):
    x = constrain(x, _REPLICATED)
    h = apply_norm(bp["norm1"], x, cfg)
    return x + ssm_mod.apply_ssm_train(bp["ssm"], h, cfg)


def _hybrid_block_train(bp: Params, x: torch.Tensor, cfg, positions, window: int):
    x = constrain(x, _REPLICATED)
    h = apply_norm(bp["norm1"], x, cfg)
    a = attn.self_attention_train(bp["attn"], h, cfg, positions=positions, window=window)
    s = ssm_mod.apply_ssm_train(bp["ssm"], h, cfg)
    x = x + 0.5 * (apply_norm(bp["norm_attn"], a, cfg) + apply_norm(bp["norm_ssm"], s, cfg))
    h = apply_norm(bp["norm2"], x, cfg)
    return x + apply_mlp(bp["mlp"], h, cfg)


def _cross_block_train(bp: Params, x: torch.Tensor, cfg, vis_embed):
    x = constrain(x, _REPLICATED)
    h = apply_norm(bp["norm1"], x, cfg)
    kv = attn.vision_kv(bp["attn"], vis_embed, cfg)
    x = x + attn.cross_attention(bp["attn"], h, kv, cfg)
    h = apply_norm(bp["norm2"], x, cfg)
    return x + apply_mlp(bp["mlp"], h, cfg)


def forward(params: Params, cfg, *, tokens: torch.Tensor | None = None,
            embeds: torch.Tensor | None = None,
            vis_embed: torch.Tensor | None = None,
            remat: str = "full",
            last_logits_only: bool = False,
            unroll: bool = False) -> tuple[torch.Tensor, dict]:
    """Training/prefill forward pass → (logits (B,S,V), aux-loss dict).

    ``last_logits_only`` unembeds just the final position (B,1,V) — the
    serving-prefill path, which never materialises the (B,S,V) tensor.
    """
    _check_remat(remat)
    if embeds is not None:
        x = embeds.to(cdtype(cfg))
        B, S = x.shape[:2]
    else:
        B, S = tokens.shape
        x = embed(params["embed"], tokens, cfg)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    if cfg.pos_embedding == "sinusoidal":
        x = x + sinusoidal_positions(positions, cfg.d_model).to(x.dtype)

    aux = {"moe_aux": torch.zeros((), dtype=torch.float32, device=x.device),
           "moe_z": torch.zeros((), dtype=torch.float32, device=x.device)}

    if cfg.family == "ssm":
        body = _maybe_remat(lambda bp, c: _ssm_block_train(bp, c, cfg), remat)
        for bp in _layers(params["blocks"]):
            x = body(bp, x)
    elif cfg.family == "hybrid":
        glb, runs = hymba_layer_groups(cfg)
        swa_body = _maybe_remat(lambda bp, c: _hybrid_block_train(bp, c, cfg, positions,
                                                                  cfg.attn_window), remat)
        g_body = _maybe_remat(lambda bp, c: _hybrid_block_train(bp, c, cfg, positions, 0),
                              remat)
        swa, global_blocks = _layers(params["swa_blocks"]), _layers(params["global_blocks"])
        offset = 0
        for gi, run in enumerate(runs):
            for j in range(len(run)):
                x = swa_body(swa[offset + j], x)
            offset += len(run)
            if gi < len(glb):
                x = g_body(global_blocks[gi], x)
    elif cfg.family == "vlm":
        self_body = _maybe_remat(lambda bp, c: _dense_block_train(bp, c, cfg, positions, 0)[0],
                                 remat)
        cross_body = _maybe_remat(lambda bp, c: _cross_block_train(bp, c, cfg, vis_embed),
                                  remat)
        for pp in _layers(params["periods"]):
            for bp in _layers(pp["self"]):
                x = self_body(bp, x)
            x = cross_body(pp["cross"], x)
    else:  # dense / moe / audio
        body = _maybe_remat(lambda bp, c: _dense_block_train(bp, c, cfg, positions,
                                                             cfg.attn_window), remat)
        for bp in _layers(params["blocks"]):
            x, losses = body(bp, x)
            aux["moe_aux"] = aux["moe_aux"] + losses.get("moe_aux", 0.0)
            aux["moe_z"] = aux["moe_z"] + losses.get("moe_z", 0.0)

    x = apply_norm(params["final_norm"], x, cfg)
    if last_logits_only:
        x = x[:, -1:]
    return constrain(unembed(params["embed"], x, cfg), ("batch", None, "tp")), aux


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

class DecodeCache(NamedTuple):
    """Family-polymorphic cache bundle (unused fields are None)."""
    kv: kvc.KVCache | None = None              # self-attn (stacked over layers)
    global_kv: kvc.KVCache | None = None       # hybrid global layers
    ssm: ssm_mod.SSMCache | None = None        # stacked over layers
    cross_k: torch.Tensor | None = None        # vlm (n_cross, B, Nv, K, hd)
    cross_v: torch.Tensor | None = None


def _stacked_ssm_cache(cfg, batch: int, device) -> ssm_mod.SSMCache:
    c = ssm_mod.init_ssm_cache(cfg, batch, device=device)
    return ssm_mod.SSMCache(*(a.new_zeros((cfg.n_layers, *a.shape)) for a in c))


def init_decode_cache(cfg, batch: int, max_t: int, kv_dtype: torch.dtype = torch.bfloat16,
                      *, device: str | torch.device = "cuda") -> DecodeCache:
    dev = init_device(device)
    hd = cfg.resolved_head_dim if cfg.n_heads else 0
    if cfg.family == "ssm":
        return DecodeCache(ssm=_stacked_ssm_cache(cfg, batch, dev))
    if cfg.family == "hybrid":
        glb, _ = hymba_layer_groups(cfg)
        w = min(cfg.attn_window, max_t)
        swa_kv = kvc.init_kv_cache(cfg.n_layers - len(glb), batch, w, cfg.n_kv_heads, hd,
                                   kv_dtype, device=dev)
        g_kv = kvc.init_kv_cache(len(glb), batch, max_t, cfg.n_kv_heads, hd, kv_dtype,
                                 device=dev)
        return DecodeCache(kv=swa_kv, global_kv=g_kv, ssm=_stacked_ssm_cache(cfg, batch, dev))
    if cfg.family == "vlm":
        # cross layers keep no self-KV; the cache covers the self layers only
        n_self = cfg.n_layers - len(cfg.cross_attn_layers)
        return DecodeCache(kv=kvc.init_kv_cache(n_self, batch, max_t, cfg.n_kv_heads, hd,
                                                kv_dtype, device=dev))
    return DecodeCache(kv=kvc.init_kv_cache(cfg.n_layers, batch, max_t, cfg.n_kv_heads, hd,
                                            kv_dtype, device=dev))


def _kv_layer(kv: kvc.KVCache, i: int) -> tuple:
    """Layer ``i``'s (k, v, k_scale, v_scale) as views into the stacked cache."""
    return (kv.k[i], kv.v[i], None if kv.k_scale is None else kv.k_scale[i],
            None if kv.v_scale is None else kv.v_scale[i])


def _attn_decode(bp: Params, h: torch.Tensor, kv_slice, pos: int, cfg, *,
                 window: int = 0, seq: tuple[str, ...] = ()) -> torch.Tensor:
    """Project, write (in place) and attend for one layer; kv_slice =
    (k, v, ks, vs), each (B,T,...): the whole cache, or on the
    tensor-parallel decode plan the rank's shard, its T cut over the mesh
    axes ``seq`` (``attention.decode_attend``).  The global slot (``pos``,
    mod T for a ring, clamped past the end of a linear cache) is written by
    the rank whose T slice holds it."""
    k_c, v_c, ks_c, vs_c = kv_slice
    B = h.shape[0]
    t_idx, n_t = cut_of(seq)
    T_l = k_c.shape[1]
    T, t0 = T_l * n_t, t_idx * T_l
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=h.device)
    q, k_new, v_new = attn.project_qkv(bp["attn"], h, h, cfg, positions=positions,
                                       rope=cfg.pos_embedding == "rope")
    if k_new.shape[2] != k_c.shape[2]:
        raise ValueError(f"decode: {k_new.shape[2]} new kv heads for a cache of "
                         f"{k_c.shape[2]}")
    slot = kvc.clamped_start(pos % T if window > 0 else pos, 1, T)
    if t0 <= slot < t0 + T_l:
        kvc.cache_write(k_c, v_c, ks_c, vs_c, k_new, v_new, slot - t0)
    k_full, v_full = kvc.cache_read(k_c, v_c, ks_c, vs_c, h.dtype)
    idx = torch.arange(t0, t0 + T_l, device=h.device)
    valid = (idx < min(pos + 1, T)) if window > 0 else (idx <= pos)
    o = attn.decode_attend(q, attn.cached_heads(k_full, cfg), attn.cached_heads(v_full, cfg),
                           valid, cfg, seq)
    return attn._out_proj(bp["attn"], o, cfg)


def _ssm_decode(bp: Params, h: torch.Tensor, cache: ssm_mod.SSMCache, i: int, cfg):
    """Layer ``i``'s SSM step; its conv and state slots written in place."""
    y, sc = ssm_mod.apply_ssm_decode(bp["ssm"], h,
                                     ssm_mod.SSMCache(cache.conv[i], cache.state[i]), cfg)
    cache.conv[i] = sc.conv
    cache.state[i] = sc.state
    return y


def decode_step(params: Params, cfg, cache: DecodeCache, pos: int | torch.Tensor,
                tokens: torch.Tensor | None = None,
                embeds: torch.Tensor | None = None,
                vis_embed: torch.Tensor | None = None,
                unroll: bool = False) -> tuple[torch.Tensor, DecodeCache]:
    """One-token decode → (logits (B,1,V), cache').

    ``cache`` is consumed: each layer's slot is written in place, and the
    returned cache holds the same tensors (a VLM cache gains the cross K/V
    on its first step).  ``pos`` is read on the host once per step."""
    pos = int(pos)
    if embeds is not None:
        x = embeds.to(cdtype(cfg))
    else:
        x = embed(params["embed"], tokens, cfg)
    B = x.shape[0]
    if cfg.pos_embedding == "sinusoidal":
        ppos = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        x = x + sinusoidal_positions(ppos, cfg.d_model).to(x.dtype)

    if cfg.family == "ssm":
        for i in range(cfg.n_layers):
            bp = _layer(params["blocks"], i)
            x = x + _ssm_decode(bp, apply_norm(bp["norm1"], x, cfg), cache.ssm, i, cfg)
    elif cfg.family == "hybrid":
        x = _hybrid_decode(params, cfg, cache, pos, x)
    elif cfg.family == "vlm":
        x, cache = _vlm_decode(params, cfg, cache, pos, x, vis_embed)
    else:
        seq = decode_seq("kv")
        for i in range(cfg.n_layers):
            bp = _layer(params["blocks"], i)
            h = apply_norm(bp["norm1"], x, cfg)
            x = x + _attn_decode(bp, h, _kv_layer(cache.kv, i), pos, cfg,
                                 window=cfg.attn_window, seq=seq)
            h = apply_norm(bp["norm2"], x, cfg)
            if "moe" in bp:
                # the batch is one routing group: on the decode plan each
                # rank routes the whole batch and keeps its rows
                hb = gather_decode_batch(h)
                m, _ = moe_mod.apply_moe(bp["moe"], hb.reshape(1, hb.shape[0], -1), cfg)
                m = decode_batch_rows(m.reshape(hb.shape[0], 1, -1))
            else:
                m = apply_mlp(bp["mlp"], h, cfg)
            x = x + m

    x = apply_norm(params["final_norm"], x, cfg)
    return unembed(params["embed"], x, cfg), cache


def _hybrid_decode(params, cfg, cache: DecodeCache, pos: int, x):
    """The hybrid stack's decode.  The sliding-window layers keep ring
    caches of ``min(attn_window, max_t)`` slots, the global layers linear
    ones; the SSM caches are stacked over all layers.  A degenerate layer
    mix (no global layers, or no window layers: the reference's
    ``transformer.py:486-502``) leaves that side's cache (with a zero
    leading axis) untouched."""
    glb, runs = hymba_layer_groups(cfg)

    def layer(bp, x, kv_slice, ssm_i, window, seq):
        h = apply_norm(bp["norm1"], x, cfg)
        a = _attn_decode(bp, h, kv_slice, pos, cfg, window=window, seq=seq)
        s = _ssm_decode(bp, h, cache.ssm, ssm_i, cfg)
        x = x + 0.5 * (apply_norm(bp["norm_attn"], a, cfg) + apply_norm(bp["norm_ssm"], s, cfg))
        return x + apply_mlp(bp["mlp"], apply_norm(bp["norm2"], x, cfg), cfg)

    offset = 0
    for gi, run in enumerate(runs):
        for j, layer_id in enumerate(run):
            x = layer(_layer(params["swa_blocks"], offset + j), x,
                      _kv_layer(cache.kv, offset + j), layer_id, cfg.attn_window,
                      decode_seq("kv"))
        offset += len(run)
        if gi < len(glb):
            x = layer(_layer(params["global_blocks"], gi), x, _kv_layer(cache.global_kv, gi),
                      glb[gi], 0, decode_seq("global_kv"))
    return x


def precompute_cross_kv(params, cfg, vis_embed):
    """(n_cross, B, Nv, K, hd) K/V from the vision stub, once per request."""
    periods = params["periods"]
    kvs = [attn.vision_kv(_layer(periods, pi)["cross"]["attn"], vis_embed, cfg)
           for pi in range(_n_stacked(periods))]
    return torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs])


def _vlm_decode(params, cfg, cache: DecodeCache, pos: int, x, vis_embed):
    if cache.cross_k is None:
        cross_k, cross_v = precompute_cross_kv(params, cfg, vis_embed)
        cache = cache._replace(cross_k=cross_k, cross_v=cross_v)
    periods = params["periods"]
    n_self = 0
    for pi in range(_n_stacked(periods)):
        pp = _layer(periods, pi)
        for j in range(_n_stacked(pp["self"])):
            bp = _layer(pp["self"], j)
            h = apply_norm(bp["norm1"], x, cfg)
            x = x + _attn_decode(bp, h, _kv_layer(cache.kv, n_self), pos, cfg, window=0,
                                 seq=decode_seq("kv"))
            x = x + apply_mlp(bp["mlp"], apply_norm(bp["norm2"], x, cfg), cfg)
            n_self += 1
        # cross block (static K/V, no cache update)
        bp = pp["cross"]
        h = apply_norm(bp["norm1"], x, cfg)
        x = x + attn.cross_attention(bp["attn"], h, (attn.cached_heads(cache.cross_k[pi], cfg),
                                                     attn.cached_heads(cache.cross_v[pi], cfg)),
                                     cfg)
        x = x + apply_mlp(bp["mlp"], apply_norm(bp["norm2"], x, cfg), cfg)
    return x, cache
