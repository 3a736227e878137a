"""Abstract stand-ins and placements for every dry-run cell (port of
``repro.launch.specs``).

``input_specs(cfg, shape)`` builds the inputs of one (architecture × input
shape) cell as meta tensors (shapes and dtypes, no storage: the port's
``ShapeDtypeStruct``), and :func:`plan_cell` pairs them with their
placements and the function the cell runs:

  * train_*    → ``train.make_train_step(mesh=...)``      (params, opt, batch)
  * prefill_*  → last-token-logits forward              (params, batch)
  * decode_* / long_* → ``transformer.decode_step``     (params, cache,
                        tokens, pos)

The placements are the reference's (``param_shardings``,
``decode_cache_shardings``, the batch over ``batch_axes``).  Under the
``fsdp`` and ``replicated`` profiles every plan computes tensor-parallel over
'model' (``"parallelism": "tensor-parallel"``): the train step as
``train.train_step`` describes (ROADMAP item 19a), and the prefill and
decode functions (item 19b) on the rank's shard of the batch, with each
weight gathered over the fsdp axis only (``gather_fsdp_tree``) inside
``use_tensor_parallel``.  The prefill's vocab-sharded last-token logits
(B/data, 1, V/model) are all-gathered over 'model' at the end.  The decode
function gathers no cache and no token batch: each rank decodes its batch
rows against its cache shard as ``decode_cache_shardings`` places it (kv
heads on 'model', or the context T on 'model', and on 'data' too with one
sequence, ``sharding.use_decode_layout``), writes the new slot where its
shard holds it, and returns the cache in its input placements.  Under
``dp`` and ``dp_zero3``, where 'model' carries batch, the prefill and
decode functions gather every weight whole (``"gather-on-use"``), the
decode function also the cache and the token batch, and cut the new cache
back to its placements.  The VLM cell feeds precomputed patch embeddings
``vis_embed``; musicgen's tokenizer is stubbed by the token stream itself.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.distributed.sharding import (DecodeLayout, NamedSharding, P, batch_axes,
                                              decode_cache_shardings, distribute_like,
                                              gather_fsdp_tree, gather_from_model, gather_tree,
                                              local_shard, map_with_path, mesh_shape,
                                              model_dim, param_shardings, placements_for,
                                              shard_axes, use_decode_layout, use_mesh,
                                              use_sharding_profile, use_tensor_parallel)
from repro_torch.models import transformer
from repro_torch.train.optimizer import OptimizerConfig, OptState, init_opt_state
from repro_torch.train.train_step import TrainConfig, make_train_step
from repro_torch.tree import tree_map


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# Abstract model/optimizer state
# ---------------------------------------------------------------------------

def abstract_params(cfg):
    return transformer.init_model(None, cfg, device="meta")


def abstract_opt_state(cfg):
    return init_opt_state(abstract_params(cfg))


def abstract_cache(cfg, shape: ShapeSpec, kv_dtype="bfloat16"):
    dt = torch.int8 if kv_dtype == "int8" else torch.bfloat16
    return transformer.init_decode_cache(cfg, shape.global_batch, shape.seq_len, kv_dtype=dt,
                                         device="meta")


# ---------------------------------------------------------------------------
# Batch specs
# ---------------------------------------------------------------------------

def train_batch_specs(cfg, shape: ShapeSpec) -> dict:
    B, S = shape.global_batch, shape.seq_len
    batch = {"tokens": _sds((B, S), torch.int32), "labels": _sds((B, S), torch.int32)}
    if cfg.family == "vlm":
        batch["vis_embed"] = _sds((B, cfg.n_vis_tokens, cfg.vis_dim), torch.bfloat16)
    return batch


def decode_inputs(cfg, shape: ShapeSpec, kv_dtype="bfloat16") -> dict:
    B = shape.global_batch
    inputs = {"cache": abstract_cache(cfg, shape, kv_dtype),
              "tokens": _sds((B, 1), torch.int32),
              "pos": _sds((), torch.int32)}
    if cfg.family == "vlm":
        # cross K/V are precomputed at prefill; pass them via the cache
        hd = cfg.resolved_head_dim
        n_cross = len(cfg.cross_attn_layers)
        cross = _sds((n_cross, B, cfg.n_vis_tokens, cfg.n_kv_heads, hd), torch.bfloat16)
        inputs["cache"] = inputs["cache"]._replace(cross_k=cross, cross_v=cross)
    return inputs


def input_specs(cfg, shape: ShapeSpec, kv_dtype="bfloat16") -> dict:
    """All abstract inputs for one dry-run cell (excluding model state)."""
    if shape.kind in ("train", "prefill"):
        return train_batch_specs(cfg, shape)
    return decode_inputs(cfg, shape, kv_dtype)


# ---------------------------------------------------------------------------
# Step + placements per cell
# ---------------------------------------------------------------------------

def _batch_shardings(mesh, batch: dict) -> dict:
    ax = batch_axes(mesh)
    return tree_map(lambda x: NamedSharding(mesh, P(ax, *([None] * (x.dim() - 1)))), batch)


@dataclasses.dataclass
class CellPlan:
    """Everything needed to run one (arch × shape × mesh) cell."""
    fn: Callable                  # the step function
    args: tuple                   # abstract args (meta-tensor trees)
    in_shardings: tuple           # NamedSharding trees (None: not placed)
    out_shardings: Any            # None → whatever the function returns
    donate: tuple = ()
    parallelism: str = "gather-on-use"


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def tensor_parallel(profile: str) -> bool:
    """Whether a plan under ``profile`` computes tensor-parallel over 'model'."""
    return profile in ("fsdp", "replicated")


@contextlib.contextmanager
def _tensor_parallel(mesh, on: bool):
    """``use_tensor_parallel`` on ``mesh`` (with it as the current mesh)
    where ``on``, else nothing."""
    if not on:
        yield
        return
    with use_mesh(mesh), use_tensor_parallel(mesh):
        yield


def _vocab_whole(logits):
    """Vocab-sharded logits all-gathered over 'model' (small: one position)."""
    return gather_from_model(logits, -1) if model_dim(logits) is not None else logits


def make_prefill_fn(cfg, train_cfg: TrainConfig = TrainConfig(), mesh=None):
    """The prefill's ``(params, batch) → last-token logits`` of the rank's
    batch rows; with a ``mesh`` under ``fsdp`` or ``replicated``,
    tensor-parallel over 'model' (module docstring)."""
    profile = train_cfg.sharding_profile
    tp = mesh is not None and tensor_parallel(profile)

    def step(params, batch):
        kw = {}
        if cfg.family == "vlm":
            kw["vis_embed"] = _local(batch["vis_embed"])
        with torch.no_grad(), use_sharding_profile(profile), _tensor_parallel(mesh, tp):
            logits, _ = transformer.forward(gather_fsdp_tree(params) if tp else gather_tree(params),
                                            cfg, tokens=_local(batch["tokens"]),
                                            remat=train_cfg.remat, last_logits_only=True,
                                            unroll=train_cfg.unroll, **kw)
            return _vocab_whole(logits)
    return step


def _gathered(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def _placed_like(old, new):
    if isinstance(old, DTensor):
        return distribute_like(new, old.device_mesh, old.placements)
    return new


def decode_layout_of(cache, mesh) -> DecodeLayout:
    """Where a placed ``DecodeCache``'s batch (dim 1 of every leaf) and each
    self-attention cache's T (dim 2) lie on ``mesh``."""
    leaves: list = []
    map_with_path(lambda _, x: leaves.append(x), cache)
    seq = {f: shard_axes(getattr(cache, f).k, 2) for f in ("kv", "global_kv")
           if getattr(cache, f) is not None}
    return DecodeLayout(mesh=mesh, batch=shard_axes(leaves[0], 1), seq=seq)


def _batch_rows(x, axes: tuple, mesh):
    """This rank's rows of the token batch ``x`` cut over ``axes``: its
    local shard where ``x`` is placed so, else cut from a replicated ``x``
    (no communication either way)."""
    have = shard_axes(x, 0)
    if have == axes:
        return _local(x)
    if have:
        raise ValueError(f"tokens cut over {have}, the cache's batch over {axes}")
    spec = P(axes if axes else None, *([None] * (x.dim() - 1)))
    return local_shard(_local(x), placements_for(spec, mesh), mesh)


def make_decode_fn(cfg, mesh, train_cfg: TrainConfig = TrainConfig()):
    """The decode's ``(params, cache, tokens, pos) → (logits of the rank's
    batch rows, cache')`` on ``mesh``: tensor-parallel under ``fsdp`` and
    ``replicated``, each rank on its batch rows and cache shard, the cache
    written in place and returned in its placements; gather-on-use under
    ``dp`` and ``dp_zero3`` (module docstring)."""
    profile = train_cfg.sharding_profile

    def gathered(params, cache, tokens, pos):
        olds: dict = {}
        map_with_path(olds.__setitem__, cache)
        logits, new = transformer.decode_step(gather_tree(params), cfg, gather_tree(cache), pos,
                                              tokens=_gathered(tokens),
                                              unroll=train_cfg.unroll)
        return logits, map_with_path(lambda path, x: _placed_like(olds[path], x), new)

    def sharded(params, cache, tokens, pos):
        if cfg.family == "vlm" and cache.cross_k is None:
            raise ValueError("the decode plan takes a VLM cache with its cross K/V "
                             "(transformer.precompute_cross_kv)")
        layout = decode_layout_of(cache, mesh)
        olds: dict = {}
        map_with_path(olds.__setitem__, cache)
        local = map_with_path(lambda _, x: _local(x), cache)
        toks = _batch_rows(tokens, layout.batch, mesh)
        with _tensor_parallel(mesh, True), use_decode_layout(layout):
            logits, new = transformer.decode_step(gather_fsdp_tree(params), cfg, local, pos,
                                                  tokens=toks, unroll=train_cfg.unroll)
            logits = _vocab_whole(logits)
        return logits, map_with_path(
            lambda path, x: DTensor.from_local(x, mesh, olds[path].placements, run_check=False),
            new)

    def fn(params, cache, tokens, pos):
        with torch.no_grad(), use_sharding_profile(profile):
            step = sharded if tensor_parallel(profile) else gathered
            return step(params, cache, tokens, pos)
    return fn


def plan_cell(cfg, shape: ShapeSpec, mesh, *, opt_cfg: OptimizerConfig | None = None,
              train_cfg: TrainConfig = TrainConfig(), kv_dtype: str = "bfloat16") -> CellPlan:
    """Build the (fn, abstract args, placements) plan for one cell."""
    opt_cfg = opt_cfg or OptimizerConfig()
    params = abstract_params(cfg)
    profile = train_cfg.sharding_profile

    def profiled(fn):
        def wrapped(*a, **kw):
            with use_sharding_profile(profile):
                return fn(*a, **kw)
        return wrapped

    parallelism = "tensor-parallel" if tensor_parallel(profile) else "gather-on-use"
    with use_sharding_profile(profile):
        p_sh = param_shardings(cfg, params, mesh)

        if shape.kind == "train":
            batch = train_batch_specs(cfg, shape)
            opt_state = abstract_opt_state(cfg)
            o_sh = OptState(step=NamedSharding(mesh, P()), mu=p_sh, nu=p_sh)
            fn = make_train_step(cfg, opt_cfg, train_cfg, mesh=mesh)
            return CellPlan(fn=profiled(fn), args=(params, opt_state, batch),
                            in_shardings=(p_sh, o_sh, _batch_shardings(mesh, batch)),
                            out_shardings=(p_sh, o_sh, None), donate=(0, 1),
                            parallelism=parallelism)

        if shape.kind == "prefill":
            batch = train_batch_specs(cfg, shape)
            batch = {k: v for k, v in batch.items() if k != "labels"}   # inference
            return CellPlan(fn=profiled(make_prefill_fn(cfg, train_cfg, mesh)),
                            args=(params, batch),
                            in_shardings=(p_sh, _batch_shardings(mesh, batch)),
                            out_shardings=None, parallelism=parallelism)

        inputs = decode_inputs(cfg, shape, kv_dtype)
        cache = inputs["cache"]
        c_sh = decode_cache_shardings(cache, mesh)

        n_batch = 1
        for a in batch_axes(mesh):
            n_batch *= mesh_shape(mesh)[a]
        tok_sh = NamedSharding(mesh, P(batch_axes(mesh) if shape.global_batch % n_batch == 0
                                       else None, None))
        return CellPlan(fn=profiled(make_decode_fn(cfg, mesh, train_cfg)),
                        args=(params, cache, inputs["tokens"], shape.seq_len - 1),
                        in_shardings=(p_sh, c_sh, tok_sh, NamedSharding(mesh, P())),
                        out_shardings=(None, c_sh), donate=(1,), parallelism=parallelism)
