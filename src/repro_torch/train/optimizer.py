"""AdamW and the beyond-paper "ITP-AdamW" (port of ``repro.train.optimizer``).

ITP-AdamW snaps the per-parameter update to the nearest power of two,
sign·2^round(log2|u|): the ITP-STDP quantiser applied to gradient descent.
The quantiser runs through the po2 encode/decode kernels
(``kernels.po2_quant.ops.po2_quantize(use_kernel=True)``); ``use_kernel=False``
runs their plain versions instead, on the same device.

Trees are nested dicts (lists, tuples) of tensors, walked in the reference's
key order (:mod:`repro_torch.tree`).  Every step is float32 arithmetic, as
in the reference; ``step`` is an int32 scalar tensor.

Sharded state (ROADMAP item 18d) is a tree of DTensors: each update runs on
the rank's local shards, and :func:`global_norm` sums a leaf's squares over
the mesh axes it is sharded on only, so an element replicated over an axis
counts once, as in the reference's global arithmetic.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import reduce_over
from repro_torch.kernels.po2_quant.ops import po2_quantize
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    po2_update: bool = False       # ITP-AdamW: po2-quantised updates


class OptState(NamedTuple):
    step: torch.Tensor
    mu: Any        # first moment  (tree like params)
    nu: Any        # second moment


def init_opt_state(params) -> OptState:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device), mu=zeros,
                    nu=tree_map(torch.clone, zeros))


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to min_lr_ratio·lr."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _local(x):
    return x.to_local() if isinstance(x, DTensor) else x


def _like(x, local: torch.Tensor):
    """``local`` placed as ``x`` is (a DTensor shard, or ``local`` itself)."""
    if isinstance(x, DTensor):
        return DTensor.from_local(local, x.device_mesh, x.placements, run_check=False)
    return local


def _square_sum(x) -> torch.Tensor:
    s = torch.sum(torch.square(_local(x).to(torch.float32)))
    if isinstance(x, DTensor):       # each distinct element once
        names = x.device_mesh.mesh_dim_names
        s = reduce_over(s, x.device_mesh,
                        [names[i] for i, pl in enumerate(x.placements) if pl.is_shard()])
    return s


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(_square_sum(x) for x in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    # a true division, as the reference's (a Python scalar over a tensor would
    # take PyTorch's reciprocal-and-multiply)
    numer = torch.full_like(norm, max_norm)
    scale = torch.clamp(numer / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: _like(g, _local(g) * scale), tree), norm


def adamw_update(cfg: OptimizerConfig, params, grads, state: OptState, *,
                 use_kernel: bool = True):
    """Returns ``(new_params, new_state, metrics)``."""
    grads = tree_map(lambda g: _like(g, _local(g).to(torch.float32)), grads)
    if cfg.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        gnorm = global_norm(grads)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - torch.pow(b1, step.to(torch.float32))
    bc2 = 1 - torch.pow(b2, step.to(torch.float32))

    def upd(p_in, *gmv):
        p, g, m, v = _local(p_in), *(_local(x) for x in gmv)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * torch.square(g)
        mhat = m / bc1
        vhat = v / bc2
        u = mhat / (torch.sqrt(vhat) + cfg.eps)
        u = u + cfg.weight_decay * p.to(torch.float32)
        if cfg.po2_update:         # ITP quantiser: sign·2^round(log2|u|)
            u = po2_quantize(u, use_kernel=use_kernel)
        p_new = p.to(torch.float32) - lr * u
        return _like(p_in, p_new.to(p.dtype)), _like(p_in, m), _like(p_in, v)

    out = [upd(*leaves) for leaves in zip(tree_leaves(params), tree_leaves(grads),
                                          tree_leaves(state.mu), tree_leaves(state.nu))]
    new_p, new_m, new_v = (tree_unflatten(params, [o[i] for o in out]) for i in range(3))
    metrics = {"lr": lr, "grad_norm": gnorm}
    return new_p, OptState(step=step, mu=new_m, nu=new_v), metrics
