"""LM training step: loss, gradients, optimizer (port of
``repro.train.train_step``; ROADMAP item 18c).

The step is a function ``(params, opt_state, batch) → (params', opt_state',
metrics)`` over the port's functional trees (``models/transformer.py``'s
parameter tree, :class:`~repro_torch.train.optimizer.OptState`):
``make_train_step`` closes over the model, optimizer and training configs.
The gradient is ``torch.autograd.grad`` of :func:`lm_loss` over the leaves
of the float32 master tree (:func:`loss_and_grads`); AdamW, or ITP-AdamW
with ``po2_update``, then updates the tree (``train.optimizer.adamw_update``,
whose po2 quantiser is kernels 9-10 with ``use_kernel=True``).  The
gradient is taken under PyTorch's deterministic algorithms
(:func:`repro_torch.device.deterministic`): on CUDA the backwards of the
embedding and MoE gathers would otherwise add with atomics, and a restart
that replays steps must end where an uninterrupted run does, bit for bit.

With a mesh (ROADMAP item 18d: a ``torch.distributed`` DeviceMesh with the
reference's axis names ``('data','model')`` or ``('pod','data','model')``)
the state is a tree of DTensors placed by the reference's rules
(``distributed.sharding.param_spec_for``), and the step computes what
GSPMD computes for the reference's step, up to summation order:

  1. under the ``fsdp`` and ``replicated`` profiles (ROADMAP item 19a)
     each leaf is gathered over the fsdp axis only, keeping its 'model'
     shard (the SSM mixer's too since item 19b), and the loss runs
     tensor-parallel over 'model' (``sharding.use_tensor_parallel``): each
     'model' rank multiplies its own shards, and the logits stay
     vocab-sharded (the loss's log-sum-exp and gold logit are reduced over
     'model'; the (B, S, V) logits are never gathered); under ``dp`` and
     ``dp_zero3``, where 'model' carries batch, each leaf is gathered
     whole;
  2. :func:`loss_and_grads` runs on the rank's shard of the batch (over
     ``batch_axes(mesh)``), with the loss's batch reductions (the token
     count, the MoE balance means) taken over the batch ranks;
  3. the gradients are summed over the batch ranks onto each leaf's
     shard: tensor-parallel, a reduce-scatter over 'data' onto the fsdp
     dim (an all-reduce for a leaf not sharded over 'data'); under ``dp``
     and ``dp_zero3`` an all-reduce, then the cut;
  4. with a ``'pod'`` axis the gradients and metrics so far are pod-local
     (the reference's region manual over ``'pod'``), and the shards are
     averaged over the pods by ``compression.pod_mean_tree``:
     po2-compressed (kernels 9-10 on every leaf) or, with
     ``pod_compression=False``, a plain float32 mean; the metrics are
     averaged over the pods;
  5. AdamW runs on the local shards.

A leaf replicated over 'model' (norms, router, ``down_bias``) gets the
same gradient on every 'model' rank, bit for bit: the conjugate pair of
``distributed.sharding`` keeps every replicated activation's gradient
whole.  On a 1 × 1 mesh every collective is skipped and the step runs the
unsharded step's ops.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed import compression
from repro_torch.distributed.sharding import (NamedSharding, P, axis_names, batch_axes,
                                              batch_sum, distribute_tree, gather_fsdp_tree,
                                              gather_tree, local_shard,
                                              mesh_shape, model_dim, over_model,
                                              param_spec_tree, reduce_from_model,
                                              reduce_grad_to_shard, reduce_over, tp_rank,
                                              tp_size, use_batch_reduction, use_manual_axes,
                                              use_mesh, use_sharding_profile,
                                              use_tensor_parallel)
from repro_torch.device import deterministic
from repro_torch.models import transformer
from repro_torch.train.optimizer import OptimizerConfig, OptState, adamw_update, init_opt_state
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    remat: str = "full"              # none | full | dots
    z_loss: float = 1e-4
    pod_compression: bool = True     # po2 wire format across the pod axis
    unroll: bool = False             # unroll layer scans (measurement only)
    sharding_profile: str = "fsdp"   # fsdp | replicated (weights over data)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def lm_loss(params: Params, cfg, batch: dict, *, train_cfg: TrainConfig,
            vis_embed: torch.Tensor | None = None) -> tuple[torch.Tensor, dict]:
    """Next-token cross entropy (+ z-loss, + MoE aux) over a token batch.

    ``batch['labels'] == -1`` marks ignored positions.  Softmax statistics
    accumulate in float32 while the logits stay in the compute dtype, as
    the reference's do.
    """
    kw = {}
    if cfg.family == "vlm":
        kw["vis_embed"] = vis_embed if vis_embed is not None else batch.get("vis_embed")
    if "embeds" in batch:
        kw["embeds"] = batch["embeds"]
    else:
        kw["tokens"] = batch["tokens"]
    logits, aux = transformer.forward(params, cfg, remat=train_cfg.remat,
                                      unroll=train_cfg.unroll, **kw)
    labels = batch["labels"]
    mask = (labels >= 0).to(torch.float32)
    safe = torch.clamp(labels, min=0).long()
    if model_dim(logits) == logits.dim() - 1 and tp_size() > 1:   # vocab-sharded
        lse = _ShardedLogSumExp.apply(logits.float())
        gold = _sharded_gold(logits, safe)
    else:
        lse = torch.logsumexp(logits.float(), dim=-1)
        gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = lse - gold.float()
    # sums over the whole batch when it is sharded (shards hold different
    # token counts where labels are -1)
    n_tok = torch.clamp(batch_sum(torch.sum(mask)), min=1.0)
    ce = batch_sum(torch.sum(nll * mask)) / n_tok
    zl = train_cfg.z_loss * batch_sum(torch.sum((lse ** 2) * mask)) / n_tok
    loss = ce + zl + aux.get("moe_aux", 0.0) + aux.get("moe_z", 0.0)
    metrics = {"loss": loss, "ce": ce, "z_loss": zl,
               "moe_aux": aux.get("moe_aux", torch.zeros((), device=loss.device)),
               "tokens": n_tok}
    return loss, metrics


class _ShardedLogSumExp(torch.autograd.Function):
    """``logsumexp`` over the last dim of logits sharded over 'model' on it:
    the maxima and the sums of exponentials reduced over 'model' (the
    composition ``torch.logsumexp`` runs); the backward ``grad · exp(x −
    lse)`` on the rank's columns, as ``torch.logsumexp``'s."""

    @staticmethod
    def forward(ctx, x):
        m = over_model(x.amax(-1, keepdim=True), "max")
        m = m.masked_fill(m.abs() == float("inf"), 0.0)
        lse = torch.log(over_model(torch.exp(x - m).sum(-1), "sum")) + m[..., 0]
        ctx.save_for_backward(x, lse)
        return lse

    @staticmethod
    def backward(ctx, grad):
        x, lse = ctx.saved_tensors
        return grad[..., None] * torch.exp(x - lse[..., None])


def _sharded_gold(logits: torch.Tensor, safe: torch.Tensor) -> torch.Tensor:
    """Each position's gold logit from vocab-sharded logits: the rank that
    holds the label's column reads it, the others add zero."""
    n = logits.shape[-1]
    lo = tp_rank() * n
    mine = (safe >= lo) & (safe < lo + n)
    gold = torch.gather(logits, -1, torch.where(mine, safe - lo, 0)[..., None])[..., 0]
    return reduce_from_model(torch.where(mine, gold, 0.0))


# ---------------------------------------------------------------------------
# Step factory
# ---------------------------------------------------------------------------

def loss_and_grads(params: Params, cfg, batch: dict, *, train_cfg: TrainConfig
                   ) -> tuple[torch.Tensor, dict, Params]:
    """``(loss, metrics, gradient tree)`` of :func:`lm_loss` over every leaf
    of ``params``, under deterministic algorithms; a leaf the loss never
    reads (a zero-length layer stack) gets a zero gradient, as in JAX."""
    leaves = tree_leaves(params)
    with deterministic():
        diff = [p.detach().requires_grad_(True) for p in leaves]
        with torch.enable_grad():
            loss, metrics = lm_loss(tree_unflatten(params, diff), cfg, batch,
                                    train_cfg=train_cfg)
            grads = torch.autograd.grad(loss, diff, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def batch_shardings(mesh, batch_tree: dict) -> dict:
    """Batch arrays shard their leading dim over ``batch_axes(mesh)``."""
    ax = batch_axes(mesh)
    return tree_map(lambda x: NamedSharding(mesh, P(ax, *([None] * (x.dim() - 1)))),
                    batch_tree)


def _local_batch(batch: dict, mesh) -> dict:
    """This rank's shard of the global batch (a DTensor batch is already
    placed: its local shard)."""
    def one(x, sh):
        if isinstance(x, DTensor):
            return x.to_local()
        return local_shard(x, sh.placements, mesh)
    return {k: one(batch[k], sh) for k, sh in batch_shardings(mesh, batch).items()}


def _sharded_step(cfg, opt_cfg: OptimizerConfig, train_cfg: TrainConfig, mesh, use_kernel):
    names = axis_names(mesh)
    if names not in (("data", "model"), ("pod", "data", "model")):
        raise ValueError(f"a train mesh has axes ('data','model') or ('pod','data','model'), "
                         f"not {names}")
    multi_pod = "pod" in names
    manual = ("pod",) if multi_pod else ()
    tp = train_cfg.sharding_profile in ("fsdp", "replicated")

    def step(params: Params, opt_state: OptState, batch: dict):
        with use_mesh(mesh), use_sharding_profile(train_cfg.sharding_profile):
            local = _local_batch(batch, mesh)
            with use_manual_axes(manual), (use_tensor_parallel(mesh) if tp
                                           else contextlib.nullcontext()):
                # the ranks this rank's batch shard shares the loss with: the
                # batch axes, less 'pod' (the pod block's loss is pod-local)
                dims = tuple(a for a in batch_axes(mesh) if a not in manual)
                used = gather_fsdp_tree(params) if tp else gather_tree(params)
                with use_batch_reduction(mesh, dims):
                    _, metrics, grads = loss_and_grads(used, cfg, local, train_cfg=train_cfg)
                del used
                if tp:
                    grads = [reduce_grad_to_shard(g, p, dims)
                             for g, p in zip(tree_leaves(grads), tree_leaves(params))]
                else:
                    grads = [local_shard(reduce_over(g, mesh, dims), p.placements, mesh)
                             for g, p in zip(tree_leaves(grads), tree_leaves(params))]
            if multi_pod:
                grads = compression.pod_mean_tree(grads, compress=train_cfg.pod_compression,
                                                  group=mesh.get_group("pod"))
                n_pod = mesh_shape(mesh)["pod"]
                metrics = {k: v if n_pod == 1 else reduce_over(v, mesh, ("pod",)) / n_pod
                           for k, v in metrics.items()}
            grads = tree_unflatten(params, [
                DTensor.from_local(g, p.device_mesh, p.placements, run_check=False)
                for g, p in zip(grads, tree_leaves(params))])
            new_params, new_opt, opt_metrics = adamw_update(opt_cfg, params, grads, opt_state,
                                                            use_kernel=use_kernel)
        return new_params, new_opt, dict(metrics, **opt_metrics)

    return step


def make_train_step(cfg, opt_cfg: OptimizerConfig,
                    train_cfg: TrainConfig = TrainConfig(), mesh=None, *,
                    use_kernel: bool = True) -> Callable[[Params, OptState, dict], tuple]:
    """Build the train step ``(params, opt_state, batch) → (params',
    opt_state', metrics)``.  ``use_kernel=False`` runs ITP-AdamW's quantiser
    on its plain version instead of kernels 9-10.

    With a ``mesh`` the state is the DTensor tree :func:`init_training`
    places, the batch is the global batch (every rank passes the same one,
    or DTensors placed by :func:`batch_shardings`), and every rank of the
    mesh calls the step; the metrics are plain tensors, equal on every
    rank."""
    if mesh is not None:
        return _sharded_step(cfg, opt_cfg, train_cfg, mesh, use_kernel)

    def step(params: Params, opt_state: OptState, batch: dict):
        _, metrics, grads = loss_and_grads(params, cfg, batch, train_cfg=train_cfg)
        new_params, new_opt, opt_metrics = adamw_update(opt_cfg, params, grads, opt_state,
                                                        use_kernel=use_kernel)
        return new_params, new_opt, dict(metrics, **opt_metrics)

    return step


def init_training(gen: torch.Generator | None, cfg, opt_cfg: OptimizerConfig, *, mesh=None,
                  device: str | torch.device = "cuda"):
    """``(params, opt_state)``: the model drawn from ``gen`` on ``device``
    (CUDA unless the caller asks for the CPU) and zero moments.  With a
    ``mesh`` the same draw is placed on it by the reference's rules under
    the ambient sharding profile, every rank keeping its shards."""
    params = transformer.init_model(gen, cfg, device=device)
    if mesh is not None:
        params = distribute_tree(params, param_spec_tree(cfg, params, mesh), mesh)
    return params, init_opt_state(params)
