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

The reference's mesh branch (the pod-local gradients inside a
``shard_map`` and the po2-compressed pod mean) and ``batch_shardings``
belong to item 18d: a mesh is refused.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.device import deterministic
from repro_torch.models import transformer
from repro_torch.train.optimizer import OptimizerConfig, OptState, adamw_update, init_opt_state
from repro_torch.tree import tree_leaves, tree_unflatten

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    remat: str = "full"              # none | full | dots
    z_loss: float = 1e-4
    pod_compression: bool = True     # po2 wire format across the pod axis
    unroll: bool = False             # unroll layer scans (measurement only)
    sharding_profile: str = "fsdp"   # fsdp | replicated (weights over data)


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise ValueError("a mesh (sharded LM training, the multi-pod step) is not ported yet "
                         "(ROADMAP queue 1 item 18d); pass mesh=None")


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
    lse = torch.logsumexp(logits.float(), dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = lse - gold.float()
    n_tok = torch.clamp(torch.sum(mask), min=1.0)
    ce = torch.sum(nll * mask) / n_tok
    zl = train_cfg.z_loss * torch.sum((lse ** 2) * mask) / n_tok
    loss = ce + zl + aux.get("moe_aux", 0.0) + aux.get("moe_z", 0.0)
    metrics = {"loss": loss, "ce": ce, "z_loss": zl,
               "moe_aux": aux.get("moe_aux", torch.zeros((), device=loss.device)),
               "tokens": n_tok}
    return loss, metrics


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


def make_train_step(cfg, opt_cfg: OptimizerConfig,
                    train_cfg: TrainConfig = TrainConfig(), mesh=None, *,
                    use_kernel: bool = True) -> Callable[[Params, OptState, dict], tuple]:
    """Build the train step ``(params, opt_state, batch) → (params',
    opt_state', metrics)``.  ``use_kernel=False`` runs ITP-AdamW's quantiser
    on its plain version instead of kernels 9-10."""
    _no_mesh(mesh)

    def step(params: Params, opt_state: OptState, batch: dict):
        _, metrics, grads = loss_and_grads(params, cfg, batch, train_cfg=train_cfg)
        new_params, new_opt, opt_metrics = adamw_update(opt_cfg, params, grads, opt_state,
                                                        use_kernel=use_kernel)
        return new_params, new_opt, dict(metrics, **opt_metrics)

    return step


def init_training(gen: torch.Generator | None, cfg, opt_cfg: OptimizerConfig, *, mesh=None,
                  device: str | torch.device = "cuda"):
    """``(params, opt_state)``: the model drawn from ``gen`` on ``device``
    (CUDA unless the caller asks for the CPU) and zero moments."""
    _no_mesh(mesh)
    params = transformer.init_model(gen, cfg, device=device)
    return params, init_opt_state(params)
