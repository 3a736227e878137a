"""LM training in bfloat16 and the ``remat`` policies (ROADMAP item 18c).

``test_models.py::test_arch_smoke_train_step`` mirrored on the port for all
ten smoke configs (one step: finite loss > 0, every leaf finite, the largest
move > 1e-6), plus the bfloat16 smoke against the JAX package on the same
arrays: loss within 1e-2 relative and the flattened gradients' correlation
> 0.98 (the reference's logits threshold, ``test_models.py:110-112``).  The
port gathers the embedding rows and then casts them, the reference casts
the table and then gathers (``layers.py:141-142``): the forward bits are
equal, but the port adds the embedding gradient in float32 where the
reference adds it in bfloat16, one of the gaps ``-s`` prints.

``remat`` ``none`` / ``full`` / ``dots`` give bit-equal loss and gradients;
counting the matrix products the backward runs shows each policy at work:
``full`` recomputes the blocks' ``mm`` and ``bmm``, ``dots`` saves the
``mm`` (no batch dimensions) and recomputes the ``bmm``."""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import ARCH_NAMES
from repro.train import train_step as JTS
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TTS
from repro_torch.tree import tree_leaves, tree_unflatten
from test_torch_lm_model import _model
from test_torch_lm_train import port_grads

B, S = 2, 16


def _smoke_batch(cfg, seed):
    """The reference test's batch: random tokens and random labels, the
    vision stub ``ones * 0.1`` in bfloat16."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    if cfg.family == "vlm":
        jb["vis_embed"] = jnp.ones((B, 8, cfg.vis_dim), jnp.bfloat16) * 0.1
        tb["vis_embed"] = torch.ones((B, 8, cfg.vis_dim), dtype=torch.bfloat16) * 0.1
    return jb, tb


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_arch_smoke_train_step_bf16(arch):
    cfg, jp, tp = _model(arch, dtype="bfloat16")
    jb, tb = _smoke_batch(cfg, 5)
    step = TTS.make_train_step(cfg, TO.OptimizerConfig(total_steps=10),
                               TTS.TrainConfig(remat="none"))
    tp2, _, metrics = step(tp, TO.init_opt_state(tp), tb)
    assert np.isfinite(float(metrics["loss"])) and float(metrics["loss"]) > 0
    moved = [float((a - b).abs().max()) if a.numel() else 0.0
             for a, b in zip(tree_leaves(tp), tree_leaves(tp2))]
    assert max(moved) > 1e-6       # step 1's lr is tiny under warmup
    assert all(np.isfinite(m) for m in moved)

    tc = JTS.TrainConfig(remat="none")
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: JTS.lm_loss(p, cfg, jb, train_cfg=tc), has_aux=True))(jp)
    loss, _, grads = port_grads(tp, cfg, tb)
    rel = abs(float(loss) - float(jl)) / abs(float(jl))
    a = np.concatenate([g.float().numpy().ravel() for g in grads])
    b = np.concatenate([np.asarray(x, np.float32).ravel() for x in jax.tree_util.tree_leaves(jg)])
    corr = np.corrcoef(a, b)[0, 1]
    # the embedding table's gradient apart from the rest
    tok_g = tree_unflatten(tp, grads)["embed"]["tok"].float().numpy()
    tok_r = np.asarray(jg["embed"]["tok"], np.float32)
    tok_rel = np.linalg.norm(tok_g - tok_r) / np.linalg.norm(tok_r)
    rest_rel = np.sqrt(max(np.sum((a - b) ** 2) - np.sum((tok_g - tok_r) ** 2), 0.0)
                       / (np.sum(b ** 2) - np.sum(tok_r ** 2)))
    print(f"[gap] {arch} bfloat16 train step: loss {float(loss):.6f} vs {float(jl):.6f} "
          f"(relative {rel:.3g}), gradient correlation {corr:.6f}; relative gradient error "
          f"embed/tok {tok_rel:.3g}, the other leaves {rest_rel:.3g}")
    assert rel < 1e-2 and corr > 0.98, (rel, corr)


class _Products(TorchDispatchMode):
    """Counts the ``aten.mm`` and ``aten.bmm`` calls made under it."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
            self.n[func.__name__.split(".")[0]] += 1
        return func(*args, **(kwargs or {}))


def _remat_run(tp, cfg, tb, remat):
    """``(loss, gradient leaves, products the backward ran)``."""
    diff = [p.detach().requires_grad_(True) for p in tree_leaves(tp)]
    loss, _ = TTS.lm_loss(tree_unflatten(tp, diff), cfg, tb,
                          train_cfg=TTS.TrainConfig(remat=remat))
    with _Products() as count:
        grads = torch.autograd.grad(loss, diff, allow_unused=True)
    return loss, [g for g in grads if g is not None], count.n


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2-moe-a2.7b", "mamba2-1.3b"])
def test_remat_policies_are_bit_equal(arch):
    cfg, _, tp = _model(arch, dtype="bfloat16")
    _, tb = _smoke_batch(cfg, 6)
    runs = {remat: _remat_run(tp, cfg, tb, remat) for remat in ("none", "full", "dots")}
    loss, grads, plain = runs["none"]
    for remat in ("full", "dots"):
        other_loss, other_grads, _ = runs[remat]
        assert torch.equal(loss, other_loss)
        assert len(grads) == len(other_grads)
        assert all(torch.equal(a, b) for a, b in zip(grads, other_grads))
    full, dots = runs["full"][2], runs["dots"][2]
    assert full["mm"] > plain["mm"] and full["bmm"] > plain["bmm"]
    assert dots["mm"] == plain["mm"] and dots["bmm"] == full["bmm"]
    with pytest.raises(ValueError, match="unknown remat"):
        _remat_run(tp, cfg, tb, "everything")
