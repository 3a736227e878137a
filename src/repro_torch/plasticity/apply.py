"""One dispatch layer for the weight update (port of ``repro.plasticity.apply``).

:func:`make_plan` resolves a config (``EngineConfig`` or ``SNNConfig``
duck-type) and a device into a frozen :class:`UpdatePlan`: the rule object, the backend
flags, the packed-readout selection, the effective compensation, the po2
read vectors and the rule's own read table (the counter rules' imstdp
window) — computed once on the host and moved to the device, so the kernel
and its plain version read the same bits.  Plans are cached per
``(cfg, device)``, the port's counterpart of the reference building one
static plan per trace.

:meth:`UpdatePlan.update` is the dense engine update (fused kernel, the
kernel's plain version for ``fused_interpret``, or the reference rank-1
path plus clip); the session-word methods are the seam the serving layer
rides.  :meth:`UpdatePlan.fc_delta` / :meth:`UpdatePlan.conv_delta` are
the batched SNN layer deltas (raw Δw: the layer owns eta, the batch
normalisation, the clip and quantisation).  The shard_map tile update and
the sparse backend come with later slices.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from repro_torch.core.stdp import STDPParams
from repro_torch.kernels.dispatch import (im2col_1d, im2col_2d, im2col_words_1d,
                                          im2col_words_2d)
from repro_torch.kernels.itp_stdp.ops import po2_vectors
from repro_torch.kernels.itp_stdp_conv.ref import gated_contraction
from repro_torch.plasticity.base import LearningRule, resolve_rule_backend


@dataclasses.dataclass(frozen=True)
class UpdatePlan:
    """Static dispatch decisions for one (rule, backend, config, device) cell."""

    rule: LearningRule
    backend: str
    use_kernel: bool       # fused / fused_interpret
    interpret: bool        # fused_interpret: the kernel's plain version
    packed: bool           # resolved packed-word selection (depth <= 8)
    depth: int
    pairing: str
    compensate: bool       # effective (rule-override-resolved) flag
    stdp: STDPParams
    eta: float
    w_min: float
    w_max: float
    device: torch.device
    po2: tuple[torch.Tensor, torch.Tensor] = dataclasses.field(compare=False)
    table: torch.Tensor | None = dataclasses.field(default=None, compare=False)

    # -- dense engine update --------------------------------------------

    def update(self, w: torch.Tensor, pre_spikes: torch.Tensor,
               post_spikes: torch.Tensor, pre_state: Any,
               post_state: Any) -> torch.Tensor:
        """Clipped update of the ``(*lanes, n_pre, n_post)`` matrix."""
        rule = self.rule
        if self.use_kernel:
            return rule.fused_update(
                w, pre_spikes, post_spikes,
                rule.kernel_view(pre_state, packed=self.packed),
                rule.kernel_view(post_state, packed=self.packed),
                self.stdp, packed=self.packed, depth=self.depth,
                pairing=self.pairing, compensate=self.compensate, eta=self.eta,
                w_min=self.w_min, w_max=self.w_max, interpret=self.interpret,
                po2=self.po2, table=self.table)
        dw = rule.delta(pre_state, post_state, pre_spikes, post_spikes, self.stdp,
                        depth=self.depth, pairing=self.pairing,
                        compensate=self.compensate)
        return torch.clamp(w + self.eta * dw, self.w_min, self.w_max)

    # -- batched SNN layer deltas ---------------------------------------

    def fc_delta(self, pre_state: Any, post_state: Any, s_in: torch.Tensor,
                 s_out: torch.Tensor) -> torch.Tensor:
        """Batch-summed raw ``(fan_in, n_out)`` Δw of an fc layer.

        The fc layer is the engine's dense synapse matrix replicated over the
        batch.  The kernel backends make one kernel-1 launch with the batch
        as the lane axis and sum the ``(B, fan_in, n_out)`` per-sample deltas
        (the reference vmaps and sums); the reference backend contracts the
        pair-gated magnitudes over the batch (the P = 1 case of the conv
        patch formula).  Every per-sample term is an exact float32 value, so
        both sum in float64, exactly, and round once: the two backends give
        the same bits, as the conv kernel and its plain version do.  The
        kernel view's shape picks the layout: ``(B·n,)`` words (packed
        history words, counter words at any depth) or ``(rows, B·n)`` rows.
        """
        B = s_in.shape[0]
        pre = s_in.reshape(B, -1)                        # (B, fan_in)
        post = s_out.reshape(B, -1)                      # (B, n_out)
        rule, p = self.rule, self.stdp
        kw = dict(depth=self.depth, pairing=self.pairing, compensate=self.compensate)
        if not self.use_kernel:
            ltp = rule.magnitudes(pre_state, p.a_plus, p.tau_plus, **kw).reshape(B, -1)
            ltd = rule.magnitudes(post_state, p.a_minus, p.tau_minus, **kw).reshape(B, -1)
            return gated_contraction(pre, post, ltp, ltd)
        pre_read = rule.kernel_view(pre_state, packed=self.packed)
        post_read = rule.kernel_view(post_state, packed=self.packed)
        words = pre_read.dim() == 1
        if words:          # (B·n,) words → (B, n) lanes
            pre_read, post_read = pre_read.reshape(B, -1), post_read.reshape(B, -1)
        else:              # (rows, B·n) → (B, rows, n) lanes
            pre_read = pre_read.reshape(pre_read.shape[0], B, -1).transpose(0, 1)
            post_read = post_read.reshape(post_read.shape[0], B, -1).transpose(0, 1)
        dw = rule.fused_delta(pre, post, pre_read, post_read, p, packed=words,
                              interpret=self.interpret, po2=self.po2, table=self.table,
                              **kw)
        return dw.sum(dim=0, dtype=torch.float64).to(torch.float32)

    def conv_delta(self, pre_state: Any, post_state: Any, patches: torch.Tensor,
                   s_out: torch.Tensor, *, in_shape: tuple, kind: str, kernel: int,
                   stride: int) -> torch.Tensor:
        """Batch- and position-summed raw ``(K, C)`` Δw of a conv layer.

        The timing views are gathered into the im2col layout of the spikes
        (each patch element carries its source pixel's state): word views
        once as ``(M, K)`` uint8, row views as ``(rows, M, K)`` float32.  The
        view's shape picks the layout: a history rule gives words only on a
        kernel backend with packed histories (the reference backend reads the
        rows its oracle is defined on); a counter rule always gives words.
        """
        rule = self.rule
        B = s_out.shape[0]
        pre_read = rule.kernel_view(pre_state, packed=self.use_kernel and self.packed)
        post_read = rule.kernel_view(post_state, packed=self.use_kernel and self.packed)
        packed = pre_read.dim() == 1
        if packed:
            im2col_w = im2col_words_2d if kind == "conv2d" else im2col_words_1d
            pre_read = im2col_w(pre_read.reshape(B, *in_shape), kernel, stride)
            pre_read = pre_read.reshape(-1, pre_read.shape[-1])          # (M, K)
            post_read = post_read.reshape(-1, s_out.shape[-1])           # (M, C)
        else:
            im2col = im2col_2d if kind == "conv2d" else im2col_1d
            rows = pre_read.shape[0]
            pre_read = im2col(pre_read.reshape(rows * B, *in_shape), kernel, stride)
            pre_read = pre_read.reshape(rows, -1, pre_read.shape[-1])    # (rows, M, K)
            post_read = post_read.to(torch.float32).reshape(rows, -1, s_out.shape[-1])
        return rule.patch_delta(
            patches.reshape(-1, patches.shape[-1]), s_out.reshape(-1, s_out.shape[-1]),
            pre_read, post_read, self.stdp, packed=packed, depth=self.depth,
            pairing=self.pairing, compensate=self.compensate,
            use_kernel=self.use_kernel, interpret=self.interpret, po2=self.po2,
            table=self.table)

    # -- session serialization (the serving layer's per-user state) -----

    def words_per_neuron(self) -> int:
        """Resident uint8 words per neuron of the serialized timing state."""
        return self.rule.words_per_neuron()

    def init_words(self, n: int, *, batch: tuple[int, ...] = ()
                   ) -> tuple[torch.Tensor, ...]:
        """Serialized fresh timing state for a population of ``n``."""
        return self.session_words(
            self.rule.init_state(n, self.depth, batch=batch, device=self.device))

    def session_words(self, state: Any) -> tuple[torch.Tensor, ...]:
        """Canonical ``(*lanes, n)`` uint8 word planes of a timing state."""
        return self.rule.to_words(state)

    def session_state(self, words: tuple[torch.Tensor, ...]) -> Any:
        """Rebuild a timing state whose continued trajectory bit-matches the
        state :meth:`session_words` serialized."""
        return self.rule.from_words_state(words, depth=self.depth)


@functools.lru_cache(maxsize=64)
def make_plan(cfg: Any, device: torch.device | str | None = None) -> UpdatePlan:
    """Resolve a config into an :class:`UpdatePlan` on ``device``.

    Duck-typed over ``EngineConfig`` and ``SNNConfig``: compensation resolves
    through ``effective_compensate()`` where the config has it, else its
    ``compensate`` property, and the clip window (``w_min``/``w_max``)
    defaults to the SNN's fixed [0, 1].  Cached: a config is a frozen
    dataclass, and a plan (its po2 tensors included) is never mutated, so
    every caller may share it.
    """
    rule = cfg.learning_rule()
    use_kernel, interpret = resolve_rule_backend(rule, cfg.backend)
    if hasattr(cfg, "effective_compensate"):
        compensate = cfg.effective_compensate()
    else:
        compensate = cfg.compensate
    device = torch.device("cpu" if device is None else device)
    return UpdatePlan(
        rule=rule,
        backend=cfg.backend,
        use_kernel=use_kernel,
        interpret=interpret,
        packed=cfg.use_packed_history(),
        depth=cfg.depth,
        pairing=cfg.pairing,
        compensate=compensate,
        stdp=cfg.stdp,
        eta=cfg.eta,
        w_min=getattr(cfg, "w_min", 0.0),
        w_max=getattr(cfg, "w_max", 1.0),
        device=device,
        po2=po2_vectors(cfg.stdp, cfg.depth, compensate=compensate, device=device),
        table=rule.read_table(cfg.stdp, cfg.depth, device=device),
    )


def apply_update(cfg: Any, w: torch.Tensor, pre_spikes: torch.Tensor,
                 post_spikes: torch.Tensor, pre_state: Any,
                 post_state: Any) -> torch.Tensor:
    """One-shot convenience: :func:`make_plan` + :meth:`UpdatePlan.update`."""
    return make_plan(cfg, w.device).update(w, pre_spikes, post_spikes,
                                           pre_state, post_state)
