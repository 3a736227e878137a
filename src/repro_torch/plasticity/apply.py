"""One dispatch layer for the weight update (port of ``repro.plasticity.apply``).

:func:`make_plan` resolves a config (``EngineConfig`` duck-type) and a
device into a frozen :class:`UpdatePlan`: the rule object, the backend
flags, the packed-readout selection, the effective compensation, and the
po2 read vectors — computed once on the host and moved to the device, so
the kernel and its plain version read the same bits.  Plans are cached per
``(cfg, device)``, the port's counterpart of the reference building one
static plan per trace.

:meth:`UpdatePlan.update` is the dense engine update (fused kernel, the
kernel's plain version for ``fused_interpret``, or the reference rank-1
path plus clip); the session-word methods are the seam the serving layer
rides.  The shard_map tile update, the SNN layer deltas and the sparse
backend come with later slices.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from repro_torch.core.stdp import STDPParams
from repro_torch.kernels.itp_stdp.ops import po2_vectors
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
                po2=self.po2)
        dw = rule.delta(pre_state, post_state, pre_spikes, post_spikes, self.stdp,
                        depth=self.depth, pairing=self.pairing,
                        compensate=self.compensate)
        return torch.clamp(w + self.eta * dw, self.w_min, self.w_max)

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

    Cached: a config is a frozen dataclass, and a plan (its po2 tensors
    included) is never mutated, so every caller may share it.
    """
    rule = cfg.learning_rule()
    use_kernel, interpret = resolve_rule_backend(rule, cfg.backend)
    compensate = cfg.effective_compensate()
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
        w_min=cfg.w_min,
        w_max=cfg.w_max,
        device=device,
        po2=po2_vectors(cfg.stdp, cfg.depth, compensate=compensate, device=device),
    )


def apply_update(cfg: Any, w: torch.Tensor, pre_spikes: torch.Tensor,
                 post_spikes: torch.Tensor, pre_state: Any,
                 post_state: Any) -> torch.Tensor:
    """One-shot convenience: :func:`make_plan` + :meth:`UpdatePlan.update`."""
    return make_plan(cfg, w.device).update(w, pre_spikes, post_spikes,
                                           pre_state, post_state)
