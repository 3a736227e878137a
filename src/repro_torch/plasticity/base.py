"""Learning-rule protocol and registry (port of ``repro.plasticity.base``).

A rule declares its timing state (``init_state`` / ``step``), its readout
views and its magnitude read; everything backend-shaped — which datapath
runs, packed or unpacked operands — lives in :mod:`repro_torch.plasticity.
apply`.  The hooks between the plan and the kernels carry names of their
own in the port (``kernel_view``, ``fused_update``, ``fused_delta``,
``patch_delta``, ``to_words``, ``from_words_state``, ``read_magnitudes``):
the reference's names are reserved by its lint rule R8 to
``repro/plasticity/``.

Only the intrinsic-timing rules (``itp``, ``itp_nocomp``) are ported so
far.  The reference's other rules and the ``sparse`` backend are known
names that fail at config construction, naming the ROADMAP item that will
port them (:data:`UNPORTED_RULES`, :data:`UNPORTED_BACKENDS`).
"""
from __future__ import annotations

import abc
from typing import Any

import torch

from repro_torch.core.stdp import STDPParams, pair_gate
from repro_torch.kernels.dispatch import BACKENDS, resolve_backend

# reference rule / backend name → the ROADMAP queue-1 item that ports it
UNPORTED_RULES = {
    "exact": "ROADMAP queue 1 item 10 (counter rules)",
    "linear": "ROADMAP queue 1 item 10 (counter rules)",
    "imstdp": "ROADMAP queue 1 item 10 (counter rules)",
    "mstdp": "ROADMAP queue 1 item 12 (Rank1Rule and mstdp)",
}
UNPORTED_BACKENDS = {"sparse": "ROADMAP queue 1 item 11 (sparse backend)"}


class LearningRule(abc.ABC):
    """Protocol every learning rule implements.

    ``has_kernel`` marks rules whose state the fused kernel consumes;
    ``compensate`` is ``None`` when the rule defers to the config's flag,
    else a hard override.
    """

    name: str = ""
    has_kernel: bool = False
    compensate: bool | None = None

    # -- state ---------------------------------------------------------
    @abc.abstractmethod
    def init_state(self, n: int, depth: int, *, batch: tuple[int, ...] = (),
                   device: torch.device | str | None = None) -> Any:
        """Fresh timing state for ``n`` neurons, one per ``batch`` lane."""

    @abc.abstractmethod
    def step(self, state: Any, spikes: torch.Tensor, *, depth: int) -> Any:
        """Record the current step's spikes (the shift-in)."""

    # -- readout -------------------------------------------------------
    @abc.abstractmethod
    def readout(self, state: Any) -> torch.Tensor:
        """Dense ``(*lanes, rows, n)`` view of the state."""

    @abc.abstractmethod
    def read_magnitudes(self, arr: torch.Tensor, amplitude: float, tau: float, *,
                        depth: int, pairing: str = "nearest",
                        compensate: bool = True) -> torch.Tensor:
        """Per-neuron Δw magnitude ``(*lanes, n)`` from a :meth:`readout` view."""

    def magnitudes(self, state: Any, amplitude: float, tau: float, *, depth: int,
                   pairing: str = "nearest", compensate: bool = True) -> torch.Tensor:
        return self.read_magnitudes(self.readout(state), amplitude, tau, depth=depth,
                                    pairing=pairing, compensate=compensate)

    def last_spikes(self, state: Any) -> torch.Tensor:
        """The newest spike of each neuron, ``(*lanes, n)`` float32 (the SNN
        layers' lateral-inhibition input)."""
        raise NotImplementedError(f"rule {self.name!r} has no last-spike readout")

    def check_pairing(self, pairing: str) -> None:
        if pairing not in ("nearest", "all"):
            raise ValueError(f"pairing must be 'nearest' or 'all', got {pairing!r}")

    # -- session serialization (the serving layer's per-user state) ----
    def words_per_neuron(self) -> int:
        raise NotImplementedError(f"rule {self.name!r} has no word serialization")

    def to_words(self, state: Any) -> tuple[torch.Tensor, ...]:
        """Canonical ``words_per_neuron()``-tuple of ``(*lanes, n)`` uint8 words."""
        raise NotImplementedError(f"rule {self.name!r} has no word serialization")

    def from_words_state(self, words: tuple[torch.Tensor, ...], *, depth: int) -> Any:
        """Rebuild a state whose continued trajectory bit-matches the original."""
        raise NotImplementedError(f"rule {self.name!r} has no word serialization")

    # -- fused (kernel) datapath ---------------------------------------
    def kernel_view(self, state: Any, *, packed: bool) -> torch.Tensor:
        """The state view the fused kernel consumes: ``(*lanes, n)`` uint8
        words (``packed``) or ``(*lanes, rows, n)`` float32 rows."""
        raise NotImplementedError(f"rule {self.name!r} has no fused kernel")

    def fused_update(self, w: torch.Tensor, pre_spike: torch.Tensor,
                     post_spike: torch.Tensor, pre_read: torch.Tensor,
                     post_read: torch.Tensor, p: STDPParams, *, packed: bool,
                     depth: int, pairing: str, compensate: bool, eta: float,
                     w_min: float, w_max: float, interpret: bool,
                     po2: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        """Fused clipped weight update from :meth:`kernel_view` views."""
        raise NotImplementedError(f"rule {self.name!r} has no fused kernel")

    def fused_delta(self, pre_spike: torch.Tensor, post_spike: torch.Tensor,
                    pre_read: torch.Tensor, post_read: torch.Tensor, p: STDPParams,
                    *, packed: bool, depth: int, pairing: str, compensate: bool,
                    interpret: bool, po2: tuple[torch.Tensor, torch.Tensor]
                    ) -> torch.Tensor:
        """Raw ``(*lanes, n_pre, n_post)`` Δw from :meth:`kernel_view` views,
        every lane in one kernel launch (the SNN fc layers' per-sample delta)."""
        raise NotImplementedError(f"rule {self.name!r} has no fused kernel")

    def patch_delta(self, pre_patches: torch.Tensor, post_spikes: torch.Tensor,
                    pre_read: torch.Tensor, post_read: torch.Tensor, p: STDPParams,
                    *, packed: bool, depth: int, pairing: str, compensate: bool,
                    use_kernel: bool, interpret: bool,
                    po2: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        """Raw ``(K, C)`` conv Δw from ``(M, K)`` / ``(M, C)`` im2col spikes and
        the timing views gathered into the same layout: ``(M, ·)`` uint8 words
        (``packed``) or ``(rows, M, ·)`` float32 rows."""
        raise NotImplementedError(f"rule {self.name!r} has no conv datapath")

    # -- dense reference update ----------------------------------------
    def delta(self, pre_state: Any, post_state: Any, pre_spikes: torch.Tensor,
              post_spikes: torch.Tensor, p: STDPParams, *, depth: int,
              pairing: str = "nearest", compensate: bool = True) -> torch.Tensor:
        """Raw pair-gated ``(*lanes, n_pre, n_post)`` Δw: the rank-1 gated
        outer product of the per-neuron magnitudes."""
        kw = dict(depth=depth, pairing=pairing, compensate=compensate)
        ltp = self.magnitudes(pre_state, p.a_plus, p.tau_plus, **kw)
        ltd = self.magnitudes(post_state, p.a_minus, p.tau_minus, **kw)
        ltp_en, ltd_en = pair_gate(pre_spikes[..., :, None], post_spikes[..., None, :])
        return ltp_en * ltp[..., :, None] - ltd_en * ltd[..., None, :]


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

RULES: dict[str, LearningRule] = {}


def register_rule(rule: LearningRule) -> LearningRule:
    if not rule.name:
        raise ValueError("learning rule must carry a non-empty name")
    RULES[rule.name] = rule
    return rule


def rule_names() -> tuple[str, ...]:
    return tuple(sorted(RULES))


def get_rule(name: str) -> LearningRule:
    """Look up a registered rule; unported and unknown names raise."""
    if name in RULES:
        return RULES[name]
    if name in UNPORTED_RULES:
        raise ValueError(f"rule {name!r} is not ported to repro_torch yet: "
                         f"{UNPORTED_RULES[name]}; ported rules: {rule_names()}")
    raise ValueError(f"unknown learning rule {name!r}; have {rule_names()}")


def kernel_rule_names() -> tuple[str, ...]:
    return tuple(sorted(n for n, r in RULES.items() if r.has_kernel))


def validate_update_config(*, rule: str, backend: str, pairing: str,
                           max_events: int | None) -> LearningRule:
    """Cross-field validator of ``EngineConfig``; returns the resolved rule."""
    resolved = get_rule(rule)
    resolve_rule_backend(resolved, backend)
    resolved.check_pairing(pairing)
    if max_events is not None and max_events < 1:
        raise ValueError(f"max_events must be a positive event-list cap or None "
                         f"(uncapped), got {max_events}")
    return resolved


def resolve_rule_backend(rule: str | LearningRule, backend: str) -> tuple[bool, bool]:
    """Validate a (rule, backend) cell and map it to ``(use_kernel, interpret)``."""
    if isinstance(rule, str):
        rule = get_rule(rule)
    use_kernel, interpret = resolve_backend(backend)
    if backend in UNPORTED_BACKENDS:
        raise ValueError(f"backend {backend!r} is not ported to repro_torch yet: "
                         f"{UNPORTED_BACKENDS[backend]}; valid backends: {BACKENDS}")
    if use_kernel and not rule.has_kernel:
        raise ValueError(
            f"rule {rule.name!r} has no fused kernel: backend {backend!r} is only "
            f"available for the kernel-backed rules {kernel_rule_names()}; use "
            f"backend='reference' for {rule.name!r} (valid backends: {BACKENDS})")
    return use_kernel, interpret
