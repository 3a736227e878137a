"""Learning-rule protocol and registry (port of ``repro.plasticity.base``).

A rule declares its timing state (``init_state`` / ``step``), its readout
views and its magnitude read; everything backend-shaped — which datapath
runs, packed or unpacked operands — lives in :mod:`repro_torch.plasticity.
apply`.  The hooks between the plan and the kernels carry names of their
own in the port (``kernel_view``, ``fused_update``, ``fused_delta``,
``patch_delta``, ``batch_delta``, ``sparse_update``, ``sparse_delta``,
``sparse_patch_delta``, ``to_words``, ``from_words_state``,
``read_magnitudes``): the reference's names are reserved by its lint rule
R8 to ``repro/plasticity/``.

``has_kernel`` / ``has_sparse`` declare the backends a rule supports; a
rule without them is refused on the ``fused*`` / ``sparse`` backends at
config construction, with the reference's messages
(:func:`resolve_rule_backend`).  :class:`Rank1Rule` derives every backend
hook from the slim protocol (``init_state``, ``step``, ``readout``,
``read_magnitudes``, ``last_spikes``): its magnitudes go to the itp kernels
as a depth-1 plane read with a unit po2 vector.
"""
from __future__ import annotations

import abc
from typing import Any

import torch

from repro_torch.core.stdp import STDPParams, pair_gate
from repro_torch.kernels.dispatch import BACKENDS, resolve_backend
from repro_torch.kernels.itp_sparse.ops import (sparse_conv_delta, sparse_synapse_delta,
                                                sparse_weight_update)
from repro_torch.kernels.itp_stdp.ops import synapse_delta, weight_update_depth_major
from repro_torch.kernels.itp_stdp_conv.ops import conv_synapse_delta


class LearningRule(abc.ABC):
    """Protocol every learning rule implements.

    ``has_kernel`` marks rules whose state the fused kernel consumes,
    ``has_sparse`` rules that own the event-driven datapath;
    ``compensate`` is ``None`` when the rule defers to the config's flag,
    else a hard override.
    """

    name: str = ""
    has_kernel: bool = False
    has_sparse: bool = False
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
    def read_table(self, p: STDPParams, depth: int, *,
                   device: torch.device | str | None = None) -> torch.Tensor | None:
        """A per-delay table the rule's kernels read, built once per update
        plan on the host (``None``: the rule reads none beyond the po2
        vectors every plan carries)."""
        return None

    def kernel_view(self, state: Any, *, packed: bool) -> torch.Tensor:
        """The state view the fused kernel consumes: ``(*lanes, n)`` uint8
        words or ``(*lanes, rows, n)`` float32 rows.  A rule whose kernels
        read bitplanes or words takes ``packed`` as the choice; a rule with
        one word layout returns its words whatever ``packed`` is, and the
        plan follows the view's shape."""
        raise NotImplementedError(f"rule {self.name!r} has no fused kernel")

    def fused_update(self, w: torch.Tensor, pre_spike: torch.Tensor,
                     post_spike: torch.Tensor, pre_read: torch.Tensor,
                     post_read: torch.Tensor, p: STDPParams, *, packed: bool,
                     depth: int, pairing: str, compensate: bool, eta: float,
                     w_min: float, w_max: float, interpret: bool,
                     po2: tuple[torch.Tensor, torch.Tensor],
                     table: torch.Tensor | None = None) -> torch.Tensor:
        """Fused clipped weight update from :meth:`kernel_view` views; ``po2``
        is the plan's po2 read vectors, ``table`` its :meth:`read_table`."""
        raise NotImplementedError(f"rule {self.name!r} has no fused kernel")

    def fused_delta(self, pre_spike: torch.Tensor, post_spike: torch.Tensor,
                    pre_read: torch.Tensor, post_read: torch.Tensor, p: STDPParams,
                    *, packed: bool, depth: int, pairing: str, compensate: bool,
                    interpret: bool, po2: tuple[torch.Tensor, torch.Tensor],
                    table: torch.Tensor | None = None) -> torch.Tensor:
        """Raw ``(*lanes, n_pre, n_post)`` Δw from :meth:`kernel_view` views,
        every lane in one kernel launch: the per-sample reference the tests
        hold :meth:`batch_delta` against."""
        raise NotImplementedError(f"rule {self.name!r} has no fused kernel")

    def patch_delta(self, pre_patches: torch.Tensor, post_spikes: torch.Tensor,
                    pre_read: torch.Tensor, post_read: torch.Tensor, p: STDPParams,
                    *, packed: bool, depth: int, pairing: str, compensate: bool,
                    use_kernel: bool, interpret: bool,
                    po2: tuple[torch.Tensor, torch.Tensor],
                    table: torch.Tensor | None = None) -> torch.Tensor:
        """Raw ``(K, C)`` conv Δw from ``(M, K)`` / ``(M, C)`` im2col spikes and
        the timing views gathered into the same layout: ``(M, ·)`` uint8 words
        (``packed``) or ``(rows, M, ·)`` float32 rows."""
        raise NotImplementedError(f"rule {self.name!r} has no conv datapath")

    def batch_delta(self, pre_spike: torch.Tensor, post_spike: torch.Tensor,
                    pre_read: torch.Tensor, post_read: torch.Tensor, p: STDPParams,
                    *, packed: bool, depth: int, pairing: str, compensate: bool,
                    interpret: bool, po2: tuple[torch.Tensor, torch.Tensor],
                    table: torch.Tensor | None = None) -> torch.Tensor:
        """Batch-summed raw ``(n_pre, n_post)`` Δw of an SNN fc layer on the
        kernel backends, from ``(B, n_pre)`` / ``(B, n_post)`` spikes and
        :meth:`kernel_view` views with the batch as their lane axis:
        ``(B, n)`` uint8 words (``packed``) or ``(rows, B, n)`` rows.

        A rule that reads one magnitude per neuron makes its fc delta the
        P = 1 case of its conv patch formula, the batch as the M rows: one
        gated-contraction launch (:meth:`patch_delta`) sums the batch exactly
        in float64 inside the kernel, with no per-sample array."""
        return self.patch_delta(pre_spike, post_spike, pre_read, post_read, p,
                                packed=packed, depth=depth, pairing=pairing,
                                compensate=compensate, use_kernel=True,
                                interpret=interpret, po2=po2, table=table)

    # -- event-driven (sparse) datapath ---------------------------------
    # The readout views are :meth:`kernel_view`'s (packed words or rows), so
    # the sparse backend shares the fused backends' state layout.

    def sparse_update(self, w: torch.Tensor, pre_spike: torch.Tensor,
                      post_spike: torch.Tensor, pre_read: torch.Tensor,
                      post_read: torch.Tensor, p: STDPParams, *, packed: bool,
                      depth: int, pairing: str, compensate: bool, eta: float,
                      w_min: float, w_max: float, max_events: int | None,
                      po2: tuple[torch.Tensor, torch.Tensor],
                      table: torch.Tensor | None = None,
                      pre_events: torch.Tensor | None = None) -> torch.Tensor:
        """Event-driven clipped weight update from :meth:`kernel_view` views,
        event lists taken from the current spikes under ``max_events``
        (the presynaptic list given as ``pre_events`` on a sharded tile)."""
        raise NotImplementedError(f"rule {self.name!r} has no event-driven datapath")

    def sparse_delta(self, pre_spike: torch.Tensor, post_spike: torch.Tensor,
                     pre_read: torch.Tensor, post_read: torch.Tensor, p: STDPParams,
                     *, packed: bool, depth: int, pairing: str, compensate: bool,
                     max_events: int | None, po2: tuple[torch.Tensor, torch.Tensor],
                     table: torch.Tensor | None = None) -> torch.Tensor:
        """Raw event-driven ``(*lanes, n_pre, n_post)`` Δw (the SNN fc layers'
        per-sample delta, the batch as lanes)."""
        raise NotImplementedError(f"rule {self.name!r} has no event-driven datapath")

    def sparse_patch_delta(self, pre_patches: torch.Tensor, post_spikes: torch.Tensor,
                           pre_read: torch.Tensor, post_read: torch.Tensor,
                           p: STDPParams, *, depth: int, pairing: str,
                           compensate: bool, max_events: int | None,
                           po2: tuple[torch.Tensor, torch.Tensor],
                           table: torch.Tensor | None = None) -> torch.Tensor:
        """Raw ``(K, C)`` conv Δw on the active patch rows only, from
        ``(rows, M, ·)`` float32 row views in the im2col layout."""
        raise NotImplementedError(f"rule {self.name!r} has no event-driven datapath")

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


def lane_sum(dw: torch.Tensor) -> torch.Tensor:
    """``(B, n_pre, n_post)`` per-sample deltas summed over the batch lanes:
    every term is an exact float32 value, so the float64 sum is exact and
    rounds once, and any order gives the bits of the gated contraction."""
    return dw.sum(dim=0, dtype=torch.float64).to(torch.float32)


# ---------------------------------------------------------------------------
# Generic rank-1 backend adapters
# ---------------------------------------------------------------------------

# Unit STDP params for the magnitude-plane adapters: with one depth-1 plane
# the po2 read vector is [2^0] = [1.0] for any τ, so ``po2 · plane`` is the
# plane itself and the rule's amplitudes are not applied twice.
_UNIT_PARAMS = STDPParams(a_plus=1.0, a_minus=1.0)


class Rank1Rule(LearningRule):
    """Slim-protocol base: every backend from five rule-owned methods.

    For a rule whose dense update is the pair-gated rank-1 form
    ``dw = gate_ltp·ltp[:, None] − gate_ltd·ltd[None, :]`` with per-neuron
    magnitudes read from its state, the whole hook seam is derivable, so a
    subclass writes only ``init_state`` / ``step`` / ``readout`` /
    ``read_magnitudes`` / ``last_spikes``.

    The adapters hand the rule's magnitudes to the itp datapaths as one
    depth-1 float32 "bitplane" (``ltp[..., None, :]``) with the unit po2
    read vector ``[1.0]`` (:meth:`read_table`, built once per plan), so the
    kernels' read ``1.0 · m`` is ``m`` exactly: kernel 2 for the engine
    update, kernel 4 for the conv delta and the fc delta's batch sum, the
    ``itp_sparse`` ops for the sparse backend.  Pairing is forced to
    ``"all"`` there (the nearest mask counts set bits, which a magnitude is
    not) and compensation off; the rule's own ``read_magnitudes`` owns
    whatever pairing it supports.  The packed kernels 1 and 3 are never
    reached: :meth:`kernel_view` returns the dense readout rows whatever
    ``packed`` is, and the plan follows the view's shape.

    Subclasses get the full backend column (``has_kernel`` and
    ``has_sparse`` both True); a subclass that clears a flag is refused on
    those backends at config construction.
    """

    has_kernel: bool = True
    has_sparse: bool = True

    def kernel_view(self, state: Any, *, packed: bool) -> torch.Tensor:
        del packed  # a generic rule's rows are its storage format
        return self.readout(state)

    def read_table(self, p: STDPParams, depth: int, *,
                   device: torch.device | str | None = None) -> torch.Tensor:
        """The unit po2 read vector ``[1.0]`` of the depth-1 magnitude plane,
        which the adapters hand the kernels as both sides' po2 vector."""
        return torch.ones((1,), dtype=torch.float32, device=device)

    def _magnitude_pair(self, pre_read, post_read, p: STDPParams, *, depth, pairing,
                        compensate) -> tuple[torch.Tensor, torch.Tensor]:
        kw = dict(depth=depth, pairing=pairing, compensate=compensate)
        return (self.read_magnitudes(pre_read, p.a_plus, p.tau_plus, **kw),
                self.read_magnitudes(post_read, p.a_minus, p.tau_minus, **kw))

    def _patch_magnitudes(self, pre_read, post_read, p: STDPParams, *, depth, pairing,
                          compensate) -> tuple[torch.Tensor, torch.Tensor]:
        """The magnitudes of ``(rows, M, ·)`` im2col views: read as
        ``(rows, M·X)`` rows, shaped back to ``(M, X)``."""
        pre = pre_read.reshape(pre_read.shape[0], -1)
        post = post_read.reshape(post_read.shape[0], -1)
        ltp, ltd = self._magnitude_pair(pre, post, p, depth=depth, pairing=pairing,
                                        compensate=compensate)
        return ltp.reshape(pre_read.shape[1:]), ltd.reshape(post_read.shape[1:])

    # -- fused (kernel) datapath: kernels 2 and 4 on a magnitude plane ----
    def fused_update(self, w, pre_spike, post_spike, pre_read, post_read,
                     p: STDPParams, *, packed, depth, pairing, compensate, eta,
                     w_min, w_max, interpret, po2, table=None):
        del packed, po2
        ltp, ltd = self._magnitude_pair(pre_read, post_read, p, depth=depth,
                                        pairing=pairing, compensate=compensate)
        return weight_update_depth_major(
            w, pre_spike, post_spike, ltp.unsqueeze(-2), ltd.unsqueeze(-2), _UNIT_PARAMS,
            pairing="all", compensate=False, eta=eta, w_min=w_min, w_max=w_max,
            interpret=interpret, po2=(table, table))

    def fused_delta(self, pre_spike, post_spike, pre_read, post_read, p: STDPParams,
                    *, packed, depth, pairing, compensate, interpret, po2, table=None):
        """Per-lane Δw on kernel 2 over the magnitude planes: no program
        path calls it (the fc layers' batch sum is :meth:`patch_delta`'s
        kernel 4); the tests' per-sample reference."""
        del packed, po2
        ltp, ltd = self._magnitude_pair(pre_read, post_read, p, depth=depth,
                                        pairing=pairing, compensate=compensate)
        return synapse_delta(pre_spike, post_spike, ltp.unsqueeze(-2), ltd.unsqueeze(-2),
                             _UNIT_PARAMS, pairing="all", compensate=False,
                             interpret=interpret, po2=(table, table))

    def patch_delta(self, pre_patches, post_spikes, pre_read, post_read, p: STDPParams,
                    *, packed, depth, pairing, compensate, use_kernel, interpret, po2,
                    table=None):
        del packed, po2
        ltp, ltd = self._patch_magnitudes(pre_read, post_read, p, depth=depth,
                                          pairing=pairing, compensate=compensate)
        return conv_synapse_delta(pre_patches, post_spikes, ltp[None], ltd[None],
                                  _UNIT_PARAMS, pairing="all", compensate=False,
                                  use_kernel=use_kernel, interpret=interpret,
                                  po2=(table, table))

    # -- event-driven (sparse) datapath: the itp_sparse ops ---------------
    def sparse_update(self, w, pre_spike, post_spike, pre_read, post_read,
                      p: STDPParams, *, packed, depth, pairing, compensate, eta,
                      w_min, w_max, max_events, po2, table=None, pre_events=None):
        del packed, po2, table
        ltp, ltd = self._magnitude_pair(pre_read, post_read, p, depth=depth,
                                        pairing=pairing, compensate=compensate)
        return sparse_weight_update(w, pre_spike, post_spike, ltp, ltd, eta=eta,
                                    w_min=w_min, w_max=w_max, max_events=max_events,
                                    pre_events=pre_events)

    def sparse_delta(self, pre_spike, post_spike, pre_read, post_read, p: STDPParams,
                     *, packed, depth, pairing, compensate, max_events, po2, table=None):
        del packed, po2, table
        ltp, ltd = self._magnitude_pair(pre_read, post_read, p, depth=depth,
                                        pairing=pairing, compensate=compensate)
        return sparse_synapse_delta(pre_spike, post_spike, ltp, ltd, max_events=max_events)

    def sparse_patch_delta(self, pre_patches, post_spikes, pre_read, post_read,
                           p: STDPParams, *, depth, pairing, compensate, max_events,
                           po2, table=None):
        del po2
        ltp, ltd = self._patch_magnitudes(pre_read, post_read, p, depth=depth,
                                          pairing=pairing, compensate=compensate)
        return sparse_conv_delta(pre_patches, post_spikes, ltp[None], ltd[None], table, table,
                                 nearest=False, max_events=max_events)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

RULES: dict[str, LearningRule] = {}


def register_rule(rule: LearningRule) -> LearningRule:
    """Add ``rule`` to the registry (keyed by ``rule.name``)."""
    if not rule.name:
        raise ValueError("learning rule must carry a non-empty name")
    RULES[rule.name] = rule
    return rule


def rule_names() -> tuple[str, ...]:
    return tuple(sorted(RULES))


def get_rule(name: str) -> LearningRule:
    """Look up a registered rule; unknown names list the valid options."""
    try:
        return RULES[name]
    except KeyError as e:
        raise ValueError(f"unknown learning rule {name!r}; have {rule_names()}") from e


def kernel_rule_names() -> tuple[str, ...]:
    return tuple(sorted(n for n, r in RULES.items() if r.has_kernel))


def sparse_rule_names() -> tuple[str, ...]:
    return tuple(sorted(n for n, r in RULES.items() if r.has_sparse))


def validate_update_config(*, rule: str, backend: str, pairing: str,
                           max_events: int | None) -> LearningRule:
    """Cross-field validator of ``EngineConfig`` and ``SNNConfig``; returns
    the resolved rule."""
    resolved = get_rule(rule)
    resolve_rule_backend(resolved, backend)
    resolved.check_pairing(pairing)
    if max_events is not None and max_events < 1:
        raise ValueError(f"max_events must be a positive event-list cap or None "
                         f"(uncapped), got {max_events}")
    return resolved


def resolve_rule_backend(rule: str | LearningRule, backend: str) -> tuple[bool, bool]:
    """Validate a (rule, backend) cell and map it to ``(use_kernel, interpret)``:
    a kernel-less rule on a ``fused*`` backend, or a rule without event hooks
    on ``sparse``, raises the reference's message."""
    if isinstance(rule, str):
        rule = get_rule(rule)
    use_kernel, interpret = resolve_backend(backend)
    if use_kernel and not rule.has_kernel:
        raise ValueError(
            f"rule {rule.name!r} has no fused kernel: backend {backend!r} is only "
            f"available for the kernel-backed rules {kernel_rule_names()}; use "
            f"backend='reference' for {rule.name!r} (valid backends: {BACKENDS})")
    if backend == "sparse" and not rule.has_sparse:
        raise ValueError(
            f"rule {rule.name!r} has no event-driven datapath: backend "
            f"'sparse' is only available for the event-hook rules "
            f"{sparse_rule_names()}; use backend='reference' for "
            f"{rule.name!r} (valid backends: {BACKENDS})")
    return use_kernel, interpret
