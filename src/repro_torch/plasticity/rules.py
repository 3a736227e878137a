"""The intrinsic-timing rules ``itp`` and ``itp_nocomp`` (port of
``repro.plasticity.rules.HistoryRule``).

State is the bitplane spike history; the timing difference is never
computed: the register read is the update (eq. 2 / Fig. 3).  ``itp`` is
compensated by default (eq. 18), ``itp_nocomp`` reads the raw po2 weights.
The rule's hooks reach the dense kernels (``itp_stdp``: the engine update
and the SNN fc layers' per-sample delta) and the conv kernel
(``itp_stdp_conv``).  The counter rules come with ROADMAP queue 1 item 10.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import history as H
from repro_torch.core.stdp import STDPParams, magnitudes_depth_major
from repro_torch.kernels.itp_stdp.ops import (synapse_delta, synapse_delta_packed,
                                              weight_update_depth_major,
                                              weight_update_packed)
from repro_torch.kernels.itp_stdp_conv.ops import (conv_synapse_delta,
                                                   conv_synapse_delta_packed)
from repro_torch.plasticity.base import LearningRule, register_rule


@dataclasses.dataclass(frozen=True)
class HistoryRule(LearningRule):
    """Intrinsic-timing po2 rule: bitplane-history state, register-read Δw."""

    name: str = "itp"
    has_kernel: bool = True
    compensate: bool | None = None  # None: defer to the config flag

    def init_state(self, n: int, depth: int, *, batch: tuple[int, ...] = (),
                   device: torch.device | str | None = None) -> H.SpikeHistory:
        return H.init_history(n, depth, batch=batch, device=device)

    def step(self, state: H.SpikeHistory, spikes: torch.Tensor, *,
             depth: int) -> H.SpikeHistory:
        del depth  # the state carries it
        return H.push(state, spikes)

    def readout(self, state: H.SpikeHistory) -> torch.Tensor:
        return H.registers_depth_major(state)  # (*lanes, depth, n), k=0 newest

    def read_magnitudes(self, arr: torch.Tensor, amplitude: float, tau: float, *,
                        depth: int, pairing: str = "nearest",
                        compensate: bool = True) -> torch.Tensor:
        del depth  # arr carries it
        return magnitudes_depth_major(arr, amplitude, tau, pairing=pairing,
                                      compensate=compensate)

    def last_spikes(self, state: H.SpikeHistory) -> torch.Tensor:
        # the newest bit is planes[head]; no full register gather needed
        return H.latest(state).to(torch.float32)

    # -- session serialization: one history word per neuron -------------
    def words_per_neuron(self) -> int:
        return 1

    def to_words(self, state: H.SpikeHistory) -> tuple[torch.Tensor, ...]:
        return (H.pack_words(state),)

    def from_words_state(self, words: tuple[torch.Tensor, ...], *,
                         depth: int) -> H.SpikeHistory:
        (word,) = words
        return H.from_words(word, depth)

    # -- fused (kernel) datapath: the itp_stdp package ------------------
    def kernel_view(self, state: H.SpikeHistory, *, packed: bool) -> torch.Tensor:
        return H.pack_words(state) if packed else self.readout(state).to(torch.float32)

    def fused_update(self, w, pre_spike, post_spike, pre_read, post_read,
                     p: STDPParams, *, packed, depth, pairing, compensate, eta,
                     w_min, w_max, interpret, po2):
        kw = dict(pairing=pairing, compensate=compensate, eta=eta, w_min=w_min,
                  w_max=w_max, interpret=interpret, po2=po2)
        if packed:  # (*lanes, n) uint8 register words
            return weight_update_packed(w, pre_spike, post_spike, pre_read,
                                        post_read, p, depth=depth, **kw)
        return weight_update_depth_major(w, pre_spike, post_spike, pre_read,
                                         post_read, p, **kw)

    def fused_delta(self, pre_spike, post_spike, pre_read, post_read, p: STDPParams,
                    *, packed, depth, pairing, compensate, interpret, po2):
        kw = dict(pairing=pairing, compensate=compensate, interpret=interpret, po2=po2)
        if packed:
            return synapse_delta_packed(pre_spike, post_spike, pre_read, post_read, p,
                                        depth=depth, **kw)
        return synapse_delta(pre_spike, post_spike, pre_read, post_read, p, **kw)

    # -- conv datapath: the itp_stdp_conv package ------------------------
    def patch_delta(self, pre_patches, post_spikes, pre_read, post_read, p: STDPParams,
                    *, packed, depth, pairing, compensate, use_kernel, interpret, po2):
        kw = dict(pairing=pairing, compensate=compensate, use_kernel=use_kernel,
                  interpret=interpret, po2=po2)
        if packed:  # (M, K) / (M, C) uint8 register words
            return conv_synapse_delta_packed(pre_patches, post_spikes, pre_read,
                                             post_read, p, depth=depth, **kw)
        return conv_synapse_delta(pre_patches, post_spikes, pre_read, post_read, p, **kw)


ITP = register_rule(HistoryRule(name="itp", compensate=None))
ITP_NOCOMP = register_rule(HistoryRule(name="itp_nocomp", compensate=False))
