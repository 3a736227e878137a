"""The learning rules (port of ``repro.plasticity.rules``).

``HistoryRule`` — ``itp`` and ``itp_nocomp``, the intrinsic-timing rules:
state is the bitplane spike history; the timing difference is never
computed: the register read is the update (eq. 2 / Fig. 3).  ``itp`` is
compensated by default (eq. 18), ``itp_nocomp`` reads the raw po2 weights.
Its hooks reach the dense kernels (``itp_stdp``: the engine update), the
conv kernel (``itp_stdp_conv``: the conv layers and the SNN fc layers'
batch-summed delta) and the event-driven ops (``itp_sparse``); its
per-lane ``fused_delta`` (kernel 1) is on no program path, and stays as the
per-sample reference the tests hold the fc layers' contraction against.

``CounterRule`` — ``exact``, ``linear`` and ``imstdp``, the paper's
explicit-Δt baselines: state is one saturating last-spike counter per
neuron, and the window (``kernels/itp_counter/ref.py``) is evaluated on the
per-pair Δt.  Its hooks reach the ``itp_counter`` kernels (its fc layers
the per-lane kernel 5 and a batch sum, not the contraction the history
rules' fc layers take); it has no event-driven datapath, so ``sparse``
refuses it at config construction.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import history as H
from repro_torch.core.stdp import STDPParams, magnitudes_depth_major, pair_gate, po2_read
from repro_torch.kernels.itp_counter.ops import (conv_counter_synapse_delta, counter_lut,
                                                 counter_synapse_delta,
                                                 counter_weight_update,
                                                 fc_counter_synapse_delta)
from repro_torch.kernels.itp_counter.ref import counter_magnitudes
from repro_torch.kernels.itp_sparse.ops import (sparse_conv_delta, sparse_synapse_delta,
                                                sparse_weight_update)
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
    has_sparse: bool = True
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
                     w_min, w_max, interpret, po2, table=None):
        del table  # the po2 vectors are the whole read
        kw = dict(pairing=pairing, compensate=compensate, eta=eta, w_min=w_min,
                  w_max=w_max, interpret=interpret, po2=po2)
        if packed:  # (*lanes, n) uint8 register words
            return weight_update_packed(w, pre_spike, post_spike, pre_read,
                                        post_read, p, depth=depth, **kw)
        return weight_update_depth_major(w, pre_spike, post_spike, pre_read,
                                         post_read, p, **kw)

    def fused_delta(self, pre_spike, post_spike, pre_read, post_read, p: STDPParams,
                    *, packed, depth, pairing, compensate, interpret, po2, table=None):
        """Per-lane Δw on kernel 1: no program path calls it (the fc layers
        sum the batch in :meth:`patch_delta`'s kernel); the tests hold that
        contraction to this array's float64 batch sum, bit for bit."""
        del table
        kw = dict(pairing=pairing, compensate=compensate, interpret=interpret, po2=po2)
        if packed:
            return synapse_delta_packed(pre_spike, post_spike, pre_read, post_read, p,
                                        depth=depth, **kw)
        return synapse_delta(pre_spike, post_spike, pre_read, post_read, p, **kw)

    # -- conv datapath: the itp_stdp_conv package ------------------------
    def patch_delta(self, pre_patches, post_spikes, pre_read, post_read, p: STDPParams,
                    *, packed, depth, pairing, compensate, use_kernel, interpret, po2,
                    table=None):
        del table
        kw = dict(pairing=pairing, compensate=compensate, use_kernel=use_kernel,
                  interpret=interpret, po2=po2)
        if packed:  # (M, K) / (M, C) uint8 register words
            return conv_synapse_delta_packed(pre_patches, post_spikes, pre_read,
                                             post_read, p, depth=depth, **kw)
        return conv_synapse_delta(pre_patches, post_spikes, pre_read, post_read, p, **kw)

    # -- event-driven (sparse) datapath: the itp_sparse package -----------
    # The magnitudes are kernel 1's register read of the same views (packed
    # words unpacked, the plan's po2 vectors with the amplitudes folded in),
    # so the sparse update is bit-equal to the fused one while w lies inside
    # the clip window.
    @staticmethod
    def _register_read(view: torch.Tensor, po2: torch.Tensor, *, packed: bool,
                       depth: int, pairing: str) -> torch.Tensor:
        bits = H.unpack_words(view, depth).transpose(-1, -2) if packed else view
        bits = bits.to(torch.float32)
        if pairing == "nearest":
            bits = bits * (torch.cumsum(bits, dim=-2) == 1.0)
        return po2_read(po2, bits)

    def _sparse_magnitudes(self, pre_read, post_read, *, packed, depth, pairing, po2):
        kw = dict(packed=packed, depth=depth, pairing=pairing)
        return (self._register_read(pre_read, po2[0], **kw),
                self._register_read(post_read, po2[1], **kw))

    def sparse_update(self, w, pre_spike, post_spike, pre_read, post_read,
                      p: STDPParams, *, packed, depth, pairing, compensate, eta,
                      w_min, w_max, max_events, po2, table=None, pre_events=None):
        del p, compensate, table  # the plan's po2 vectors carry them
        ltp, ltd = self._sparse_magnitudes(pre_read, post_read, packed=packed,
                                           depth=depth, pairing=pairing, po2=po2)
        return sparse_weight_update(w, pre_spike, post_spike, ltp, ltd, eta=eta,
                                    w_min=w_min, w_max=w_max, max_events=max_events,
                                    pre_events=pre_events)

    def sparse_delta(self, pre_spike, post_spike, pre_read, post_read, p: STDPParams,
                     *, packed, depth, pairing, compensate, max_events, po2, table=None):
        del p, compensate, table
        ltp, ltd = self._sparse_magnitudes(pre_read, post_read, packed=packed,
                                           depth=depth, pairing=pairing, po2=po2)
        return sparse_synapse_delta(pre_spike, post_spike, ltp, ltd, max_events=max_events)

    def sparse_patch_delta(self, pre_patches, post_spikes, pre_read, post_read,
                           p: STDPParams, *, depth, pairing, compensate, max_events,
                           po2, table=None):
        del p, depth, compensate, table
        return sparse_conv_delta(pre_patches, post_spikes, pre_read, post_read, *po2,
                                 nearest=pairing == "nearest", max_events=max_events)


@dataclasses.dataclass(frozen=True)
class CounterRule(LearningRule):
    """Conventional Δt-based STDP: last-spike counters and a per-pair window.

    Nearest-neighbour only (one counter holds one spike time).  A counter
    saturates at ``depth``, one past the last valid delay ``depth − 1``,
    mirroring the finite history window of the po2 rules.  State is an
    int32 ``(*lanes, n)`` counter; its word — one uint8 per neuron, the
    same shape as the packed history word whatever the depth (≤ 255) — is
    what the kernels, the sessions and the conv im2col gather carry.  The
    fused backends route to ``kernels/itp_counter``, which forms Δt from the
    word and evaluates the window per synapse, so the comparison against the
    ITP kernels is kernel against kernel.
    """

    name: str = "exact"
    window: str = "exact"
    has_kernel: bool = True
    has_sparse: bool = False
    compensate: bool | None = None

    def init_state(self, n: int, depth: int, *, batch: tuple[int, ...] = (),
                   device: torch.device | str | None = None) -> torch.Tensor:
        # start saturated-invalid: no spike within the window yet
        return torch.full((*batch, n), depth, dtype=torch.int32, device=device)

    def step(self, state: torch.Tensor, spikes: torch.Tensor, *,
             depth: int) -> torch.Tensor:
        fired = torch.as_tensor(spikes, device=state.device).to(torch.bool)
        aged = torch.clamp(state + 1, max=depth)
        return torch.where(fired, 0, aged).to(torch.int32)

    def readout(self, state: torch.Tensor) -> torch.Tensor:
        return state.to(torch.float32).unsqueeze(-2)   # (*lanes, 1, n)

    def read_magnitudes(self, arr: torch.Tensor, amplitude: float, tau: float, *,
                        depth: int, pairing: str = "nearest",
                        compensate: bool = True) -> torch.Tensor:
        self.check_pairing(pairing)
        del compensate  # the windows read τ directly (no po2 read to fix)
        return counter_magnitudes(arr[..., 0, :], amplitude, tau, depth=depth,
                                  window=self.window)

    def last_spikes(self, state: torch.Tensor) -> torch.Tensor:
        return (state == 0).to(torch.float32)

    def check_pairing(self, pairing: str) -> None:
        if pairing != "nearest":
            raise ValueError(
                f"rule {self.name!r} is counter-based (one last-spike time "
                f"per neuron) and supports pairing='nearest' only, got "
                f"{pairing!r}")

    # -- session serialization: the counter word round-trips losslessly -
    def words_per_neuron(self) -> int:
        return 1

    def to_words(self, state: torch.Tensor) -> tuple[torch.Tensor, ...]:
        return (state.to(torch.uint8),)

    def from_words_state(self, words: tuple[torch.Tensor, ...], *,
                         depth: int) -> torch.Tensor:
        del depth  # counters saturate at depth, and the word holds the value
        (word,) = words
        return word.to(torch.int32)

    # -- fused (kernel) datapath: the itp_counter package -----------------
    def read_table(self, p: STDPParams, depth: int, *,
                   device: torch.device | str | None = None) -> torch.Tensor:
        return counter_lut(p, depth, device)   # (2, depth): the imstdp window

    def kernel_view(self, state: torch.Tensor, *, packed: bool) -> torch.Tensor:
        del packed  # one uint8 counter word per neuron is the only layout
        return state.to(torch.uint8)

    def fused_update(self, w, pre_spike, post_spike, pre_read, post_read,
                     p: STDPParams, *, packed, depth, pairing, compensate, eta,
                     w_min, w_max, interpret, po2, table=None):
        self.check_pairing(pairing)
        del packed, compensate, po2
        return counter_weight_update(w, pre_spike, post_spike, pre_read, post_read, p,
                                     depth=depth, window=self.window, eta=eta,
                                     w_min=w_min, w_max=w_max, interpret=interpret,
                                     lut=table)

    def fused_delta(self, pre_spike, post_spike, pre_read, post_read, p: STDPParams,
                    *, packed, depth, pairing, compensate, interpret, po2, table=None):
        self.check_pairing(pairing)
        del packed, compensate, po2
        return counter_synapse_delta(pre_spike, post_spike, pre_read, post_read, p,
                                     depth=depth, window=self.window,
                                     interpret=interpret, lut=table)

    def batch_delta(self, pre_spike, post_spike, pre_read, post_read, p: STDPParams,
                    *, packed, depth, pairing, compensate, interpret, po2, table=None):
        """The fc delta summed over the batch in one counter fc kernel launch:
        every pair of every lane evaluates both windows, the paper's baseline
        datapath that ITP's register read is compared with, so the counter
        rules' fc layers keep the per-pair windows rather than contract
        per-neuron magnitudes; the kernel sums the lanes in float64 in its
        registers, with no per-sample array."""
        self.check_pairing(pairing)
        del packed, compensate, po2
        return fc_counter_synapse_delta(pre_spike, post_spike, pre_read, post_read, p,
                                        depth=depth, window=self.window,
                                        interpret=interpret, lut=table)

    def patch_delta(self, pre_patches, post_spikes, pre_read, post_read, p: STDPParams,
                    *, packed, depth, pairing, compensate, use_kernel, interpret, po2,
                    table=None):
        self.check_pairing(pairing)
        del packed, compensate, po2
        return conv_counter_synapse_delta(pre_patches, post_spikes, pre_read, post_read,
                                          p, depth=depth, window=self.window,
                                          use_kernel=use_kernel, interpret=interpret,
                                          lut=table)

    def delta(self, pre_state: torch.Tensor, post_state: torch.Tensor,
              pre_spikes: torch.Tensor, post_spikes: torch.Tensor, p: STDPParams, *,
              depth: int, pairing: str = "nearest",
              compensate: bool = True) -> torch.Tensor:
        """Deliberately per-pair: Δt is broadcast to the synapse axes and the
        window evaluated there — the conventional datapath the intrinsic-timing
        representation collapses to a register read."""
        self.check_pairing(pairing)
        kw = dict(depth=depth, window=self.window)
        ltp_mag = counter_magnitudes(pre_state[..., :, None], p.a_plus, p.tau_plus, **kw)
        ltd_mag = counter_magnitudes(post_state[..., None, :], p.a_minus, p.tau_minus, **kw)
        ltp_en, ltd_en = pair_gate(pre_spikes[..., :, None], post_spikes[..., None, :])
        return ltp_en * ltp_mag - ltd_en * ltd_mag


ITP = register_rule(HistoryRule(name="itp", compensate=None))
ITP_NOCOMP = register_rule(HistoryRule(name="itp_nocomp", compensate=False))
EXACT = register_rule(CounterRule(name="exact", window="exact"))
LINEAR = register_rule(CounterRule(name="linear", window="linear"))
IMSTDP = register_rule(CounterRule(name="imstdp", window="imstdp"))
