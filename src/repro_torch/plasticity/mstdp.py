"""Reward-modulated ITP-STDP, ``rule="mstdp"`` (port of
``repro.plasticity.mstdp``).

Each neuron carries one uint8 *eligibility word* beside its bitplane spike
history: a spike injects a fixed credit, and every step halves the word (one
right shift, the shift-only arithmetic of the po2 magnitudes).  The
magnitude is ``reward · (elig / 128) · m_itp``, a per-neuron scale on the
register read, so the update stays the pair-gated rank-1 outer product and
the rule rides :class:`~repro_torch.plasticity.base.Rank1Rule` onto every
backend with no kernel of its own: kernels 2 and 4 read its magnitudes as a
depth-1 plane, and the sparse backend scatters them.

``reward`` is a field of the frozen rule: ``dataclasses.replace(MSTDP,
reward=r)`` and re-registration swap it between episodes.  The registered
default, 1.0, leaves mstdp an eligibility-gated ITP-STDP.  State per neuron:
the history word and the eligibility word, 2 bytes in the serving store.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import history as H
from repro_torch.core.stdp import magnitudes_depth_major
from repro_torch.plasticity.base import Rank1Rule, register_rule

# A spike injects 64 (0.5 in the /128 read) and each step halves the word;
# saturating at 127 keeps decayed (<= 63) + inject (64) inside the uint8
# word, so it never wraps.
ELIG_INJECT = 64
ELIG_MAX = 127
ELIG_SCALE = 128.0  # fixed-point denominator of the eligibility read


class MSTDPState(NamedTuple):
    """Per-population timing state: the bitplane history and the eligibility."""

    hist: H.SpikeHistory     # the same registers as rule="itp"
    elig: torch.Tensor       # (*lanes, n) uint8 eligibility


@dataclasses.dataclass(frozen=True)
class MSTDPRule(Rank1Rule):
    """Reward-modulated intrinsic-timing rule (slim protocol only)."""

    name: str = "mstdp"
    compensate: bool | None = None  # defer to the config flag, like itp
    reward: float = 1.0

    def init_state(self, n: int, depth: int, *, batch: tuple[int, ...] = (),
                   device: torch.device | str | None = None) -> MSTDPState:
        return MSTDPState(H.init_history(n, depth, batch=batch, device=device),
                          torch.zeros((*batch, n), dtype=torch.uint8, device=device))

    def step(self, state: MSTDPState, spikes: torch.Tensor, *, depth: int) -> MSTDPState:
        del depth  # the state carries it
        fired = torch.as_tensor(spikes, device=state.elig.device).to(torch.uint8)
        elig = torch.clamp((state.elig >> 1) + fired * ELIG_INJECT, max=ELIG_MAX)
        return MSTDPState(H.push(state.hist, spikes), elig)

    def readout(self, state: MSTDPState) -> torch.Tensor:
        # (*lanes, depth + 1, n) uint8: the registers (k=0 newest), then elig
        regs = H.registers_depth_major(state.hist)
        return torch.cat([regs, state.elig.unsqueeze(-2)], dim=-2)

    def read_magnitudes(self, arr: torch.Tensor, amplitude: float, tau: float, *,
                        depth: int, pairing: str = "nearest",
                        compensate: bool = True) -> torch.Tensor:
        del depth  # the history rows are all rows but the last
        base = magnitudes_depth_major(arr[..., :-1, :], amplitude, tau, pairing=pairing,
                                      compensate=compensate)
        elig = arr[..., -1, :].to(torch.float32) / ELIG_SCALE
        return self.reward * elig * base

    def last_spikes(self, state: MSTDPState) -> torch.Tensor:
        return H.latest(state.hist).to(torch.float32)

    # -- session serialization: the history word and the eligibility word --
    def words_per_neuron(self) -> int:
        return 2

    def to_words(self, state: MSTDPState) -> tuple[torch.Tensor, ...]:
        return (H.pack_words(state.hist), state.elig)

    def from_words_state(self, words: tuple[torch.Tensor, ...], *,
                         depth: int) -> MSTDPState:
        hist_word, elig = words
        return MSTDPState(H.from_words(hist_word, depth), elig.to(torch.uint8))


MSTDP = register_rule(MSTDPRule())
