"""LIF neuron, exact float path (port of ``repro.core.lif``).

``lif_step`` is plain tensor arithmetic, as in the reference, where it does
not reach the ``kernels/lif`` Pallas kernel.  The LLSMU fixed-point step and
the Izhikevich neuron come with a later slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class LIFParams:
    tau: float = 2.0          # membrane time constant (steps)
    v_th: float = 1.0         # firing threshold
    e_rest: float = 0.0       # resting potential

    @property
    def alpha(self) -> float:
        return math.exp(-1.0 / self.tau)


class LIFState(NamedTuple):
    v: torch.Tensor


def lif_init(shape, p: LIFParams, *,
             device: torch.device | str | None = None) -> LIFState:
    return LIFState(v=torch.full(shape, p.e_rest, dtype=torch.float32, device=device))


def lif_step(state: LIFState, i_in: torch.Tensor, p: LIFParams,
             v_th_offset: torch.Tensor | float = 0.0
             ) -> tuple[LIFState, torch.Tensor]:
    """Exact LIF update (eq. 4) + threshold/reset (eq. 5).

    ``v_th_offset`` raises the threshold per neuron (the homeostasis term θ,
    broadcast against ``v``).  Returns ``(state', spikes)``, spikes bool.
    """
    v = p.alpha * (state.v - p.e_rest) + p.e_rest + i_in
    spikes = v > p.v_th + v_th_offset
    v = torch.where(spikes, p.e_rest, v)
    return LIFState(v=v), spikes
