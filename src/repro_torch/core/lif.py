"""Neuron models (port of ``repro.core.lif``): the exact-float LIF step
(paper eqs. 4-5) and the Izhikevich neuron of the 6-layer DCSNN (§IV-C).

Both are plain tensor arithmetic, as in the reference, where they do not
reach the ``kernels/lif`` Pallas kernel.  The LLSMU fixed-point LIF step
comes with a later slice (ROADMAP queue 1 item 14).
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


# ---------------------------------------------------------------------------
# Izhikevich neuron (used by the 6-layer DCSNN in §IV-C)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class IzhikevichParams:
    a: float = 0.02
    b: float = 0.2
    c: float = -65.0
    d: float = 8.0
    v_th: float = 30.0
    dt: float = 1.0


class IzhikevichState(NamedTuple):
    v: torch.Tensor
    u: torch.Tensor


def izhikevich_init(shape, p: IzhikevichParams, *,
                    device: torch.device | str | None = None) -> IzhikevichState:
    v = torch.full(shape, p.c, dtype=torch.float32, device=device)
    return IzhikevichState(v=v, u=p.b * v)


def izhikevich_step(state: IzhikevichState, i_in: torch.Tensor, p: IzhikevichParams,
                    v_th_offset: torch.Tensor | float = 0.0
                    ) -> tuple[IzhikevichState, torch.Tensor]:
    """One Euler step; ``v_th_offset`` is the per-neuron threshold term θ
    (broadcast against ``v``).  Returns ``(state', spikes)``, spikes bool.

    The operations run in the reference's order, each rounded to float32.
    """
    v, u = state.v, state.u
    dv = 0.04 * v * v + 5.0 * v + 140.0 - u + i_in
    du = p.a * (p.b * v - u)
    v = v + p.dt * dv
    u = u + p.dt * du
    v_th = p.v_th + v_th_offset
    spikes = v >= v_th
    v = torch.where(spikes, p.c, v)
    u = torch.where(spikes, u + p.d, u)
    # clamp against Euler blow-up at large dt; the ceiling tracks the
    # effective (homeostasis-raised) threshold
    v = torch.clamp(v, min=-120.0)
    v = torch.minimum(v, v_th) if isinstance(v_th, torch.Tensor) else torch.clamp(v, max=v_th)
    return IzhikevichState(v=v, u=u), spikes
