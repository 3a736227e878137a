"""Neuron models (port of ``repro.core.lif``): the LIF neuron (paper eqs.
4-5) on its two datapaths, and the Izhikevich neuron of the 6-layer DCSNN
(§IV-C).

* ``lif_step``        — exact float path:  V' = α·(V−E) + E + I,  α = e^(−1/τ)
* ``lif_step_llsmu``  — fixed-point path where the α·(V−E) multiply goes
  through the LLSMU approximate multiplier (``kernels.llsmu``), as in the
  paper's learning engine (Fig. 9).  V is kept in Q(``frac_bits``) integers.

``lif_step`` and the Izhikevich step are plain tensor arithmetic, as in the
reference; ``kernels.lif.ops.lif_step_kernel`` is the kernel-backed drop-in
for ``lif_step`` without a threshold offset.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.kernels.llsmu.ops import llsmu


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


class LIFFixedState(NamedTuple):
    v_q: torch.Tensor  # int32, Q(frac_bits)


def lif_fixed_init(shape, p: LIFParams, frac_bits: int = 8, *,
                   device: torch.device | str | None = None) -> LIFFixedState:
    e_q = round(p.e_rest * (1 << frac_bits))
    return LIFFixedState(v_q=torch.full(shape, e_q, dtype=torch.int32, device=device))


def lif_step_llsmu(state: LIFFixedState, i_in: torch.Tensor, p: LIFParams, *,
                   frac_bits: int = 8, use_kernel: bool = True
                   ) -> tuple[LIFFixedState, torch.Tensor]:
    """Hardware-faithful LIF step: the leak multiply uses LLSMU (Fig. 9).

    V is Q(frac_bits) int32; α is quantised to the same format (rounded in
    Python, as the reference); the product α·(V−E) is a Q×Q→Q2 LLSMU multiply
    followed by a truncating shift.  ``i_in`` is a float current, quantised
    on entry (``torch.round`` rounds half to even, as ``jnp.round``).
    ``use_kernel`` is passed to ``kernels.llsmu.ops.llsmu``: the LLSMU kernel
    (its plain version on the CPU), or the reference oracle when False.
    Returns ``(state', spikes)``, spikes bool.
    """
    one = 1 << frac_bits
    alpha_q = round(p.alpha * one)
    e_q = round(p.e_rest * one)
    vth_q = round(p.v_th * one)
    i_q = torch.round(torch.as_tensor(i_in).to(torch.float32) * one).to(torch.int32)

    leak = llsmu(state.v_q - e_q, alpha_q, use_kernel=use_kernel) >> frac_bits
    v_q = leak + e_q + i_q
    spikes = v_q > vth_q
    v_q = torch.where(spikes, e_q, v_q)
    return LIFFixedState(v_q=v_q), spikes


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
