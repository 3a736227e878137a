"""The ITP-STDP update on bitplane histories (port of ``repro.core.stdp``).

Only the parts the intrinsic-timing (history) rules use come across in this
slice: the parameters, the po2 read vector, the nearest and all-to-all
magnitude reads, the XOR pair gate and the dense reference update.  The
explicit-Δt windows (``exact``, ``linear``, ``imstdp``) come with the
counter rules.

Histories are ``(..., depth)`` {0,1} with k=0 the current step (the MSB of
the paper's register picture); depth-major registers are ``(..., depth, N)``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

LN2 = math.log(2.0)


@dataclasses.dataclass(frozen=True)
class STDPParams:
    """Pair-based STDP window parameters (paper eq. 1); τ in steps."""

    a_plus: float = 1.0
    a_minus: float = 1.125
    tau_plus: float = 4.0
    tau_minus: float = 4.0

    def compensated(self) -> "STDPParams":
        """τ' = τ·ln2 — the paper's error compensation (eq. 18)."""
        return dataclasses.replace(
            self, tau_plus=self.tau_plus * LN2, tau_minus=self.tau_minus * LN2)


def po2_weights(depth: int, tau: float, *, compensate: bool = True) -> torch.Tensor:
    """The constant po2 read vector ``[2^(-k/τ')]``, float32, on the host.

    Always computed on the CPU: callers build it once (per update plan) and
    move it to their device, so the kernel and its plain version read the
    same bits whatever device they run on.
    """
    tau_eff = tau * LN2 if compensate else tau
    k = torch.arange(depth, dtype=torch.float32)
    return torch.exp2(-k / tau_eff)


def po2_read(po2: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """``Σ_k po2[k] · bits[..., k, :]``, summed k = 0 … depth-1 in float32.

    A fixed-order loop rather than a matrix product, so the sum is taken in
    the order the CUDA kernel takes it and the two agree bit for bit.
    """
    acc = torch.zeros_like(bits[..., 0, :])
    for k in range(bits.shape[-2]):
        acc = acc + po2[k] * bits[..., k, :]
    return acc


def nn_delta_from_history(history: torch.Tensor, amplitude: float, tau: float,
                          *, compensate: bool = True) -> torch.Tensor:
    """Nearest-neighbour magnitude ``A·2^(-k*/τ')``, k* the newest spike."""
    nz = history != 0
    any_spike = nz.any(dim=-1)
    k_star = nz.to(torch.uint8).argmax(dim=-1)      # first (most recent) spike
    w = po2_weights(history.shape[-1], tau, compensate=compensate).to(history.device)
    return torch.where(any_spike, amplitude * w[k_star], 0.0)


def a2a_delta_from_history(history: torch.Tensor, amplitude: float, tau: float,
                           *, compensate: bool = True) -> torch.Tensor:
    """All-to-all magnitude: the history read as a po2 fixed-point fraction."""
    history = history.to(torch.float32)
    w = po2_weights(history.shape[-1], tau, compensate=compensate).to(history.device)
    return (amplitude * history) @ w


def magnitudes_depth_major(planes: torch.Tensor, amplitude: float, tau: float,
                           *, pairing: str = "nearest",
                           compensate: bool = True) -> torch.Tensor:
    """Per-neuron Δw magnitude ``(..., N)`` from ``(..., depth, N)`` registers.

    Nearest pairing keeps only the newest set bit (MSB mask via a
    cumsum-compare along depth); all-to-all reads the raw bits.
    """
    bits = planes.to(torch.float32)
    if pairing == "nearest":
        bits = bits * (torch.cumsum(bits, dim=-2) == 1.0)
    w = po2_weights(bits.shape[-2], tau, compensate=compensate).to(bits.device)
    return amplitude * po2_read(w, bits)


def pair_gate(pre_spike: torch.Tensor, post_spike: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """XOR/AND control logic (§V-A): ``(ltp_en, ltd_en)`` as bool tensors.

    LTP where only the post neuron fired, LTD where only the pre neuron did.
    """
    pre = pre_spike.to(torch.bool)
    post = post_spike.to(torch.bool)
    fire_xor = pre ^ post
    return fire_xor & post, fire_xor & pre


def synapse_update(w: torch.Tensor,
                   pre_spike: torch.Tensor, post_spike: torch.Tensor,
                   pre_hist: torch.Tensor, post_hist: torch.Tensor,
                   p: STDPParams,
                   *,
                   pairing: str = "nearest",
                   compensate: bool = True,
                   eta: float = 1.0,
                   w_min: float = 0.0,
                   w_max: float = 1.0) -> torch.Tensor:
    """One ITP-STDP step on a dense ``(n_pre, n_post)`` matrix (reference).

    ``pre_hist``: ``(n_pre, depth)``, ``post_hist``: ``(n_post, depth)``
    bitplanes, k=0 most recent.
    """
    if pairing == "nearest":
        read = nn_delta_from_history
    elif pairing == "all":
        read = a2a_delta_from_history
    else:
        raise ValueError(f"pairing must be 'nearest' or 'all', got {pairing!r}")
    ltp_mag = read(pre_hist, p.a_plus, p.tau_plus, compensate=compensate)
    ltd_mag = read(post_hist, p.a_minus, p.tau_minus, compensate=compensate)
    ltp_en, ltd_en = pair_gate(pre_spike[:, None], post_spike[None, :])
    dw = ltp_en * ltp_mag[:, None] - ltd_en * ltd_mag[None, :]
    return torch.clamp(w + eta * dw, w_min, w_max)
