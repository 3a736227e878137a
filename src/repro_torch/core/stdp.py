"""The STDP rule family and the ITP-STDP update on bitplane histories (port
of ``repro.core.stdp``).

The explicit-Δt windows (paper eqs. 17-20: ``exact``, ``itp``,
``itp_nocomp``, ``linear``, ``imstdp``) map a timing difference to a weight
increment; the history part (the po2 read vector, the nearest and
all-to-all magnitude reads, the XOR pair gate, the dense reference update)
is what the intrinsic-timing rules run on.  The base-e and PWL windows round
as IEEE float32 arithmetic does, one operation at a time (each step taken
in float64 on float32 operands and rounded once; ``exp`` taken in float64
and rounded once), so they give the same bits on any device; the counter
rules' windows (``kernels/itp_counter/ref.py``) are built from them.

Histories are ``(..., depth)`` {0,1} with k=0 the current step (the MSB of
the paper's register picture); depth-major registers are ``(..., depth, N)``.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Callable

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


def f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float."""
    return torch.tensor(x, dtype=torch.float32).item()


def _quotient(x: torch.Tensor, c: float) -> torch.Tensor:
    """The float32 quotient ``x / c``, correctly rounded.  The divisor is a
    tensor: for a Python scalar PyTorch's CUDA kernel multiplies by the
    reciprocal instead."""
    c64 = torch.full_like(x, f32(c), dtype=torch.float64)
    return (x.to(torch.float64) / c64).to(torch.float32)


def _times(x: torch.Tensor, amplitude: float) -> torch.Tensor:
    return (x.to(torch.float64) * f32(amplitude)).to(torch.float32)


def exp_decay(dt: torch.Tensor, amplitude: float, tau: float) -> torch.Tensor:
    """``A·exp(−dt/τ)``: the float32 quotient, its exp rounded once, times A."""
    e = torch.exp(_quotient(-dt, tau).to(torch.float64)).to(torch.float32)
    return _times(e, amplitude)


def pwl_decay(dt: torch.Tensor, amplitude: float, width: float) -> torch.Tensor:
    """``A·clip(1 − dt/width, 0, 1)``: the linear decay of [24]."""
    x = (1.0 - _quotient(dt, width).to(torch.float64)).to(torch.float32)
    return _times(torch.clamp(x, 0.0, 1.0), amplitude)


# ---------------------------------------------------------------------------
# Rule definitions: each maps dt = t_post - t_pre to Δw elementwise (positive
# dt → LTP, negative → LTD).
# ---------------------------------------------------------------------------

def exact_stdp(dt: torch.Tensor, p: STDPParams) -> torch.Tensor:
    """Original STDP, base-e exponential (paper eq. 17)."""
    dt = torch.as_tensor(dt, dtype=torch.float32)
    ltp = exp_decay(dt, p.a_plus, p.tau_plus)
    ltd = -exp_decay(-dt, p.a_minus, p.tau_minus)
    return torch.where(dt >= 0, ltp, ltd)


def itp_stdp(dt: torch.Tensor, p: STDPParams, *, compensate: bool = True) -> torch.Tensor:
    """ITP-STDP, base-2 exponential (paper eq. 20); ``compensate=True``
    applies τ' = τ·ln2 first (eq. 18), which makes it :func:`exact_stdp`."""
    if compensate:
        p = p.compensated()
    dt = torch.as_tensor(dt, dtype=torch.float32)
    ltp = p.a_plus * torch.exp2(-dt / p.tau_plus)
    ltd = -p.a_minus * torch.exp2(dt / p.tau_minus)
    return torch.where(dt >= 0, ltp, ltd)


def linear_stdp(dt: torch.Tensor, p: STDPParams, *,
                window: float | None = None) -> torch.Tensor:
    """PWL baseline of [24]: linear decay to zero at the window edge
    (default 2τ, where ``A·(1 − dt/(2τ))`` crosses zero)."""
    dt = torch.as_tensor(dt, dtype=torch.float32)
    wp = window if window is not None else 2.0 * p.tau_plus
    wm = window if window is not None else 2.0 * p.tau_minus
    ltp = pwl_decay(dt, p.a_plus, wp)
    ltd = -pwl_decay(-dt, p.a_minus, wm)
    return torch.where(dt >= 0, ltp, ltd)


def make_imstdp_lut(p: STDPParams, depth: int = 8) -> torch.Tensor:
    """The precomputed LUT of [23]: index k ∈ [0, depth) holds LTP(k), index
    depth+k holds LTD(−k)."""
    k = torch.arange(depth, dtype=torch.float32)
    return torch.cat([exp_decay(k, p.a_plus, p.tau_plus),
                      -exp_decay(k, p.a_minus, p.tau_minus)])


def imstdp(dt: torch.Tensor, p: STDPParams, *, depth: int = 8) -> torch.Tensor:
    """ImSTDP baseline: floor |dt| onto the integer index grid and look it
    up (the uncompensated timing error the paper criticises in §I)."""
    dt = torch.as_tensor(dt, dtype=torch.float32)
    lut = make_imstdp_lut(p, depth).to(dt.device)
    k = torch.clamp(torch.floor(torch.abs(dt)).to(torch.int64), 0, depth - 1)
    return lut[torch.where(dt >= 0, k, depth + k)]


RULES: dict[str, Callable[..., torch.Tensor]] = {
    "exact": exact_stdp,
    "itp": itp_stdp,
    "itp_nocomp": partial(itp_stdp, compensate=False),
    "linear": linear_stdp,
    "imstdp": imstdp,
}


def get_rule(name: str) -> Callable[..., torch.Tensor]:
    try:
        return RULES[name]
    except KeyError as e:
        raise ValueError(f"unknown STDP rule {name!r}; have {sorted(RULES)}") from e


# ---------------------------------------------------------------------------
# Power-of-two weight-update primitives on bitplane spike histories
# ---------------------------------------------------------------------------

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
