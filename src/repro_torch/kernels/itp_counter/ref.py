"""Plain PyTorch version of the fused counter-rule (explicit-Δt STDP) kernels
(port of ``repro.kernels.itp_counter.ref``).

The conventional datapath the paper's Tables III-V measure ITP-STDP
against: a per-neuron last-spike counter, the per-pair timing difference
Δt, and a window function evaluated per pair.  Three windows:

  * ``exact``  — ``A·exp(−Δt/τ)``, the base-e exponential of original STDP;
  * ``linear`` — ``A·clip(1 − Δt/(2τ), 0, 1)``, the PWL rule of [24];
  * ``imstdp`` — ``lut[Δt]``, the integer-grid LUT of [23], built with the
                 ``exact`` formula (:func:`window_lut`).

A counter at value t means the neuron last spiked t steps ago; counters
saturate at ``depth`` and the validity gate ``t <= depth − 1`` zeroes every
saturated one.

Every window rounds as IEEE float32 arithmetic does, one operation at a
time (``core.stdp.exp_decay`` / ``pwl_decay``): each step is taken in
float64 on float32 operands and rounded to float32 once, which gives the
correctly rounded float32 sum, difference, product or quotient (float64
carries more than twice float32's 24 bits), so no device's shortcut (such
as a reciprocal multiply in place of a division by a scalar) changes a bit.
The exponential is taken in float64 and rounded once, as the CUDA kernel
takes it.  At the default τ = 4 these
are the JAX package's values bit for bit up to depth 8; at other τ, and
for the exponential of large delays, XLA's compiled division and ``exp``
move the last bit of some entries (ROADMAP queue 3).

Shapes: the dense update takes optional leading lane axes, ``w``
``(*lanes, n_pre, n_post)``, spikes and counters ``(*lanes, n)``; the conv
delta takes ``(M, K)`` / ``(M, C)`` im2col spikes and counters, the fc delta
``(B, n_pre)`` / ``(B, n_post)``.  ``lut`` is
the ``(2, depth)`` float32 table of :func:`window_lut` rows (LTP, LTD) that
the imstdp window reads; when omitted it is built here.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.stdp import exp_decay, pair_gate, pwl_decay
from repro_torch.device import eager
from repro_torch.kernels.itp_stdp_conv.ref import gated_contraction


def window_exact(dt: torch.Tensor, amplitude: float, tau: float, depth: int) -> torch.Tensor:
    """``A·exp(−dt/τ)``: the float32 quotient, its exp rounded once, times A."""
    del depth
    return exp_decay(dt, amplitude, tau)


def window_linear(dt: torch.Tensor, amplitude: float, tau: float, depth: int) -> torch.Tensor:
    """PWL of [24]: value and slope matched at dt = 0, zero at the 2τ edge."""
    del depth
    return pwl_decay(dt, amplitude, 2.0 * tau)


@functools.lru_cache(maxsize=64)
@eager
def window_lut(amplitude: float, tau: float, depth: int,
               device: torch.device | str | None = None) -> torch.Tensor:
    """The [23] LUT on the integer delay grid, one entry per valid delay
    ``0 … depth−1``, with the exact window's formula.  Built on the host and
    moved to ``device``; cached, so every caller reads the same tensor (never
    write to it)."""
    lut = window_exact(torch.arange(depth, dtype=torch.float32), amplitude, tau, depth)
    return lut.to(device)


def window_imstdp(dt: torch.Tensor, amplitude: float, tau: float, depth: int,
                  lut_row: torch.Tensor | None = None) -> torch.Tensor:
    """``lut[clip(dt, 0, depth−1)]``; the validity gate zeroes what the clip
    aliases onto the last entry."""
    if lut_row is None:
        lut_row = window_lut(amplitude, tau, depth, dt.device)
    k = torch.clamp(dt.to(torch.int64), 0, depth - 1)
    return lut_row[k]


WINDOWS = {"exact": window_exact, "linear": window_linear, "imstdp": window_imstdp}


def counter_magnitudes(t: torch.Tensor, amplitude: float, tau: float, *, depth: int,
                       window: str, lut_row: torch.Tensor | None = None) -> torch.Tensor:
    """Per-neuron window magnitude gated by counter validity: ``f(t)·[t < depth]``."""
    valid = t <= depth - 1
    dt = t.to(torch.float32)
    if window == "imstdp":
        mag = window_imstdp(dt, amplitude, tau, depth, lut_row)
    else:
        mag = WINDOWS[window](dt, amplitude, tau, depth)
    return mag * valid


def _magnitudes(pre_t, post_t, *, depth, window, a_plus, a_minus, tau_plus, tau_minus,
                lut):
    rows = (None, None) if lut is None else (lut[0], lut[1])
    ltp = counter_magnitudes(pre_t.to(torch.int32), a_plus, tau_plus, depth=depth,
                             window=window, lut_row=rows[0])
    ltd = counter_magnitudes(post_t.to(torch.int32), a_minus, tau_minus, depth=depth,
                             window=window, lut_row=rows[1])
    return ltp, ltd


def counter_stdp_update_ref(w: torch.Tensor,
                            pre_spike: torch.Tensor, post_spike: torch.Tensor,
                            pre_t: torch.Tensor, post_t: torch.Tensor,
                            *,
                            depth: int,
                            window: str,
                            a_plus: float,
                            a_minus: float,
                            tau_plus: float,
                            tau_minus: float,
                            eta: float = 1.0,
                            w_min: float = 0.0,
                            w_max: float = 1.0,
                            lut: torch.Tensor | None = None) -> torch.Tensor:
    """Reference semantics of the dense counter kernel:
    ``clip(w + eta·(ltp_en·f+(t_pre) − ltd_en·f−(t_post)), w_min, w_max)``
    with the XOR pair gate on the current spikes."""
    ltp, ltd = _magnitudes(pre_t, post_t, depth=depth, window=window, a_plus=a_plus,
                           a_minus=a_minus, tau_plus=tau_plus, tau_minus=tau_minus,
                           lut=lut)
    ltp_en, ltd_en = pair_gate(pre_spike[..., :, None], post_spike[..., None, :])
    dw = ltp_en * ltp[..., :, None] - ltd_en * ltd[..., None, :]
    return torch.clamp(w.to(torch.float32) + eta * dw, w_min, w_max)


def counter_conv_delta_ref(pre_patches: torch.Tensor, post_spikes: torch.Tensor,
                           pre_t: torch.Tensor, post_t: torch.Tensor,
                           *,
                           depth: int,
                           window: str,
                           a_plus: float,
                           a_minus: float,
                           tau_plus: float,
                           tau_minus: float,
                           lut: torch.Tensor | None = None) -> torch.Tensor:
    """Reference semantics of the conv counter kernel: the window of each
    im2col element's counter, then the pair-gated patch-row contraction
    (float64, rounded once: :func:`gated_contraction`)."""
    ltp, ltd = _magnitudes(pre_t, post_t, depth=depth, window=window, a_plus=a_plus,
                           a_minus=a_minus, tau_plus=tau_plus, tau_minus=tau_minus,
                           lut=lut)
    return gated_contraction(pre_patches.to(torch.float32),
                             post_spikes.to(torch.float32), ltp, ltd)


def counter_fc_delta_ref(pre_spike: torch.Tensor, post_spike: torch.Tensor,
                         pre_t: torch.Tensor, post_t: torch.Tensor,
                         *,
                         depth: int,
                         window: str,
                         a_plus: float,
                         a_minus: float,
                         tau_plus: float,
                         tau_minus: float,
                         lut: torch.Tensor | None = None) -> torch.Tensor:
    """Reference semantics of the fc counter kernel: the per-lane raw delta
    of :func:`counter_stdp_update_ref` (a zero ``w``, ``eta = 1``, no clip)
    over ``(B, n)`` spikes and counters, summed over the B lanes in float64
    and rounded once to the ``(n_pre, n_post)`` float32 delta."""
    zero_w = torch.zeros((*pre_t.shape, post_t.shape[-1]), dtype=torch.float32,
                         device=pre_t.device)
    dw = counter_stdp_update_ref(zero_w, pre_spike, post_spike, pre_t, post_t, depth=depth,
                                 window=window, a_plus=a_plus, a_minus=a_minus,
                                 tau_plus=tau_plus, tau_minus=tau_minus, eta=1.0,
                                 w_min=float("-inf"), w_max=float("inf"), lut=lut)
    return dw.sum(dim=0, dtype=torch.float64).to(torch.float32)
