"""Plain PyTorch version of the fused ITP-STDP kernel (port of
``repro.kernels.itp_stdp.ref``).

It repeats the CUDA kernel's arithmetic step for step — nearest mask by
cumsum, the po2 read summed k = 0 … depth-1 in float32, the gated rank-1
delta, ``clip(w + eta·dw)`` rounded after each operation — so the kernel is
held against it bit for bit.  Shapes carry optional leading lane axes:
``w`` ``(*lanes, n_pre, n_post)``, spikes ``(*lanes, n)``, bitplanes
``(*lanes, depth, n)`` (k=0 row newest), words ``(*lanes, n)`` uint8, po2
vectors ``(depth,)``.
"""
from __future__ import annotations

import torch

from repro_torch.core.history import unpack_words
from repro_torch.core.stdp import pair_gate, po2_read


def itp_stdp_update_ref(w: torch.Tensor,
                        pre_spike: torch.Tensor, post_spike: torch.Tensor,
                        pre_hist: torch.Tensor, post_hist: torch.Tensor,
                        po2_ltp: torch.Tensor, po2_ltd: torch.Tensor,
                        *,
                        nearest: bool = True,
                        eta: float = 1.0,
                        w_min: float = 0.0,
                        w_max: float = 1.0) -> torch.Tensor:
    """Reference semantics of the bitplane-fed kernel."""
    pre_bits = pre_hist.to(torch.float32)
    post_bits = post_hist.to(torch.float32)
    if nearest:
        pre_bits = pre_bits * (torch.cumsum(pre_bits, dim=-2) == 1.0)
        post_bits = post_bits * (torch.cumsum(post_bits, dim=-2) == 1.0)
    ltp_mag = po2_read(po2_ltp.to(torch.float32), pre_bits)     # (*lanes, n_pre)
    ltd_mag = po2_read(po2_ltd.to(torch.float32), post_bits)    # (*lanes, n_post)
    ltp_en, ltd_en = pair_gate(pre_spike[..., :, None], post_spike[..., None, :])
    dw = ltp_en * ltp_mag[..., :, None] - ltd_en * ltd_mag[..., None, :]
    return torch.clamp(w.to(torch.float32) + eta * dw, w_min, w_max)


def itp_stdp_update_packed_ref(w: torch.Tensor,
                               pre_spike: torch.Tensor, post_spike: torch.Tensor,
                               pre_words: torch.Tensor, post_words: torch.Tensor,
                               po2_ltp: torch.Tensor, po2_ltd: torch.Tensor,
                               *,
                               depth: int,
                               nearest: bool = True,
                               eta: float = 1.0,
                               w_min: float = 0.0,
                               w_max: float = 1.0) -> torch.Tensor:
    """Reference semantics of the word-fed kernel: unpack, then the same body."""
    return itp_stdp_update_ref(
        w, pre_spike, post_spike,
        unpack_words(pre_words, depth).transpose(-1, -2),
        unpack_words(post_words, depth).transpose(-1, -2),
        po2_ltp, po2_ltd, nearest=nearest, eta=eta, w_min=w_min, w_max=w_max)
