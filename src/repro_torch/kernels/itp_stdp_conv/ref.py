"""Plain PyTorch version of the im2col ITP-STDP conv kernel (port of
``repro.kernels.itp_stdp_conv.ref``).

The magnitudes repeat the CUDA kernel's arithmetic (nearest mask by cumsum,
the po2 read summed k = 0 … depth-1 in float32 by ``core.stdp.po2_read``),
so they are bit-equal to the kernel's.  Spikes are {0,1}, so every product
of the two contractions over the M patch rows is exact and only their sums
round.  The terms are float32 values spanning a few binades, so float64
holds their sums exactly: this version contracts in float64 and rounds the
(K, C) delta to float32 once, as the kernel does, and the two agree bit for
bit whatever M is and in whatever order the rows are summed.  Against the
JAX reference, whose einsums sum in float32, they agree within
``atol=1e-4, rtol=1e-5`` (the reference's own kernel-vs-oracle tolerance).

Shapes: pre patches ``(M, K)``, post spikes ``(M, C)``, bitplanes
``(depth, M, K)`` / ``(depth, M, C)`` with the k=0 row newest, words ``(M, K)`` / ``(M, C)`` uint8, po2 read vectors
``(depth,)`` with the amplitudes folded in; the result is the raw ``(K, C)``
delta summed over M, with no normalisation, clip or quantisation.
"""
from __future__ import annotations

import torch

from repro_torch.core.history import unpack_words
from repro_torch.core.stdp import po2_read


def gated_contraction(pre: torch.Tensor, post: torch.Tensor, ltp_mag: torch.Tensor,
                      ltd_mag: torch.Tensor) -> torch.Tensor:
    """``Σ_m ((1−pre)·ltp_mag)ᵀ·post − preᵀ·((1−post)·ltd_mag)`` over the M
    rows of ``(M, K)`` pre / ltp and ``(M, C)`` post / ltd float32 operands:
    potentiate where post fired alone, depress where pre fired alone, per
    (K, C) synapse.  Contracted in float64 (exact for {0,1} spikes) and
    rounded to float32 once."""
    f64 = torch.float64
    dw_ltp = ((1.0 - pre) * ltp_mag).to(f64).T @ post.to(f64)
    dw_ltd = pre.to(f64).T @ ((1.0 - post) * ltd_mag).to(f64)
    return (dw_ltp - dw_ltd).to(torch.float32)


def itp_stdp_conv_delta_ref(pre_patches: torch.Tensor, post_spikes: torch.Tensor,
                            pre_bits: torch.Tensor, post_bits: torch.Tensor,
                            po2_ltp: torch.Tensor, po2_ltd: torch.Tensor,
                            *, nearest: bool = True) -> torch.Tensor:
    """Reference semantics of the bitplane-fed conv kernel."""
    pre_b = pre_bits.to(torch.float32)
    post_b = post_bits.to(torch.float32)
    if nearest:
        # MSB mask (paper Fig. 11): keep only the most recent spike bit
        pre_b = pre_b * (torch.cumsum(pre_b, dim=0) == 1.0)
        post_b = post_b * (torch.cumsum(post_b, dim=0) == 1.0)
    ltp_mag = po2_read(po2_ltp.to(torch.float32), pre_b.movedim(0, -2))    # (M, K)
    ltd_mag = po2_read(po2_ltd.to(torch.float32), post_b.movedim(0, -2))  # (M, C)
    return gated_contraction(pre_patches.to(torch.float32), post_spikes.to(torch.float32),
                             ltp_mag, ltd_mag)


def itp_stdp_conv_delta_packed_ref(pre_patches: torch.Tensor, post_spikes: torch.Tensor,
                                   pre_words: torch.Tensor, post_words: torch.Tensor,
                                   po2_ltp: torch.Tensor, po2_ltd: torch.Tensor,
                                   *, depth: int, nearest: bool = True) -> torch.Tensor:
    """Reference semantics of the word-fed conv kernel: unpack, then the same body."""
    return itp_stdp_conv_delta_ref(
        pre_patches, post_spikes,
        unpack_words(pre_words, depth).permute(2, 0, 1),
        unpack_words(post_words, depth).permute(2, 0, 1),
        po2_ltp, po2_ltd, nearest=nearest)
