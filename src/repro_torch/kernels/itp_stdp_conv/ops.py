"""Public wrappers of the im2col ITP-STDP conv kernel (port of
``repro.kernels.itp_stdp_conv.ops``).

Bridges the SNN conv layers' state (im2col spike patches and history
registers, ``STDPParams``) to the kernel wrappers of :mod:`.kernel`.  Two
history layouts share the entry-point shape:

  * :func:`conv_synapse_delta_packed` — packed uint8 register words, one
    byte per patch element, gathered into the im2col layout once by
    :func:`im2col_words_2d` / :func:`im2col_words_1d`;
  * :func:`conv_synapse_delta` — depth-major bitplane patches.

Both return the raw ``(K, C)`` delta, so callers own the batch
normalisation, clip and quantisation.  ``use_kernel=False`` is the
reference oracle and ``interpret=True`` the kernel's plain version (the
``fused_interpret`` backend); both run the plain PyTorch arithmetic of
``ref.py`` on whatever device the tensors are on.  Otherwise the kernel
wrapper runs: the CUDA kernel for CUDA tensors, its plain version for CPU
tensors.  Unlike the Pallas wrappers nothing is padded: the CUDA kernel
masks ragged M, K and C itself.

The im2col feature order is ``(kh, kw, c)`` row-major, the reference's (it
transposes ``conv_general_dilated_patches``' ``(c, kh, kw)``).  Every
extractor here is one index gather, so it keeps the input's dtype (uint8
words stay one byte) and is exact for float spikes; the index tensors are
built once per shape and device.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.stdp import STDPParams
from repro_torch.device import eager
from repro_torch.kernels.itp_stdp.ops import Po2Pair, po2_vectors
from repro_torch.kernels.itp_stdp_conv.kernel import (itp_stdp_conv_delta,
                                                      itp_stdp_conv_delta_packed)
from repro_torch.kernels.itp_stdp_conv.ref import (itp_stdp_conv_delta_packed_ref,
                                                   itp_stdp_conv_delta_ref)


@functools.lru_cache(maxsize=64)
@eager
def _index_2d(h: int, w: int, c: int, k: int, stride: int,
              device: torch.device) -> torch.Tensor:
    ho = (h - k) // stride + 1
    wo = (w - k) // stride + 1
    oh = (torch.arange(ho) * stride)[:, None, None, None, None]
    ow = (torch.arange(wo) * stride)[None, :, None, None, None]
    kh = torch.arange(k)[None, None, :, None, None]
    kw = torch.arange(k)[None, None, None, :, None]
    idx = ((oh + kh) * w + (ow + kw)) * c + torch.arange(c)[None, None, None, None, :]
    return idx.reshape(-1).to(device)


@functools.lru_cache(maxsize=64)
@eager
def _index_1d(length: int, c: int, k: int, stride: int,
              device: torch.device) -> torch.Tensor:
    lo = (length - k) // stride + 1
    pos = (torch.arange(lo) * stride)[:, None, None] + torch.arange(k)[None, :, None]
    idx = pos * c + torch.arange(c)[None, None, :]
    return idx.reshape(-1).to(device)


def im2col_words_2d(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, Ho, Wo, k*k*C) dtype-preserving im2col gather."""
    B, H, W, C = x.shape
    ho = (H - k) // stride + 1
    wo = (W - k) // stride + 1
    idx = _index_2d(H, W, C, k, stride, x.device)
    return x.reshape(B, H * W * C)[:, idx].reshape(B, ho, wo, k * k * C)


def im2col_words_1d(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """(B, L, C) -> (B, Lo, k*C) dtype-preserving im2col gather."""
    B, L, C = x.shape
    lo = (L - k) // stride + 1
    idx = _index_1d(L, C, k, stride, x.device)
    return x.reshape(B, L * C)[:, idx].reshape(B, lo, k * C)


def im2col_2d(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, Ho, Wo, k*k*C) float32 im2col patches."""
    return im2col_words_2d(x.to(torch.float32), k, stride)


def im2col_1d(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """(B, L, C) -> (B, Lo, k*C) float32 im2col patches."""
    return im2col_words_1d(x.to(torch.float32), k, stride)


def conv_synapse_delta(pre_patches: torch.Tensor, post_spikes: torch.Tensor,
                       pre_bits: torch.Tensor, post_bits: torch.Tensor,
                       params: STDPParams,
                       *,
                       pairing: str = "nearest",
                       compensate: bool = True,
                       use_kernel: bool = True,
                       interpret: bool = False,
                       po2: Po2Pair | None = None) -> torch.Tensor:
    """Raw ``(K, C)`` conv-layer delta from im2col patches and bitplane
    registers: ``pre_bits`` ``(depth, M, K)`` / ``post_bits`` ``(depth, M, C)``,
    k=0 row newest; M flattens batch × output positions."""
    if po2 is None:
        po2 = po2_vectors(params, pre_bits.shape[0], compensate=compensate,
                          device=pre_patches.device)
    delta = itp_stdp_conv_delta if use_kernel and not interpret else itp_stdp_conv_delta_ref
    return delta(pre_patches, post_spikes, pre_bits, post_bits, *po2,
                 nearest=pairing == "nearest")


def conv_synapse_delta_packed(pre_patches: torch.Tensor, post_spikes: torch.Tensor,
                              pre_words: torch.Tensor, post_words: torch.Tensor,
                              params: STDPParams,
                              *,
                              depth: int,
                              pairing: str = "nearest",
                              compensate: bool = True,
                              use_kernel: bool = True,
                              interpret: bool = False,
                              po2: Po2Pair | None = None) -> torch.Tensor:
    """Raw ``(K, C)`` conv-layer delta from packed ``(M, K)`` / ``(M, C)``
    uint8 history words (MSB = newest): the packed twin of
    :func:`conv_synapse_delta`, bit-identical to it on the kernel path."""
    if po2 is None:
        po2 = po2_vectors(params, depth, compensate=compensate, device=pre_patches.device)
    delta = (itp_stdp_conv_delta_packed if use_kernel and not interpret
             else itp_stdp_conv_delta_packed_ref)
    return delta(pre_patches, post_spikes, pre_words, post_words, *po2, depth=depth,
                 nearest=pairing == "nearest")
