"""Wrappers of the im2col ITP-STDP conv CUDA kernels (``csrc/itp_stdp_conv.cu``).

Port of the Pallas kernels in ``repro/kernels/itp_stdp_conv/kernel.py``:
``itp_stdp_conv_delta_packed`` (one uint8 history word per patch element /
output neuron) and ``itp_stdp_conv_delta`` (depth-major float32 bitplanes).
Both share one CUDA device body, launched once per call as a cooperative
grid that fills the card: each block sums its rows exactly in double, and
the blocks' partials are added in a fixed order after a grid sync, in the
same kernel.  So the packed and unpacked kernels, two runs, and the plain
version all agree bit for bit.  See the source for the design and its bound.

A wrapper given CPU tensors runs the kernel's plain version (``ref.py``);
given CUDA tensors it launches the kernel on the current stream or raises —
there is no fallback.  Each wrapper counts its calls that launch the kernel
in a plain integer attribute, ``<wrapper>.launches``, which callers may
reset to 0.

Shapes: pre patches ``(M, K)``, post spikes ``(M, C)`` (any dtype, read as
float32), words ``(M, K)`` / ``(M, C)`` uint8 or bitplanes ``(depth, M, K)``
/ ``(depth, M, C)`` float32, po2 read vectors ``(depth,)`` float32.  The
result is the raw ``(K, C)`` float32 delta summed over the M rows.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.itp_stdp_conv.ref import (itp_stdp_conv_delta_packed_ref,
                                                   itp_stdp_conv_delta_ref)

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    lib = _build.library("itp_stdp_conv")
    for name in ("itp_stdp_conv_delta_packed", "itp_stdp_conv_delta"):
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    lib.itp_stdp_conv_max_splits.argtypes = [ctypes.c_int] * 3
    lib.itp_stdp_conv_max_splits.restype = ctypes.c_int
    lib.itp_stdp_conv_error_string.argtypes = [ctypes.c_int]
    lib.itp_stdp_conv_error_string.restype = ctypes.c_char_p
    return lib


def _launch(symbol: str, pre: torch.Tensor, post: torch.Tensor,
            pre_hist: torch.Tensor, post_hist: torch.Tensor, po2_ltp: torch.Tensor,
            po2_ltd: torch.Tensor, *, depth: int, hist_dtype: torch.dtype,
            nearest: bool) -> torch.Tensor:
    dev = pre.device
    if dev.type != "cuda":
        raise ValueError(f"{symbol}: tensors must be on a CUDA device or the CPU, got {dev}")
    args = {"post_spikes": post, "pre_hist": pre_hist, "post_hist": post_hist,
            "po2_ltp": po2_ltp, "po2_ltd": po2_ltd}
    for name, t in args.items():
        if t.device != dev:
            raise ValueError(f"{symbol}: {name} is on {t.device}, pre_patches on {dev}")
    if pre.dim() != 2 or post.dim() != 2:
        raise ValueError(f"{symbol}: spikes must be (M, K) and (M, C), got "
                         f"{tuple(pre.shape)} and {tuple(post.shape)}")
    if pre_hist.dtype != hist_dtype or post_hist.dtype != hist_dtype:
        raise TypeError(f"{symbol}: history operands must be {hist_dtype}, got "
                        f"{pre_hist.dtype}/{post_hist.dtype}")
    (m, k), c = pre.shape, post.shape[1]
    words = hist_dtype == torch.uint8
    want = {"post_spikes": (m, c),
            "pre_hist": (m, k) if words else (depth, m, k),
            "post_hist": (m, c) if words else (depth, m, c),
            "po2_ltp": (depth,), "po2_ltd": (depth,)}
    for name, shape in want.items():
        if tuple(args[name].shape) != shape:
            raise ValueError(f"{symbol}: {name} has shape {tuple(args[name].shape)}, "
                             f"expected {shape}")
    if po2_ltp.dtype != torch.float32 or po2_ltd.dtype != torch.float32:
        raise TypeError(f"{symbol}: po2 vectors must be float32")

    pre = pre.to(torch.float32).contiguous()
    post = post.to(torch.float32).contiguous()
    pre_hist, post_hist = pre_hist.contiguous(), post_hist.contiguous()
    po2_ltp, po2_ltd = po2_ltp.contiguous(), po2_ltd.contiguous()
    lib = _lib()
    out = torch.empty((k, c), dtype=torch.float32, device=dev)
    # the blocks' float64 partials: every slot the launch reads it first writes
    partial = torch.empty((lib.itp_stdp_conv_max_splits(m, k, c) * k * c,),
                          dtype=torch.float64, device=dev)
    rc = getattr(lib, symbol)(
        out.data_ptr(), partial.data_ptr(), pre.data_ptr(), post.data_ptr(),
        pre_hist.data_ptr(), post_hist.data_ptr(), po2_ltp.data_ptr(),
        po2_ltd.data_ptr(), m, k, c, depth, int(nearest),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{symbol}: CUDA launch failed: "
                           f"{lib.itp_stdp_conv_error_string(rc).decode()}")
    return out


def itp_stdp_conv_delta_packed(pre_patches: torch.Tensor, post_spikes: torch.Tensor,
                               pre_words: torch.Tensor, post_words: torch.Tensor,
                               po2_ltp: torch.Tensor, po2_ltd: torch.Tensor,
                               *, depth: int, nearest: bool = True) -> torch.Tensor:
    """Raw ``(K, C)`` conv delta fed by packed uint8 history words (depth ≤ 8)."""
    if not 1 <= depth <= 8:
        raise ValueError(f"packed history words support 1 <= depth <= 8, got {depth}")
    if pre_patches.device.type == "cpu":
        return itp_stdp_conv_delta_packed_ref(pre_patches, post_spikes, pre_words,
                                              post_words, po2_ltp, po2_ltd,
                                              depth=depth, nearest=nearest)
    out = _launch("itp_stdp_conv_delta_packed", pre_patches, post_spikes, pre_words,
                  post_words, po2_ltp, po2_ltd, depth=depth, hist_dtype=torch.uint8,
                  nearest=nearest)
    itp_stdp_conv_delta_packed.launches += 1
    return out


def itp_stdp_conv_delta(pre_patches: torch.Tensor, post_spikes: torch.Tensor,
                        pre_bits: torch.Tensor, post_bits: torch.Tensor,
                        po2_ltp: torch.Tensor, po2_ltd: torch.Tensor,
                        *, nearest: bool = True) -> torch.Tensor:
    """Raw ``(K, C)`` conv delta fed by ``(depth, M, ·)`` float32 bitplanes.

    The same device body as :func:`itp_stdp_conv_delta_packed`; used when the
    history is unpacked (``packed_history=False`` or depth > 8).
    """
    if pre_patches.device.type == "cpu":
        return itp_stdp_conv_delta_ref(pre_patches, post_spikes, pre_bits, post_bits,
                                       po2_ltp, po2_ltd, nearest=nearest)
    out = _launch("itp_stdp_conv_delta", pre_patches, post_spikes,
                  pre_bits.to(torch.float32), post_bits.to(torch.float32), po2_ltp,
                  po2_ltd, depth=pre_bits.shape[0], hist_dtype=torch.float32,
                  nearest=nearest)
    itp_stdp_conv_delta.launches += 1
    return out


itp_stdp_conv_delta_packed.launches = 0
itp_stdp_conv_delta.launches = 0
