"""Wrappers of the fused counter-rule CUDA kernels (``csrc/itp_counter.cu``).

Port of the Pallas kernels in ``repro/kernels/itp_counter/kernel.py``:
``counter_stdp_update`` (the dense clipped update, window evaluated per
synapse) and ``counter_conv_delta`` (the im2col conv delta, the one-launch
cooperative float64 contraction of ``csrc/gated_sum.cuh``).  See the source for the
design and its bound.

A wrapper given CPU tensors runs the kernel's plain version (``ref.py``);
given CUDA tensors it launches the kernel on the current stream or raises —
there is no fallback.  Each wrapper counts its calls that launch the kernel
in a plain integer attribute, ``<wrapper>.launches``, which callers may
reset to 0.

Shapes: the dense update takes optional leading lane axes, one independent
engine per lane, all in one launch: ``w`` ``(*lanes, n_pre, n_post)``
float32, spikes ``(*lanes, n)`` (read as float32), counter words
``(*lanes, n)`` uint8.  The conv delta takes ``(M, K)`` / ``(M, C)`` spikes
and uint8 words and returns the raw ``(K, C)`` float32 delta summed over M.
``lut`` is the ``(2, depth)`` float32 window table (rows LTP, LTD) that the
imstdp window reads; ``1 <= depth <= 255``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.itp_counter.ref import counter_conv_delta_ref, counter_stdp_update_ref

WINDOW_CODES = {"exact": 0, "linear": 1, "imstdp": 2}
MAX_DEPTH = 255

_UPDATE_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float] * 7
                    + [ctypes.c_int, ctypes.c_void_p])
_CONV_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float] * 4
                  + [ctypes.c_int, ctypes.c_void_p])


def _lib() -> ctypes.CDLL:
    lib = _build.library("itp_counter")
    lib.counter_stdp_update.argtypes = _UPDATE_ARGTYPES
    lib.counter_stdp_update.restype = ctypes.c_int
    lib.counter_conv_delta.argtypes = _CONV_ARGTYPES
    lib.counter_conv_delta.restype = ctypes.c_int
    lib.counter_conv_max_splits.argtypes = [ctypes.c_int] * 3
    lib.counter_conv_max_splits.restype = ctypes.c_int
    lib.counter_error_string.argtypes = [ctypes.c_int]
    lib.counter_error_string.restype = ctypes.c_char_p
    return lib


def _check(symbol: str, dev: torch.device, args: dict, want: dict, *, depth: int,
           window: str) -> None:
    """Device, dtype and shape checks shared by both wrappers."""
    if dev.type != "cuda":
        raise ValueError(f"{symbol}: tensors must be on a CUDA device or the CPU, got {dev}")
    for name, t in args.items():
        if t.device != dev:
            raise ValueError(f"{symbol}: {name} is on {t.device}, expected {dev}")
    for name, shape in want.items():
        if tuple(args[name].shape) != shape:
            raise ValueError(f"{symbol}: {name} has shape {tuple(args[name].shape)}, "
                             f"expected {shape}")
    for name in ("pre_words", "post_words"):
        if args[name].dtype != torch.uint8:
            raise TypeError(f"{symbol}: {name} must be uint8 counter words, got "
                            f"{args[name].dtype}")
    if args["lut"].dtype != torch.float32:
        raise TypeError(f"{symbol}: lut must be float32, got {args['lut'].dtype}")
    if window not in WINDOW_CODES:
        raise ValueError(f"{symbol}: unknown counter window {window!r}; have "
                         f"{tuple(WINDOW_CODES)}")
    if not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"{symbol}: counter words are uint8: depth must be in "
                         f"[1, {MAX_DEPTH}], got {depth}")


def _raise_on(lib: ctypes.CDLL, symbol: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{symbol}: CUDA launch failed: "
                           f"{lib.counter_error_string(rc).decode()}")


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def counter_stdp_update(w: torch.Tensor,
                        pre_spike: torch.Tensor, post_spike: torch.Tensor,
                        pre_words: torch.Tensor, post_words: torch.Tensor,
                        lut: torch.Tensor,
                        *,
                        depth: int,
                        window: str,
                        a_plus: float,
                        a_minus: float,
                        tau_plus: float,
                        tau_minus: float,
                        eta: float = 1.0,
                        w_min: float = 0.0,
                        w_max: float = 1.0) -> torch.Tensor:
    """Fused explicit-Δt STDP update from per-neuron counter words:
    ``clip(w + eta·dw, w_min, w_max)`` with the per-pair window and the XOR
    pair gate."""
    kw = dict(depth=depth, window=window, a_plus=a_plus, a_minus=a_minus,
              tau_plus=tau_plus, tau_minus=tau_minus, eta=eta, w_min=w_min,
              w_max=w_max)
    if w.device.type == "cpu":
        return counter_stdp_update_ref(w, pre_spike, post_spike, pre_words, post_words,
                                       lut=lut, **kw)
    symbol = "counter_stdp_update"
    if w.dtype != torch.float32:
        raise TypeError(f"{symbol}: w must be float32, got {w.dtype}")
    lanes, (n_pre, n_post) = w.shape[:-2], w.shape[-2:]
    args = {"pre_spike": pre_spike, "post_spike": post_spike, "pre_words": pre_words,
            "post_words": post_words, "lut": lut}
    want = {"pre_spike": (*lanes, n_pre), "post_spike": (*lanes, n_post),
            "pre_words": (*lanes, n_pre), "post_words": (*lanes, n_post),
            "lut": (2, depth)}
    _check(symbol, w.device, args, want, depth=depth, window=window)
    w = w.contiguous()
    pre_spike = pre_spike.to(torch.float32).contiguous()
    post_spike = post_spike.to(torch.float32).contiguous()
    pre_words, post_words = pre_words.contiguous(), post_words.contiguous()
    lut = lut.contiguous()
    out = torch.empty_like(w)
    lib = _lib()
    rc = lib.counter_stdp_update(
        out.data_ptr(), w.data_ptr(), pre_spike.data_ptr(), post_spike.data_ptr(),
        pre_words.data_ptr(), post_words.data_ptr(), lut.data_ptr(), math.prod(lanes),
        n_pre, n_post, depth, WINDOW_CODES[window], a_plus, a_minus, tau_plus,
        tau_minus, eta, w_min, w_max, _device_index(w.device),
        torch.cuda.current_stream(w.device).cuda_stream)
    _raise_on(lib, symbol, rc)
    counter_stdp_update.launches += 1
    return out


def counter_conv_delta(pre_patches: torch.Tensor, post_spikes: torch.Tensor,
                       pre_words: torch.Tensor, post_words: torch.Tensor,
                       lut: torch.Tensor,
                       *,
                       depth: int,
                       window: str,
                       a_plus: float,
                       a_minus: float,
                       tau_plus: float,
                       tau_minus: float) -> torch.Tensor:
    """Raw ``(K, C)`` conv delta from im2col spikes and counter words: the
    window of each element's counter, then the pair-gated patch-row
    contraction summed over the M rows."""
    kw = dict(depth=depth, window=window, a_plus=a_plus, a_minus=a_minus,
              tau_plus=tau_plus, tau_minus=tau_minus)
    if pre_patches.device.type == "cpu":
        return counter_conv_delta_ref(pre_patches, post_spikes, pre_words, post_words,
                                      lut=lut, **kw)
    symbol = "counter_conv_delta"
    if pre_patches.dim() != 2 or post_spikes.dim() != 2:
        raise ValueError(f"{symbol}: spikes must be (M, K) and (M, C), got "
                         f"{tuple(pre_patches.shape)} and {tuple(post_spikes.shape)}")
    (m, k), c = pre_patches.shape, post_spikes.shape[1]
    args = {"post_spikes": post_spikes, "pre_words": pre_words, "post_words": post_words,
            "lut": lut}
    want = {"post_spikes": (m, c), "pre_words": (m, k), "post_words": (m, c),
            "lut": (2, depth)}
    _check(symbol, pre_patches.device, args, want, depth=depth, window=window)
    dev = pre_patches.device
    pre = pre_patches.to(torch.float32).contiguous()
    post = post_spikes.to(torch.float32).contiguous()
    pre_words, post_words = pre_words.contiguous(), post_words.contiguous()
    lut = lut.contiguous()
    lib = _lib()
    out = torch.empty((k, c), dtype=torch.float32, device=dev)
    # the blocks' float64 partials: every slot the launch reads it first writes
    partial = torch.empty((lib.counter_conv_max_splits(m, k, c) * k * c,),
                          dtype=torch.float64, device=dev)
    rc = lib.counter_conv_delta(
        out.data_ptr(), partial.data_ptr(), pre.data_ptr(), post.data_ptr(),
        pre_words.data_ptr(), post_words.data_ptr(), lut.data_ptr(), m, k, c, depth,
        WINDOW_CODES[window], a_plus, a_minus, tau_plus, tau_minus, _device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, symbol, rc)
    counter_conv_delta.launches += 1
    return out


counter_stdp_update.launches = 0
counter_conv_delta.launches = 0
