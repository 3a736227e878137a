"""Wrappers of the fused counter-rule CUDA kernels (``csrc/itp_counter.cu``).

Port of the Pallas kernels in ``repro/kernels/itp_counter/kernel.py``:
``counter_stdp_update`` (the dense clipped update, window evaluated per
synapse) and ``counter_conv_delta`` (the im2col conv delta, the one-launch
cooperative float64 contraction of ``csrc/gated_sum.cuh``); and
``counter_fc_delta``, which ports no TPU kernel: an SNN fc layer's delta,
each pair's windows evaluated as the dense update evaluates them and summed
over the batch lanes in float64 inside the kernel, with no per-lane array.
See the source for the design and its bound.

Each wrapper calls its registered operator (``torch.ops.repro_torch.*``,
``kernels/_ops.py``): given CPU tensors it runs the kernel's plain version
(``ref.py``); given CUDA tensors it launches the kernel on the current
stream or raises — there is no fallback.  Each wrapper counts its calls
that launch the kernel in a plain integer attribute,
``<wrapper>.launches``, which callers may reset to 0; only the operator's
CUDA kernel adds to it.  The conv delta's float64 partials are the CUDA
kernel's own scratch, allocated inside it as large as the kernel's plan
reports (``counter_conv_scratch``; none where the blocks store the outputs
directly).

Shapes: the dense update takes optional leading lane axes, one independent
engine per lane, all in one launch: ``w`` ``(*lanes, n_pre, n_post)``
float32, spikes ``(*lanes, n)`` (read as float32), counter words
``(*lanes, n)`` uint8.  The conv delta takes ``(M, K)`` / ``(M, C)`` spikes
and uint8 words and returns the raw ``(K, C)`` float32 delta summed over M;
the fc delta takes the same operands with the batch as M, ``(B, n_pre)`` /
``(B, n_post)``, and returns the raw ``(n_pre, n_post)`` delta summed over B.
``lut`` is the ``(2, depth)`` float32 window table (rows LTP, LTD) that the
imstdp window reads; ``1 <= depth <= 255``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, _ops
from repro_torch.kernels.itp_counter.ref import (counter_conv_delta_ref, counter_fc_delta_ref,
                                                 counter_stdp_update_ref)

WINDOW_CODES = {"exact": 0, "linear": 1, "imstdp": 2}
MAX_DEPTH = 255

_UPDATE_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_float] * 7
                    + [ctypes.c_int, ctypes.c_void_p])
_CONV_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_long] + [ctypes.c_void_p] * 5
                  + [ctypes.c_int] * 5 + [ctypes.c_float] * 4 + [ctypes.c_int, ctypes.c_void_p])
_FC_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float] * 4
                + [ctypes.c_int, ctypes.c_void_p])


def counter_delays(words: torch.Tensor, depth: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Δt formation: uint8 counter words → (delays int32, validity float32).

    A word at value t means the neuron last spiked t steps ago; words
    saturate at ``depth`` (one past the last valid delay), so the validity
    gate is ``t <= depth - 1``.  The CUDA kernel forms the same pair in
    registers (``csrc/itp_counter.cu``)."""
    t = words.to(torch.int32)
    return t, (t <= depth - 1).to(torch.float32)


def _lib() -> ctypes.CDLL:
    lib = _build.library("itp_counter")
    lib.counter_stdp_update.argtypes = _UPDATE_ARGTYPES
    lib.counter_stdp_update.restype = ctypes.c_int
    lib.counter_conv_delta.argtypes = _CONV_ARGTYPES
    lib.counter_conv_delta.restype = ctypes.c_int
    lib.counter_fc_delta.argtypes = _FC_ARGTYPES
    lib.counter_fc_delta.restype = ctypes.c_int
    lib.counter_conv_scratch.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_long)]
    lib.counter_conv_scratch.restype = ctypes.c_int
    lib.counter_error_string.argtypes = [ctypes.c_int]
    lib.counter_error_string.restype = ctypes.c_char_p
    return lib


def _update_operands(w, pre_spike, post_spike, pre_words, post_words, lut, *,
                     depth) -> tuple[dict, dict]:
    """The dense update's operands and their expected shapes (lane axes
    included); ``w`` must be float32."""
    if w.dtype != torch.float32:
        raise TypeError(f"counter_stdp_update: w must be float32, got {w.dtype}")
    lanes, (n_pre, n_post) = w.shape[:-2], w.shape[-2:]
    args = {"pre_spike": pre_spike, "post_spike": post_spike, "pre_words": pre_words,
            "post_words": post_words, "lut": lut}
    want = {"pre_spike": (*lanes, n_pre), "post_spike": (*lanes, n_post),
            "pre_words": (*lanes, n_pre), "post_words": (*lanes, n_post),
            "lut": (2, depth)}
    return args, want


def _conv_operands(pre_patches, post_spikes, pre_words, post_words, lut, *, depth,
                   symbol="counter_conv_delta") -> tuple[dict, dict]:
    """The conv delta's operands and their expected shapes: ``(M, K)``
    patches and ``(M, C)`` spikes (the fc delta's too, the batch as M)."""
    if pre_patches.dim() != 2 or post_spikes.dim() != 2:
        raise ValueError(f"{symbol}: spikes must be (M, K) and (M, C), got "
                         f"{tuple(pre_patches.shape)} and {tuple(post_spikes.shape)}")
    (m, k), c = pre_patches.shape, post_spikes.shape[1]
    args = {"post_spikes": post_spikes, "pre_words": pre_words, "post_words": post_words,
            "lut": lut}
    want = {"post_spikes": (m, c), "pre_words": (m, k), "post_words": (m, c),
            "lut": (2, depth)}
    return args, want


def _check(symbol: str, args: dict, want: dict, *, depth: int, window: str,
           dev: torch.device | None = None) -> None:
    """Dtype and shape checks shared by both kernels' launches and fake
    kernels; given ``dev``, the launch's device checks too."""
    if dev is not None:
        if dev.type != "cuda":
            raise ValueError(f"{symbol}: tensors must be on a CUDA device or the CPU, "
                             f"got {dev}")
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


_WINDOW_ARGS = ("int depth, str window, float a_plus, float a_minus, float tau_plus, "
                "float tau_minus")


def _cuda_update(w, pre_spike, post_spike, pre_words, post_words, lut, *, depth, window,
                 a_plus, a_minus, tau_plus, tau_minus, eta, w_min, w_max):
    symbol = "counter_stdp_update"
    args, want = _update_operands(w, pre_spike, post_spike, pre_words, post_words, lut,
                                  depth=depth)
    _check(symbol, args, want, depth=depth, window=window, dev=w.device)
    lanes, (n_pre, n_post) = w.shape[:-2], w.shape[-2:]
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


def _cuda_conv(pre_patches, post_spikes, pre_words, post_words, lut, *, depth, window,
               a_plus, a_minus, tau_plus, tau_minus):
    symbol = "counter_conv_delta"
    args, want = _conv_operands(pre_patches, post_spikes, pre_words, post_words, lut,
                                depth=depth)
    dev = pre_patches.device
    _check(symbol, args, want, depth=depth, window=window, dev=dev)
    (m, k), c = pre_patches.shape, post_spikes.shape[1]
    pre = pre_patches.to(torch.float32).contiguous()
    post = post_spikes.to(torch.float32).contiguous()
    pre_words, post_words = pre_words.contiguous(), post_words.contiguous()
    lut = lut.contiguous()
    lib = _lib()
    index = _device_index(dev)
    doubles = ctypes.c_long(0)
    _raise_on(lib, symbol, lib.counter_conv_scratch(m, k, c, depth, WINDOW_CODES[window],
                                                    index, ctypes.byref(doubles)))
    out = torch.empty((k, c), dtype=torch.float32, device=dev)
    # the blocks' float64 partials: every slot the launch reads it first writes
    partial = (torch.empty((doubles.value,), dtype=torch.float64, device=dev)
               if doubles.value else None)
    rc = lib.counter_conv_delta(
        out.data_ptr(), None if partial is None else partial.data_ptr(), doubles.value,
        pre.data_ptr(), post.data_ptr(), pre_words.data_ptr(), post_words.data_ptr(),
        lut.data_ptr(), m, k, c, depth, WINDOW_CODES[window], a_plus, a_minus, tau_plus,
        tau_minus, index, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, symbol, rc)
    counter_conv_delta.launches += 1
    return out


def _cuda_fc(pre_spike, post_spike, pre_words, post_words, lut, *, depth, window, a_plus,
             a_minus, tau_plus, tau_minus):
    symbol = "counter_fc_delta"
    args, want = _conv_operands(pre_spike, post_spike, pre_words, post_words, lut,
                                depth=depth, symbol=symbol)
    dev = pre_spike.device
    _check(symbol, args, want, depth=depth, window=window, dev=dev)
    (lanes, n_pre), n_post = pre_spike.shape, post_spike.shape[1]
    pre = pre_spike.to(torch.float32).contiguous()
    post = post_spike.to(torch.float32).contiguous()
    pre_words, post_words = pre_words.contiguous(), post_words.contiguous()
    lut = lut.contiguous()
    out = torch.empty((n_pre, n_post), dtype=torch.float32, device=dev)
    lib = _lib()
    rc = lib.counter_fc_delta(
        out.data_ptr(), pre.data_ptr(), post.data_ptr(), pre_words.data_ptr(),
        post_words.data_ptr(), lut.data_ptr(), lanes, n_pre, n_post, depth,
        WINDOW_CODES[window], a_plus, a_minus, tau_plus, tau_minus, _device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, symbol, rc)
    counter_fc_delta.launches += 1
    return out


def _fake_update(w, pre_spike, post_spike, pre_words, post_words, lut, *, depth, window,
                 **kw):
    _check("counter_stdp_update", *_update_operands(w, pre_spike, post_spike, pre_words,
                                                    post_words, lut, depth=depth),
           depth=depth, window=window)
    return w.new_empty(w.shape)


def _fake_conv(pre_patches, post_spikes, pre_words, post_words, lut, *, depth, window,
               **kw):
    """The raw ``(K, C)`` float32 delta of ``(M, K)`` patches and ``(M, C)`` spikes."""
    _check("counter_conv_delta", *_conv_operands(pre_patches, post_spikes, pre_words,
                                                 post_words, lut, depth=depth),
           depth=depth, window=window)
    return pre_patches.new_empty((pre_patches.shape[1], post_spikes.shape[1]),
                                 dtype=torch.float32)


def _fake_fc(pre_spike, post_spike, pre_words, post_words, lut, *, depth, window, **kw):
    """The raw ``(n_pre, n_post)`` float32 delta of ``(B, n_pre)`` and ``(B, n_post)``
    spikes."""
    _check("counter_fc_delta", *_conv_operands(pre_spike, post_spike, pre_words, post_words,
                                               lut, depth=depth, symbol="counter_fc_delta"),
           depth=depth, window=window)
    return pre_spike.new_empty((pre_spike.shape[1], post_spike.shape[1]),
                               dtype=torch.float32)


def _cpu_update(w, pre_spike, post_spike, pre_words, post_words, lut, **kw):
    return counter_stdp_update_ref(w, pre_spike, post_spike, pre_words, post_words,
                                   lut=lut, **kw).contiguous()


def _cpu_conv(pre_patches, post_spikes, pre_words, post_words, lut, **kw):
    return counter_conv_delta_ref(pre_patches, post_spikes, pre_words, post_words,
                                  lut=lut, **kw).contiguous()


def _cpu_fc(pre_spike, post_spike, pre_words, post_words, lut, **kw):
    return counter_fc_delta_ref(pre_spike, post_spike, pre_words, post_words, lut=lut,
                                **kw).contiguous()


_UPDATE = _ops.define(
    "counter_stdp_update(Tensor w, Tensor pre_spike, Tensor post_spike, Tensor pre_words, "
    f"Tensor post_words, Tensor lut, *, {_WINDOW_ARGS}, float eta, float w_min, "
    "float w_max) -> Tensor",
    cpu=_cpu_update, cuda=_cuda_update, fake=_fake_update)
_CONV = _ops.define(
    "counter_conv_delta(Tensor pre_patches, Tensor post_spikes, Tensor pre_words, "
    f"Tensor post_words, Tensor lut, *, {_WINDOW_ARGS}) -> Tensor",
    cpu=_cpu_conv, cuda=_cuda_conv, fake=_fake_conv)
_FC = _ops.define(
    "counter_fc_delta(Tensor pre_spike, Tensor post_spike, Tensor pre_words, "
    f"Tensor post_words, Tensor lut, *, {_WINDOW_ARGS}) -> Tensor",
    cpu=_cpu_fc, cuda=_cuda_fc, fake=_fake_fc)


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
    _ops.check_device("counter_stdp_update", w)
    return _UPDATE(w, pre_spike, post_spike, pre_words, post_words, lut, depth=depth,
                   window=window, a_plus=a_plus, a_minus=a_minus, tau_plus=tau_plus,
                   tau_minus=tau_minus, eta=eta, w_min=w_min, w_max=w_max)


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
    _ops.check_device("counter_conv_delta", pre_patches)
    return _CONV(pre_patches, post_spikes, pre_words, post_words, lut, depth=depth,
                 window=window, a_plus=a_plus, a_minus=a_minus, tau_plus=tau_plus,
                 tau_minus=tau_minus)


def counter_fc_delta(pre_spike: torch.Tensor, post_spike: torch.Tensor,
                     pre_words: torch.Tensor, post_words: torch.Tensor,
                     lut: torch.Tensor,
                     *,
                     depth: int,
                     window: str,
                     a_plus: float,
                     a_minus: float,
                     tau_plus: float,
                     tau_minus: float) -> torch.Tensor:
    """Raw ``(n_pre, n_post)`` fc delta from ``(B, n)`` spikes and counter
    words: each lane's per-pair windows and XOR pair gate, as the dense update
    forms them, summed over the B lanes in float64 and rounded once."""
    _ops.check_device("counter_fc_delta", pre_spike)
    return _FC(pre_spike, post_spike, pre_words, post_words, lut, depth=depth, window=window,
               a_plus=a_plus, a_minus=a_minus, tau_plus=tau_plus, tau_minus=tau_minus)


counter_stdp_update.launches = 0
counter_conv_delta.launches = 0
counter_fc_delta.launches = 0
