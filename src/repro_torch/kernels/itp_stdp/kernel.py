"""Wrappers of the fused ITP-STDP CUDA kernels (``csrc/itp_stdp.cu``).

Port of the Pallas kernels in ``repro/kernels/itp_stdp/kernel.py``:
``itp_stdp_update_packed`` (one uint8 history word per neuron) and
``itp_stdp_update`` (depth-major float32 bitplanes).  Both share one CUDA
device body, so they are bit-identical; see the source for the design.

Each wrapper calls its registered operator (``torch.ops.repro_torch.*``,
``kernels/_ops.py``): given CPU tensors it runs the kernel's plain version
(``ref.py``); given CUDA tensors it launches the kernel on the current
stream or raises — there is no fallback.  Each wrapper counts its launches
in a plain integer attribute, ``<wrapper>.launches``, which callers may
reset to 0; only the operator's CUDA kernel adds to it.

Shapes take optional leading lane axes, one independent engine per lane:
``w`` ``(*lanes, n_pre, n_post)`` float32, spikes ``(*lanes, n)``, words
``(*lanes, n)`` uint8 or bitplanes ``(*lanes, depth, n)``, po2 read vectors
``(depth,)`` float32 (amplitudes folded in).  The kernel could update ``w``
in place; the wrappers write a new tensor, keeping the reference's
functional contract.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, _ops
from repro_torch.kernels.itp_stdp.ref import (itp_stdp_update_packed_ref,
                                              itp_stdp_update_ref)

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float] * 3
             + [ctypes.c_int, ctypes.c_void_p])


def _lib() -> ctypes.CDLL:
    lib = _build.library("itp_stdp")
    for name in ("itp_stdp_update_packed", "itp_stdp_update"):
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    lib.itp_stdp_error_string.argtypes = [ctypes.c_int]
    lib.itp_stdp_error_string.restype = ctypes.c_char_p
    return lib


def _check(symbol: str, w: torch.Tensor, pre_spike: torch.Tensor,
           post_spike: torch.Tensor, pre_hist: torch.Tensor, post_hist: torch.Tensor,
           po2_ltp: torch.Tensor, po2_ltd: torch.Tensor, *, depth: int, words: bool,
           hist_dtype: torch.dtype | None) -> None:
    """The operand rules the launch and the fake kernel share: dtypes
    (``hist_dtype=None``: the history's is not checked) and shapes, the
    lane axes included."""
    if w.dtype != torch.float32:
        raise TypeError(f"{symbol}: w must be float32, got {w.dtype}")
    if hist_dtype is not None and (pre_hist.dtype != hist_dtype
                                   or post_hist.dtype != hist_dtype):
        raise TypeError(f"{symbol}: history operands must be {hist_dtype}, got "
                        f"{pre_hist.dtype}/{post_hist.dtype}")
    args = {"pre_spike": pre_spike, "post_spike": post_spike, "pre_hist": pre_hist,
            "post_hist": post_hist, "po2_ltp": po2_ltp, "po2_ltd": po2_ltd}
    lanes_shape, (n_pre, n_post) = w.shape[:-2], w.shape[-2:]
    want = {
        "pre_spike": (*lanes_shape, n_pre), "post_spike": (*lanes_shape, n_post),
        "pre_hist": (*lanes_shape, n_pre) if words else (*lanes_shape, depth, n_pre),
        "post_hist": (*lanes_shape, n_post) if words else (*lanes_shape, depth, n_post),
        "po2_ltp": (depth,), "po2_ltd": (depth,),
    }
    for name, shape in want.items():
        if tuple(args[name].shape) != shape:
            raise ValueError(f"{symbol}: {name} has shape {tuple(args[name].shape)}, "
                             f"expected {shape}")
    if po2_ltp.dtype != torch.float32 or po2_ltd.dtype != torch.float32:
        raise TypeError(f"{symbol}: po2 vectors must be float32")


def _launch(symbol: str, w: torch.Tensor, pre_spike: torch.Tensor,
            post_spike: torch.Tensor, pre_hist: torch.Tensor,
            post_hist: torch.Tensor, po2_ltp: torch.Tensor,
            po2_ltd: torch.Tensor, *, depth: int, hist_dtype: torch.dtype,
            nearest: bool, eta: float, w_min: float, w_max: float) -> torch.Tensor:
    dev = w.device
    if dev.type != "cuda":
        raise ValueError(f"{symbol}: tensors must be on a CUDA device or the CPU, got {dev}")
    args = {"pre_spike": pre_spike, "post_spike": post_spike, "pre_hist": pre_hist,
            "post_hist": post_hist, "po2_ltp": po2_ltp, "po2_ltd": po2_ltd}
    for name, t in args.items():
        if t.device != dev:
            raise ValueError(f"{symbol}: {name} is on {t.device}, w on {dev}")
    _check(symbol, w, pre_spike, post_spike, pre_hist, post_hist, po2_ltp, po2_ltd,
           depth=depth, words=hist_dtype == torch.uint8, hist_dtype=hist_dtype)
    lanes_shape, (n_pre, n_post) = w.shape[:-2], w.shape[-2:]
    w = w.contiguous()
    pre_spike = pre_spike.to(torch.float32).contiguous()
    post_spike = post_spike.to(torch.float32).contiguous()
    pre_hist, post_hist = pre_hist.contiguous(), post_hist.contiguous()
    po2_ltp, po2_ltd = po2_ltp.contiguous(), po2_ltd.contiguous()
    out = torch.empty_like(w)
    lib = _lib()
    rc = getattr(lib, symbol)(
        out.data_ptr(), w.data_ptr(), pre_spike.data_ptr(), post_spike.data_ptr(),
        pre_hist.data_ptr(), post_hist.data_ptr(), po2_ltp.data_ptr(),
        po2_ltd.data_ptr(), math.prod(lanes_shape), n_pre, n_post, depth,
        int(nearest), eta, w_min, w_max, dev.index if dev.index is not None
        else torch.cuda.current_device(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{symbol}: CUDA launch failed: "
                           f"{lib.itp_stdp_error_string(rc).decode()}")
    return out


_SCHEMA = ("(Tensor w, Tensor pre_spike, Tensor post_spike, Tensor pre_hist, "
           "Tensor post_hist, Tensor po2_ltp, Tensor po2_ltd, *, {depth}bool nearest, "
           "float eta, float w_min, float w_max) -> Tensor")


def _cuda_packed(w, pre_spike, post_spike, pre_words, post_words, po2_ltp, po2_ltd, *,
                 depth, **kw):
    out = _launch("itp_stdp_update_packed", w, pre_spike, post_spike, pre_words,
                  post_words, po2_ltp, po2_ltd, depth=depth, hist_dtype=torch.uint8, **kw)
    itp_stdp_update_packed.launches += 1
    return out


def _cuda_planes(w, pre_spike, post_spike, pre_hist, post_hist, po2_ltp, po2_ltd, **kw):
    out = _launch("itp_stdp_update", w, pre_spike, post_spike, pre_hist.to(torch.float32),
                  post_hist.to(torch.float32), po2_ltp, po2_ltd, depth=pre_hist.shape[-2],
                  hist_dtype=torch.float32, **kw)
    itp_stdp_update.launches += 1
    return out


def _cpu_packed(*args, **kw):
    return itp_stdp_update_packed_ref(*args, **kw).contiguous()


def _cpu_planes(*args, **kw):
    return itp_stdp_update_ref(*args, **kw).contiguous()


def _fake_packed(w, pre_spike, post_spike, pre_words, post_words, po2_ltp, po2_ltd, *,
                 depth, **kw):
    _check("itp_stdp_update_packed", w, pre_spike, post_spike, pre_words, post_words,
           po2_ltp, po2_ltd, depth=depth, words=True, hist_dtype=torch.uint8)
    return w.new_empty(w.shape)


def _fake_planes(w, pre_spike, post_spike, pre_hist, post_hist, po2_ltp, po2_ltd, **kw):
    _check("itp_stdp_update", w, pre_spike, post_spike, pre_hist, post_hist, po2_ltp,
           po2_ltd, depth=pre_hist.shape[-2], words=False, hist_dtype=None)
    return w.new_empty(w.shape)


_PACKED = _ops.define("itp_stdp_update_packed" + _SCHEMA.format(depth="int depth, "),
                      cpu=_cpu_packed, cuda=_cuda_packed, fake=_fake_packed)
_PLANES = _ops.define("itp_stdp_update" + _SCHEMA.format(depth=""),
                      cpu=_cpu_planes, cuda=_cuda_planes, fake=_fake_planes)


def itp_stdp_update_packed(w: torch.Tensor,
                           pre_spike: torch.Tensor, post_spike: torch.Tensor,
                           pre_words: torch.Tensor, post_words: torch.Tensor,
                           po2_ltp: torch.Tensor, po2_ltd: torch.Tensor,
                           *,
                           depth: int,
                           nearest: bool = True,
                           eta: float = 1.0,
                           w_min: float = 0.0,
                           w_max: float = 1.0) -> torch.Tensor:
    """Fused ITP-STDP update fed by packed uint8 history words (depth ≤ 8).

    Returns ``clip(w + eta·dw, w_min, w_max)``; ``dw`` is the XOR-gated
    rank-1 delta of the po2 magnitudes read from the words (MSB = newest,
    ``repro_torch.core.history.pack_words``).
    """
    if not 1 <= depth <= 8:
        raise ValueError(f"packed history words support 1 <= depth <= 8, got {depth}")
    _ops.check_device("itp_stdp_update_packed", w)
    return _PACKED(w, pre_spike, post_spike, pre_words, post_words, po2_ltp, po2_ltd,
                   depth=depth, nearest=nearest, eta=eta, w_min=w_min, w_max=w_max)


def itp_stdp_update(w: torch.Tensor,
                    pre_spike: torch.Tensor, post_spike: torch.Tensor,
                    pre_hist: torch.Tensor, post_hist: torch.Tensor,
                    po2_ltp: torch.Tensor, po2_ltd: torch.Tensor,
                    *,
                    nearest: bool = True,
                    eta: float = 1.0,
                    w_min: float = 0.0,
                    w_max: float = 1.0) -> torch.Tensor:
    """Fused ITP-STDP update fed by ``(*lanes, depth, n)`` float32 bitplanes.

    The same device body as :func:`itp_stdp_update_packed`; used when the
    history is unpacked (``packed_history=False`` or depth > 8).
    """
    _ops.check_device("itp_stdp_update", w)
    return _PLANES(w, pre_spike, post_spike, pre_hist, post_hist, po2_ltp, po2_ltd,
                   nearest=nearest, eta=eta, w_min=w_min, w_max=w_max)


itp_stdp_update_packed.launches = 0
itp_stdp_update.launches = 0
