"""Wrappers of the po2 encode/decode CUDA kernels (``csrc/po2_quant.cu``).

Port of the Pallas kernels ``repro/kernels/po2_quant/kernel.py::po2_encode``
and ``po2_decode``; see the source for the design.  Each wrapper calls its
registered operator (``torch.ops.repro_torch.*``, ``kernels/_ops.py``):
given CPU tensors it runs the kernel's plain version (``ref.py``); given
CUDA tensors it launches the kernel on the current stream or raises — there
is no fallback.  Each counts the calls that launch its kernel in
``<wrapper>.launches``, which callers may reset to 0; only the operator's
CUDA kernel adds to it.

Operands: one contiguous tensor of any shape (flattened, nothing padded):
float32 values for the encoder, int32 codes for the decoder.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _launch, _ops
from repro_torch.kernels.po2_quant.ref import po2_decode_ref, po2_encode_ref

_ENTRY = {name: [ctypes.c_void_p] * 2 + [ctypes.c_int64]
          for name in ("po2_encode", "po2_decode")}


def _cuda_encode(x):
    symbol = "po2_encode"
    dev = _launch.check(symbol, {"x": (x, torch.float32)})
    out = torch.empty(x.shape, dtype=torch.int32, device=dev)
    lib = _launch.load("po2_quant", _ENTRY)
    _launch.launch(lib, "po2_quant", symbol, dev, out.data_ptr(), x.data_ptr(), x.numel())
    po2_encode.launches += 1
    return out


def _cuda_decode(c):
    symbol = "po2_decode"
    dev = _launch.check(symbol, {"c": (c, torch.int32)})
    out = torch.empty(c.shape, dtype=torch.float32, device=dev)
    lib = _launch.load("po2_quant", _ENTRY)
    _launch.launch(lib, "po2_quant", symbol, dev, out.data_ptr(), c.data_ptr(), c.numel())
    po2_decode.launches += 1
    return out


def _cpu_encode(x):
    return po2_encode_ref(x).contiguous()


def _cpu_decode(c):
    return po2_decode_ref(c).contiguous()


def _fake_encode(x):
    _launch.check_operands("po2_encode", {"x": (x, torch.float32)})
    return x.new_empty(x.shape, dtype=torch.int32)


def _fake_decode(c):
    _launch.check_operands("po2_decode", {"c": (c, torch.int32)})
    return c.new_empty(c.shape, dtype=torch.float32)


_ENCODE = _ops.define("po2_encode(Tensor x) -> Tensor", cpu=_cpu_encode, cuda=_cuda_encode,
                      fake=_fake_encode)
_DECODE = _ops.define("po2_decode(Tensor c) -> Tensor", cpu=_cpu_decode, cuda=_cuda_decode,
                      fake=_fake_decode)


def po2_encode(x: torch.Tensor) -> torch.Tensor:
    """float32 → int32 po2 codes (the low byte is the wire format)."""
    _ops.check_device("po2_encode", x)
    return _ENCODE(x)


def po2_decode(c: torch.Tensor) -> torch.Tensor:
    """int32 po2 codes → float32 ±2^(code−64), 0 for code 0."""
    _ops.check_device("po2_decode", c)
    return _DECODE(c)


po2_encode.launches = 0
po2_decode.launches = 0
