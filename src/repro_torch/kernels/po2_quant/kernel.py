"""Wrappers of the po2 encode/decode CUDA kernels (``csrc/po2_quant.cu``).

Port of the Pallas kernels ``repro/kernels/po2_quant/kernel.py::po2_encode``
and ``po2_decode``; see the source for the design.  Given CPU tensors a
wrapper runs the kernel's plain version (``ref.py``); given CUDA tensors it
launches the kernel on the current stream or raises — there is no fallback.
Each counts the calls that launch its kernel in ``<wrapper>.launches``,
which callers may reset to 0.

Operands: one contiguous tensor of any shape (flattened, nothing padded):
float32 values for the encoder, int32 codes for the decoder.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _launch
from repro_torch.kernels.po2_quant.ref import po2_decode_ref, po2_encode_ref

_ENTRY = {name: [ctypes.c_void_p] * 2 + [ctypes.c_int64]
          for name in ("po2_encode", "po2_decode")}


def po2_encode(x: torch.Tensor) -> torch.Tensor:
    """float32 → int32 po2 codes (the low byte is the wire format)."""
    if x.device.type == "cpu":
        return po2_encode_ref(x)
    symbol = "po2_encode"
    dev = _launch.check(symbol, {"x": (x, torch.float32)})
    out = torch.empty(x.shape, dtype=torch.int32, device=dev)
    lib = _launch.load("po2_quant", _ENTRY)
    _launch.launch(lib, "po2_quant", symbol, dev, out.data_ptr(), x.data_ptr(), x.numel())
    po2_encode.launches += 1
    return out


def po2_decode(c: torch.Tensor) -> torch.Tensor:
    """int32 po2 codes → float32 ±2^(code−64), 0 for code 0."""
    if c.device.type == "cpu":
        return po2_decode_ref(c)
    symbol = "po2_decode"
    dev = _launch.check(symbol, {"c": (c, torch.int32)})
    out = torch.empty(c.shape, dtype=torch.float32, device=dev)
    lib = _launch.load("po2_quant", _ENTRY)
    _launch.launch(lib, "po2_quant", symbol, dev, out.data_ptr(), c.data_ptr(), c.numel())
    po2_decode.launches += 1
    return out


po2_encode.launches = 0
po2_decode.launches = 0
