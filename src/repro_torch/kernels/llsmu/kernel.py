"""Wrapper of the LLSMU multiplier CUDA kernel (``csrc/llsmu.cu``).

Port of the Pallas kernel ``repro/kernels/llsmu/kernel.py::llsmu_multiply``:
the elementwise int32 LLSMU approximate multiply of non-negative operands;
see the source for the design.  Given CPU tensors the wrapper runs the
kernel's plain version (``ref.py``); given CUDA tensors it launches the
kernel on the current stream or raises — there is no fallback.  It counts
the calls that launch the kernel in ``llsmu_multiply.launches``, which
callers may reset to 0.

Operands: ``a``, a contiguous int32 tensor of any shape (flattened; nothing
is padded: the kernel masks the ragged end), and ``b``, either a contiguous
int32 tensor of ``a``'s shape or one int32 element that multiplies every
element of ``a`` (the kernel's scalar-``b`` variant; nothing is broadcast
in memory).  The result has ``a``'s shape.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _launch
from repro_torch.kernels.llsmu.ref import kernel_constants, llsmu_multiply_ref

_ENTRY = {"llsmu_multiply": [ctypes.c_void_p] * 3 + [ctypes.c_int64] + [ctypes.c_int] * 5}


def llsmu_multiply(a: torch.Tensor, b: torch.Tensor, *, n_bits: int = 4,
                   frac_bits: int = 12, c: float = 0.08333) -> torch.Tensor:
    """Elementwise LLSMU approximate multiply of non-negative int32 tensors;
    ``b`` of ``a``'s shape or one element."""
    b_scalar = b.shape != a.shape and b.numel() == 1
    if a.device.type == "cpu":
        return llsmu_multiply_ref(a, b.reshape(()) if b_scalar else b, n_bits=n_bits,
                                  frac_bits=frac_bits, c=c)
    symbol = "llsmu_multiply"
    a_spec, b_spec = {"a": (a, torch.int32)}, {"b": (b, torch.int32)}
    dev = (_launch.check(symbol, a_spec, b_spec) if b_scalar
           else _launch.check(symbol, {**a_spec, **b_spec}))
    cq, max_bits = kernel_constants(n_bits, frac_bits, c)
    out = torch.empty_like(a)
    lib = _launch.load("llsmu", _ENTRY)
    _launch.launch(lib, "llsmu", symbol, dev, out.data_ptr(), a.data_ptr(), b.data_ptr(),
                   a.numel(), int(b_scalar), n_bits, frac_bits, cq, max_bits)
    llsmu_multiply.launches += 1
    return out


llsmu_multiply.launches = 0
