"""Wrapper of the LLSMU multiplier CUDA kernel (``csrc/llsmu.cu``).

Port of the Pallas kernel ``repro/kernels/llsmu/kernel.py::llsmu_multiply``:
the elementwise int32 LLSMU approximate multiply of non-negative operands;
see the source for the design.  Given CPU tensors the wrapper runs the
kernel's plain version (``ref.py``); given CUDA tensors it launches the
kernel on the current stream or raises — there is no fallback.  It counts
the calls that launch the kernel in ``llsmu_multiply.launches``, which
callers may reset to 0.

Operands: two contiguous int32 tensors of one shape, any shape (flattened;
nothing is padded: the kernel masks the ragged end).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _launch
from repro_torch.kernels.llsmu.ref import kernel_constants, llsmu_multiply_ref

_ENTRY = {"llsmu_multiply": [ctypes.c_void_p] * 3 + [ctypes.c_int64] + [ctypes.c_int] * 4}


def llsmu_multiply(a: torch.Tensor, b: torch.Tensor, *, n_bits: int = 4,
                   frac_bits: int = 12, c: float = 0.08333) -> torch.Tensor:
    """Elementwise LLSMU approximate multiply of non-negative int32 tensors."""
    if a.device.type == "cpu":
        return llsmu_multiply_ref(a, b, n_bits=n_bits, frac_bits=frac_bits, c=c)
    symbol = "llsmu_multiply"
    dev = _launch.check(symbol, {"a": (a, torch.int32), "b": (b, torch.int32)})
    cq, max_bits = kernel_constants(n_bits, frac_bits, c)
    out = torch.empty_like(a)
    lib = _launch.load("llsmu", _ENTRY)
    _launch.launch(lib, "llsmu", symbol, dev, out.data_ptr(), a.data_ptr(), b.data_ptr(),
                   a.numel(), n_bits, frac_bits, cq, max_bits)
    llsmu_multiply.launches += 1
    return out


llsmu_multiply.launches = 0
