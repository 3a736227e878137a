"""Wrapper of the LLSMU multiplier CUDA kernel (``csrc/llsmu.cu``).

Port of the Pallas kernel ``repro/kernels/llsmu/kernel.py::llsmu_multiply``:
the elementwise int32 LLSMU approximate multiply of non-negative operands;
see the source for the design.  The wrapper calls its registered operator
(``torch.ops.repro_torch.llsmu_multiply``, ``kernels/_ops.py``): given CPU
tensors it runs the kernel's plain version (``ref.py``); given CUDA tensors
it launches the kernel on the current stream or raises — there is no
fallback.  It counts the calls that launch the kernel in
``llsmu_multiply.launches``, which callers may reset to 0; only the
operator's CUDA kernel adds to it.

Operands: ``a``, a contiguous int32 tensor of any shape (flattened; nothing
is padded: the kernel masks the ragged end), and ``b``, either a contiguous
int32 tensor of ``a``'s shape or one int32 element that multiplies every
element of ``a`` (the kernel's scalar-``b`` variant; nothing is broadcast
in memory).  The result has ``a``'s shape.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _launch, _ops
from repro_torch.kernels.llsmu.ref import kernel_constants, llsmu_multiply_ref

_ENTRY = {"llsmu_multiply": [ctypes.c_void_p] * 3 + [ctypes.c_int64] + [ctypes.c_int] * 5}


def _scalar_b(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``b`` is the kernel's scalar ``b``: one element, not ``a``'s shape."""
    return b.shape != a.shape and b.numel() == 1


def _cuda(a, b, *, n_bits, frac_bits, c):
    symbol = "llsmu_multiply"
    b_scalar = _scalar_b(a, b)
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


def _cpu(a, b, **kw):
    return llsmu_multiply_ref(a, b.reshape(()) if _scalar_b(a, b) else b, **kw).contiguous()


def _fake(a, b, **kw):
    """An int32 tensor of ``a``'s shape, ``b`` of ``a``'s shape or one element."""
    a_spec, b_spec = {"a": (a, torch.int32)}, {"b": (b, torch.int32)}
    if _scalar_b(a, b):
        _launch.check_operands("llsmu_multiply", a_spec, b_spec)
    else:
        _launch.check_operands("llsmu_multiply", {**a_spec, **b_spec})
    return a.new_empty(a.shape, dtype=torch.int32)


_OP = _ops.define("llsmu_multiply(Tensor a, Tensor b, *, int n_bits, int frac_bits, "
                  "float c) -> Tensor", cpu=_cpu, cuda=_cuda, fake=_fake)


def llsmu_multiply(a: torch.Tensor, b: torch.Tensor, *, n_bits: int = 4,
                   frac_bits: int = 12, c: float = 0.08333) -> torch.Tensor:
    """Elementwise LLSMU approximate multiply of non-negative int32 tensors;
    ``b`` of ``a``'s shape or one element."""
    _ops.check_device("llsmu_multiply", a)
    return _OP(a, b, n_bits=n_bits, frac_bits=frac_bits, c=c)


llsmu_multiply.launches = 0
