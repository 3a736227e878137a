"""Signed LLSMU multiply of any shape (port of ``repro.kernels.llsmu.ops``).

Sign-magnitude around the kernel, as the hardware and the reference do:
``sign(a)·sign(b) · |a| ⊗ |b|``.  ``use_kernel=False`` is the reference
oracle (``core.llsmu.llsmu_fixed``) on whatever device the operands are on;
otherwise the kernel wrapper runs: the CUDA kernel for CUDA tensors, its
plain version for CPU tensors.  Unlike the Pallas wrapper nothing is padded,
and a one-element ``b`` is not broadcast in memory: it goes to the kernel as
its scalar ``b``.
"""
from __future__ import annotations

import torch

from repro_torch.core.llsmu import llsmu_fixed
from repro_torch.kernels.llsmu.kernel import llsmu_multiply


def llsmu(a: torch.Tensor, b, *, n_bits: int = 4, frac_bits: int = 12,
          c: float = 0.08333, use_kernel: bool = True) -> torch.Tensor:
    """Signed LLSMU approximate multiply of int32 operands of equal or
    broadcastable shape (``b`` may be a Python int)."""
    a = torch.as_tensor(a).to(torch.int32)
    b = torch.as_tensor(b, device=a.device).to(torch.int32)
    if a.shape != b.shape and b.numel() != 1:
        a, b = torch.broadcast_tensors(a, b)
    sign = torch.sign(a) * torch.sign(b)
    aa, bb = torch.abs(a), torch.abs(b)
    kw = dict(n_bits=n_bits, frac_bits=frac_bits, c=c)
    if not use_kernel:
        return sign * llsmu_fixed(aa, bb, **kw)
    return sign * llsmu_multiply(aa.contiguous(), bb.contiguous(), **kw)
