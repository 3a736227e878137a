"""Plain PyTorch version of the LLSMU multiplier kernel (``csrc/llsmu.cu``),
written from the Pallas body it replaces (``repro/kernels/llsmu/kernel.py``:
``_floor_log2``, ``_var_shift``, ``_mitchell``, ``_llsmu_kernel``).

Elementwise int32 on non-negative operands: a Karatsuba split at
``n_bits``, three Mitchell log-multiplies with the correction
``cq = round(c·2^frac_bits)``, and the recombination
``m1<<2n + (m2−m0−m1)<<n + m0``.  The leading-one count saturates at bit
``max_bits − 1`` with ``max_bits = 2·n_bits + 10``, as the Pallas wrapper
passes it; ``core.llsmu.floor_log2`` saturates at bit 17.  The two agree on
every operand of 2N bits and, at the default ``n_bits = 4``, up to 2^30;
beyond 2N bits at other widths they part (ROADMAP, reference caveats), and
this version follows the kernel.  int32 semantics as ``core.llsmu``.
"""
from __future__ import annotations

import torch

MAX_N_BITS = 10   # max_bits = 2·n_bits + 10 thresholds must stay below 2^31


def kernel_constants(n_bits: int, frac_bits: int, c: float) -> tuple[int, int]:
    """``(cq, max_bits)`` as the Pallas wrapper computes them; raises on a
    width the int32 threshold chain cannot hold."""
    if not 1 <= n_bits <= MAX_N_BITS:
        raise ValueError(f"llsmu: n_bits must be in [1, {MAX_N_BITS}], got {n_bits}")
    if not 0 <= frac_bits <= 29:
        raise ValueError(f"llsmu: frac_bits must be in [0, 29], got {frac_bits}")
    return round(c * (1 << frac_bits)), 2 * n_bits + 10


def _floor_log2(x: torch.Tensor, max_bits: int) -> torch.Tensor:
    """k = ⌊log2 x⌋, saturating at ``max_bits − 1``: the threshold chain."""
    k = torch.zeros_like(x)
    for i in range(1, max_bits):
        k = k + (x >= (1 << i)).to(torch.int32)
    return k


def _var_shift(mant: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return (mant << torch.clamp(s, min=0)) >> torch.clamp(-s, min=0)


def _mitchell(x: torch.Tensor, y: torch.Tensor, *, frac_bits: int, cq: int,
              max_bits: int) -> torch.Tensor:
    one = 1 << frac_bits
    kx = _floor_log2(x, max_bits)
    ky = _floor_log2(y, max_bits)
    fx = _var_shift(x, frac_bits - kx)
    fy = _var_shift(y, frac_bits - ky)
    delta = fx + fy - 2 * one
    mant = torch.where(delta < one, one + delta + cq, 2 * (delta + cq // 2))
    p = _var_shift(mant, kx + ky - frac_bits)
    return torch.where((x == 0) | (y == 0), 0, p)


def llsmu_multiply_ref(a: torch.Tensor, b: torch.Tensor, *, n_bits: int = 4,
                       frac_bits: int = 12, c: float = 0.08333) -> torch.Tensor:
    """Elementwise LLSMU approximate multiply of non-negative int32 tensors of
    one shape (callers handle the sign)."""
    cq, max_bits = kernel_constants(n_bits, frac_bits, c)
    a, b = a.to(torch.int32), b.to(torch.int32)
    mask = (1 << n_bits) - 1
    ha, la = a >> n_bits, a & mask
    hb, lb = b >> n_bits, b & mask
    kw = dict(frac_bits=frac_bits, cq=cq, max_bits=max_bits)
    m0 = _mitchell(la, lb, **kw)
    m1 = _mitchell(ha, hb, **kw)
    m2 = _mitchell(ha + la, hb + lb, **kw)
    s3 = m2 - m0 - m1
    return (m1 << (2 * n_bits)) + (s3 << n_bits) + m0
