"""LLSMU — Logarithmic Linear Segmented Multiply (port of ``repro.core.llsmu``;
paper §II-D, eqs. 6-14).

Karatsuba decomposition of a 2N×2N-bit multiply into three N(+1)-bit
multiplies, each evaluated with the Mitchell logarithmic approximation with
the minimally-biased error-compensation constant c = 0.08333 [32].

* :func:`mitchell_fixed` / :func:`llsmu_fixed` — integer fixed-point, the
  model of the hardware datapath (Q-format mantissas, truncating shifts).
* :func:`mitchell_float` — float shadow used for error analysis only.

Everything is int32 with XLA's integer semantics, which PyTorch's int32 ops
share on the CPU and on CUDA: additions wrap, a left shift by 32 or more
gives 0, a right shift is arithmetic and fills with the sign bit from 32 on.
The δ≥1 branch of eq. 7 is the minimally-biased form 2^(kx+ky+1)·(δ + c/2),
as in the reference.
"""
from __future__ import annotations

import torch

C_COMP = 0.08333  # error-compensation constant (paper §II-D)


def _i32(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.int32)


def floor_log2(x: torch.Tensor, max_bits: int = 18) -> torch.Tensor:
    """Exact ⌊log2 x⌋ for non-negative int32 x (0 maps to 0), saturating at
    ``max_bits - 1``: the threshold count k = #{i : x >= 2^i} - 1."""
    x = _i32(x)
    one = torch.ones((), dtype=torch.int32, device=x.device)
    thresholds = one << torch.arange(max_bits, dtype=torch.int32, device=x.device)
    k = (x[..., None] >= thresholds).sum(dim=-1, dtype=torch.int32) - 1
    return torch.clamp(k, min=0)


def _var_shift(mant: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """mant · 2^s with truncation for negative s (hardware barrel shift)."""
    return (mant << torch.clamp(s, min=0)) >> torch.clamp(-s, min=0)


def mitchell_fixed(x: torch.Tensor, y: torch.Tensor, *, frac_bits: int = 12,
                   c: float = C_COMP) -> torch.Tensor:
    """Mitchell approximate multiply, integer Q(frac_bits) datapath (eqs. 7-9),
    of non-negative int32 operands."""
    x, y = _i32(x), _i32(y)
    one = 1 << frac_bits
    cq = round(c * (1 << frac_bits))

    kx = floor_log2(x)
    ky = floor_log2(y)
    # mantissas x/2^kx, y/2^ky in Q(frac_bits) — truncating, as in hardware
    fx = _var_shift(x, frac_bits - kx)
    fy = _var_shift(y, frac_bits - ky)
    delta = fx + fy - 2 * one                       # δ in Q(frac_bits)

    mant_lt = one + delta + cq                      # (1 + δ + c)
    mant_ge = 2 * (delta + cq // 2)                 # 2·(δ + c/2)
    mant = torch.where(delta < one, mant_lt, mant_ge)

    p = _var_shift(mant, kx + ky - frac_bits)
    return torch.where((x == 0) | (y == 0), 0, p).to(torch.int32)


def mitchell_float(x: torch.Tensor, y: torch.Tensor, *, c: float = C_COMP) -> torch.Tensor:
    """Float shadow of :func:`mitchell_fixed` (no quantisation error)."""
    x = torch.as_tensor(x).to(torch.float32)
    y = torch.as_tensor(y).to(torch.float32)
    kx = torch.floor(torch.log2(torch.clamp(x, min=1.0)))
    ky = torch.floor(torch.log2(torch.clamp(y, min=1.0)))
    fx = x / torch.exp2(kx) - 1.0
    fy = y / torch.exp2(ky) - 1.0
    delta = fx + fy
    mant = torch.where(delta < 1.0, 1.0 + delta + c, 2.0 * (delta + c / 2.0))
    p = torch.exp2(kx + ky) * mant
    return torch.where((x == 0) | (y == 0), 0.0, p)


def llsmu_fixed(a: torch.Tensor, b: torch.Tensor, *, n_bits: int = 4,
                frac_bits: int = 12, c: float = C_COMP) -> torch.Tensor:
    """LLSMU approximate multiply of two 2N-bit operands (eqs. 6, 10-14).

    All three partial products go through :func:`mitchell_fixed`; the
    recombination (eq. 13) is exact integer adds and shifts, exact while the
    true product stays below 2^31.
    """
    a, b = _i32(a), _i32(b)
    mask = (1 << n_bits) - 1
    ha, la = a >> n_bits, a & mask
    hb, lb = b >> n_bits, b & mask

    m0 = mitchell_fixed(la, lb, frac_bits=frac_bits, c=c)
    m1 = mitchell_fixed(ha, hb, frac_bits=frac_bits, c=c)
    m2 = mitchell_fixed(ha + la, hb + lb, frac_bits=frac_bits, c=c)
    s3 = m2 - m0 - m1                                # eq. 12
    return (m1 << (2 * n_bits)) + (s3 << n_bits) + m0  # eq. 13


def llsmu_signed(a: torch.Tensor, b: torch.Tensor, **kw) -> torch.Tensor:
    """Sign-magnitude wrapper (the neuron datapath multiplies signed V-E)."""
    a, b = _i32(a), _i32(b)
    sign = torch.sign(a) * torch.sign(b)
    return sign * llsmu_fixed(torch.abs(a), torch.abs(b), **kw)


def relative_error(a: torch.Tensor, b: torch.Tensor, **kw) -> torch.Tensor:
    """|LLSMU(a,b) − a·b| / max(1, |a·b|), the exact product in float32."""
    exact = torch.as_tensor(a).to(torch.float32) * torch.as_tensor(b).to(torch.float32)
    approx = llsmu_fixed(a, b, **kw).to(torch.float32)
    return torch.abs(approx - exact) / torch.clamp(torch.abs(exact), min=1.0)
