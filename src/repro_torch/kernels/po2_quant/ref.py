"""Plain PyTorch version of the po2 encode/decode kernels
(``csrc/po2_quant.cu``; port of ``repro.kernels.po2_quant.ref``).

The 8-bit code of a float32 x: bit 7 the sign, bits 0-6 the biased exponent
``e + BIAS`` of the nearest power of two, ``e = round(log2|x|)`` clipped to
[−63, 63]; code 0 is an exact zero.  The decoder builds ``±2^(code−64)``
from the exponent field, the decoder circuit.

The encoder is the encoder circuit, read off the float's bits, not computed
through ``log2``: e is the unbiased exponent field, plus one exactly when
the 23 mantissa bits are at least ``0x3504F4``, the smallest float32
mantissa above √2 (√2 is irrational, so no value ties).  That is the
correctly rounded ``round(log2|x|)``.  ±0, subnormals and NaN encode to 0
with no sign bit (XLA flushes subnormals to zero and turns NaN into the
integer 0, so the reference gives the same); +inf encodes to 127, −inf to
255.  The reference goes through XLA's ``log2``, which is not correctly
rounded within a few ulps of √2·2^k: there some of its codes differ from
these (ROADMAP queue 3).
"""
from __future__ import annotations

import torch

BIAS = 64
SQRT2_MANTISSA = 0x3504F4   # smallest 23-bit mantissa m with 1 + m/2^23 > √2


def exact_exp2_int(e: torch.Tensor) -> torch.Tensor:
    """Exact 2^e for int32 e ∈ [−126, 127] by exponent-field construction."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def po2_encode_ref(x: torch.Tensor) -> torch.Tensor:
    """float32 → int32 po2 codes in [0, 255] (the low byte is the wire format)."""
    bits = torch.as_tensor(x).to(torch.float32).contiguous().view(torch.int32)
    field = (bits >> 23) & 0xFF
    mant = bits & 0x7FFFFF
    e = field - 127 + (mant >= SQRT2_MANTISSA).to(torch.int32)
    code = (torch.clamp(e, -BIAS + 1, 127 - BIAS) + BIAS) | ((bits >> 24) & 128)
    flush = (field == 0) | ((field == 0xFF) & (mant != 0))   # ±0, subnormal, NaN
    return torch.where(flush, 0, code).to(torch.int32)


def po2_decode_ref(c: torch.Tensor) -> torch.Tensor:
    """po2 codes (only the low 8 bits are read) → float32 ±2^(code−64), 0 for
    code 0."""
    c = c.to(torch.int32)
    sign = torch.where((c & 128) != 0, -1.0, 1.0)
    code = c & 127
    val = sign * exact_exp2_int(code - BIAS)
    return torch.where(code == 0, 0.0, val)


def po2_roundtrip_ref(x: torch.Tensor) -> torch.Tensor:
    """Quantise to the nearest power of two (the ITP-STDP quantiser)."""
    return po2_decode_ref(po2_encode_ref(x))
