"""Po2 gradient compression: the int8 wire codec (port of
``repro.distributed.compression``).

The paper's representation, sign · 2^e, applied to the slowest link of a
multi-pod training system: each gradient is encoded to the 8-bit wire
format of ``kernels.po2_quant`` (sign bit 7, biased exponent bits 0-6; 4×
fewer bytes than float32), exchanged, decoded and averaged.  Encoding and
decoding go through the po2 kernel wrappers: the CUDA kernels for CUDA
tensors, their plain versions for CPU tensors.

The cross-pod mean itself (the reference's ``pod_mean_tree``, a gather over
a ``pod`` mesh axis) belongs with the sharded engine on
``torch.distributed`` and is not ported here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.po2_quant.kernel import po2_decode, po2_encode
from repro_torch.tree import tree_leaves


def _encode_int8(x: torch.Tensor) -> torch.Tensor:
    """float32 → int8 wire bytes (sign bit 7, biased exponent bits 0-6)."""
    return po2_encode(x.to(torch.float32).contiguous()).to(torch.int8)


def _decode_int8(c: torch.Tensor) -> torch.Tensor:
    return po2_decode((c.to(torch.int32) & 0xFF).contiguous())


def compression_error(grads) -> torch.Tensor:
    """Relative L2 error of the po2 quantiser over a gradient tree."""
    def err(x):
        x = x.to(torch.float32)
        q = _decode_int8(_encode_int8(x))
        return torch.sum((q - x) ** 2), torch.sum(x ** 2)
    pairs = [err(x) for x in tree_leaves(grads)]
    num = sum(p[0] for p in pairs)
    den = sum(p[1] for p in pairs)
    return torch.sqrt(num / torch.clamp(den, min=1e-30))
