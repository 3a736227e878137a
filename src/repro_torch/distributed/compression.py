"""Po2 gradient compression: the int8 wire codec (port of
``repro.distributed.compression``).

The paper's representation, sign · 2^e, applied to the slowest link of a
multi-pod training system: each gradient is encoded to the 8-bit wire
format of ``kernels.po2_quant`` (sign bit 7, biased exponent bits 0-6; 4×
fewer bytes than float32), exchanged, decoded and averaged.  Encoding and
decoding go through the po2 kernel wrappers: the CUDA kernels for CUDA
tensors, their plain versions for CPU tensors.

:func:`pod_mean_tree` is the cross-pod mean on ``torch.distributed``: the
reference gathers the int8 codes over a ``pod`` mesh axis inside
``shard_map``; here the pods are the ranks of a process group.  The po2
codec cannot be summed, so the exchange is gather-then-decode-then-mean; on
two pods its wire cost is one compressed all-reduce.
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

from repro_torch.kernels.po2_quant.kernel import po2_decode, po2_encode
from repro_torch.tree import tree_leaves, tree_map


def _encode_int8(x: torch.Tensor) -> torch.Tensor:
    """float32 → int8 wire bytes (sign bit 7, biased exponent bits 0-6)."""
    return po2_encode(x.to(torch.float32).contiguous()).to(torch.int8)


def _decode_int8(c: torch.Tensor) -> torch.Tensor:
    return po2_decode((c.to(torch.int32) & 0xFF).contiguous())


# ``all_gather_tensor`` took this name in newer PyTorch
_all_gather = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor


def _wait(x: torch.Tensor) -> torch.Tensor:
    return x.wait() if isinstance(x, funcol.AsyncCollectiveTensor) else x


def _pod_mean_one(g: torch.Tensor, group) -> torch.Tensor:
    wire = _encode_int8(g)
    parts = _wait(_all_gather(wire[None], 0, group))   # n_pod × int8
    return torch.mean(_decode_int8(parts), dim=0).to(g.dtype)


def _pod_mean_plain(g: torch.Tensor, group) -> torch.Tensor:
    total = _wait(funcol.all_reduce(g, "sum", group))
    return total / dist.get_world_size(group)


def pod_mean_tree(grads, *, compress: bool, group=None):
    """Mean a gradient tree over the ranks of ``group`` (default: the whole
    world), po2-compressed or plain.  Every rank calls it with a tree of
    the same shapes and gets the same mean back."""
    one = _pod_mean_one if compress else _pod_mean_plain
    group = dist.group.WORLD if group is None else group
    return tree_map(functools.partial(one, group=group), grads)


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
