"""Shape-generic po2 quantisation of tensors and trees (port of
``repro.kernels.po2_quant.ops``).

``use_kernel=False`` (the default, as in the reference) runs the plain
encode and decode on whatever device the tensor is on; ``use_kernel=True``
goes through the kernel wrappers: the CUDA kernels for a CUDA tensor, their
plain versions for a CPU tensor.  Nothing is padded.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.po2_quant.kernel import po2_decode, po2_encode
from repro_torch.kernels.po2_quant.ref import po2_decode_ref, po2_encode_ref
from repro_torch.tree import tree_map


def po2_quantize(x: torch.Tensor, *, use_kernel: bool = False) -> torch.Tensor:
    """Round every element to the nearest power of two (sign preserved)."""
    if not use_kernel:
        return po2_decode_ref(po2_encode_ref(x))
    return po2_decode(po2_encode(x.to(torch.float32).contiguous()))


def po2_quantize_tree(tree, **kw):
    """:func:`po2_quantize` on every leaf of a tree of tensors."""
    return tree_map(lambda g: po2_quantize(g, **kw), tree)
