"""The hybrid family's weights, made on the device from ``--seed``: the
parameter tree of a Mamba-2/attention stack (``reference/granite.py``'s
``leaf_shapes``, the layout of the port's ``models/transformer.py``).  The
token batches are the LM family's (``lm_inputs.token_pool``).

The law is the LM family's (``lm_inputs.py``) where the leaves are alike:
every matrix truncated normal in [-2, 2] times 1/sqrt(fan_in), from one
draw, the token table normal times 0.02, norm scales 1.  The SSM's own
leaves follow a frozen copy of the port's ``models/ssm.py init_ssm``: the
conv's weight normal times 0.1 (one draw), its bias 0, ``a_log`` =
log(linspace(1, 16, heads)), ``d_skip`` 1, ``dt_bias`` 0.  All on one
``torch.Generator`` on the device, so that the program and the reference
are handed the same float32 master weights and no change to the program
changes them.
"""
from __future__ import annotations

import math

import torch

from port_bench.inputs import generator
from port_bench.lm_inputs import paths
from port_bench.reference.granite import leaf_shapes
from port_bench.reference.lm import unflatten

WEIGHT_STREAM = 5

MATRICES = ("wq", "wk", "wv", "wo", "gate", "up", "down", "wz", "wxbc", "wdt", "out_proj")


def _leaf(path: str) -> str:
    return path.split(".")[-1]


def initial_params(cfg: dict, seed: int, device: torch.device) -> dict:
    """The float32 master weights from ``seed``."""
    gen = generator(seed, WEIGHT_STREAM, device)
    shapes = paths(leaf_shapes(cfg))
    matrices = [(p, s) for p, s in shapes if _leaf(p) in MATRICES]
    flat = torch.empty(sum(math.prod(s) for _, s in matrices), device=device)
    torch.nn.init.trunc_normal_(flat, a=-2.0, b=2.0, generator=gen)
    drawn = dict(zip([p for p, _ in matrices],
                     flat.split([math.prod(s) for _, s in matrices])))
    tok = torch.empty(dict(shapes)["embed.tok"], device=device).normal_(generator=gen).mul_(0.02)
    conv_shape = dict(shapes)["mamba_blocks.ssm.conv_w"]
    conv_w = torch.empty(conv_shape, device=device).normal_(generator=gen).mul_(0.1)
    heads = dict(shapes)["mamba_blocks.ssm.a_log"]
    a_log = torch.log(torch.linspace(1.0, 16.0, heads[-1], device=device)).expand(heads)
    leaves = []
    for path, shape in shapes:
        name = _leaf(path)
        if path == "embed.tok":
            leaves.append(tok)
        elif path in drawn:
            leaves.append(drawn[path].view(shape).mul_(1.0 / math.sqrt(shape[-2])))
        elif name == "conv_w":
            leaves.append(conv_w)
        elif name == "a_log":
            leaves.append(a_log.contiguous())
        elif name in ("conv_b", "dt_bias"):
            leaves.append(torch.zeros(shape, device=device))
        else:                       # norm scales, d_skip
            leaves.append(torch.ones(shape, device=device))
    return unflatten(leaf_shapes(cfg), leaves)
