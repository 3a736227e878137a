"""The port's kernels as registered torch operators, namespace ``repro_torch``.

Each kernel wrapper (``kernels/*/kernel.py``) defines one operator here at
import, so a trace (``make_fx``, ``torch.export``) holds one
``torch.ops.repro_torch.<name>`` node per launch, with its operands' shapes
and dtypes, where a ctypes call would be invisible.  Each operator has three
kernels and no more:

  * ``CPU``  — the kernel's plain version (``ref.py``), so ``fused`` on CPU
               tensors runs it (``kernels/dispatch.py``);
  * ``CUDA`` — the launch, with its operand checks and its error code; it
               alone counts ``<wrapper>.launches``;
  * fake     — the shape function a trace runs instead, which launches
               nothing and counts nothing.

No composite or default kernel is registered, so the dispatcher can never
run the plain version on CUDA tensors: a CUDA call reaches the launch or
raises.  The operators are defined through ``torch.library.Library``'s
``define`` and ``impl``: a ``torch.library.custom_op`` call costs several
times the host time per call (PERF.md), and the steps are host-bound.
"""
from __future__ import annotations

from typing import Callable

import torch

NAMESPACE = "repro_torch"
_LIB = torch.library.Library(NAMESPACE, "FRAGMENT")


def define(schema: str, *, cpu: Callable, cuda: Callable, fake: Callable):
    """Define the operator of ``schema`` (``"name(Tensor x, ...) -> Tensor"``)
    with its CPU, CUDA and fake kernels, once per process: a module imported
    again gets the operator already defined.  Returns the operator's
    overload packet, ``torch.ops.repro_torch.<name>``."""
    name = schema.split("(", 1)[0]
    if not hasattr(getattr(torch.ops, NAMESPACE), name):
        _LIB.define(schema)
        _LIB.impl(name, cpu, "CPU")
        _LIB.impl(name, cuda, "CUDA")
        torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name)


def check_device(symbol: str, t: torch.Tensor) -> None:
    """Raise unless ``t`` (a wrapper's first operand) lies on the CPU or a
    CUDA device: the operator's fake kernel would answer a meta tensor, and a
    wrapper never returns what nothing computed."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{symbol}: tensors must be on a CUDA device or the CPU, "
                         f"got {t.device}")

