"""Backend names and padding helpers (port of ``repro.kernels.dispatch``).

``BACKENDS`` keeps the reference's names so configs map one to one:

  * ``reference``       — plain torch (the rank-1 register-read path)
  * ``fused``           — the hand-written CUDA kernel (on CPU tensors its
                          wrapper runs the kernel's plain version)
  * ``fused_interpret`` — the kernel's plain version, on any device: the
                          port's analogue of Pallas interpret mode
  * ``sparse``          — event-driven datapath (``kernels/itp_sparse``):
                          static-shape event lists gate gather/scatter
                          updates of only the touched weight slices; not a
                          kernel path, so it maps to ``use_kernel=False``
                          and the plan branches on the name

The event-list primitives of ``itp_sparse.events`` and the im2col layout
helpers of ``itp_stdp_conv.ops`` re-export here lazily
(PEP 562 ``__getattr__``, so importing ``dispatch`` from inside a kernel
package never cycles), as the reference re-exports them: the models import
this module instead of reaching into a kernel package.
"""
from __future__ import annotations

import importlib

import torch
import torch.nn.functional as F

# name → defining module of the kernel-package re-exports; resolved on first
# attribute access and cached in globals()
_KERNEL_REEXPORTS = {
    "event_cap": "repro_torch.kernels.itp_sparse.events",
    "spike_events": "repro_torch.kernels.itp_sparse.events",
    "word_events": "repro_torch.kernels.itp_sparse.events",
    "im2col_1d": "repro_torch.kernels.itp_stdp_conv.ops",
    "im2col_2d": "repro_torch.kernels.itp_stdp_conv.ops",
    "im2col_words_1d": "repro_torch.kernels.itp_stdp_conv.ops",
    "im2col_words_2d": "repro_torch.kernels.itp_stdp_conv.ops",
}


def __getattr__(name: str):
    target = _KERNEL_REEXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(target), name)
    globals()[name] = value
    return value

LANE = 128

BACKENDS = ("reference", "fused", "fused_interpret", "sparse")


def resolve_backend(backend: str) -> tuple[bool, bool]:
    """Map a backend name to the ``(use_kernel, interpret)`` pair."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; have {BACKENDS}")
    if backend == "sparse":
        return False, False
    return backend != "reference", backend == "fused_interpret"


def resolve_packed(packed_history: bool, *, depth: int,
                   use_kernel: bool = True) -> bool:
    """Single owner of the packed-vs-unpacked operand selection.

    The packed word holds ``depth <= 8`` register bits; deeper histories keep
    the bitplane operands (bit-identical, so the fallback is silent), and the
    reference path always reads the unpacked registers it is defined on.
    """
    return bool(packed_history) and use_kernel and depth <= 8


def default_fused_backend() -> str:
    """The fused backend this host can run: ``fused`` (the CUDA kernels)
    where a card is present, else ``fused_interpret`` (their plain
    versions), so selecting the fused path never silently means the plain
    version on a machine with a card."""
    return "fused" if torch.cuda.is_available() else "fused_interpret"


def default_interpret() -> bool:
    """The ``interpret`` flag of :func:`default_fused_backend`."""
    return resolve_backend(default_fused_backend())[1]


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def pad_axis(x: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    """Zero-pad ``x`` along ``axis`` up to length ``n`` (no-op if equal)."""
    pad = n - x.shape[axis]
    if pad == 0:
        return x
    axis %= x.dim()
    widths = [0, 0] * (x.dim() - 1 - axis) + [0, pad]   # F.pad lists the last dim first
    return F.pad(x, widths)
