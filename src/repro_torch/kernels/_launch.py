"""Shared plumbing of the elementwise kernel wrappers (``lif``, ``llsmu``,
``po2_quant``): loading a library's entry points, the operand checks, and
the launch with its device, stream and error code.

An elementwise kernel takes contiguous operands of one shape, on one CUDA
device, each of a fixed dtype, and an element count; it launches on the
current stream and returns its ``cudaError_t`` (0 on success), which is
raised here with the library's own message.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build


def load(stem: str, entry_points: dict[str, list]) -> ctypes.CDLL:
    """The library built from ``csrc/<stem>.cu`` with each entry point's
    argument types set (every entry point returns an int error code); the
    types are set once, when the library first loads."""
    def set_types(lib: ctypes.CDLL) -> None:
        for name, argtypes in entry_points.items():
            fn = getattr(lib, name)
            fn.argtypes = [*argtypes, ctypes.c_int, ctypes.c_void_p]   # + device, stream
            fn.restype = ctypes.c_int
        err = getattr(lib, f"{stem}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p

    return _build.library(stem, set_types)


def check_operands(symbol: str, operands: dict[str, tuple[torch.Tensor, torch.dtype]],
                   scalars: dict[str, tuple[torch.Tensor, torch.dtype]] | None = None
                   ) -> None:
    """The rules a launch and its fake kernel share: every operand has the
    first one's shape and its own stated dtype; each of ``scalars`` (one
    element each, of any shape) its dtype."""
    shape = next(iter(operands.values()))[0].shape
    for name, (t, dtype) in {**operands, **(scalars or {})}.items():
        if t.dtype != dtype:
            raise TypeError(f"{symbol}: {name} must be {dtype}, got {t.dtype}")
        if name in operands and t.shape != shape:
            raise ValueError(f"{symbol}: {name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")


def check(symbol: str, operands: dict[str, tuple[torch.Tensor, torch.dtype]],
          scalars: dict[str, tuple[torch.Tensor, torch.dtype]] | None = None
          ) -> torch.device:
    """Raise unless every operand lies on the first one's CUDA device,
    :func:`check_operands` holds, and every operand is contiguous (checked
    in that order); each of ``scalars`` is checked for device and dtype
    alone."""
    dev = next(iter(operands.values()))[0].device
    if dev.type != "cuda":
        raise ValueError(f"{symbol}: tensors must be on a CUDA device or the CPU, got {dev}")
    for name, (t, _) in {**operands, **(scalars or {})}.items():
        if t.device != dev:
            raise ValueError(f"{symbol}: {name} is on {t.device}, expected {dev}")
    check_operands(symbol, operands, scalars)
    for name, (t, _) in operands.items():
        if not t.is_contiguous():
            raise ValueError(f"{symbol}: {name} must be contiguous")
    return dev


def launch(lib: ctypes.CDLL, stem: str, symbol: str, dev: torch.device, *args) -> None:
    """Call ``symbol`` with ``args``, the device index and the current stream;
    raise on a non-zero error code."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    rc = getattr(lib, symbol)(*args, index, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        message = getattr(lib, f"{stem}_error_string")(rc).decode()
        raise RuntimeError(f"{symbol}: CUDA launch failed: {message}")
