"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device`` (default ``"cuda"``) and
resolves it here: a CUDA device on a host without one raises instead of
quietly running on the CPU, and a CUDA device switches off TF32 for float32
matrix products (the parity contract forbids it: TF32 keeps about three
decimal digits, the JAX reference computes in full float32).

:func:`eager` wraps the functions that build the constant tensors the port caches
per shape and device (po2 read vectors, window tables, im2col indices,
update plans).  :func:`deterministic` runs the LM training step with
PyTorch's deterministic algorithms.
"""
from __future__ import annotations

import contextlib
import functools

import torch
import torch.utils.deterministic
from torch.utils._python_dispatch import _disable_current_modes


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises if CUDA is absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                f"is False; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}; use 'cuda' or 'cpu'")
    return dev


def eager(build):
    """``build`` run with every active dispatch mode set aside, so the
    tensors it returns are real ones even when it is first called inside a
    trace (``make_fx``, ``torch.export``).  Put it under a
    ``functools.lru_cache``: a cache that kept a fake tensor from a trace
    would hand it to every later eager call and every later trace.  A trace
    holds such a tensor as a constant, the same bits the eager path reads."""
    @functools.wraps(build)
    def built_eagerly(*args, **kwargs):
        with _disable_current_modes():
            return build(*args, **kwargs)
    return built_eagerly


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms for the body, then the previous
    setting.  On CUDA the backwards of the LM's gathers (the embedding rows,
    the MoE's token gather and combine) otherwise add floats with atomics, so
    two runs of one step would differ.  Uninitialised memory is not filled
    (no op of the port reads it).  cuBLAS needs ``CUBLAS_WORKSPACE_CONFIG``
    from the process's first cuBLAS call (``repro_torch/__init__.py`` sets
    it)."""
    was = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn_only)
        torch.utils.deterministic.fill_uninitialized_memory = fill
