"""Wrapper of the fused LIF CUDA kernel (``csrc/lif.cu``).

Port of the Pallas kernel ``repro/kernels/lif/kernel.py::lif_update``: the
integrate → compare → fire → reset step in one pass; see the source for the
design.  The wrapper calls its registered operator
(``torch.ops.repro_torch.lif_update``, ``kernels/_ops.py``): given CPU
tensors it runs the kernel's plain version (``ref.py``); given CUDA tensors
it launches the kernel on the current stream or raises — there is no
fallback.  It counts the calls that launch the kernel in
``lif_update.launches``, which callers may reset to 0; only the operator's
CUDA kernel adds to it.

Operands: the membrane ``v`` and the current ``i_in``, contiguous float32
tensors of one shape, any shape (flattened, nothing padded).  ``alpha``,
``e_rest`` and ``v_th`` are rounded to float32 once, here, as PyTorch rounds
a Python scalar in the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _launch, _ops
from repro_torch.kernels.lif.ref import lif_update_ref

_ENTRY = {"lif_update": [ctypes.c_void_p] * 4 + [ctypes.c_int64] + [ctypes.c_float] * 3}


def _cuda(v, i_in, *, alpha, e_rest, v_th):
    symbol = "lif_update"
    dev = _launch.check(symbol, {"v": (v, torch.float32), "i_in": (i_in, torch.float32)})
    v_out, s_out = torch.empty_like(v), torch.empty_like(v)
    lib = _launch.load("lif", _ENTRY)
    _launch.launch(lib, "lif", symbol, dev, v_out.data_ptr(), s_out.data_ptr(), v.data_ptr(),
                   i_in.data_ptr(), v.numel(), alpha, e_rest, v_th)
    lif_update.launches += 1
    return v_out, s_out


def _cpu(v, i_in, **kw):
    return tuple(t.contiguous() for t in lif_update_ref(v, i_in, **kw))


def _fake(v, i_in, **kw):
    """``(v', s)``: two float32 tensors of the membrane's shape."""
    _launch.check_operands("lif_update", {"v": (v, torch.float32),
                                          "i_in": (i_in, torch.float32)})
    return (v.new_empty(v.shape, dtype=torch.float32),
            v.new_empty(v.shape, dtype=torch.float32))


_OP = _ops.define("lif_update(Tensor v, Tensor i_in, *, float alpha, float e_rest, "
                  "float v_th) -> (Tensor, Tensor)", cpu=_cpu, cuda=_cuda, fake=_fake)


def lif_update(v: torch.Tensor, i_in: torch.Tensor, *, alpha: float,
               e_rest: float = 0.0, v_th: float = 1.0
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused LIF step: ``(v_next, spikes)`` with spikes as float32 {0, 1}."""
    _ops.check_device("lif_update", v)
    return _OP(v, i_in, alpha=alpha, e_rest=e_rest, v_th=v_th)


lif_update.launches = 0
