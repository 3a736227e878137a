"""Kernel-backed LIF step (port of ``repro.kernels.lif.ops``).

:func:`lif_step_kernel` is the drop-in for ``core.lif.lif_step`` without a
threshold offset, on 1-D ``(n,)`` or 2-D ``(batch, n)`` membrane state.
``use_kernel=False`` runs the plain version on whatever device the state is
on; otherwise the kernel wrapper runs: the CUDA kernel for CUDA tensors, its
plain version for CPU tensors.  Nothing is padded.
"""
from __future__ import annotations

import torch

from repro_torch.core.lif import LIFParams, LIFState
from repro_torch.kernels.lif.kernel import lif_update
from repro_torch.kernels.lif.ref import lif_update_ref


def lif_step_kernel(state: LIFState, i_in: torch.Tensor, p: LIFParams, *,
                    use_kernel: bool = True) -> tuple[LIFState, torch.Tensor]:
    """One LIF step; returns ``(state', spikes)``, spikes bool."""
    v = state.v
    if v.dim() not in (1, 2):
        raise ValueError(f"lif_step_kernel: state must be (n,) or (batch, n), got "
                         f"{tuple(v.shape)}")
    kw = dict(alpha=p.alpha, e_rest=p.e_rest, v_th=p.v_th)
    if use_kernel:
        v2, s = lif_update(v.to(torch.float32).contiguous(),
                           i_in.to(torch.float32).contiguous(), **kw)
    else:
        v2, s = lif_update_ref(v, i_in, **kw)
    return LIFState(v=v2), s.to(torch.bool)
