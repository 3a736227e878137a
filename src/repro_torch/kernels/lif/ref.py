"""Plain PyTorch version of the fused LIF kernel (``csrc/lif.cu``; port of
``repro.kernels.lif.ref``): ``v' = α·(v − E) + E + I``, ``s = v' > V_th``,
``v'' = s ? E : v'``.

Each operation rounds to float32 on its own, in this order, as the eager
reference ``repro.core.lif.lif_step`` and the CUDA kernel do.  The jitted
reference contracts ``α·(v−E) + E`` into an FMA and so differs from both
by an ulp on some membranes (ROADMAP queue 3).
"""
from __future__ import annotations

import torch


def lif_update_ref(v: torch.Tensor, i_in: torch.Tensor, *, alpha: float,
                   e_rest: float = 0.0, v_th: float = 1.0
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(v_next, spikes)`` with spikes as float32 {0, 1}."""
    v = v.to(torch.float32)
    v_new = alpha * (v - e_rest) + e_rest + i_in.to(torch.float32)
    spikes = v_new > v_th
    return torch.where(spikes, e_rest, v_new), spikes.to(torch.float32)
