"""Spike encoding (port of ``repro.core.encoding``; paper §IV-B, eqs. 28-29).

Per-sample min-max normalisation and Bernoulli rate coding.  The random
draws come from an explicit ``torch.Generator``; ``jax.random`` streams
cannot be matched, so parity tests compare statistics, or feed both
packages the same uniforms.  The ISI analysis tools come with ROADMAP queue
1 item 14.
"""
from __future__ import annotations

import torch


def minmax_normalise(x: torch.Tensor, axis=None, eps: float = 1e-12) -> torch.Tensor:
    """Min-max normalisation (eq. 28) over ``axis`` (all axes when None)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    if axis is None:
        lo, hi = x.amin(), x.amax()
    else:
        lo, hi = x.amin(dim=axis, keepdim=True), x.amax(dim=axis, keepdim=True)
    return (x - lo) / torch.clamp(hi - lo, min=eps)


def rate_code(generator: torch.Generator | None, x_norm: torch.Tensor,
              t_steps: int) -> torch.Tensor:
    """Bernoulli rate coding (eqs. 29-30): {0,1} uint8 ``(t_steps, *x.shape)``.

    P(spike at t) = x_norm elementwise.  The uniforms are drawn on the
    generator's device (the host for the default CPU generator) and the
    raster is returned on ``x_norm``'s device.
    """
    gen_device = generator.device if generator is not None else torch.device("cpu")
    u = torch.rand((t_steps, *x_norm.shape), generator=generator, device=gen_device)
    return (u.to(x_norm.device) < x_norm[None]).to(torch.uint8)
