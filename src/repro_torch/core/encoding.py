"""Spike encoding and ISI analysis (port of ``repro.core.encoding``; paper
§IV-B, eqs. 28-30, Fig. 6).

Per-sample min-max normalisation and Bernoulli rate coding, and the
inter-spike-interval statistics used to select the spike-history depth (the
paper picks depth 7, covering 99.53 % of ISIs over three datasets).  The
random draws come from an explicit ``torch.Generator``; ``jax.random``
streams cannot be matched, so parity tests compare statistics, or feed both
packages the same uniforms.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
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


class ISIStats(NamedTuple):
    counts: np.ndarray    # histogram of ISI lengths, index i = ISI of i steps
    cdf: np.ndarray       # cumulative distribution
    n_spikes: int
    n_intervals: int

    def coverage(self, depth: int) -> float:
        """Fraction of ISIs ≤ depth (paper: depth 7 → 0.9953)."""
        if depth < 1:
            return 0.0
        return float(self.cdf[min(depth, len(self.cdf) - 1)])


def _raster(spikes) -> torch.Tensor:
    return torch.as_tensor(spikes).to(torch.bool)


def isi_histogram(spikes, max_isi: int = 64) -> ISIStats:
    """ISI distribution of a ``(T, N)`` spike raster, neuron by neuron on the
    host (an ISI of k: a spike at t and the next at t+k)."""
    s = _raster(spikes).cpu().numpy()
    T, N = s.shape
    counts = np.zeros(max_isi + 1, np.int64)
    t_idx = np.arange(T)
    n_intervals = 0
    for col in range(N):
        times = t_idx[s[:, col]]
        if times.size >= 2:
            isi = np.clip(np.diff(times), 0, max_isi)
            counts += np.bincount(isi, minlength=max_isi + 1)
            n_intervals += isi.size
    cdf = np.cumsum(counts) / max(1, counts.sum())
    return ISIStats(counts=counts, cdf=cdf, n_spikes=int(s.sum()), n_intervals=n_intervals)


def isi_histogram_batched(spikes, max_isi: int = 64) -> ISIStats:
    """Vectorised ISI histogram of a large ``(T, N)`` raster, on its device:
    each spike's distance to the previous one, from a running maximum of
    spike times.  Equals :func:`isi_histogram`."""
    s = _raster(spikes)
    T, N = s.shape
    t_idx = torch.arange(T, device=s.device)[:, None]
    spike_t = torch.where(s, t_idx, -1)
    prev = torch.cummax(spike_t, dim=0).values
    # previous spike strictly before t, -1 if none
    prev_before = torch.cat([torch.full((1, N), -1, dtype=prev.dtype, device=s.device),
                             prev[:-1]])
    isi = torch.where(s & (prev_before >= 0), t_idx - prev_before, 0)
    vals = torch.clamp(isi[isi > 0], 0, max_isi)
    counts = torch.bincount(vals, minlength=max_isi + 1).cpu().numpy().astype(np.int64)
    counts[0] = 0
    cdf = np.cumsum(counts) / max(1, counts.sum())
    return ISIStats(counts=counts, cdf=cdf, n_spikes=int(s.sum()),
                    n_intervals=int(counts.sum()))


def select_history_depth(stats: ISIStats, target_coverage: float = 0.99) -> int:
    """Smallest depth whose ISI coverage meets the target (paper: 7)."""
    for d in range(1, len(stats.cdf)):
        if stats.cdf[d] >= target_coverage:
            return d
    return len(stats.cdf) - 1
