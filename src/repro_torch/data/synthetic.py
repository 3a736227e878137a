"""Procedurally generated stand-ins for the paper's three datasets and the
LM token streams (port of ``repro.data.synthetic``): MNIST-,
Fashion-MNIST- and motor-rotor-fault-class data with the same shapes and
dynamic range, and Zipf-distributed token batches for the LM stack.

Each generator draws its random numbers from an explicit
``torch.Generator`` and hands them to a deterministic ``*_from_draws``
function, the seam through which a test feeds both packages the same
draws.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator

import torch


def _grid(side: int) -> tuple[torch.Tensor, torch.Tensor]:
    lin = torch.linspace(-1.0, 1.0, side, dtype=torch.float32)
    yy, xx = torch.meshgrid(lin, lin, indexing="ij")
    return yy, xx


# ---------------------------------------------------------------------------
# Image-like datasets (digits / fashion stand-ins)
# ---------------------------------------------------------------------------

def _digit_prototypes(side: int, n_classes: int) -> torch.Tensor:
    """Deterministic stroke-pattern prototypes, one per class ``(c, side, side)``."""
    yy, xx = _grid(side)
    protos = []
    for c in range(n_classes):
        ang = 2.0 * math.pi * c / n_classes
        # oriented bar + class-dependent ring: distinct, overlapping strokes
        bar = torch.exp(-((xx * math.cos(ang) + yy * math.sin(ang)) ** 2) / 0.05)
        r = torch.sqrt(xx ** 2 + yy ** 2)
        ring = torch.exp(-((r - 0.3 - 0.4 * (c % 3) / 2.0) ** 2) / 0.02)
        protos.append(torch.clamp(1.8 * (0.7 * bar + 0.5 * ring), 0.0, 1.0))
    return torch.stack(protos)


def digits_from_draws(labels: torch.Tensor, shifts: torch.Tensor, z: torch.Tensor,
                      *, side: int = 28, n_classes: int = 10,
                      noise: float = 0.08) -> torch.Tensor:
    """Images from the draws: class prototypes rolled by ``shifts`` ``(n, 2)``
    plus ``noise·z``, clipped to [0, 1] with a true-zero background."""
    n = labels.shape[0]
    imgs = _digit_prototypes(side, n_classes)[labels.long()]       # (n, s, s)
    idx = torch.arange(side)
    rows = (idx[None, :] - shifts[:, 0:1].long()) % side           # jnp.roll per sample
    cols = (idx[None, :] - shifts[:, 1:2].long()) % side
    imgs = imgs[torch.arange(n)[:, None, None], rows[:, :, None], cols[:, None, :]]
    imgs = torch.clamp(imgs + noise * z, 0.0, 1.0)
    return torch.where(imgs < 0.12, 0.0, imgs)


def synthetic_digits(generator: torch.Generator | None, n: int, *, side: int = 28,
                     n_classes: int = 10, noise: float = 0.08, jitter: int = 2
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """MNIST stand-in: ``(n, side, side)`` float in [0, 1], labels ``(n,)``."""
    labels = torch.randint(0, n_classes, (n,), generator=generator)
    shifts = torch.randint(-jitter, jitter + 1, (n, 2), generator=generator)
    z = torch.randn((n, side, side), generator=generator)
    return digits_from_draws(labels, shifts, z, side=side, n_classes=n_classes,
                             noise=noise), labels


def fashion_from_draws(labels: torch.Tensor, phase_u: torch.Tensor, z: torch.Tensor,
                       *, side: int = 28, n_classes: int = 10,
                       noise: float = 0.2) -> torch.Tensor:
    """Textured silhouettes: per-class width and texture frequency, texture
    phase ``phase_u·π`` (``phase_u`` ``(n, 1, 1)`` uniforms)."""
    yy, xx = _grid(side)
    freqs = 2.0 + torch.arange(n_classes, dtype=torch.float32)
    widths = 0.35 + 0.4 * (torch.arange(n_classes) % 4) / 3.0
    f, w = freqs[labels.long()], widths[labels.long()]
    sil = ((xx.abs()[None] < w[:, None, None]).to(torch.float32)
           * (yy.abs()[None] < 0.8).to(torch.float32))
    tex = 0.7 + 0.3 * torch.sin(f[:, None, None] * math.pi * (xx[None] + yy[None])
                                + phase_u * math.pi)
    imgs = torch.clamp(sil * tex + noise * z * sil, 0.0, 1.0)
    return torch.where(imgs < 0.12, 0.0, imgs)


def synthetic_fashion(generator: torch.Generator | None, n: int, *, side: int = 28,
                      n_classes: int = 10, noise: float = 0.2
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fashion-MNIST stand-in: textured silhouettes (higher-noise regime)."""
    labels = torch.randint(0, n_classes, (n,), generator=generator)
    phase_u = torch.rand((n, 1, 1), generator=generator)
    z = torch.randn((n, side, side), generator=generator)
    return fashion_from_draws(labels, phase_u, z, side=side, n_classes=n_classes,
                              noise=noise), labels


def fault_from_draws(labels: torch.Tensor, phase_u: torch.Tensor, imp_u: torch.Tensor,
                     z: torch.Tensor, *, length: int = 512, channels: int = 2,
                     noise: float = 0.1) -> torch.Tensor:
    """Motor-current/flux signals: a fundamental at f0 plus class-dependent
    sidebands (1), rotational modulation (2) or impulsive bursts (3);
    ``phase_u`` ``(n, 1, 1)``, ``imp_u`` ``(n, length, 1)`` uniforms."""
    t = torch.linspace(0.0, 1.0, length, dtype=torch.float32)
    f0 = 50.0
    phase = phase_u * 2 * math.pi
    tt = t[None, :, None]
    ch_shift = torch.arange(channels)[None, None, :] * (math.pi / 2)
    base = torch.sin(2 * math.pi * f0 * tt + phase + ch_shift)
    lbl = labels.long()[:, None, None]
    side = (0.4 * torch.sin(2 * math.pi * (f0 - 4.0) * tt + phase + ch_shift)
            + 0.4 * torch.sin(2 * math.pi * (f0 + 4.0) * tt + phase + ch_shift))
    ecc = 0.5 * torch.sin(2 * math.pi * 12.5 * tt + ch_shift) * base
    impulses = (imp_u > 0.98).to(torch.float32) * 1.5
    sig = (base + torch.where(lbl == 1, side, 0.0) + torch.where(lbl == 2, ecc, 0.0)
           + torch.where(lbl == 3, impulses, 0.0))
    return sig + noise * z


def synthetic_fault(generator: torch.Generator | None, n: int, *, length: int = 512,
                    channels: int = 2, n_classes: int = 4, noise: float = 0.1
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Motor fault stand-in: ``(n, length, channels)`` signals, labels ``(n,)``."""
    labels = torch.randint(0, n_classes, (n,), generator=generator)
    phase_u = torch.rand((n, 1, 1), generator=generator)
    imp_u = torch.rand((n, length, 1), generator=generator)
    z = torch.randn((n, length, channels), generator=generator)
    return fault_from_draws(labels, phase_u, imp_u, z, length=length, channels=channels,
                            noise=noise), labels


# ---------------------------------------------------------------------------
# LM token streams
# ---------------------------------------------------------------------------

def zipf_tokens(generator: torch.Generator, batch: int, seq: int, vocab: int,
                alpha: float = 1.1) -> torch.Tensor:
    """Zipf-distributed token ids ``(batch, seq)`` int32 (realistic LM token
    marginals: id ``r`` with probability ∝ ``(r + 1)^-alpha``), drawn on the
    generator's device by inverse CDF.  The CDF is summed on the host in
    float64, one sequential sum with the same bits every call (a device
    scan, such as ``torch.multinomial``'s on CUDA, may add in another order
    from call to call and move a draw to the next id), so one seed gives one
    batch, as a replay after a restart needs."""
    ranks = torch.arange(1, vocab + 1, dtype=torch.float64)
    cdf = torch.cumsum(torch.exp(-alpha * torch.log(ranks)), 0)
    cdf = (cdf / cdf[-1]).to(generator.device)
    u = torch.rand(batch * seq, generator=generator, dtype=torch.float64,
                   device=generator.device)
    ids = torch.searchsorted(cdf, u, right=True).clamp_(max=vocab - 1)
    return ids.reshape(batch, seq).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class LMBatchSpec:
    batch: int
    seq: int
    vocab: int


def lm_batches(generator: torch.Generator, spec: LMBatchSpec,
               n_steps: int | None = None) -> Iterator[dict]:
    """Infinite (or ``n_steps``-long) stream of ``{tokens, labels}`` LM
    batches from ``generator``, on its device.

    labels = tokens shifted left (next-token prediction); the final column
    is masked with -1 (ignored by the loss)."""
    step = 0
    while n_steps is None or step < n_steps:
        toks = zipf_tokens(generator, spec.batch, spec.seq, spec.vocab)
        labels = torch.cat([toks[:, 1:], toks.new_full((spec.batch, 1), -1)], dim=1)
        yield {"tokens": toks, "labels": labels}
        step += 1


def host_shard(batch: dict, host_id: int, n_hosts: int) -> dict:
    """Per-host slice of a global batch (multi-host data loading)."""
    def slc(x):
        per = x.shape[0] // n_hosts
        return x[host_id * per:(host_id + 1) * per]
    return {k: slc(v) for k, v in batch.items()}
