"""The benchmark's inputs, made on the device from ``--seed``.

A frozen copy of the port's synthetic-image arithmetic
(``repro_torch/data/synthetic.py``: the MNIST-class digits and the
Fashion-MNIST-class silhouettes) and of its encoding
(``repro_torch/data/pipeline.py``: per-sample min-max normalisation, then
Bernoulli rate coding), kept here so that no later change to the program
changes what the benchmark feeds it.  The draws come from a
``torch.Generator`` on the device, in a few large calls: one seed gives one
pool of rasters, and both the program and the reference are handed that
same pool.

Every traffic file names its ``dataset``; this module is the one generator
that reads them all.
"""
from __future__ import annotations

import math

import torch

WEIGHT_STREAM = 1
POOL_STREAM = 2


def generator(seed: int, stream: int, device: torch.device) -> torch.Generator:
    """One generator per (seed, stream) on ``device``; any whole seed."""
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9) % (1 << 63)
    return torch.Generator(device=device).manual_seed(mixed)


def _grid(side: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    lin = torch.linspace(-1.0, 1.0, side, dtype=torch.float32, device=device)
    return torch.meshgrid(lin, lin, indexing="ij")


def _digit_prototypes(side: int, n_classes: int, device) -> torch.Tensor:
    yy, xx = _grid(side, device)
    protos = []
    for c in range(n_classes):
        ang = 2.0 * math.pi * c / n_classes
        bar = torch.exp(-((xx * math.cos(ang) + yy * math.sin(ang)) ** 2) / 0.05)
        r = torch.sqrt(xx ** 2 + yy ** 2)
        ring = torch.exp(-((r - 0.3 - 0.4 * (c % 3) / 2.0) ** 2) / 0.02)
        protos.append(torch.clamp(1.8 * (0.7 * bar + 0.5 * ring), 0.0, 1.0))
    return torch.stack(protos)


def digits(gen: torch.Generator, n: int, *, side: int = 28, n_classes: int = 10,
           noise: float = 0.08, jitter: int = 2) -> torch.Tensor:
    """MNIST-class stand-in: ``(n, side, side)`` float32 in [0, 1]."""
    dev = gen.device
    labels = torch.randint(0, n_classes, (n,), generator=gen, device=dev)
    shifts = torch.randint(-jitter, jitter + 1, (n, 2), generator=gen, device=dev)
    z = torch.randn((n, side, side), generator=gen, device=dev)
    imgs = _digit_prototypes(side, n_classes, dev)[labels]
    idx = torch.arange(side, device=dev)
    rows = (idx[None, :] - shifts[:, 0:1]) % side
    cols = (idx[None, :] - shifts[:, 1:2]) % side
    imgs = imgs[torch.arange(n, device=dev)[:, None, None], rows[:, :, None], cols[:, None, :]]
    imgs = torch.clamp(imgs + noise * z, 0.0, 1.0)
    return torch.where(imgs < 0.12, 0.0, imgs)


def fashion(gen: torch.Generator, n: int, *, side: int = 28, n_classes: int = 10,
            noise: float = 0.2) -> torch.Tensor:
    """Fashion-MNIST-class stand-in: textured silhouettes, ``(n, side, side)``."""
    dev = gen.device
    labels = torch.randint(0, n_classes, (n,), generator=gen, device=dev)
    phase_u = torch.rand((n, 1, 1), generator=gen, device=dev)
    z = torch.randn((n, side, side), generator=gen, device=dev)
    yy, xx = _grid(side, dev)
    freqs = 2.0 + torch.arange(n_classes, dtype=torch.float32, device=dev)
    widths = 0.35 + 0.4 * (torch.arange(n_classes, device=dev) % 4) / 3.0
    f, w = freqs[labels], widths[labels]
    sil = ((xx.abs()[None] < w[:, None, None]).to(torch.float32)
           * (yy.abs()[None] < 0.8).to(torch.float32))
    tex = 0.7 + 0.3 * torch.sin(f[:, None, None] * math.pi * (xx[None] + yy[None])
                                + phase_u * math.pi)
    imgs = torch.clamp(sil * tex + noise * z * sil, 0.0, 1.0)
    return torch.where(imgs < 0.12, 0.0, imgs)


DATASETS = {"digits": digits, "fashion": fashion}


def rate_code(gen: torch.Generator, x: torch.Tensor, t_steps: int) -> torch.Tensor:
    """``(n, ...)`` images → ``(t_steps, n, features)`` {0,1} uint8: per-sample
    min-max normalisation (eq. 28), then P(spike) = the normalised value."""
    n = x.shape[0]
    flat = x.reshape(n, -1)
    lo = flat.amin(dim=-1, keepdim=True)
    hi = flat.amax(dim=-1, keepdim=True)
    norm = (flat - lo) / torch.clamp(hi - lo, min=1e-12)
    u = torch.rand((t_steps, *norm.shape), generator=gen, device=gen.device)
    return (u < norm[None]).to(torch.uint8)


def raster_pool(traffic: dict, pool: int, seed: int, device: torch.device) -> list[torch.Tensor]:
    """The cell's pool of ``pool`` rasters, each ``(t_steps, batch, features)``
    uint8 on ``device``; every sample of the pool is distinct."""
    gen = generator(seed, POOL_STREAM, device)
    batch = traffic["batch"]
    make = DATASETS[traffic["dataset"]]
    images = make(gen, batch * pool, **traffic.get("dataset_args", {}))
    rasters = rate_code(gen, images, traffic["t_steps"])
    return [r.contiguous() for r in rasters.split(batch, dim=1)]


def initial_weights(shapes: list[tuple[int, int]], seed: int,
                    device: torch.device) -> list[torch.Tensor]:
    """Uniform [0.2, 0.8) float32 weights, one ``(fan_in, out)`` matrix per
    learnable layer, as the port's ``init_snn`` draws them, made on the device
    in one call."""
    gen = generator(seed, WEIGHT_STREAM, device)
    sizes = [a * b for a, b in shapes]
    flat = 0.2 + 0.6 * torch.rand((sum(sizes),), generator=gen, device=device)
    return [w.reshape(s).contiguous() for w, s in zip(flat.split(sizes), shapes)]
