"""Shared CLI plumbing for the serving entry point (the serve half of
``repro.launch.cli``).

Flags that feed ``EngineConfig`` / ``ServeConfig`` are declared once here;
the builders accept any ``argparse.Namespace``-shaped object and fall back
to the dataclass defaults for missing or ``None`` attributes.  ``--device``
is new in the port (default ``cuda``).
"""
from __future__ import annotations

import argparse

from repro_torch import plasticity
from repro_torch.core.engine import EngineConfig
from repro_torch.kernels.dispatch import BACKENDS
from repro_torch.serve import ServeConfig


def add_update_flags(ap: argparse.ArgumentParser) -> None:
    """Learning-rule / weight-update-datapath selection (rule × backend)."""
    ap.add_argument(
        "--rule", default="itp",
        choices=tuple(sorted({*plasticity.rule_names(), *plasticity.UNPORTED_RULES})),
        help="learning rule; rules not ported yet fail naming their ROADMAP item")
    ap.add_argument(
        "--backend", default="reference", choices=BACKENDS,
        help="weight-update datapath: plain torch reference, the fused CUDA "
        "kernel, or the kernel's plain version (fused_interpret)")
    ap.add_argument(
        "--max-events", type=int, default=None,
        help="sparse backend's event-list cap (the sparse backend is not ported yet)")


def add_serve_flags(ap: argparse.ArgumentParser) -> None:
    """Online-plasticity serving knobs; ``None`` defaults defer to
    ``ServeConfig``."""
    ap.add_argument("--n-pre", type=int, default=64,
                    help="presynaptic population size of each session's network")
    ap.add_argument("--n-post", type=int, default=16,
                    help="postsynaptic population size of each session's network")
    ap.add_argument("--depth", type=int, default=None,
                    help="spike-history register depth (<= 8, the packed word width)")
    ap.add_argument("--max-batch", type=int, default=None,
                    help="serving lanes per step (batches are padded to this)")
    ap.add_argument("--t-steps", type=int, default=None,
                    help="simulation steps per request raster")
    ap.add_argument("--capacity", type=int, default=None,
                    help="resident-session bound (LRU eviction; default unbounded)")
    ap.add_argument("--seed", type=int, default=0,
                    help="PRNG seed; session weight init is keyed by (seed, sid)")
    ap.add_argument("--theta-plus", type=float, default=None,
                    help="per-session adaptive-threshold increment per post spike "
                    "(0 disables homeostasis)")
    ap.add_argument("--theta-tau", type=float, default=None,
                    help="adaptive-threshold decay time constant (steps)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the sessions and kernels (cuda or cpu)")


def engine_config_from_args(args) -> EngineConfig:
    """One serving session's private engine from parsed flags."""
    kw = {
        "n_pre": getattr(args, "n_pre", 64),
        "n_post": getattr(args, "n_post", 16),
        "rule": getattr(args, "rule", "itp"),
        "backend": getattr(args, "backend", "reference"),
        "max_events": getattr(args, "max_events", None),
    }
    if getattr(args, "depth", None) is not None:
        kw["depth"] = args.depth
    return EngineConfig(**kw)


def serve_config_from_args(args) -> ServeConfig:
    """``ServeConfig`` from parsed flags (``None`` defers to the defaults)."""
    kw = {}
    for field in ("max_batch", "t_steps", "theta_plus", "theta_tau", "capacity"):
        v = getattr(args, field, None)
        if v is not None:
            kw[field] = v
    return ServeConfig(**kw)
