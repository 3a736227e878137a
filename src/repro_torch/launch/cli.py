"""Shared CLI plumbing for the port's entry points (port of
``repro.launch.cli``): the serving launcher and the SNN training launcher.

Flags that feed ``EngineConfig`` / ``ServeConfig`` / ``SNNConfig`` /
``TrainerConfig`` are declared once here; the builders accept any
``argparse.Namespace``-shaped object and fall back to the dataclass
defaults for missing or ``None`` attributes.  ``--device`` is new in the
port (default ``cuda``).
"""
from __future__ import annotations

import argparse

from repro_torch import plasticity
from repro_torch.core.engine import EngineConfig
from repro_torch.data import synthetic_digits, synthetic_fashion, synthetic_fault
from repro_torch.kernels.dispatch import BACKENDS
from repro_torch.models import snn
from repro_torch.serve import ServeConfig
from repro_torch.train.stdp_trainer import TrainerConfig

# network → (sampler over the offline stand-in dataset, n_classes)
SAMPLERS = {
    "2layer-snn": (synthetic_digits, 10),
    "6layer-dcsnn": (synthetic_fashion, 10),
    "5layer-csnn": (synthetic_fault, 4),
}
assert set(SAMPLERS) == set(snn.PAPER_NETWORKS), (
    "SAMPLERS must cover every network in snn.PAPER_NETWORKS")


def sampler_for(net: str) -> tuple:
    """(sampler, n_classes) for one of the paper's networks."""
    return SAMPLERS[net]


def add_device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device of the state and kernels (cuda or cpu)")


def add_net_flag(ap: argparse.ArgumentParser, flag: str = "--net", *,
                 default: str | None = "2layer-snn") -> None:
    """The network selector; entry points pick the flag spelling (``--net``,
    or ``--snn`` as the training launcher's mode switch)."""
    ap.add_argument(flag, dest="net", default=default, choices=tuple(SAMPLERS),
                    help="which of the paper's three networks to train (2-layer fc "
                    "SNN, 6-layer conv DCSNN, 5-layer conv CSNN)")


def add_update_flags(ap: argparse.ArgumentParser) -> None:
    """Learning-rule / weight-update-datapath selection (rule × backend)."""
    ap.add_argument(
        "--rule", default="itp", choices=plasticity.rule_names(),
        help="learning rule: itp/itp_nocomp (intrinsic timing), the counter "
        "baselines exact/linear/imstdp, or mstdp (reward-modulated)")
    ap.add_argument(
        "--backend", default="reference", choices=BACKENDS,
        help="weight-update datapath: plain torch reference, the fused CUDA "
        "kernel, the kernel's plain version (fused_interpret), or the "
        "event-driven sparse datapath (itp, itp_nocomp, mstdp)")
    ap.add_argument(
        "--max-events", type=int, default=None,
        help="sparse backend's event-list cap per population and step (default: "
        "uncapped; past the cap the highest-indexed events are dropped)")


def add_serve_flags(ap: argparse.ArgumentParser) -> None:
    """Online-plasticity serving knobs; ``None`` defaults defer to
    ``ServeConfig``."""
    ap.add_argument("--n-pre", type=int, default=64,
                    help="presynaptic population size of each session's network")
    ap.add_argument("--n-post", type=int, default=16,
                    help="postsynaptic population size of each session's network")
    ap.add_argument("--depth", type=int, default=None,
                    help="timing-register depth: <= 8 for the history rules' packed "
                    "word (deeper histories run unpacked), <= 255 for the counter "
                    "rules' uint8 last-spike counter")
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
    add_device_flag(ap)


def add_train_flags(ap: argparse.ArgumentParser) -> None:
    """Epoch-level training and homeostasis knobs (``None`` defaults defer
    to the ``TrainerConfig`` / ``SNNConfig`` dataclass defaults)."""
    ap.add_argument("--epochs", type=int, default=None,
                    help="training epochs (each followed by a label-assignment "
                    "evaluation pass)")
    ap.add_argument("--batches-per-epoch", type=int, default=None, help="rasters per epoch")
    ap.add_argument("--batch", type=int, default=None,
                    help="samples per raster batch")
    ap.add_argument("--t-raster", type=int, default=None,
                    help="simulation steps per raster")
    ap.add_argument("--assign-batches", type=int, default=None,
                    help="held-out batches for the label-assignment pass")
    ap.add_argument("--eval-batches", type=int, default=None,
                    help="held-out batches for the accuracy pass")
    ap.add_argument("--seed", type=int, default=None, help="seed of the whole run")
    ap.add_argument("--hidden", type=int, default=None, help="hidden width (2layer-snn only)")
    ap.add_argument("--theta-plus", type=float, default=None,
                    help="adaptive-threshold homeostasis increment per spike (0 disables)")
    ap.add_argument("--theta-tau", type=float, default=None,
                    help="homeostasis threshold decay time constant (steps)")
    ap.add_argument("--inhibition", type=float, default=None,
                    help="soft lateral-inhibition strength")
    ap.add_argument("--hard-wta", action="store_true",
                    help="hard winner-take-all: only the most-driven super-threshold "
                    "neuron fires per sample/position")


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


def net_from_args(args) -> str:
    """The selected network: ``args.net`` from the shared flag, or an
    ``args.snn`` attribute of programmatic launcher namespaces."""
    net = getattr(args, "net", None) or getattr(args, "snn", None)
    if not net:
        raise ValueError(f"no network selected; choose one of {tuple(SAMPLERS)}")
    return net


def snn_config_from_args(args, *, net: str | None = None) -> snn.SNNConfig:
    """``SNNConfig`` from parsed flags; only flags the user set (non-``None``)
    override the network maker's defaults."""
    net = net or net_from_args(args)
    kw = {}
    if net == "2layer-snn" and getattr(args, "hidden", None) is not None:
        kw["n_hidden"] = args.hidden
    for name in ("theta_plus", "theta_tau", "inhibition"):
        v = getattr(args, name, None)
        if v is not None:
            kw[name] = v
    if getattr(args, "hard_wta", False):
        kw["hard_wta"] = True
    return snn.PAPER_NETWORKS[net](
        getattr(args, "rule", "itp"), backend=getattr(args, "backend", "reference"),
        max_events=getattr(args, "max_events", None), **kw)


def trainer_config_from_args(args) -> TrainerConfig:
    """``TrainerConfig`` from parsed flags (missing/``None`` → defaults).

    A ``steps`` attribute (total simulation steps, from programmatic
    namespaces) maps to one epoch of ``steps`` steps with a short evaluation,
    unless explicit epoch flags override it.
    """
    kw = {}
    for attr, field in (("epochs", "epochs"), ("batches_per_epoch", "batches_per_epoch"),
                        ("batch", "batch"), ("t_raster", "t_steps"),
                        ("assign_batches", "assign_batches"),
                        ("eval_batches", "eval_batches"), ("seed", "seed")):
        v = getattr(args, attr, None)
        if v is not None:
            kw[field] = v
    steps = getattr(args, "steps", None)
    if steps is not None and "t_steps" not in kw:
        kw["t_steps"] = max(min(steps, 30), 1)
        kw.setdefault("batches_per_epoch", max(steps // kw["t_steps"], 1))
        kw.setdefault("epochs", 1)
        kw.setdefault("assign_batches", 2)
        kw.setdefault("eval_batches", 2)
    return TrainerConfig(**kw)
