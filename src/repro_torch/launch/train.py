"""Training launcher: ``python -m repro_torch.launch.train --snn <net> [...]``.

Trains one of the paper's networks (2-layer SNN, 6-layer DCSNN, 5-layer
CSNN) with unsupervised STDP on ``--device`` (default ``cuda``), through the
shared train-to-accuracy loop of ``repro_torch.train.stdp_trainer`` and the
shared flag builders of ``repro_torch.launch.cli``: epochs of rate-coded
stand-in data, a label-assignment evaluation after each, and one summary
line with the synaptic-update throughput (SOP/s) and the accuracy.  With
``--backend fused`` the conv layers run the im2col conv kernel and the fc
layer the dense kernel.  The reference launcher's engine and LM modes are
not ported yet (ROADMAP queue 1 items 16 and 18).
"""
from __future__ import annotations

import argparse
import math

from repro_torch.launch import cli
from repro_torch.models import snn
from repro_torch.train.stdp_trainer import train_to_accuracy


def synaptic_updates_per_step(cfg: snn.SNNConfig, batch: int) -> int:
    """Synapse updates per simulation step: every learnable layer touches its
    full ``(fan_in × out)`` matrix once per patch row."""
    updates = 0
    shapes = [tuple(cfg.input_shape)] + snn._layer_shapes(cfg)
    for spec, in_shape, out_shape in zip(cfg.layers, shapes[:-1], shapes[1:]):
        if spec.kind.startswith("pool"):
            continue
        updates += (batch * math.prod(out_shape[:-1]) * snn._fan_in(spec, in_shape)
                    * spec.out_features)
    return updates


def run_snn_training(args) -> dict:
    """One of the paper's SNNs trained to accuracy on the selected rule and
    backend; returns the summary dict (also printed)."""
    net = cli.net_from_args(args)
    cfg = cli.snn_config_from_args(args, net=net)
    tcfg = cli.trainer_config_from_args(args)
    sampler, n_classes = cli.sampler_for(net)
    result = train_to_accuracy(cfg, sampler, n_classes, tcfg, verbose=True,
                               device=getattr(args, "device", "cuda"))
    run_s = result["train_seconds"]
    updates = synaptic_updates_per_step(cfg, tcfg.batch)
    summary = {
        "net": cfg.name, "rule": cfg.rule, "backend": cfg.backend,
        "device": str(result["state"].weights[0].device),
        "batch": tcfg.batch,
        "steps": result["sim_steps"],
        "epochs": tcfg.epochs,
        "run_seconds": round(run_s, 4),
        "sops_per_s": result["sim_steps"] * updates / max(run_s, 1e-9),
        "mean_rate": result["mean_eval_rates"][-1],
        "accuracy_curve": result["accuracy_curve"],
        "final_accuracy": result["final_accuracy"],
        "chance": result["chance"],
    }
    print(f"snn training [{cfg.name} / {cfg.rule} / {cfg.backend} / {summary['device']}]: "
          f"batch {tcfg.batch} × {result['sim_steps']} steps — "
          f"{summary['sops_per_s']:.3e} SOP/s (train {run_s:.2f}s incl. kernel build), "
          f"accuracy {summary['final_accuracy']:.3f} (chance {summary['chance']:.3f})",
          flush=True)
    return summary


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    cli.add_net_flag(ap, "--snn", default=None)
    cli.add_update_flags(ap)
    cli.add_train_flags(ap)
    cli.add_device_flag(ap)
    args = ap.parse_args(argv)
    if not args.net:
        ap.error("only the --snn <net> mode is ported; the engine and LM modes come "
                 "with ROADMAP queue 1 items 16 and 18")
    return run_snn_training(args)


if __name__ == "__main__":
    main()
