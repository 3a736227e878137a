"""Unsupervised STDP train-to-accuracy loop (port of
``repro.train.stdp_trainer``; the paper's system-level protocol behind
Table II).

  1. **Feature learning**: epochs of rate-coded batches drive
     ``snn.run_snn(train=True)``, with the dynamics reset between rasters;
     competition comes from soft inhibition / hard WTA and θ homeostasis.
  2. **Label assignment**: a held-out pass (``train=False``: weights and θ
     frozen) records per-neuron spike counts; each neuron is assigned to the
     class it responds to most (:func:`assign_labels`).
  3. **Evaluation**: a second held-out pass classifies each sample by the
     assigned-population vote (:func:`assignment_predict`).

Batches come from a data source (:class:`SamplerSource` by default: every
batch drawn from the network's sampler with ``torch.Generator``s seeded from
``TrainerConfig.seed``).  A source has three methods: ``initial_weights()``
(``None`` lets ``init_snn`` draw them), ``train_batches(epoch)`` and
``held_out_batches(epoch, fold)`` with ``fold`` ``"assign"`` or ``"eval"``;
each batch is a ``{"spikes": (T, B, N), "labels": (B,)}`` dict.  A test that
replays the JAX package's arrays passes a source of its own.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Iterator

import torch

from repro_torch.data.pipeline import Prefetcher, Sampler, spike_stream
from repro_torch.device import resolve_device
from repro_torch.models import snn


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """Epoch-level knobs of the train-to-accuracy loop.

    One epoch = ``batches_per_epoch`` rasters of ``batch`` samples ×
    ``t_steps`` simulation steps, followed by an assignment pass
    (``assign_batches``) and an evaluation pass (``eval_batches``) on freshly
    drawn held-out samples.
    """

    epochs: int = 5
    batches_per_epoch: int = 8
    batch: int = 16
    t_steps: int = 30
    assign_batches: int = 6
    eval_batches: int = 4
    seed: int = 0
    prefetch: bool = True

    def __post_init__(self):
        for name in ("epochs", "batches_per_epoch", "batch", "t_steps",
                     "assign_batches", "eval_batches"):
            v = getattr(self, name)
            if v < 1:
                raise ValueError(f"{name} must be >= 1, got {v}")


# ---------------------------------------------------------------------------
# Data sources
# ---------------------------------------------------------------------------

def _generator(seed: int, stream: int) -> torch.Generator:
    """One host generator per (seed, stream); distinct streams never share
    a seed (the CPU generator keeps 32 seed bits, so the pair is mixed)."""
    return torch.Generator().manual_seed((seed * 0x9E3779B1 + stream) % (1 << 32))


class SamplerSource:
    """The default data source: batches drawn from ``sampler`` with one
    generator per epoch and role, all seeded from ``tcfg.seed``."""

    def __init__(self, sampler: Sampler, tcfg: TrainerConfig):
        self.sampler = sampler
        self.tcfg = tcfg

    def initial_weights(self) -> None:
        return None

    def _stream(self, stream: int, n_batches: int) -> Iterator[dict]:
        return spike_stream(_generator(self.tcfg.seed, stream), self.sampler,
                            batch=self.tcfg.batch, t_steps=self.tcfg.t_steps,
                            n_steps=n_batches)

    def train_batches(self, epoch: int) -> Iterator[dict]:
        return self._stream(1000 + epoch, self.tcfg.batches_per_epoch)

    def held_out_batches(self, epoch: int, fold: str) -> Iterator[dict]:
        if fold == "assign":
            return self._stream(2000 + 2 * epoch, self.tcfg.assign_batches)
        if fold == "eval":
            return self._stream(2001 + 2 * epoch, self.tcfg.eval_batches)
        raise ValueError(f"fold must be 'assign' or 'eval', got {fold!r}")


# ---------------------------------------------------------------------------
# Label-assignment evaluator
# ---------------------------------------------------------------------------

def _onehot(labels: torch.Tensor, n_classes: int, device) -> torch.Tensor:
    labels = torch.as_tensor(labels, device=device).long()
    return torch.nn.functional.one_hot(labels, n_classes).to(torch.float32)


def assign_labels(counts: torch.Tensor, labels: torch.Tensor,
                  n_classes: int) -> torch.Tensor:
    """Assign each feature neuron to its max-mean-response class.

    ``counts`` is ``(N, F)`` spike counts over a held-out pass, ``labels``
    ``(N,)``; returns ``(F,)`` int32 assignments.  Neurons that never fire
    fall to class 0; ties go to the lowest class, as ``jnp.argmax``.
    """
    counts = torch.as_tensor(counts, dtype=torch.float32)
    onehot = _onehot(labels, n_classes, counts.device)              # (N, C)
    per_class = onehot.T @ counts                                   # (C, F)
    per_class = per_class / torch.clamp(onehot.sum(dim=0)[:, None], min=1.0)
    return torch.argmax(per_class, dim=0).to(torch.int32)


def assignment_predict(counts: torch.Tensor, assignments: torch.Tensor,
                       n_classes: int) -> torch.Tensor:
    """Classify by assigned-population vote: per sample, each class scores
    the *mean* spike count of the neurons assigned to it; ``(N,)`` int32."""
    counts = torch.as_tensor(counts, dtype=torch.float32)
    onehot = _onehot(assignments, n_classes, counts.device)         # (F, C)
    pop = torch.clamp(onehot.sum(dim=0), min=1.0)                   # (C,)
    votes = counts @ onehot / pop                                   # (N, C)
    return torch.argmax(votes, dim=-1).to(torch.int32)


def assignment_accuracy(counts: torch.Tensor, labels: torch.Tensor,
                        assignments: torch.Tensor, n_classes: int) -> float:
    pred = assignment_predict(counts, assignments, n_classes)
    labels = torch.as_tensor(labels, device=pred.device)
    return float(torch.mean((pred == labels).to(torch.float32)))


# ---------------------------------------------------------------------------
# Held-out feature collection + evaluation
# ---------------------------------------------------------------------------

def _collect_counts(state: snn.SNNState, cfg: snn.SNNConfig, batches: Iterable[dict],
                    batch: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Frozen-network spike counts over held-out batches."""
    feats, labels = [], []
    st = state
    for b in batches:
        st = snn.reset_dynamics(st, cfg, batch)
        st, counts = snn.run_snn(st, b["spikes"], cfg, train=False)
        feats.append(counts)
        labels.append(torch.as_tensor(b["labels"]).to(counts.device))
    return torch.cat(feats), torch.cat(labels)


def evaluate(state: snn.SNNState, cfg: snn.SNNConfig, n_classes: int,
             tcfg: TrainerConfig, assign_batches: Iterable[dict],
             eval_batches: Iterable[dict]) -> dict:
    """Label-assignment evaluation of a trained network on two disjoint
    held-out folds (assignment, then accuracy)."""
    counts_a, labels_a = _collect_counts(state, cfg, assign_batches, tcfg.batch)
    assignments = assign_labels(counts_a, labels_a, n_classes)
    counts_e, labels_e = _collect_counts(state, cfg, eval_batches, tcfg.batch)
    return {
        "accuracy": assignment_accuracy(counts_e, labels_e, assignments, n_classes),
        "assignments": assignments,
        "n_assigned_classes": int(torch.unique(assignments).numel()),
        "mean_eval_rate": float(counts_e.mean()) / tcfg.t_steps,
    }


# ---------------------------------------------------------------------------
# Epoch-level training loop
# ---------------------------------------------------------------------------

def train_to_accuracy(cfg: snn.SNNConfig, sampler: Sampler, n_classes: int,
                      tcfg: TrainerConfig, *, verbose: bool = False,
                      device: torch.device | str = "cuda",
                      source=None) -> dict:
    """Unsupervised STDP epochs + per-epoch label-assignment accuracy.

    Streams the source's training batches (prefetched to ``device`` when
    ``tcfg.prefetch``) through ``run_snn(train=True)`` with the dynamics
    reset between rasters, then evaluates after every epoch.  Returns the
    reference's result dict; the trained state rides along under ``"state"``.
    """
    dev = resolve_device(device)
    source = SamplerSource(sampler, tcfg) if source is None else source
    state = snn.init_snn(cfg, tcfg.batch, generator=_generator(tcfg.seed, 0),
                         w_init=source.initial_weights(), device=dev)
    curve, rates = [], []
    train_seconds = 0.0
    for epoch in range(tcfg.epochs):
        stream = source.train_batches(epoch)
        if tcfg.prefetch:
            stream = Prefetcher(stream, device=dev)
        t0 = time.time()
        try:
            for b in stream:
                state, _ = snn.run_snn(state, b["spikes"], cfg, train=True)
                state = snn.reset_dynamics(state, cfg, tcfg.batch)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        finally:
            if isinstance(stream, Prefetcher):
                stream.close()
        train_seconds += time.time() - t0
        ev = evaluate(state, cfg, n_classes, tcfg, source.held_out_batches(epoch, "assign"),
                      source.held_out_batches(epoch, "eval"))
        curve.append(ev["accuracy"])
        rates.append(ev["mean_eval_rate"])
        if verbose:
            print(f"  epoch {epoch + 1:2d}/{tcfg.epochs}: accuracy {ev['accuracy']:.3f} "
                  f"(rate {ev['mean_eval_rate']:.3f}, "
                  f"{ev['n_assigned_classes']}/{n_classes} classes assigned)", flush=True)
    return {
        "net": cfg.name,
        "rule": cfg.rule,
        "backend": cfg.backend,
        "epochs": tcfg.epochs,
        "batch": tcfg.batch,
        "t_steps": tcfg.t_steps,
        "sim_steps": tcfg.epochs * tcfg.batches_per_epoch * tcfg.t_steps,
        "chance": 1.0 / n_classes,
        "accuracy_curve": [float(a) for a in curve],
        "final_accuracy": float(curve[-1]),
        "mean_eval_rates": [float(r) for r in rates],
        "train_seconds": round(train_seconds, 3),
        "state": state,
    }
