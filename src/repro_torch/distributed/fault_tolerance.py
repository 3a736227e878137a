"""Fault tolerance: straggler watchdog, failure-injected restart, elastic
resume (port of ``repro.distributed.fault_tolerance``).

:class:`TrainingRunner` wraps any ``(state, batch) → (state, metrics)`` step
with the reference's control loop:

  * a checkpoint every ``ckpt_every`` steps (:class:`~repro_torch.checkpoint.
    AsyncCheckpointer`: host copy now, atomic checksummed write on a thread);
  * on a ``RuntimeError`` in a step (a lost node, simulated by
    :class:`FailureInjector`), restore the latest checkpoint and replay.  The
    batches are keyed by step number, so the replayed steps see the same
    data and the run ends where an uninterrupted one does, bit for bit;
  * a :class:`Watchdog` times each step against a rolling median and flags
    stragglers (more than ``threshold`` × the median);
  * :func:`elastic_reshard` moves a restored state onto another device.

Each step's metrics are read back as Python floats for the log, one host
sync per step where a metric is a device tensor, as in the reference.  On
a mesh every rank runs the loop with the same schedule: a sharded state is
gathered for each checkpoint, rank 0 writes it, and a restore puts every
rank's shards back (``checkpoint``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.checkpoint import (AsyncCheckpointer, latest_checkpoint, map_named_leaves,
                                    restore_checkpoint)


class Watchdog:
    """Rolling-median straggler detector with an injectable clock."""

    def __init__(self, threshold: float = 3.0, window: int = 32,
                 clock: Callable[[], float] = time.monotonic):
        self.threshold = threshold
        self.window = window
        self.clock = clock
        self.durations: list[float] = []
        self.stragglers: list[tuple[int, float, float]] = []  # (step, dur, median)
        self._t0: float | None = None

    def start(self) -> None:
        self._t0 = self.clock()

    def stop(self, step: int) -> bool:
        """Record the step's duration; True if it was a straggler."""
        dur = self.clock() - self._t0
        hist = self.durations[-self.window:]
        self.durations.append(dur)
        if len(hist) >= 8:
            med = sorted(hist)[len(hist) // 2]
            if dur > self.threshold * med:
                self.stragglers.append((step, dur, med))
                return True
        return False


@dataclasses.dataclass
class RunnerConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    max_restarts: int = 5
    straggler_threshold: float = 3.0


class FailureInjector:
    """Deterministic failure schedule: fail once at each of the given steps."""

    def __init__(self, fail_at: set[int] | None = None):
        self.fail_at = set(fail_at or ())
        self.fired: set[int] = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected node failure at step {step}")


class TrainingRunner:
    """Checkpoint/restart training loop with straggler monitoring."""

    def __init__(self, cfg: RunnerConfig, step_fn: Callable, batch_fn: Callable[[int], Any],
                 clock: Callable[[], float] = time.monotonic):
        """``step_fn(state, batch) → (state, metrics)``; ``batch_fn(step) →
        batch`` (keyed by step, so a replay sees the same data)."""
        self.cfg = cfg
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.ckpt = AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.keep)
        self.watchdog = Watchdog(cfg.straggler_threshold, clock=clock)
        self.restarts = 0
        self.log: list[dict] = []

    def _restore(self, state_template):
        step = latest_checkpoint(self.cfg.ckpt_dir)
        if step is None:
            return 0, state_template
        return step, restore_checkpoint(self.cfg.ckpt_dir, step, state_template)

    def run(self, state, n_steps: int, injector: FailureInjector | None = None):
        """Run to ``n_steps``, surviving failures by restore and replay."""
        start = 0
        template = state
        while True:
            try:
                for step in range(start, n_steps):
                    if injector is not None:
                        injector.maybe_fail(step)
                    batch = self.batch_fn(step)
                    self.watchdog.start()
                    state, metrics = self.step_fn(state, batch)
                    straggled = self.watchdog.stop(step)
                    self.log.append({"step": step, "straggler": straggled,
                                     **{k: float(v) for k, v in (metrics or {}).items()
                                        if hasattr(v, "__float__")}})
                    if (step + 1) % self.cfg.ckpt_every == 0:
                        self.ckpt.save(step + 1, state)
                self.ckpt.wait()
                self.ckpt.save(n_steps, state)
                self.ckpt.wait()
                return state
            except RuntimeError as e:
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise RuntimeError(
                        f"exceeded max_restarts={self.cfg.max_restarts}") from e
                self.ckpt.wait()
                start, state = self._restore(template)
                self.log.append({"event": "restart", "resume_step": start, "cause": str(e)})


def elastic_reshard(state, device: torch.device | str):
    """A (restored) state tree with every tensor moved onto ``device``."""
    return map_named_leaves(
        lambda _, x: x.to(device) if isinstance(x, torch.Tensor) else x, state)
