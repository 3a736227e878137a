"""Spike-encoding data pipeline (port of ``repro.data.pipeline``; paper §IV-B).

Chains a sampler with min-max normalisation (eq. 28) and Bernoulli rate
coding (eq. 29) into ``(T, B, N)`` uint8 spike rasters for the SNN training
loop, plus a double-buffered prefetcher so host-side generation overlaps
device compute.  Samplers take ``(generator, n)`` and return ``(x, labels)``.
"""
from __future__ import annotations

import collections
import threading
from typing import Callable, Iterator

import torch

from repro_torch.core.encoding import minmax_normalise, rate_code

Sampler = Callable[[torch.Generator, int], tuple[torch.Tensor, torch.Tensor]]


def encode_batch(generator: torch.Generator | None, x: torch.Tensor,
                 t_steps: int) -> torch.Tensor:
    """``(B, ...)`` floats → ``(T, B, features)`` {0,1} uint8 spikes:
    per-sample min-max normalisation, then Bernoulli rate coding."""
    B = x.shape[0]
    norm = minmax_normalise(x.reshape(B, -1), axis=-1)
    return rate_code(generator, norm, t_steps)


def spike_stream(generator: torch.Generator | None, sampler: Sampler, *, batch: int,
                 t_steps: int, n_steps: int | None = None) -> Iterator[dict]:
    """Stream of ``{spikes (T, B, N), labels (B,)}`` batches from a sampler;
    each batch draws its data, then its encoding, from ``generator``."""
    step = 0
    while n_steps is None or step < n_steps:
        x, labels = sampler(generator, batch)
        yield {"spikes": encode_batch(generator, x, t_steps), "labels": labels}
        step += 1


def _to_device(item, device):
    if device is None:
        return item
    if isinstance(item, dict):
        return {k: _to_device(v, device) for k, v in item.items()}
    if isinstance(item, torch.Tensor):
        return item.to(device, non_blocking=True)
    return item


class Prefetcher:
    """Double-buffered background prefetch of an iterator, optionally moving
    each item's tensors to ``device`` (host → device).

    The training loop's ``next()`` overlaps the *next* batch's generation and
    encoding with the current step's device compute.
    """

    def __init__(self, it: Iterator, depth: int = 2,
                 device: torch.device | str | None = None):
        self._it = it
        self._q: collections.deque = collections.deque()
        self._depth = depth
        self._device = device
        # guards _q, _done, _error and _stop; both sides wait on it
        self._cond = threading.Condition()
        self._done = False
        self._error: Exception | None = None
        self._stop = False
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self._it:
                item = _to_device(item, self._device)
                with self._cond:
                    while len(self._q) >= self._depth and not self._stop:
                        self._cond.wait()
                    if self._stop:
                        return
                    self._q.append(item)
                    self._cond.notify_all()
        except Exception as e:  # re-raised in the consumer by __next__
            with self._cond:
                self._error = e
        finally:
            with self._cond:
                self._done = True
                self._cond.notify_all()

    def close(self, timeout: float = 5.0) -> None:
        """Stop the background thread and drop buffered batches.

        Safe at any point, including before the source is exhausted (a loop
        that stops early, or an exception unwinding through the consumer).
        Idempotent; after it returns the fill thread has exited, unless the
        source itself blocks for longer than ``timeout`` seconds.
        """
        with self._cond:
            self._stop = True
            self._q.clear()
            self._cond.notify_all()
        self._thread.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        with self._cond:
            while not self._q and not self._done:
                self._cond.wait()
            if self._q:
                item = self._q.popleft()
                self._cond.notify_all()
                return item
            if self._error is not None:
                raise self._error
            raise StopIteration
