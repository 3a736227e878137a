"""Online-plasticity serving (port of ``repro.serve.serving``).

Each request carries a spike raster for one user's private network.
:func:`serve_step` gathers up to ``ServeConfig.max_batch`` admitted
requests, rehydrates their sessions' word planes into timing state, runs
them as the lanes of one batched engine rollout with continual on-line
STDP — always padded to ``max_batch`` lanes, as in the reference — and
scatters the updated words, weights, membrane and θ back into the
:class:`~repro_torch.serve.session.SessionStore`.  With ``backend="fused"``
on a CUDA store every step's weight update of all lanes is one launch of
the fused CUDA kernel.

Lanes never interact, so a session's trajectory is bit-identical whether it
is served solo or interleaved with others.  ``learn=False`` requests run the
same dynamics read-only.  :class:`Server` is the async front end:
``submit``/``poll`` around a deterministic FIFO admission rule, a background
serving thread, a graceful ``shutdown(drain=True)``, and checkpoint/restore
of its session store.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.core.engine import EngineConfig, EngineState, engine_step
from repro_torch.core.lif import LIFState
from repro_torch.plasticity import UpdatePlan
from repro_torch.serve.session import SessionState, SessionStore


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Static serving knobs.

    ``t_steps`` fixes every request raster's length.  ``theta_plus`` /
    ``theta_tau`` are the per-session homeostasis: each post spike raises
    that neuron's threshold θ by ``theta_plus``, and θ decays by
    ``exp(-1/theta_tau)`` per step (0 disables).  ``capacity`` bounds
    resident sessions (LRU).
    """

    max_batch: int = 8
    t_steps: int = 16
    theta_plus: float = 0.0
    theta_tau: float = 100.0
    capacity: int | None = None

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.t_steps < 1:
            raise ValueError(f"t_steps must be >= 1, got {self.t_steps}")
        if self.theta_tau <= 0:
            raise ValueError(f"theta_tau must be > 0, got {self.theta_tau}")

    @property
    def theta_decay(self) -> float:
        return float(np.exp(-1.0 / self.theta_tau))  # as the reference computes it


@dataclasses.dataclass
class Request:
    """One unit of traffic: a ``(t_steps, n_pre)`` spike raster for ``sid``.

    ``learn=False`` marks eval traffic: nothing is written back.
    """

    sid: str
    raster: Any               # (t_steps, n_pre) {0,1} spikes, array-like
    learn: bool = True


@dataclasses.dataclass
class Result:
    """Completed request: the session's post-spike raster for this slice."""

    sid: str
    ticket: int
    post: np.ndarray          # (t_steps, n_post) uint8 spikes
    learned: bool             # False: eval traffic, state not written back


def _batched_rollout(plan: UpdatePlan, cfg: EngineConfig, scfg: ServeConfig,
                     learn: bool, w, pre_words, post_words, v, theta, rasters):
    """Engine rollout over ``max_batch`` independent sessions.

    Every tensor's leading axis is the lane axis (the reference vmaps over
    it); ``rasters`` is ``(lanes, t_steps, n_pre)``.  Returns the updated
    per-lane state plus the ``(lanes, t_steps, n_post)`` uint8 post rasters.
    """
    state = EngineState(w, plan.session_state(pre_words),
                        plan.session_state(post_words), LIFState(v))
    th = theta
    posts = []
    for x in rasters.unbind(1):
        state, out = engine_step(state, x, cfg, learn=learn, v_th_offset=th)
        th = th * scfg.theta_decay + scfg.theta_plus * out.to(torch.float32)
        posts.append(out)
    return (state.w, plan.session_words(state.pre_hist),
            plan.session_words(state.post_hist), state.neurons.v, th,
            torch.stack(posts, dim=1).to(torch.uint8))


def serve_step(store: SessionStore, requests: list[Request], scfg: ServeConfig,
               *, tickets: list[int] | None = None) -> list[Result]:
    """Serve one admitted batch; scatter updated state back to the store.

    ``requests`` must satisfy the admission invariants (≤ ``max_batch``, one
    ``learn`` flag, unique sids).  Sessions absent from the store are
    initialised on first touch; dead lanes are padded with a template
    session.
    """
    if not requests:
        return []
    if len(requests) > scfg.max_batch:
        raise ValueError(f"batch of {len(requests)} exceeds max_batch={scfg.max_batch}")
    learn = requests[0].learn
    sids = [r.sid for r in requests]
    if len(set(sids)) != len(sids):
        raise ValueError(f"duplicate session in batch: {sids}")
    if any(r.learn != learn for r in requests):
        raise ValueError("mixed learn flags in one batch")

    cfg = store.cfg
    rasters = []
    for r in requests:
        x = torch.as_tensor(np.asarray(r.raster), dtype=torch.float32)
        if tuple(x.shape) != (scfg.t_steps, cfg.n_pre):
            raise ValueError(f"request {r.sid!r}: raster shape {tuple(x.shape)} != "
                             f"({scfg.t_steps}, {cfg.n_pre})")
        rasters.append(x)

    states = [store.get_or_init(sid) for sid in sids]
    pad = scfg.max_batch - len(requests)
    if pad:
        states += [store.fresh_state("pad")] * pad
        rasters += [torch.zeros((scfg.t_steps, cfg.n_pre))] * pad

    dev = store.device
    words = store.plan.words_per_neuron()
    w, pw, qw, v, theta, post = _batched_rollout(
        store.plan, cfg, scfg, learn,
        torch.stack([s.w for s in states]),
        tuple(torch.stack([s.pre_words[k] for s in states]) for k in range(words)),
        tuple(torch.stack([s.post_words[k] for s in states]) for k in range(words)),
        torch.stack([s.v for s in states]),
        torch.stack([s.theta for s in states]),
        torch.stack(rasters).to(dev))

    post = post.cpu().numpy()
    if tickets is None:
        tickets = list(range(len(requests)))
    results = []
    for i, (r, ticket) in enumerate(zip(requests, tickets)):
        if learn:
            store.put(r.sid, SessionState(
                w=w[i], pre_words=tuple(p[i] for p in pw),
                post_words=tuple(q[i] for q in qw), v=v[i], theta=theta[i],
                t=states[i].t + scfg.t_steps))
        results.append(Result(sid=r.sid, ticket=ticket, post=post[i], learned=learn))
    return results


class Server:
    """Async submit/poll server over :func:`serve_step`.

    Single consumer: batches are admitted and served either by the
    background thread (:meth:`start`) or by explicit :meth:`step` calls;
    admission is deterministic in queue order, so both drives give
    bit-identical results.  ``batches`` counts the batches served.
    """

    def __init__(self, cfg: EngineConfig, scfg: ServeConfig, *, seed: int = 0,
                 store: SessionStore | None = None,
                 device: torch.device | str = "cuda"):
        self.scfg = scfg
        self.store = store if store is not None else SessionStore(
            cfg, capacity=scfg.capacity, seed=seed, device=device)
        self._tickets = itertools.count()
        self._queue: list[tuple[int, Request]] = []
        self._results: dict[int, Result] = {}
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._thread: threading.Thread | None = None
        self._running = False
        self.batches = 0

    @property
    def cfg(self) -> EngineConfig:
        """The engine config the sessions run (the store's)."""
        return self.store.cfg

    # -- submit / poll --------------------------------------------------

    def submit(self, req: Request) -> int:
        """Enqueue a request; returns the ticket :meth:`poll` redeems."""
        with self._work:
            ticket = next(self._tickets)
            self._queue.append((ticket, req))
            self._work.notify()
        return ticket

    def poll(self, ticket: int) -> Result | None:
        """The finished :class:`Result`, or ``None`` while pending."""
        with self._lock:
            return self._results.pop(ticket, None)

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    # -- batch admission + serving --------------------------------------

    def _admit(self) -> list[tuple[int, Request]]:
        """Pop the next batch (caller holds the lock): the longest FIFO
        prefix with the head's ``learn`` flag, no repeated session, and at
        most ``max_batch`` lanes."""
        if not self._queue:
            return []
        learn = self._queue[0][1].learn
        batch: list[tuple[int, Request]] = []
        aboard: set[str] = set()
        for item in self._queue:
            _, req = item
            if len(batch) == self.scfg.max_batch:
                break
            if req.learn != learn or req.sid in aboard:
                break
            batch.append(item)
            aboard.add(req.sid)
        del self._queue[:len(batch)]
        return batch

    def step(self) -> int:
        """Admit and serve one batch synchronously; returns lanes served."""
        with self._lock:
            batch = self._admit()
        if not batch:
            return 0
        results = serve_step(self.store, [r for _, r in batch], self.scfg,
                             tickets=[t for t, _ in batch])
        self.batches += 1
        with self._lock:
            for res in results:
                self._results[res.ticket] = res
        return len(results)

    def drain(self) -> int:
        """Serve until the queue is empty; returns total lanes served."""
        n = 0
        while served := self.step():
            n += served
        return n

    # -- async loop -----------------------------------------------------

    def start(self) -> None:
        """Start the background serving thread (idempotent)."""
        with self._lock:
            if self._running:
                return
            self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while True:
            with self._work:
                while self._running and not self._queue:
                    self._work.wait()
                if not self._running:
                    return
            self.step()

    def shutdown(self, *, drain: bool = True) -> int:
        """Stop the loop; ``drain=True`` serves every queued request first.

        Returns the lanes served during the drain.
        """
        with self._work:
            self._running = False
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        return self.drain() if drain else 0

    # -- persistence ----------------------------------------------------

    def checkpoint(self, ckpt_dir: str, step: int | None = None) -> str:
        return self.store.checkpoint(ckpt_dir, step)

    def restore(self, ckpt_dir: str, step: int | None = None) -> None:
        self.store.restore(ckpt_dir, step)
