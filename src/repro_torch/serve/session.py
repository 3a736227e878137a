"""Per-user session state (port of ``repro.serve.session``).

A session's plasticity cache is the rule's packed uint8 word planes — one
history word per neuron for the intrinsic-timing rules — serialized and
rehydrated through :meth:`repro_torch.plasticity.UpdatePlan.session_words`
/ ``session_state``.  :class:`SessionStore` owns the id → state map with LRU
eviction under an optional capacity bound, the byte accounting, and
checkpoint/restore through :mod:`repro_torch.checkpoint` (atomic,
checksummed, session ids in LRU order in the manifest's ``extra``; the
reference's format, so either package restores the other's store).  State
lives on the store's device.
"""
from __future__ import annotations

import zlib
from collections import OrderedDict
from typing import Iterator, NamedTuple

import torch

from repro_torch import checkpoint as ckpt
from repro_torch import plasticity
from repro_torch.core.engine import EngineConfig
from repro_torch.device import resolve_device


class SessionState(NamedTuple):
    """One user's resident state, word-serialized timing state included."""

    w: torch.Tensor                        # float32[n_pre, n_post]
    pre_words: tuple[torch.Tensor, ...]    # uint8[n_pre] × words_per_neuron
    post_words: tuple[torch.Tensor, ...]   # uint8[n_post] × words_per_neuron
    v: torch.Tensor                        # float32[n_post] membrane
    theta: torch.Tensor                    # float32[n_post] adaptive threshold
    t: int                                 # steps served


class SessionStore:
    """LRU-bounded id → :class:`SessionState` map with byte accounting.

    ``get`` / ``put`` refresh recency, ``peek`` does not.  A fresh session's
    weights are drawn on the host from a ``torch.Generator`` seeded by
    ``(seed, crc32(sid))``, so a re-initialised session replays identically
    on any device.
    """

    def __init__(self, cfg: EngineConfig, *, capacity: int | None = None,
                 seed: int = 0, device: torch.device | str = "cuda"):
        if capacity is not None and capacity < 1:
            raise ValueError(f"capacity must be a positive session bound or "
                             f"None (unbounded), got {capacity}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.plan = plasticity.make_plan(cfg, self.device)
        self.capacity = capacity
        self.seed = seed
        self._sessions: OrderedDict[str, SessionState] = OrderedDict()

    # -- lifecycle ------------------------------------------------------

    def _generator(self, sid: str) -> torch.Generator:
        # stable across processes: the crc of the id folded into the seed.  The
        # CPU generator keeps only the low 32 bits of its seed, so the seed is
        # mixed in by an odd multiplier (a bijection mod 2^32), not shifted out
        mixed = (zlib.crc32(sid.encode()) ^ (self.seed * 0x9E3779B1)) & 0xFFFFFFFF
        return torch.Generator().manual_seed(mixed)

    def fresh_state(self, sid: str = "") -> SessionState:
        """A new session's state (weights keyed by ``(seed, sid)``)."""
        cfg = self.cfg
        u = torch.rand((cfg.n_pre, cfg.n_post), generator=self._generator(sid))
        return SessionState(
            w=(0.2 + 0.6 * u).to(self.device),
            pre_words=self.plan.init_words(cfg.n_pre),
            post_words=self.plan.init_words(cfg.n_post),
            v=torch.full((cfg.n_post,), cfg.lif.e_rest, dtype=torch.float32,
                         device=self.device),
            theta=torch.zeros((cfg.n_post,), dtype=torch.float32, device=self.device),
            t=0,
        )

    def init(self, sid: str) -> SessionState:
        """Create (or reset) ``sid``; evicts the LRU session at capacity."""
        if not sid or any(c in sid for c in "/\\\x00"):
            raise ValueError(f"invalid session id {sid!r}")
        if sid in self._sessions:
            del self._sessions[sid]
        elif self.capacity is not None and len(self._sessions) >= self.capacity:
            self.evict()
        state = self.fresh_state(sid)
        self._sessions[sid] = state
        return state

    def get(self, sid: str) -> SessionState:
        """Fetch ``sid``'s state and mark it most recently used."""
        state = self._sessions[sid]
        self._sessions.move_to_end(sid)
        return state

    def get_or_init(self, sid: str) -> SessionState:
        return self.get(sid) if sid in self._sessions else self.init(sid)

    def peek(self, sid: str) -> SessionState:
        """Fetch without refreshing recency."""
        return self._sessions[sid]

    def put(self, sid: str, state: SessionState) -> None:
        """Write back an updated state and mark it most recently used."""
        self._sessions[sid] = state
        self._sessions.move_to_end(sid)

    def touch(self, sid: str) -> None:
        """Mark ``sid`` most recently used without reading it."""
        self._sessions.move_to_end(sid)

    def evict(self, sid: str | None = None) -> str:
        """Drop ``sid`` (default: the least-recently-used session)."""
        if sid is None:
            sid, _ = self._sessions.popitem(last=False)
            return sid
        del self._sessions[sid]
        return sid

    def __contains__(self, sid: str) -> bool:
        return sid in self._sessions

    def __len__(self) -> int:
        return len(self._sessions)

    def __iter__(self) -> Iterator[str]:
        return iter(self._sessions)

    @property
    def session_ids(self) -> tuple[str, ...]:
        """Resident ids, least recently used first."""
        return tuple(self._sessions)

    # -- byte accounting ------------------------------------------------

    def state_bytes_per_session(self) -> int:
        """Bytes of the plasticity cache alone: the packed word planes of
        both populations (1 byte/neuron/word)."""
        return (self.cfg.n_pre + self.cfg.n_post) * self.plan.words_per_neuron()

    def resident_bytes_per_session(self) -> int:
        """Plasticity cache plus the float32 weights, membrane, θ and the
        step counter a live session keeps."""
        cfg = self.cfg
        return (self.state_bytes_per_session() + 4 * cfg.n_pre * cfg.n_post
                + 4 * cfg.n_post + 4 * cfg.n_post + 4)

    def sessions_per_gb(self, *, resident: bool = False) -> float:
        """Sessions per GiB: the plasticity cache alone, or everything."""
        per = (self.resident_bytes_per_session() if resident
               else self.state_bytes_per_session())
        return float(1 << 30) / per

    # -- checkpoint / restore -------------------------------------------

    def checkpoint(self, ckpt_dir: str, step: int | None = None) -> str:
        """Atomic checksummed save of every resident session.

        The tree is ``{sid: SessionState}``; the session ids in LRU order and
        the config's rule and shape ride in the manifest's ``extra``, so
        :meth:`restore` rebuilds its target without other state.
        """
        if step is None:
            step = len(ckpt.list_checkpoints(ckpt_dir))
        extra = {
            "sessions": list(self._sessions),   # LRU order, oldest first
            "rule": self.cfg.rule,
            "n_pre": self.cfg.n_pre,
            "n_post": self.cfg.n_post,
            "depth": self.cfg.depth,
        }
        return ckpt.save_checkpoint(ckpt_dir, step, dict(self._sessions), extra=extra)

    def restore(self, ckpt_dir: str, step: int | None = None) -> None:
        """Replace the resident map with a checkpoint's sessions, on this
        store's device, in the saved LRU order; every leaf's checksum is
        verified.  A checkpoint of another rule or shape raises a
        ``ValueError`` that names the field; none at all, ``FileNotFoundError``."""
        if step is None:
            step = ckpt.latest_checkpoint(ckpt_dir)
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {ckpt_dir!r}")
        extra = ckpt.load_manifest(ckpt_dir, step)["extra"]
        for field in ("rule", "n_pre", "n_post", "depth"):
            have, saved = getattr(self.cfg, field), extra[field]
            if saved != have:
                raise ValueError(f"checkpoint {field}={saved!r} does not match "
                                 f"store config {field}={have!r}")
        sids = extra["sessions"]
        target = {sid: self.fresh_state(sid) for sid in sids}
        restored = ckpt.restore_checkpoint(ckpt_dir, step, target)
        self._sessions = OrderedDict((sid, restored[sid]) for sid in sids)
