"""Bitplane spike-history storage (port of ``repro.core.history``).

A ring buffer of bitplanes per population, the software form of the
paper's per-neuron shift register:

    ``planes`` : uint8[*lanes, depth, N]   planes[..., s, i] = spike of i at slot s
    ``head``   : int64[*lanes]             slot holding the *most recent* step

"Shift" overwrites slot ``(head+1) % depth`` and bumps ``head``.  The JAX
reference vmaps one ring over a lane axis; here the lane axes are written
out as leading dimensions and every lane keeps its own ``head``, so the
per-lane ring semantics are those of the reference exactly.  ``head`` is
int64 (torch's index type) where the reference stores int32; the values
are the same.

The packed form — one uint8 word per neuron, register slot k (k=0 newest)
at word bit ``7 - k`` — is the storage format of the fused CUDA kernel and
of the serving layer's per-session state.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class SpikeHistory(NamedTuple):
    """Ring-buffer bitplane history for N neurons (optionally per lane)."""

    planes: torch.Tensor  # uint8[*lanes, depth, N]
    head: torch.Tensor    # int64[*lanes], slot index of the most recent step

    @property
    def depth(self) -> int:
        return self.planes.shape[-2]

    @property
    def n(self) -> int:
        return self.planes.shape[-1]


def init_history(n: int, depth: int = 7, *, batch: tuple[int, ...] = (),
                 device: torch.device | str | None = None) -> SpikeHistory:
    """Empty history with ``head = depth - 1``, one ring per ``batch`` lane."""
    return SpikeHistory(
        planes=torch.zeros((*batch, depth, n), dtype=torch.uint8, device=device),
        head=torch.full(batch, depth - 1, dtype=torch.int64, device=device))


def push(h: SpikeHistory, spikes: torch.Tensor) -> SpikeHistory:
    """Record the current step's spikes (the hardware 'shift-in').

    ``spikes``: ``(*lanes, N)``; each lane writes slot ``(head+1) % depth``
    of its own ring.
    """
    new_head = (h.head + 1) % h.depth
    slots = torch.arange(h.depth, device=h.planes.device)
    write = (slots == new_head[..., None])[..., None]          # (*lanes, depth, 1)
    planes = torch.where(write, spikes.to(h.planes.dtype)[..., None, :], h.planes)
    return SpikeHistory(planes=planes, head=new_head)


def registers_depth_major(h: SpikeHistory) -> torch.Tensor:
    """``(*lanes, depth, N)`` logical registers, k=0 row the most recent.

    ``out[..., k, :] = planes[..., (head - k) % depth, :]``.
    """
    k = torch.arange(h.depth, device=h.planes.device)
    slots = (h.head[..., None] - k) % h.depth                  # (*lanes, depth)
    return torch.gather(h.planes, -2, slots[..., None].expand(*slots.shape, h.n))


def as_register(h: SpikeHistory) -> torch.Tensor:
    """``(*lanes, N, depth)`` registers, k=0 column the most recent (Figs. 2/3)."""
    return registers_depth_major(h).transpose(-1, -2)


def latest(h: SpikeHistory) -> torch.Tensor:
    """The most recent spike bit per neuron: ``(*lanes, N)`` uint8."""
    idx = h.head[..., None, None].expand(*h.head.shape, 1, h.n)
    return torch.gather(h.planes, -2, idx).squeeze(-2)


def pack_bitplanes(bits: torch.Tensor) -> torch.Tensor:
    """Pack depth-major ``(depth, ...)`` {0,1} bitplanes into uint8 words.

    The single owner of the MSB-first word layout: register slot k → word
    bit ``7 - k``.
    """
    depth = bits.shape[0]
    if depth > 8:
        raise ValueError("pack_bitplanes supports depth <= 8")
    shifts = torch.arange(7, 7 - depth, -1, dtype=torch.uint8, device=bits.device)
    shifts = shifts.reshape((depth,) + (1,) * (bits.dim() - 1))
    return torch.sum(bits.to(torch.uint8) << shifts, dim=0, dtype=torch.uint8)


def pack_words(h: SpikeHistory) -> torch.Tensor:
    """Pack each neuron's register into a uint8 word, MSB = most recent.

    ``(*lanes, N)`` uint8; the paper's 8-bit register file (depth ≤ 8).
    """
    if h.depth > 8:
        raise ValueError("pack_words supports depth <= 8")
    return pack_bitplanes(registers_depth_major(h).movedim(-2, 0))


def unpack_words(words: torch.Tensor, depth: int) -> torch.Tensor:
    """Inverse of :func:`pack_words` → ``(..., N, depth)`` bits, k=0 newest."""
    if depth > 8:
        raise ValueError("unpack_words supports depth <= 8")
    shifts = torch.arange(7, 7 - depth, -1, dtype=torch.uint8, device=words.device)
    return (words.to(torch.uint8)[..., None] >> shifts) & 1


def from_words(words: torch.Tensor, depth: int) -> SpikeHistory:
    """Rebuild a ring buffer from packed words: inverse of :func:`pack_words`.

    Every readout is rotation-invariant, so the canonical ``head = depth-1``
    (the :func:`init_history` layout) continues the trajectory
    bit-identically: the k-th newest register lands in plane ``depth-1-k``
    and the next :func:`push` overwrites plane 0, the oldest slot.  Every
    lane of a batched ``(*lanes, N)`` word tensor gets this same head.
    """
    regs = unpack_words(words, depth).transpose(-1, -2)         # (*lanes, depth, N)
    head = torch.full(words.shape[:-1], depth - 1, dtype=torch.int64,
                      device=words.device)
    return SpikeHistory(planes=regs.flip(-2), head=head)


def fixed_point_value(words: torch.Tensor, depth: int) -> torch.Tensor:
    """Read a packed word as the paper's binary fraction (eq. 2): word/128.

    The scale is depth-independent: slot k=0 sits at the MSB for every
    depth ≤ 8, so unused low bits are zero and add nothing.
    """
    del depth
    return words.to(torch.float32) / 128.0
