"""Static-shape spike-event extraction (port of
``repro.kernels.itp_sparse.events``).

An event list is the first ``E = event_cap(n, max_events)`` active indices of
a ``(*lanes, n)`` activity vector in ascending order, padded with the
out-of-range sentinel ``n``: one list per lane, of a size that does not
depend on the spike density.  Past the cap the highest-indexed events are
dropped.  ``torch.nonzero`` has a data-dependent shape and waits for the
device, so the lists are built from the running count of active neurons
instead: slot j holds the first index whose count reaches j + 1
(``torch.searchsorted``), which is ``n`` when fewer than j + 1 are active.
Nothing here reads a value back to the host.  Indices are int64 (torch's
index type) where the reference returns int32; the values are the same.
"""
from __future__ import annotations

import torch


def event_cap(n: int, max_events: int | None) -> int:
    """The static event-list length for ``n`` neurons: ``n`` when uncapped
    (``None``), else ``max_events`` clamped to ``n``."""
    if max_events is None:
        return n
    if max_events < 1:
        raise ValueError(f"max_events must be >= 1, got {max_events}")
    return min(int(max_events), n)


def spike_events(spikes: torch.Tensor, max_events: int | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Event lists of a ``(*lanes, n)`` spike tensor (nonzero = event).

    Returns ``(idx, count)``: ``idx`` int64 ``(*lanes, E)``, the first ``E``
    active indices ascending, padded with ``n``; ``count`` int64 ``(*lanes,)``,
    the valid entries, saturating at ``E``.
    """
    n = spikes.shape[-1]
    cap = event_cap(n, max_events)
    running = torch.cumsum(spikes != 0, dim=-1)                  # (*lanes, n) int64
    rank = torch.arange(1, cap + 1, device=spikes.device)
    rank = rank.expand(*spikes.shape[:-1], cap).contiguous()
    idx = torch.searchsorted(running, rank)                      # n where none reaches it
    return idx, torch.clamp(running[..., -1], max=cap)


def word_events(words: torch.Tensor, depth: int, max_events: int | None = None,
                *, slot: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Event lists of register slot ``slot`` (0 = newest, word bit ``7 - slot``)
    of ``(*lanes, n)`` packed uint8 history words; the :func:`spike_events`
    contract."""
    if not 0 <= slot < depth:
        raise ValueError(f"slot must be in [0, {depth}), got {slot}")
    if depth > 8:
        raise ValueError("word_events reads packed words (depth <= 8)")
    bit = (words.to(torch.uint8) >> (7 - slot)) & 1
    return spike_events(bit, max_events)
