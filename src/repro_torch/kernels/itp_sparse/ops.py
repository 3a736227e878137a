"""Event-driven weight updates: gather/scatter on the touched slices (port of
``repro.kernels.itp_sparse.ops``).

The dense update reads every (pre, post) pair and the XOR pair gate zeroes
most of them at realistic 1-5 % spike densities; these ops touch only the
slices next to events:

  * LTP writes the **columns** of post neurons that fired, adding the
    per-row magnitude ``(1-pre)·ltp``;
  * LTD writes the **rows** of pre neurons that fired, subtracting the
    per-column magnitude ``(1-post)·ltd``.

The two sides meet only on (pre-event × post-event) cells, where both masked
magnitudes are zero, so the sequence equals the dense ``clip(w + eta·dw)``
whenever ``w`` lies inside ``[w_min, w_max]`` (every init and update is
clipped).  Event lists come from :mod:`.events`: ``(*lanes, E)``, ascending,
padded with the sentinel ``n``; every lane is an independent update.

The sentinel never reaches an index op.  The reference gathers with
``mode="fill"`` and scatters with ``mode="drop"``; torch has neither, and an
out-of-range index is a device-side assert that ends the CUDA context.  So
each padding slot is pointed at its lane's last valid event and carries the
value computed for that event (or, in a lane with no event, at index 0
carrying ``w``'s own value): a duplicate write then stores the value the
valid slot stores, and the result is the same whichever write lands last.
Nothing is read back to the host, so a silent step costs the same launches
as any other and writes nothing.

The ops are functional, as the reference's: the weight update returns a new
tensor (a copy of ``w`` with the touched slices rewritten).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels.itp_sparse.events import spike_events
from repro_torch.kernels.itp_stdp_conv.kernel import itp_stdp_conv_delta


def _slots(idx: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(*lanes, E)`` event lists → in-range indices (each padding slot at
    its lane's last valid event, or 0) and whether each lane has an event,
    ``(*lanes, 1)``."""
    valid = idx < n
    count = valid.sum(dim=-1, keepdim=True)
    last = torch.gather(idx, -1, torch.clamp(count - 1, min=0))
    last = torch.where(count > 0, last, 0)
    return torch.where(valid, idx, last), count > 0


def _rewrite(w: torch.Tensor, events: torch.Tensor, dim: int,
             fn: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """``w`` (rewritten in place) with its event columns (``dim=-1``) or rows
    (``dim=-2``) replaced by ``fn`` of themselves."""
    idx, live = _slots(events, w.shape[dim])
    if dim == -1:
        idx = idx[..., None, :].expand(*w.shape[:-1], idx.shape[-1])
    else:
        idx = idx[..., :, None].expand(*w.shape[:-2], idx.shape[-1], w.shape[-1])
    old = torch.gather(w, dim, idx)
    return w.scatter_(dim, idx, torch.where(live[..., None], fn(old), old))


def sparse_weight_update(w: torch.Tensor, pre_spike: torch.Tensor,
                         post_spike: torch.Tensor, ltp_mag: torch.Tensor,
                         ltd_mag: torch.Tensor, *, eta: float = 1.0,
                         w_min: float = 0.0, w_max: float = 1.0,
                         max_events: int | None = None,
                         pre_events: torch.Tensor | None = None,
                         post_events: torch.Tensor | None = None) -> torch.Tensor:
    """Clipped event-driven update of ``(*lanes, n_pre, n_post)`` weights.

    ``ltp_mag`` / ``ltd_mag`` are the per-neuron magnitudes ``(*lanes, n_pre)``
    / ``(*lanes, n_post)`` the rule read from its timing state.  Event lists
    are extracted from the spikes under ``max_events`` unless given.
    """
    pre = pre_spike.to(torch.float32)
    post = post_spike.to(torch.float32)
    if pre_events is None:
        pre_events, _ = spike_events(pre, max_events)
    if post_events is None:
        post_events, _ = spike_events(post, max_events)
    ltp_row = ((1.0 - pre) * ltp_mag)[..., :, None]
    ltd_col = ((1.0 - post) * ltd_mag)[..., None, :]
    w = _rewrite(w.clone(), post_events, -1,
                 lambda cols: torch.clamp(cols + eta * ltp_row, w_min, w_max))
    return _rewrite(w, pre_events, -2,
                    lambda rows: torch.clamp(rows - eta * ltd_col, w_min, w_max))


def sparse_synapse_delta(pre_spike: torch.Tensor, post_spike: torch.Tensor,
                         ltp_mag: torch.Tensor, ltd_mag: torch.Tensor, *,
                         max_events: int | None = None) -> torch.Tensor:
    """Raw event-driven ``(*lanes, n_pre, n_post)`` Δw (no eta or clip): the
    LTP columns set to ``(1-pre)·ltp`` in zeros, then the LTD rows lowered by
    ``(1-post)·ltd`` (so the overlap stays exact).  The SNN fc layers take
    the batch as lanes and sum."""
    pre = pre_spike.to(torch.float32)
    post = post_spike.to(torch.float32)
    pre_events, _ = spike_events(pre, max_events)
    post_events, _ = spike_events(post, max_events)
    ltp_row = ((1.0 - pre) * ltp_mag)[..., :, None]
    ltd_col = ((1.0 - post) * ltd_mag)[..., None, :]
    dw = pre.new_zeros((*pre.shape, post.shape[-1]))
    dw = _rewrite(dw, post_events, -1, lambda cols: ltp_row.expand_as(cols))
    return _rewrite(dw, pre_events, -2, lambda rows: rows - ltd_col)


def sparse_conv_delta(pre_patches: torch.Tensor, post_spikes: torch.Tensor,
                      pre_bits: torch.Tensor, post_bits: torch.Tensor,
                      po2_ltp: torch.Tensor, po2_ltd: torch.Tensor, *,
                      nearest: bool = True,
                      max_events: int | None = None) -> torch.Tensor:
    """Event-driven ``(K, C)`` conv delta: the conv kernel on active rows only.

    A patch row contributes only if it carries a current-step spike on
    either side (history bits alone pass nothing through the pair gate), so
    one event list over the M rows gathers the ``(M, K)`` / ``(M, C)`` spikes
    and the ``(depth, M, ·)`` bitplanes down to E rows, and the conv kernel
    (:func:`~repro_torch.kernels.itp_stdp_conv.kernel.itp_stdp_conv_delta`:
    kernel 4 on CUDA tensors, its plain version on CPU tensors) contracts
    them.  Padding rows gather as zeros and add exactly zero, so the result
    is the dense delta whenever every active row fits the cap.
    """
    pre = pre_patches.to(torch.float32)
    post = post_spikes.to(torch.float32)
    m = pre.shape[0]
    rows, _ = spike_events((pre != 0).any(dim=1) | (post != 0).any(dim=1), max_events)
    live = rows < m
    rows = torch.clamp(rows, max=m - 1)

    def gather(a: torch.Tensor, axis: int) -> torch.Tensor:
        keep = live.reshape((-1,) + (1,) * (a.dim() - axis - 1))
        return torch.where(keep, a.to(torch.float32).index_select(axis, rows), 0.0)

    return itp_stdp_conv_delta(gather(pre, 0), gather(post, 0), gather(pre_bits, 1),
                               gather(post_bits, 1), po2_ltp, po2_ltd, nearest=nearest)
