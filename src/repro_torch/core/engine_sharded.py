"""The weight-sharded ITP-STDP learning engine (port of
``repro.core.engine_sharded``).

The synapse matrix is cut into ``(pre_tile, post_tile)`` tiles over a
``(data, model)`` grid of ``torch.distributed`` ranks
(:mod:`repro_torch.distributed.sharding`); each rank updates its tile from
*replicated* spike histories and membrane.  The update is local because the
per-neuron Δw magnitudes are rank-1: no per-synapse state crosses ranks.
Per step each rank:

  1. forms the local current of its tile, ``pre[rows] @ w_tile``;
  2. sums it over its column, one ``all_reduce(SUM)`` of ``post_tile``
     floats (the reference's one ``psum``);
  3. runs the LIF step on its post slice;
  4. updates its tile (:meth:`~repro_torch.plasticity.UpdatePlan.tile_update`
     on the tile's slices of the readout views; on ``sparse`` the global pre
     event list, taken once from the replicated spikes, translated into the
     tile's rows);
  5. gathers the post spikes and membrane slices over its row, one
     ``all_gather``, so the next step's histories and membrane are whole
     again.  ``shard_map``'s ``out_specs`` gives the reference this
     reassembly implicitly; here it is an explicit collective.

On a 1 × 1 grid the step is :func:`~repro_torch.core.engine.engine_step`
bit for bit.  With a cap on ``sparse`` each tile caps its own post events,
as in the reference, so a capped run over several post tiles may differ
from the unsharded one by design.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch import plasticity
from repro_torch.core.engine import EngineConfig, EngineState, _quantise
from repro_torch.core.lif import LIFState, lif_step
from repro_torch.distributed.sharding import EngineGrid


def shard_engine_state(state: EngineState, grid: EngineGrid) -> EngineState:
    """This rank's share of an unlaned engine: its tile of ``w`` (a copy),
    the histories and membrane whole."""
    rows, cols = grid.tile(*state.w.shape[-2:])
    return state._replace(w=state.w[rows, cols].contiguous())


def make_sharded_engine_step(cfg: EngineConfig, grid: EngineGrid):
    """``step(state, pre_spikes) → (state', post_spikes)`` on this rank's tile.

    ``state`` is :func:`shard_engine_state`'s share; ``pre_spikes`` the whole
    ``(n_pre,)`` vector (replicated); ``post_spikes`` come back whole, bool.
    Every rank of the grid calls the step with the same spikes.
    """
    rule = cfg.learning_rule()
    plan = plasticity.make_plan(cfg, grid.device)
    rows, cols = grid.tile(cfg.n_pre, cfg.n_post)
    words = plan.readout_ndim() == 1

    def tile_view(read: torch.Tensor, sl: slice) -> torch.Tensor:
        return read[sl] if words else read[:, sl]

    def step(state: EngineState, pre_spikes: torch.Tensor):
        pre_spikes = torch.as_tensor(pre_spikes, device=state.w.device)
        pre = pre_spikes[rows]
        i_in = torch.matmul(pre.to(torch.float32).unsqueeze(-2), state.w).squeeze(-2)
        dist.all_reduce(i_in, op=dist.ReduceOp.SUM, group=grid.col_group)
        neurons, post = lif_step(LIFState(v=state.neurons.v[cols]), i_in, cfg.lif)
        w = plan.tile_update(state.w, pre, post,
                             tile_view(plan.state_readout(state.pre_hist), rows),
                             tile_view(plan.state_readout(state.post_hist), cols),
                             pre_events=plan.pre_events_crossing(pre_spikes),
                             pre_start=rows.start)
        if cfg.quantise:
            w = _quantise(w, cfg)
        local = torch.stack([post.to(torch.float32), neurons.v])    # (2, post_tile)
        parts = [torch.empty_like(local) for _ in range(grid.model)]
        dist.all_gather(parts, local, group=grid.row_group)
        post_all, v = torch.cat(parts, dim=-1)
        post_all = post_all != 0
        return EngineState(w=w,
                           pre_hist=rule.step(state.pre_hist, pre_spikes, depth=cfg.depth),
                           post_hist=rule.step(state.post_hist, post_all, depth=cfg.depth),
                           neurons=LIFState(v=v)), post_all

    return step
