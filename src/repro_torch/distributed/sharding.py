"""The learning engine's process grid on ``torch.distributed`` (port of the
engine's part of ``repro.distributed.sharding``).

The reference shards the synapse matrix over a 2-D device mesh ``('data',
'model')`` ≙ (pre tiles, post tiles) and runs the per-tile step under
``shard_map``.  Here each tile belongs to one process (rank) of a
``torch.distributed`` world of ``data × model`` ranks, rank ``d·model + m``
holding pre tile ``d`` and post tile ``m``.  Each rank has two subgroups:

  * its **column**, the ``data`` ranks that share its post tile: they sum
    the postsynaptic current (the reference's one ``psum`` over ``'data'``);
  * its **row**, the ``model`` ranks that share its pre tile: they gather
    the post spikes and membrane slices (the reassembly the reference's
    ``out_specs`` does).

The process-group backend follows the device, NCCL for CUDA and gloo for
the CPU: :func:`init_process_group` picks it from the device, and
:func:`make_grid` refuses a world whose backend is not the device's.  The
reference's LM sharding rules (``param_spec_for``, ``kv_cache_spec``, …)
come with the LM stack (ROADMAP queue 1 item 18).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def backend_for(device: torch.device | str) -> str:
    """The process-group backend of ``device``: ``nccl`` or ``gloo``."""
    dev = torch.device(device)
    if dev.type not in _BACKENDS:
        raise ValueError(f"no process-group backend for device {str(dev)!r}; "
                         f"use one of {tuple(_BACKENDS)}")
    return _BACKENDS[dev.type]


def init_process_group(device: torch.device | str, *, rank: int, world_size: int,
                       init_method: str | None = None, store: Any = None) -> None:
    """Join the default process group with ``device``'s backend.

    Nothing tells a program of its cluster: pass ``init_method`` (e.g.
    ``tcp://127.0.0.1:<port>``) or a ``store`` (e.g. a ``FileStore``), and
    the rank and world size.  A CUDA device becomes the current device (on a
    host without CUDA it raises, as every entry point of the port does).
    """
    dev = resolve_device(device)
    backend = backend_for(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else torch.cuda.current_device())
    dist.init_process_group(backend, init_method=init_method, store=store, rank=rank,
                            world_size=world_size)


@dataclasses.dataclass(frozen=True)
class EngineGrid:
    """This rank's place in the ``(data, model)`` grid and its subgroups."""

    data: int
    model: int
    rank: int
    device: torch.device
    row_group: Any = dataclasses.field(compare=False, repr=False)
    col_group: Any = dataclasses.field(compare=False, repr=False)

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def tile(self, n_pre: int, n_post: int) -> tuple[slice, slice]:
        """This rank's (pre rows, post columns) of an ``n_pre × n_post``
        matrix; each axis must divide evenly, as ``shard_map`` requires."""
        if n_pre % self.data or n_post % self.model:
            raise ValueError(f"a {n_pre}x{n_post} matrix does not tile over a "
                             f"{self.data}x{self.model} grid")
        tp, tq = n_pre // self.data, n_post // self.model
        d, m = self.data_index, self.model_index
        return slice(d * tp, (d + 1) * tp), slice(m * tq, (m + 1) * tq)


def make_grid(data: int, model: int, *, device: torch.device | str) -> EngineGrid:
    """The ``data × model`` grid over the initialised default group.

    Every rank calls this with the same shape (each subgroup is created on
    every rank, in the same order).  Raises unless the world has
    ``data × model`` ranks and the backend is ``device``'s.
    """
    dev = torch.device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_grid: no process group; call init_process_group first")
    if dist.get_world_size() != data * model:
        raise ValueError(f"a {data}x{model} grid needs {data * model} ranks, the world "
                         f"has {dist.get_world_size()}")
    want, have = backend_for(dev), dist.get_backend()
    if have != want:
        raise ValueError(f"the process group runs {have!r}, but device {str(dev)!r} "
                         f"needs {want!r}")
    rows = [dist.new_group([d * model + m for m in range(model)]) for d in range(data)]
    cols = [dist.new_group([d * model + m for d in range(data)]) for m in range(model)]
    rank = dist.get_rank()
    return EngineGrid(data=data, model=model, rank=rank, device=dev,
                      row_group=rows[rank // model], col_group=cols[rank % model])
