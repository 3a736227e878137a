"""Production and debug meshes over ``torch.distributed`` (port of
``repro.launch.mesh``).

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over the
initialised default process group, with the reference's axis names.
Nothing here starts a group: the caller joins one first (the dry run, a
``fake`` group of 256 or 512 ranks in one process; the launcher, one rank
per process).

Geometry (the reference's):
  * single-pod: (data=16, model=16)            — 256 ranks
  * multi-pod : (pod=2, data=16, model=16)     — 512 ranks; the ``pod`` axis
    carries pure data parallelism (the po2-compressed gradient exchange).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.distributed.sharding import axis_names, backend_for, mesh_shape


def _mesh(shape: tuple[int, ...], names: tuple[str, ...], device_type: str) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError("no process group: join one before building a mesh")
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() != n:
        raise ValueError(f"a {' × '.join(map(str, shape))} mesh needs {n} ranks, the world "
                         f"has {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda") -> DeviceMesh:
    """The 256-rank (data=16, model=16) or 512-rank (pod=2, data=16,
    model=16) mesh over the default group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, torch.device(device).type)


def make_debug_mesh(data: int = 1, model: int = 1, pod: int | None = None, *,
                    device: str | torch.device = "cuda") -> DeviceMesh:
    """A small mesh over the default group, whose backend must be
    ``device``'s (NCCL for CUDA, gloo for the CPU)."""
    dev = torch.device(device)
    if dist.is_initialized() and dist.get_backend() != backend_for(dev):
        raise ValueError(f"the process group runs {dist.get_backend()!r}, but device "
                         f"{str(dev)!r} needs {backend_for(dev)!r}")
    if pod is not None:
        return _mesh((pod, data, model), ("pod", "data", "model"), dev.type)
    return _mesh((data, model), ("data", "model"), dev.type)


def describe(mesh) -> str:
    shape = mesh_shape(mesh)
    return " × ".join(f"{n}={shape[n]}" for n in axis_names(mesh))
