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
:func:`make_grid` refuses a world whose backend is not the device's.

The LM half (ROADMAP item 18d) keeps the reference's rules word for word:
logical-axis specs → mesh :class:`PartitionSpec` for every parameter, batch
and decode cache, under the sharding profiles ``fsdp | replicated | dp |
dp_zero3`` (scheme: batch → ``('pod','data')``, ``'tp'`` → ``'model'``,
``'fsdp'`` → ``'data'``, experts → ``'model'`` when they divide it, every
axis behind a divisibility guard).  The rule functions take any mesh with
``.shape`` (name → size) and ``.axis_names``, or a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``.  A
spec becomes DTensor placements through :func:`placements_for`, and
:func:`distribute_tree` places a tree of full tensors with no
communication, each rank cutting its own shard.

GSPMD partitions the reference's compute from these specs.  The port
stores state by them; under the ``fsdp`` and ``replicated`` profiles the
train step, and the prefill and decode plans (ROADMAP item 19b), gather
each leaf over the fsdp axis only and compute each ``'model'`` rank's share
inside :func:`use_tensor_parallel` (item 19a): the conjugate pair
:func:`copy_to_model` / :func:`reduce_from_model`, :func:`gather_from_model`,
the column- and row-parallel products, and :func:`constrain`, which acts
there and is the identity elsewhere.  The decode plan reads each rank's
cache shard where :func:`decode_cache_shardings` places it
(:func:`use_decode_layout`).  The batch reductions GSPMD inserts into a sharded loss (the token
count, the MoE balance means) are :func:`batch_sum` and :func:`batch_mean`
over the axes :func:`use_batch_reduction` names.  The reference's
``shard_map_compat`` has no counterpart: a region manual over ``'pod'`` is
:func:`use_manual_axes`, under which specs drop ``'pod'`` as the
reference's ``_strip_manual`` does.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
from collections.abc import Mapping
from typing import Any, Sequence

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard

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


# ---------------------------------------------------------------------------
# LM sharding rules (the reference's LM half, ROADMAP item 18d)
# ---------------------------------------------------------------------------

_state = threading.local()


def _canon(entry):
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return entry[0] if len(entry) == 1 else entry
    return entry


class PartitionSpec(tuple):
    """A spec: one entry per tensor dim, each ``None``, a mesh axis name or
    a tuple of names (a one-name tuple is that name, as in JAX)."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_canon(e) for e in entries))

    def __repr__(self) -> str:
        return "PartitionSpec(" + ", ".join(repr(e) for e in self) + ")"


P = PartitionSpec


def axis_names(mesh) -> tuple[str, ...]:
    """The mesh's axis names (a DeviceMesh's ``mesh_dim_names``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name → size, for a shape-only mesh or a DeviceMesh."""
    shape = mesh.shape
    if isinstance(shape, Mapping):
        return dict(shape)
    return dict(zip(axis_names(mesh), shape))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements_for(self.spec, self.mesh)


def current_mesh():
    return getattr(_state, "mesh", None)


def sharding_profile() -> str:
    """Parallelism profile for weights/activations.

    * 'fsdp'       — ZeRO-3: weights sharded over 'data', TP over 'model'
                     (the default).
    * 'replicated' — DP+TP: weights replicated over 'data'.
    * 'dp'         — pure data parallelism: weights fully replicated,
                     batch sharded over ('data','model') jointly.
    * 'dp_zero3'   — pure-DP compute with weights/opt sharded over the
                     (compute-idle) 'model' axis, gathered on use.

    Under 'fsdp' and 'replicated' the train step and the prefill and decode
    plans compute tensor-parallel over 'model' (ROADMAP items 19a-19b,
    :func:`use_tensor_parallel`); under 'dp' and 'dp_zero3' the model axis
    carries batch and every weight is gathered whole on use.
    """
    return getattr(_state, "profile", "fsdp")


@contextlib.contextmanager
def use_sharding_profile(profile: str):
    prev = sharding_profile()
    _state.profile = profile
    try:
        yield
    finally:
        _state.profile = prev


@contextlib.contextmanager
def use_mesh(mesh):
    prev = current_mesh()
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def _manual_axes() -> frozenset:
    """Mesh axes of the enclosing manual region (:func:`use_manual_axes`)."""
    return getattr(_state, "manual", frozenset())


@contextlib.contextmanager
def use_manual_axes(axes):
    """The region the reference runs inside ``shard_map`` manual over
    ``axes`` (the multi-pod step's pod block): specs resolved here drop
    those axes, since each rank's shard has no such dimension."""
    prev = _manual_axes()
    _state.manual = frozenset(axes)
    try:
        yield
    finally:
        _state.manual = prev


def batch_axes(mesh) -> tuple[str, ...]:
    if sharding_profile() in ("dp", "dp_zero3"):
        # pure DP: the model axis carries batch too
        return (("pod", "data", "model") if "pod" in axis_names(mesh)
                else ("data", "model"))
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def _resolve_axis(logical, mesh):
    """logical axis name → physical mesh axis (or tuple), or None."""
    if logical is None:
        return None
    if logical == "batch":
        return batch_axes(mesh)
    profile = sharding_profile()
    if logical == "tp":
        return None if profile in ("dp", "dp_zero3") else "model"
    if logical == "fsdp":
        if profile == "fsdp":
            return "data"
        if profile == "dp_zero3":
            return "model"
        return None
    return logical


def _axis_size(ax, mesh) -> int:
    shape = mesh_shape(mesh)
    if isinstance(ax, tuple):
        n = 1
        for a in ax:
            n *= shape[a]
        return n
    return shape[ax]


def _strip_manual(ax, manual):
    if ax is None:
        return None
    if isinstance(ax, tuple):
        kept = tuple(a for a in ax if a not in manual)
        return kept if kept else None
    return None if ax in manual else ax


def logical_to_spec(spec: Sequence, shape: tuple[int, ...], mesh) -> PartitionSpec:
    """Right-aligned logical spec → PartitionSpec with divisibility guard.

    ``spec`` names the trailing dims; leading (layer-stack) dims replicate.
    """
    spec = tuple(spec)
    if len(spec) > len(shape):
        spec = spec[len(spec) - len(shape):]
    pad = len(shape) - len(spec)
    manual = _manual_axes()
    out = [None] * pad
    for dim, logical in zip(shape[pad:], spec):
        ax = _strip_manual(_resolve_axis(logical, mesh), manual)
        if ax is not None and dim % _axis_size(ax, mesh) != 0:
            ax = None
        out.append(ax)
    return P(*out)


# ordered (regex on '/'-joined path, logical spec for the trailing dims)
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embed/tok$", ("tp", "fsdp")),
    (r"embed/out$", ("fsdp", "tp")),
    (r"attn/wq$", ("fsdp", "tp")),
    (r"attn/wk$", ("fsdp", "tp")),
    (r"attn/wv$", ("fsdp", "tp")),
    (r"attn/wo$", ("tp", "fsdp")),
    (r"attn/b[qkv]$", ("tp",)),
    (r"mlp/(gate|up)$", ("fsdp", "tp")),
    (r"mlp/down$", ("tp", "fsdp")),
    (r"mlp/up_bias$", ("tp",)),
    (r"moe/router$", ("fsdp", None)),
    (r"moe/(gate|up)$", ("ep", "fsdp", "tp")),     # resolved per arch below
    (r"moe/down$", ("ep", "tp", "fsdp")),
    (r"shared/(gate|up)$", ("fsdp", "tp")),
    (r"shared/down$", ("tp", "fsdp")),
    (r"shared/route$", (None, None)),
    (r"ssm/wz$", ("fsdp", "tp")),
    (r"ssm/wxbc$", ("fsdp", "tp")),
    (r"ssm/wdt$", ("fsdp", None)),
    (r"ssm/conv_w$", (None, "tp")),
    (r"ssm/conv_b$", ("tp",)),
    (r"ssm/norm_scale$", ("tp",)),
    (r"ssm/out_proj$", ("tp", "fsdp")),
]


def param_spec_for(path_str: str, shape: tuple[int, ...], cfg, mesh) -> PartitionSpec:
    for pattern, spec in _PARAM_RULES:
        if re.search(pattern, path_str):
            if pattern == r"embed/tok$" and "pod" in axis_names(mesh):
                # the reference drops the fsdp factor of the token table on a
                # pod mesh (a workaround for an XLA partitioner crash that
                # torch does not have); kept so the spec tables are equal
                spec = ("tp", None)
            if "ep" in spec:
                # expert-parallel when E (padded) divides the model axis,
                # else the expert dim replicates and TP shards inside
                if cfg.experts_alloc % mesh_shape(mesh)["model"] == 0:
                    spec = tuple("tp" if s == "ep" else
                                 (None if s == "tp" else s) for s in spec)
                else:
                    spec = tuple(None if s == "ep" else s for s in spec)
            return logical_to_spec(spec, shape, mesh)
    return P()  # norms, scalars, small vectors: replicate


def map_with_path(fn, tree, path: tuple = ()):
    """``fn('/'-joined path, leaf)`` on every leaf of a tree of dicts,
    lists and tuples (NamedTuples kept; a :class:`PartitionSpec` is a
    leaf); ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, PartitionSpec):
        return fn("/".join(path), tree)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], path + (str(k),)) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(fn, getattr(tree, f), path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, x, path + (str(i),)) for i, x in enumerate(tree))
    return fn("/".join(path), tree)


def param_spec_tree(cfg, params_shape, mesh):
    """Tree of :class:`PartitionSpec` matching ``params_shape``."""
    return map_with_path(lambda path, leaf: param_spec_for(path, tuple(leaf.shape), cfg, mesh),
                         params_shape)


def param_shardings(cfg, params, mesh):
    """Tree of :class:`NamedSharding` matching ``params``."""
    return map_with_path(
        lambda path, leaf: NamedSharding(mesh, param_spec_for(path, tuple(leaf.shape), cfg,
                                                              mesh)), params)


def constrain(x: torch.Tensor, spec: Sequence) -> torch.Tensor:
    """An activation sharding constraint (the reference's
    ``with_sharding_constraint`` at its ``constrain`` sites).

    Outside :func:`use_tensor_parallel` it is the identity.  Inside, ``spec``
    is resolved by :func:`logical_to_spec` on ``x``'s global shape (its
    local shape with the dim it holds a ``'model'`` shard of, if any,
    :func:`model_dim`, times the model axis) and compared with that dim:
    where they agree ``x`` comes back as it is; where the spec drops
    ``'model'`` from ``x``'s sharded dim, ``x`` is all-gathered over
    ``'model'`` (:func:`gather_from_model`); any other transition raises.
    """
    mesh = tp_mesh()
    if mesh is None:
        return x
    have = model_dim(x)
    shape = list(x.shape)
    if have is not None:
        shape[have] *= tp_size()
    want = [i for i, e in enumerate(logical_to_spec(spec, tuple(shape), mesh))
            if e == "model" or (isinstance(e, tuple) and "model" in e)]
    want = want[0] if want else None
    if want == have:
        return x
    if want is None:
        return gather_from_model(x, have)
    raise ValueError(f"constrain: a {tuple(x.shape)} activation holding 'model' on dim "
                     f"{have} cannot move to spec {tuple(spec)} ('model' on dim {want})")


def batch_spec(mesh, ndim: int, *, seq_axis=None) -> PartitionSpec:
    """(B, ...) arrays: batch over ('pod','data'); optional seq over model."""
    out: list[Any] = [batch_axes(mesh)] + [None] * (ndim - 1)
    if seq_axis is not None:
        out[seq_axis] = "model"
    return P(*out)


def _div(dim: int, ax, mesh) -> bool:
    return ax is not None and dim % _axis_size(ax, mesh) == 0


def _batch_ax(dim: int, mesh):
    """Largest batch sharding ('pod','data') → ('data',) → None that divides."""
    full = batch_axes(mesh)
    if _div(dim, full, mesh):
        return full
    if _div(dim, ("data",), mesh):
        return ("data",)
    return None


def kv_cache_spec(shape: tuple[int, ...], mesh) -> PartitionSpec:
    """(L, B, T, K, hd) KV cache (or (L,B,T,K,1) scale) sharding.

    KV heads on 'model' when they divide it, else the context axis T on
    'model' (sequence parallelism); batch over ('pod','data') when it
    divides, and when it does not (B=1 latency decode) T also over 'data'.
    """
    L, B, T, K = shape[:4]
    b_ax = _batch_ax(B, mesh)
    k_ax = "model" if _div(K, "model", mesh) else None
    t_ax = None
    if k_ax is None and _div(T, ("model",), mesh):
        t_ax = ("model",)
    if b_ax is None:
        if t_ax == ("model",) and _div(T, ("data", "model"), mesh):
            t_ax = ("data", "model")
        elif t_ax is None and _div(T, ("data",), mesh):
            t_ax = ("data",)
    rest = [None] * (len(shape) - 4)
    return P(None, b_ax, t_ax, k_ax, *rest)


def ssm_cache_specs(conv_shape: tuple[int, ...], state_shape: tuple[int, ...],
                    mesh) -> tuple[PartitionSpec, PartitionSpec]:
    """SSM decode caches: conv (L,B,W,conv_dim), state (L,B,g,r,N,P); the
    channels and the head axis r shard on 'model' when divisible."""
    Lb, B, W, conv_dim = conv_shape
    b_ax = _batch_ax(B, mesh)
    conv_spec = P(None, b_ax, None, "model" if _div(conv_dim, "model", mesh) else None)
    _, Bs, g, r = state_shape[:4]
    r_ax = "model" if _div(r, "model", mesh) else None
    state_spec = P(None, _batch_ax(Bs, mesh), None, r_ax, None, None)
    return conv_spec, state_spec


def decode_cache_shardings(cache, mesh):
    """:class:`NamedSharding` tree matching a ``DecodeCache``."""
    def ns(spec):
        return NamedSharding(mesh, spec)

    def kv_shardings(kv):
        if kv is None:
            return None
        return type(kv)(
            k=ns(kv_cache_spec(tuple(kv.k.shape), mesh)),
            v=ns(kv_cache_spec(tuple(kv.v.shape), mesh)),
            k_scale=(ns(kv_cache_spec(tuple(kv.k_scale.shape), mesh))
                     if kv.k_scale is not None else None),
            v_scale=(ns(kv_cache_spec(tuple(kv.v_scale.shape), mesh))
                     if kv.v_scale is not None else None))

    def ssm_shardings(ssm):
        if ssm is None:
            return None
        conv_spec, state_spec = ssm_cache_specs(tuple(ssm.conv.shape), tuple(ssm.state.shape),
                                                mesh)
        return type(ssm)(conv=ns(conv_spec), state=ns(state_spec))

    def cross_sharding(x):
        if x is None:
            return None
        _, B, Nv, K = x.shape[:4]        # (n_cross, B, Nv, K, hd)
        return ns(P(None, _batch_ax(B, mesh), None,
                    "model" if _div(K, "model", mesh) else None, None))

    return type(cache)(kv=kv_shardings(cache.kv), global_kv=kv_shardings(cache.global_kv),
                       ssm=ssm_shardings(cache.ssm), cross_k=cross_sharding(cache.cross_k),
                       cross_v=cross_sharding(cache.cross_v))


# ---------------------------------------------------------------------------
# Specs on a DeviceMesh: placements, shards, batch reductions
# ---------------------------------------------------------------------------

def placements_for(spec: Sequence, mesh) -> tuple:
    """DTensor placements of ``spec``: mesh dim ``a`` → ``Shard(i)`` when
    ``a`` is, or is in, ``spec[i]``, else ``Replicate()``.  A tuple entry
    must list its axes in mesh order (the order DTensor splits a dim in)."""
    names = axis_names(mesh)
    for entry in spec:
        if isinstance(entry, tuple):
            idx = [names.index(a) for a in entry]
            if idx != sorted(idx):
                raise ValueError(f"spec entry {entry} is not in the mesh's axis order {names}")
        elif entry is not None and entry not in names:
            raise ValueError(f"spec names axis {entry!r}; the mesh has {names}")
    out = []
    for a in names:
        dims = [i for i, e in enumerate(spec)
                if e == a or (isinstance(e, tuple) and a in e)]
        if len(dims) > 1:
            raise ValueError(f"spec {spec} shards two dims over axis {a!r}")
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def local_shard(x: torch.Tensor, placements: Sequence, mesh) -> torch.Tensor:
    """This rank's shard of the full tensor ``x`` under ``placements``, cut
    with no communication (every dim must divide evenly, as the divisibility
    guard ensures).  An unsharded ``x`` comes back as it is."""
    coord = mesh.get_coordinate()
    sizes = tuple(mesh.shape)
    cut = False
    for dim in range(x.dim()):
        idx, n = 0, 1
        for md, pl in enumerate(placements):
            if isinstance(pl, Shard) and pl.dim == dim:
                idx, n = idx * sizes[md] + coord[md], n * sizes[md]
        if n > 1:
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split {n} ways")
            step = x.shape[dim] // n
            x, cut = x.narrow(dim, idx * step, step), True
    return x.clone(memory_format=torch.contiguous_format) if cut else x


def distribute_like(x: torch.Tensor, mesh, placements: Sequence) -> DTensor:
    """The full tensor ``x`` as a DTensor with ``placements``, each rank
    keeping its own shard (no communication)."""
    return DTensor.from_local(local_shard(x, placements, mesh), mesh, tuple(placements),
                              run_check=False)


def distribute_tree(tree, spec_tree, mesh):
    """Every leaf of ``tree`` (full tensors, the same on every rank) as a
    DTensor placed by its spec in ``spec_tree`` (same structure)."""
    specs: dict = {}
    map_with_path(specs.__setitem__, spec_tree)
    return map_with_path(
        lambda path, x: distribute_like(x, mesh, placements_for(specs[path], mesh)), tree)


def gather_tree(tree):
    """Every DTensor leaf gathered whole (``full_tensor()``): the port's
    gather-on-use of sharded state."""
    return map_with_path(lambda _, x: x.full_tensor() if isinstance(x, DTensor) else x, tree)


def reduce_over(x: torch.Tensor, mesh, dims: Sequence[str], op: str = "sum") -> torch.Tensor:
    """``x`` reduced by ``op`` (``"sum"``, ``"max"``) over the ranks of the
    mesh axes ``dims``, one axis after the other (an axis of one rank is
    skipped: its reduction is ``x``)."""
    for d in dims:
        if mesh_shape(mesh)[d] > 1:
            x = funcol.all_reduce(x, op, mesh.get_group(d))
            if isinstance(x, funcol.AsyncCollectiveTensor):
                x = x.wait()
    return x


def _reduction() -> tuple | None:
    return getattr(_state, "reduction", None)


@contextlib.contextmanager
def use_batch_reduction(mesh, dims: Sequence[str]):
    """Inside, :func:`batch_sum` and :func:`batch_mean` reduce over the
    ranks of the mesh axes ``dims`` (the axes this rank's batch shard is cut
    over); outside they are identities."""
    prev = _reduction()
    _state.reduction = (mesh, tuple(dims))
    try:
        yield
    finally:
        _state.reduction = prev


class _BatchSum(torch.autograd.Function):
    """Sum over the batch ranks; the backward passes the gradient through,
    so each rank's gradient is its own shard's contribution and their sum
    over the ranks is the gradient of the whole batch's loss."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        return reduce_over(x, mesh, dims)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the batch shards (:func:`use_batch_reduction`)."""
    red = _reduction()
    if red is None or all(mesh_shape(red[0])[d] == 1 for d in red[1]):
        return x
    return _BatchSum.apply(x, *red)


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the batch shards of a per-shard mean (equal shards)."""
    red = _reduction()
    n = 1 if red is None else _axis_size(red[1], red[0])
    return x if n == 1 else batch_sum(x) / n


# ---------------------------------------------------------------------------
# Tensor-parallel compute over 'model' (ROADMAP item 19a)
# ---------------------------------------------------------------------------
#
# Inside :func:`use_tensor_parallel` the model functions compute each
# 'model' rank's share as the reference's GSPMD partitions it: a projection
# whose weight the parameter specs shard over 'model' multiplies the rank's
# shard (column-parallel: its output columns; row-parallel: its input rows,
# the partial products summed over 'model').  An activation is either
# replicated over 'model' or holds a shard of one dim (:func:`model_dim`).
# The conjugate pair keeps every replicated activation's gradient whole and
# equal on every 'model' rank: :func:`copy_to_model` before every product
# or slice that uses part of a replicated tensor, :func:`reduce_from_model`
# after every row-parallel product.  Every collective over a one-rank axis
# is skipped, so a 1 × 1 mesh runs the unsharded step's ops.

def tp_mesh():
    """The mesh of the enclosing :func:`use_tensor_parallel`, or None."""
    return getattr(_state, "tp", None)


@contextlib.contextmanager
def use_tensor_parallel(mesh):
    """Tensor-parallel compute over ``mesh``'s ``'model'`` axis: entered by
    the sharded train step and the prefill and decode plans under the
    ``fsdp`` and ``replicated`` profiles (never by :func:`use_mesh`)."""
    prev = tp_mesh()
    _state.tp = mesh
    try:
        yield mesh
    finally:
        _state.tp = prev


def tp_size() -> int:
    """The 'model' axis's size inside :func:`use_tensor_parallel`, else 1."""
    mesh = tp_mesh()
    return 1 if mesh is None else mesh_shape(mesh)["model"]


def tp_rank() -> int:
    """This rank's coordinate on 'model' (0 outside the context)."""
    mesh = tp_mesh()
    return 0 if mesh is None else mesh.get_local_rank("model")


def tp_splits(n: int) -> bool:
    """Whether a logical ``'tp'`` dim of global size ``n`` is sharded over
    'model' here: inside the context and through the divisibility guard."""
    return tp_mesh() is not None and n % tp_size() == 0


def tp_width(local: int, full: int, what: str) -> bool:
    """Whether a weight dim of global size ``full`` holding ``local``
    entries on this rank is a 'model' shard: the spec's guard decides, and a
    local width that is neither the shard's nor the whole's raises (no
    fallback to a whole-weight path)."""
    if tp_mesh() is None:
        return False
    split = tp_splits(full)
    want = full // tp_size() if split else full
    if local != want:
        raise ValueError(f"{what}: {local} local entries of {full}, but the 'model' "
                         f"spec gives {want}")
    return split


def model_dim(x: torch.Tensor) -> int | None:
    """The dim of ``x`` that holds a 'model' shard (None: replicated)."""
    return getattr(x, "_model_dim", None)


def on_model(x: torch.Tensor, dim: int | None) -> torch.Tensor:
    """``x`` marked as holding the 'model' shard of ``dim`` (None: marked
    replicated); outside the context ``x`` as it is."""
    if tp_mesh() is not None:
        x._model_dim = None if dim is None else dim % x.dim()
    return x


def _wait(x: torch.Tensor) -> torch.Tensor:
    return x.wait() if isinstance(x, funcol.AsyncCollectiveTensor) else x


# ``all_gather_tensor`` was renamed ``all_gather_single`` (PyTorch 2.12)
_all_gather = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor


class _CopyToModel(torch.autograd.Function):
    """Identity forward, all-reduce backward over 'model'."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return _wait(funcol.all_reduce(grad.contiguous(), "sum", ctx.group)), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce forward over 'model', identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return _wait(funcol.all_reduce(x.contiguous(), "sum", group))

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather forward over 'model' along ``dim``, the rank's slice backward."""

    @staticmethod
    def forward(ctx, x, dim, group, rank):
        ctx.dim, ctx.rank, ctx.chunk = dim, rank, x.shape[dim]
        return _wait(_all_gather(x.contiguous(), dim, group))

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.chunk, ctx.chunk), None, None, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """A replicated tensor entering compute that uses part of it on each
    'model' rank (a column-parallel product, a slice): identity forward,
    its partial gradients summed over 'model' backward."""
    if tp_size() == 1:
        return x
    return _CopyToModel.apply(x, tp_mesh().get_group("model"))


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's partial sums summed over 'model' (identity
    backward: the sum's gradient is each term's); replicated after."""
    if tp_size() > 1:
        x = _ReduceFromModel.apply(x, tp_mesh().get_group("model"))
    return on_model(x, None)


def gather_from_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The 'model' shards of ``dim`` all-gathered (the rank's slice of the
    whole gradient backward); replicated after."""
    if tp_size() == 1:
        return on_model(x.view_as(x), None)
    return on_model(_GatherFromModel.apply(x, dim % x.dim(), tp_mesh().get_group("model"),
                                           tp_rank()), None)


def over_model(x: torch.Tensor, op: str) -> torch.Tensor:
    """The elementwise ``op`` (``"sum"``, ``"max"``) over 'model' of a
    value no gradient flows through."""
    if tp_size() == 1:
        return x
    return _wait(funcol.all_reduce(x.detach().contiguous(), op, tp_mesh().get_group("model")))


def model_slice(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's 'model' shard of dim ``dim`` of a replicated ``x``
    (through :func:`copy_to_model`, so the whole gradient is summed)."""
    n = tp_size()
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split {n} ways")
    step = x.shape[dim] // n
    return on_model(copy_to_model(x).narrow(dim, tp_rank() * step, step), dim)


def column_parallel(x: torch.Tensor, *weights) -> list[torch.Tensor]:
    """``x @ w`` for a replicated ``x`` and each ``(w, full, what)``, a
    weight whose output columns (global ``full``) the specs may shard over
    'model': the rank's columns, marked, or the whole product.  The split
    products share one :func:`copy_to_model` of ``x``."""
    xs, out = None, []
    for w, full, what in weights:
        if tp_width(w.shape[-1], full, what):
            xs = copy_to_model(x) if xs is None else xs
            out.append(on_model(xs @ w, -1))
        else:
            out.append(x @ w)
    return out


def row_parallel(h: torch.Tensor, w: torch.Tensor, full: int, what: str) -> torch.Tensor:
    """``h @ w`` for a weight whose input rows (global ``full``) the specs
    may shard over 'model': the rank's rows times ``h``'s matching columns
    (cut from ``h`` where it holds all ``full``), summed over 'model';
    replicated."""
    if not tp_width(w.shape[0], full, what):
        return on_model(h @ w, None)
    if h.shape[-1] != w.shape[0]:
        h = model_slice(h, -1)
    return reduce_from_model(h @ w)


def _fsdp_placements(x: DTensor) -> tuple:
    """``x``'s placements with every axis but 'model' replicated."""
    return tuple(pl if name == "model" else Replicate()
                 for name, pl in zip(axis_names(x.device_mesh), x.placements))


def gather_fsdp_tree(tree):
    """The tensor-parallel gather-on-use: each DTensor leaf gathered over
    every axis but 'model' (its 'model' shard kept, as a plain tensor)."""
    def one(path, x):
        if not isinstance(x, DTensor):
            return x
        return x.redistribute(x.device_mesh, _fsdp_placements(x)).to_local()
    return map_with_path(one, tree)


def reduce_grad_to_shard(g: torch.Tensor, p: DTensor, dims: Sequence[str]) -> torch.Tensor:
    """A rank's gradient of a leaf used as :func:`gather_fsdp_tree` gave it
    (its 'model' shard), summed over the batch axes ``dims`` onto ``p``'s
    local shard: over an axis ``p`` is sharded on, a reduce-scatter onto
    that dim, else an all-reduce (a one-rank axis is skipped)."""
    mesh = p.device_mesh
    placed = dict(zip(axis_names(mesh), p.placements))
    for d in dims:
        if mesh_shape(mesh)[d] == 1:
            continue
        if isinstance(placed[d], Shard):
            g = funcol.reduce_scatter_tensor(g.contiguous(), "sum", placed[d].dim,
                                             mesh.get_group(d))
        else:
            g = funcol.all_reduce(g.contiguous(), "sum", mesh.get_group(d))
        g = _wait(g)
    return g


# ---------------------------------------------------------------------------
# The decode plan's placements (ROADMAP item 19b)
# ---------------------------------------------------------------------------
#
# The tensor-parallel decode plan (``launch.specs``) runs each rank on its
# own shard of the batch and of the cache, placed by
# :func:`decode_cache_shardings`: the batch over the batch axes where it
# divides, and each cache's context axis T over 'model' where its kv heads do
# not divide the axis (and over 'data' too with one sequence).
# :func:`use_decode_layout` tells ``transformer.decode_step`` where they lie.

@dataclasses.dataclass(frozen=True)
class DecodeLayout:
    """The mesh axes the decode batch is cut over, and those each cache's T
    is cut over (by cache field, ``"kv"`` / ``"global_kv"``), in mesh order;
    ``()`` is whole."""

    mesh: Any
    batch: tuple[str, ...] = ()
    seq: Mapping[str, tuple[str, ...]] = dataclasses.field(default_factory=dict)


def decode_layout() -> DecodeLayout | None:
    return getattr(_state, "decode", None)


@contextlib.contextmanager
def use_decode_layout(layout: DecodeLayout | None):
    prev = decode_layout()
    _state.decode = layout
    try:
        yield layout
    finally:
        _state.decode = prev


def shard_axes(x, dim: int) -> tuple[str, ...]:
    """The mesh axes a DTensor's ``dim`` is cut over, in mesh order (a
    plain tensor: none)."""
    if not isinstance(x, DTensor):
        return ()
    return tuple(name for name, pl in zip(axis_names(x.device_mesh), x.placements)
                 if isinstance(pl, Shard) and pl.dim == dim)


def cut_of(axes: Sequence[str]) -> tuple[int, int]:
    """``(this rank's index, count)`` of a dim cut over the mesh axes
    ``axes`` of the decode layout's mesh (the first axis the outer one, as
    DTensor cuts); ``(0, 1)`` outside a layout."""
    layout = decode_layout()
    if layout is None or not axes:
        return 0, 1
    coord = dict(zip(axis_names(layout.mesh), layout.mesh.get_coordinate()))
    shape = mesh_shape(layout.mesh)
    idx, n = 0, 1
    for a in axes:
        idx, n = idx * shape[a] + coord[a], n * shape[a]
    return idx, n


def decode_seq(field: str) -> tuple[str, ...]:
    """The axes the decode layout cuts cache ``field``'s T over."""
    layout = decode_layout()
    return () if layout is None else tuple(layout.seq.get(field, ()))


def over_decode_axes(x: torch.Tensor, op: str, axes: Sequence[str]) -> torch.Tensor:
    """``x`` reduced by ``op`` over the decode layout's ``axes`` (no gradient)."""
    layout = decode_layout()
    if layout is None:
        return x
    return reduce_over(x.contiguous(), layout.mesh, axes, op)


def gather_decode_batch(x: torch.Tensor) -> torch.Tensor:
    """The whole decode batch (dim 0) from each rank's rows: all-gathered
    over the batch axes, the inner axis first."""
    layout = decode_layout()
    if layout is None:
        return x
    for a in reversed(layout.batch):
        if mesh_shape(layout.mesh)[a] > 1:
            x = _wait(_all_gather(x.contiguous(), 0, layout.mesh.get_group(a)))
    return x


def decode_batch_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows (dim 0) of the whole decode batch ``x``."""
    layout = decode_layout()
    idx, n = cut_of(() if layout is None else layout.batch)
    if n == 1:
        return x
    step = x.shape[0] // n
    return x.narrow(0, idx * step, step)
