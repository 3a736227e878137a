"""Atomic, checksummed checkpoints (port of ``repro.checkpoint.checkpoint``).

Layout, one directory per step, renamed into place as a whole:

    <dir>/step_000000123/
        manifest.json       # {"step", "leaves": [{name, shape, dtype, sha256}], "extra"}
        <leaf-name>.npy     # one file per tree leaf

The format is the reference's letter for letter, so a checkpoint written by
either package restores in the other:

  * **atomic commit**: leaves land in ``step_N.tmp``; the manifest is
    written last and fsync'd, then the directory is renamed.  A crash mid-save
    leaves the previous checkpoint intact, and a directory without a manifest
    is never listed;
  * **integrity**: each leaf carries the sha256 of its C-ordered bytes, and
    a restore verifies every leaf before any of it reaches the caller;
  * **leaf names** are the reference's ``jax.tree_util`` key paths joined by
    ``__``: dict keys in sorted order, sequence indices, and a NamedTuple
    field as ``.field`` (a session store's ``u0__.pre_words__0``).  ``None``
    is an empty subtree, as in JAX;
  * **elastic restore**: leaves are saved whole and restored onto the target
    leaf's device, or onto ``device`` when given — a checkpoint written from
    the card restores on the CPU and the other way round.

A Python ``int`` leaf (the port's ``SessionState.t``) is saved as a 0-d
int32 array, as the reference stores its step counters, and restored as an
``int``.

Sharded state (a tree holding DTensors, ROADMAP item 18d) is saved whole:
:class:`AsyncCheckpointer` gathers every DTensor leaf on every rank, on the
caller's thread (a collective never runs on the writer thread), rank 0
writes, and each :meth:`~AsyncCheckpointer.wait` ends in a barrier, so no
rank reads a checkpoint before it is committed.  A DTensor target leaf is
restored from the whole array onto its own placements, so a checkpoint
written on one mesh restores on another, on one process or in the JAX
package.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

Tree = Any


def map_named_leaves(fn: Callable[[str, Any], Any], tree: Tree) -> Tree:
    """``tree`` with each leaf replaced by ``fn(name, leaf)``, keeping its
    structure (NamedTuples stay NamedTuples).  Leaves are visited in the
    reference's flattening order and named by its key paths."""

    def walk(node, parts):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(node[k], parts + (str(k),)) for k in sorted(node)}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(getattr(node, f), parts + ("." + f,))
                                for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(x, parts + (str(i),)) for i, x in enumerate(node))
        return fn("__".join(parts) or "leaf", node)

    return walk(tree, ())


def _leaf_paths(tree: Tree) -> list[tuple[str, Any]]:
    out = []
    map_named_leaves(lambda name, leaf: out.append((name, leaf)), tree)
    return out


def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array (a CPU tensor's shares its storage)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, int):
        return np.asarray(leaf, dtype=np.int32)
    return np.asarray(leaf)


def _snapshot(leaf) -> np.ndarray:
    """A host copy of a leaf that later in-place writes cannot reach (a
    DTensor gathered whole: a collective, on every rank)."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(_host(leaf), copy=True)


def _sha256(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:09d}")


def save_checkpoint(ckpt_dir: str, step: int, tree: Tree,
                    extra: dict | None = None) -> str:
    """Synchronous atomic save; returns the committed directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = _step_dir(ckpt_dir, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for name, leaf in _leaf_paths(tree):
        arr = _host(leaf)
        np.save(os.path.join(tmp, name + ".npy"), arr)
        manifest["leaves"].append({"name": name, "shape": list(arr.shape),
                                   "dtype": str(arr.dtype), "sha256": _sha256(arr)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def load_manifest(ckpt_dir: str, step: int) -> dict:
    """The committed manifest of one step: leaf metadata plus ``extra`` (a
    caller that needs ``extra`` to build its restore target reads it here)."""
    with open(os.path.join(_step_dir(ckpt_dir, step), "manifest.json")) as f:
        return json.load(f)


def list_checkpoints(ckpt_dir: str) -> list[int]:
    """Committed steps under ``ckpt_dir``, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
                steps.append(int(d[len("step_"):]))
    return sorted(steps)


def latest_checkpoint(ckpt_dir: str) -> int | None:
    steps = list_checkpoints(ckpt_dir)
    return steps[-1] if steps else None


def _verify_and_load(path: str, meta: dict) -> np.ndarray:
    arr = np.load(os.path.join(path, meta["name"] + ".npy"))
    if list(arr.shape) != meta["shape"] or str(arr.dtype) != meta["dtype"]:
        raise IOError(f"checkpoint leaf {meta['name']}: shape/dtype mismatch")
    if _sha256(arr) != meta["sha256"]:
        raise IOError(f"checkpoint leaf {meta['name']}: checksum mismatch "
                      "(torn or corrupted write)")
    return arr


def restore_checkpoint(ckpt_dir: str, step: int, target: Tree, *,
                       device: torch.device | str | None = None) -> Tree:
    """Restore into the structure of ``target``, every checksum verified.

    A tensor leaf lands on ``device`` when given, else on the target leaf's
    device; an ``int`` leaf comes back as an ``int``; a numpy leaf as a numpy
    array.  Nothing is returned unless every leaf verified.
    """
    path = _step_dir(ckpt_dir, step)
    by_name = {m["name"]: m for m in load_manifest(ckpt_dir, step)["leaves"]}

    def load(name, tgt):
        if name not in by_name:
            raise IOError(f"checkpoint missing leaf {name}")
        arr = _verify_and_load(path, by_name[name])
        if isinstance(tgt, DTensor):
            from repro_torch.distributed.sharding import distribute_like
            full = torch.from_numpy(arr).to(tgt.device if device is None else device)
            return distribute_like(full, tgt.device_mesh, tgt.placements)
        if isinstance(tgt, torch.Tensor):
            return torch.from_numpy(arr).to(tgt.device if device is None else device)
        if isinstance(tgt, int):
            return int(arr)
        return arr

    return map_named_leaves(load, target)


def prune_checkpoints(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` committed steps."""
    for s in list_checkpoints(ckpt_dir)[:-keep]:
        shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)


class AsyncCheckpointer:
    """Background-thread checkpoint writer with at most one save in flight.

    :meth:`save` copies the tree to host memory synchronously (a device
    tensor waits for its producer here) and hands the disk write to a
    thread that touches numpy arrays only; a second :meth:`save` while one
    is in flight first waits for it to commit.  A write's exception is
    raised by the next :meth:`wait` or :meth:`save`.  A sharded tree is
    written by rank 0 alone, and every rank calls :meth:`save` and
    :meth:`wait` at the same points.
    """

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self._sharded = False

    def save(self, step: int, tree: Tree, extra: dict | None = None) -> None:
        self.wait()
        self._sharded = any(isinstance(leaf, DTensor) for _, leaf in _leaf_paths(tree))
        host_tree = map_named_leaves(lambda _, leaf: _snapshot(leaf), tree)
        if self._sharded and dist.get_rank() != 0:
            return

        def work():
            try:
                save_checkpoint(self.ckpt_dir, step, host_tree, extra)
                prune_checkpoints(self.ckpt_dir, self.keep)
            except Exception as e:  # raised again by the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded:
            dist.barrier()
            self._sharded = False
        if self._error is not None:
            err, self._error = self._error, None
            raise err
