"""Faults planted in the port's training step, to show that the LM
family's comparison catches them (``tests/test_port_bench_lm.py``) and to
read the upper limits of its numbers on the card (``readings.py``):

  * ``unchanged``: a step that returns its state unchanged (the optimizer
    runs, and its result is dropped);
  * ``half_batch``: the loss and its gradients over the first half of the
    batch's sequences, the mean taken over the rest;
  * ``altered``: an answer altered where it is produced: one parameter of
    each update moved a second time by its own update.

Each is a context manager that patches ``train_step`` by name and puts it
back.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(**fns):
    from repro_torch.train import train_step

    old = {name: getattr(train_step, name) for name in fns}
    for name, make in fns.items():
        setattr(train_step, name, make(old[name]))
    try:
        yield
    finally:
        for name, fn in old.items():
            setattr(train_step, name, fn)


def _stale(update):
    def stale(cfg, params, grads, state, **kwargs):
        metrics = update(cfg, params, grads, state, **kwargs)[2]
        return params, state, metrics
    return stale


def _half(loss_and_grads):
    def half(params, cfg, batch, **kwargs):
        return loss_and_grads(params, cfg, {k: v[: v.shape[0] // 2] for k, v in batch.items()},
                              **kwargs)
    return half


def _moved(update):
    from repro_torch.tree import tree_leaves, tree_unflatten

    def moved(cfg, params, grads, state, **kwargs):
        new, new_state, metrics = update(cfg, params, grads, state, **kwargs)
        leaves = tree_leaves(new)
        w = leaves[0].clone()
        w.view(-1)[0] += w.view(-1)[0] - tree_leaves(params)[0].reshape(-1)[0]
        return tree_unflatten(new, [w, *leaves[1:]]), new_state, metrics
    return moved


def plant(name: str):
    if name == "unchanged":
        return _patched(adamw_update=_stale)
    if name == "half_batch":
        return _patched(loss_and_grads=_half)
    if name == "altered":
        return _patched(adamw_update=_moved)
    raise ValueError(f"no fault {name!r}")


FAULTS = ("unchanged", "half_batch", "altered")
