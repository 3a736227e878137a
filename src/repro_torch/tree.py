"""Trees of tensors: the port's stand-in for ``jax.tree_util`` where the
reference maps over parameter and gradient pytrees.

A tree is a nested dict, list or tuple; anything else is a leaf.  Dict
entries are walked in sorted key order, as JAX flattens dicts, so the leaf
order of :func:`tree_leaves` is the reference's.
"""
from __future__ import annotations

from typing import Any, Callable


def tree_leaves(tree) -> list:
    """The leaves, in the reference's flattening order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for kid in tree for leaf in tree_leaves(kid)]
    return [tree]


def tree_unflatten(like, leaves) -> Any:
    """A tree shaped as ``like`` (tuples rebuilt as plain tuples) holding
    ``leaves`` in flattening order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            items = [build(x) for x in node]
            return items if isinstance(node, list) else tuple(items)
        return next(it)

    out = build(like)
    if next(it, it) is not it:
        raise ValueError("tree_unflatten: more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree) -> Any:
    """``fn`` applied to every leaf of ``tree``."""
    return tree_unflatten(tree, [fn(leaf) for leaf in tree_leaves(tree)])
