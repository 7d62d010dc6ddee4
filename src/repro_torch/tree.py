"""Minimal pytree walking for parameter trees of tensors.

Nodes are dicts, lists, tuples and None; everything else is a leaf. Dict
children are visited in SORTED key order — the order ``jax.tree.flatten``
uses — so a parameter dict flattens to the same leaf sequence as in the
JAX package, and leaf indices (packed layouts, per-leaf seeds) line up
with it.
"""
from __future__ import annotations

from typing import Any, Callable

PyTree = Any


# The walkers are module functions that take their accumulator as an
# argument: a nested recursive function refers to itself through its
# closure, and that cycle would keep every leaf alive until the cyclic
# garbage collector runs (tens of GB of device memory at full width).

def _walk(t, leaves: list):
    if isinstance(t, dict):
        keys = tuple(sorted(t))
        return ("dict", keys, tuple(_walk(t[k], leaves) for k in keys))
    if isinstance(t, (list, tuple)):
        return (type(t).__name__, len(t), tuple(_walk(c, leaves) for c in t))
    if t is None:
        return ("none",)
    leaves.append(t)
    return ("leaf",)


def flatten(tree: PyTree) -> tuple[list, tuple]:
    """Returns (leaves, treedef); treedef is a hashable nested tuple."""
    leaves: list = []
    return leaves, _walk(tree, leaves)


def _build(d, it):
    kind = d[0]
    if kind == "leaf":
        return next(it)
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _build(c, it) for k, c in zip(d[1], d[2])}
    children = [_build(c, it) for c in d[2]]
    return children if kind == "list" else tuple(children)


def unflatten(treedef: tuple, leaves) -> PyTree:
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the treedef holds")
    return out


def leaves(tree: PyTree) -> list:
    return flatten(tree)[0]


def _walk_paths(t, prefix: tuple, out: list):
    if isinstance(t, dict):
        for k in sorted(t):
            _walk_paths(t[k], prefix + (str(k),), out)
    elif isinstance(t, (list, tuple)):
        for i, c in enumerate(t):
            _walk_paths(c, prefix + (str(i),), out)
    elif t is not None:
        out.append(("/".join(prefix), t))


def leaves_with_names(tree: PyTree) -> list:
    """(name, leaf) pairs in ``flatten`` order; a name is the leaf's key
    path joined by '/' (dict keys, then list and tuple indices), as the
    JAX package names leaves from ``tree_flatten_with_path``."""
    out: list = []
    _walk_paths(tree, (), out)
    return out


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """fn over corresponding leaves of trees with the same structure."""
    lv, td = flatten(tree)
    others = []
    for r in rest:
        rl, rd = flatten(r)
        if rd != td:
            raise ValueError(f"tree structures differ: {td} vs {rd}")
        others.append(rl)
    return unflatten(td, [fn(*xs) for xs in zip(lv, *others)])
