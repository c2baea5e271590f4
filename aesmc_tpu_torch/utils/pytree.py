"""Helpers over tensors and dicts of tensors (the port's pytrees)."""

from __future__ import annotations

import torch


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


def _index(tree, t: int, axis: int):
    if isinstance(tree, dict):
        return {k: _index(v, t, axis) for k, v in tree.items()}
    return torch.select(tree, axis, t)


def unstack(tree, axis: int = 0):
    """Splits a stacked `[T, ...]` tensor (or dict of them) into a list of
    T values along ``axis``: the list-of-timesteps view for consumers of
    the reference's layout (the engine returns stacked tensors). Each
    entry is a view of ``tree``."""
    length = _leaves(tree)[0].shape[axis]
    return [_index(tree, t, axis) for t in range(length)]


def sorted_leaves(tree):
    """The leaves of a tensor, number or (nested) dict, dicts in sorted key
    order: the JAX package's pytree order, which the per-leaf draws of
    `if2`, `smc2` and `samplers` follow."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in sorted_leaves(tree[k])]
    return [tree]


def rebuild(tree, leaves):
    """``tree``'s structure with ``leaves`` (in `sorted_leaves` order)."""
    it = iter(leaves)

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(node[k]) for k in sorted(node)}
        return next(it)

    return fill(tree)
