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
