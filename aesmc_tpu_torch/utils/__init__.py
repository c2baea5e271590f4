"""Small shared utilities: the MLP building block and the pytree
helpers."""

from .mlp import MLP, mixed_dot
from .pytree import rebuild, sorted_leaves, unstack

__all__ = ["MLP", "mixed_dot", "rebuild", "sorted_leaves", "unstack"]
