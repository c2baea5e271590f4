"""Small shared utilities: the MLP building block and the pytree helper."""

from .mlp import MLP, mixed_dot
from .pytree import unstack

__all__ = ["MLP", "mixed_dot", "unstack"]
