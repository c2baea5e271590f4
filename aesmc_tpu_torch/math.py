"""Numerically stable log-space utilities.

Counterpart of `aesmc_tpu.math` (`lognormexp`, `exponentiate_and_normalize`,
`logsumexp`). `torch.logsumexp` shifts by the maximum as
`jax.nn.logsumexp` does, and an all `-inf` slice gives `-inf`.
"""

from __future__ import annotations

import torch


def lognormexp(values: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Log of the normalized exponentials of ``values`` along ``dim``:
    ``values - logsumexp(values, dim)``."""
    return values - torch.logsumexp(values, dim=dim, keepdim=True)


def exponentiate_and_normalize(values: torch.Tensor,
                               dim: int = 0) -> torch.Tensor:
    """``exp(values) / sum(exp(values), dim)``, computed stably."""
    return torch.exp(lognormexp(values, dim=dim))


def logsumexp(values: torch.Tensor, axis=None,
              keepdims: bool = False) -> torch.Tensor:
    """Stable logsumexp over ``axis`` (all axes when None)."""
    if axis is None:
        axis = tuple(range(values.ndim))
    return torch.logsumexp(values, dim=axis, keepdim=keepdims)
