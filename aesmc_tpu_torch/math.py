"""Numerically stable log-space utilities.

Counterpart of `aesmc_tpu.math` (`lognormexp`, `exponentiate_and_normalize`,
`logsumexp`, `table_lookup`, `distributed_logsumexp`). `torch.logsumexp`
shifts by the maximum as `jax.nn.logsumexp` does, and an all `-inf` slice
gives `-inf`.
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


def table_lookup(table, idx) -> torch.Tensor:
    """``table[idx]`` for a leading-axis table `[D, ...]` and integer
    ``idx`` `[...]`: `idx.shape + table.shape[1:]`, in the table's dtype
    (int8 and bool included), differentiable in the table.

    Index semantics of `aesmc_tpu.math.table_lookup`: a negative index
    wraps once (``idx + D``), then every index is clamped into [0, D - 1].
    A plain gather: the JAX package's one-hot masked-sum route works around
    the TPU's cross-lane gathers and is not needed on the card.
    """
    d = table.shape[0]
    idx = idx.long()
    idx = torch.clamp(torch.where(idx < 0, idx + d, idx), 0, d - 1)
    return table[idx]


def logsumexp(values: torch.Tensor, axis=None,
              keepdims: bool = False) -> torch.Tensor:
    """Stable logsumexp over ``axis`` (all axes when None)."""
    if axis is None:
        axis = tuple(range(values.ndim))
    return torch.logsumexp(values, dim=axis, keepdim=keepdims)


def distributed_logsumexp(values: torch.Tensor, group,
                          dim=None) -> torch.Tensor:
    """logsumexp over the local axis ``dim`` (if given) and over the ranks
    of the process group ``group``, whose blocks together make the axis:
    local max, all-reduce max, local sum of the shifted exponentials,
    all-reduce sum, log.

    The same arithmetic as `torch.logsumexp`: the shift is detached and an
    infinite maximum shifts by 0, so over a group of one rank the result
    has its bits. Differentiable in ``values`` (`collectives.all_reduce`:
    every rank gets the gradient of its own block).
    """
    from .parallel import collectives

    detached = values.detach()
    local_max = (detached.amax(dim=dim, keepdim=True) if dim is not None
                 else detached)
    shift = collectives.all_reduce(local_max, group, "max")
    shift = shift.masked_fill(shift.abs() == float("inf"), 0.0)
    shifted = torch.exp(values - shift)
    local_sum = shifted.sum(dim=dim) if dim is not None else shifted
    total = collectives.all_reduce(local_sum, group, "sum")
    if dim is not None:
        shift = shift.squeeze(dim)
    return torch.log(total) + shift
