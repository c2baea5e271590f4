"""The distribution interface the engine consumes, and `Normal`.

Counterpart of the `Distribution` base and `Normal` in
`aesmc_tpu.distributions`. It does not wrap `torch.distributions`: the
engine needs the optional `batch_shape_mode` tag (see `state`) and an
`rsample` that takes its standard-normal noise from the caller (the
engine's `noise.NoiseSource`), so that tests can replay the reference's
draws.

Shapes follow the torch/tfp convention:
    rsample(sample_shape)  -> sample_shape + batch_shape + event_shape
    log_prob(value)        -> broadcast(value batch dims, batch_shape)
"""

from __future__ import annotations

import math as _stdmath
from typing import Tuple

import torch

_HALF_LOG_2PI = 0.5 * _stdmath.log(2.0 * _stdmath.pi)


def _shape(x) -> Tuple[int, ...]:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else ()


class Distribution:
    """Interface: `batch_shape`, `event_shape`, `rsample`, `log_prob`.

    `batch_shape_mode` is an optional `state.BatchShapeMode` tag read by
    `state.sample` and `state.get_batch_shape_mode`.
    """

    batch_shape_mode = None

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        raise NotImplementedError

    @property
    def event_shape(self) -> Tuple[int, ...]:
        return ()

    def rsample(self, sample_shape, eps: torch.Tensor):
        raise ValueError(f"{type(self).__name__} is not reparameterizable")

    def log_prob(self, value):
        raise NotImplementedError


class Normal(Distribution):
    """Univariate normal, elementwise over broadcast(loc, scale).

    `loc` and `scale` are tensors or Python floats.
    """

    def __init__(self, loc, scale, batch_shape_mode=None):
        self.loc = loc
        self.scale = scale
        self.batch_shape_mode = batch_shape_mode

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(_shape(self.loc),
                                            _shape(self.scale)))

    def _param(self, x, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(x, dtype=like.dtype, device=like.device)

    def rsample(self, sample_shape, eps):
        """``loc + scale * eps`` for standard-normal noise ``eps`` of shape
        ``sample_shape + batch_shape`` (see `state.sample`)."""
        shape = tuple(sample_shape) + self.batch_shape
        if tuple(eps.shape) != shape:
            raise ValueError(
                f"eps has shape {tuple(eps.shape)}, expected {shape}")
        return self._param(self.loc, eps) + self._param(self.scale, eps) * eps

    def log_prob(self, value):
        loc = self._param(self.loc, value)
        scale = self._param(self.scale, value)
        z = (value - loc) / scale
        return -0.5 * z * z - torch.log(scale) - _HALF_LOG_2PI
