"""The distribution interface the engine consumes, `Normal` and
`Categorical`.

Counterpart of the `Distribution` base, `Normal` and `Categorical` in
`aesmc_tpu.distributions`. It does not wrap `torch.distributions`: the
engine needs the optional `batch_shape_mode` tag (see `state`), and draws
that take their noise from the caller (the engine's `noise.NoiseSource`):
standard-normal noise for `rsample`, Gumbel noise for a categorical
`sample`, so that tests can replay the reference's draws.

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
    # Whether `rsample` exists; `state.sample` draws the others detached.
    has_rsample = True

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
        # A Python number becomes a fill on the device: `torch.as_tensor`
        # would copy it from the host, which waits for the card and cannot
        # be captured in a CUDA graph.
        if isinstance(x, torch.Tensor):
            return x.to(dtype=like.dtype, device=like.device)
        return torch.full((), x, dtype=like.dtype, device=like.device)

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


class Categorical(Distribution):
    """Categorical over the last axis of ``logits``; not reparameterizable.

    ``logits`` is a float tensor `[..., D]`; `batch_shape` is its shape
    without the last axis.
    """

    has_rsample = False

    def __init__(self, logits, batch_shape_mode=None):
        self.logits = logits
        self.batch_shape_mode = batch_shape_mode

    @classmethod
    def from_probs(cls, probs, **kwargs):
        return cls(logits=torch.log(torch.as_tensor(probs)), **kwargs)

    @property
    def batch_shape(self):
        return tuple(self.logits.shape[:-1])

    @property
    def num_categories(self) -> int:
        return self.logits.shape[-1]

    def sample(self, sample_shape, gumbel):
        """``argmax(logits + gumbel, -1)`` as int32 (the first maximum on a
        tie, as `jnp.argmax`), for standard Gumbel noise ``gumbel`` of shape
        ``sample_shape + batch_shape + (D,)``: the shape in which
        `jax.random.categorical` draws it."""
        shape = (tuple(sample_shape) + self.batch_shape +
                 (self.num_categories,))
        if tuple(gumbel.shape) != shape:
            raise ValueError(
                f"gumbel has shape {tuple(gumbel.shape)}, expected {shape}")
        logits = self.logits.to(gumbel.dtype)
        return torch.argmax(gumbel + logits, dim=-1).to(torch.int32)

    def log_prob(self, value):
        """Log-probability of integer categories ``value``, broadcast both
        ways against the batch shape. A negative value wraps once (``value
        + D``); a value still outside [0, D) scores NaN, as the JAX
        package's gather route does."""
        log_probs = torch.log_softmax(self.logits, dim=-1)
        value = torch.as_tensor(value, device=log_probs.device).long()
        batch = torch.broadcast_shapes(tuple(value.shape),
                                       tuple(log_probs.shape[:-1]))
        log_probs = log_probs.expand(batch + tuple(log_probs.shape[-1:]))
        value = value.expand(batch)
        d = log_probs.shape[-1]
        value = torch.where(value < 0, value + d, value)
        outside = (value < 0) | (value >= d)
        out = torch.gather(log_probs, -1,
                           value.clamp(0, d - 1).unsqueeze(-1)).squeeze(-1)
        return torch.where(outside, torch.full_like(out, float("nan")), out)
