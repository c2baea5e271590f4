"""State and shape algebra over the `[batch, particle]` axes.

Counterpart of `aesmc_tpu.state`: the three-way `BatchShapeMode` dispatch
that lets one distribution serve as an unexpanded prior, a per-batch-row
distribution or a per-particle distribution; `sample` and `log_prob`
across those modes; particle `resample`; observation expansion.

Values are tensors or dicts of tensors. Sampling takes its noise from a
`noise.NoiseSource` (the JAX package takes a PRNG key).
"""

from __future__ import annotations

import copy
import enum
import warnings
from typing import Optional

import torch

from . import distributions as dists
from . import noise as noise_


class BatchShapeMode(enum.Enum):
    NOT_EXPANDED = 0      # batch_shape is [...]
    BATCH_EXPANDED = 1    # batch_shape is [batch_size, ...]
    FULLY_EXPANDED = 2    # batch_shape is [batch_size, num_particles, ...]


def set_batch_shape_mode(distribution, batch_shape_mode: BatchShapeMode):
    """A copy of ``distribution`` tagged with an explicit mode (a dict of
    distributions: each entry tagged). The original is left as it was, as
    the JAX package's immutable distributions are; call sites write
    ``d = set_batch_shape_mode(d, mode)``."""
    if isinstance(distribution, dict):
        return {k: set_batch_shape_mode(v, batch_shape_mode)
                for k, v in distribution.items()}
    tagged = copy.copy(distribution)
    tagged.batch_shape_mode = batch_shape_mode
    return tagged


def get_batch_shape_mode(distribution,
                         batch_size: Optional[int] = None,
                         num_particles: Optional[int] = None
                         ) -> BatchShapeMode:
    """The explicit tag if the distribution has one, else the mode
    inferred from its batch shape, with a warning where the inference
    could be wrong (same rules as `aesmc_tpu.state.get_batch_shape_mode`).
    """
    explicit = getattr(distribution, "batch_shape_mode", None)
    if explicit is not None:
        return explicit

    batch_shape = tuple(distribution.batch_shape)

    def warn(result):
        warnings.warn(
            "Inferred batch_shape_mode ({}) of distribution ({}) might"
            " be wrong given its batch_shape ({}), batch_size ({}) and"
            " num_particles ({}). Consider specifying the"
            " batch_shape_mode explicitly.".format(
                result, type(distribution).__name__, batch_shape,
                batch_size, num_particles),
            RuntimeWarning, stacklevel=3)

    if len(batch_shape) == 0:
        return BatchShapeMode.NOT_EXPANDED
    if len(batch_shape) == 1:
        if batch_shape[0] == batch_size:
            warn(BatchShapeMode.BATCH_EXPANDED)
            return BatchShapeMode.BATCH_EXPANDED
        return BatchShapeMode.NOT_EXPANDED
    if batch_shape[0] == batch_size:
        if batch_shape[1] == num_particles:
            result = BatchShapeMode.FULLY_EXPANDED
        else:
            result = BatchShapeMode.BATCH_EXPANDED
        warn(result)
        return result
    return BatchShapeMode.NOT_EXPANDED


def sample(distribution, batch_size: int, num_particles: int, noise):
    """Samples `[batch_size, num_particles, ...]` tensors (or dicts).

    Each distribution takes one draw of its `noise_kind` from ``noise``
    (none for `Deterministic`). Reparameterized distributions sample
    pathwise (`rsample`), with their noise drawn in the output's
    `[batch, particle, ...]` layout. The others (discrete latents) sample
    detached, from noise drawn as the JAX package's `jax.random` draws it
    (`Distribution.noise_shape`): ``sample_shape + batch_shape (+ (D,) for
    the categoricals)``, so `[num_particles, batch, ...]` for a
    BATCH_EXPANDED distribution, whose draw is then swapped to `[batch,
    particle]`. A raw tensor passes through.
    """
    if isinstance(distribution, dict):
        return {k: sample(v, batch_size, num_particles, noise)
                for k, v in distribution.items()}
    if isinstance(distribution, torch.Tensor):
        return distribution
    if not isinstance(distribution, dists.Distribution):
        raise AttributeError(
            "distribution must be a dict or a Distribution. Got: {}".format(
                distribution))
    mode = get_batch_shape_mode(distribution, batch_size, num_particles)
    if mode not in _SAMPLE_SHAPES:
        raise ValueError(f"batch_shape_mode {mode} not supported")
    sample_shape = _SAMPLE_SHAPES[mode](batch_size, num_particles)
    kind = distribution.noise_kind
    if not distribution.has_rsample:
        shape = distribution.noise_shape(sample_shape)
        draw = (noise_.particle_major(noise, kind, shape)
                if mode == BatchShapeMode.BATCH_EXPANDED else
                getattr(noise, kind)(shape))
        with torch.no_grad():
            result = distribution.sample(sample_shape, draw)
        if mode == BatchShapeMode.BATCH_EXPANDED:
            return result.transpose(0, 1).contiguous()
        return result
    tail = tuple(distribution.batch_shape) + tuple(distribution.event_shape)
    if mode == BatchShapeMode.BATCH_EXPANDED:
        # The distribution samples [num_particles, batch_size, ...]; the
        # noise is drawn as [batch, particle, ...] and swapped to match.
        eps = (None if kind is None else getattr(noise, kind)(
            (tail[0], num_particles) + tail[1:]).transpose(0, 1))
        return distribution.rsample(sample_shape, eps).transpose(0, 1)
    eps = (None if kind is None else
           getattr(noise, kind)(tuple(sample_shape) + tail))
    return distribution.rsample(sample_shape, eps)


# The sample shape a distribution is drawn at in each mode.
_SAMPLE_SHAPES = {
    BatchShapeMode.NOT_EXPANDED: lambda b, k: (b, k),
    BatchShapeMode.BATCH_EXPANDED: lambda b, k: (k,),
    BatchShapeMode.FULLY_EXPANDED: lambda b, k: (),
}


def log_prob(distribution, value):
    """Log probability of ``value``, reduced to `[batch, particle]`.

    The value's batch dims may exceed the distribution's by 0, 2
    (broadcast) or 1 (the BATCH_EXPANDED transpose); extra per-event
    dims are summed.
    """
    if isinstance(distribution, dict):
        total = None
        for k, v in distribution.items():
            lp = log_prob(v, value[k])
            total = lp if total is None else total + lp
        return total
    if not isinstance(distribution, dists.Distribution):
        raise AttributeError(
            "distribution must be a dict or a Distribution. Got: {}".format(
                distribution))
    batch_ndim = len(distribution.batch_shape)
    value_batch_ndim = value.ndim - len(distribution.event_shape)
    if value_batch_ndim in (batch_ndim, batch_ndim + 2):
        logp = distribution.log_prob(value)
    elif value_batch_ndim == batch_ndim + 1:
        logp = distribution.log_prob(
            value.transpose(0, 1)).transpose(0, 1)
    else:
        raise RuntimeError(
            "Incompatible distribution.batch_shape ({}) and "
            "value.shape ({}).".format(distribution.batch_shape,
                                       tuple(value.shape)))
    return logp.reshape(value.shape[0], value.shape[1], -1).sum(dim=2)


def tree_map(fn, value):
    """Applies ``fn`` to every tensor of a tensor or a dict of them."""
    if isinstance(value, dict):
        return {k: tree_map(fn, v) for k, v in value.items()}
    return fn(value)


def resample(value, ancestral_index: torch.Tensor):
    """Gathers particles by ancestor index: each `[batch, particle, ...]`
    tensor of ``value`` is gathered along the particle axis with the
    `[batch, particle]` ``ancestral_index``."""
    idx = ancestral_index.long()

    def gather(leaf):
        if tuple(idx.shape) != tuple(leaf.shape[:2]):
            raise ValueError(
                f"ancestral_index shape {tuple(idx.shape)} does not match "
                f"the leading dims of value shape {tuple(leaf.shape)}")
        expanded = idx.reshape(tuple(idx.shape) + (1,) * (leaf.ndim - 2))
        return torch.take_along_dim(leaf, expanded, dim=1)

    return tree_map(gather, value)


def expand_observation(observation, num_particles: int):
    """`[batch, ...]` -> `[batch, num_particles, ...]`, as a view."""
    def expand(leaf):
        return leaf.unsqueeze(1).expand(
            (leaf.shape[0], num_particles) + tuple(leaf.shape[1:]))

    return tree_map(expand, observation)
