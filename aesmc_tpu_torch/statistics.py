"""Weighted-particle statistics and sampling from the model prior.

Counterpart of `aesmc_tpu.statistics`: empirical mean and variance over
weighted particles (also per time step of a stacked sequence), (log)
effective sample size, and ancestral sampling
of (latents, observations) from the generative model.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import math as amath
from . import state
from .inference import TimeIndex, _stack_time
from .noise import NoiseSource


def empirical_expectation(value, log_weight, f):
    """E_w[f(value)] over the particle axis.

    Args:
        value: `[batch, particle, ...]` tensor.
        log_weight: `[batch, particle]` unnormalized log-weights.
        f: maps `[batch, ...]` -> `[batch, out...]`; applied per particle.

    Returns: `[batch, out...]` weighted average.
    """
    if tuple(value.shape[:2]) != tuple(log_weight.shape):
        raise ValueError(f"value {tuple(value.shape)} and log_weight "
                         f"{tuple(log_weight.shape)} mismatch")
    normalized_weights = amath.exponentiate_and_normalize(log_weight, dim=1)
    fv = torch.func.vmap(f, in_dims=1, out_dims=1)(value)
    w = normalized_weights.reshape(
        tuple(normalized_weights.shape) + (1,) * (fv.ndim - 2))
    return (w * fv).sum(dim=1)


def empirical_mean(value, log_weight):
    """Weighted mean over particles -> `[batch, ...]`."""
    return empirical_expectation(value, log_weight, lambda x: x)


def empirical_variance(value, log_weight):
    """Weighted variance over particles -> `[batch, ...]`."""
    return (empirical_expectation(value, log_weight, lambda x: x ** 2) -
            empirical_mean(value, log_weight) ** 2)


def empirical_mean_sequence(values, log_weight):
    """Per-time-step weighted means of a stacked `[T, batch, particle, ...]`
    tensor (e.g. `infer(...)["latents"]`) under one `[batch, particle]`
    weight tensor -> `[T, batch, ...]`."""
    return torch.func.vmap(empirical_mean, in_dims=(0, None))(values,
                                                              log_weight)


def empirical_variance_sequence(values, log_weight):
    """Per-time-step weighted variances of a stacked sequence ->
    `[T, batch, ...]` (see `empirical_mean_sequence`)."""
    return torch.func.vmap(empirical_variance, in_dims=(0, None))(
        values, log_weight)


def log_ess(log_weight):
    """log ESS = 2 logsumexp(logw) - logsumexp(2 logw), over particles."""
    dim = 1 if log_weight.ndim == 2 else 0
    return (2 * torch.logsumexp(log_weight, dim=dim) -
            torch.logsumexp(2 * log_weight, dim=dim))


def ess(log_weight):
    """Effective sample size -> `[batch]` (or a scalar)."""
    return torch.exp(log_ess(log_weight))


def sample_from_prior(initial, transition, emission, num_timesteps: int,
                      batch_size: int,
                      noise: Optional[NoiseSource] = None,
                      history_window: int = 1):
    """Ancestral sampling of (latents, observations) from the model prior.

    The components see the contract of `inference.infer`: length-W
    ``previous_latents`` / ``latents`` / ``previous_observations`` lists
    (W = ``history_window``), padded before t = 0 with copies of the t = 0
    values; categorical components (the HMM) draw their integer states
    through `state.sample`. Draws come from ``noise`` (default
    `NoiseSource.seeded(0)` on the card, which raises without one; pass a
    CPU source to sample on the CPU), in the order x_0, y_0, x_1, y_1, ...

    Returns:
        (latents, observations): stacked `[T, batch, ...]` tensors.
    """
    if history_window < 1:
        raise ValueError(
            f"history_window must be >= 1. currently = {history_window}")
    if noise is None:
        noise = NoiseSource.seeded(0)
    latent = state.sample(initial(), batch_size, 1, noise)
    obs = state.sample(emission(latents=[latent], time=0), batch_size, 1,
                       noise)
    latents, observations = [latent], [obs]
    prev_latents = [latent] * history_window
    prev_obs = [obs] * history_window
    for t in range(1, num_timesteps):
        time = TimeIndex(t)
        latent = state.sample(
            transition(previous_latents=prev_latents, time=time,
                       previous_observations=prev_obs),
            batch_size, 1, noise)
        obs = state.sample(
            emission(latents=prev_latents[1:] + [latent], time=time,
                     previous_observations=prev_obs),
            batch_size, 1, noise)
        latents.append(latent)
        observations.append(obs)
        prev_latents = prev_latents[1:] + [latent]
        prev_obs = prev_obs[1:] + [obs]

    def squeeze_particles(value):
        return state.tree_map(lambda x: x.squeeze(2), value)

    return (squeeze_particles(_stack_time(latents)),
            squeeze_particles(_stack_time(observations)))
