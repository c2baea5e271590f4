"""SMC / importance-sampling inference engine.

Counterpart of the Markov branch of `aesmc_tpu.inference.infer`: one
`infer` entry point for 'is' and for 'smc' with systematic, stratified or
multinomial resampling at every step, the same return-dict vocabulary,
detached ancestor indices and backward lineage tracing
(`get_resampled_latents`). Gradients flow through the resampled particle
values, never through ancestor indices or the resampling weights, as in
the JAX package.

The time loop is a plain Python loop (PyTorch runs eagerly); the t = 0 step
stays hoisted, with `time` the int 0, so that user components can branch on
`time == 0`. Later steps pass a `TimeIndex`, an int known to be >= 1. The
loop never waits for the device: nothing in it reads a value back to the
host.

User-component contract (as in the JAX package): four callables returning
`distributions.Distribution`s (or dicts of them). `previous_latents` and
`latents` are length-1 lists holding the previous / current latent;
`previous_observations` is a length-1 list holding y_{t-1};
`observations` is an `ObservationSequence`.

Latents may be float32 (reparameterized proposals) or integer (categorical
proposals: the HMM's int32 states, drawn detached); integer particles go
through the time loop, resampling (K5 on the card), lineage tracing and
the returned stacks in their own dtype.

Not ported yet: ESS-adaptive resampling, `lookahead`, `history_window` > 1,
soft and OT resampling, `remat` and `nan_check`.
"""

from __future__ import annotations

import math as _stdmath
from typing import Optional

import numpy as np
import torch

from . import device as _device
from . import resampling, state
from .noise import NoiseSource
from .resampling import sample_ancestral_index  # noqa: F401  (parity export)

__all__ = [
    "infer", "get_resampled_latents", "sample_ancestral_index",
    "ObservationSequence", "TimeIndex", "stack_observations",
]


class TimeIndex(int):
    """The time index of a step after the hoisted t = 0, known to be >= 1.

    In the eager loop it is a plain int, so `time == t` and
    `observations[time]` behave as for any int.
    """


class ObservationSequence:
    """Time-indexable view over stacked observations `[T, batch, ...]`
    (a tensor or a dict of tensors): `observations[t]` is the `[batch,
    ...]` value at time t, and `len()` is T."""

    __slots__ = ("stacked", "_length")

    def __init__(self, stacked, length: Optional[int] = None):
        self.stacked = stacked
        if length is None:
            length = _first_leaf(stacked).shape[0]
        self._length = length

    def __getitem__(self, t):
        if isinstance(t, slice):
            return ObservationSequence(state.tree_map(lambda x: x[t],
                                                      self.stacked))
        return state.tree_map(lambda x: x[t], self.stacked)

    def __len__(self):
        return self._length

    def __iter__(self):
        return (self[t] for t in range(self._length))


def _as_tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=_device.resolve(device))


def stack_observations(observations, device=None):
    """Normalizes observations to a stacked `[T, batch, ...]` tensor (or
    dict of tensors). Accepts a list of `[batch, ...]` values or an
    already stacked value.

    Tensors stay where the caller put them; numpy arrays and lists become
    tensors on ``device`` (default: the card; raises without one).
    """
    if isinstance(observations, ObservationSequence):
        return observations.stacked
    if isinstance(observations, (list, tuple)):
        first = observations[0]
        if isinstance(first, dict):
            return {k: stack_observations([o[k] for o in observations],
                                          device)
                    for k in first}
        return torch.stack([_as_tensor(o, device) for o in observations],
                           dim=0)
    return state.tree_map(lambda x: _as_tensor(x, device), observations)


def _first_leaf(tree):
    return resampling._leaves(tree)[0]


def _stack_time(values):
    """Stacks a list of per-step tensors (or dicts) on a new time axis."""
    if isinstance(values[0], dict):
        return {k: _stack_time([v[k] for v in values]) for k in values[0]}
    return torch.stack(values, dim=0)


def infer(inference_algorithm: str,
          observations,
          initial,
          transition,
          emission,
          proposal,
          num_particles: int,
          noise: Optional[NoiseSource] = None,
          resampling_method: str = "systematic",
          resampling_implementation: str = "auto",
          return_log_marginal_likelihood: bool = False,
          return_latents: bool = True,
          return_original_latents: bool = False,
          return_log_weight: bool = True,
          return_log_weights: bool = False,
          return_ancestral_indices: bool = False) -> dict:
    """Particle filtering ('smc') or importance sampling ('is') on an SSM.

    Args:
        inference_algorithm: 'is' or 'smc'.
        observations: list of `[batch, ...]` values of length T, or a
            stacked `[T, batch, ...]` value (tensors or dicts of tensors).
            Tensors stay on their device; numpy arrays and lists go to
            the card (see `stack_observations`).
        initial, transition, emission, proposal: user callables (see the
            module docstring). `transition` may be None when T == 1.
        num_particles: number of particles K.
        noise: the source of all random draws; defaults to
            `NoiseSource.seeded(0)` on the observations' device.
        resampling_method: 'systematic', 'stratified' or 'multinomial'.
        resampling_implementation: 'auto' | 'cuda' | 'torch' (see
            `resampling`).
        return_*: which outputs to materialize, as in the JAX package.

    Returns:
        dict with keys log_marginal_likelihood `[batch]`, latents
        `[T, batch, K, ...]`, original_latents, log_weight `[batch, K]`,
        log_weights `[T, batch, K]`, ancestral_indices `[T-1, batch, K]`,
        last_latent; entries are None unless requested.
    """
    if inference_algorithm not in ("is", "smc"):
        raise ValueError(
            "inference_algorithm must be either is or smc. currently = {}"
            .format(inference_algorithm))
    if inference_algorithm == "is" and return_original_latents:
        raise ValueError("return_original_latents shouldn't be True for is")
    if inference_algorithm == "is" and return_ancestral_indices:
        raise ValueError("return_ancestral_indices shouldn't be True for is")

    stacked_obs = stack_observations(observations)
    obs_seq = ObservationSequence(stacked_obs)
    num_timesteps = len(obs_seq)
    first = _first_leaf(stacked_obs)
    batch_size = first.shape[1]
    if noise is None:
        noise = NoiseSource.seeded(0, first.device)
    is_smc = inference_algorithm == "smc"
    implementation = resampling.resolve_implementation(
        first.device, resampling_method, resampling_implementation)

    # ---- t = 0 (hoisted: `time` is the int 0).
    proposal_dist = proposal(time=0, observations=obs_seq)
    latent_0 = state.sample(proposal_dist, batch_size, num_particles, noise)
    proposal_log_prob = state.log_prob(proposal_dist, latent_0)
    initial_log_prob = state.log_prob(initial(), latent_0)
    emission_log_prob = state.log_prob(
        emission(latents=[latent_0], time=0),
        state.expand_observation(obs_seq[0], num_particles))
    log_weight_0 = initial_log_prob + emission_log_prob - proposal_log_prob

    log_num_particles = _stdmath.log(num_particles)
    # Ancestor indices feed lineage tracing and the ancestral-indices output
    # only; without either the kernel skips computing them (and the stacked
    # indices are then [T-1, 0]).
    need_ancestors = bool(return_latents or return_ancestral_indices)
    need_original = return_latents or (is_smc and return_original_latents)
    need_stacked_weights = return_log_weights or not is_smc

    latents = [latent_0]
    log_weights = [log_weight_0]
    ancestors = []
    contributions = []
    prev_latent, prev_log_weight = latent_0, log_weight_0

    # ---- t = 1 .. T-1.
    for t in range(1, num_timesteps):
        time = TimeIndex(t)
        prev_obs_list = [obs_seq[t - 1]]
        if is_smc:
            ancestral_index, previous_latent = resampling._resample(
                prev_log_weight, noise, prev_latent, resampling_method,
                implementation, need_ancestors)
            if ancestral_index is None:
                ancestral_index = torch.zeros(
                    (0,), dtype=torch.int32, device=first.device)
            ancestors.append(ancestral_index)
            contributions.append(
                torch.logsumexp(prev_log_weight, dim=1) - log_num_particles)
        else:
            previous_latent = prev_latent

        proposal_dist = proposal(previous_latents=[previous_latent],
                                 time=time, observations=obs_seq)
        latent_t = state.sample(proposal_dist, batch_size, num_particles,
                                noise)
        proposal_lp = state.log_prob(proposal_dist, latent_t)
        transition_lp = state.log_prob(
            transition(previous_latents=[previous_latent], time=time,
                       previous_observations=prev_obs_list),
            latent_t)
        emission_lp = state.log_prob(
            emission(latents=[latent_t], time=time,
                     previous_observations=prev_obs_list),
            state.expand_observation(obs_seq[t], num_particles))
        # Under always-resampling the new weight is the increment alone.
        log_weight_t = transition_lp + emission_lp - proposal_lp

        if need_original:
            latents.append(latent_t)
        if need_stacked_weights:
            log_weights.append(log_weight_t)
        prev_latent, prev_log_weight = latent_t, log_weight_t

    last_latent, last_log_weight = prev_latent, prev_log_weight
    original_latents = _stack_time(latents) if need_original else None
    stacked_log_weights = (_stack_time(log_weights)
                           if need_stacked_weights else None)
    if is_smc:
        ancestral_indices = (
            torch.stack(ancestors, dim=0) if ancestors else
            torch.zeros((0, batch_size, num_particles), dtype=torch.int32,
                        device=first.device))
    else:
        ancestral_indices = None

    # ---- Estimators: AESMC (smc) and IWAE (is) differ in where the
    # logsumexp over particles sits relative to the sum over time.
    if is_smc:
        if return_log_marginal_likelihood:
            summed = (torch.stack(contributions, dim=0).sum(dim=0)
                      if contributions else 0.0)
            log_marginal_likelihood = (
                summed + torch.logsumexp(last_log_weight, dim=1) -
                log_num_particles)
        else:
            log_marginal_likelihood = None
        traced = (get_resampled_latents(original_latents, ancestral_indices)
                  if return_latents else None)
        log_weight = last_log_weight if return_log_weight else None
    else:
        if return_log_marginal_likelihood or return_log_weight:
            total_log_weight = stacked_log_weights.sum(dim=0)  # [B, K]
        if return_log_marginal_likelihood:
            log_marginal_likelihood = (
                torch.logsumexp(total_log_weight, dim=1) - log_num_particles)
        else:
            log_marginal_likelihood = None
        traced = original_latents if return_latents else None
        log_weight = total_log_weight if return_log_weight else None

    return {
        "log_marginal_likelihood": log_marginal_likelihood,
        "latents": traced,
        "original_latents":
            original_latents if (is_smc and return_original_latents)
            else None,
        "log_weight": log_weight,
        "log_weights": stacked_log_weights if return_log_weights else None,
        "ancestral_indices":
            ancestral_indices if (is_smc and return_ancestral_indices)
            else None,
        "last_latent": last_latent,
    }


def get_resampled_latents(latents, ancestral_indices):
    """Reconstructs surviving-lineage trajectories from SMC outputs.

    Composes the ancestry maps backward through time.

    Args:
        latents: stacked `[T, batch, particle, ...]` tensor or dict (or a
            list of `[batch, particle, ...]` values, stacked here).
        ancestral_indices: `[T-1, batch, particle]` int tensor (or list).

    Returns:
        stacked `[T, batch, particle, ...]` lineage-traced latents.
    """
    if isinstance(latents, (list, tuple)):
        latents = _stack_time(list(latents))
    if isinstance(ancestral_indices, (list, tuple)):
        ancestral_indices = (torch.stack(list(ancestral_indices), dim=0)
                             if ancestral_indices else None)
    num_timesteps = _first_leaf(latents).shape[0]
    if ancestral_indices is not None and ancestral_indices.shape[0] == 0:
        ancestral_indices = None
    if ancestral_indices is None:
        if num_timesteps != 1:
            raise ValueError(
                "ancestral_indices must have length len(latents) - 1")
        return latents
    if ancestral_indices.shape[0] != num_timesteps - 1:
        raise ValueError(
            "ancestral_indices must have length len(latents) - 1")

    batch_size, num_particles = ancestral_indices.shape[1:3]
    index = torch.arange(num_particles, device=ancestral_indices.device
                         ).expand(batch_size, num_particles)
    traced = [None] * num_timesteps
    for t in range(num_timesteps - 1, 0, -1):
        traced[t] = state.resample(
            state.tree_map(lambda x, t=t: x[t], latents), index)
        index = torch.gather(ancestral_indices[t - 1].long(), 1, index)
    traced[0] = state.resample(state.tree_map(lambda x: x[0], latents),
                               index)
    return _stack_time(traced)
