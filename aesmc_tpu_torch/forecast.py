"""Predictive distributions: h-step-ahead forecasting and calibration.

Counterpart of `aesmc_tpu.forecast`:

1. `forecast` rolls the weighted particle cloud H steps through the
   model: each particle is advanced through the transition and draws an
   observation at every step. The weights carry over unchanged (nothing
   is assimilated), so every predictive functional is a weighted
   expectation over the rolled-out particles.
2. `weighted_quantiles`: predictive intervals from weighted samples (the
   inverse CDF of the weighted empirical distribution).
3. `predictive_pit`: probability-integral-transform values u =
   P_pred(y <= y_realized), Uniform(0, 1) under a calibrated forecast.
4. `forecast_online`: `forecast` from the streaming filter's carry
   (`online.OnlineFilterState`).
"""

from __future__ import annotations

import torch

from . import resampling, state
from .inference import DeviceTimeIndex, TimeIndex, _stack_time

__all__ = ["forecast", "forecast_online", "weighted_quantiles",
           "predictive_pit"]


def forecast(latent, log_weight, transition, emission, horizon: int,
             noise, start_time: int, previous_observation=None):
    """Rolls the weighted particle cloud ``horizon`` steps through the
    model.

    Args:
        latent: `[batch, K, ...]` tensor (or dict): the current posterior
            particles (e.g. ``infer(...)['latents'][-1]``).
        log_weight: `[batch, K]` log-weights of the particles (returned
            unchanged).
        transition, emission: model components (the engine's contract).
        horizon: H >= 1 steps.
        noise: the `NoiseSource`; each step draws the latents, then the
            observations.
        start_time: time index of the last assimilated observation; step
            h runs at ``TimeIndex(start_time + h)`` (a
            `inference.DeviceTimeIndex` when ``start_time`` is a tensor,
            read by no host).
        previous_observation: `[batch, ...]` y_t, for models whose
            components read ``previous_observations``. Later steps feed
            back the per-particle sampled observations (`[batch, K,
            ...]`), so such models must broadcast over the particle dim.

    Returns:
        dict with 'latents' `[H, batch, K, ...]`, 'observations' `[H,
        batch, K, ...]` (per-particle predictive samples) and
        'log_weight' (the input).
    """
    if horizon < 1:
        raise ValueError(f"horizon must be >= 1. currently = {horizon}")
    batch_size, num_particles = log_weight.shape
    prev_obs = (None if previous_observation is None else
                state.expand_observation(previous_observation,
                                         num_particles))
    lat = latent
    latents, observations = [], []
    for h in range(1, horizon + 1):
        time = (DeviceTimeIndex(start_time + h)
                if isinstance(start_time, torch.Tensor) else
                TimeIndex(int(start_time) + h))
        prev_obs_list = [prev_obs] if prev_obs is not None else None
        lat = state.sample(
            transition(previous_latents=[lat], time=time,
                       previous_observations=prev_obs_list),
            batch_size, num_particles, noise)
        obs = state.sample(
            emission(latents=[lat], time=time,
                     previous_observations=prev_obs_list),
            batch_size, num_particles, noise)
        if prev_obs is not None:
            prev_obs = obs
        latents.append(lat)
        observations.append(obs)
    return {"latents": _stack_time(latents),
            "observations": _stack_time(observations),
            "log_weight": log_weight}


def forecast_online(filter_state, transition, emission, horizon: int,
                    noise):
    """`forecast` from a streaming carry (`online.OnlineFilterState`): the
    particles, weights, last observation and time all read from it, the
    time as a tensor (no host read)."""
    return forecast(filter_state.latent, filter_state.log_weight,
                    transition, emission, horizon, noise,
                    start_time=filter_state.t - 1,
                    previous_observation=filter_state.prev_observation)


def weighted_quantiles(values, log_weight, qs):
    """Quantiles of the weighted empirical distribution, per batch row.

    Args:
        values: `[batch, K]` samples.
        log_weight: `[batch, K]` log-weights.
        qs: sequence of quantiles in (0, 1).

    Returns:
        `[batch, len(qs)]`: the lowest sample whose cumulative weight
        reaches q.
    """
    order = torch.argsort(values, dim=1, stable=True)
    sorted_vals = torch.take_along_dim(values, order, dim=1)
    w = torch.softmax(log_weight, dim=1)
    cum = resampling._row_cumsum(torch.take_along_dim(w, order, dim=1))
    q = torch.as_tensor(qs, dtype=cum.dtype, device=cum.device)
    idx = torch.searchsorted(cum, q.expand(cum.shape[0], -1).contiguous())
    idx = idx.clamp_(0, values.shape[1] - 1)
    return torch.take_along_dim(sorted_vals, idx, dim=1)


def predictive_pit(predicted, log_weight, realized):
    """PIT value u = P_pred(Y < y) + 0.5 P_pred(Y = y) per batch row (the
    randomized-PIT midpoint handles ties of discrete observations).

    Args:
        predicted: `[batch, K]` predictive samples (e.g.
            ``forecast(...)['observations'][0]``).
        log_weight: `[batch, K]` log-weights.
        realized: `[batch]` the observation that arrived.

    Returns:
        `[batch]` PIT values in [0, 1].
    """
    realized = realized[:, None]
    w = torch.softmax(log_weight, dim=1)
    below = (w * (predicted < realized)).sum(dim=1)
    equal = (w * (predicted == realized)).sum(dim=1)
    return below + 0.5 * equal
