"""Resample-move particle filter (Gilks & Berzuini 2001).

Counterpart of `aesmc_tpu.resample_move`: after each resampling step the
duplicated particles are diversified by Metropolis-Hastings moves that
leave the filtering posterior invariant, without touching the weights, so
the log-Z estimator stays unbiased. At each step t >= 1:

1. resample the carried pairs (x_{t-2}, x_{t-1}) with the step-(t-1)
   weights: one fused resample + gather with the parent and the head as
   two value columns (on the card one K1 launch with D = 2; at t = 1 the
   head x_0 alone, D = 1), ancestors not kept;
2. move the head x_{t-1}, its parent fixed, with `num_move_steps`
   random-walk MH steps targeting f(x_{t-1} | x_{t-2}) g(y_{t-1} |
   x_{t-1}) (the prior mu in place of f at t = 1);
3. propose x_t from the moved head and weight as usual.

The random-walk scale is `move_scale` times the weighted per-dimension std
of the cloud, optionally times a per-row multiplier that a Robbins-Monro
recursion steers toward `target_acceptance`, on the device.

Draws, in order: the t = 0 proposal's normals; then at each step t >= 1
the resampling noise (`[B, 1]` uniforms for systematic), for each move a
normal like the head (one a leaf, in the head's leaf order) and `[B, K]`
uniforms kept off 0 (as the JAX package draws them with minval 1e-38),
then the proposal's normals. The time loop reads nothing from the device,
so a call can be captured in a CUDA graph. Continuous latents only.

A callable ``resampling_implementation`` resamples the pairs (as `infer`
takes one). A distributed one (`parallel.dist_resampling`, carrying
``.mesh``) runs the filter on its mesh: every rank holds its block, the
observations' rows of its data shard and K / n particles of each, draws
its block of the single-device draws, and log-Z, the acceptance means
and the random walk's weighted std reduce over the particle group.
"""

from __future__ import annotations

import math as _stdmath
from typing import Optional

import torch

from . import resampling, state
from .inference import (ObservationSequence, TimeIndex, _first_leaf,
                        _stack_time, stack_observations)
from .noise import NoiseSource
from .sharding_utils import (cloud_of, particle_logsumexp, particle_mean,
                             particle_softmax)

__all__ = ["resample_move_filter"]

# The JAX package's accept uniforms have minval 1e-38: log(u) stays
# finite.
_MIN_UNIFORM = 1e-38


def _weighted_std(tree, log_weight, cloud=None):
    """Per-leaf, per-trailing-dim weighted std over the particle axis,
    shape `[B, 1(, D)]`: the random walk's bandwidth base (over the whole
    cloud on a mesh)."""
    w = particle_softmax(log_weight, cloud)

    def total(x):
        x = torch.sum(x, dim=1, keepdim=True)
        return x if cloud is None else cloud.particle_sum(x)

    def leaf_std(x):
        wx = w.reshape(tuple(w.shape) + (1,) * (x.ndim - 2))
        mean = total(wx * x)
        var = total(wx * (x - mean) ** 2)
        return torch.sqrt(torch.clamp(var, min=1e-12))

    return state.tree_map(leaf_std, tree)


def _tree_zip(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_zip(fn, *[t[k] for t in trees]) for k in trees[0]}
    return fn(*trees)


def resample_move_filter(observations, initial, transition, emission,
                         proposal, num_particles: int,
                         noise: Optional[NoiseSource] = None,
                         num_move_steps: int = 2,
                         move_scale: float = 0.5,
                         target_acceptance=None,
                         adaptation_gain: float = 0.5,
                         resampling_method: str = "systematic",
                         resampling_implementation="auto",
                         return_latents: bool = True):
    """SMC with post-resampling MH rejuvenation of the parents.

    Args:
        observations: list or stacked `[T, batch, ...]` tensor (or dict).
        initial, transition, emission, proposal: engine components.
        num_particles: K.
        noise: the source of every draw (order in the module docstring);
            default `NoiseSource.seeded(0)` on the observations' device.
        num_move_steps: MH steps per filter step (0 = plain SMC).
        move_scale: dimensionless random-walk scale, times the weighted
            per-dimension std of the current cloud.
        target_acceptance: optional acceptance target in (0, 1): a
            per-batch-row log-scale multiplier is Robbins-Monro-updated
            after every step, `log_mult += gain * (rate - target)`.
        adaptation_gain: the Robbins-Monro gain.
        resampling_method / resampling_implementation: as in `infer`
            ('auto': the kernels for CUDA tensors, or a callable; a
            distributed one runs on its mesh: module docstring, with
            ``num_particles`` the whole cloud's K and the outputs this
            rank's blocks).
        return_latents: include the filtered latents `[T, B, K, ...]`.

    Returns:
        dict with 'log_marginal_likelihood' `[batch]`, 'log_weight'
        `[batch, K]`, 'acceptance_rate' `[T-1, batch]` (mean MH acceptance
        a step; zeros when `num_move_steps == 0`), and 'latents' when
        requested.
    """
    if num_move_steps < 0:
        raise ValueError("num_move_steps must be >= 0. currently = "
                         f"{num_move_steps}")
    stacked_obs = stack_observations(observations)
    obs_seq = ObservationSequence(stacked_obs)
    num_timesteps = len(obs_seq)
    first = _first_leaf(stacked_obs)
    batch_size = first.shape[1]
    if noise is None:
        noise = NoiseSource.seeded(0, first.device)
    cloud = cloud_of(None, resampling_implementation)
    k = (num_particles if cloud is None else
         cloud.local_particles(num_particles))
    log_k = _stdmath.log(num_particles)
    implementation = resampling.resolve_implementation(
        first.device, resampling_method, resampling_implementation)
    if cloud is not None:
        noise = cloud.noise(noise)

    def lse(x):
        return particle_logsumexp(x, cloud)

    def resample(log_weight, value):
        if callable(implementation):
            _, out = resampling.callable_resample(
                implementation, log_weight.detach(), noise, value,
                lse(log_weight).detach())
            return out
        _, out = resampling._resample(log_weight, noise, value,
                                      resampling_method, implementation,
                                      need_indices=False)
        return out

    # ---- t = 0 (hoisted).
    proposal_dist = proposal(time=0, observations=obs_seq)
    latent_0 = state.sample(proposal_dist, batch_size, k, noise)
    log_weight_0 = (state.log_prob(initial(), latent_0) +
                    state.log_prob(emission(latents=[latent_0], time=0),
                                   state.expand_observation(obs_seq[0], k))
                    - state.log_prob(proposal_dist, latent_0))

    def head_log_target(head, parent, time_head, obs_head, prev_obs_head):
        """log f(head | parent) + log g(y | head); prior mu at t = 0."""
        if parent is None:
            trans_lp = state.log_prob(initial(), head)
            emis_lp = state.log_prob(emission(latents=[head], time=0),
                                     state.expand_observation(obs_head, k))
        else:
            prev_list = ([prev_obs_head] if prev_obs_head is not None
                         else None)
            trans_lp = state.log_prob(
                transition(previous_latents=[parent], time=time_head,
                           previous_observations=prev_list), head)
            emis_lp = state.log_prob(
                emission(latents=[head], time=time_head,
                         previous_observations=prev_list),
                state.expand_observation(obs_head, k))
        return trans_lp + emis_lp

    def mh_move(head, parent, log_weight_for_scale, time_head, obs_head,
                prev_obs_head, log_scale_mult):
        """num_move_steps random-walk MH steps on ``head``; returns (head,
        acceptance rate `[B]`)."""
        if num_move_steps == 0:
            return head, torch.zeros((batch_size,),
                                     dtype=log_weight_for_scale.dtype,
                                     device=log_weight_for_scale.device)
        mult = None
        if log_scale_mult is not None:
            mult = torch.exp(log_scale_mult)

        def leaf_scale(s):
            out = move_scale * s
            if mult is not None:
                out = out * mult.reshape((-1,) + (1,) * (s.ndim - 1))
            return out

        scale = state.tree_map(
            leaf_scale, _weighted_std(head, log_weight_for_scale, cloud))
        lp = head_log_target(head, parent, time_head, obs_head,
                             prev_obs_head)
        accepted_total = torch.zeros((batch_size,), dtype=lp.dtype,
                                     device=lp.device)
        for _ in range(num_move_steps):
            eps = state.tree_map(lambda x: noise.normal(tuple(x.shape)),
                                 head)
            cand = _tree_zip(lambda x, e, s: x + s * e, head, eps, scale)
            cand_lp = head_log_target(cand, parent, time_head, obs_head,
                                      prev_obs_head)
            log_u = torch.log(noise.uniform((batch_size, k)).clamp_(
                min=_MIN_UNIFORM))
            acc = log_u < (cand_lp - lp)                      # [B, K]
            head = _tree_zip(
                lambda c, x: torch.where(
                    acc.reshape(tuple(acc.shape) + (1,) * (x.ndim - 2)),
                    c, x), cand, head)
            lp = torch.where(acc, cand_lp, lp)
            accepted_total = accepted_total + particle_mean(
                acc.to(lp.dtype), cloud)
        return head, accepted_total / num_move_steps

    def propose_and_weight(moved, t, obs_prev):
        time = TimeIndex(t)
        proposal_dist = proposal(previous_latents=[moved], time=time,
                                 observations=obs_seq)
        latent_t = state.sample(proposal_dist, batch_size, k, noise)
        log_weight_t = (
            state.log_prob(
                transition(previous_latents=[moved], time=time,
                           previous_observations=[obs_prev]), latent_t) +
            state.log_prob(
                emission(latents=[latent_t], time=time,
                         previous_observations=[obs_prev]),
                state.expand_observation(obs_seq[t], k)) -
            state.log_prob(proposal_dist, latent_t))
        return latent_t, log_weight_t

    if num_timesteps == 1:
        out = {"log_marginal_likelihood": lse(log_weight_0) - log_k,
               "log_weight": log_weight_0,
               "acceptance_rate": torch.zeros((0, batch_size),
                                              device=first.device)}
        if return_latents:
            out["latents"] = state.tree_map(lambda x: x[None], latent_0)
        return out

    # ---- t = 1 (hoisted too: the head is x_0, whose target is the prior).
    log_mult = torch.zeros((batch_size,), dtype=log_weight_0.dtype,
                           device=log_weight_0.device)
    resampled_0 = resample(log_weight_0, latent_0)
    parent, rate = mh_move(resampled_0, None, log_weight_0, None,
                           obs_seq[0], None, log_mult)
    if target_acceptance is not None:
        log_mult = log_mult + adaptation_gain * (rate - target_acceptance)
    log_z = lse(log_weight_0) - log_k
    latent, log_weight = propose_and_weight(parent, 1, obs_seq[0])
    latents, rates = [latent_0, latent], [rate]

    # ---- t = 2 .. T-1.
    for t in range(2, num_timesteps):
        # 1. resample the (parent, head) pairs with the head weights.
        pair = resample(log_weight, {"parent": parent, "head": latent})
        log_z = log_z + lse(log_weight) - log_k
        # 2. move the head x_{t-1} | x_{t-2}, y_{t-1}.
        moved, rate = mh_move(pair["head"], pair["parent"], log_weight,
                              TimeIndex(t - 1), obs_seq[t - 1],
                              obs_seq[t - 2], log_mult)
        if target_acceptance is not None:
            log_mult = log_mult + adaptation_gain * (
                rate - target_acceptance)
        # 3. propose x_t and weight.
        latent, log_weight = propose_and_weight(moved, t, obs_seq[t - 1])
        parent = moved
        rates.append(rate)
        if return_latents:
            latents.append(latent)

    out = {"log_marginal_likelihood": log_z + lse(log_weight) - log_k,
           "log_weight": log_weight,
           "acceptance_rate": torch.stack(rates, dim=0)}
    if return_latents:
        out["latents"] = _stack_time(latents)
    return out
