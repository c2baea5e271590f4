"""IF2 iterated filtering: maximum likelihood for state-space models.

Counterpart of `aesmc_tpu.if2` (Ionides, Nguyen, Atchade, Stoev & King,
PNAS 2015): each particle carries its own parameter vector, which takes a
small random-walk perturbation at every step and is resampled jointly
with the state, so good parameter regions gather particles; iterating the
filter with a geometrically cooled perturbation concentrates the swarm at
the maximum-likelihood estimate. Derivative-free: it only runs a filter.

Parameters live as `[B, K]` tensors handed straight to the components
(``build_components(theta)`` every step): the LGSSM components keep a
tensor argument as given (`models.lgssm._param`), so
``lgssm.Transition(mult=theta["mult"], scale=1.0)`` broadcasts it against
the `[B, K]` latents on the card. Batch rows fit B independent datasets.

Each step resamples with one call of the shared resampler (on the card one
K1 launch, indices only), then gathers the latent and every parameter
leaf by the indices (`take_along_dim`); each iteration ends with one more
such draw, which weight-averages the final swarm. Nothing is read from
the device, so a call can be captured in a CUDA graph (the proposal is
best built once, outside ``build_components``).

Draws, in order, per iteration: the t = 0 re-dispersal's normals (one
`[B, K]` draw a parameter leaf, dicts in sorted key order), the t = 0
proposal's normals, then per step t >= 1 the resampling noise, the
perturbation normals and the proposal's normals, and last the final
draw's resampling noise. They are the JAX package's `(resample, propose,
perturb)` streams of `split(key, (M, T, 3))[m, t]`, the final draw from
stream `[m, 0, 0]`.

A callable ``resampling_implementation`` draws the indices, and the
latent and parameters move with them (as leaves of a fused exchange). A
distributed one (`parallel.dist_resampling`, carrying ``.mesh``) runs
the fit on its mesh: every rank holds the observations' rows of its
data shard and K / n particles of each (theta0's `[B]` and `[B, K]`
leaves are cut to this rank's block), draws its block of the
single-device draws, and log-Z and the swarm means reduce over the
particle group.
"""

from __future__ import annotations

import math as _stdmath
from typing import Callable, Optional

import torch

from . import resampling, state
from .inference import (ObservationSequence, TimeIndex, _first_leaf,
                        _sum_in_order, stack_observations)
from .noise import NoiseSource
from .sharding_utils import cloud_of, particle_logsumexp, particle_mean
from .utils.pytree import rebuild, sorted_leaves

__all__ = ["if2"]


def if2(observations,
        build_components: Callable,
        theta0,
        rw_scale,
        num_particles: int,
        num_iterations: int,
        noise: Optional[NoiseSource] = None,
        cooling: float = 0.9,
        initial_perturbation: float = 2.0,
        resampling_method: str = "systematic",
        resampling_implementation="auto") -> dict:
    """Iterated filtering (IF2) maximum-likelihood estimation.

    Args:
        observations: list of `[B, ...]` steps or stacked `[T, B, ...]`
            tensor. Batch rows are independent datasets, each fitted by
            its own swarm.
        build_components: `theta -> (initial, transition, emission,
            proposal)`, where `theta` has theta0's structure with `[B, K]`
            tensor leaves, which the components broadcast against the
            `[B, K]` latents (`lgssm.Transition(mult=theta["mult"],
            scale=s)`). The proposal is used as-is.
        theta0: a number, tensor or dict of them, each scalar, `[B]` or
            `[B, K]`: the starting centre of the swarm (the global batch
            and K on a mesh).
        rw_scale: theta0's structure: each parameter's random-walk
            standard deviation at cooling 1.
        num_particles: the swarm size K.
        num_iterations: M filtering passes; pass m perturbs with scale
            `cooling**m`.
        noise: the source of every draw (order in the module docstring);
            default `NoiseSource.seeded(0)` on the observations' device.
        cooling: geometric cooling factor per iteration.
        initial_perturbation: multiplier on the t = 0 re-dispersal of the
            swarm at the start of every iteration.
        resampling_method / resampling_implementation: the joint (state,
            theta) resampler ('auto': the kernels for CUDA tensors), or a
            callable; a distributed one runs on its mesh (module
            docstring: the observations are this rank's rows and the
            outputs this rank's blocks).

    Returns:
        dict with `theta` (the final swarm, `[B, K]` leaves), `theta_mean`
        (`[B]` leaves), `theta_trajectory` (`[M, B]` leaves: the swarm
        means after each iteration) and `log_likelihoods` (`[M, B]`: each
        iteration's log-Z of the perturbed filter).
    """
    stacked_obs = stack_observations(observations)
    obs_seq = ObservationSequence(stacked_obs)
    num_timesteps = len(obs_seq)
    first = _first_leaf(stacked_obs)
    batch_size = first.shape[1]
    device = first.device
    if noise is None:
        noise = NoiseSource.seeded(0, device)
    cloud = cloud_of(None, resampling_implementation)
    k = (num_particles if cloud is None else
         cloud.local_particles(num_particles))
    log_num_particles = _stdmath.log(num_particles)
    implementation = resampling.resolve_implementation(
        device, resampling_method, resampling_implementation)
    rows = particles = slice(None)
    global_batch = batch_size
    if cloud is not None:
        noise = cloud.noise(noise)
        global_batch = batch_size * cloud.n_data
        rows = cloud.rows(global_batch)
        particles = cloud.particles(num_particles)

    def lse(x):
        return particle_logsumexp(x, cloud)

    def expand_theta(x):
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(x, dtype=torch.float32)
            if x.ndim == 0:
                return torch.full((batch_size, k), float(x), device=device)
            x = x.to(device)
        if x.ndim == 0:
            return x.to(torch.float32).expand(batch_size, k)
        if tuple(x.shape) == (global_batch,):
            return x[rows, None].expand(batch_size, k)
        if tuple(x.shape) == (global_batch, num_particles):
            return x[rows, particles]
        raise ValueError(
            "theta0 leaves must be scalar, [batch], or "
            f"[batch, particles]; got shape {tuple(x.shape)}")

    theta = rebuild(theta0, [expand_theta(x) for x in sorted_leaves(theta0)])
    scales = sorted_leaves(rw_scale)

    def perturb(theta, sigma):
        return rebuild(theta, [
            th + sigma * s * noise.normal((batch_size, k))
            for th, s in zip(sorted_leaves(theta), scales)])

    def gather(theta, index):
        return rebuild(theta, [torch.take_along_dim(th, index, dim=1)
                               for th in sorted_leaves(theta)])

    def indices(log_weight):
        return resampling.sample_indices(log_weight, noise,
                                         resampling_method,
                                         implementation).long()

    def resample(log_weight, latent, theta):
        """(latent, theta) at the step's ancestors."""
        if not callable(implementation):
            index = indices(log_weight)
            return (None if latent is None else
                    state.resample(latent, index)), gather(theta, index)
        value = {"theta": theta} if latent is None else {
            "latent": latent, "theta": theta}
        _, out = resampling.callable_resample(
            implementation, log_weight.detach(), noise, value,
            lse(log_weight).detach())
        return out.get("latent"), out["theta"]

    def one_iteration(theta_swarm, sigma):
        # Re-disperse the swarm at t = 0 (seeds iteration 0 from theta0).
        theta = perturb(theta_swarm, sigma * initial_perturbation)
        initial, transition, emission, proposal = build_components(theta)
        proposal_dist = proposal(time=0, observations=obs_seq)
        latent = state.sample(proposal_dist, batch_size, k, noise)
        log_weight = (
            state.log_prob(initial(), latent) +
            state.log_prob(emission(latents=[latent], time=0),
                           state.expand_observation(obs_seq[0], k)) -
            state.log_prob(proposal_dist, latent))
        contributions = []
        for t in range(1, num_timesteps):
            time = TimeIndex(t)
            prev_latent, theta = resample(log_weight, latent, theta)
            theta = perturb(theta, sigma)
            _, transition, emission, proposal = build_components(theta)
            proposal_dist = proposal(previous_latents=[prev_latent],
                                     time=time, observations=obs_seq)
            latent = state.sample(proposal_dist, batch_size, k, noise)
            obs_prev = [obs_seq[t - 1]]
            contributions.append(lse(log_weight) - log_num_particles)
            log_weight = (
                state.log_prob(
                    transition(previous_latents=[prev_latent], time=time,
                               previous_observations=obs_prev), latent) +
                state.log_prob(
                    emission(latents=[latent], time=time,
                             previous_observations=obs_prev),
                    state.expand_observation(obs_seq[t], k)) -
                state.log_prob(proposal_dist, latent))
        total = _sum_in_order(contributions) if contributions else 0.0
        log_z = total + lse(log_weight) - log_num_particles
        # Weight-average the final swarm before the next iteration, so
        # that the last observation's information survives the handoff.
        _, theta_end = resample(log_weight, None, theta)
        return theta_end, log_z

    means, log_liks = [], []
    for m in range(num_iterations):
        theta, log_z = one_iteration(theta, cooling ** m)
        means.append(rebuild(theta, [particle_mean(th, cloud)
                                     for th in sorted_leaves(theta)]))
        log_liks.append(log_z)

    def stack(trees):
        return rebuild(trees[0], [torch.stack(col, dim=0) for col in
                                  zip(*[sorted_leaves(t) for t in trees])])

    return {
        "theta": theta,
        "theta_mean": rebuild(theta, [particle_mean(th, cloud)
                                      for th in sorted_leaves(theta)]),
        "theta_trajectory": stack(means) if means else None,
        "log_likelihoods": (torch.stack(log_liks, dim=0) if log_liks
                            else None),
    }
