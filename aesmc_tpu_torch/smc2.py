"""SMC^2: sequential inference over model parameters.

Counterpart of `aesmc_tpu.smc2` (Chopin, Jacob & Papaspiliopoulos, JRSS-B
2013): M theta-particles each carry an inner K-particle state filter; at
every observation the inner filters advance one step and each theta's
weight takes its inner filter's incremental evidence estimate, so the
theta cloud tracks p(theta | y_{0:t}) online. When the theta ESS falls
below ``ess_threshold`` M the cloud is resampled and rejuvenated by PMMH
moves, each of which reruns fresh inner filters up to the current time.

Layout: the M inner filters run as the rows of one `[M B, K]` batch (theta
m on rows m B ... m B + B - 1), the JAX package's own resampling layout.
An inner step resamples all of them with one call of the shared resampler
(on the card one K1 launch carrying the latent as its column, ancestors
not kept); the theta cloud's `[1, M]` resampling takes the 'torch' route,
as the JAX package's takes XLA's.

API difference: the JAX package vmaps ``build_components`` over theta. The
components here draw noise and launch kernels, which a vmap cannot hold,
so ``build_components`` is called once a step with theta leaves repeated
to `[M B, 1]` (`[M B, 1, ...]` for a leaf with trailing axes), which the
components broadcast against the `[M B, K]` latents (the LGSSM components
keep a tensor argument as given: ``lgssm.Transition(mult=theta["mult"],
scale=1.0)``). The observations reach them tiled to `[T, M B, ...]`.
``log_prior`` keeps the one-theta contract and runs under
`torch.func.vmap` over the cloud (a pure tensor function).

Host reads: one a step, the test of the theta ESS against the threshold
(the JAX package's `lax.cond`). A rejuvenation's reruns advance only up
to the current time t; the JAX package computes the later steps too, for
static shapes, and discards them, so the result is the same.

Draws, in order: the inner filters' t = 0 proposal draw (one `[M B, ...]`
draw: theta m's rows are the JAX package's draw from
`split(k0, M)[m]`); then per step t >= 1 the inner resampling noise (`[M
B, 1]` uniforms for systematic) and the proposal draw, and, when the cloud
rejuvenates, the theta resampling noise (`[1, 1]` uniforms for
systematic), then per move one `[M, ...]` normal a theta leaf (dicts in
sorted key order), the rerun's draws (its t = 0 proposal draw, then its
steps 1 ... t as above) and `[M]` accept uniforms.

Several ranks (``mesh``): theta is sharded over ``theta_axis`` and the
inner particles over ``particle_axis``. A rank holds M / n thetas, their
`[M_l B, K_l]` inner rows (consecutive rows of the single-device layout)
and draws its block of every draw. The inner filters resample through
the distributed exchange (`parallel.dist_resampling`); the evidence
logsumexp over M, the theta ESS (the host read, the same on every rank)
and the theta resampling (the index-only exchange over the theta group;
the chosen thetas and their inner rows come from their owners) cross the
theta group, and the PMMH reruns stay on the rank's own thetas.
"""

from __future__ import annotations

import math as _stdmath
from typing import Optional

import numpy as np
import torch

from . import device as _device
from . import resampling, state
from .inference import (ObservationSequence, TimeIndex, _first_leaf,
                        _resolve_implementation, stack_observations)
from .noise import NoiseSource
from .sharding_utils import (cloud_of, particle_ess, particle_gather,
                             particle_logsumexp, particle_mean)
from .utils.pytree import rebuild, sorted_leaves

__all__ = ["smc2"]


def smc2(observations, build_components, theta0, log_prior,
         num_particles: int, noise: Optional[NoiseSource] = None,
         ess_threshold: float = 0.5, num_moves: int = 2,
         step_size=0.15,
         resampling_method: str = "systematic",
         resampling_implementation="auto",
         return_history: bool = False,
         mesh=None, theta_axis: str = "data",
         particle_axis: str = "particle"):
    """Online parameter and state inference by nested SMC.

    Args:
        observations: list of `[B, ...]` values or a stacked `[T, B, ...]`
            tensor. Batch rows are independent sequences sharing theta
            (their evidence terms add).
        build_components: `theta -> (initial, transition, emission,
            proposal)`, called with theta leaves of `[M B, 1]` rows (see
            the module docstring).
        theta0: a dict of `[M, ...]` tensors (or numpy arrays, which go
            to the observations' device): the initial theta cloud, iid
            prior draws, M >= 2.
        log_prior: `theta -> scalar` log prior density of ONE theta.
        num_particles: K, the inner filters' particle count.
        noise: the source of every draw (order in the module docstring);
            default `NoiseSource.seeded(0)` on the observations' device.
        ess_threshold: rejuvenate when the theta ESS < threshold M (0:
            never, importance sampling from the prior cloud).
        num_moves: PMMH random-walk moves per rejuvenation, each a rerun
            of all M inner filters up to the current time.
        step_size: the random walk's scale: a number, or a dict matching
            one theta.
        resampling_method / resampling_implementation: the inner filters'
            resampling ('auto': the kernels for CUDA tensors, or a
            callable; on a mesh a distributed one over ``theta_axis`` and
            ``particle_axis``); the theta cloud's resampling uses the same
            method on the 'torch' route (on a mesh, the distributed
            index-only exchange over the theta group).
        return_history: also return the per-step theta cloud and weights.
        mesh, theta_axis, particle_axis: a `DeviceMesh` and the names of
            its theta and inner-particle axes (module docstring): theta0
            and the observations are global, ``num_particles`` the whole
            K; theta, log_theta_weight, inner_log_marginal_likelihood and
            theta_history are this rank's thetas, the rest global.

    Returns:
        dict: theta (`[M, ...]` leaves), log_theta_weight `[M]`,
        log_evidence (0-d, summed over batch sequences),
        inner_log_marginal_likelihood `[M, B]`, acceptance_rate (0-d, 0
        without a move), num_rejuvenations (0-d int32), ess_path `[T]`,
        and with `return_history` theta_history (`[T, M, ...]` leaves)
        and log_theta_weight_history `[T, M]`.
    """
    stacked_obs = stack_observations(observations)
    first = _first_leaf(stacked_obs)
    device = first.device

    def as_tensor(x):
        if isinstance(x, torch.Tensor):
            return x
        return torch.as_tensor(np.asarray(x, dtype=np.float32),
                               device=_device.resolve(device))

    theta0 = rebuild(theta0, [as_tensor(x) for x in sorted_leaves(theta0)])
    num_theta = int(sorted_leaves(theta0)[0].shape[0])
    if num_theta < 2:
        raise ValueError(
            f"smc2 needs num_theta >= 2 prior draws in theta0. "
            f"currently = {num_theta}")
    if not 0.0 <= float(ess_threshold) <= 1.0:
        raise ValueError(
            f"ess_threshold must be in [0, 1]. "
            f"currently = {ess_threshold}")
    num_timesteps, batch_size = first.shape[0], first.shape[1]
    if noise is None:
        noise = NoiseSource.seeded(0, device)
    cloud = cloud_of(mesh, resampling_implementation, theta_axis,
                     particle_axis)
    m_total, log_k = num_theta, _stdmath.log(num_particles)
    theta_draws = noise
    if cloud is None:
        m, k = num_theta, num_particles
        implementation = resampling.resolve_implementation(
            device, resampling_method, resampling_implementation)
    else:
        m, k = num_theta // cloud.n_data, cloud.local_particles(
            num_particles)
        if num_theta % cloud.n_data:
            raise ValueError(f"num_theta={num_theta} does not split over "
                             f"{cloud.n_data} theta shards")
        mine = cloud.rows(num_theta)
        theta0 = rebuild(theta0, [x[mine] for x in sorted_leaves(theta0)])
        implementation = _resolve_implementation(
            device, resampling_method, resampling_implementation, cloud)
        noise = cloud.noise(noise)
        theta_draws = noise.along(0, None)
    # The theta cloud `[M_l]` lies along the theta (data) axis: its
    # reductions and gathers cross the data group.
    thetas = None if cloud is None else cloud.over_data()
    theta_split = thetas is not None and thetas.n_particle > 1
    rows = m * batch_size
    obs_seq = ObservationSequence(state.tree_map(
        lambda x: x.repeat((1, m) + (1,) * (x.ndim - 2)), stacked_obs))

    def all_thetas(x):
        """Every theta shard's ``x`` `[M_l, ...]`, in order."""
        return particle_gather(x, thetas, dim=0)

    num_leaves = len(sorted_leaves(theta0))
    steps = ([step_size] * num_leaves if isinstance(step_size, (int, float))
             else sorted_leaves(step_size))
    v_log_prior = torch.func.vmap(log_prior)

    def theta_rows(theta):
        """`[M, ...]` leaves -> `[M B, 1, ...]`: theta m on its B rows."""
        return rebuild(theta, [
            x.repeat_interleave(batch_size, dim=0).unsqueeze(1)
            for x in sorted_leaves(theta)])

    def by_theta(x):
        return x.reshape((m, batch_size) + tuple(x.shape[1:]))

    def by_row(x):
        return x.reshape((rows,) + tuple(x.shape[2:]))

    def inner_init(theta):
        """t = 0 of all M inner filters: (latent, log-weight) `[M B, K]`."""
        initial, _, emission, proposal = build_components(theta_rows(theta))
        proposal_dist = proposal(time=0, observations=obs_seq)
        latent = state.sample(proposal_dist, rows, k, noise)
        log_weight = (
            state.log_prob(initial(), latent) +
            state.log_prob(emission(latents=[latent], time=0),
                           state.expand_observation(obs_seq[0], k)) -
            state.log_prob(proposal_dist, latent))
        return latent, log_weight

    def increments(log_weight):
        return by_theta(particle_logsumexp(log_weight, cloud) - log_k)

    def advance(theta, latent, log_weight, t):
        """One inner step of all M filters: the new (latent, log-weight)
        and the per-theta increments `[M, B]`."""
        if callable(implementation):
            _, previous = resampling.callable_resample(
                implementation, log_weight.detach(), noise, latent,
                particle_logsumexp(log_weight, cloud).detach())
        else:
            _, previous = resampling._resample(
                log_weight, noise, latent, resampling_method,
                implementation, need_indices=False)
        _, transition, emission, proposal = build_components(
            theta_rows(theta))
        time = TimeIndex(t)
        prev_obs_list = [obs_seq[t - 1]]
        proposal_dist = proposal(previous_latents=[previous], time=time,
                                 observations=obs_seq)
        new_latent = state.sample(proposal_dist, rows, k, noise)
        new_log_weight = (
            state.log_prob(transition(previous_latents=[previous],
                                      time=time,
                                      previous_observations=prev_obs_list),
                           new_latent) +
            state.log_prob(emission(latents=[new_latent], time=time,
                                    previous_observations=prev_obs_list),
                           state.expand_observation(obs_seq[t], k)) -
            state.log_prob(proposal_dist, new_latent))
        return new_latent, new_log_weight, increments(new_log_weight)

    def rerun(theta, t_now):
        """Fresh inner filters for a theta cloud, advanced up to and
        including time ``t_now``: (latent, log-weight, cum `[M, B]`)."""
        latent, log_weight = inner_init(theta)
        cum = increments(log_weight)
        for t in range(1, t_now + 1):
            latent, log_weight, inc = advance(theta, latent, log_weight, t)
            cum = cum + inc
        return latent, log_weight, cum

    def select(acc, a, b):
        """Per theta: ``a`` where ``acc`` `[M]`, else ``b`` (either `[M,
        ...]` or in `[M B, ...]` rows)."""
        pred = (acc.repeat_interleave(batch_size) if a.shape[0] == rows
                else acc)
        return torch.where(pred.reshape((-1,) + (1,) * (a.ndim - 1)), a, b)

    def rejuvenate(theta, latent, log_weight, cum, log_theta_w, t_now):
        """The theta resampling and num_moves PMMH moves at time t_now;
        the theta weights reset to uniform."""
        if theta_split:
            from .parallel import dist_resampling
            anc = dist_resampling.distributed_resampling_indices(
                log_theta_w[None, :], noise, cloud.data_group,
                method=resampling_method)[0]
        else:
            # The whole theta cloud on every rank: its `[1, M]` draw is
            # the same on every rank of the particle group.
            anc = resampling.sample_indices(
                log_theta_w[None, :], theta_draws, resampling_method,
                "torch")[0]
        anc = anc.long()
        theta = rebuild(theta, [torch.index_select(all_thetas(x), 0, anc)
                                for x in sorted_leaves(theta)])
        latent = state.tree_map(
            lambda x: by_row(all_thetas(by_theta(x))[anc]), latent)
        log_weight = by_row(all_thetas(by_theta(log_weight))[anc])
        cum = all_thetas(cum)[anc]
        accepted = torch.zeros((), dtype=torch.float32, device=device)
        for _ in range(num_moves):
            leaves = sorted_leaves(theta)
            theta_prop = rebuild(theta, [
                x + s * theta_draws.normal(tuple(x.shape))
                for x, s in zip(leaves, steps)])
            lat_p, logw_p, cum_p = rerun(theta_prop, t_now)
            log_ratio = (v_log_prior(theta_prop) + torch.sum(cum_p, dim=1) -
                         v_log_prior(theta) - torch.sum(cum, dim=1))
            u = theta_draws.uniform((m,))
            acc = torch.log(u) < log_ratio
            theta = rebuild(theta, [select(acc, a, b) for a, b in
                                    zip(sorted_leaves(theta_prop), leaves)])
            latent = resampling._unflatten(latent, iter([
                select(acc, a, b) for a, b in zip(resampling._leaves(lat_p),
                                                  resampling._leaves(latent))
            ]))
            log_weight = select(acc, logw_p, log_weight)
            cum = select(acc, cum_p, cum)
            accepted = accepted + particle_mean(acc.to(torch.float32),
                                                thetas, dim=0)
        return (theta, latent, log_weight, cum,
                torch.zeros_like(log_theta_w), accepted)

    # ---- t = 0.
    theta = theta0
    latent, log_weight = inner_init(theta)
    cum = increments(log_weight)
    log_theta_w = torch.sum(cum, dim=1)                        # [M]
    log_evidence = (particle_logsumexp(log_theta_w, thetas, 0) -
                    _stdmath.log(m_total))
    ess_path = [particle_ess(log_theta_w, thetas, dim=0)]
    theta_hist, w_hist = [theta], [log_theta_w]
    accepted = torch.zeros((), dtype=torch.float32, device=device)
    num_rejuvenations = 0

    for t in range(1, num_timesteps):
        latent, log_weight, inc = advance(theta, latent, log_weight, t)
        cum = cum + inc
        new_w = log_theta_w + torch.sum(inc, dim=1)
        log_evidence = log_evidence + (
            particle_logsumexp(new_w, thetas, 0) -
            particle_logsumexp(log_theta_w, thetas, 0))
        log_theta_w = new_w
        ess = particle_ess(log_theta_w, thetas, dim=0)
        ess_path.append(ess)
        # The one host read a step: rejuvenate or not (the same value on
        # every rank of a mesh).
        if bool(ess < ess_threshold * m_total):
            theta, latent, log_weight, cum, log_theta_w, acc = rejuvenate(
                theta, latent, log_weight, cum, log_theta_w, t)
            accepted = accepted + acc
            num_rejuvenations += 1
        if return_history:
            theta_hist.append(theta)
            w_hist.append(log_theta_w)

    total_moves = num_rejuvenations * num_moves
    out = {
        "theta": theta,
        "log_theta_weight": log_theta_w,
        "log_evidence": log_evidence,
        "inner_log_marginal_likelihood": cum,
        "acceptance_rate": (accepted / total_moves if total_moves
                            else torch.zeros((), device=device)),
        "num_rejuvenations": torch.full((), num_rejuvenations,
                                        dtype=torch.int32, device=device),
        "ess_path": torch.stack(ess_path),
    }
    if return_history:
        out["theta_history"] = rebuild(theta, [
            torch.stack(col, dim=0) for col in
            zip(*[sorted_leaves(th) for th in theta_hist])])
        out["log_theta_weight_history"] = torch.stack(w_hist)
    return out
