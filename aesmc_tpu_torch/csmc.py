"""PMCMC: conditional SMC, particle Gibbs and PMMH.

Counterpart of `aesmc_tpu.csmc`. Conditional SMC (Andrieu, Doucet,
Holenstein, JRSS-B 2010) keeps a reference trajectory alive: particle slot
0 holds the reference at every time step (its ancestor is slot 0), while
the other K - 1 particles are proposed and resampled as usual. The
particle Gibbs kernel, a sweep and then a new reference drawn from the
surviving lineages, leaves the joint smoothing posterior p(x_{0:T-1} |
y_{0:T-1}) invariant for any K >= 2. With ancestor sampling (PGAS;
Lindsten, Jordan, Schon, JMLR 2014) the reference's ancestor is redrawn
each step from w_{t-1}^i p(x_t^ref | x_{t-1}^i), which breaks the path
degeneracy of plain particle Gibbs at long T. `pmmh` is the particle
marginal Metropolis-Hastings chain over model parameters.

The free particles' ancestors are K - 1 iid categorical draws, taken by
inverse CDF at K - 1 sorted positions made from K exponentials (torch
ops: the JAX package's search here is XLA's `searchsorted`, no kernel).
Every draw goes through the `NoiseSource`: the ancestors' exponentials,
the proposal's normals, ancestor sampling's and the trajectory pick's
Gumbels, PMMH's random-walk normals and its accept uniform. Chains are
Python loops over a sweep that reads nothing from the device, so one
sweep (`particle_gibbs_step`) can be captured in a CUDA graph; the
reference is written into slot 0 by a concatenation.
"""

from __future__ import annotations

import math as _stdmath
from typing import Optional

import torch

from . import inference as _inference
from . import resampling, state
from .noise import NoiseSource
from .ops import resample_cuda

__all__ = ["csmc_infer", "sample_trajectory", "particle_gibbs_step",
           "particle_gibbs", "pmmh"]


def _conditional_ancestors(log_weight, noise):
    """Slot 0 -> 0 (the reference keeps its own lineage); slots 1..K-1 ->
    K - 1 iid Categorical(softmax(log_weight)) draws, at the sorted
    positions S_j / S_K of K exponentials (an exchangeable presentation of
    K - 1 iid draws, so the kernel's law is unchanged). `[B, K]` int32,
    detached."""
    log_weight = log_weight.detach()
    batch_size, k = log_weight.shape
    s = resampling._row_cumsum(noise.exponential((batch_size, k)))
    pos = torch.clamp(s[:, :-1] / s[:, -1:], max=resample_cuda.BELOW_ONE)
    idx = resampling.inverse_cdf_indices(log_weight, pos)
    return torch.cat([torch.zeros_like(idx[:, :1]), idx], dim=1)


def _pin_reference(latent, ref_t):
    """``latent`` `[B, K, ...]` (or a dict of them) with slot 0 replaced by
    the reference ``ref_t`` `[B, ...]`: a new tensor, by concatenation."""
    if isinstance(latent, dict):
        return {k: _pin_reference(v, ref_t[k]) for k, v in latent.items()}
    return torch.cat([ref_t.unsqueeze(1).to(latent.dtype), latent[:, 1:]],
                     dim=1)


def _categorical(logits, noise):
    """One categorical draw a row of `[B, K]` logits, as
    `jax.random.categorical(key, logits, axis=-1)` draws it: the argmax of
    logits plus `[B, K]` Gumbel noise. `[B]` int32."""
    gumbel = noise.gumbel(tuple(logits.shape))
    return torch.argmax(logits.detach() + gumbel, dim=-1).to(torch.int32)


def csmc_infer(observations, initial, transition, emission, proposal,
               num_particles: int, reference,
               noise: Optional[NoiseSource] = None,
               ancestor_sampling: bool = False,
               return_log_marginal_likelihood: bool = True):
    """One conditional-SMC sweep with ``reference`` pinned to slot 0.

    Args:
        observations: list of `[B, ...]` values or a stacked `[T, B, ...]`
            value.
        initial, transition, emission, proposal: the components of
            `inference.infer`.
        num_particles: K >= 2.
        reference: stacked `[T, B, ...]` latent (a tensor or a dict of
            them): the conditioned trajectory.
        noise: the source of every draw; default `NoiseSource.seeded(0)`
            on the observations' device. A step draws the ancestors'
            `[B, K]` exponentials, then (with ``ancestor_sampling``) a
            `[B, K]` Gumbel, then the proposal's noise.
        ancestor_sampling: redraw the reference's ancestor each step from
            w_{t-1}^i p(x_t^ref | x_{t-1}^i) (PGAS).
        return_log_marginal_likelihood: include the (conditional) log-Z.

    Returns:
        dict with original_latents `[T, B, K, ...]` (slot 0 is the
        reference at every t), ancestral_indices `[T-1, B, K]`,
        log_weight `[B, K]` (final), log_marginal_likelihood `[B]` or None.
    """
    if num_particles < 2:
        raise ValueError(
            f"conditional SMC needs num_particles >= 2. "
            f"currently = {num_particles}")
    stacked_obs = _inference.stack_observations(observations)
    obs_seq = _inference.ObservationSequence(stacked_obs)
    num_timesteps = len(obs_seq)
    first = _inference._first_leaf(stacked_obs)
    batch_size = first.shape[1]
    if noise is None:
        noise = NoiseSource.seeded(0, first.device)
    log_num_particles = _stdmath.log(num_particles)

    # ---- t = 0.
    proposal_dist = proposal(time=0, observations=obs_seq)
    latent_0 = state.sample(proposal_dist, batch_size, num_particles, noise)
    latent_0 = _pin_reference(latent_0,
                              state.tree_map(lambda x: x[0], reference))
    log_weight_0 = (
        state.log_prob(initial(), latent_0) +
        state.log_prob(emission(latents=[latent_0], time=0),
                       state.expand_observation(obs_seq[0],
                                                num_particles)) -
        state.log_prob(proposal_dist, latent_0))

    latents, ancestors, contributions = [latent_0], [], []
    prev_latent, prev_log_weight = latent_0, log_weight_0
    for t in range(1, num_timesteps):
        time = _inference.TimeIndex(t)
        prev_obs_list = [obs_seq[t - 1]]
        ref_t = state.tree_map(lambda x, t=t: x[t], reference)
        ancestral_index = _conditional_ancestors(prev_log_weight, noise)
        if ancestor_sampling:
            # PGAS: the reference's ancestor ~ w_{t-1}^i p(x_t^ref |
            # x_{t-1}^i) over all particles i.
            trans_all = transition(previous_latents=[prev_latent],
                                   time=time,
                                   previous_observations=prev_obs_list)
            ref_exp = state.expand_observation(ref_t, num_particles)
            ref_lp = state.log_prob(trans_all, ref_exp)      # [B, K]
            a0 = _categorical(prev_log_weight + ref_lp, noise)
            ancestral_index = torch.cat([a0[:, None],
                                         ancestral_index[:, 1:]], dim=1)
        previous_latent = state.resample(prev_latent, ancestral_index)
        proposal_dist = proposal(previous_latents=[previous_latent],
                                 time=time, observations=obs_seq)
        latent_t = state.sample(proposal_dist, batch_size, num_particles,
                                noise)
        latent_t = _pin_reference(latent_t, ref_t)
        log_weight_t = (
            state.log_prob(transition(
                previous_latents=[previous_latent], time=time,
                previous_observations=prev_obs_list), latent_t) +
            state.log_prob(emission(
                latents=[latent_t], time=time,
                previous_observations=prev_obs_list),
                state.expand_observation(obs_seq[t], num_particles)) -
            state.log_prob(proposal_dist, latent_t))
        contributions.append(torch.logsumexp(prev_log_weight, dim=1) -
                             log_num_particles)
        latents.append(latent_t)
        ancestors.append(ancestral_index)
        prev_latent, prev_log_weight = latent_t, log_weight_t

    lml = None
    if return_log_marginal_likelihood:
        summed = (_inference._sum_in_order(contributions) if contributions
                  else 0.0)
        lml = (summed + torch.logsumexp(prev_log_weight, dim=1) -
               log_num_particles)
    return {"original_latents": _inference._stack_time(latents),
            "ancestral_indices": (
                torch.stack(ancestors, dim=0) if ancestors else
                torch.zeros((0, batch_size, num_particles),
                            dtype=torch.int32, device=first.device)),
            "log_weight": prev_log_weight,
            "log_marginal_likelihood": lml}


def sample_trajectory(original_latents, ancestral_indices, log_weight,
                      noise):
    """Draws one surviving-lineage trajectory a batch row: j_T ~
    Categorical(softmax(log_weight)) (one `[B, K]` Gumbel draw from
    ``noise``), then the ancestry composed backward. Returns a `[T, B,
    ...]` latent (a tensor or a dict of them)."""
    j = _categorical(log_weight, noise)                     # [B]

    def pick(latent_t, idx):
        def one(x):
            index = idx.long().reshape((-1, 1) + (1,) * (x.ndim - 2))
            return torch.take_along_dim(x, index, dim=1)[:, 0]
        return state.tree_map(one, latent_t)

    num_timesteps = _inference._first_leaf(original_latents).shape[0]
    idx = j
    traj = [None] * num_timesteps
    for t in range(num_timesteps - 1, 0, -1):
        traj[t] = pick(state.tree_map(lambda x, t=t: x[t],
                                      original_latents), idx)
        idx = torch.take_along_dim(ancestral_indices[t - 1],
                                   idx.long()[:, None], dim=1)[:, 0]
    traj[0] = pick(state.tree_map(lambda x: x[0], original_latents), idx)
    return _inference._stack_time(traj)


def particle_gibbs_step(reference, observations, initial, transition,
                        emission, proposal, num_particles: int,
                        noise: NoiseSource, ancestor_sampling: bool = True):
    """One particle Gibbs transition: a conditional-SMC sweep conditioned
    on ``reference``, then a new reference drawn from the lineages. It
    leaves p(x_{0:T-1} | y_{0:T-1}) invariant for any K >= 2, and reads
    nothing from the device (it can be captured in a CUDA graph).

    Returns (new_reference `[T, B, ...]`, log_marginal_likelihood `[B]`).
    """
    out = csmc_infer(observations, initial, transition, emission,
                     proposal, num_particles, reference, noise=noise,
                     ancestor_sampling=ancestor_sampling)
    new_ref = sample_trajectory(out["original_latents"],
                                out["ancestral_indices"],
                                out["log_weight"], noise)
    return new_ref, out["log_marginal_likelihood"]


def particle_gibbs(observations, initial, transition, emission, proposal,
                   num_particles: int, num_iterations: int,
                   noise: Optional[NoiseSource] = None,
                   initial_reference=None,
                   ancestor_sampling: bool = True):
    """Runs a particle Gibbs chain of ``num_iterations`` sweeps.

    Args:
        noise: the source of every draw; default `NoiseSource.seeded(0)`
            on the observations' device.
        initial_reference: `[T, B, ...]` latent; by default a lineage
            drawn (`sample_trajectory`) from one bootstrap
            `infer('smc', ...)` run with the given components, whose
            resampling runs K1 on the card.
        ancestor_sampling: PGAS (recommended: plain particle Gibbs mixes
            poorly at long T).

    Returns:
        (trajectories `[num_iterations, T, B, ...]`, the chain's states
        after each sweep; log_marginal_likelihoods `[num_iterations, B]`).
    """
    stacked_obs = _inference.stack_observations(observations)
    if noise is None:
        noise = NoiseSource.seeded(
            0, _inference._first_leaf(stacked_obs).device)
    if initial_reference is None:
        first = _inference.infer(
            "smc", stacked_obs, initial, transition, emission, proposal,
            num_particles, noise=noise, return_latents=False,
            return_original_latents=True, return_ancestral_indices=True,
            return_log_weight=True, return_log_marginal_likelihood=False)
        initial_reference = sample_trajectory(
            first["original_latents"], first["ancestral_indices"],
            first["log_weight"], noise)
    ref = initial_reference
    trajectories, lmls = [], []
    for _ in range(num_iterations):
        ref, lml = particle_gibbs_step(
            ref, stacked_obs, initial, transition, emission, proposal,
            num_particles, noise, ancestor_sampling=ancestor_sampling)
        trajectories.append(ref)
        lmls.append(lml)
    return _inference._stack_time(trajectories), torch.stack(lmls, dim=0)


def _leaves(theta):
    """A dict's values in sorted key order (the JAX package's pytree
    order, which its per-parameter draws follow), or a list's items."""
    if isinstance(theta, dict):
        return [theta[k] for k in sorted(theta)]
    return list(theta)


def _rebuild(theta, leaves):
    if isinstance(theta, dict):
        return dict(zip(sorted(theta), leaves))
    return type(theta)(leaves)


def pmmh(observations, build_components, theta0, log_prior,
         num_particles: int, num_iterations: int,
         noise: Optional[NoiseSource] = None, step_size=0.1,
         algorithm: str = "smc", resampling_method: str = "systematic"):
    """Particle marginal Metropolis-Hastings (Andrieu et al. 2010) over the
    model's parameters: a random-walk MH chain on theta whose acceptance
    ratio uses the SMC (or IS) log-marginal-likelihood estimate, which
    targets the exact parameter posterior because the estimator of Z is
    unbiased.

    Args:
        observations: list of `[B, ...]` values or a stacked value
            (independent sequences; their log-MLs add).
        build_components: theta -> (initial, transition, emission,
            proposal).
        theta0: the initial parameters, a dict or a list of float
            tensors.
        log_prior: theta -> scalar log prior density.
        num_particles: K of each sweep.
        num_iterations: MH iterations.
        noise: the source of every draw; default `NoiseSource.seeded(0)`
            on the observations' device. The first sweep's draws come
            first; then each iteration draws one standard-normal tensor a
            parameter (the random walk), its sweep's draws, and one
            uniform (the accept test).
        step_size: the random walk's scale, a number or a dict/list
            matching theta.
        algorithm: 'smc' (AESMC-style estimate) or 'is' (IWAE-style).
        resampling_method: the sweep's resampling method.

    Returns:
        (thetas, theta's structure with a leading `[num_iterations]` axis
        (the chain after each step); log posteriors `[num_iterations]`;
        the acceptance rate, a scalar tensor).
    """
    stacked_obs = _inference.stack_observations(observations)
    device = _inference._first_leaf(stacked_obs).device
    if noise is None:
        noise = NoiseSource.seeded(0, device)
    theta = _rebuild(theta0, [torch.as_tensor(x, dtype=torch.float32,
                                              device=device)
                              for x in _leaves(theta0)])
    steps = (_leaves(step_size) if isinstance(step_size, (dict, list,
                                                          tuple))
             else [step_size] * len(_leaves(theta)))

    def log_ml(params):
        comps = build_components(params)
        out = _inference.infer(
            algorithm, stacked_obs, *comps, num_particles, noise=noise,
            resampling_method=resampling_method,
            return_log_marginal_likelihood=True, return_latents=False,
            return_log_weight=False)
        return torch.sum(out["log_marginal_likelihood"])

    with torch.no_grad():
        lp = log_ml(theta) + log_prior(theta)
        thetas, lps, accepts = [], [], []
        for _ in range(num_iterations):
            leaves = _leaves(theta)
            prop_leaves = [leaf + s * noise.normal(tuple(leaf.shape))
                           for leaf, s in zip(leaves, steps)]
            theta_prop = _rebuild(theta, prop_leaves)
            lp_prop = log_ml(theta_prop) + log_prior(theta_prop)
            log_u = torch.log(noise.uniform(()))
            accept = log_u < (lp_prop - lp)
            theta = _rebuild(theta, [torch.where(accept, p, x) for p, x in
                                     zip(prop_leaves, leaves)])
            lp = torch.where(accept, lp_prop, lp)
            thetas.append(theta)
            lps.append(lp)
            accepts.append(accept.to(torch.float32))
    stacked = _rebuild(theta0, [torch.stack(list(column), dim=0) for column
                                in zip(*[_leaves(t) for t in thetas])])
    return stacked, torch.stack(lps), torch.stack(accepts).mean()
