"""Tensor Monte Carlo: marginalize over all K^T particle paths.

Counterpart of `aesmc_tpu.tmc` (Aitchison, "Tensor Monte Carlo: particle
methods for the GPU era", arXiv:1806.08593). The particles are sampled as
importance sampling samples them (no resampling), and the estimator

    Z = K^{-T} sum_{k_0..k_{T-1}} prod_t
        p(x_t^{k_t} | x_{t-1}^{k_{t-1}}) p(y_t | x_t^{k_t})
        / q(x_t^{k_t} | x_{t-1}^{k_t})

is computed in O(T K^2) by the forward recursion

    f_0[j] = log p(x_0^j) + log p(y_0 | x_0^j) - log q(x_0^j)
    f_t[j] = LSE_i(f_{t-1}[i] + log p(x_t^j | x_{t-1}^i)) - log K
             + log p(y_t | x_t^j) - log q(x_t^j | x_{t-1}^j)
    log Z  = LSE_j(f_{T-1}[j]) - log K

whose inner step is a stabilized exp-matmul, a batched [1, K] x [K, K]
product (`resampling._exact_matmul`: full float32 precision whatever
`torch.set_float32_matmul_precision` says). No resampling and no
discrete index: the estimator is a smooth function of every input, and
reaches none of the port's resampling kernels.

The pairwise [B, K, K] transition tile is formed one of two ways
(`pairwise=`):
- 'broadcast': the transition is called once with parents shaped
  [B, K, 1, ...] and its log_prob evaluated at [B, 1, K, ...] children;
  no extra work for transitions that are arithmetic in the latent;
- 'vmap': the transition is mapped over the parent axis with
  `torch.func.vmap`, each parent a standard [B, 1, ...] latent, so that
  neural transitions work unchanged;
- 'auto' (default): 'broadcast' if the transition accepts the expanded
  shapes, else 'vmap'. The probe runs once, before the time loop, on fake
  tensors (`FakeTensorMode`, the counterpart of `jax.eval_shape`): it
  computes nothing on any device.

On a mesh (`cloud=`, as `losses.get_loss(mesh=...)` passes it) a rank
draws its block of the particles, all-gathers the parents and their f
over the particle group a step, and forms its `[B_l, K, K_l]` tile
columns; the final logsumexp crosses the group.

Memory: one [B, K, K] tile a step; `remat` recomputes each step in the
backward (`torch.utils.checkpoint`) instead of keeping T tiles, and
`block_size` streams the children in checkpointed blocks, so that a step
holds O(K * block_size).
"""

from __future__ import annotations

import math as _stdmath

import torch
from torch.utils import checkpoint as _checkpoint

from . import resampling, state
from .inference import (ObservationSequence, TimeIndex, _NoiseTape,
                        _first_leaf, stack_observations)
from .noise import NoiseSource
from .sharding_utils import particle_gather, particle_logsumexp

__all__ = ["tmc_log_marginal_likelihood", "tmc_loss"]

PAIRWISE_MODES = ("auto", "broadcast", "vmap")


def _expand_prev(latent):
    """[B, K, ...] -> [B, K, 1, ...]: the 'i' (parent) axis."""
    return state.tree_map(lambda x: x[:, :, None], latent)


def _expand_new(latent):
    """[B, K, ...] -> [B, 1, K, ...]: the 'j' (child) axis."""
    return state.tree_map(lambda x: x[:, None, :], latent)


def _pairwise_log_prob(distribution, value):
    """log_prob summed over event dims, reduced to [B, K_i, K_j].

    ``distribution`` was built from [B, K, 1, ...] parents and ``value``
    is [B, 1, K, ...]: the densities broadcast to [B, K_i, K_j, ...];
    trailing dims are summed."""
    if isinstance(distribution, dict):
        total = None
        for k, v in distribution.items():
            lp = _pairwise_log_prob(v, value[k])
            total = lp if total is None else total + lp
        return total
    lp = distribution.log_prob(value)
    if lp.ndim > 3:
        lp = lp.reshape(tuple(lp.shape[:3]) + (-1,)).sum(dim=-1)
    return lp


def _check_pairwise(pairwise):
    if pairwise not in PAIRWISE_MODES:
        raise ValueError(
            f"pairwise must be 'auto', 'broadcast' or 'vmap'. "
            f"currently = {pairwise}")


def _resolve_pairwise_mode(transition, latent, obs_prev, time_value=1):
    """'broadcast' if the transition accepts [B, K, 1, ...] parents and
    gives a [B, K, 1] tile, else 'vmap'. Runs the transition on fake
    tensors: no work on any device."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    batch_size, k = _first_leaf(latent).shape[:2]
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            dist = transition(
                previous_latents=[_expand_prev(latent)],
                time=TimeIndex(time_value), previous_observations=[obs_prev])
            lp = _pairwise_log_prob(dist, _expand_new(
                state.tree_map(lambda v: v[:, :1], latent)))
            shape = tuple(lp.shape)
    except Exception:  # any refusal of the expanded shapes
        return "vmap"
    return "broadcast" if shape == (batch_size, k, 1) else "vmap"


def _pair_log_prob_fn(transition, prev_latent, time, prev_obs_list,
                      resolved_pairwise):
    """``fn(children)`` -> [B, K, C]: log p(child_j | parent_i) of the
    [B, C, ...] ``children`` under each [B, K, ...] parent."""
    if resolved_pairwise == "broadcast":
        pair_dist = transition(previous_latents=[_expand_prev(prev_latent)],
                               time=time,
                               previous_observations=prev_obs_list)
        return lambda children: _pairwise_log_prob(pair_dist,
                                                   _expand_new(children))

    def tile(children):
        def per_parent(parent):                  # [B, ...]
            parent1 = state.tree_map(lambda x: x[:, None], parent)
            dist = transition(previous_latents=[parent1], time=time,
                              previous_observations=prev_obs_list)
            return state.log_prob(dist, children)             # [B, C]

        return torch.func.vmap(per_parent, in_dims=1,
                               out_dims=1)(prev_latent)

    return tile


def tmc_log_marginal_likelihood(observations, initial, transition,
                                emission, proposal, num_particles: int,
                                noise=None, remat: bool = True,
                                block_size=None, pairwise: str = "auto",
                                cloud=None):
    """TMC estimate of log p(y_{0:T-1}), shape [batch].

    Differentiable in every component (reparameterized proposal samples,
    no resampling). ``noise`` is the `NoiseSource` of the proposal draws
    (default `NoiseSource.seeded(0)` on the observations' device): the
    same draws as `inference.infer('is', ...)` takes from it. ``remat``
    (default) recomputes each step's [B, K, K] tile in the backward.
    ``block_size`` (must divide K) streams the children in checkpointed
    blocks of that size. ``pairwise``: 'broadcast' | 'vmap' | 'auto' (see
    the module docstring).

    ``cloud``: this rank's `sharding_utils.Cloud` on a mesh, or None.
    ``observations`` are then this rank's rows and ``num_particles`` the
    whole cloud's K: the rank draws its K_l particles of its rows (its
    block of the single-device draws), each step all-gathers the previous
    particles and f over the particle group (differentiable: the
    backward sums the ranks' cotangents) and forms its `[B_l, K, K_l]`
    tile columns, which give its K_l new f; the final logsumexp crosses
    the group. ``block_size`` then divides K_l. Returns this rank's rows
    `[B_l]`, the same on every particle rank.
    """
    _check_pairwise(pairwise)
    stacked_obs = stack_observations(observations)
    obs_seq = ObservationSequence(stacked_obs)
    num_timesteps = len(obs_seq)
    first = _first_leaf(stacked_obs)
    batch_size = first.shape[1]
    if noise is None:
        noise = NoiseSource.seeded(0, first.device)
    log_k = _stdmath.log(num_particles)
    # This rank's particles (all of them on one device), its view of the
    # draws, and the whole cloud's particles and f.
    k = (num_particles if cloud is None else
         cloud.local_particles(num_particles))

    def view(source):
        return source if cloud is None else cloud.noise(source)

    def whole(x):
        return state.tree_map(lambda v: particle_gather(v, cloud), x)

    blocked = block_size is not None and block_size < k
    if blocked and k % block_size:
        raise ValueError(
            f"block_size ({block_size}) must divide num_particles ({k})"
            + ("" if cloud is None else " / the particle shards"))

    # ---- t = 0 (hoisted: `time` is the int 0).
    proposal_dist = proposal(time=0, observations=obs_seq)
    latent_0 = state.sample(proposal_dist, batch_size, k, view(noise))
    f0 = (state.log_prob(initial(), latent_0) +
          state.log_prob(emission(latents=[latent_0], time=0),
                         state.expand_observation(obs_seq[0], k)) -
          state.log_prob(proposal_dist, latent_0))           # [B, K]
    if num_timesteps == 1:
        return particle_logsumexp(f0, cloud) - log_k

    resolved = pairwise
    if resolved == "auto":
        resolved = _resolve_pairwise_mode(transition, latent_0, obs_seq[0])

    def step(t, prev_latent, f, noise):
        time = TimeIndex(t)
        prev_obs_list = [obs_seq[t - 1]]
        proposal_dist = proposal(previous_latents=[prev_latent], time=time,
                                 observations=obs_seq)
        latent_t = state.sample(proposal_dist, batch_size, k, view(noise))
        q_lp = state.log_prob(proposal_dist, latent_t)        # [B, K]
        e_lp = state.log_prob(
            emission(latents=[latent_t], time=time,
                     previous_observations=prev_obs_list),
            state.expand_observation(obs_seq[t], k))          # [B, K]
        # Every parent of the whole cloud against this rank's children.
        pair_log_prob = _pair_log_prob_fn(transition, whole(prev_latent),
                                          time, prev_obs_list, resolved)
        f = particle_gather(f, cloud)

        # f_j = LSE_i(f_i + A_ij) - log K + e_j - q_j, stabilized per
        # batch row (c) and per child column (amax).
        c = f.max(dim=1, keepdim=True).values                 # [B, 1]
        g = torch.exp(f - c).unsqueeze(1)                     # [B, 1, K]

        def pair_lse(children):
            """c + LSE_i(f_i + A_i,blk) for a [B, blk, ...] child block."""
            a = pair_log_prob(children)                       # [B, K, blk]
            amax = a.max(dim=1, keepdim=True).values          # [B, 1, blk]
            m = torch.exp(a - amax)
            s = resampling._exact_matmul(g, m).squeeze(1)     # [B, blk]
            # f and A are stabilized by separate maxes; if they disagree
            # by more than ~100 nats for every parent of a child, s
            # flushes to 0 though the true LSE is finite. The floor makes
            # that child's f saturate with a zero, not NaN, gradient.
            s = torch.clamp(s, min=torch.finfo(s.dtype).tiny)
            return c + amax[:, 0, :] + torch.log(s)

        if not blocked:
            f_pair = pair_lse(latent_t)
        else:
            f_pair = torch.cat([
                _checkpoint.checkpoint(
                    pair_lse, state.tree_map(
                        lambda x, i=i: x[:, i:i + block_size], latent_t),
                    use_reentrant=False)
                for i in range(0, k, block_size)], dim=1)
        return latent_t, f_pair - log_k + e_lp - q_lp

    def remat_step(t, prev_latent, f, tape):
        tape.rewind()
        return step(t, prev_latent, f, tape)

    latent, f = latent_0, f0
    for t in range(1, num_timesteps):
        if remat:
            latent, f = _checkpoint.checkpoint(
                remat_step, t, latent, f, _NoiseTape(noise),
                use_reentrant=False, preserve_rng_state=False)
        else:
            latent, f = step(t, latent, f, noise)
    return particle_logsumexp(f, cloud) - log_k


def tmc_loss(observations, num_particles: int, initial, transition,
             emission, proposal, noise=None, **kwargs):
    """``-mean(TMC log-Z estimate)``: the TMC training objective."""
    return -tmc_log_marginal_likelihood(
        observations, initial, transition, emission, proposal,
        num_particles, noise=noise, **kwargs).mean()
