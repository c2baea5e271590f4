"""Localized (block) particle filter for high-dimensional models.

Counterpart of `aesmc_tpu.blockpf` (Rebeschini & van Handel 2015): the
state dimensions are partitioned into J blocks, and each block is
resampled on its own with weights built from the observations local to
it, which trades the plain filter's exponential weight collapse in the
dimension for an O(1) bias at the block boundaries.

Scope, as in the JAX package: bootstrap filtering (proposal = transition).
The emission must factorize over blocks; for the diagonal-Gaussian
emissions (`MultivariateNormalDiag`: `models.lorenz`, `models.lgssm_nd`)
the per-block weights are derived from ``obs_indices``; anything else
passes ``local_log_weight``.

Resampling is one call of the shared resampler on the `[J B, K]` weights
a step (the block axis folded into the rows; on the card one K1 launch,
indices only), and reassembly is J row gathers (`take_along_dim` on each
block's `[B, K, |b|]` slice) plus one static permutation, never a
per-element `[B, K, D]` gather. Draws, in order: the t = 0 sample's
normals, then at each step t >= 1 the resampling noise of the J blocks as
one `[J B, ...]` draw in block order (`[J B, 1]` uniforms for systematic:
block j's rows are the JAX package's ``fold_in(key_t, j)`` draw, or
``key_t``'s own when J = 1), then the transition's normals.

With one block covering every dimension the filter is the bootstrap
`inference.infer` bit for bit: the same draws, ancestors, latents and
log-Z. For that, one block's weight is written as the engine writes its
bootstrap weight, (prior or transition log-density + emission) - the same
log-density as the proposal's, which differs from the emission alone in
float32 rounding (and would move ancestors across bin edges); J > 1
blocks take the local emission weights alone, as the JAX package does.
"""

from __future__ import annotations

import functools
import math as _stdmath
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch.utils import checkpoint as _checkpoint

from . import distributions as dists
from . import inference as _inference
from . import resampling, state
from .noise import NoiseSource

__all__ = ["block_pf", "block_filtered_mean", "contiguous_blocks",
           "diag_emission_local_log_weights"]

_HALF_LOG_2PI = 0.5 * _stdmath.log(2.0 * _stdmath.pi)


def contiguous_blocks(dim: int, block_size: int) -> tuple:
    """Partition `range(dim)` into contiguous blocks of `block_size`
    (the last block takes the remainder)."""
    return tuple(tuple(range(i, min(i + block_size, dim)))
                 for i in range(0, dim, block_size))


def _validate_blocks(blocks, dim: int) -> tuple:
    flat = [d for b in blocks for d in b]
    if sorted(flat) != list(range(dim)):
        raise ValueError(
            f"blocks must partition range({dim}); got {blocks}")
    return tuple(tuple(int(d) for d in b) for b in blocks)


@functools.lru_cache(maxsize=None)
def _static(values: tuple, device: torch.device, dtype=torch.int64):
    """The static ``values`` as a tensor on ``device``, made once: a copy
    from the host could not be captured in a CUDA graph."""
    return torch.tensor(values, dtype=dtype, device=device)


def _segment_sum(per_dim, owner, num_blocks):
    """Sums the last axis of ``per_dim`` `[..., Do]` into `[..., J]` by the
    static owning block of each component (the JAX package's `[Do, J]`
    0/1 product), without atomics, so the same inputs give the same bits:
    the plain sum with one block, one reshaped sum when every block owns
    the same number of components, else one sum a block."""
    if num_blocks == 1:
        return per_dim.sum(dim=-1, keepdim=True)
    counts = np.bincount(owner, minlength=num_blocks)
    if counts.min() == counts.max():
        order = np.argsort(owner, kind="stable")
        if not np.array_equal(order, np.arange(len(owner))):
            per_dim = per_dim[..., _static(tuple(order.tolist()),
                                           per_dim.device)]
        return per_dim.reshape(tuple(per_dim.shape[:-1]) +
                               (num_blocks, int(counts[0]))).sum(dim=-1)
    return torch.stack([
        per_dim[..., _static(tuple(np.flatnonzero(owner == j).tolist()),
                             per_dim.device)].sum(dim=-1)
        for j in range(num_blocks)], dim=-1)


def diag_emission_local_log_weights(emission,
                                    blocks: Sequence[Sequence[int]],
                                    obs_indices=None) -> Callable:
    """Per-block emission log-weights for diagonal-Gaussian emissions.

    The emission must return a `MultivariateNormalDiag` over the observed
    components. `obs_indices[i]` names the STATE dimension that
    observation component i measures (default: identity, fully observed);
    each observation component is credited to the block owning that state
    dimension.

    Returns `local(latents, time, observations) -> [B, K, n_blocks]`.
    """
    blocks = [tuple(b) for b in blocks]
    dim_to_block = {}
    for j, b in enumerate(blocks):
        for d in b:
            dim_to_block[int(d)] = j

    def local(latents, time, observations):
        dist = emission(latents=latents, time=time)
        if not isinstance(dist, dists.MultivariateNormalDiag):
            raise TypeError(
                "diag_emission_local_log_weights needs the emission to "
                "return MultivariateNormalDiag; got "
                f"{type(dist).__name__}. Pass local_log_weight=... "
                "instead.")
        obs_t = observations[time]                     # [B, Do]
        n_obs = _inference._first_leaf(obs_t).shape[-1]
        oi = (list(range(n_obs)) if obs_indices is None
              else [int(i) for i in obs_indices])
        if len(oi) != n_obs:
            raise ValueError(
                f"obs_indices has {len(oi)} entries but the observation "
                f"has {n_obs} components")
        loc = dist.loc                                 # [B, K, Do]
        scale = dists._like(dist.scale_diag, loc).expand_as(loc)
        z = (obs_t[:, None, :] - loc) / scale
        per_dim = -0.5 * z * z - torch.log(scale) - _HALF_LOG_2PI
        owner = np.asarray([dim_to_block[d] for d in oi], dtype=np.int64)
        return _segment_sum(per_dim, owner, len(blocks))

    return local


def block_filtered_mean(latent: torch.Tensor, log_weight: torch.Tensor,
                        blocks: Sequence[Sequence[int]]) -> torch.Tensor:
    """Filtered posterior mean under per-block weights.

    Args:
        latent: `[..., B, K, D]` particles.
        log_weight: `[..., B, K, J]` matching block log-weights.
        blocks: the same partition passed to `block_pf`.

    Returns:
        `[..., B, D]`: each state dimension averaged with ITS block's
        normalized weights.
    """
    dim = latent.shape[-1]
    blocks = _validate_blocks(blocks, dim)
    dim_block = np.zeros((dim,), dtype=np.int64)
    for j, b in enumerate(blocks):
        dim_block[list(b)] = j
    w = torch.softmax(log_weight, dim=-2)            # [..., K, J]
    w_dim = w[..., _static(tuple(dim_block.tolist()), w.device)]
    return torch.sum(latent * w_dim, dim=-2)


def block_pf(observations,
             initial,
             transition,
             emission,
             num_particles: int,
             blocks: Sequence[Sequence[int]],
             noise: Optional[NoiseSource] = None,
             local_log_weight: Optional[Callable] = None,
             obs_indices=None,
             resampling_method: str = "systematic",
             resampling_implementation="auto",
             remat: bool = False,
             return_log_marginal_likelihood: bool = False,
             return_latents: bool = True,
             return_log_weights: bool = False,
             return_ancestral_indices: bool = False) -> dict:
    """Block particle filter (Rebeschini & van Handel 2015).

    Args:
        observations: stacked `[T, B, Do]` tensor (or list of steps).
        initial, transition, emission: model components with tensor
            latents `[B, K, D]` (bootstrap: no proposal argument).
        num_particles: K.
        blocks: partition of `range(D)` into index tuples, e.g. from
            `contiguous_blocks(D, 4)`. ONE block gives the bootstrap
            `inference.infer` (same draws, same ancestors).
        noise: the source of every draw (order in the module docstring);
            default `NoiseSource.seeded(0)` on the observations' device.
        local_log_weight: optional `(latents, time, observations) ->
            [B, K, n_blocks]` per-block incremental log-weights. Default:
            `diag_emission_local_log_weights(emission, blocks,
            obs_indices)`.
        obs_indices: state dimension measured by each observation
            component (for the default local weights).
        resampling_method / resampling_implementation: the per-block
            resampler, one call on the `[J B, K]` weights a step ('auto':
            the kernels for CUDA tensors). A callable (distributed)
            implementation is slice E of the port and raises
            NotImplementedError.
        remat: recompute each step in the backward
            (`torch.utils.checkpoint`) instead of keeping its activations.
        return_*: `infer`-style output selection. `latents` are the
            per-step filtered particles.

    Returns:
        dict with log_marginal_likelihood `[B]` (the product of the block
        evidences; biased for J > 1, exact for J == 1), latents
        `[T, B, K, D]`, log_weights `[T, B, K, n_blocks]`,
        ancestral_indices `[T-1, n_blocks, B, K]` int32, log_weight
        `[B, K, n_blocks]`, last_latent.
    """
    if callable(resampling_implementation):
        raise NotImplementedError(
            "block_pf's distributed (callable) resampling_implementation is "
            "not ported yet: multi-device is slice E of the port")
    stacked_obs = _inference.stack_observations(observations)
    obs_seq = _inference.ObservationSequence(stacked_obs)
    num_timesteps = len(obs_seq)
    first = _inference._first_leaf(stacked_obs)
    batch_size = first.shape[1]
    if noise is None:
        noise = NoiseSource.seeded(0, first.device)
    log_num_particles = _stdmath.log(num_particles)

    init_dist = initial()
    dim = (int(init_dist.event_shape[-1]) if tuple(init_dist.event_shape)
           else 1)
    blocks = _validate_blocks(blocks, dim)
    num_blocks = len(blocks)
    if local_log_weight is None:
        local_log_weight = diag_emission_local_log_weights(
            emission, blocks, obs_indices)
    implementation = resampling.resolve_implementation(
        first.device, resampling_method, resampling_implementation)

    # Reassembly plan: every dimension of a block shares the block's
    # ancestors, so the mix is J row gathers plus one static permutation
    # from block-concatenated order back to dimension order (the identity
    # for contiguous blocks).
    block_dims = [sorted(b) for b in blocks]
    contiguous = [list(range(b[0], b[-1] + 1)) == b for b in block_dims]
    concat_order = np.concatenate([np.asarray(b) for b in block_dims])
    inv_perm = np.argsort(concat_order)
    perm_is_identity = bool(np.all(inv_perm == np.arange(dim)))
    device = first.device
    dim_index = [None if c else _static(tuple(b), device)
                 for b, c in zip(block_dims, contiguous)]
    inv_perm_t = (None if perm_is_identity else
                  _static(tuple(inv_perm.tolist()), device))

    def block_slice(latent, j):
        if dim_index[j] is None:
            b = block_dims[j]
            return latent[:, :, b[0]:b[-1] + 1]
        return latent[:, :, dim_index[j]]

    def step(t, prev_latent, prev_log_weight, noise):
        time = _inference.TimeIndex(t)
        lw = prev_log_weight.detach().permute(2, 0, 1).reshape(
            num_blocks * batch_size, num_particles)
        anc = resampling.sample_indices(
            lw, noise, resampling_method, implementation).reshape(
                num_blocks, batch_size, num_particles)
        parts = [torch.take_along_dim(block_slice(prev_latent, j),
                                      anc[j].long()[:, :, None], dim=1)
                 for j in range(num_blocks)]
        mixed = parts[0] if num_blocks == 1 else torch.cat(parts, dim=-1)
        if inv_perm_t is not None:
            mixed = mixed[:, :, inv_perm_t]
        trans_dist = transition(previous_latents=[mixed], time=time)
        latent_t = state.sample(trans_dist, batch_size, num_particles,
                                noise)
        log_weight_t = weight(trans_dist, latent_t, time)
        contribution = (torch.logsumexp(prev_log_weight, dim=1) -
                        log_num_particles)                 # [B, J]
        return latent_t, log_weight_t, anc, contribution

    def remat_step(t, prev_latent, prev_log_weight, tape):
        tape.rewind()
        return step(t, prev_latent, prev_log_weight, tape)

    def weight(proposal_dist, latent, time):
        """The local emission log-weights `[B, K, J]`; with one block in the
        engine's bootstrap form (see the module docstring)."""
        local = local_log_weight([latent], time, obs_seq)
        if num_blocks > 1:
            return local
        proposal_lp = state.log_prob(proposal_dist, latent)[..., None]
        return proposal_lp + local - proposal_lp

    # ---- t = 0: sample from the prior; weights are the local emission lp.
    latent_0 = state.sample(init_dist, batch_size, num_particles, noise)
    log_weight_0 = weight(init_dist, latent_0, 0)            # [B, K, J]

    latents, log_weights = [latent_0], [log_weight_0]
    ancestors, contributions = [], []
    latent, log_weight = latent_0, log_weight_0
    for t in range(1, num_timesteps):
        if remat:
            latent, log_weight, anc, contribution = _checkpoint.checkpoint(
                remat_step, t, latent, log_weight,
                _inference._NoiseTape(noise), use_reentrant=False,
                preserve_rng_state=False)
        else:
            latent, log_weight, anc, contribution = step(t, latent,
                                                         log_weight, noise)
        ancestors.append(anc)
        contributions.append(contribution)
        if return_latents:
            latents.append(latent)
        if return_log_weights:
            log_weights.append(log_weight)

    log_marginal_likelihood = None
    if return_log_marginal_likelihood:
        summed = (_inference._sum_in_order(contributions) if contributions
                  else 0.0)
        log_marginal_likelihood = torch.sum(
            summed + torch.logsumexp(log_weight, dim=1) - log_num_particles,
            dim=-1)                                          # [B]
    ancestral_indices = None
    if return_ancestral_indices:
        ancestral_indices = (
            torch.stack(ancestors, dim=0) if ancestors else torch.zeros(
                (0, num_blocks, batch_size, num_particles),
                dtype=torch.int32, device=device))
    return {
        "log_marginal_likelihood": log_marginal_likelihood,
        "latents": _inference._stack_time(latents) if return_latents
        else None,
        "log_weight": log_weight,
        "log_weights": (_inference._stack_time(log_weights)
                        if return_log_weights else None),
        "ancestral_indices": ancestral_indices,
        "last_latent": latent,
    }
