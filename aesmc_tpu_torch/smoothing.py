"""Particle smoothing: FFBS trajectories and PaRIS online functionals.

Counterpart of `aesmc_tpu.smoothing`:

1. `backward_simulation`: forward-filter backward-simulation (Godsill,
   Doucet & West 2004). From a filter's stored (un-lineage-traced)
   particles and per-step log-weights it draws M trajectories from the
   joint smoothing distribution by a backward pass: at step t the parent
   of trajectory m is drawn from w_t^i p(x_{t+1}^(m) | x_t^i), so the
   trajectories do not collapse onto the few surviving forward lineages.
2. `paris`: the Particle-based Rapid Incremental Smoother (Olsson &
   Westerborn 2017). Smoothed expectations of additive functionals
   S = h0(x_0) + sum_t h(x_{t-1}, x_t, t), forward only, with O(1) memory
   in T: each particle carries a running statistic, updated at every
   filter step from N backward-kernel draws. `paris_score` uses it for
   the score of the data log-likelihood (Fisher's identity).

Backward draws, both exact categoricals J ~ w^j p(child | parent_j):
- 'pairwise': a Gumbel-max over the [B, K, M] (FFBS) or [B, K, K]
  (PaRIS) tile of log w + log p; above `PAIRWISE_DENSE_MAX_BYTES` PaRIS
  streams the parents in chunks with a running (max, argmax), so the
  tile never exists whole (O(K * chunk) memory, O(K^2) work);
- 'rejection' (Douc, Garivier, Moulines & Olsson 2011): parents proposed
  from the weights (inverse CDF) and accepted against a bound on the
  transition density, O(K) a round, for at most `max_rejection_rounds`
  rounds; the lanes still open then get the exact chunked Gumbel-max
  draw (up to `max_exact_lanes` of them). The loop reads on the host,
  once a round, how many lanes are still open, so smoothing in this
  mode is not captured in a CUDA graph.

Every random draw goes through the `NoiseSource`, in the order and
layout of the JAX package's draws: the Gumbel noise of a categorical
over the last axis of `[B, C, K]` logits is `[B, C, K]`; a rejection
round draws the parent uniforms, then the acceptance uniforms; the
streamed and exact Gumbel-max draw one `[B, chunk, ...]` block a parent
chunk. The filter of `paris` resamples with `resampling` (K1 for
systematic on the card).

Several ranks (``mesh``): every rank holds its block of the filter's
cloud, the rows of its data shard and K / n particles of each, as
`inference.infer(mesh=...)` returns them, and the draws are its block of
the single-device run's (`noise.ShardNoise`, which names the axis a tile
cuts):

- `backward_simulation`: the candidate parents stay sharded and the M
  trajectories are replicated over the particle group. A step's
  Gumbel-max runs over this rank's parents (its block of the `[B, M, K]`
  Gumbel draw), one gather of the `[B_l, M]` (score, global index) pairs
  picks the maximum (ties to the lowest index, as `torch.argmax`), and
  the chosen parents come from their owners in one all-reduce. The
  rejection mode gathers the parents and runs on the replicated
  trajectories;
- `paris`: the children (this rank's particles) are sharded; the parents
  (latents, log-weights, tau) are gathered once a step, and the `[B_l,
  K_l, K]` backward tile is local. The filter resamples through the
  distributed exchange (`parallel.dist_resampling`, K3 on the card).

The rejection loop's stop test counts the open lanes of the whole mesh
(an all-reduce before the host read), so every rank runs the same rounds
as the single-device call.
"""

from __future__ import annotations

import math as _stdmath

import torch
from torch.utils import checkpoint as _checkpoint

from . import resampling, state
from .inference import (ObservationSequence, TimeIndex, _NoiseTape,
                        _first_leaf, _resolve_implementation, _stack_time,
                        _sum_in_order, stack_observations)
from .noise import NoiseSource
from .sharding_utils import cloud_of, particle_logsumexp, particle_softmax
from .tmc import (_check_pairwise, _pair_log_prob_fn, _pairwise_log_prob,
                  _expand_new, _expand_prev, _resolve_pairwise_mode)

__all__ = ["backward_simulation", "paris", "paris_score"]

BACKWARD_MODES = ("pairwise", "rejection")

# Dense-tile ceiling of PaRIS's pairwise backward, in bytes of float32
# logits: above it the exact categorical streams over parent chunks.
PAIRWISE_DENSE_MAX_BYTES = 1 << 31
# Live-block budget of the streamed path: the per-chunk Gumbel block
# [B, chunk, C, N] stays under this many bytes.
PAIRWISE_CHUNK_BYTES = 256 << 20


def _check_backward(backward):
    if backward not in BACKWARD_MODES:
        raise ValueError(f"backward must be 'pairwise' or 'rejection'. "
                         f"currently = {backward}")


def _gather(tree, idx):
    """Gathers `[B, K, ...]` leaves at ``idx`` `[B, C]` -> `[B, C, ...]`."""
    index = idx.long()

    def leaf(x):
        return torch.take_along_dim(
            x, index.reshape(tuple(index.shape) + (1,) * (x.ndim - 2)),
            dim=1)

    return state.tree_map(leaf, tree)


def _categorical(logits, noise):
    """A categorical draw over the last axis: argmax of the logits plus
    Gumbel noise of their shape (`jax.random.categorical`'s layout)."""
    return torch.argmax(logits + noise.gumbel(tuple(logits.shape)),
                        dim=-1).to(torch.int32)


def _weights_cdf(log_weight):
    """The plain inverse-CDF table of the rejection proposals:
    cumsum(softmax(log w)), as the JAX package builds it."""
    return resampling._row_cumsum(torch.softmax(log_weight, dim=1))


def _auto_log_bound(transition, prev_latent, time, prev_obs_list):
    """Upper bound `[B]` on log p(x' | x) over children and parents: the
    density of a location family peaks at its mean, so log_prob(mean) is
    each parent's supremum, and the max over parents bounds the row."""
    dist = transition(previous_latents=[prev_latent], time=time,
                      previous_observations=prev_obs_list)
    try:
        mode = dist.mean
    except AttributeError as exc:
        raise TypeError(
            "backward='rejection' needs a transition density bound: the "
            f"auto bound reads `.mean` of the transition distribution "
            f"({type(dist).__name__} has none). Pass "
            "transition_log_bound=fn(prev_latent, time, "
            "previous_observations) -> [B].") from exc
    return state.log_prob(dist, mode).max(dim=1).values


def _chunk_size(k: int, target: int = 4096) -> int:
    """Largest divisor of k <= target (k itself when only divisors below
    256 exist: a prime K pays one dense pass)."""
    best = max(d for d in range(1, min(target, k) + 1) if k % d == 0)
    return best if (best >= 256 or k <= target) else k


def _running_argmax(score_chunks, batch_shape, dtype, device):
    """Argmax over the parent axis (1) of a sequence of score chunks, each
    `[B, chunk, ...]` with its first parent index: a running (max,
    argmax) in which ties resolve to the lowest parent."""
    best = torch.full(batch_shape, float("-inf"), dtype=dtype, device=device)
    best_idx = torch.zeros(batch_shape, dtype=torch.int32, device=device)
    for start, score in score_chunks:
        m, am = score.max(dim=1)
        take = m > best
        best = torch.where(take, m, best)
        best_idx = torch.where(take, (am + start).to(torch.int32), best_idx)
    return best_idx


def _chunked_pairwise_backward_indices(noise, prev_latent, prev_log_weight,
                                       children, transition, time,
                                       prev_obs_list, num_draws: int,
                                       resolved_pairwise: str,
                                       chunk_target=None, cloud=None):
    """Exact backward-kernel draws streamed over parent chunks: a
    Gumbel-max with a running (max, argmax), O(K * chunk) live memory in
    place of the [B, K, C] tile. Each chunk draws Gumbel noise
    `[B, chunk, C, N]` (on a mesh, ``cloud``: this rank's children, on
    axis 2, of the draw at the global sizes).

    Returns `[B, C, N]` int32 parent indices."""
    batch_size, c_children = _first_leaf(children).shape[:2]
    k = prev_log_weight.shape[1]
    n = num_draws
    if chunk_target is None:
        scale = 1 if cloud is None else cloud.n_data * cloud.n_particle
        chunk_target = max(
            1, PAIRWISE_CHUNK_BYTES // (4 * batch_size * c_children * n *
                                        scale))
    if cloud is not None:
        noise = noise.along(0, 2)
    # The largest divisor of K <= target (not `_chunk_size`, whose
    # fallback to K would rebuild the whole tile).
    target = max(1, min(int(chunk_target), k))
    chunk = max(d for d in range(1, target + 1) if k % d == 0)

    def scores():
        for start in range(0, k, chunk):
            parents = state.tree_map(lambda x: x[:, start:start + chunk],
                                     prev_latent)
            lp = _pair_log_prob_fn(transition, parents, time, prev_obs_list,
                                   resolved_pairwise)(children)
            g = noise.gumbel((batch_size, chunk, c_children, n))
            logw = prev_log_weight[:, start:start + chunk, None, None]
            yield start, lp[..., None] + logw + g        # [B, chunk, C, N]

    return _running_argmax(scores(), (batch_size, c_children, n),
                           prev_log_weight.dtype, prev_log_weight.device)


def _exact_backward_draw(noise, prev_latent, prev_log_weight, children_sel,
                         transition, time, prev_obs_list):
    """The exact backward-kernel categorical for a small set of children
    `[B, L, ...]`: a Gumbel-max over parent chunks (noise `[B, chunk,
    L]` a chunk). Returns `[B, L]` int32 parent indices."""
    batch_size, lanes = _first_leaf(children_sel).shape[:2]
    k = prev_log_weight.shape[1]
    chunk = _chunk_size(k)

    def scores():
        for start in range(0, k, chunk):
            parents = state.tree_map(lambda x: x[:, start:start + chunk],
                                     prev_latent)
            lp = _pair_log_prob_fn(transition, parents, time, prev_obs_list,
                                   "vmap")(children_sel)   # [B, chunk, L]
            g = noise.gumbel((batch_size, chunk, lanes))
            yield start, lp + prev_log_weight[:, start:start + chunk,
                                              None] + g

    return _running_argmax(scores(), (batch_size, lanes),
                           prev_log_weight.dtype, prev_log_weight.device)


def _open_lanes(accepted, cloud, sharded_children):
    """The number of open lanes of the whole mesh (of the whole batch on
    one device): the rejection loop's stop test reads it on the host, and
    every rank must read the same number."""
    count = (~accepted).sum()
    if cloud is not None:
        count = cloud.batch_sum(count)
        if sharded_children:
            count = cloud.particle_sum(count)
    return int(count)


def _rejection_backward_indices(noise, prev_latent, prev_log_weight,
                                children, transition, time, prev_obs_list,
                                num_draws: int, log_bound, max_rounds: int,
                                max_exact_lanes=None, cloud=None,
                                sharded_children=False):
    """Backward-kernel parent draws by rejection sampling, O(K) a round.

    For every child and draw, J ~ Categorical_j(wbar^j p(child | x^j))
    without the pairwise tile: propose J from the weights (inverse CDF),
    accept with probability p(child | x^J) / bound. Rounds repeat until
    at most the fallback's capacity of lanes is still open (counted over
    the whole batch, read on the host) or ``max_rounds`` is reached; then
    up to ``max_exact_lanes`` open lanes (None: max(128, lanes / 8),
    capped at ~2^26 / K; 0 disables) get the exact chunked Gumbel-max
    draw. Lanes beyond it keep their last proposal and are reported.

    On a mesh (``cloud``) the parents are the whole particle axis
    (gathered), the rows this rank's, and ``noise`` this rank's view; the
    open lanes are counted over the whole mesh. ``sharded_children``: the
    children are this rank's block of the particle axis (PaRIS), whose
    lanes are this rank's block of the single-device lanes; the exact
    fallback then picks its lanes from every rank's (gathered) flags, as
    the single-device call does. Otherwise the children are the same on
    every particle rank (FFBS's trajectories).

    Returns (idx `[B, C, N]` int32, accept_rate `[B]` (the first round's),
    unconverged `[B]`: lanes still open at exit, 0 when the draw was
    exact).
    """
    batch_size, c = _first_leaf(children).shape[:2]
    n = num_draws
    lanes_total = c * n
    spread = cloud is not None and sharded_children and cloud.n_particle > 1
    lanes_global = lanes_total * (cloud.n_particle if spread else 1)
    cdf = _weights_cdf(prev_log_weight)                      # [B, K]
    k = cdf.shape[1]
    children_flat = state.tree_map(
        lambda x: torch.repeat_interleave(x, n, dim=1), children)

    def eval_lp(j_flat):
        dist = transition(previous_latents=[_gather(prev_latent, j_flat)],
                          time=time, previous_observations=prev_obs_list)
        return state.log_prob(dist, children_flat)           # [B, C*N]

    if max_exact_lanes is None:
        lanes = min(lanes_global,
                    max(128, min(lanes_global // 8, (1 << 26) // max(k, 1))))
    else:
        lanes = min(int(max_exact_lanes), lanes_global)

    def one_round(idx, accepted):
        u_sel = noise.uniform((batch_size, lanes_total))
        j_cand = torch.searchsorted(cdf, u_sel, right=True).clamp_(
            0, k - 1).to(torch.int32)
        log_u = torch.log(torch.clamp(
            noise.uniform((batch_size, lanes_total)), min=1e-38))
        acc_new = log_u < (eval_lp(j_cand) - log_bound[:, None])
        # Open lanes track their last proposal as the fallback.
        idx = torch.where(accepted, idx, j_cand)
        return idx, accepted | acc_new

    idx = torch.zeros((batch_size, lanes_total), dtype=torch.int32,
                      device=cdf.device)
    accepted = torch.zeros((batch_size, lanes_total), dtype=torch.bool,
                           device=cdf.device)
    idx, accepted = one_round(idx, accepted)
    if spread:
        accept_rate = cloud.particle_sum(
            accepted.float().sum(dim=1)) / lanes_global
    else:
        accept_rate = accepted.float().mean(dim=1)
    rounds = 1
    while (rounds < max_rounds and
           _open_lanes(accepted, cloud, sharded_children) > lanes):
        idx, accepted = one_round(idx, accepted)
        rounds += 1

    if lanes > 0:
        if spread:
            # Every rank's lanes, in the single-device order.
            idx = cloud.gather_particles(idx)
            accepted = cloud.gather_particles(accepted)
            children_flat = state.tree_map(
                lambda x: cloud.gather_particles(x), children_flat)
        exact_noise = noise if cloud is None else noise.along(0, None)
        # The open lanes first (a stable sort of the flags), drawn
        # exactly; lanes already accepted in that window keep their draw.
        order = torch.argsort(accepted.to(torch.int8), dim=1,
                              stable=True)[:, :lanes]
        alive_sel = ~torch.gather(accepted, 1, order)
        children_sel = _gather(children_flat, order)
        idx_exact = _exact_backward_draw(
            exact_noise, prev_latent, prev_log_weight, children_sel,
            transition, time, prev_obs_list)
        keep = torch.gather(idx, 1, order)
        idx = idx.scatter(1, order, torch.where(alive_sel, idx_exact, keep))
        accepted = accepted.scatter(1, order, torch.ones_like(alive_sel))
        if spread:
            mine = slice(cloud.particle_rank * lanes_total,
                         (cloud.particle_rank + 1) * lanes_total)
            idx, accepted = idx[:, mine], accepted[:, mine]

    unconverged = (~accepted).sum(dim=1)
    if spread:
        unconverged = cloud.particle_sum(unconverged)
    return idx.reshape(batch_size, c, n), accept_rate, unconverged


def _paris_backward_update(noise, prev_latent, prev_log_weight, latent_t,
                           tau, transition, time, prev_obs_list, h,
                           num_backward_draws, backward, resolved_pairwise,
                           transition_log_bound, max_rejection_rounds,
                           max_exact_lanes, cloud=None):
    """One PaRIS statistic update: N backward-kernel parent draws a
    child, tau_t^i = mean_n [tau^{J_n} + h(x_{t-1}^{J_n}, x_t^i, t)].
    Returns (tau_t, accept_rate `[B]`, unconverged `[B]`); the
    diagnostics are ones and zeros in pairwise mode.

    On a mesh (``cloud``; ``noise`` this rank's view) the children are
    this rank's particles and the parents, their log-weights and tau are
    gathered over the particle group first: the `[B_l, K_l, K]` tile is
    this rank's block of the single-device tile."""
    if cloud is not None:
        prev_latent = state.tree_map(cloud.gather_particles, prev_latent)
        prev_log_weight = cloud.gather_particles(prev_log_weight)
        tau = cloud.gather_particles(tau)
    batch_size, k = prev_log_weight.shape
    scale = 1 if cloud is None else cloud.n_data
    ones = torch.ones((batch_size,), dtype=prev_log_weight.dtype,
                      device=prev_log_weight.device)
    zeros = torch.zeros((batch_size,), dtype=torch.int64,
                        device=prev_log_weight.device)
    if backward == "rejection":
        log_bound = (
            transition_log_bound(prev_latent, time, prev_obs_list)
            if transition_log_bound is not None else
            _auto_log_bound(transition, prev_latent, time, prev_obs_list))
        j_all, acc_rate, unconv = _rejection_backward_indices(
            noise, prev_latent, prev_log_weight, latent_t, transition, time,
            prev_obs_list, num_backward_draws, log_bound,
            max_rejection_rounds, max_exact_lanes, cloud=cloud,
            sharded_children=True)                          # [B, K, N]
    elif 4 * batch_size * scale * k * k > PAIRWISE_DENSE_MAX_BYTES:
        j_all = _chunked_pairwise_backward_indices(
            noise, prev_latent, prev_log_weight, latent_t, transition, time,
            prev_obs_list, num_backward_draws, resolved_pairwise,
            cloud=cloud)
        acc_rate, unconv = ones, zeros
    else:
        # logits[b, i_child, j_parent] = log w^j + log p(x_t^i | x^j).
        a = _pair_log_prob_fn(transition, prev_latent, time, prev_obs_list,
                              resolved_pairwise)(latent_t)  # [B, Kj, Ki]
        logits = a.transpose(1, 2) + prev_log_weight[:, None, :]
        j_all = torch.stack([_categorical(logits, noise)
                             for _ in range(num_backward_draws)], dim=-1)
        acc_rate, unconv = ones, zeros

    acc = None
    for draw in range(num_backward_draws):
        j_idx = j_all[..., draw]                              # [B, K]
        term = _gather(tau, j_idx) + h(_gather(prev_latent, j_idx),
                                       latent_t, time)
        acc = term if acc is None else acc + term
    return acc / num_backward_draws, acc_rate, unconv


def _mesh_categorical(logits, noise, cloud):
    """A categorical draw over this rank's parents, the last axis of
    ``logits`` `[B_l, M, K_l]`, as the single-device draw over all K: the
    local Gumbel-max (this rank's block of the `[B, M, K]` draw), then one
    gather of every rank's (score, global index) and the maximum, the
    lowest index on ties. Returns `[B_l, M]` int32 global indices."""
    scores = logits + noise.along(0, 2).gumbel(tuple(logits.shape))
    best, arg = scores.max(dim=-1)
    arg = arg + cloud.offset(logits.shape[-1])
    bests = cloud.gather_particles(best[None], dim=0)        # [n, B, M]
    args = cloud.gather_particles(arg[None], dim=0)
    owner = torch.argmax(bests, dim=0, keepdim=True)
    return torch.gather(args, 0, owner)[0].to(torch.int32)


def _fetch(latent, idx, cloud):
    """``latent`` `[B_l, K_l, ...]` (this rank's block) at the global
    indices ``idx`` `[B_l, C]`: each rank fills the slots it owns and one
    all-reduce over the particle group sums them (a value plus zeros: the
    value's bits)."""
    k_local = _first_leaf(latent).shape[1]
    local = idx.long() - cloud.offset(k_local)
    mine = (local >= 0) & (local < k_local)
    picked = _gather(latent, local.clamp(0, k_local - 1))

    def own(x):
        keep = mine.reshape(tuple(mine.shape) + (1,) * (x.ndim - 2))
        return cloud.particle_sum(torch.where(keep, x, torch.zeros_like(x)))

    return state.tree_map(own, picked)


def backward_simulation(original_latents, log_weights, transition,
                        num_trajectories: int, noise, observations=None,
                        backward: str = "pairwise",
                        transition_log_bound=None,
                        max_rejection_rounds: int = 64,
                        max_exact_lanes=None, mesh=None,
                        data_axis: str = "data",
                        particle_axis: str = "particle"):
    """Draws ``num_trajectories`` joint smoothing trajectories (FFBS).

    Args:
        original_latents: stacked `[T, B, K, ...]` tensor (or dict): the
            un-resampled particles of each step
            (``infer(..., return_original_latents=True)``).
        log_weights: `[T, B, K]` per-step log-weights
            (``infer(..., return_log_weights=True)``).
        transition: the model's transition; in 'pairwise' mode it must
            accept [B, K, 1, ...] parents (see `tmc`).
        num_trajectories: M, trajectories a batch row.
        noise: the `NoiseSource` (Gumbel noise in 'pairwise' mode,
            uniforms and Gumbel noise in 'rejection' mode).
        observations: optional observations (list or stacked), for
            transitions that read ``previous_observations``.
        backward: 'pairwise' (the [B, K, M] tile, exact) or 'rejection'
            (O(K + M) a step; exact when every lane accepts within
            ``max_rejection_rounds`` or falls to the exact fallback).
        transition_log_bound: optional ``fn(prev_latent, time,
            previous_observations) -> [B]`` log upper bound on the
            transition density (default: log_prob at the mean, exact for
            the Gaussians).
        max_rejection_rounds, max_exact_lanes: the rejection loop's caps.
        mesh, data_axis, particle_axis: a `DeviceMesh` and its axis
            names: the latents, weights and observations are this rank's
            blocks (as ``infer(mesh=...)`` returns them; module
            docstring), and so is the result's batch axis.

    Returns:
        `[T, B, M, ...]` smoothing trajectories (on a mesh `[T, B_l, M,
        ...]`, the same on every rank of a particle group).
    """
    _check_backward(backward)
    cloud = cloud_of(mesh, None, data_axis, particle_axis)
    num_timesteps, batch_size, _ = log_weights.shape
    m = num_trajectories
    obs_seq = (ObservationSequence(stack_observations(observations))
               if observations is not None else None)
    if cloud is not None:
        noise = cloud.noise(noise)

    def categorical(logits):
        """[B, M, K] logits over the (this rank's) parents."""
        if cloud is None:
            return _categorical(logits, noise)
        return _mesh_categorical(logits, noise, cloud)

    def pick(latent, idx):
        return _gather(latent, idx) if cloud is None else _fetch(
            latent, idx, cloud)

    # ---- t = T-1: from the final filtering weights.
    logits = log_weights[-1][:, None, :].expand(batch_size, m, -1)
    chosen = pick(state.tree_map(lambda x: x[-1], original_latents),
                  categorical(logits))
    trajectory = [chosen]

    # ---- t = T-2 .. 0.
    for t in range(num_timesteps - 2, -1, -1):
        latent_t = state.tree_map(lambda x, t=t: x[t], original_latents)
        logw_t = log_weights[t]
        # The transition from t to t+1 sees previous_observations [y_t].
        time = TimeIndex(t + 1)
        prev_obs_list = [obs_seq[t]] if obs_seq is not None else None
        if backward == "rejection":
            parents, parent_lw, draws = latent_t, logw_t, noise
            if cloud is not None:
                # The trajectories are replicated over the particle group:
                # every rank draws for all of them over the gathered
                # parents, from its rows of the draws.
                parents = state.tree_map(cloud.gather_particles, latent_t)
                parent_lw = cloud.gather_particles(logw_t)
                draws = noise.along(0, None)
            log_bound = (
                transition_log_bound(parents, time, prev_obs_list)
                if transition_log_bound is not None else
                _auto_log_bound(transition, parents, time, prev_obs_list))
            idx, _, _ = _rejection_backward_indices(
                draws, parents, parent_lw, chosen, transition, time,
                prev_obs_list, 1, log_bound, max_rejection_rounds,
                max_exact_lanes, cloud=cloud)
            idx = idx[..., 0]                                # [B, M]
            chosen = _gather(parents, idx)
        else:
            pair_dist = transition(
                previous_latents=[_expand_prev(latent_t)], time=time,
                previous_observations=prev_obs_list)
            # trans_lp[b, k, m] = log p(chosen^m | candidate parent^k)
            trans_lp = _pairwise_log_prob(pair_dist, _expand_new(chosen))
            logits = logw_t[:, :, None] + trans_lp           # [B, K, M]
            idx = categorical(logits.transpose(1, 2))        # [B, M]
            chosen = pick(latent_t, idx)
        trajectory.append(chosen)
    return _stack_time(trajectory[::-1])


def paris(observations, initial, transition, emission, proposal,
          num_particles: int, h, noise=None, h0=None,
          num_backward_draws: int = 2,
          resampling_method: str = "systematic",
          resampling_implementation: str = "auto",
          pairwise: str = "auto",
          backward: str = "pairwise",
          transition_log_bound=None,
          max_rejection_rounds: int = 64,
          max_exact_lanes=None,
          remat: bool = True,
          mesh=None,
          data_axis: str = "data",
          particle_axis: str = "particle"):
    """PaRIS: forward-only smoothing of an additive functional.

    Runs an SMC filter over ``observations`` in which every particle
    carries tau_t^i ~= E[h0(x_0) + sum_{s<=t} h(x_{s-1}, x_s, s) | x_t =
    x_t^i, y_{0:t}], updated at each step as the mean over
    ``num_backward_draws`` draws J ~ Categorical_j(w_{t-1}^j p(x_t^i |
    x_{t-1}^j)) of tau_{t-1}^J + h(x_{t-1}^J, x_t^i, t) (Olsson &
    Westerborn 2017, Algorithm 2). The smoothed estimate sum_i wbar^i
    tau^i is consistent for E[S | y_{0:T-1}]; nothing is stored per step.

    Args:
        observations: list or stacked `[T, batch, ...]` observations.
        initial, transition, emission, proposal: the components.
        num_particles: K.
        h: ``h(previous_latent, latent, time) -> [batch, K(, D)]``,
            evaluated pointwise on (drawn parent, particle) pairs.
        noise: the `NoiseSource` (default `NoiseSource.seeded(0)` on the
            observations' device). Each step draws the resampling noise,
            the proposal's, then the backward draws'.
        h0: optional ``h0(latent_0) -> [batch, K(, D)]`` (default 0).
        num_backward_draws: N >= 1 (2, the default, keeps the statistic's
            variance O(T); 1 is lineage smoothing).
        resampling_method, resampling_implementation: the filter's
            resampling (`resampling`); the backward draws are always
            categorical.
        pairwise: 'broadcast' | 'vmap' | 'auto', how the [B, K, K] tile is
            formed (see `tmc`).
        backward: 'pairwise' or 'rejection' (see the module docstring;
            ``pairwise`` is then unused).
        transition_log_bound, max_rejection_rounds, max_exact_lanes: as in
            `backward_simulation`.
        remat: recompute each step in the backward pass
            (`torch.utils.checkpoint`), for callers that differentiate.
        mesh, data_axis, particle_axis: a `DeviceMesh` and its axis
            names: this rank runs its block, the observations' rows of
            its data shard and K / n of the ``num_particles`` particles
            (module docstring); ``resampling_implementation`` may then be
            a distributed resampler of `parallel.dist_resampling` (by
            default the all-gather exchange of ``resampling_method``).
            The outputs are this rank's blocks.

    Returns:
        dict with 'smoothed' `[batch(, D)]`, 'tau' `[batch, K(, D)]`,
        'log_weight' `[batch, K]`, 'log_marginal_likelihood' `[batch]`;
        with ``backward='rejection'`` also 'backward_accept_rate'
        `[batch]` (the mean first-round acceptance over steps) and
        'backward_unconverged' `[batch]` (lanes left open, 0 when exact).
    """
    _check_backward(backward)
    if num_backward_draws < 1:
        raise ValueError(
            "num_backward_draws must be >= 1. currently = "
            f"{num_backward_draws}")
    _check_pairwise(pairwise)
    stacked_obs = stack_observations(observations)
    obs_seq = ObservationSequence(stacked_obs)
    num_timesteps = len(obs_seq)
    first = _first_leaf(stacked_obs)
    batch_size = first.shape[1]
    if noise is None:
        noise = NoiseSource.seeded(0, first.device)
    cloud = cloud_of(mesh, None, data_axis, particle_axis)
    k = (num_particles if cloud is None else
         cloud.local_particles(num_particles))
    log_k = _stdmath.log(num_particles)
    if cloud is None:
        implementation = resampling.resolve_implementation(
            first.device, resampling_method, resampling_implementation)
    else:
        implementation = _resolve_implementation(
            first.device, resampling_method, resampling_implementation,
            cloud)

    def view(source):
        return source if cloud is None else cloud.noise(source)

    def lse(x):
        return particle_logsumexp(x, cloud)

    def smoothed_of(log_weight, tau):
        w = particle_softmax(log_weight, cloud)
        local = torch.einsum("bk,bk...->b...", w, tau)
        return local if cloud is None else cloud.particle_sum(local)

    # ---- t = 0 (hoisted).
    proposal_dist = proposal(time=0, observations=obs_seq)
    latent_0 = state.sample(proposal_dist, batch_size, k, view(noise))
    log_weight_0 = (state.log_prob(initial(), latent_0) +
                    state.log_prob(emission(latents=[latent_0], time=0),
                                   state.expand_observation(obs_seq[0], k)) -
                    state.log_prob(proposal_dist, latent_0))
    tau_0 = (h0(latent_0) if h0 is not None else
             torch.zeros_like(log_weight_0))
    out = {}
    if num_timesteps == 1:
        last_latent, last_log_weight, tau_last = latent_0, log_weight_0, tau_0
        log_ml = lse(log_weight_0) - log_k
        if backward == "rejection":
            out["backward_accept_rate"] = torch.ones_like(log_ml)
            out["backward_unconverged"] = torch.zeros(
                (batch_size,), dtype=torch.int64, device=log_ml.device)
    else:
        resolved = (pairwise if pairwise != "auto" or backward != "pairwise"
                    else _resolve_pairwise_mode(transition, latent_0,
                                                obs_seq[0]))

        def resample(prev_log_weight, noise, prev_latent):
            if cloud is None:
                _, parent = resampling._resample(
                    prev_log_weight, noise, prev_latent, resampling_method,
                    implementation, need_indices=False)
                return parent
            _, parent = resampling.callable_resample(
                implementation, prev_log_weight.detach(), noise,
                prev_latent, lse(prev_log_weight).detach())
            return parent

        def step(t, prev_latent, prev_log_weight, tau, noise):
            time = TimeIndex(t)
            prev_obs_list = [obs_seq[t - 1]]
            noise = view(noise)
            # Filter update: resample, propose, weight (always resampling).
            parent = resample(prev_log_weight, noise, prev_latent)
            proposal_dist = proposal(previous_latents=[parent], time=time,
                                     observations=obs_seq)
            latent_t = state.sample(proposal_dist, batch_size, k, noise)
            log_weight_t = (
                state.log_prob(
                    transition(previous_latents=[parent], time=time,
                               previous_observations=prev_obs_list),
                    latent_t) +
                state.log_prob(
                    emission(latents=[latent_t], time=time,
                             previous_observations=prev_obs_list),
                    state.expand_observation(obs_seq[t], k)) -
                state.log_prob(proposal_dist, latent_t))
            # Backward draws over the pre-resampling parents.
            tau_t, acc_rate, unconv = _paris_backward_update(
                noise, prev_latent, prev_log_weight, latent_t, tau,
                transition, time, prev_obs_list, h, num_backward_draws,
                backward, resolved, transition_log_bound,
                max_rejection_rounds, max_exact_lanes, cloud=cloud)
            return latent_t, log_weight_t, tau_t, acc_rate, unconv

        def remat_step(t, prev_latent, prev_log_weight, tau, tape):
            tape.rewind()
            return step(t, prev_latent, prev_log_weight, tau, tape)

        latent, log_weight, tau = latent_0, log_weight_0, tau_0
        contributions, acc_rates, unconvs = [], [], []
        for t in range(1, num_timesteps):
            contributions.append(lse(log_weight) - log_k)
            if remat and torch.is_grad_enabled():
                latent, log_weight, tau, acc_rate, unconv = \
                    _checkpoint.checkpoint(
                        remat_step, t, latent, log_weight, tau,
                        _NoiseTape(noise), use_reentrant=False,
                        preserve_rng_state=False)
            else:
                latent, log_weight, tau, acc_rate, unconv = step(
                    t, latent, log_weight, tau, noise)
            acc_rates.append(acc_rate)
            unconvs.append(unconv)
        last_latent, last_log_weight, tau_last = latent, log_weight, tau
        log_ml = (_sum_in_order(contributions) + lse(last_log_weight) -
                  log_k)
        if backward == "rejection":
            out["backward_accept_rate"] = torch.stack(acc_rates).mean(dim=0)
            out["backward_unconverged"] = torch.stack(unconvs).sum(dim=0)
    out.update({
        "smoothed": smoothed_of(last_log_weight, tau_last),
        "tau": tau_last, "log_weight": last_log_weight,
        "log_marginal_likelihood": log_ml})
    return out


def _flatten(params):
    """(flat `[P]` tensor, ``unflatten(flat)`` -> the structure of
    ``params``, a tensor or a dict of tensors)."""
    leaves = resampling._leaves(params)
    shapes = [tuple(leaf.shape) for leaf in leaves]
    sizes = [leaf.numel() for leaf in leaves]
    flat = torch.cat([leaf.reshape(-1) for leaf in leaves])

    def unflatten(vector, lead=()):
        parts = torch.split(vector, sizes, dim=-1)
        return resampling._unflatten(params, iter(
            [p.reshape(tuple(lead) + s) for p, s in zip(parts, shapes)]))

    return flat, unflatten


def paris_score(observations, build_components, params,
                num_particles: int, noise=None,
                num_backward_draws: int = 2,
                resampling_method: str = "systematic",
                resampling_implementation: str = "auto",
                pairwise: str = "auto", remat: bool = True):
    """Online score (Fisher-identity gradient) estimation via PaRIS.

    The score of the data log-likelihood is the smoothed expectation of
    the additive functional grad log mu(x_0) + grad log g(y_0 | x_0) +
    sum_t grad log f(x_t | x_{t-1}) + grad log g(y_t | x_t), so `paris`
    computes it forward only; each increment is a forward-mode Jacobian
    (`torch.func.jacfwd`) over the P parameters. The proposal is built
    from the same parameters but does not enter the score.

    Args:
        observations: list or stacked `[T, batch, ...]` observations.
        build_components: ``params -> (initial, transition, emission,
            proposal)``, components whose densities are differentiable
            functions of the ``params`` tensors they are given.
        params: a tensor or a dict of tensors.
        num_particles, noise, num_backward_draws, resampling_*, pairwise,
            remat: as in `paris`.

    Returns:
        dict with 'score' (the structure of ``params``, each leaf with a
        leading `[batch]` axis) and 'log_marginal_likelihood' `[batch]`.
    """
    flat_params, unflatten = _flatten(params)
    flat_params = flat_params.detach()
    initial, transition, emission, proposal = build_components(params)
    obs_seq = ObservationSequence(stack_observations(observations))

    def h(xp, xc, time):
        obs_t = obs_seq[time]
        prev_obs_list = [obs_seq[time - 1]]
        k_count = _first_leaf(xc).shape[1]

        def logdensities(flat):
            _, trans_p, emis_p, _ = build_components(unflatten(flat))
            return (state.log_prob(
                        trans_p(previous_latents=[xp], time=time,
                                previous_observations=prev_obs_list), xc) +
                    state.log_prob(
                        emis_p(latents=[xc], time=time,
                               previous_observations=prev_obs_list),
                        state.expand_observation(obs_t, k_count)))

        return torch.func.jacfwd(logdensities)(flat_params)   # [B, K, P]

    def h0(x0):
        k_count = _first_leaf(x0).shape[1]

        def logdensities(flat):
            init_p, _, emis_p, _ = build_components(unflatten(flat))
            return (state.log_prob(init_p(), x0) +
                    state.log_prob(emis_p(latents=[x0], time=0),
                                   state.expand_observation(obs_seq[0],
                                                            k_count)))

        return torch.func.jacfwd(logdensities)(flat_params)   # [B, K, P]

    with torch.no_grad():
        out = paris(obs_seq.stacked, initial, transition, emission, proposal,
                    num_particles, h=h, h0=h0, noise=noise,
                    num_backward_draws=num_backward_draws,
                    resampling_method=resampling_method,
                    resampling_implementation=resampling_implementation,
                    pairwise=pairwise, remat=remat)
    smoothed = out["smoothed"]                                  # [B, P]
    return {"score": unflatten(smoothed, lead=(smoothed.shape[0],)),
            "log_marginal_likelihood": out["log_marginal_likelihood"]}
