"""Island particle models: two-level SMC for several ranks.

Counterpart of `aesmc_tpu.parallel.islands`. Runs ``num_islands``
independent SMC filters ("islands") of ``num_particles`` each and,
optionally, RESAMPLES WHOLE ISLANDS against each other (Verge, Dubarry,
Del Moral & Moulines 2015, "On parallel implementation of sequential
Monte Carlo methods: the island particle model").

- Within an island everything is local: the islands are the rows of one
  streaming filter (`online.make_online_filter`), island i holding rows
  `[i B, (i + 1) B)`, so one resampling launch a step (K1 on the card)
  serves every island.
- The only interaction between islands is a log-mean-exp over the
  `[N]` island evidences and the occasional island-level resampling.
  On a mesh with an ``island_axis`` each rank keeps N / n islands; the
  island log-weights are gathered over the island group (N scalars a
  row) and whole island states are gathered only at a step where some
  row resamples its islands (one read of the device a step decides it,
  the same on every rank).

Estimator: each island carries its evidence since the last island
resampling; an island-resampling event adds logmeanexp over the islands
and resets them; a final logmeanexp ends it. With
``island_resampling_criterion='never'`` it is log(1/N sum_i Z_i), the mean
of independent unbiased estimates.

Noise: island i draws from ``noise.fold_in(i)`` (the counterpart of
`jax.random.fold_in(key, i)`), so island i alone is `infer(noise=
noise.fold_in(i))`; the island-level resampling draws from
``noise.fold_in(0x15AD)``.
"""

from __future__ import annotations

import math as _stdmath

import torch

from .. import device as _device
from .. import online, resampling, state
from ..noise import NoiseSource, ShardNoise, StackedNoise
from . import collectives

__all__ = ["island_infer"]

ISLAND_CRITERIA = ("never", "always")
# The fold_in tag of the island-level resampling stream.
ISLAND_STREAM = 0x15AD


def _repeat_rows(tree, n):
    """`[B, ...]` leaves -> `[n B, ...]`: the rows once for each island."""
    return state.tree_map(
        lambda x: x.repeat((n,) + (1,) * (x.ndim - 1)), tree)


def _take_islands(x, idx, group, axis=0):
    """``x`` with island-major rows `[N_l B, ...]` along ``axis`` (or None)
    regathered so that local island n, row b takes island ``idx[n, b]``
    (global ids `[N_l, B]`); the islands of every rank are gathered first
    when ``group`` is given."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _take_islands(v, idx, group, axis) for k, v in x.items()}
    n_local, batch = idx.shape
    shape = tuple(x.shape)
    islands = x.reshape(shape[:axis] + (n_local, batch) + shape[axis + 1:])
    if group is not None:
        islands = collectives.all_gather(islands, group, dim=axis)
    index = idx.long().reshape(
        (1,) * axis + (n_local, batch) +
        (1,) * (islands.ndim - axis - 2))
    out = torch.take_along_dim(islands, index, dim=axis)
    return out.reshape(shape)


def _gather_states(states, idx, group):
    """Every row-leading field of the carry regathered by island."""
    take = lambda x, axis=0: _take_islands(x, idx, group, axis)  # noqa: E731
    return states._replace(
        latent=take(states.latent), log_weight=take(states.log_weight),
        log_z_contrib=take(states.log_z_contrib),
        prev_observation=take(states.prev_observation),
        eve=take(states.eve), num_events=take(states.num_events),
        lag_buffer=take(states.lag_buffer, 1), tau=take(states.tau))


def island_infer(observations,
                 initial,
                 transition,
                 emission,
                 proposal,
                 num_particles: int,
                 num_islands: int,
                 noise=None,
                 island_resampling_criterion="never",
                 island_resampling_method: str = "systematic",
                 mesh=None,
                 island_axis: str = "island",
                 data_axis: str = "data",
                 **filter_kwargs) -> dict:
    """Two-level (island) SMC over a whole observation sequence.

    Args:
        observations: list of `[batch, ...]` values or stacked `[T, batch,
            ...]` (as `infer`); on a mesh with ``data_axis``, this rank's
            rows.
        initial, transition, emission, proposal: the components.
        num_particles: particles PER ISLAND.
        num_islands: N. The budget is N * num_particles.
        noise: a `NoiseSource` (default: seeded 0 on the observations'
            device); island i draws from ``noise.fold_in(i)``, the
            island-level resampling from ``noise.fold_in(0x15AD)``.
        island_resampling_criterion: 'never' (independent islands), 'always',
            or an ESS fraction in (0, 1]: resample the islands of a row when
            their Kish ESS drops below ``frac * N``.
        island_resampling_method: 'systematic', 'stratified' or
            'multinomial' for the island-level draw.
        mesh, island_axis, data_axis: a `DeviceMesh` with an
            ``island_axis`` (`parallel.make_island_mesh`): this rank runs
            islands `[r N / n, (r + 1) N / n)`; with ``data_axis`` too,
            its rows of the batch.
        **filter_kwargs: forwarded to `online.make_online_filter` (the
            within-island knobs: resampling_method, ..._criterion,
            lookahead, ...).

    Returns:
        dict with 'log_marginal_likelihood' `[batch]`;
        'island_log_marginal_likelihood' `[num_islands, batch]` (every
        island's, on every rank), each island's evidence since its last
        island resampling; 'last_latent' `[N_l, batch, K, ...]`,
        'log_weight' `[N_l, batch, K]` and 'pooled_log_weight' `[N_l,
        batch, K]` (island weight x particle weight, normalized over
        all islands and particles) of this rank's N_l islands (all N
        without a mesh); 'num_island_events' `[batch]` int32.
    """
    from ..inference import stack_observations

    if num_islands < 1:
        raise ValueError(
            f"num_islands must be >= 1. currently = {num_islands}")
    adaptive = island_resampling_criterion not in ISLAND_CRITERIA
    if adaptive:
        frac = float(island_resampling_criterion)
        if not 0.0 < frac <= 1.0:
            raise ValueError(
                "island_resampling_criterion must be 'never', 'always' "
                "or an ESS fraction in (0, 1]. currently = "
                f"{island_resampling_criterion!r}")
        ess_threshold = frac * num_islands

    group, first_island, local_islands = None, 0, num_islands
    rows = ((0, 1))
    if mesh is not None:
        names = tuple(mesh.mesh_dim_names or ())
        if island_axis not in names:
            raise ValueError(
                f"mesh has axes {names}; island_axis={island_axis!r} is "
                "not one of them")
        group = mesh.get_group(island_axis)
        n = collectives.size(group)
        if num_islands % n:
            raise ValueError(f"num_islands={num_islands} does not split "
                             f"over {n} ranks of {island_axis!r}")
        local_islands = num_islands // n
        first_island = collectives.rank_in(group) * local_islands
        if data_axis in names:
            data_group = mesh.get_group(data_axis)
            rows = (collectives.rank_in(data_group),
                    collectives.size(data_group))

    stacked = stack_observations(observations)
    first = resampling._leaves(stacked)[0]
    num_timesteps, batch_size = first.shape[0], first.shape[1]
    if noise is None:
        noise = NoiseSource.seeded(0, _device.resolve(first.device))

    def sharded(source):
        return source if rows[1] == 1 else ShardNoise(source, rows, (0, 1))

    island_noise = StackedNoise(
        [sharded(noise.fold_in(first_island + i))
         for i in range(local_islands)])
    level_noise = sharded(noise.fold_in(ISLAND_STREAM))
    log_num_islands = _stdmath.log(num_islands)

    init_fn, step_fn = online.make_online_filter(
        initial, transition, emission, proposal, num_particles,
        **filter_kwargs)

    def all_islands(x):
        """`[N_l, B]` -> `[N, B]` (gathered over the island group)."""
        return x if group is None else collectives.all_gather(x, group)

    states = init_fn(_repeat_rows(state.tree_map(lambda x: x[0], stacked),
                                  local_islands), island_noise)
    island_lw = online.log_marginal_likelihood(states).reshape(
        local_islands, batch_size)
    contrib = torch.zeros((batch_size,), dtype=island_lw.dtype,
                          device=island_lw.device)
    events = torch.zeros((batch_size,), dtype=torch.int32,
                         device=island_lw.device)
    interacting = num_islands > 1 and island_resampling_criterion != "never"

    for t in range(1, num_timesteps):
        obs_t = _repeat_rows(state.tree_map(lambda x, t=t: x[t], stacked),
                             local_islands)
        states, info = step_fn(states, obs_t, island_noise)
        island_lw = island_lw + info["log_pred"].reshape(local_islands,
                                                         batch_size)
        if not interacting:
            continue
        full = all_islands(island_lw)                          # [N, B]
        lw_t = full.T                                          # [B, N]
        if adaptive:
            ess = torch.exp(2 * torch.logsumexp(lw_t, dim=1) -
                            torch.logsumexp(2 * lw_t, dim=1))
            do = ess < ess_threshold                           # [B]
        else:
            do = torch.ones((batch_size,), dtype=torch.bool,
                            device=lw_t.device)
        sampled = resampling.sample_ancestral_index(
            lw_t, level_noise, method=island_resampling_method).T  # [N, B]
        identity = torch.arange(num_islands, dtype=sampled.dtype,
                                device=sampled.device)[:, None]
        idx = torch.where(do[None, :], sampled, identity.expand_as(sampled))
        idx = idx[first_island:first_island + local_islands]
        # One read a step: the islands' states move only where some row
        # resamples (every rank reads the same gathered weights).
        if bool(do.any()):
            states = _gather_states(states, idx, group)
        contrib = contrib + torch.where(
            do, torch.logsumexp(full, dim=0) - log_num_islands,
            torch.zeros_like(contrib))
        island_lw = torch.where(do[None, :], torch.zeros_like(island_lw),
                                island_lw)
        events = events + do.to(torch.int32)

    full = all_islands(island_lw)
    log_z = contrib + torch.logsumexp(full, dim=0) - log_num_islands
    island_lognorm = island_lw - torch.logsumexp(full, dim=0, keepdim=True)
    log_weight = states.log_weight.reshape(local_islands, batch_size, -1)
    particle_lognorm = log_weight - torch.logsumexp(log_weight, dim=-1,
                                                    keepdim=True)
    last_latent = state.tree_map(
        lambda x: x.reshape((local_islands, batch_size) +
                            tuple(x.shape[1:])), states.latent)
    return {
        "log_marginal_likelihood": log_z,
        "island_log_marginal_likelihood": full,
        "last_latent": last_latent,
        "log_weight": log_weight,
        "pooled_log_weight": island_lognorm[:, :, None] + particle_lognorm,
        "num_island_events": events,
    }
