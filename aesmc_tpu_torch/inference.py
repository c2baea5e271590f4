"""SMC / importance-sampling inference engine.

Counterpart of `aesmc_tpu.inference.infer`: one `infer` entry point for
'is' and for 'smc' with systematic, stratified, multinomial, residual or
soft resampling at every step, the same return-dict vocabulary, detached
ancestor indices and backward lineage tracing (`get_resampled_latents`).
Gradients flow through the resampled particle values, never through
ancestor indices or the resampling weights, as in the JAX package; soft
resampling's corrected weights also carry the gradient of the weights.

The time loop is a plain Python loop (PyTorch runs eagerly); the t = 0 step
stays hoisted, with `time` the int 0, so that user components can branch on
`time == 0`. Later steps pass a `TimeIndex`, an int known to be >= 1. The
loop never waits for the device: nothing in it reads a value back to the
host.

User-component contract (as in the JAX package): four callables returning
`distributions.Distribution`s (or dicts of them). `previous_latents` and
`latents` are lists holding the last W latents (W = `history_window`, 1
by default: the Markov path) and the current one; `previous_observations`
holds the last W observations, y_{t-1} last; `observations` is an
`ObservationSequence`.

Latents may be float32 (reparameterized proposals) or integer (categorical
proposals: the HMM's int32 states, drawn detached); integer particles go
through the time loop, resampling (K5 on the card), lineage tracing and
the returned stacks in their own dtype.

ESS-adaptive resampling (`resampling_criterion`), the auxiliary particle
filter (`lookahead`), history windows (`history_window`), the NaN guard
(`nan_check`) and rematerialization (`remat`, `torch.utils.checkpoint`
per time step) follow the JAX package. Not ported yet: OT resampling
(slice C of the port), `mesh` and the callable (distributed)
`resampling_implementation` (slice E).
"""

from __future__ import annotations

import math as _stdmath
from typing import Optional

import numpy as np
import torch
from torch.utils import checkpoint as _checkpoint

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


NAN_MESSAGE = "log_weight contains nan element(s)"


def infer(inference_algorithm: str,
          observations,
          initial,
          transition,
          emission,
          proposal,
          num_particles: int,
          noise: Optional[NoiseSource] = None,
          lookahead=None,
          resampling_method: str = "systematic",
          resampling_implementation: str = "auto",
          resampling_criterion="always",
          soft_resampling_alpha: float = 0.5,
          history_window: int = 1,
          nan_check: bool = False,
          remat: bool = False,
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
        lookahead: optional callable ``(previous_latents, time,
            observations) -> [batch, K]`` log-scores, which make SMC an
            auxiliary particle filter: each step resamples from the
            first-stage weights ``w exp(nu)`` (the scores ride the
            resampling launch as one more column) and starts the next
            weights from ``lse(logw + nu) - lse(logw) - nu[a]``, so that
            log-Z stays unbiased for any score. It sees the
            pre-resampling latents. With nu = 0 the filter equals the
            plain one bit for bit. 'smc' with a discrete method only.
        resampling_method: 'systematic', 'stratified', 'multinomial',
            'residual' or 'soft'. 'soft' draws the ancestors from the
            tempered mixture alpha w + (1 - alpha) / K and starts the next
            weights from the corrected log(w[a] / q[a]), differentiable in
            the weights (``soft_resampling_alpha`` is alpha; at alpha = 1
            it is 'multinomial').
        resampling_implementation: 'auto' | 'cuda' | 'torch' (see
            `resampling`).
        resampling_criterion: 'always' (resample at every step) or a
            float ``frac``: ESS-adaptive SMC ('smc' only; not with
            'soft'). Every row goes through the same resampling call at
            every step, so the noise drawn does not depend on the
            weights; a row whose effective sample size is below ``frac *
            K`` takes the resampled particles and contributes one
            logmeanexp term to log-Z, the other rows keep their
            particles, identity ancestors and accumulated weights. frac =
            0 never resamples (the IS estimator), a huge frac always
            does.
        soft_resampling_alpha: alpha of 'soft'.
        history_window: W >= 1. Components see length-W
            ``previous_latents``/``previous_observations`` lists ([-1]
            the most recent), padded before t = 0 with copies of the
            t = 0 values. With W > 1 the engine carries the last W
            original latents, regathers them with each step's ancestors
            (a torch gather; the resampling launch finds only the
            indices), and the emission sees the un-resampled originals
            plus the new latent, as the JAX package does.
        nan_check: raise FloatingPointError after the time loop when any
            pre-resampling log-weight was NaN ('smc' only): the steps OR
            one flag on the device, read once at the end.
        remat: recompute each time step on the backward pass
            (`torch.utils.checkpoint`) instead of keeping its activations.
            The step's noise is drawn once, in the forward, and handed to
            the recompute.
        return_*: which outputs to materialize, as in the JAX package.

    Returns:
        dict with keys log_marginal_likelihood `[batch]`, latents
        `[T, batch, K, ...]`, original_latents, log_weight `[batch, K]`,
        log_weights `[T, batch, K]` (under 'smc' the carried weights),
        ancestral_indices `[T-1, batch, K]`, last_latent; entries are None
        unless requested.
    """
    result, has_nan = _infer(
        inference_algorithm, observations, initial, transition, emission,
        proposal, num_particles, noise=noise, lookahead=lookahead,
        resampling_method=resampling_method,
        resampling_implementation=resampling_implementation,
        resampling_criterion=resampling_criterion,
        soft_resampling_alpha=soft_resampling_alpha,
        history_window=history_window, nan_check=nan_check, remat=remat,
        return_log_marginal_likelihood=return_log_marginal_likelihood,
        return_latents=return_latents,
        return_original_latents=return_original_latents,
        return_log_weight=return_log_weight,
        return_log_weights=return_log_weights,
        return_ancestral_indices=return_ancestral_indices)
    _raise_if_nan(has_nan)
    return result


def _raise_if_nan(has_nan) -> None:
    """FloatingPointError if the NaN flag of `_infer` is set; reads it from
    the device (None: nothing was checked)."""
    if has_nan is not None and bool(has_nan):
        raise FloatingPointError(NAN_MESSAGE)


class _NoiseTape:
    """A noise source for one rematerialized time step: the forward draws
    from ``noise`` and records each draw; after `rewind` the recompute of
    `torch.utils.checkpoint` gets the same tensors back, in order.
    (`preserve_rng_state` restores only PyTorch's default generators.)"""

    def __init__(self, noise):
        self._noise = noise
        self._draws = []
        self._next = 0

    @property
    def device(self):
        return self._noise.device

    def rewind(self):
        self._next = 0

    def _draw(self, kind, shape):
        if self._next == len(self._draws):
            self._draws.append(getattr(self._noise, kind)(shape))
        self._next += 1
        return self._draws[self._next - 1]

    def uniform(self, shape):
        return self._draw("uniform", shape)

    def exponential(self, shape):
        return self._draw("exponential", shape)

    def normal(self, shape):
        return self._draw("normal", shape)

    def gumbel(self, shape):
        return self._draw("gumbel", shape)


def _where_rows(do, resampled, kept):
    """Per batch row: ``resampled`` where ``do``, else ``kept`` (tensors or
    dicts of them, of any dtype)."""
    def select(res, orig):
        return torch.where(do.reshape((-1,) + (1,) * (res.ndim - 1)), res,
                           orig)

    return resampling._unflatten(resampled, iter(
        [select(res, orig) for res, orig in
         zip(resampling._leaves(resampled), resampling._leaves(kept))]))


def _check_options(inference_algorithm, resampling_method,
                   resampling_criterion, lookahead, history_window,
                   return_original_latents, return_ancestral_indices):
    """The JAX package's ValueErrors on combinations `infer` refuses."""
    if inference_algorithm not in ("is", "smc"):
        raise ValueError(
            "inference_algorithm must be either is or smc. currently = {}"
            .format(inference_algorithm))
    if inference_algorithm == "is" and return_original_latents:
        raise ValueError("return_original_latents shouldn't be True for is")
    if inference_algorithm == "is" and return_ancestral_indices:
        raise ValueError("return_ancestral_indices shouldn't be True for is")
    if history_window < 1:
        raise ValueError(
            f"history_window must be >= 1. currently = {history_window}")
    if resampling_method == "soft" and resampling_criterion != "always":
        raise ValueError(
            "soft resampling does not combine with ESS-adaptive "
            "criteria (resample-or-not is already softened)")
    if lookahead is not None:
        if inference_algorithm != "smc":
            raise ValueError(
                "lookahead (auxiliary particle filter) requires "
                "inference_algorithm='smc' - importance sampling never "
                "resamples, so there is nothing to steer")
        if resampling_method == "soft":
            raise ValueError(
                "lookahead does not combine with differentiable "
                f"resampling_method={resampling_method!r}; use a "
                "discrete method (systematic/stratified/multinomial/"
                "residual)")


def _infer(inference_algorithm, observations, initial, transition, emission,
           proposal, num_particles, noise=None, lookahead=None,
           resampling_method="systematic", resampling_implementation="auto",
           resampling_criterion="always", soft_resampling_alpha=0.5,
           history_window=1, nan_check=False, remat=False,
           return_log_marginal_likelihood=False, return_latents=True,
           return_original_latents=False, return_log_weight=True,
           return_log_weights=False, return_ancestral_indices=False):
    """`infer`, returning (result, NaN flag) without reading the flag: a
    device bool that is True when any pre-resampling log-weight was NaN,
    or None when ``nan_check`` is off or the algorithm is 'is'."""
    _check_options(inference_algorithm, resampling_method,
                   resampling_criterion, lookahead, history_window,
                   return_original_latents, return_ancestral_indices)
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
    soft = resampling_method == "soft"
    adaptive = is_smc and resampling_criterion != "always"
    if adaptive:
        ess_threshold = float(resampling_criterion) * num_particles
    window = history_window

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
    # indices are then [T-1, 0]). The windowed branch gathers its history
    # with them, so it always needs them.
    need_ancestors = bool(return_latents or return_ancestral_indices or
                          window > 1)
    need_original = return_latents or (is_smc and return_original_latents)
    need_stacked_weights = return_log_weights or not is_smc

    def resample(prev_log_weight, values, noise, time, prev_latents):
        """The resampling of a step ('smc'): (ancestral_index or None,
        ``values`` resampled (None for None: then only the indices are
        drawn), the base of the next log-weights or None for zeros, the
        step's contribution to log-Z)."""
        log_sum = torch.logsumexp(prev_log_weight, dim=1)
        contribution = log_sum - log_num_particles
        base = None
        if soft:
            idx, base, out = resampling._soft_resample(
                prev_log_weight, noise, values, soft_resampling_alpha,
                implementation, need_ancestors)
        elif lookahead is not None:
            # Auxiliary PF: the scores ride the launch as one more column.
            log_nu = lookahead(previous_latents=prev_latents, time=time,
                               observations=obs_seq)
            first_stage = prev_log_weight + log_nu
            wrapped = ({"nu": log_nu} if values is None else
                       {"latent": values, "nu": log_nu})
            idx, out = resampling._resample(
                first_stage, noise, wrapped, resampling_method,
                implementation, need_ancestors)
            base = (torch.logsumexp(first_stage, dim=1, keepdim=True) -
                    log_sum[:, None] - out["nu"])
            out = out.get("latent")
        elif values is None:
            idx = resampling._sample_indices(
                prev_log_weight, noise, resampling_method, implementation)
            out = None
        else:
            idx, out = resampling._resample(
                prev_log_weight, noise, values, resampling_method,
                implementation, need_ancestors)
        if adaptive:
            # Per row, without a host-side branch: rows whose ESS is below
            # the threshold take the resampled particles; the others keep
            # theirs, with identity ancestors and accumulated weights.
            ess = torch.exp(2 * log_sum -
                            torch.logsumexp(2 * prev_log_weight, dim=1))
            do = ess < ess_threshold                               # [B]
            if idx is not None:
                identity = torch.arange(
                    num_particles, dtype=idx.dtype,
                    device=idx.device).expand_as(idx)
                idx = torch.where(do[:, None], idx, identity)
            contribution = torch.where(do, contribution,
                                       torch.zeros_like(contribution))
            base = torch.where(
                do[:, None],
                torch.zeros_like(prev_log_weight) if base is None else base,
                prev_log_weight)
            if out is not None:
                out = _where_rows(do, out, values)
        return idx, out, base, contribution

    def step(t, prev_latents, prev_log_weight, noise):
        """Time step t >= 1 from the last W original latents: (latent_t,
        log_weight_t, ancestral_index, contribution to log-Z)."""
        time = TimeIndex(t)
        prev_obs_list = [obs_seq[max(t - window + i, 0)]
                         for i in range(window)]
        ancestral_index = contribution = base = None
        if is_smc:
            ancestral_index, resampled, base, contribution = resample(
                prev_log_weight, prev_latents[-1] if window == 1 else None,
                noise, time, prev_latents)
            if window == 1:
                previous_latents = [resampled]
            else:
                previous_latents = [state.resample(x, ancestral_index)
                                    for x in prev_latents]
            if ancestral_index is None:
                ancestral_index = torch.zeros(
                    (0,), dtype=torch.int32, device=first.device)
        else:
            previous_latents = prev_latents
        proposal_dist = proposal(previous_latents=previous_latents,
                                 time=time, observations=obs_seq)
        latent_t = state.sample(proposal_dist, batch_size, num_particles,
                                noise)
        proposal_lp = state.log_prob(proposal_dist, latent_t)
        transition_lp = state.log_prob(
            transition(previous_latents=previous_latents, time=time,
                       previous_observations=prev_obs_list),
            latent_t)
        # The emission sees the un-resampled history and the new latent.
        emission_lp = state.log_prob(
            emission(latents=prev_latents[1:] + [latent_t], time=time,
                     previous_observations=prev_obs_list),
            state.expand_observation(obs_seq[t], num_particles))
        # With no base (always-resampling) the new weight is the increment.
        log_weight_t = transition_lp + emission_lp - proposal_lp
        if base is not None:
            log_weight_t = base + log_weight_t
        return latent_t, log_weight_t, ancestral_index, contribution

    def remat_step(t, prev_latents, prev_log_weight, tape):
        tape.rewind()
        return step(t, prev_latents, prev_log_weight, tape)

    latents = [latent_0]
    log_weights = [log_weight_0]
    ancestors = []
    contributions = []
    has_nan = (torch.zeros((), dtype=torch.bool, device=first.device)
               if nan_check and is_smc else None)
    # The last W original latents, padded with copies of latent_0.
    prev_latents, prev_log_weight = [latent_0] * window, log_weight_0

    # ---- t = 1 .. T-1.
    for t in range(1, num_timesteps):
        if has_nan is not None:
            has_nan = has_nan | torch.isnan(prev_log_weight).any()
        if remat:
            latent_t, log_weight_t, ancestral_index, contribution = \
                _checkpoint.checkpoint(
                    remat_step, t, prev_latents, prev_log_weight,
                    _NoiseTape(noise), use_reentrant=False,
                    preserve_rng_state=False)
        else:
            latent_t, log_weight_t, ancestral_index, contribution = step(
                t, prev_latents, prev_log_weight, noise)
        if is_smc:
            ancestors.append(ancestral_index)
            contributions.append(contribution)
        if need_original:
            latents.append(latent_t)
        if need_stacked_weights:
            log_weights.append(log_weight_t)
        prev_latents = prev_latents[1:] + [latent_t]
        prev_log_weight = log_weight_t

    last_latent, last_log_weight = prev_latents[-1], prev_log_weight

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
    }, has_nan


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
