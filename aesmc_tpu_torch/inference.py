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
filter (`lookahead`), history windows (`history_window`), entropy-
regularized OT resampling (`resampling_method='ot'`, `ot`), the NaN guard
(`nan_check`) and rematerialization (`remat`, `torch.utils.checkpoint`
per time step) follow the JAX package.

Several ranks (`mesh`): every rank runs `infer` on its block, the
observations' rows of its data shard (`[T, B / data, ...]`,
`parallel.shard_batch`) and K / particle particles of each. Every
reduction over the particle axis is then a collective over the particle
group (the log-Z terms, the ESS of adaptive resampling), the per-particle
draws are this rank's block of the single-device run's draws
(`noise.ShardNoise`), and resampling is distributed
(`parallel.dist_resampling`): a callable ``resampling_implementation``, or
by default the all-gather exchange of the same method ('ot': the
ring-streamed Sinkhorn of `ot.distributed_ot_resample`). Lineages are
traced over the whole particle axis: the stacked latents and ancestors
are gathered over the particle group at the end, O(T B_l K) values a
rank.

log-Z sums the steps' contributions in time order, one addition a step
(`_sum_in_order`), as the streaming filter (`online`) accumulates them,
so that both give the same bits from the same noise.
"""

from __future__ import annotations

import functools
import math as _stdmath
import operator
from typing import Optional

import numpy as np
import torch
from torch.utils import checkpoint as _checkpoint

from . import device as _device
from . import ot as _ot
from . import resampling, state
from .noise import NoiseSource
from .profiling import annotate
from .resampling import sample_ancestral_index  # noqa: F401  (parity export)

__all__ = [
    "infer", "get_resampled_latents", "sample_ancestral_index",
    "ObservationSequence", "TimeIndex", "DeviceTimeIndex",
    "stack_observations",
]


class TimeIndex(int):
    """The time index of a step after the hoisted t = 0, known to be >= 1.

    In the eager loop it is a plain int, so `time == t` and
    `observations[time]` behave as for any int.
    """


def _unwrap_time(x):
    return x.value if isinstance(x, DeviceTimeIndex) else x


class DeviceTimeIndex:
    """A time index >= 1 held in a 0-d int32 tensor on the device, for
    steps whose time the host does not track (the streaming filter's
    `step_fn`, a step captured in a CUDA graph and replayed). The JAX
    package hands its components a traced `TimeIndex` there.

    ``time == 0`` is False without reading the device (the step after the
    hoisted t = 0); any other comparison or arithmetic gives a tensor, and
    torch functions (``torch.sin(time)``, ``table[time]``) see the
    tensor. `int(time)` reads it from the device, a wait for the card.
    """

    __slots__ = ("value",)

    def __init__(self, value: torch.Tensor):
        self.value = value

    def __eq__(self, other):
        if type(other) is int and other == 0:
            return False
        return self.value == _unwrap_time(other)

    def __ne__(self, other):
        if type(other) is int and other == 0:
            return True
        return self.value != _unwrap_time(other)

    __hash__ = object.__hash__

    def __int__(self):
        return int(self.value)

    def __repr__(self):
        return f"DeviceTimeIndex({self.value!r})"

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        args = [_unwrap_time(a) for a in args]
        kwargs = {k: _unwrap_time(v) for k, v in (kwargs or {}).items()}
        return func(*args, **kwargs)


def _delegate(name):
    def method(self, *args):
        return getattr(self.value, name)(*[_unwrap_time(a) for a in args])
    method.__name__ = name
    return method


for _name in ("__add__", "__radd__", "__sub__", "__rsub__", "__mul__",
              "__rmul__", "__truediv__", "__rtruediv__", "__floordiv__",
              "__mod__", "__neg__", "__lt__", "__le__", "__gt__", "__ge__"):
    setattr(DeviceTimeIndex, _name, _delegate(_name))


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
          ot_epsilon: float = 0.5,
          ot_num_iterations: int = 20,
          ot_block_size=None,
          ot_rank=None,
          history_window: int = 1,
          nan_check: bool = False,
          remat: bool = False,
          return_log_marginal_likelihood: bool = False,
          return_latents: bool = True,
          return_original_latents: bool = False,
          return_log_weight: bool = True,
          return_log_weights: bool = False,
          return_ancestral_indices: bool = False,
          mesh=None,
          data_axis: str = "data",
          particle_axis: str = "particle") -> dict:
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
            'residual', 'soft' or 'ot'. 'soft' draws the ancestors from the
            tempered mixture alpha w + (1 - alpha) / K and starts the next
            weights from the corrected log(w[a] / q[a]), differentiable in
            the weights (``soft_resampling_alpha`` is alpha; at alpha = 1
            it is 'multinomial'). 'ot' transports the weighted particles
            onto a uniformly weighted set (`ot.ot_resample`, log-domain
            Sinkhorn; with ``ot_rank`` the low-rank
            `ot.lowrank_ot_resample`, whose jitter is two normal draws of
            `[B, K, rank]` from ``noise``), differentiable in the weights
            and the particles. It has no ancestors: 'smc' with 'ot' needs
            ``return_latents=False``, no ancestral indices, W = 1 and the
            'always' criterion.
        resampling_implementation: 'auto' | 'cuda' | 'torch' (see
            `resampling`), or a callable resampler of
            `parallel.dist_resampling` (with ``mesh``).
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
        ot_epsilon, ot_num_iterations, ot_block_size, ot_rank: the OT
            resampler's entropic regularization (relative to the mean
            cost), Sinkhorn iterations, block width (None: dense up to
            `ot.OT_DENSE_MAX_K`, blocked above) and low-rank rank (None:
            Sinkhorn). ``ot_epsilon`` and ``ot_block_size`` do not apply
            to the low-rank form.
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
        mesh, data_axis, particle_axis: a `DeviceMesh` (`parallel.
            make_mesh`) and the names of its batch and particle axes: this
            rank runs its block (module docstring). ``num_particles`` is
            the whole cloud's K; the outputs are this rank's blocks
            (log-Z `[B_l]`, the same on every particle rank; ancestors
            as global indices). 'ot' runs the ring-streamed Sinkhorn
            (`ot.distributed_ot_resample`; ``ot_block_size`` unused), or
            with ``ot_rank`` the low-rank transport with its sums over K
            all-reduced (`ot.lowrank_ot_resample(group=)`); 'residual'
            the residual exchange (`parallel.dist_resampling.
            distributed_residual_resample`: exact int32 counts between
            ranks, kernels K4, K3, K2 and K5).

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
        soft_resampling_alpha=soft_resampling_alpha, ot_epsilon=ot_epsilon,
        ot_num_iterations=ot_num_iterations, ot_block_size=ot_block_size,
        ot_rank=ot_rank, history_window=history_window,
        nan_check=nan_check, remat=remat,
        return_log_marginal_likelihood=return_log_marginal_likelihood,
        return_latents=return_latents,
        return_original_latents=return_original_latents,
        return_log_weight=return_log_weight,
        return_log_weights=return_log_weights,
        return_ancestral_indices=return_ancestral_indices, mesh=mesh,
        data_axis=data_axis, particle_axis=particle_axis)
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

    def bits(self, shape):
        return self._draw("bits", shape)


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
                   return_latents, return_original_latents,
                   return_ancestral_indices):
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
        if resampling_method in ("soft", "ot"):
            raise ValueError(
                "lookahead does not combine with differentiable "
                f"resampling_method={resampling_method!r}; use a "
                "discrete method (systematic/stratified/multinomial/"
                "residual)")
    if resampling_method == "ot" and inference_algorithm == "smc":
        # OT transports particles: no ancestors, so no lineage, no
        # ancestor outputs and no history to regather ('is' ignores the
        # method, as every other one).
        if return_latents or return_ancestral_indices:
            raise ValueError(
                "resampling_method='ot' transports particles (no "
                "discrete ancestors): lineage-traced latents and "
                "ancestral indices are unavailable. Use "
                "return_latents=False (training) or "
                "return_original_latents=True.")
        if history_window > 1:
            raise ValueError(
                "resampling_method='ot' does not combine with "
                "history_window > 1 (no ancestors to regather the "
                "history with)")
        if resampling_criterion != "always":
            raise ValueError(
                "resampling_method='ot' does not combine with "
                "ESS-adaptive criteria")


def _resolve_implementation(device, resampling_method,
                            resampling_implementation, cloud=None,
                            soft_resampling_alpha=0.5):
    """`resampling.resolve_implementation`, with 'ot' (no kernel: torch ops
    on every device) checked as a route name only. On a mesh (``cloud``)
    a callable must be given or is made: the all-gather exchange of the
    same method, the residual exchange for 'residual' ('ot': the
    ring-streamed Sinkhorn or the low-rank transport, chosen in
    `_resample_step`)."""
    _check_ot_callable(resampling_method, resampling_implementation)
    if cloud is not None:
        if callable(resampling_implementation):
            return resampling_implementation
        resampling._route(device, resampling_implementation)
        if resampling_method == "ot":
            return "torch"
        from .parallel import dist_resampling
        if resampling_method == "residual":
            return dist_resampling._make_residual_resampler(
                cloud.mesh, cloud.data_axis, cloud.particle_axis)
        return dist_resampling.make_distributed_fused_resampler(
            cloud.mesh, cloud.data_axis, cloud.particle_axis,
            method=resampling_method, soft_alpha=soft_resampling_alpha)
    if callable(resampling_implementation):
        if getattr(resampling_implementation, "mesh", None) is not None:
            raise ValueError(
                "a distributed resampler needs mesh= (the engine's "
                "particle-axis reductions cross the mesh too)")
        return resampling_implementation
    if resampling_method == "ot":
        resampling._route(device, resampling_implementation)
        return "torch"
    return resampling.resolve_implementation(device, resampling_method,
                                             resampling_implementation)


def _check_ot_callable(method, implementation):
    """The JAX package's ValueError for a distributed OT resampler under
    another method."""
    if (callable(implementation) and getattr(implementation, "ot", False)
            and method != "ot"):
        raise ValueError(
            "got a distributed OT resampler (.ot callable) but "
            f"resampling_method={method!r}; pass resampling_method='ot' "
            "with it")


def _sum_in_order(values):
    """``values[0] + values[1] + ...``, one addition at a time in list
    order: the same bits on every device, as a running sum gives them."""
    return functools.reduce(operator.add, values)


@annotate("aesmc.smc.resample")
def _resample_step(prev_log_weight, values, noise, time, prev_latents,
                   observations, method, implementation, need_ancestors,
                   alpha=0.5, lookahead=None, ess_threshold=None, ot=None,
                   log_sum=None, cloud=None):
    """The resampling of an 'smc' step, shared by `infer` and the streaming
    filter (`online`).

    Args:
        prev_log_weight: `[B, K]` pre-resampling log-weights.
        values: the particles to resample, or None (then only the indices
            are drawn: a windowed step regathers its history with them).
        noise: the step's `NoiseSource`; the resampling draws come first.
        time, prev_latents, observations: what ``lookahead`` reads.
        method, implementation: the method, and 'cuda' or 'torch'.
        need_ancestors: whether the indices are wanted.
        alpha: soft resampling's alpha.
        lookahead: the APF's score callable, or None.
        ess_threshold: ESS-adaptive resampling's threshold (frac * K), or
            None for resampling at every step.
        ot: (epsilon, num_iterations, block_size, rank) of 'ot'.
        log_sum: ``logsumexp(prev_log_weight, dim=1)`` if the caller has
            it already.
        cloud: this rank's `sharding_utils.Cloud` on a mesh, or None: the
            particle-axis reductions then cross the particle group, and
            ``implementation`` is a distributed callable.

    Returns:
        (ancestral_index or None, ``values`` resampled (None for None),
        the base of the next log-weights or None for zeros, the step's
        contribution to log-Z `[B]`, the rows that resampled `[B]` bool or
        None when every row did).
    """
    lse = _particle_logsumexp(cloud)
    num_particles = prev_log_weight.shape[1] * (
        1 if cloud is None else cloud.n_particle)
    if log_sum is None:
        log_sum = lse(prev_log_weight)
    contribution = log_sum - _stdmath.log(num_particles)
    base = idx = None
    if method == "ot":
        # Transported, not selected: no ancestors; uniform weights next.
        epsilon, num_iterations, block_size, rank = ot
        if callable(implementation) and getattr(implementation, "ot",
                                                False):
            # A distributed OT resampler binds its own epsilon and
            # iterations (`parallel.make_distributed_ot_resampler`).
            out, _ = implementation(prev_log_weight, values)
        elif rank is not None:
            out, _ = _ot.lowrank_ot_resample(
                prev_log_weight, values, rank=rank,
                num_iterations=num_iterations, noise=noise,
                group=None if cloud is None else cloud.particle_group)
        elif cloud is not None:
            out, _ = _ot.distributed_ot_resample(
                prev_log_weight, values, cloud.particle_group,
                epsilon=epsilon, num_iterations=num_iterations)
        else:
            out, _ = _ot.ot_resample(
                prev_log_weight, values, epsilon=epsilon,
                num_iterations=num_iterations, block_size=block_size)
    elif callable(implementation):
        idx, out, base = _callable_step(
            prev_log_weight, values, noise, time, prev_latents,
            observations, method, implementation, alpha, lookahead,
            log_sum, lse)
    elif method == "soft":
        idx, base, out = resampling._soft_resample(
            prev_log_weight, noise, values, alpha, implementation,
            need_ancestors)
    elif lookahead is not None:
        # Auxiliary PF: the scores ride the launch as one more column.
        log_nu = lookahead(previous_latents=prev_latents, time=time,
                           observations=observations)
        first_stage = prev_log_weight + log_nu
        wrapped = ({"nu": log_nu} if values is None else
                   {"latent": values, "nu": log_nu})
        idx, out = resampling._resample(
            first_stage, noise, wrapped, method, implementation,
            need_ancestors)
        base = (torch.logsumexp(first_stage, dim=1, keepdim=True) -
                log_sum[:, None] - out["nu"])
        out = out.get("latent")
    elif values is None:
        idx = resampling.sample_indices(prev_log_weight, noise, method,
                                        implementation)
        out = None
    else:
        idx, out = resampling._resample(prev_log_weight, noise, values,
                                        method, implementation,
                                        need_ancestors)
    if ess_threshold is None:
        return idx, out, base, contribution, None
    # Per row, without a host-side branch: rows whose ESS is below the
    # threshold take the resampled particles; the others keep theirs,
    # with identity ancestors and accumulated weights.
    ess = torch.exp(2 * log_sum - lse(2 * prev_log_weight))
    do = ess < ess_threshold                                     # [B]
    if idx is not None:
        offset = 0 if cloud is None else cloud.offset(idx.shape[1])
        identity = torch.arange(
            offset, offset + prev_log_weight.shape[1], dtype=idx.dtype,
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
    return idx, out, base, contribution, do


def _particle_logsumexp(cloud):
    """logsumexp over the particle axis (dim 1): local, or across the
    particle group of ``cloud``."""
    if cloud is None:
        return lambda x: torch.logsumexp(x, dim=1)
    return cloud.logsumexp


def _callable_step(prev_log_weight, values, noise, time, prev_latents,
                   observations, method, implementation, alpha, lookahead,
                   log_sum, lse):
    """`_resample_step`'s resampling through a callable implementation:
    (ancestral_index, resampled values, base of the next log-weights or
    None)."""
    if method == "soft":
        resampling.check_soft_callable(implementation, alpha)
        idx, base, out = resampling._call(implementation, prev_log_weight,
                                          noise, values, log_sum=log_sum)
        return idx, out, base
    if lookahead is not None:
        log_nu = lookahead(previous_latents=prev_latents, time=time,
                           observations=observations)
        first_stage = prev_log_weight + log_nu
        first_sum = lse(first_stage)
        wrapped = ({"nu": log_nu} if values is None else
                   {"latent": values, "nu": log_nu})
        idx, out = resampling.callable_resample(
            implementation, first_stage.detach(), noise, wrapped,
            first_sum.detach())
        base = first_sum[:, None] - log_sum[:, None] - out["nu"]
        return idx, out.get("latent"), base
    # The resampler's normalization is the log-Z term's logsumexp.
    log_sum = log_sum.detach()
    if values is None:
        return resampling.callable_indices(
            implementation, prev_log_weight.detach(), noise,
            log_sum), None, None
    idx, out = resampling.callable_resample(
        implementation, prev_log_weight.detach(), noise, values, log_sum)
    return idx, out, None


def _infer(inference_algorithm, observations, initial, transition, emission,
           proposal, num_particles, noise=None, lookahead=None,
           resampling_method="systematic", resampling_implementation="auto",
           resampling_criterion="always", soft_resampling_alpha=0.5,
           ot_epsilon=0.5, ot_num_iterations=20, ot_block_size=None,
           ot_rank=None, history_window=1, nan_check=False, remat=False,
           return_log_marginal_likelihood=False, return_latents=True,
           return_original_latents=False, return_log_weight=True,
           return_log_weights=False, return_ancestral_indices=False,
           mesh=None, data_axis="data", particle_axis="particle"):
    """`infer`, returning (result, NaN flag) without reading the flag: a
    device bool that is True when any pre-resampling log-weight was NaN,
    or None when ``nan_check`` is off or the algorithm is 'is'."""
    _check_options(inference_algorithm, resampling_method,
                   resampling_criterion, lookahead, history_window,
                   return_latents, return_original_latents,
                   return_ancestral_indices)
    stacked_obs = stack_observations(observations)
    obs_seq = ObservationSequence(stacked_obs)
    num_timesteps = len(obs_seq)
    first = _first_leaf(stacked_obs)
    batch_size = first.shape[1]
    if noise is None:
        noise = NoiseSource.seeded(0, first.device)
    is_smc = inference_algorithm == "smc"
    cloud = None
    if mesh is not None:
        from .sharding_utils import Cloud
        cloud = Cloud(mesh, data_axis, particle_axis)
    implementation = (_resolve_implementation(
        first.device, resampling_method, resampling_implementation, cloud,
        soft_resampling_alpha) if is_smc or cloud is None else None)
    adaptive = is_smc and resampling_criterion != "always"
    ess_threshold = (float(resampling_criterion) * num_particles
                     if adaptive else None)
    ot_options = (ot_epsilon, ot_num_iterations, ot_block_size, ot_rank)
    window = history_window

    # This rank's particles, and its view of the draws.
    local_k = (num_particles if cloud is None else
               cloud.local_particles(num_particles))
    lse = _particle_logsumexp(cloud)

    def view(source):
        return source if cloud is None else cloud.noise(source)

    # ---- t = 0 (hoisted: `time` is the int 0).
    with annotate("aesmc.smc.initial"):
        proposal_dist = proposal(time=0, observations=obs_seq)
        latent_0 = state.sample(proposal_dist, batch_size, local_k,
                                view(noise))
        proposal_log_prob = state.log_prob(proposal_dist, latent_0)
        initial_log_prob = state.log_prob(initial(), latent_0)
        emission_log_prob = state.log_prob(
            emission(latents=[latent_0], time=0),
            state.expand_observation(obs_seq[0], local_k))
        log_weight_0 = (initial_log_prob + emission_log_prob -
                        proposal_log_prob)

    log_num_particles = _stdmath.log(num_particles)
    # Ancestor indices feed lineage tracing and the ancestral-indices output
    # only; without either the kernel skips computing them (and the stacked
    # indices are then [T-1, 0]). The windowed branch gathers its history
    # with them, so it always needs them.
    need_ancestors = bool(return_latents or return_ancestral_indices or
                          window > 1)
    need_original = return_latents or (is_smc and return_original_latents)
    need_stacked_weights = return_log_weights or not is_smc

    def step(t, prev_latents, prev_log_weight, noise):
        """Time step t >= 1 from the last W original latents: (latent_t,
        log_weight_t, ancestral_index, contribution to log-Z)."""
        time = TimeIndex(t)
        noise = view(noise)
        prev_obs_list = [obs_seq[max(t - window + i, 0)]
                         for i in range(window)]
        ancestral_index = contribution = base = None
        if is_smc:
            ancestral_index, resampled, base, contribution, _ = \
                _resample_step(
                    prev_log_weight,
                    prev_latents[-1] if window == 1 else None, noise, time,
                    prev_latents, obs_seq, resampling_method,
                    implementation, need_ancestors,
                    alpha=soft_resampling_alpha, lookahead=lookahead,
                    ess_threshold=ess_threshold, ot=ot_options, cloud=cloud)
            if window == 1:
                previous_latents = [resampled]
            elif cloud is not None:
                from .parallel import dist_resampling
                previous_latents = [
                    dist_resampling.distributed_resample_particles(
                        x, ancestral_index, cloud.particle_group)
                    for x in prev_latents]
            else:
                previous_latents = [state.resample(x, ancestral_index)
                                    for x in prev_latents]
            if ancestral_index is None:
                ancestral_index = torch.zeros(
                    (0,), dtype=torch.int32, device=first.device)
        else:
            previous_latents = prev_latents
        with annotate("aesmc.smc.propose"):
            proposal_dist = proposal(previous_latents=previous_latents,
                                     time=time, observations=obs_seq)
            latent_t = state.sample(proposal_dist, batch_size, local_k,
                                    noise)
            proposal_lp = state.log_prob(proposal_dist, latent_t)
        with annotate("aesmc.smc.weigh"):
            transition_lp = state.log_prob(
                transition(previous_latents=previous_latents, time=time,
                           previous_observations=prev_obs_list),
                latent_t)
            # The emission sees the un-resampled history and the new
            # latent.
            emission_lp = state.log_prob(
                emission(latents=prev_latents[1:] + [latent_t], time=time,
                         previous_observations=prev_obs_list),
                state.expand_observation(obs_seq[t], local_k))
            # With no base (always-resampling) the new weight is the
            # increment.
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

    with annotate("aesmc.smc.estimate"):
        original_latents = _stack_time(latents) if need_original else None
        stacked_log_weights = (_stack_time(log_weights)
                               if need_stacked_weights else None)
        if is_smc:
            ancestral_indices = (
                torch.stack(ancestors, dim=0) if ancestors else
                torch.zeros((0, batch_size, local_k), dtype=torch.int32,
                            device=first.device))
        else:
            ancestral_indices = None

        # ---- Estimators: AESMC (smc) and IWAE (is) differ in where the
        # logsumexp over particles sits relative to the sum over time.
        if is_smc:
            if return_log_marginal_likelihood:
                summed = (_sum_in_order(contributions) if contributions
                          else 0.0)
                log_marginal_likelihood = (
                    summed + lse(last_log_weight) - log_num_particles)
            else:
                log_marginal_likelihood = None
            if not return_latents:
                traced = None
            elif cloud is None:
                traced = get_resampled_latents(original_latents,
                                               ancestral_indices)
            else:
                traced = _traced_on_mesh(original_latents, ancestral_indices,
                                         cloud)
            log_weight = last_log_weight if return_log_weight else None
        else:
            if return_log_marginal_likelihood or return_log_weight:
                total_log_weight = stacked_log_weights.sum(dim=0)  # [B, K]
            if return_log_marginal_likelihood:
                log_marginal_likelihood = (
                    lse(total_log_weight) - log_num_particles)
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


def _traced_on_mesh(latents, ancestral_indices, cloud):
    """This rank's columns of the lineages traced over the whole particle
    axis: the stacked latents `[T, B_l, K_l, ...]` and the global
    ancestors `[T-1, B_l, K_l]` are gathered over the particle group
    (O(T B_l K) values a rank), traced, and cut back to this rank's
    particles."""
    full = state.tree_map(lambda x: cloud.gather_particles(x, dim=2),
                          latents)
    full_ancestors = (cloud.gather_particles(ancestral_indices, dim=2)
                      if ancestral_indices.shape[0] else ancestral_indices)
    traced = get_resampled_latents(full, full_ancestors)
    k_local = ancestral_indices.shape[2] if ancestral_indices.shape[0] \
        else _first_leaf(latents).shape[2]
    start = cloud.offset(k_local)
    return state.tree_map(lambda x: x[:, :, start:start + k_local], traced)


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
