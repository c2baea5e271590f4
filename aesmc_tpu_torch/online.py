"""Online (streaming) particle filtering, for serving and live inference.

Counterpart of `aesmc_tpu.online`. `inference.infer` consumes a whole
observation sequence; a server gets the observations one at a time and
must update the posterior with each, at bounded latency and O(1) memory:

    init_fn, step_fn = make_online_filter(initial, transition, emission,
                                          proposal, num_particles, ...)
    filter_state = init_fn(y_0, noise)
    for y_t arriving:
        filter_state, info = step_fn(filter_state, y_t, noise)

`step_fn` is a fixed-shape function of tensors: the carry
(`OnlineFilterState`) holds the particles, the weights, the running log-Z
terms, the last observation and the time, all tensors on the device.

Noise. Where the JAX package takes a PRNG key a step (or a row of
`split_step_keys`, which has no counterpart here), `init_fn` and
`step_fn` take a `NoiseSource` and draw from it in `infer`'s order: at
t = 0 the proposal's draw; at each later step the resampling noise, then
the proposal's, then, with ``paris_h``, the backward draws in
`smoothing.paris`'s order. So `init_fn` and T - 1 `step_fn` calls fed one
source give the bits one `infer('smc', ...)` call (or one `paris` call)
gives from the same source: the same ancestors, particles, weights and
log-Z (`infer` sums the log-Z terms in time order, as the carry does).

Time. The carry holds t as a 0-d int32 tensor, and components see a
`inference.DeviceTimeIndex` at t >= 1, whose ``== 0`` is False without a
read (as the JAX package's traced `TimeIndex`): a Python int would be
frozen into a captured step, and reading t back to the host would wait
for the card at every observation.

No host reads. `step_fn` reads nothing back from the device (no
``bool()``, ``.item()`` or ``int()``), so a step captured in a CUDA graph
replays without a wait: the single step, `batched_steps`' S steps, and
their kernels (K1 for systematic resampling, K3 for stratified,
multinomial and soft, K4 and K5 for integer particles). The one exception
is rejection PaRIS (``paris_backward='rejection'``), which reads once a
round how many lanes are still open, as offline: that mode is eager only
and cannot be captured or exported.

Causality: components receive `observations` as a view that returns the
current observation for any index (a stream cannot look ahead);
``previous_observations[-1]`` is y_{t-1}, as in the batch engine.

Several ranks (``mesh``): every rank serves its block of the cloud, its
rows of the batch (`parallel.shard_batch`) and K / particle particles of
each, as `inference.infer(mesh=...)` does: the log-Z terms and the ESS
cross the particle group, the draws are this rank's block of the
single-device run's (`noise.ShardNoise`), and resampling is distributed
(a callable ``resampling_implementation``, or the all-gather exchange of
the same method; 'ot' the ring-streamed Sinkhorn,
`ot.distributed_ot_resample`). Streaming PaRIS gathers the parents, their
weights and statistics once a step and updates this rank's children
(`smoothing`); genealogy tracking gathers the time-0 labels as the lag
buffer is gathered, and sums the family weights over the particle group.
"""

from __future__ import annotations

import io
import json
import math as _stdmath
from typing import Any, NamedTuple

import torch
from torch.utils import _pytree as pytree

from . import resampling, smoothing, state, variance
from .inference import (DeviceTimeIndex,
                        _particle_logsumexp, _resample_step,
                        _resolve_implementation)
from .profiling import annotate
from .sharding_utils import particle_softmax

__all__ = [
    "OnlineFilterState", "make_online_filter", "log_marginal_likelihood",
    "effective_sample_size", "batched_steps", "export_step", "load_step",
    "copy_state_", "CapturedStep",
]


class OnlineFilterState(NamedTuple):
    """The streaming filter's carry: tensors (or dicts of them) on the
    device.

    Attributes:
        latent: particles, leaves `[batch, num_particles, ...]`.
        log_weight: `[batch, num_particles]` unnormalized log-weights.
        log_z_contrib: `[batch]` the resampling steps' log-Z terms summed
            so far (see `log_marginal_likelihood`).
        prev_observation: the last observation consumed, `[batch, ...]`
            (what components see as ``previous_observations[-1]``).
        t: 0-d int32 tensor, the number of observations consumed.
        eve: `[batch, num_particles]` int32 time-0 ancestor labels, or None
            (``track_genealogy``).
        num_events: `[batch]` int32 resampling events, or None.
        lag_buffer: `[L, batch, num_particles, ...]` the last L latents,
            regathered through each step's ancestors, or None
            (``fixed_lag``).
        tau: `[batch, num_particles(, D)]` PaRIS statistics, or None
            (``paris_h``).
    """

    latent: Any
    log_weight: torch.Tensor
    log_z_contrib: torch.Tensor
    prev_observation: Any
    t: torch.Tensor
    eve: Any = None
    num_events: Any = None
    lag_buffer: Any = None
    tau: Any = None


def _cloud(mesh, data_axis="data", particle_axis="particle"):
    if mesh is None:
        return None
    from .sharding_utils import Cloud
    return Cloud(mesh, data_axis, particle_axis)


def _log_z(filter_state, cloud):
    lse = _particle_logsumexp(cloud)
    num_particles = filter_state.log_weight.shape[-1] * (
        1 if cloud is None else cloud.n_particle)
    return (filter_state.log_z_contrib + lse(filter_state.log_weight) -
            _stdmath.log(num_particles))


def log_marginal_likelihood(filter_state: OnlineFilterState, mesh=None,
                            particle_axis: str = "particle"
                            ) -> torch.Tensor:
    """The running log-Z estimate `[batch]` after the observations consumed
    so far: ``sum(contributions) + logsumexp(log_weight) - log K``, the
    batch engine's estimator at the same step. With ``mesh``, of a
    sharded carry (a collective over the particle group)."""
    return _log_z(filter_state, _cloud(mesh, particle_axis=particle_axis))


def effective_sample_size(filter_state: OnlineFilterState, mesh=None,
                          particle_axis: str = "particle") -> torch.Tensor:
    """Kish ESS `[batch]` of the current weights (1 .. num_particles); with
    ``mesh``, of the whole sharded cloud."""
    lse = _particle_logsumexp(_cloud(mesh, particle_axis=particle_axis))
    lw = filter_state.log_weight
    return torch.exp(2 * lse(lw) - lse(2 * lw))


class _CausalObservations:
    """The streaming stand-in for `inference.ObservationSequence`:
    ``obs[t]`` is the current observation for any index."""

    __slots__ = ("current",)

    def __init__(self, current):
        self.current = current

    def __getitem__(self, t):
        return self.current

    def __len__(self):
        raise TypeError(
            "online filtering has no sequence length; components must "
            "not call len(observations) in streaming mode")


def _check_options(resampling_method, resampling_implementation,
                   resampling_criterion, lookahead, return_ancestors,
                   track_genealogy, fixed_lag, paris_h, paris_h0,
                   paris_num_draws, paris_backward, paris_pairwise):
    """The JAX package's ValueErrors."""
    if resampling_method == "soft" and resampling_criterion != "always":
        raise ValueError(
            "soft resampling does not combine with ESS-adaptive "
            "criteria (resample-or-not is already softened)")
    if lookahead is not None and resampling_method in ("soft", "ot"):
        raise ValueError(
            "lookahead does not combine with differentiable "
            f"resampling_method={resampling_method!r}; use a "
            "discrete method (systematic/stratified/multinomial)")
    if resampling_method == "ot":
        if resampling_criterion != "always":
            raise ValueError(
                "resampling_method='ot' does not combine with "
                "ESS-adaptive criteria")
        for flag, what in ((return_ancestors, "ancestor indices are "
                            "unavailable"),
                           (track_genealogy, "genealogy tracking is "
                            "unavailable"),
                           (fixed_lag, "fixed-lag smoothing is "
                            "unavailable")):
            if flag:
                raise ValueError(
                    "resampling_method='ot' transports particles (no "
                    f"discrete ancestors): {what}")
    if fixed_lag < 0:
        raise ValueError(f"fixed_lag must be >= 0. currently = {fixed_lag}")
    if paris_h0 is not None and paris_h is None:
        raise ValueError("paris_h0 requires paris_h")
    if paris_h is not None:
        if paris_num_draws < 1:
            raise ValueError("paris_num_draws must be >= 1. currently = "
                             f"{paris_num_draws}")
        if paris_backward not in ("pairwise", "rejection"):
            raise ValueError("paris_backward must be 'pairwise' or "
                             f"'rejection'. currently = {paris_backward}")
        if paris_pairwise not in ("auto", "broadcast", "vmap"):
            raise ValueError("paris_pairwise must be 'auto', 'broadcast' "
                             f"or 'vmap'. currently = {paris_pairwise}")


def make_online_filter(initial,
                       transition,
                       emission,
                       proposal,
                       num_particles: int,
                       lookahead=None,
                       resampling_method: str = "systematic",
                       resampling_implementation="auto",
                       resampling_criterion="always",
                       soft_resampling_alpha: float = 0.5,
                       ot_epsilon: float = 0.5,
                       ot_num_iterations: int = 20,
                       ot_block_size=None,
                       ot_rank=None,
                       return_ancestors: bool = False,
                       track_genealogy: bool = False,
                       fixed_lag: int = 0,
                       paris_h=None,
                       paris_h0=None,
                       paris_num_draws: int = 2,
                       paris_backward: str = "pairwise",
                       paris_pairwise: str = "auto",
                       paris_transition_log_bound=None,
                       paris_max_rejection_rounds: int = 64,
                       paris_max_exact_lanes=None,
                       mesh=None,
                       data_axis: str = "data",
                       particle_axis: str = "particle"):
    """Builds ``(init_fn, step_fn)`` for streaming SMC.

    The knobs are `infer`'s ('smc' only), with its validation. Components
    are closed over: build the filter again to serve other parameters.

    Args:
        initial, transition, emission, proposal: the components.
        num_particles: K.
        lookahead: the APF's score callable, as in `infer`.
        resampling_method: 'systematic', 'stratified', 'multinomial',
            'residual', 'soft' or 'ot'.
        resampling_implementation: 'auto', 'cuda' or 'torch', or a
            distributed callable of `parallel.dist_resampling` (with
            ``mesh``).
        resampling_criterion: 'always' or an ESS fraction.
        soft_resampling_alpha, ot_epsilon, ot_num_iterations,
            ot_block_size, ot_rank: as in `infer`.
        return_ancestors: add the step's `[batch, K]` ancestor indices to
            ``info`` (off by default: the kernel then skips them).
        track_genealogy: carry the time-0 ancestor labels and the
            resampling-event counts, and report the running Lee-Whiteley
            estimate of the relative variance of log-Z as
            ``info['log_z_rel_var']`` (`variance.log_z_variance`'s
            semantics). Not with 'ot'.
        fixed_lag: L > 0 carries the last L latents, regathered through
            each step's ancestors, and reports ``info['lagged_latent']``
            (the fixed-lag smoothing particles of x_{t-L} under the
            current weights) and ``info['lag_time']`` = t - L (below 0: a
            copy of x_0). Not with 'ot'.
        paris_h, paris_h0, paris_num_draws, paris_backward,
            paris_pairwise, paris_transition_log_bound,
            paris_max_rejection_rounds, paris_max_exact_lanes: streaming
            PaRIS (`smoothing.paris`'s ``h``, ``h0`` and options): the
            carry holds the statistics tau and the step reports the
            current smoothed estimate ``info['paris_smoothed']`` (and,
            with 'rejection', ``paris_accept_rate`` and
            ``paris_unconverged``; that mode reads the host and is eager
            only).
        mesh, data_axis, particle_axis: a `DeviceMesh` and the names of
            its batch and particle axes: this rank serves its block
            (module docstring). ``num_particles`` is the whole cloud's K;
            observations and the carry are this rank's blocks (ancestors
            and genealogy labels as global indices). Every method runs as
            in `inference.infer(mesh=...)`: 'residual' through the
            residual exchange, 'ot' with ``ot_rank`` through the low-rank
            transport on the particle group.

    Returns:
        ``init_fn(observation, noise) -> OnlineFilterState`` consumes y_0
        (`[batch, ...]`); ``step_fn(filter_state, observation, noise) ->
        (OnlineFilterState, info)`` consumes one later observation.
        ``info`` holds 'log_pred' (`[batch]`: log p(y_t | y_{0:t-1}), a
        serving-side anomaly score), 'ess' (`[batch]`, the pre-step
        weights'), 'resampled' (`[batch]` bool) and the optional entries
        above. Both draw from ``noise`` in `infer`'s order (module
        docstring).
    """
    _check_options(resampling_method, resampling_implementation,
                   resampling_criterion, lookahead, return_ancestors,
                   track_genealogy, fixed_lag, paris_h, paris_h0,
                   paris_num_draws, paris_backward, paris_pairwise)
    adaptive = resampling_criterion != "always"
    ess_threshold = (float(resampling_criterion) * num_particles
                     if adaptive else None)
    need_indices = bool(return_ancestors or track_genealogy or fixed_lag > 0)
    ot_options = (ot_epsilon, ot_num_iterations, ot_block_size, ot_rank)
    pairwise_mode = [paris_pairwise]
    cloud = _cloud(mesh, data_axis, particle_axis)
    local_k = (num_particles if cloud is None else
               cloud.local_particles(num_particles))
    lse = _particle_logsumexp(cloud)
    # The resolved implementation (on a mesh the distributed resampler is
    # made once, at the first step).
    resolved = []

    def view(noise):
        return noise if cloud is None else cloud.noise(noise)

    def init_fn(observation, noise) -> OnlineFilterState:
        """Consumes y_0: the batch engine's hoisted t = 0 step (``time``
        is the int 0)."""
        batch_size = resampling._leaves(observation)[0].shape[0]
        obs_view = _CausalObservations(observation)
        proposal_dist = proposal(time=0, observations=obs_view)
        latent_0 = state.sample(proposal_dist, batch_size, local_k,
                                view(noise))
        proposal_lp = state.log_prob(proposal_dist, latent_0)
        initial_lp = state.log_prob(initial(), latent_0)
        emission_lp = state.log_prob(
            emission(latents=[latent_0], time=0),
            state.expand_observation(observation, local_k))
        log_weight_0 = initial_lp + emission_lp - proposal_lp
        device = log_weight_0.device
        eve = num_events = lag_buffer = tau = None
        if track_genealogy:
            offset = 0 if cloud is None else cloud.offset(local_k)
            eve = torch.arange(offset, offset + local_k, dtype=torch.int32,
                               device=device).expand(
                                   batch_size, local_k).contiguous()
            num_events = torch.zeros((batch_size,), dtype=torch.int32,
                                     device=device)
        if fixed_lag > 0:
            lag_buffer = state.tree_map(
                lambda x: x[None].expand((fixed_lag,) + tuple(x.shape))
                .contiguous(), latent_0)
        if paris_h is not None:
            # A copy: an h0 such as `lambda x0: x0` would otherwise make
            # tau the latent's own tensor, and a carry updated in place
            # would then write one tensor twice.
            tau = (paris_h0(latent_0).clone() if paris_h0 is not None else
                   torch.zeros_like(log_weight_0))
            if pairwise_mode[0] == "auto" and paris_backward == "pairwise":
                pairwise_mode[0] = smoothing._resolve_pairwise_mode(
                    transition, latent_0, observation)
        return OnlineFilterState(
            latent=latent_0, log_weight=log_weight_0,
            log_z_contrib=torch.zeros((batch_size,),
                                      dtype=log_weight_0.dtype,
                                      device=device),
            prev_observation=observation,
            t=torch.ones((), dtype=torch.int32, device=device),
            eve=eve, num_events=num_events, lag_buffer=lag_buffer, tau=tau)

    def step_fn(filter_state: OnlineFilterState, observation, noise):
        """Consumes one observation y_t (t >= 1): one filter update."""
        prev_latent = filter_state.latent
        prev_log_weight = filter_state.log_weight
        batch_size = prev_log_weight.shape[0]
        time = DeviceTimeIndex(filter_state.t)
        obs_view = _CausalObservations(observation)
        prev_obs_list = [filter_state.prev_observation]
        noise = view(noise)
        if cloud is None or not resolved:
            resolved[:] = [_resolve_implementation(
                prev_log_weight.device, resampling_method,
                resampling_implementation, cloud, soft_resampling_alpha)]
        implementation = resolved[0]
        # log_marginal_likelihood and effective_sample_size of the carry,
        # sharing one logsumexp with the resampling step.
        log_sum = lse(prev_log_weight)
        log_pred_base = (filter_state.log_z_contrib + log_sum -
                         _stdmath.log(num_particles))
        pre_ess = torch.exp(2 * log_sum - lse(2 * prev_log_weight))

        ancestral_index, previous_latent, base, contribution, do = \
            _resample_step(
                prev_log_weight, prev_latent, noise, time, [prev_latent],
                obs_view, resampling_method, implementation, need_indices,
                alpha=soft_resampling_alpha, lookahead=lookahead,
                ess_threshold=ess_threshold, ot=ot_options, log_sum=log_sum,
                cloud=cloud)
        did_resample = (torch.ones((batch_size,), dtype=torch.bool,
                                   device=prev_log_weight.device)
                        if do is None else do)

        with annotate("aesmc.smc.propose"):
            proposal_dist = proposal(previous_latents=[previous_latent],
                                     time=time, observations=obs_view)
            latent_t = state.sample(proposal_dist, batch_size, local_k,
                                    noise)
            proposal_lp = state.log_prob(proposal_dist, latent_t)
        with annotate("aesmc.smc.weigh"):
            transition_lp = state.log_prob(
                transition(previous_latents=[previous_latent], time=time,
                           previous_observations=prev_obs_list),
                latent_t)
            emission_lp = state.log_prob(
                emission(latents=[latent_t], time=time,
                         previous_observations=prev_obs_list),
                state.expand_observation(observation, local_k))
            # `infer`'s arithmetic, in its order: the same bits.
            log_weight_t = transition_lp + emission_lp - proposal_lp
            if base is not None:
                log_weight_t = base + log_weight_t

        eve = num_events = lag_buffer = tau = None
        info = {}
        if track_genealogy:
            # On a mesh the ancestors are global: the labels of the whole
            # particle axis are gathered first, as the lag buffer is.
            eve = torch.take_along_dim(
                filter_state.eve if cloud is None else
                cloud.gather_particles(filter_state.eve),
                ancestral_index.long(), dim=1)
            num_events = filter_state.num_events + did_resample.to(
                torch.int32)
        if paris_h is not None:
            # The statistic's update over the pre-resampling parents.
            tau, paris_acc, paris_unconv = smoothing._paris_backward_update(
                noise, prev_latent, prev_log_weight, latent_t,
                filter_state.tau, transition, time, prev_obs_list, paris_h,
                paris_num_draws, paris_backward, pairwise_mode[0],
                paris_transition_log_bound, paris_max_rejection_rounds,
                paris_max_exact_lanes, cloud=cloud)
        if fixed_lag > 0:
            # Regather the whole buffer with this step's ancestors (so
            # buffer[0] is x_{t-L} traced to the current particles), report
            # the oldest entry, shift in x_t.
            # On a mesh the ancestors are global: the buffer's whole
            # particle axis is gathered first.
            gathered = state.tree_map(
                lambda x: torch.take_along_dim(
                    x if cloud is None else cloud.gather_particles(x, dim=2),
                    ancestral_index.long().reshape(
                        (1,) + tuple(ancestral_index.shape) +
                        (1,) * (x.ndim - 3)), dim=2),
                filter_state.lag_buffer)
            info["lagged_latent"] = state.tree_map(lambda x: x[0], gathered)
            info["lag_time"] = filter_state.t - fixed_lag
            lag_buffer = _shift_in(gathered, latent_t)

        new_state = OnlineFilterState(
            latent=latent_t, log_weight=log_weight_t,
            log_z_contrib=filter_state.log_z_contrib + contribution,
            prev_observation=observation, t=filter_state.t + 1, eve=eve,
            num_events=num_events, lag_buffer=lag_buffer, tau=tau)
        info.update({
            "log_pred": _log_z(new_state, cloud) - log_pred_base,
            "ess": pre_ess,
            "resampled": did_resample,
        })
        if paris_h is not None or track_genealogy:
            w = particle_softmax(log_weight_t, cloud)
        if paris_h is not None:
            smoothed = torch.einsum("bk,bk...->b...", w, tau)
            info["paris_smoothed"] = (smoothed if cloud is None else
                                      cloud.particle_sum(smoothed))
            if paris_backward == "rejection":
                info["paris_accept_rate"] = paris_acc
                info["paris_unconverged"] = paris_unconv
        if track_genealogy:
            if cloud is None:
                s = variance._family_sums(w, eve)
            else:
                # Family labels are global: this rank's weights land in a
                # [B_l, K] table, summed over the particle group.
                s = cloud.particle_sum(torch.zeros(
                    (batch_size, num_particles), dtype=w.dtype,
                    device=w.device).scatter_add_(1, eve.long(), w))
            cross = 1.0 - (s * s).sum(dim=-1)
            factor = (num_particles / (num_particles - 1.0)) ** (
                num_events.to(log_weight_t.dtype) + 1.0)
            info["log_z_rel_var"] = torch.clamp(1.0 - factor * cross,
                                                min=0.0)
        if return_ancestors:
            info["ancestral_index"] = ancestral_index
        return new_state, info

    step_fn.eager_only = paris_h is not None and paris_backward == "rejection"
    return init_fn, step_fn


def _shift_in(buffer, latent):
    """``buffer[1:]`` followed by ``latent``, leaf by leaf."""
    if isinstance(buffer, dict):
        return {k: _shift_in(buffer[k], latent[k]) for k in buffer}
    return torch.cat([buffer[1:], latent[None]], dim=0)


def _stack_infos(infos):
    """A list of per-step info dicts -> one dict, each entry stacked on a
    leading `[S]` axis."""
    return pytree.tree_map(lambda *xs: torch.stack(xs, dim=0), *infos)


def batched_steps(step_fn):
    """Micro-batched serving: S buffered observations in one call.

    Wraps a `make_online_filter` ``step_fn`` into ``batched(filter_state,
    observations, noise) -> (filter_state, infos)``, where
    ``observations`` is `[S, batch, ...]` and every entry of ``infos``
    has a leading `[S]` axis (so ``log_pred`` stays per observation). The
    S updates are S `step_fn` calls in order, drawing from ``noise`` as
    S calls would: the same bits. Captured in one CUDA graph, the S
    updates are one launch from the host, the counterpart of the JAX
    package's S updates in one dispatch.
    """
    def batched(filter_state, observations, noise):
        num_steps = resampling._leaves(observations)[0].shape[0]
        infos = []
        for s in range(num_steps):
            filter_state, info = step_fn(
                filter_state, state.tree_map(lambda x: x[s], observations),
                noise)
            infos.append(info)
        return filter_state, _stack_infos(infos)

    return batched


def copy_state_(target: OnlineFilterState, source: OnlineFilterState):
    """Copies every tensor of ``source`` into the same field of ``target``,
    in place: how a step captured in a CUDA graph carries its state from
    one replay to the next. Returns ``target``."""
    for dst, src in zip(pytree.tree_leaves(_fields(target)),
                        pytree.tree_leaves(_fields(source))):
        if dst is not src:
            dst.copy_(src)
    return target


def _clone(tree):
    return pytree.tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


class CapturedStep:
    """A step (a `make_online_filter` ``step_fn``, or `batched_steps` of
    one) captured in a CUDA graph: each call copies the observation into
    the graph's input buffer and replays it, and the step updates the
    carry ``state`` in place. On the card only.

    The step is warmed up twice first (the carry and the generator's
    state are put back after), then captured
    with ``noise``'s generator registered, so every replay draws fresh
    noise, as the next eager call would from the same generator state.
    The returned info's tensors are the graph's outputs: the next replay
    overwrites them. Rejection PaRIS reads the host and cannot be
    captured.
    """

    def __init__(self, step_fn, filter_state: OnlineFilterState,
                 observation, noise):
        from . import train
        if getattr(step_fn, "eager_only", False):
            raise ValueError(
                "paris_backward='rejection' reads the host once a round "
                "and cannot be captured in a CUDA graph; use 'pairwise'")
        self.state = _clone(filter_state)
        self.observation = _clone(observation)

        def run():
            new_state, info = step_fn(self.state, self.observation, noise)
            copy_state_(self.state, new_state)
            return info

        generator_state = noise.generator.get_state()
        with torch.no_grad():
            train._warm_up(run, 2)
            copy_state_(self.state, filter_state)
            noise.generator.set_state(generator_state)
            self.graph, self.info = train._capture(run, noise.generator)

    def __call__(self, observation):
        with annotate("aesmc.online.copy_in"):
            for dst, src in zip(pytree.tree_leaves(self.observation),
                                pytree.tree_leaves(observation)):
                dst.copy_(src)
        with annotate("aesmc.online.replay"):
            self.graph.replay()
        return self.info


class _ShapeRecorder:
    """A noise source that records the kind and shape of every draw and
    hands out fills of 0.5 on ``like``'s device (valid noise of each
    kind)."""

    def __init__(self, like):
        self.like = like
        self.draws = []

    @property
    def device(self):
        return self.like.device

    def _draw(self, kind, shape):
        self.draws.append((kind, [int(n) for n in shape]))
        return self.like.new_full(tuple(shape), 0.5)

    def uniform(self, shape):
        return self._draw("uniform", shape)

    def exponential(self, shape):
        return self._draw("exponential", shape)

    def normal(self, shape):
        return self._draw("normal", shape)

    def gumbel(self, shape):
        return self._draw("gumbel", shape)


class _GivenNoise:
    """A noise source that hands out given tensors, in order."""

    def __init__(self, draws, device):
        self._draws = list(draws)
        self.device = device

    def _next(self, shape):
        x = self._draws.pop(0)
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"noise draw of shape {tuple(x.shape)} where "
                             f"the step asks for {tuple(shape)}")
        return x

    uniform = exponential = normal = gumbel = _next


class _StepProgram(torch.nn.Module):
    """The step as a module of flat tensors: the carry's and the
    observation's leaves, then the noise draws, in; the new carry's and the
    info's leaves out."""

    def __init__(self, step_fn, in_spec, num_inputs):
        super().__init__()
        self.step_fn = step_fn
        self.in_spec = in_spec
        self.num_inputs = num_inputs

    def forward(self, *flat):
        carry, observation = pytree.tree_unflatten(
            list(flat[:self.num_inputs]), self.in_spec)
        noise = _GivenNoise(flat[self.num_inputs:], flat[0].device)
        new_state, info = self.step_fn(OnlineFilterState(**carry),
                                       observation, noise)
        out = pytree.tree_leaves((_fields(new_state), info))
        # An output that is an input (the observation becomes the carry's
        # prev_observation) leaves the program as a copy.
        return tuple(o.clone() if any(o is i for i in flat) else o
                     for o in out)


_META = "aesmc_online_step.json"


def _fields(filter_state):
    """The carry's fields that are not None, as a dict (the pytree that
    the exported program takes and returns)."""
    return {name: value for name, value in filter_state._asdict().items()
            if value is not None}


def export_step(step_fn, filter_state: OnlineFilterState,
                observation) -> bytes:
    """Serializes a streaming step with `torch.export` (the JAX package
    uses `jax.export`).

    The program is traced at the example arguments' shapes, dtypes and
    device: the parameters are baked in as constants, and on the card the
    resampling kernel is recorded as its operator (K1 as
    ``aesmc_tpu_torch::resample_systematic``, K3, K4 and K5 likewise),
    never its plain version. It takes its noise as tensor inputs, the
    draws `step_fn` makes in its order (the JAX artifact takes the key);
    their kinds and shapes are recorded beside the program by one eager
    call of ``step_fn`` on the example arguments, with fills for noise.
    Rejection PaRIS reads the host and cannot be exported.

    Unlike the JAX artifact, which needs no model code, loading needs this
    package: `load_step` imports it, which registers the kernels'
    operators.

    Returns:
        bytes: `torch.export.save`'s archive; load it with `load_step`.
    """
    if getattr(step_fn, "eager_only", False):
        raise ValueError(
            "paris_backward='rejection' reads the host once a round and "
            "cannot be exported; use 'pairwise'")
    flat, in_spec = pytree.tree_flatten((_fields(filter_state), observation))
    recorder = _ShapeRecorder(filter_state.log_weight)
    with torch.no_grad():
        new_state, info = step_fn(filter_state, observation, recorder)
    out_spec = pytree.tree_structure((_fields(new_state), info))
    draws = [filter_state.log_weight.new_full(tuple(shape), 0.5)
             for _, shape in recorder.draws]
    program = torch.export.export(
        _StepProgram(step_fn, in_spec, len(flat)), tuple(flat) + tuple(draws))
    meta = {"draws": recorder.draws,
            "out_spec": pytree.treespec_dumps(out_spec)}
    buffer = io.BytesIO()
    torch.export.save(program, buffer, extra_files={_META: json.dumps(meta)})
    return buffer.getvalue()


def load_step(blob: bytes):
    """Loads `export_step`'s bytes into ``step(filter_state, observation,
    noise) -> (filter_state, info)``: it draws the program's noise tensors
    from the `NoiseSource` ``noise`` (the kinds and shapes recorded at
    export, in order) and runs the program."""
    extra = {_META: ""}
    program = torch.export.load(io.BytesIO(blob), extra_files=extra).module()
    meta = json.loads(extra[_META])
    out_spec = pytree.treespec_loads(meta["out_spec"])
    draws = [(kind, tuple(shape)) for kind, shape in meta["draws"]]

    def step(filter_state, observation, noise):
        flat = pytree.tree_leaves((_fields(filter_state), observation))
        noise_tensors = [getattr(noise, kind)(shape) for kind, shape in draws]
        out = program(*flat, *noise_tensors)
        carry, info = pytree.tree_unflatten(list(out), out_spec)
        return OnlineFilterState(**carry), info

    return step
