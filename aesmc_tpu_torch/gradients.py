"""Unbiased score-function (REINFORCE) gradients for the SMC objective.

Counterpart of `aesmc_tpu.gradients`. The default AESMC gradient stops at
the ancestor indices, so its estimate of grad E[log Z-hat] is biased: the
resampling distribution itself depends on the parameters through the
weights. The full estimator adds the score of the ancestor draws,

    grad E[log Z]
      = E[ grad log Z  +  sum_t (sum_k grad log wbar_{t-1}[a_t^k]) * G_t ]

with wbar_{t-1} the normalized resampling weights, a_t^k the sampled
ancestors and G_t the advantage: the sum of the future per-step log-Z
contributions (causality), less a baseline independent of the row's own
ancestor draws (the leave-one-out mean over the other batch rows).

It needs multinomial resampling at every step: multinomial ancestors are
iid categorical draws with a tractable density; systematic and
stratified ancestors share their uniforms and have none. Everything is
computed from the engine's outputs (per-step log-weights and ancestor
indices), with no special engine mode; on the 'cuda' route the
multinomial resampling of `infer` is K3 forward and K2 backward. On a
mesh (`score_surrogate_from_result(cloud=)`) the reductions over the
particles and the batch cross the mesh's groups.
"""

from __future__ import annotations

import math as _stdmath

import torch

from . import inference
from .sharding_utils import (batch_mean, cloud_of, particle_gather,
                             particle_logsumexp, particle_sum)

__all__ = ["score_gradient_loss", "score_surrogate_from_result"]

BASELINES = ("batch", "none")


def score_surrogate_from_result(result: dict, baseline: str = "batch",
                                cloud=None):
    """The surrogate loss from an `infer` result dict.

    Args:
        result: output of `inference.infer('smc', ...,
            resampling_method='multinomial', resampling_criterion='always',
            return_log_weights=True, return_ancestral_indices=True)`.
        baseline: 'batch' (leave-one-out mean of the future contribution
            sums across the batch; 'none' at batch size 1) or 'none'.
        cloud: this rank's `sharding_utils.Cloud` when ``result`` came
            from `infer(mesh=...)` (this rank's blocks `[T, B_l, K_l]`,
            global ancestors), or None. The logsumexps and the sum over
            particles then cross the particle group, the score gathers
            `lognorm[:-1]` over it (O(T B_l K) a rank, differentiable),
            the 'batch' baseline totals the global batch (one data-group
            all-reduce) and the mean crosses the data group.

    Returns:
        scalar tensor whose value is ``-mean(log Z)`` (the score term is
        cancelled in value, exactly, by a detached copy) and whose
        gradient is the unbiased score-function estimator; on a mesh the
        global batch's, the same on every rank.
    """
    if baseline not in BASELINES:
        raise ValueError(
            f"baseline must be one of {BASELINES}. currently = {baseline}")
    log_weights = result["log_weights"]              # [T, B, K] increments
    anc = result["ancestral_indices"]                # [T-1, B, K]
    if log_weights is None or anc is None:
        raise ValueError(
            "score surrogate needs return_log_weights=True and "
            "return_ancestral_indices=True on the infer call")
    num_timesteps, batch_size, num_particles = log_weights.shape
    if cloud is not None:
        num_particles *= cloud.n_particle
        batch_size *= cloud.n_data

    # Per-step log-Z contributions: the logmeanexp of each step's
    # increments (the engine's own decomposition under always-resampling).
    log_sum = particle_logsumexp(log_weights, cloud, dim=2).unsqueeze(2)
    contributions = log_sum[..., 0] - _stdmath.log(num_particles)  # [T, B]
    log_z = contributions.sum(dim=0)                              # [B]
    if num_timesteps == 1:
        return -batch_mean(log_z, cloud)

    # G_t: future contribution sums. Ancestors anc[i] are drawn at step
    # i + 1 from the weights of step i, so they sum contributions from
    # step i + 1 on.
    future = torch.flip(torch.cumsum(torch.flip(contributions, [0]), dim=0),
                        [0])[1:]                                  # [T-1, B]

    # Score: sum_k log wbar_{t-1}[a_t^k], differentiable through the
    # gathered normalized log-weights.
    lognorm = log_weights - log_sum                               # [T, B, K]
    gathered = torch.take_along_dim(
        particle_gather(lognorm[:-1], cloud, dim=2), anc.long(), dim=2)
    score_steps = particle_sum(gathered, cloud, dim=2)            # [T-1, B]

    if baseline == "batch" and batch_size > 1:
        # Leave-one-out mean over the other batch rows: independent of
        # this row's ancestor draws, hence exactly unbiased.
        total = future.detach().sum(dim=1, keepdim=True)
        if cloud is not None:
            total = cloud.batch_sum(total)
        b = (total - future) / (batch_size - 1)
    else:
        b = torch.zeros_like(future)
    advantage = (future - b).detach()

    score_term = (score_steps * advantage).sum(dim=0)             # [B]
    # The difference is exactly 0 in value, so the value is log Z's bits;
    # (log_z + score_term) - score_term would round at the magnitude of
    # the score term (thousands of nats at T = 200).
    surrogate = log_z + (score_term - score_term.detach())
    return -batch_mean(surrogate, cloud)


def _check_options(resampling_method, resampling_criterion, lookahead):
    """The JAX package's ValueErrors for options the estimator refuses."""
    if resampling_method != "multinomial":
        raise ValueError(
            "the score-function gradient requires "
            "resampling_method='multinomial' (iid categorical ancestors "
            "with a tractable index density); systematic/stratified "
            f"have none. currently = {resampling_method!r}")
    if resampling_criterion != "always":
        raise ValueError(
            "the score-function gradient requires "
            "resampling_criterion='always' (carried-weight rows change "
            "the per-step contribution decomposition). "
            f"currently = {resampling_criterion!r}")
    if lookahead is not None:
        raise ValueError(
            "lookahead (auxiliary PF) twists the ancestor distribution; "
            "its score term is not implemented")


def score_gradient_loss(observations, num_particles: int, initial,
                        transition, emission, proposal, noise=None,
                        baseline: str = "batch", **infer_kwargs):
    """``-mean(ELBO_AESMC)`` with the unbiased score-function gradient.

    The alternative to ``losses.get_loss(..., algorithm='aesmc')`` (or
    pass ``gradient_estimator='score'`` there): the loss value is the
    multinomial AESMC loss on the same noise; only the gradient differs,
    by the score term of the ancestor draws.

    ``infer_kwargs`` go to `inference.infer`: ``resampling_method``
    defaults to (and must stay) 'multinomial', ``resampling_criterion``
    must stay 'always', and ``lookahead`` is refused (the auxiliary
    filter's ancestor distribution needs another score). With ``mesh``
    (and its axis names) the surrogate is the global batch's
    (`score_surrogate_from_result`'s ``cloud``).
    """
    method = infer_kwargs.pop("resampling_method", "multinomial")
    criterion = infer_kwargs.pop("resampling_criterion", "always")
    _check_options(method, criterion, infer_kwargs.get("lookahead"))
    cloud = cloud_of(infer_kwargs.get("mesh"), None,
                     infer_kwargs.get("data_axis", "data"),
                     infer_kwargs.get("particle_axis", "particle"))
    result = inference.infer(
        "smc", observations, initial, transition, emission, proposal,
        num_particles, noise=noise, resampling_method="multinomial",
        return_log_marginal_likelihood=False, return_latents=False,
        return_log_weight=False, return_log_weights=True,
        return_ancestral_indices=True, **infer_kwargs)
    return score_surrogate_from_result(result, baseline=baseline,
                                       cloud=cloud)
