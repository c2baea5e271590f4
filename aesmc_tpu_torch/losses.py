"""Differentiable ELBO objectives.

Counterpart of `aesmc_tpu.losses`: `get_loss` maps 'iwae' to importance
sampling and 'aesmc' to SMC, runs `inference.infer` for the log marginal
likelihood only, and returns ``-mean(log Z)`` over the batch, a scalar
tensor to call `.backward()` on; 'tmc' is the Tensor Monte Carlo
estimator (`tmc`: every K^T path, no resampling). `get_loss_and_metrics`
adds the mean ELBO and the mean effective sample size of the final
weights (NaN for 'tmc', which has no particle weights). `checked_loss`
is `get_loss` with the NaN guard deferred: it returns an error value that
reads the guard's device flag only when asked.

Gradients flow through the reparameterized proposal samples and every
log-probability, but not through ancestor indices (the engine detaches
them): the reference's AESMC gradient semantics. Soft resampling
(``resampling_method='soft'``) also carries the gradient of the weights
through its corrected log-weights. On the card the resampling gradient is
the range-sum kernel (K2). ``gradient_estimator='score'`` ('aesmc' with
multinomial resampling) adds the score-function term of the ancestor
draws, which makes the gradient of E[log Z] unbiased (`gradients`); the
loss value stays the same.

With ``mesh`` (several ranks, `parallel`) every rank runs the objective
on its block: 'iwae' and 'aesmc' through `inference.infer(mesh=...)`,
'tmc' through `tmc.tmc_log_marginal_likelihood(cloud=...)` (the parents
and their f all-gathered over the particle group a step), the score
estimator through `gradients.score_surrogate_from_result(cloud=...)`
(the score's log-weights gathered over the particle group, the baseline
over the global batch). The batch mean crosses the data group, so every
rank returns the same loss. The average over the mesh's ranks of the
gradients their backward passes give is the single-device gradient
(`parallel.make_sharded_train_step` takes it).
"""

from __future__ import annotations

import torch

from . import gradients, inference, statistics, tmc
from .sharding_utils import batch_mean

ALGORITHMS = ("iwae", "aesmc", "tmc")


def _check_estimator(algorithm, gradient_estimator, resampling_method,
                     resampling_criterion, lookahead, with_metrics):
    """The JAX package's ValueErrors for ``gradient_estimator``: those of
    `get_loss` (`gradients.score_gradient_loss`'s), or those of
    `get_loss_and_metrics` with ``with_metrics``."""
    if gradient_estimator not in ("pathwise", "score"):
        raise ValueError(
            "gradient_estimator must be 'pathwise' or 'score'. "
            f"currently = {gradient_estimator}")
    if gradient_estimator == "pathwise":
        return
    if with_metrics:
        if algorithm != "aesmc":
            raise ValueError(
                "gradient_estimator='score' only applies to "
                f"algorithm='aesmc' (currently = {algorithm})")
        if resampling_method != "multinomial":
            raise ValueError(
                "gradient_estimator='score' requires "
                "resampling_method='multinomial' (see "
                "aesmc_tpu_torch.gradients)")
        if resampling_criterion != "always":
            raise ValueError(
                "gradient_estimator='score' requires "
                "resampling_criterion='always'")
    elif algorithm != "aesmc":
        raise ValueError(
            "gradient_estimator='score' corrects the RESAMPLING "
            "gradient; it only applies to algorithm='aesmc' "
            f"(currently = {algorithm}). IWAE's pathwise gradient "
            "is already unbiased.")
    gradients._check_options(resampling_method, resampling_criterion,
                             lookahead)


def _inference_algorithm(algorithm):
    if algorithm == "iwae":
        return "is"
    if algorithm == "aesmc":
        return "smc"
    raise ValueError(
        f"algorithm must be one of {ALGORITHMS}. currently = {algorithm}")


def _objective(observations, num_particles, algorithm, initial, transition,
               emission, proposal, noise=None,
               resampling_method="systematic",
               resampling_implementation="auto",
               resampling_criterion="always", soft_resampling_alpha=0.5,
               ot_epsilon=0.5, ot_num_iterations=20, ot_block_size=None,
               ot_rank=None, lookahead=None, history_window=1, remat=False,
               gradient_estimator="pathwise", score_baseline="batch",
               pairwise="auto", block_size=None, nan_check=False,
               with_metrics=False, mesh=None, data_axis="data",
               particle_axis="particle"):
    """(loss, metrics or None, NaN flag): the flag is a device bool left
    unread (None when nothing was checked): `inference._infer`'s, or for
    'tmc' whether the loss is NaN."""
    cloud = None
    if mesh is not None:
        from .sharding_utils import Cloud
        cloud = Cloud(mesh, data_axis, particle_axis)
    if algorithm == "tmc":
        # Tensor Monte Carlo: no resampling, so the resampling_* options
        # and the estimator do not apply; always rematerialized (the
        # backward would otherwise keep T [B, K, K] tiles).
        elbo = batch_mean(tmc.tmc_log_marginal_likelihood(
            observations, initial, transition, emission, proposal,
            num_particles, noise=noise, remat=True, pairwise=pairwise,
            block_size=block_size, cloud=cloud), cloud)
        metrics = None
        if with_metrics:
            # No particle weights: the ESS is NaN (a fill on the device).
            metrics = {"elbo": elbo.detach(), "ess": torch.full(
                (), float("nan"), dtype=elbo.dtype, device=elbo.device)}
        # TMC has no resampling step to guard: one check of the loss.
        has_nan = torch.isnan(elbo.detach()) if nan_check else None
        return -elbo, metrics, has_nan
    inference_algorithm = _inference_algorithm(algorithm)
    _check_estimator(algorithm, gradient_estimator, resampling_method,
                     resampling_criterion, lookahead, with_metrics)
    score = gradient_estimator == "score"
    result, has_nan = inference._infer(
        inference_algorithm, observations, initial, transition,
        emission, proposal, num_particles, noise=noise, lookahead=lookahead,
        resampling_method=resampling_method,
        resampling_implementation=resampling_implementation,
        resampling_criterion=resampling_criterion,
        soft_resampling_alpha=soft_resampling_alpha, ot_epsilon=ot_epsilon,
        ot_num_iterations=ot_num_iterations, ot_block_size=ot_block_size,
        ot_rank=ot_rank, history_window=history_window, nan_check=nan_check,
        remat=remat, return_log_marginal_likelihood=True,
        return_latents=False, return_log_weight=with_metrics,
        return_log_weights=score, return_ancestral_indices=score,
        mesh=mesh, data_axis=data_axis, particle_axis=particle_axis)
    log_z = result["log_marginal_likelihood"]
    elbo = batch_mean(log_z, cloud)
    metrics = None
    if with_metrics:
        if cloud is None:
            ess = statistics.ess(result["log_weight"])
        else:
            lw = result["log_weight"]
            ess = torch.exp(2 * cloud.logsumexp(lw) - cloud.logsumexp(2 * lw))
        metrics = {"elbo": elbo.detach(),
                   "ess": batch_mean(ess, cloud).detach()}
    if score:
        return (gradients.score_surrogate_from_result(
            result, score_baseline, cloud=cloud), metrics, has_nan)
    return -elbo, metrics, has_nan


def get_loss(observations, num_particles: int, algorithm: str, initial,
             transition, emission, proposal, noise=None,
             resampling_method: str = "systematic",
             resampling_implementation: str = "auto",
             resampling_criterion="always",
             soft_resampling_alpha: float = 0.5,
             ot_epsilon: float = 0.5,
             ot_num_iterations: int = 20,
             ot_block_size=None,
             ot_rank=None,
             lookahead=None,
             history_window: int = 1,
             remat: bool = False,
             gradient_estimator: str = "pathwise",
             score_baseline: str = "batch",
             pairwise: str = "auto",
             block_size=None,
             nan_check: bool = False,
             mesh=None,
             data_axis: str = "data",
             particle_axis: str = "particle"):
    """Scalar loss ``-mean(ELBO)`` for gradient descent.

    Args:
        observations: list of `[batch, ...]` values or stacked
            `[T, batch, ...]` value (see `inference.infer`).
        num_particles: int.
        algorithm: 'iwae' (IS estimator), 'aesmc' (SMC estimator) or
            'tmc' (Tensor Monte Carlo, `tmc`: every K^T path, fully
            differentiable; always rematerialized, the resampling_*
            options ignored).
        initial, transition, emission, proposal: user components.
        noise: the `NoiseSource` of every draw (see `inference.infer`).
        resampling_method, resampling_implementation,
            resampling_criterion, soft_resampling_alpha, ot_epsilon,
            ot_num_iterations, ot_block_size, ot_rank, lookahead:
            forwarded to `infer` ('aesmc' only; 'soft' and 'ot' are
            differentiable resampling).
        history_window, remat: forwarded to `infer`.
        gradient_estimator: 'pathwise' (the reference's semantics:
            gradients stop at the ancestor indices) or 'score' ('aesmc'
            with ``resampling_method='multinomial'`` and
            ``resampling_criterion='always'`` only, no lookahead): adds the
            score-function term of the ancestor draws (`gradients`). The
            loss value is the same either way.
        score_baseline: the score term's baseline, 'batch' or 'none'.
        pairwise, block_size: the 'tmc' estimator's (see `tmc`).
        nan_check: raise FloatingPointError when a resampling step saw a
            NaN log-weight ('aesmc'), or the 'tmc' loss is NaN (one read
            of the device).
        mesh, data_axis, particle_axis: run on this rank's block of a
            `DeviceMesh` (module docstring; every algorithm and
            estimator): ``observations`` are this rank's rows,
            ``num_particles`` the whole cloud's, and the loss is the
            global batch mean, the same on every rank.

    Returns:
        scalar tensor.
    """
    loss, _, has_nan = _objective(
        observations, num_particles, algorithm, initial, transition,
        emission, proposal, noise=noise,
        resampling_method=resampling_method,
        resampling_implementation=resampling_implementation,
        resampling_criterion=resampling_criterion,
        soft_resampling_alpha=soft_resampling_alpha, ot_epsilon=ot_epsilon,
        ot_num_iterations=ot_num_iterations, ot_block_size=ot_block_size,
        ot_rank=ot_rank, lookahead=lookahead,
        history_window=history_window, remat=remat,
        gradient_estimator=gradient_estimator, score_baseline=score_baseline,
        pairwise=pairwise, block_size=block_size, nan_check=nan_check,
        mesh=mesh, data_axis=data_axis, particle_axis=particle_axis)
    inference._raise_if_nan(has_nan)
    return loss


class CheckError:
    """The error value of `checked_loss`: holds the NaN guard's device flag
    and reads it only when `get` or `throw` is called."""

    def __init__(self, has_nan):
        self._has_nan = has_nan

    def get(self):
        """None, or the message of the NaN a resampling step saw."""
        if self._has_nan is not None and bool(self._has_nan):
            return inference.NAN_MESSAGE
        return None

    def throw(self) -> None:
        """Raises FloatingPointError with `get`'s message, if any."""
        inference._raise_if_nan(self._has_nan)


def checked_loss(observations, num_particles: int, algorithm: str,
                 initial, transition, emission, proposal, noise=None,
                 **kwargs):
    """`get_loss` with the NaN guard deferred: returns ``(error, loss)``.

    ``error`` is a `CheckError`; ``error.get()`` gives None or a message
    containing "nan", ``error.throw()`` raises FloatingPointError. Nothing
    waits for the device until one of them is called. ``kwargs`` are
    `get_loss`'s (``nan_check`` is always on).
    """
    kwargs.pop("nan_check", None)
    loss, _, has_nan = _objective(
        observations, num_particles, algorithm, initial, transition,
        emission, proposal, noise=noise, nan_check=True, **kwargs)
    return CheckError(has_nan), loss


def get_loss_and_metrics(observations, num_particles: int, algorithm: str,
                         initial, transition, emission, proposal,
                         noise=None, resampling_method: str = "systematic",
                         resampling_implementation: str = "auto",
                         resampling_criterion="always",
                         soft_resampling_alpha: float = 0.5,
                         ot_epsilon: float = 0.5,
                         ot_num_iterations: int = 20,
                         ot_block_size=None,
                         ot_rank=None,
                         lookahead=None,
                         history_window: int = 1,
                         remat: bool = False,
                         gradient_estimator: str = "pathwise",
                         score_baseline: str = "batch",
                         pairwise: str = "auto",
                         block_size=None,
                         nan_check: bool = False,
                         mesh=None,
                         data_axis: str = "data",
                         particle_axis: str = "particle"):
    """Like `get_loss`, and also a metrics dict of device scalars:

    - 'elbo': mean ELBO over the batch;
    - 'ess': mean effective sample size of the final particle weights
      (NaN for 'tmc', which has no particle weights).

    With ``gradient_estimator='score'`` the loss is the score-function
    surrogate (`gradients`), whose value equals the plain loss; the
    metrics are unchanged.
    """
    loss, metrics, has_nan = _objective(
        observations, num_particles, algorithm, initial, transition,
        emission, proposal, noise=noise,
        resampling_method=resampling_method,
        resampling_implementation=resampling_implementation,
        resampling_criterion=resampling_criterion,
        soft_resampling_alpha=soft_resampling_alpha, ot_epsilon=ot_epsilon,
        ot_num_iterations=ot_num_iterations, ot_block_size=ot_block_size,
        ot_rank=ot_rank, lookahead=lookahead,
        history_window=history_window, remat=remat,
        gradient_estimator=gradient_estimator, score_baseline=score_baseline,
        pairwise=pairwise, block_size=block_size, nan_check=nan_check,
        with_metrics=True, mesh=mesh, data_axis=data_axis,
        particle_axis=particle_axis)
    inference._raise_if_nan(has_nan)
    return loss, metrics
