"""Differentiable ELBO objectives.

Counterpart of `aesmc_tpu.losses`: `get_loss` maps 'iwae' to importance
sampling and 'aesmc' to SMC, runs `inference.infer` for the log marginal
likelihood only, and returns ``-mean(log Z)`` over the batch, a scalar
tensor to call `.backward()` on. `get_loss_and_metrics` adds the mean
ELBO and the mean effective sample size of the final weights.
`checked_loss` is `get_loss` with the NaN guard deferred: it returns an
error value that reads the guard's device flag only when asked.

Gradients flow through the reparameterized proposal samples and every
log-probability, but not through ancestor indices (the engine detaches
them): the reference's AESMC gradient semantics. On the card the
resampling gradient is the range-sum kernel (K2).

Not ported yet, and raising NotImplementedError until then: the 'tmc'
algorithm and `gradient_estimator='score'` (slice C: `tmc.py`,
`gradients.py`).
"""

from __future__ import annotations

from . import inference, statistics

ALGORITHMS = ("iwae", "aesmc")


def _check_later(algorithm, gradient_estimator):
    if algorithm == "tmc":
        raise NotImplementedError(
            "algorithm='tmc' (Tensor Monte Carlo) is not ported yet; it "
            "comes with slice C of the port (tmc.py)")
    if gradient_estimator == "score":
        raise NotImplementedError(
            "gradient_estimator='score' is not ported yet; it comes with "
            "slice C of the port (gradients.py)")
    if gradient_estimator != "pathwise":
        raise ValueError(
            "gradient_estimator must be 'pathwise' or 'score'. "
            f"currently = {gradient_estimator}")


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
               resampling_criterion="always", remat=False,
               gradient_estimator="pathwise", nan_check=False,
               with_metrics=False):
    """(loss, metrics or None, NaN flag of `inference._infer`): the flag
    is left on the device, unread."""
    _check_later(algorithm, gradient_estimator)
    result, has_nan = inference._infer(
        _inference_algorithm(algorithm), observations, initial, transition,
        emission, proposal, num_particles, noise=noise,
        resampling_method=resampling_method,
        resampling_implementation=resampling_implementation,
        resampling_criterion=resampling_criterion, nan_check=nan_check,
        remat=remat, return_log_marginal_likelihood=True,
        return_latents=False, return_log_weight=with_metrics)
    elbo = result["log_marginal_likelihood"].mean()
    metrics = None
    if with_metrics:
        ess = statistics.ess(result["log_weight"]).mean()
        metrics = {"elbo": elbo.detach(), "ess": ess.detach()}
    return -elbo, metrics, has_nan


def get_loss(observations, num_particles: int, algorithm: str, initial,
             transition, emission, proposal, noise=None,
             resampling_method: str = "systematic",
             resampling_implementation: str = "auto",
             resampling_criterion="always",
             remat: bool = False,
             gradient_estimator: str = "pathwise",
             nan_check: bool = False):
    """Scalar loss ``-mean(ELBO)`` for gradient descent.

    Args:
        observations: list of `[batch, ...]` values or stacked
            `[T, batch, ...]` value (see `inference.infer`).
        num_particles: int.
        algorithm: 'iwae' (IS estimator) or 'aesmc' (SMC estimator).
        initial, transition, emission, proposal: user components.
        noise: the `NoiseSource` of every draw (see `inference.infer`).
        resampling_method, resampling_implementation,
            resampling_criterion: forwarded to `infer` ('aesmc' only).
        remat: forwarded to `infer`.
        nan_check: raise FloatingPointError when a resampling step saw a
            NaN log-weight ('aesmc'; one read of the device).

    Returns:
        scalar tensor.
    """
    loss, _, has_nan = _objective(
        observations, num_particles, algorithm, initial, transition,
        emission, proposal, noise=noise,
        resampling_method=resampling_method,
        resampling_implementation=resampling_implementation,
        resampling_criterion=resampling_criterion, remat=remat,
        gradient_estimator=gradient_estimator, nan_check=nan_check)
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
                         remat: bool = False,
                         gradient_estimator: str = "pathwise",
                         nan_check: bool = False):
    """Like `get_loss`, and also a metrics dict of device scalars:

    - 'elbo': mean ELBO over the batch;
    - 'ess': mean effective sample size of the final particle weights.
    """
    loss, metrics, has_nan = _objective(
        observations, num_particles, algorithm, initial, transition,
        emission, proposal, noise=noise,
        resampling_method=resampling_method,
        resampling_implementation=resampling_implementation,
        resampling_criterion=resampling_criterion, remat=remat,
        gradient_estimator=gradient_estimator, nan_check=nan_check,
        with_metrics=True)
    inference._raise_if_nan(has_nan)
    return loss, metrics
