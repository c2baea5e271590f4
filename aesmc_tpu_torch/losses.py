"""Differentiable ELBO objectives.

Counterpart of `aesmc_tpu.losses`: `get_loss` maps 'iwae' to importance
sampling and 'aesmc' to SMC, runs `inference.infer` for the log marginal
likelihood only, and returns ``-mean(log Z)`` over the batch, a scalar
tensor to call `.backward()` on. `get_loss_and_metrics` adds the mean
ELBO and the mean effective sample size of the final weights.

Gradients flow through the reparameterized proposal samples and every
log-probability, but not through ancestor indices (the engine detaches
them): the reference's AESMC gradient semantics. On the card the
resampling gradient is the range-sum kernel (K2).

Not ported yet, and raising NotImplementedError until then: the 'tmc'
algorithm and `gradient_estimator='score'` (slice C: `tmc.py`,
`gradients.py`), and `nan_check` / `checked_loss` (slice B: the
`inference` NaN guard).
"""

from __future__ import annotations

from . import inference, statistics

ALGORITHMS = ("iwae", "aesmc")


def _check_later(algorithm, gradient_estimator, nan_check):
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
    if nan_check:
        raise NotImplementedError(
            "nan_check is not ported yet; it comes with slice B of the port "
            "(the inference NaN guard)")


def _inference_algorithm(algorithm):
    if algorithm == "iwae":
        return "is"
    if algorithm == "aesmc":
        return "smc"
    raise ValueError(
        f"algorithm must be one of {ALGORITHMS}. currently = {algorithm}")


def get_loss(observations, num_particles: int, algorithm: str, initial,
             transition, emission, proposal, noise=None,
             resampling_method: str = "systematic",
             resampling_implementation: str = "auto",
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
        resampling_method, resampling_implementation: forwarded to
            `infer` ('aesmc' only).

    Returns:
        scalar tensor.
    """
    _check_later(algorithm, gradient_estimator, nan_check)
    result = inference.infer(
        _inference_algorithm(algorithm), observations, initial, transition,
        emission, proposal, num_particles, noise=noise,
        resampling_method=resampling_method,
        resampling_implementation=resampling_implementation,
        return_log_marginal_likelihood=True, return_latents=False,
        return_log_weight=False)
    return -result["log_marginal_likelihood"].mean()


def checked_loss(*args, **kwargs):
    """`get_loss` with the NaN guard: not ported yet."""
    raise NotImplementedError(
        "checked_loss is not ported yet; it comes with slice B of the port "
        "(the inference NaN guard)")


def get_loss_and_metrics(observations, num_particles: int, algorithm: str,
                         initial, transition, emission, proposal,
                         noise=None, resampling_method: str = "systematic",
                         resampling_implementation: str = "auto",
                         gradient_estimator: str = "pathwise",
                         nan_check: bool = False):
    """Like `get_loss`, and also a metrics dict of device scalars:

    - 'elbo': mean ELBO over the batch;
    - 'ess': mean effective sample size of the final particle weights.
    """
    _check_later(algorithm, gradient_estimator, nan_check)
    result = inference.infer(
        _inference_algorithm(algorithm), observations, initial, transition,
        emission, proposal, num_particles, noise=noise,
        resampling_method=resampling_method,
        resampling_implementation=resampling_implementation,
        return_log_marginal_likelihood=True, return_latents=False,
        return_log_weight=True)
    elbo = result["log_marginal_likelihood"].mean()
    ess = statistics.ess(result["log_weight"]).mean()
    return -elbo, {"elbo": elbo.detach(), "ess": ess.detach()}
