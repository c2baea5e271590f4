"""Single-run variance estimation for SMC via genealogy tracking.

Counterpart of `aesmc_tpu.variance`. Particles that share a time-0
ancestor (an "eve") are correlated, and the spread of the final weight
across eve families measures how many effectively independent samples
survived, so one run estimates its own Monte Carlo variance:

- `log_z_variance`: Lee & Whiteley (2018, Biometrika 105(3)), an
  estimator of the relative variance Var(Z_hat) / Z^2, unbiased (in its
  unnormalized form) for multinomial resampling at every step, and by the
  delta method about Var(log Z_hat); with no resampling it is the
  textbook unbiased iid estimator of importance sampling;
- `expectation_variance`: Chan & Lai (2013, Ann. Statist. 41(4)), the
  asymptotic variance sigma^2(h) of sqrt(K) (E_hat[h] - E[h | y]) for a
  posterior expectation under the final weights.

Both read what `infer(..., return_ancestral_indices=True,
return_log_weight=True)` returns: the eves are the ancestor maps composed
forward (one `take_along_dim` a step) and the family sums one
`scatter_add` a call. Genealogy estimators are biased downward at
moderate K (families coalesce); see the JAX package's notes.
"""

from __future__ import annotations

import torch

__all__ = ["eve_indices", "num_families", "log_z_variance",
           "expectation_variance"]


def eve_indices(ancestral_indices, initial=None):
    """Composes the ancestor maps forward into time-0 roots ("eves").

    Args:
        ancestral_indices: `[T-1, batch, K]` integer tensor; row t holds
            the ancestor of particle i at time t+1.
        initial: optional `[batch, K]` starting labels (default
            ``arange(K)`` a row).

    Returns:
        `[batch, K]` int32: each final particle's time-0 ancestor.
    """
    if ancestral_indices.ndim != 3:
        raise ValueError(
            "ancestral_indices must be [T-1, batch, K]. Got "
            f"{tuple(ancestral_indices.shape)}")
    _, batch_size, num_particles = ancestral_indices.shape
    if initial is None:
        initial = torch.arange(
            num_particles, dtype=torch.int32,
            device=ancestral_indices.device).expand(batch_size,
                                                    num_particles)
    eve = initial.long()
    for anc_t in ancestral_indices:
        eve = torch.take_along_dim(eve, anc_t.long(), dim=1)
    return eve.to(torch.int32)


def _family_sums(values, eve):
    """``values`` `[batch, K, ...]` summed per eve family: `[batch, K,
    ...]`, entry e the sum over the particles whose eve is e (zero for
    extinct families)."""
    index = eve.long().reshape(tuple(eve.shape) +
                               (1,) * (values.ndim - 2)).expand_as(values)
    return torch.zeros_like(values).scatter_add_(1, index, values)


def num_families(ancestral_indices):
    """`[batch]` count of distinct surviving time-0 families: K is
    healthy, 1 fully collapsed."""
    eve = eve_indices(ancestral_indices)
    alive = torch.zeros(eve.shape, dtype=torch.bool, device=eve.device)
    alive.scatter_(1, eve.long(), True)
    return alive.sum(dim=-1)


def log_z_variance(log_weight, ancestral_indices,
                   num_resampling_events=None):
    """Lee-Whiteley single-run estimator of Var(Z_hat) / Z_hat^2.

    V = 1 - (K/(K-1))^(m+1) (1 - sum_e s_e^2), with s_e the normalized
    final weight of eve family e and m the number of resampling events.

    Args:
        log_weight: `[batch, K]` final unnormalized log-weights.
        ancestral_indices: `[T-1, batch, K]` from the same run.
        num_resampling_events: optional `[batch]` (or scalar) count m;
            default T-1, the always-resample schedule. For ESS-adaptive
            runs pass the rows' own counts: identity ancestor rows
            compose harmlessly through the eves but must not inflate the
            bias correction.

    Returns:
        `[batch]` relative-variance estimates in [0, 1]: clipped at 0
        (too small to resolve from one run) and 1 when all the weight
        sits in one family (full collapse; see `num_families`).
    """
    num_particles = log_weight.shape[-1]
    m = (ancestral_indices.shape[0] if num_resampling_events is None
         else num_resampling_events)
    if not isinstance(m, torch.Tensor):
        m = torch.full((), float(m), device=log_weight.device)
    eve = eve_indices(ancestral_indices)
    s = _family_sums(torch.softmax(log_weight, dim=-1), eve)   # [B, K]
    cross = 1.0 - (s * s).sum(dim=-1)
    factor = (num_particles / (num_particles - 1.0)) ** (m + 1.0)
    return torch.clamp(1.0 - factor * cross, min=0.0)


def expectation_variance(value, log_weight, ancestral_indices):
    """Chan-Lai single-run estimator of the asymptotic variance of a
    posterior expectation: K * sum_e (sum_{i in e} wbar_i (h_i - h_hat))^2
    (Chan & Lai 2013, eq. 2.5). The variance of the estimate itself is
    about sigma^2(h) / K. To restrict it to a lag window, pass
    ``ancestral_indices[-lag:]``.

    Args:
        value: `[batch, K]` or `[batch, K, D]` h-values.
        log_weight: `[batch, K]` final unnormalized log-weights.
        ancestral_indices: `[T-1, batch, K]`.

    Returns:
        sigma^2 estimates `[batch]` (or `[batch, D]`), >= 0.
    """
    squeeze = value.ndim == 2
    if squeeze:
        value = value[..., None]
    num_particles = value.shape[1]
    eve = eve_indices(ancestral_indices)
    w = torch.softmax(log_weight, dim=-1)                      # [B, K]
    h_hat = torch.einsum("bk,bkd->bd", w, value)               # [B, D]
    contrib = w[..., None] * (value - h_hat[:, None, :])       # [B, K, D]
    family = _family_sums(contrib, eve)                        # [B, K, D]
    sigma2 = num_particles * (family * family).sum(dim=1)      # [B, D]
    return sigma2[..., 0] if squeeze else sigma2
