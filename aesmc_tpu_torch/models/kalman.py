"""Exact scalar Kalman filter (test oracle), in numpy float64.

Counterpart of `aesmc_tpu.models.kalman` (`KalmanParams`,
`kalman_filter`, `kalman_smoother`, `kalman_em`) for the scalar
linear-Gaussian SSM

    x_0 ~ N(mu_0, P_0)
    x_t = a x_{t-1} + b + N(0, Q)
    y_t = c x_t + d + N(0, R)

Independent of the PyTorch code under test, so that a machine with no JAX
can check the port's log-Z against it.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class KalmanParams:
    initial_mean: float
    initial_variance: float
    transition_mult: float
    transition_offset: float
    transition_variance: float
    emission_mult: float
    emission_offset: float
    emission_variance: float


def kalman_filter(observations: Sequence[float], params: KalmanParams
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                             np.ndarray, float]:
    """Forward filtering pass.

    Returns (filtered_means, filtered_variances, predicted_means,
    predicted_variances, log_marginal_likelihood). predicted_* are the
    one-step-ahead prior moments at each t (the t=0 entry is the initial
    prior).
    """
    y = np.asarray(observations, dtype=np.float64).reshape(-1)
    num_timesteps = y.shape[0]
    a, b, q = (params.transition_mult, params.transition_offset,
               params.transition_variance)
    c, d, r = (params.emission_mult, params.emission_offset,
               params.emission_variance)

    m = np.zeros(num_timesteps)
    p = np.zeros(num_timesteps)
    m_pred = np.zeros(num_timesteps)
    p_pred = np.zeros(num_timesteps)
    loglik = 0.0

    for t in range(num_timesteps):
        if t == 0:
            m_pred[t] = params.initial_mean
            p_pred[t] = params.initial_variance
        else:
            m_pred[t] = a * m[t - 1] + b
            p_pred[t] = a * a * p[t - 1] + q
        s = c * c * p_pred[t] + r
        gain = p_pred[t] * c / s
        innovation = y[t] - (c * m_pred[t] + d)
        m[t] = m_pred[t] + gain * innovation
        p[t] = (1.0 - gain * c) * p_pred[t]
        loglik += -0.5 * (np.log(2.0 * np.pi * s) + innovation ** 2 / s)

    return m, p, m_pred, p_pred, float(loglik)


def kalman_smoother(observations: Sequence[float], params: KalmanParams
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Rauch-Tung-Striebel smoothing pass: returns (smoothed_means,
    smoothed_variances), the exact oracle of the particle smoothers."""
    m, p, m_pred, p_pred, _ = kalman_filter(observations, params)
    num_timesteps = m.shape[0]
    a = params.transition_mult
    ms = np.zeros(num_timesteps)
    ps = np.zeros(num_timesteps)
    ms[-1] = m[-1]
    ps[-1] = p[-1]
    for t in range(num_timesteps - 2, -1, -1):
        gain = p[t] * a / p_pred[t + 1]
        ms[t] = m[t] + gain * (ms[t + 1] - m_pred[t + 1])
        ps[t] = p[t] + gain * gain * (ps[t + 1] - p_pred[t + 1])
    return ms, ps


def kalman_em(observations: Sequence[float],
              params: KalmanParams,
              num_iterations: int = 10,
              em_vars: Tuple[str, ...] = (
                  "transition_variance", "emission_variance",
                  "initial_mean", "initial_variance")) -> KalmanParams:
    """EM fitting of the scalar LGSSM's parameters named in ``em_vars``
    (by default pykalman's set: the transition and emission variances and
    the initial moments), from the smoothed moments of `kalman_smoother`.
    Returns new parameters; ``params`` is left as it was."""
    y = np.asarray(observations, dtype=np.float64).reshape(-1)
    num_timesteps = y.shape[0]
    params = dataclasses.replace(params)
    for _ in range(num_iterations):
        a, b = params.transition_mult, params.transition_offset
        c, d = params.emission_mult, params.emission_offset
        _, p, _, p_pred, _ = kalman_filter(y, params)
        ms, ps = kalman_smoother(y, params)
        # Smoothed lag-one covariances Cov(x_t, x_{t-1} | y), t >= 1.
        cross = np.zeros(num_timesteps)
        for t in range(1, num_timesteps):
            cross[t] = p[t - 1] * a / p_pred[t] * ps[t]
        e_xx = ps + ms ** 2                      # E[x_t^2]
        e_xl = cross[1:] + ms[1:] * ms[:-1]      # E[x_t x_{t-1}]
        updates = {}
        if "initial_mean" in em_vars:
            updates["initial_mean"] = float(ms[0])
        if "initial_variance" in em_vars:
            updates["initial_variance"] = float(max(ps[0], 1e-12))
        if "transition_variance" in em_vars and num_timesteps > 1:
            resid = (e_xx[1:] - 2.0 * a * e_xl - 2.0 * b * ms[1:] +
                     a * a * e_xx[:-1] + 2.0 * a * b * ms[:-1] + b * b)
            updates["transition_variance"] = float(
                max(np.mean(resid), 1e-12))
        if "emission_variance" in em_vars:
            resid = (y ** 2 - 2.0 * c * y * ms - 2.0 * d * y +
                     c * c * e_xx + 2.0 * c * d * ms + d * d)
            updates["emission_variance"] = float(max(np.mean(resid), 1e-12))
        params = dataclasses.replace(params, **updates)
    return params
