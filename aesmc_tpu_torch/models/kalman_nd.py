"""Exact N-dimensional Kalman filter and RTS smoother (test oracle), in
numpy float64.

Counterpart of `aesmc_tpu.models.kalman_nd` for the N-dim LGSSM
(`models.lgssm_nd`):

    x_0 ~ N(m0, P0)
    x_t = A x_{t-1} + N(0, Q)
    y_t = C x_t + N(0, R)

The port keeps its own copy, independent of the PyTorch code under test,
so that a machine with no JAX can check the port's log-Z against it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class KalmanNdParams:
    initial_mean: np.ndarray        # [D]
    initial_cov: np.ndarray         # [D, D]
    transition_matrix: np.ndarray   # [D, D]
    transition_cov: np.ndarray      # [D, D]
    emission_matrix: np.ndarray     # [Do, D]
    emission_cov: np.ndarray        # [Do, Do]


def kalman_filter_nd(observations: np.ndarray, params: KalmanNdParams
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray, float]:
    """observations [T, Do] -> (filtered means [T, D], filtered covs
    [T, D, D], predicted means, predicted covs, log marginal likelihood).
    """
    y = np.asarray(observations, dtype=np.float64)
    t_len = y.shape[0]
    a, q = params.transition_matrix, params.transition_cov
    c, r = params.emission_matrix, params.emission_cov
    d = a.shape[0]

    m = np.zeros((t_len, d))
    p = np.zeros((t_len, d, d))
    m_pred = np.zeros((t_len, d))
    p_pred = np.zeros((t_len, d, d))
    loglik = 0.0

    for t in range(t_len):
        if t == 0:
            m_pred[t] = params.initial_mean
            p_pred[t] = params.initial_cov
        else:
            m_pred[t] = a @ m[t - 1]
            p_pred[t] = a @ p[t - 1] @ a.T + q
        s = c @ p_pred[t] @ c.T + r
        s = 0.5 * (s + s.T)
        innovation = y[t] - c @ m_pred[t]
        solve = np.linalg.solve(s, innovation)
        gain = p_pred[t] @ c.T @ np.linalg.inv(s)
        m[t] = m_pred[t] + gain @ innovation
        p[t] = (np.eye(d) - gain @ c) @ p_pred[t]
        _, logdet = np.linalg.slogdet(s)
        loglik += -0.5 * (logdet + innovation @ solve +
                          len(innovation) * np.log(2.0 * np.pi))

    return m, p, m_pred, p_pred, float(loglik)


def kalman_smoother_nd(observations: np.ndarray, params: KalmanNdParams
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """RTS smoothing: (smoothed means [T, D], smoothed covs [T, D, D])."""
    m, p, m_pred, p_pred, _ = kalman_filter_nd(observations, params)
    t_len = m.shape[0]
    a = params.transition_matrix

    ms = np.zeros_like(m)
    ps = np.zeros_like(p)
    ms[-1], ps[-1] = m[-1], p[-1]
    for t in range(t_len - 2, -1, -1):
        gain = p[t] @ a.T @ np.linalg.inv(p_pred[t + 1])
        ms[t] = m[t] + gain @ (ms[t + 1] - m_pred[t + 1])
        ps[t] = p[t] + gain @ (ps[t + 1] - p_pred[t + 1]) @ gain.T

    return ms, ps
