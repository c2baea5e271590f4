"""The plain reference of the `lgssm` configuration.

- `exact_terms`: the exact predictive log-densities log p(y_t | y_{<t})
  of every row, by the Kalman filter in float64 numpy; their sum,
  `exact_log_z`, is the exact log-Z that a filter call estimates, and
  each term is what a served observation's `log_pred` estimates.
- `filter_log_z` and `stream`: a bootstrap-free particle filter with the
  configuration's affine Gaussian proposal and systematic resampling, in
  any dtype: at float32 it takes the program's place as a sound run, at a
  lower precision it is the control.

The model: x_0 ~ N(loc0, s0^2), x_t = a x_{t-1} + N(0, sq^2),
y_t = c x_t + N(0, sr^2); the proposal q(x_0 | y_0) = N(w0 y_0 + b0,
ps0^2), q(x_t | x_{t-1}, y_t) = N(wt0 x_{t-1} + wt1 y_t + bt, pst^2).
Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .smc import gather_rows, log_mean_exp, normal_log_prob, \
    systematic_ancestors

def exact_terms(obs, model) -> np.ndarray:
    """log p(y_t | y_{<t}) `[T, B]` (float64) of ``obs`` `[T, B]`."""
    y = np.asarray(obs, dtype=np.float64)
    a, c = model["transition_mult"], model["emission_mult"]
    q, r = model["transition_scale"] ** 2, model["emission_scale"] ** 2
    m = np.full(y.shape[1], float(model["initial_loc"]))
    p = float(model["initial_scale"]) ** 2
    out = np.empty_like(y)
    for t in range(y.shape[0]):
        if t:
            m, p = a * m, a * a * p + q
        s = c * c * p + r
        resid = y[t] - c * m
        out[t] = -0.5 * (resid * resid / s + math.log(2 * math.pi * s))
        gain = p * c / s
        m, p = m + gain * resid, (1.0 - gain * c) * p
    return out


def exact_log_z(obs, model) -> np.ndarray:
    """The exact log p(y_{0:T-1}) `[B]`."""
    return exact_terms(obs, model).sum(axis=0)


def _proposal_loc(prop, t, x_prev, y_t):
    if t == 0:
        return prop["lin_0_weight"] * y_t + prop["lin_0_bias"]
    w = prop["lin_t_weight"]
    return w[0] * x_prev + w[1] * y_t[:, None] + prop["lin_t_bias"]


def _step_weight(model, params, t, x, x_prev, y_t):
    """The incremental log-weight `[B, K]` of particles ``x`` at time t."""
    if t == 0:
        prior = normal_log_prob(x, model["initial_loc"],
                                model["initial_scale"])
        loc = (params["lin_0_weight"] * y_t + params["lin_0_bias"])[:, None]
        scale = params["proposal_scale_0"]
    else:
        prior = normal_log_prob(x, params["transition_mult"] * x_prev,
                                model["transition_scale"])
        loc = _proposal_loc(params, t, x_prev, y_t)
        scale = params["proposal_scale_t"]
    like = normal_log_prob(y_t[:, None], params["emission_mult"] * x,
                           model["emission_scale"])
    return prior + like - normal_log_prob(x, loc, scale)


def _propose(params, t, x_prev, y_t, eps):
    if t == 0:
        loc = (params["lin_0_weight"] * y_t + params["lin_0_bias"])[:, None]
        return loc + params["proposal_scale_0"] * eps
    return (_proposal_loc(params, t, x_prev, y_t) +
            params["proposal_scale_t"] * eps)


def filter_log_z(model, params, obs, num_particles, draws):
    """One particle filter's log-Z estimate `[B]`: ``obs`` `[T, B]`,
    ``draws`` with `normal([B, K])` and `uniform([B, 1])` in the dtype and
    on the device the filter runs in. log-Z is summed in time order."""
    num_timesteps, batch = obs.shape
    shape = (batch, num_particles)
    x = _propose(params, 0, None, obs[0], draws.normal(shape))
    log_w = _step_weight(model, params, 0, x, None, obs[0])
    log_z = log_mean_exp(log_w)
    for t in range(1, num_timesteps):
        idx = systematic_ancestors(log_w.detach(), draws.uniform((batch, 1)))
        x_prev = gather_rows(x, idx)
        x = _propose(params, t, x_prev, obs[t], draws.normal(shape))
        log_w = _step_weight(model, params, t, x, x_prev, obs[t])
        log_z = log_z + log_mean_exp(log_w)
    return log_z


def stream(model, params, obs, num_particles, draws):
    """The streaming filter over ``obs`` `[T, B]`: `log_pred` `[T - 1, B]`
    of each observation after the first, each the difference of the
    running log-Z after and before it, as a server's carry holds it."""
    num_timesteps, batch = obs.shape
    shape = (batch, num_particles)
    x = _propose(params, 0, None, obs[0], draws.normal(shape))
    log_w = _step_weight(model, params, 0, x, None, obs[0])
    running = log_mean_exp(log_w)
    preds = []
    for t in range(1, num_timesteps):
        idx = systematic_ancestors(log_w, draws.uniform((batch, 1)))
        x_prev = gather_rows(x, idx)
        x = _propose(params, t, x_prev, obs[t], draws.normal(shape))
        log_w = _step_weight(model, params, t, x, x_prev, obs[t])
        after = running + log_mean_exp(log_w)
        preds.append(after - running)
        running = after
    return torch.stack(preds)


def model_params(config) -> dict:
    """The data model's numbers from the configuration's file."""
    return {k: float(config["model"][k]) for k in (
        "initial_loc", "initial_scale", "transition_mult",
        "transition_scale", "emission_mult", "emission_scale")}
