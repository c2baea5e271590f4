"""Ensemble Kalman filtering.

Counterpart of `aesmc_tpu.enkf`. Where the particle filter reweights and
resamples, the EnKF (Evensen 1994) moves every ensemble member by a Kalman
update built from ensemble covariances: no weights, no resampling, at the
price of a Gaussian analysis step. Two analysis schemes:

- 'stochastic' (Burgers, van Leeuwen & Evensen 1998): perturbed
  observations, with optional covariance localization (Schur masks on the
  ensemble covariances, Houtekamer & Mitchell 2001; the Gaspari-Cohn mask
  of a cyclic grid is `gaspari_cohn_localization`);
- 'etkf' (the ensemble transform filter, Bishop et al. 2001, in Hunt et
  al. 2007's form): deterministic, the analysis in the ensemble space
  through an eigendecomposition of the `[N, N]` matrix M.

Model contract: `initial` and `transition` are the engine's component
callables; the ensemble is a particle cloud, forecast by sampling the
transition (`state.sample`). The observation operator is a function
``x [D] -> [Do]``, mapped over batch and members with `torch.func.vmap`
(covariances of h(x), no Jacobians). The per-step innovation
log-likelihood log N(y_t; ybar_t, P_yy) is returned as the evidence
approximation.

No kernel runs here: batched einsums, Cholesky factors
(`distributions.cholesky`, whose error flag stays on the device), solves
by a factor as two triangular solves (`distributions.cho_solve`) and
`torch.linalg.eigh`. On an H100 (torch 2.11) a CUDA graph captures the
stochastic scheme; ETKF's `eigh` fails inside a capture, so ETKF runs
eager.

Draws, in order: the initial ensemble's normals (`state.sample` with N
members, `[B, N, D]`), t = 0's observation perturbations `[B, N, Do]`
('stochastic' only), then per step the forecast's normals and the
perturbations. 'etkf' draws no perturbation.
"""

from __future__ import annotations

import math as _stdmath
from typing import Any, Callable, Optional

import numpy as np
import torch

from . import distributions as dists
from . import state
from .inference import TimeIndex, _first_leaf, stack_observations
from .noise import NoiseSource

__all__ = ["enkf_filter", "gaspari_cohn", "gaspari_cohn_localization"]

METHODS = ("stochastic", "etkf")


def gaspari_cohn(dist, radius: float):
    """The Gaspari & Cohn (1999) fifth-order compact correlation taper: 1
    at distance 0, exactly 0 beyond 2 radius. ``dist`` a tensor (its float
    dtype is kept) or an array (float64 on the CPU)."""
    if isinstance(dist, torch.Tensor):
        dist = dist if dist.is_floating_point() else dist.to(torch.float32)
    else:
        dist = torch.as_tensor(np.asarray(dist, np.float64))
    r = torch.abs(dist) / float(radius)
    near = (-0.25 * r ** 5 + 0.5 * r ** 4 + 0.625 * r ** 3
            - (5.0 / 3.0) * r ** 2 + 1.0)
    far = (r ** 5 / 12.0 - 0.5 * r ** 4 + 0.625 * r ** 3
           + (5.0 / 3.0) * r ** 2 - 5.0 * r + 4.0 - (2.0 / 3.0) / r)
    out = torch.where(r <= 1.0, near,
                      torch.where(r < 2.0, far, torch.zeros_like(r)))
    return torch.where(r == 0.0, torch.ones_like(r), out)


def gaspari_cohn_localization(dim: int, obs_indices=None,
                              radius: float = 2.0):
    """(loc_xy `[D, Do]`, loc_yy `[Do, Do]`) Schur masks for a cyclic 1-D
    grid (the Lorenz-96 geometry): the taper of the shortest ring distance
    between each state component and the grid location of each observed
    component. float64 tensors on the CPU; `enkf_filter` moves them to
    the ensemble's device and dtype."""
    grid = np.arange(dim)
    obs = (grid if obs_indices is None
           else np.asarray(list(obs_indices), np.int64))
    d_xy = np.abs(grid[:, None] - obs[None, :])
    d_xy = np.minimum(d_xy, dim - d_xy)
    d_yy = np.abs(obs[:, None] - obs[None, :])
    d_yy = np.minimum(d_yy, dim - d_yy)
    return gaspari_cohn(d_xy, radius), gaspari_cohn(d_yy, radius)


def _as_cov(obs_cov, obs_dim: int, like: torch.Tensor) -> torch.Tensor:
    if isinstance(obs_cov, (int, float)):
        return torch.diag(torch.full((obs_dim,), float(obs_cov),
                                     dtype=like.dtype, device=like.device))
    cov = (obs_cov if isinstance(obs_cov, torch.Tensor)
           else torch.as_tensor(np.asarray(obs_cov)))
    cov = cov.to(dtype=like.dtype, device=like.device)
    if cov.ndim == 0:
        return cov * torch.eye(obs_dim, dtype=like.dtype, device=like.device)
    if cov.ndim == 1:
        return torch.diag(cov)
    return cov


def _mask(x, like):
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return x.to(dtype=like.dtype, device=like.device)


def enkf_filter(observations,
                initial,
                transition,
                observation_fn: Callable,
                obs_cov,
                num_members: int,
                noise: Optional[NoiseSource] = None,
                method: str = "stochastic",
                inflation: float = 1.0,
                localization: Optional[Any] = None,
                return_ensembles: bool = False) -> dict:
    """Ensemble Kalman filter over a whole observation sequence.

    Args:
        observations: list of `[batch, Do]` values or a stacked `[T, batch,
            Do]` tensor (numpy goes to the card, see
            `inference.stack_observations`).
        initial, transition: the engine's component callables.
        observation_fn: ``x [D] -> [Do]``, the observation operator h
            (mapped over batch and members with `torch.func.vmap`).
        obs_cov: the observation noise covariance R: a number (R = c I),
            `[Do]` (diagonal) or `[Do, Do]`.
        num_members: the ensemble size N >= 2.
        noise: the source of every draw; defaults to
            `NoiseSource.seeded(0)` on the observations' device.
        method: 'stochastic' or 'etkf'.
        inflation: multiplicative anomaly inflation of each forecast
            ensemble (1.0 = off).
        localization: None, or `(loc_xy [D, Do], loc_yy [Do, Do])` Schur
            masks ('stochastic' only).
        return_ensembles: also stack the analysis ensembles `[T, batch, N,
            D]`.

    Returns:
        dict with 'filtered_means' and 'filtered_variances' `[T, batch,
        D]` (ensemble marginals, correction 1), 'log_likelihood' `[batch]`
        (the Gaussian innovation approximation), 'last_ensemble' `[batch,
        N, D]` and, when asked, 'ensembles'.
    """
    if method not in METHODS:
        raise ValueError(
            f"method must be one of {METHODS}. currently = {method}")
    if method == "etkf" and localization is not None:
        raise ValueError(
            "localization is only supported for method='stochastic' "
            "(the localized transform filter, LETKF, is a different "
            "per-gridpoint algorithm)")
    if num_members < 2:
        raise ValueError(
            f"num_members must be >= 2. currently = {num_members}")

    stacked = stack_observations(observations)
    obs = _first_leaf(stacked)
    if obs.ndim != 3:
        raise ValueError(
            "enkf_filter expects array observations [T, batch, Do]; got "
            f"shape {tuple(obs.shape)}")
    if noise is None:
        noise = NoiseSource.seeded(0, obs.device)
    obs = obs.to(obs.dtype if obs.is_floating_point() else torch.float32)
    num_timesteps, batch_size, obs_dim = obs.shape
    n = num_members
    r_cov = _as_cov(obs_cov, obs_dim, obs)
    r_chol = dists.cholesky(r_cov)
    h = torch.func.vmap(torch.func.vmap(observation_fn))
    if localization is not None:
        loc_xy, loc_yy = (_mask(localization[0], obs),
                          _mask(localization[1], obs))
    eye_n = torch.eye(n, dtype=obs.dtype, device=obs.device)
    log_2pi = obs_dim * _stdmath.log(2.0 * _stdmath.pi)

    def analysis(ensemble, y):
        """One analysis: ensemble `[B, N, D]`, y `[B, Do]`."""
        xbar = torch.mean(ensemble, dim=1, keepdim=True)
        ax = (ensemble - xbar) * inflation
        ensemble = xbar + ax
        yf = h(ensemble)                                        # [B, N, Do]
        ybar = torch.mean(yf, dim=1, keepdim=True)
        ay = yf - ybar
        pyy = torch.einsum("bno,bnp->bop", ay, ay) / (n - 1)
        if localization is not None:
            pyy = pyy * loc_yy
        pyy = pyy + r_cov
        # The innovation log-likelihood log N(y; ybar, pyy).
        dy = y - ybar[:, 0]                                     # [B, Do]
        chol = dists.cholesky(pyy)
        quad = torch.einsum("bo,bo->b", dy, dists.cho_solve(
            chol, dy.unsqueeze(-1)).squeeze(-1))
        logdet = 2.0 * torch.sum(torch.log(
            torch.diagonal(chol, dim1=1, dim2=2)), dim=1)
        step_ll = -0.5 * (logdet + quad + log_2pi)

        if method == "stochastic":
            pxy = torch.einsum("bnd,bno->bdo", ax, ay) / (n - 1)
            if localization is not None:
                pxy = pxy * loc_xy
            # K^T = pyy^{-1} pxy^T: [B, Do, D].
            kt = dists.cho_solve(chol, pxy.transpose(1, 2))
            eps = torch.einsum(
                "op,bnp->bno", r_chol,
                noise.normal((batch_size, n, obs_dim)).to(ax.dtype))
            innov = y[:, None, :] + eps - yf                    # [B, N, Do]
            ensemble = ensemble + torch.einsum("bno,bod->bnd", innov, kt)
        else:
            # ETKF: Ay R^{-1} [B, N, Do], then M = (N-1) I + Ay R^-1 Ay^T.
            ayr = dists.cho_solve(r_chol.expand(batch_size, -1, -1),
                             ay.transpose(1, 2)).transpose(1, 2)
            m_mat = (n - 1) * eye_n + torch.einsum("bno,bmo->bnm", ayr, ay)
            lam, u = torch.linalg.eigh(m_mat)
            lam = torch.clamp(lam, min=1e-10)
            # w = M^{-1} Ay R^{-1} (y - ybar); W = sqrt(N-1) M^{-1/2}.
            g = torch.einsum("bno,bo->bn", ayr, dy)
            w = torch.einsum("bnk,bk,bmk,bm->bn", u, 1.0 / lam, u, g)
            w_mat = torch.einsum("bnk,bk,bmk->bnm", u,
                                 torch.sqrt((n - 1) / lam), u)
            coeff = w[:, None, :] + w_mat                       # [B, i, j]
            ensemble = xbar + torch.einsum("bij,bjd->bid", coeff, ax)
        return ensemble, step_ll

    def moments(ensemble):
        return (torch.mean(ensemble, dim=1),
                torch.var(ensemble, dim=1, correction=1))

    # ---- t = 0: the initial draw, then the analysis of y_0.
    ensemble = state.sample(initial(), batch_size, n, noise).to(obs.dtype)
    ensemble, log_likelihood = analysis(ensemble, obs[0])
    mean, var = moments(ensemble)
    means, variances, ensembles = [mean], [var], [ensemble]
    for t in range(1, num_timesteps):
        dist = transition(previous_latents=[ensemble], time=TimeIndex(t),
                          previous_observations=[obs[t - 1]])
        ensemble = state.sample(dist, batch_size, n, noise).to(obs.dtype)
        ensemble, step_ll = analysis(ensemble, obs[t])
        log_likelihood = log_likelihood + step_ll
        mean, var = moments(ensemble)
        means.append(mean)
        variances.append(var)
        if return_ensembles:
            ensembles.append(ensemble)

    out = {
        "filtered_means": torch.stack(means),
        "filtered_variances": torch.stack(variances),
        "log_likelihood": log_likelihood,
        "last_ensemble": ensemble,
    }
    if return_ensembles:
        out["ensembles"] = torch.stack(ensembles)
    return out
