"""Auto-linearized locally-optimal proposals.

Counterpart of `aesmc_tpu.proposals`. For a nonlinear SSM with additive
Gaussian noise

    x_t = f(x_{t-1}) + N(0, Q)         y_t = g(x_t) + N(0, R)

the locally-optimal proposal p(x_t | x_{t-1}, y_t) is approximated by a
Gaussian from one Kalman measurement update of the prior N(f(x_{t-1}), Q)
against a linearization of g, per particle: the extended Kalman filter's
(the Jacobian of g, `torch.func.jacfwd` under `torch.func.vmap` over the
particles, where the JAX package takes `jax.jacfwd` under two `vmap`s),
or the unscented transform's (sigma points, derivative-free). On a linear
model the extended update is the exact locally-optimal proposal.

The algebra is batched over the `B * K` particles: one `[N, D, D]`
Cholesky factor, solve and product each, where the JAX package maps a
per-particle function. Every Cholesky factor goes through
`distributions.cholesky`: no host read, and NaN where a matrix is not
positive definite, as in the JAX package. The gain's Cholesky solve
(`jax.scipy.linalg.cho_solve` there) is `distributions.cho_solve`, two
batched triangular solves; `chip_smoke.py` phase 21 times it against
`torch.cholesky_solve` on the card.

Contract of the user's functions: ``transition_mean``, ``emission_mean``
and callable covariances take one particle (`[D]`, or a 0-d tensor in
scalar mode) and are pure tensor functions of it: `torch.func.vmap`
traces them once for every particle, so a function that calls `.item()`,
`bool()` or branches on a value raises, where `jax.vmap` would trace it.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from . import distributions as dists
from .state import BatchShapeMode

__all__ = ["ekf_proposal", "EKFProposal"]

LINEARIZATIONS = ("extended", "unscented")


class EKFProposal(nn.Module):
    """The proposal `ekf_proposal` returns: a module whose constant
    moments are buffers (``.to(device)`` moves them) and whose call
    follows the engine's proposal contract."""

    def __init__(self, transition_mean, transition_cov, emission_mean,
                 emission_cov, initial_mean, initial_cov,
                 linearization="extended", unscented_kappa=1.0):
        super().__init__()
        if linearization not in LINEARIZATIONS:
            raise ValueError(
                f"linearization must be 'extended' or 'unscented'. "
                f"currently = {linearization}")
        self.scalar_mode = _as_tensor(initial_mean).ndim == 0
        self.linearization = linearization
        self.kappa = float(unscented_kappa)
        self.transition_mean = transition_mean
        self.emission_mean = emission_mean
        self._constant("initial_mean", initial_mean)
        self._constant("initial_cov", initial_cov)
        self._constant("transition_cov", transition_cov)
        self._constant("emission_cov", emission_cov)

    def _constant(self, name, value):
        """A callable stays a callable; a tensor that requires a gradient
        stays itself (trainable); anything else becomes a float32
        buffer."""
        if callable(value) or (isinstance(value, torch.Tensor) and
                               value.requires_grad):
            setattr(self, "_" + name, value)
            return
        self.register_buffer("_" + name, _as_tensor(value))

    def _cov(self, name, x_flat):
        """The covariance ``name`` at each particle of ``x_flat`` `[N(, D)]`:
        `[N(, Do, Do)]`."""
        cov = getattr(self, "_" + name)
        if callable(cov):
            return torch.func.vmap(cov)(x_flat)
        cov = cov.to(x_flat.device)
        return cov.expand((x_flat.shape[0],) + tuple(cov.shape))

    # ---- the measurement update of N(m, p) against y ~ g(x) + N(0, r),
    # batched over N particles: (loc, cov).
    def _condition_scalar(self, m, p, r, y):
        g = self.emission_mean
        if self.linearization == "extended":
            gm = torch.func.vmap(g)(m)
            grad = torch.func.vmap(torch.func.jacfwd(g))(m).to(m.dtype)
            s = grad * p * grad + r
            c = p * grad
        else:
            kappa = self.kappa
            spread = torch.sqrt((1.0 + kappa) * p)
            pts = torch.stack([m, m + spread, m - spread], dim=-1)  # [N, 3]
            w = _sigma_weights(kappa / (1.0 + kappa), 0.5 / (1.0 + kappa),
                               2, pts)
            gs = torch.func.vmap(g)(pts.reshape(-1)).reshape(pts.shape)
            gm = (w * gs).sum(dim=-1)
            s = (w * (gs - gm[:, None]) ** 2).sum(dim=-1) + r
            c = (w * (pts - m[:, None]) * (gs - gm[:, None])).sum(dim=-1)
        gain = c / s
        loc = m + gain * (y - gm)
        var = p - gain * c
        return loc, var

    def _condition_vector(self, m, p, r, y):
        g = self.emission_mean
        if self.linearization == "extended":
            gm = torch.func.vmap(g)(m)                       # [N, Do]
            # (jacfwd can hand back float64 for float32 inputs.)
            jac = torch.func.vmap(torch.func.jacfwd(g))(m).to(
                m.dtype)                                     # [N, Do, D]
            jac_t = jac.transpose(-1, -2)
            s = jac @ p @ jac_t + r
            c = p @ jac_t                                    # [N, D, Do]
        else:
            dim, kappa = m.shape[-1], self.kappa
            scale = float(np.sqrt(dim + kappa))
            tril_t = dists.cholesky(p).transpose(-1, -2)
            deltas = torch.cat([torch.zeros_like(m)[:, None], scale * tril_t,
                                -scale * tril_t], dim=1)      # [N, 2D+1, D]
            pts = m[:, None] + deltas
            w = _sigma_weights(kappa / (dim + kappa), 0.5 / (dim + kappa),
                               2 * dim, m)
            gs = torch.func.vmap(g)(pts.reshape(-1, dim)).reshape(
                pts.shape[:2] + (-1,))                        # [N, 2D+1, Do]
            gm = torch.einsum("n,Nni->Ni", w, gs)
            dg = gs - gm[:, None]
            s = torch.einsum("n,Nni,Nnj->Nij", w, dg, dg) + r
            c = torch.einsum("n,Nni,Nnj->Nij", w, deltas, dg)
        s = 0.5 * (s + s.transpose(-1, -2))
        chol = dists.cholesky(s)
        # gain = c S^{-1} (the JAX package's cho_solve of S X = c^T), one
        # batched call for every particle.
        gain = dists.cho_solve(chol, c.transpose(-1, -2)).transpose(
            -1, -2)                                          # [N, D, Do]
        loc = m + (gain @ (y - gm)[..., None])[..., 0]
        cov = p - gain @ s @ gain.transpose(-1, -2)
        return loc, 0.5 * (cov + cov.transpose(-1, -2))

    def _distribution(self, loc, cov, mode):
        if self.scalar_mode:
            return dists.Normal(loc, torch.sqrt(cov), batch_shape_mode=mode)
        return dists.MultivariateNormalTriL(loc, dists.cholesky(cov),
                                            batch_shape_mode=mode)

    def forward(self, previous_latents=None, time=None, observations=None):
        condition = (self._condition_scalar if self.scalar_mode else
                     self._condition_vector)
        if previous_latents is None:
            y0 = observations[0]                             # [B(, Do)]
            n = y0.shape[0]
            m0 = self._initial_mean.to(y0.device)
            p0 = self._initial_cov.to(y0.device)
            r0 = self._cov("emission_cov", m0[None])
            loc, cov = condition(m0.expand((n,) + tuple(m0.shape)),
                                 p0.expand((n,) + tuple(p0.shape)),
                                 r0.expand((n,) + tuple(r0.shape[1:])), y0)
            return self._distribution(loc, cov,
                                      BatchShapeMode.BATCH_EXPANDED)
        x_prev = previous_latents[-1]                        # [B, K(, D)]
        y_t = observations[time]                             # [B(, Do)]
        batch, k = x_prev.shape[:2]
        x_flat = x_prev.reshape((batch * k,) + tuple(x_prev.shape[2:]))
        m = torch.func.vmap(self.transition_mean)(x_flat)
        p = self._cov("transition_cov", x_flat)
        r = self._cov("emission_cov", x_flat)
        y = y_t[:, None].expand((batch, k) + tuple(y_t.shape[1:])).reshape(
            (batch * k,) + tuple(y_t.shape[1:]))
        loc, cov = condition(m, p, r, y)
        lead = (batch, k)
        return self._distribution(
            loc.reshape(lead + tuple(loc.shape[1:])),
            cov.reshape(lead + tuple(cov.shape[1:])),
            BatchShapeMode.FULLY_EXPANDED)


def _sigma_weights(center, other, count, like):
    """`[1 + count]` sigma-point weights, made by fills on ``like``'s device
    (a copy from the host could not be captured in a CUDA graph)."""
    return torch.cat([torch.full((1,), center, dtype=like.dtype,
                                 device=like.device),
                      torch.full((count,), other, dtype=like.dtype,
                                 device=like.device)])


def _as_tensor(value):
    """A float32 tensor of ``value`` (a tensor stays on its device)."""
    if isinstance(value, torch.Tensor):
        return value.detach().to(torch.float32)
    return torch.as_tensor(np.asarray(value, dtype=np.float32))


def ekf_proposal(transition_mean, transition_cov, emission_mean,
                 emission_cov, initial_mean, initial_cov,
                 linearization: str = "extended",
                 unscented_kappa: float = 1.0) -> EKFProposal:
    """Builds an engine proposal from the model's mean and covariance
    pieces.

    Args:
        transition_mean: ``x [D] -> [D]`` (or scalar -> scalar), the prior
            transition mean f, applied to each particle.
        transition_cov: `[D, D]` (a variance in scalar mode), or a callable
            ``x -> cov`` for state-dependent noise.
        emission_mean: ``x [D] -> [Do]`` (or scalar -> scalar), the
            emission mean g: its Jacobian ('extended') or its sigma-point
            images ('unscented') linearize it.
        emission_cov: `[Do, Do]` (a variance in scalar mode), or a
            callable ``x -> cov``.
        initial_mean, initial_cov: the prior moments of x_0 (`[D]` and `[D,
            D]`, scalars in scalar mode), for the t = 0 proposal q(x_0 |
            y_0).
        linearization: 'extended' or 'unscented'.
        unscented_kappa: the sigma points' spread kappa.

    Returns:
        An `EKFProposal` (move it with ``.to(device)``): ``proposal(
        previous_latents=None, time=None, observations=None)``. Scalar mode
        (a scalar ``initial_mean``) gives a `Normal` over `[B, K]`
        latents; vector mode a `MultivariateNormalTriL` over `[B, K, D]`.
        Differentiable: it can sit inside a training objective.
    """
    return EKFProposal(transition_mean, transition_cov, emission_mean,
                       emission_cov, initial_mean, initial_cov,
                       linearization=linearization,
                       unscented_kappa=unscented_kappa)
