"""Lorenz-96 chaotic state-space model, as `nn.Module`s.

Counterpart of `aesmc_tpu.models.lorenz`: D coupled ODEs

    dx_i/dt = (x_{i+1} - x_{i-2}) x_{i-1} - x_i + F

with cyclic indexing (chaotic at F = 8), discretized by one RK4 step of
length ``dt`` plus Gaussian process noise, and observed linearly on a
subset of the components:

    x_t = rk4(x_{t-1}) + N(0, q^2 I)      y_t = x_t[obs] + N(0, r^2 I)

`assimilation_proposal` builds the locally-optimal proposal: the closed
form ('diagonal', the default: the posterior of a diagonal prior against
a component-selection observation is diagonal) or the generic
`proposals.ekf_proposal` ('extended', 'unscented'). On this model the
three agree to sigma-point rounding. `make_model` builds the four
components on the card (or ``device``); `from_numpy` builds them from a
JAX model's numbers.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from .. import device as _device
from .. import proposals as _proposals
from ..distributions import MultivariateNormalDiag
from ..state import BatchShapeMode

__all__ = ["lorenz96_drift", "rk4_step", "Initial", "Transition",
           "Emission", "BootstrapProposal", "assimilation_proposal",
           "make_model", "from_numpy"]


def lorenz96_drift(x, forcing: float = 8.0):
    """dx/dt of the Lorenz-96 system; ``x`` is `[..., D]`, D >= 4."""
    xp1 = torch.roll(x, -1, dims=-1)
    xm1 = torch.roll(x, 1, dims=-1)
    xm2 = torch.roll(x, 2, dims=-1)
    return (xp1 - xm2) * xm1 - x + forcing


def rk4_step(x, dt: float = 0.05, forcing: float = 8.0):
    """One classical Runge-Kutta-4 step of the Lorenz-96 flow."""
    k1 = lorenz96_drift(x, forcing)
    k2 = lorenz96_drift(x + 0.5 * dt * k1, forcing)
    k3 = lorenz96_drift(x + 0.5 * dt * k2, forcing)
    k4 = lorenz96_drift(x + dt * k3, forcing)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


class Initial(nn.Module):
    """p(x_0) = N(loc, scale^2 I), loc = F 1 with its first component
    nudged by 0.01 off the drift's symmetric fixed point (the usual
    spin-up initialization)."""

    def __init__(self, dim: int, forcing: float = 8.0, scale: float = 1.0):
        super().__init__()
        self.dim, self.forcing, self.scale = int(dim), float(forcing), \
            float(scale)
        loc = np.full((self.dim,), self.forcing, np.float32)
        loc[0] += np.float32(0.01)
        self.register_buffer("loc", torch.tensor(loc))
        self.register_buffer("scale_diag",
                             torch.full((self.dim,), self.scale))

    def forward(self):
        return MultivariateNormalDiag(self.loc, self.scale_diag)


class Transition(nn.Module):
    """p(x_t | x_{t-1}) = N(rk4(x_{t-1}), q^2 I)."""

    def __init__(self, dim: int, dt: float = 0.05, forcing: float = 8.0,
                 scale: float = 0.5):
        super().__init__()
        self.dim, self.dt, self.forcing, self.scale = (
            int(dim), float(dt), float(forcing), float(scale))

    def mean(self, x):
        return rk4_step(x, self.dt, self.forcing)

    def forward(self, previous_latents=None, time=None,
                previous_observations=None):
        loc = self.mean(previous_latents[-1])
        return MultivariateNormalDiag(
            loc, torch.full_like(loc, self.scale),
            batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)


class Emission(nn.Module):
    """p(y_t | x_t) = N(x_t[obs_indices], r^2 I): a linear partial
    observation (every component when ``obs_indices`` is None)."""

    def __init__(self, dim: int, obs_indices=None, scale: float = 1.0):
        super().__init__()
        self.dim, self.scale = int(dim), float(scale)
        self.obs_indices = (None if obs_indices is None else
                            tuple(int(i) for i in obs_indices))
        self.register_buffer("index", torch.tensor(
            self.observed(), dtype=torch.long))

    def observed(self):
        """The observed components, as a list."""
        return (list(range(self.dim)) if self.obs_indices is None else
                list(self.obs_indices))

    def observe(self, x):
        if self.obs_indices is None:
            return x
        return torch.index_select(x, -1, self.index.to(x.device))

    def forward(self, latents=None, time=None, previous_observations=None):
        loc = self.observe(latents[-1])
        return MultivariateNormalDiag(
            loc, torch.full_like(loc, self.scale),
            batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)


class BootstrapProposal(nn.Module):
    """q = p: the prior at t = 0, the transition kernel after."""

    def __init__(self, initial: Initial, transition: Transition):
        super().__init__()
        self.initial = initial
        self.transition = transition

    def forward(self, previous_latents=None, time=None, observations=None):
        if time == 0:
            return self.initial()
        return self.transition(previous_latents=previous_latents, time=time)


class DiagonalAssimilationProposal(nn.Module):
    """The closed-form locally-optimal proposal: observed components take
    the precision-weighted update (m / q^2 + y / r^2) / (1 / q^2 + 1 / r^2),
    the others keep the prior. Elementwise arithmetic only."""

    def __init__(self, initial: Initial, transition: Transition,
                 emission: Emission):
        super().__init__()
        self.initial = initial
        self.transition = transition
        d = transition.dim
        mask = torch.zeros((d,))
        mask[emission.observed()] = 1.0
        self.register_buffer("obs_mask", mask)
        self.register_buffer("obs_index", emission.index.clone())
        self.r2 = float(emission.scale) ** 2

    def _scatter_obs(self, y):
        """y `[.., Do]` -> `[.., D]`, zeros off the observed components."""
        out = y.new_zeros(tuple(y.shape[:-1]) + (self.transition.dim,))
        return out.index_copy(-1, self.obs_index, y)

    def _condition(self, m, q2, y_full):
        post_var = 1.0 / (1.0 / q2 + self.obs_mask / self.r2)
        post_mean = post_var * (m / q2 + self.obs_mask * y_full / self.r2)
        return post_mean, torch.sqrt(post_var)

    def forward(self, previous_latents=None, time=None, observations=None):
        if previous_latents is None:
            y0 = self._scatter_obs(observations[0])          # [B, D]
            initial = self.initial
            loc, scale = self._condition(initial.loc,
                                         initial.scale_diag ** 2, y0)
            return MultivariateNormalDiag(
                loc, scale.expand_as(loc),
                batch_shape_mode=BatchShapeMode.BATCH_EXPANDED)
        x_prev = previous_latents[-1]                        # [B, K, D]
        y = self._scatter_obs(observations[time])            # [B, D]
        q2 = torch.full((), self.transition.scale, dtype=x_prev.dtype,
                        device=x_prev.device) ** 2
        loc, scale = self._condition(self.transition.mean(x_prev), q2,
                                     y[:, None, :])
        return MultivariateNormalDiag(
            loc, scale.expand_as(loc),
            batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)


def assimilation_proposal(initial: Initial, transition: Transition,
                          emission: Emission,
                          linearization: str = "diagonal",
                          unscented_kappa: float = 1.0) -> nn.Module:
    """The locally-optimal proposal of this model: one Kalman measurement
    update of N(rk4(x_{t-1}), q^2 I) against the linear observation, per
    particle.

    'diagonal' (the default) is the closed form
    (`DiagonalAssimilationProposal`); 'extended' and 'unscented' go
    through the generic `proposals.ekf_proposal` (batched `[B K, D, D]`
    Cholesky factors, solves and products). On this model all three agree
    to sigma-point rounding: the emission is linear and the propagated
    prior diagonal. The proposal is built on the components' device."""
    device = initial.loc.device
    if linearization == "diagonal":
        return DiagonalAssimilationProposal(initial, transition,
                                            emission).to(device)
    index = emission.index

    def emission_mean(x):
        return torch.index_select(x, -1, index)

    def eye(n):
        return torch.eye(n, device=device)

    return _proposals.ekf_proposal(
        transition_mean=transition.mean,
        transition_cov=transition.scale ** 2 * eye(transition.dim),
        emission_mean=emission_mean,
        emission_cov=emission.scale ** 2 * eye(len(emission.observed())),
        initial_mean=initial.loc, initial_cov=torch.diag(
            initial.scale_diag ** 2),
        linearization=linearization, unscented_kappa=unscented_kappa)


def _components(initial, transition, emission, proposal, device):
    if proposal not in ("bootstrap", "assimilation"):
        raise ValueError(
            "proposal must be 'bootstrap' or 'assimilation'. "
            f"currently = {proposal}")
    device = _device.resolve(device)
    initial, transition, emission = (module.to(device) for module in
                                     (initial, transition, emission))
    if proposal == "bootstrap":
        prop = BootstrapProposal(initial, transition)
    else:
        prop = assimilation_proposal(initial, transition, emission)
    return initial, transition, emission, prop.to(device)


def make_model(dim: int = 8, dt: float = 0.05, forcing: float = 8.0,
               transition_scale: float = 0.5, emission_scale: float = 1.0,
               obs_indices: Optional[Sequence[int]] = None,
               proposal: str = "assimilation", device=None):
    """(initial, transition, emission, proposal) on ``device`` (default:
    the card; raises without one).

    ``proposal``: 'bootstrap' or 'assimilation' (the closed form; the
    generic linearizations come from `assimilation_proposal`).
    ``obs_indices``: the observed components (default all; the classic
    hard setting observes every other one, ``range(0, dim, 2)``).
    """
    return _components(
        Initial(dim, forcing=forcing),
        Transition(dim, dt=dt, forcing=forcing, scale=transition_scale),
        Emission(dim, obs_indices=obs_indices, scale=emission_scale),
        proposal, device)


def from_numpy(params: dict, proposal: str = "assimilation", device=None):
    """(initial, transition, emission, proposal) from a JAX model's
    numbers, on ``device`` (default: the card; raises without one).

    ``params`` maps 'initial', 'transition' and 'emission' to dicts of the
    JAX components' fields: {'dim', 'forcing', 'scale'}, {'dim', 'dt',
    'forcing', 'scale'} and {'dim', 'obs_indices', 'scale'}.
    """
    init, tr, em = (params[k] for k in ("initial", "transition",
                                         "emission"))
    obs = em.get("obs_indices")
    return _components(
        Initial(int(init["dim"]), forcing=float(init["forcing"]),
                scale=float(init["scale"])),
        Transition(int(tr["dim"]), dt=float(tr["dt"]),
                   forcing=float(tr["forcing"]), scale=float(tr["scale"])),
        Emission(int(em["dim"]),
                 obs_indices=None if obs is None else [int(i) for i in obs],
                 scale=float(em["scale"])),
        proposal, device)
