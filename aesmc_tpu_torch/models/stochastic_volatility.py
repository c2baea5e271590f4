"""Nonlinear stochastic-volatility SSM, as `nn.Module`s.

    x_0 ~ N(mu, sigma^2 / (1 - phi^2))          (stationary prior)
    x_t = mu + phi (x_{t-1} - mu) + N(0, sigma^2)
    y_t = exp(x_t / 2) N(0, beta^2)

Counterpart of `aesmc_tpu.models.stochastic_volatility`: the parameters
are learned unconstrained (phi = tanh(raw_phi), sigma and beta as logs),
and the proposal is a learned Gaussian affine in (x_{t-1}, log y_t^2).
`from_numpy` carries the JAX components' fields across, so that both
packages compute the same model in the tests.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import device as _device
from ..distributions import Normal
from ..state import BatchShapeMode


def _param(x) -> nn.Parameter:
    return nn.Parameter(torch.tensor(np.asarray(x, dtype=np.float32)))


class _Dynamics(nn.Module):
    """The parameters (mu, raw_phi, log_sigma) of `Initial` and
    `Transition`."""

    def __init__(self, mu, raw_phi, log_sigma):
        super().__init__()
        self.mu = _param(mu)
        self.raw_phi = _param(raw_phi)
        self.log_sigma = _param(log_sigma)

    @classmethod
    def create(cls, mu=0.0, phi=0.95, sigma=0.2):
        return cls(float(mu), float(np.arctanh(phi)), float(np.log(sigma)))


class Initial(_Dynamics):
    """The stationary prior N(mu, sigma^2 / (1 - phi^2))."""

    def forward(self):
        sigma = torch.exp(self.log_sigma)
        phi = torch.tanh(self.raw_phi)
        return Normal(self.mu, sigma / torch.sqrt(1.0 - phi ** 2))


class Transition(_Dynamics):
    """x_t = mu + phi (x_{t-1} - mu) + N(0, sigma^2)."""

    def forward(self, previous_latents=None, time=None,
                previous_observations=None):
        prev = previous_latents[-1]
        loc = self.mu + torch.tanh(self.raw_phi) * (prev - self.mu)
        return Normal(loc, torch.exp(self.log_sigma),
                      batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)


class Emission(nn.Module):
    """y_t ~ N(0, (beta exp(x_t / 2))^2)."""

    def __init__(self, log_beta):
        super().__init__()
        self.log_beta = _param(log_beta)

    @classmethod
    def create(cls, beta=1.0):
        return cls(float(np.log(beta)))

    def forward(self, latents=None, time=None, previous_observations=None):
        x = latents[-1]
        return Normal(torch.zeros_like(x), torch.exp(self.log_beta + x / 2.0),
                      batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)


class Proposal(nn.Module):
    """q(x_t | x_{t-1}, y_t) = N(w_prev x_{t-1} + w_obs log(y_t^2 + 1e-4) +
    bias, exp(log_scale)^2); at t = 0 affine in log(y_0^2 + 1e-4)."""

    def __init__(self, w_prev, w_obs, bias, log_scale, w_obs_0, bias_0,
                 log_scale_0):
        super().__init__()
        self.w_prev = _param(w_prev)
        self.w_obs = _param(w_obs)
        self.bias = _param(bias)
        self.log_scale = _param(log_scale)
        self.w_obs_0 = _param(w_obs_0)
        self.bias_0 = _param(bias_0)
        self.log_scale_0 = _param(log_scale_0)

    @classmethod
    def create(cls, init_scale=0.3):
        """The JAX package's deterministic initialization."""
        log_scale = float(np.log(init_scale))
        return cls(0.9, 0.0, 0.0, log_scale, 0.0, 0.0, log_scale)

    @staticmethod
    def _feat(y):
        return torch.log(y ** 2 + 1e-4)

    def forward(self, previous_latents=None, time=None, observations=None):
        if time == 0:
            loc = self.w_obs_0 * self._feat(observations[0]) + self.bias_0
            return Normal(loc, torch.exp(self.log_scale_0),
                          batch_shape_mode=BatchShapeMode.BATCH_EXPANDED)
        y = observations[time]                               # [B]
        loc = (self.w_prev * previous_latents[-1] +
               self.w_obs * self._feat(y)[:, None] + self.bias)
        return Normal(loc, torch.exp(self.log_scale),
                      batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)


def make_model(mu=0.0, phi=0.95, sigma=0.2, beta=0.7, device=None):
    """(initial, transition, emission, proposal) on ``device`` (default:
    the card; raises without one)."""
    device = _device.resolve(device)
    return tuple(module.to(device) for module in (
        Initial.create(mu, phi, sigma), Transition.create(mu, phi, sigma),
        Emission.create(beta), Proposal.create()))


def from_numpy(params: dict, device=None):
    """Builds (initial, transition, emission, proposal) from numpy fields,
    on ``device`` (default: the card; raises without one).

    ``params`` maps 'initial' and 'transition' to {'mu', 'raw_phi',
    'log_sigma'}, 'emission' to {'log_beta'} and 'proposal' to {'w_prev',
    'w_obs', 'bias', 'log_scale', 'w_obs_0', 'bias_0', 'log_scale_0'}:
    the JAX components' fields.
    """
    device = _device.resolve(device)
    init, tr, em, prop = (params[k] for k in
                          ("initial", "transition", "emission", "proposal"))
    dynamics = ("mu", "raw_phi", "log_sigma")
    return tuple(module.to(device) for module in (
        Initial(*(init[k] for k in dynamics)),
        Transition(*(tr[k] for k in dynamics)),
        Emission(em["log_beta"]),
        Proposal(*(prop[k] for k in ("w_prev", "w_obs", "bias", "log_scale",
                                     "w_obs_0", "bias_0", "log_scale_0")))))
