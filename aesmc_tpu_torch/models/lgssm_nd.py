"""D-dimensional linear-Gaussian SSM, as `nn.Module`s.

    x_0 ~ N(loc, scale^2 I)
    x_t = A x_{t-1} + N(0, diag(q^2))
    y_t = C x_t + N(0, diag(r^2))

Counterpart of `aesmc_tpu.models.lgssm_nd` (the JAX bench's 10-dim
configuration): `Initial`, `Transition` and `Emission` on
`distributions.MultivariateNormalDiag` over `[batch, particle, D]`
latents, the learned affine `Proposal`, and `make_model`, a random stable
model (10-dim by default). `from_numpy` carries the JAX components'
fields across, so that both packages compute the same model in the tests.
`optimal_proposal` is the exact p(x_t | x_{t-1}, y_t), a full-covariance
Gaussian (`MultivariateNormalTriL`); `kalman_params` gives the exact
filter (`models.kalman_nd`) its parameters.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from .. import device as _device
from ..distributions import MultivariateNormalDiag, MultivariateNormalTriL
from ..state import BatchShapeMode
from . import kalman_nd


def _param(x) -> nn.Parameter:
    return nn.Parameter(torch.tensor(np.asarray(x, dtype=np.float32)))


def _scale(module, scale, size: int, train_scale: bool):
    """Sets ``module``'s noise scale `[size]`: a parameter with
    ``train_scale``, else a buffer that no optimizer sees (the JAX
    package's frozen static field)."""
    scale = np.broadcast_to(np.asarray(scale, np.float32), (size,))
    if train_scale:
        module.scale = _param(scale)
    else:
        module.scale = None
        module.register_buffer("frozen_scale", torch.tensor(scale.copy()))


class Initial(nn.Module):
    """p(x_0) = N(loc, scale^2 I); ``loc`` `[D]` is a parameter."""

    def __init__(self, loc, scale: float = 1.0):
        super().__init__()
        self.loc = _param(loc)
        self.scale = float(scale)

    @classmethod
    def create(cls, dim: int, loc: float = 0.0, scale: float = 1.0):
        return cls(np.full((dim,), float(loc)), scale)

    def forward(self):
        return MultivariateNormalDiag(self.loc,
                                      self.scale * torch.ones_like(self.loc))


class Transition(nn.Module):
    """x_t = A x_{t-1} + eps, eps ~ N(0, diag(scale^2)); A trainable, the
    scale trainable only with ``train_scale``."""

    def __init__(self, matrix, scale, train_scale: bool = False):
        super().__init__()
        self.matrix = _param(matrix)                         # [D, D]
        _scale(self, scale, self.matrix.shape[0], train_scale)

    @property
    def noise_scale(self):
        """The `[D]` noise scale, whether trainable or frozen."""
        return self.scale if self.scale is not None else self.frozen_scale

    def forward(self, previous_latents=None, time=None,
                previous_observations=None):
        loc = previous_latents[-1] @ self.matrix.T          # [B, K, D]
        return MultivariateNormalDiag(
            loc, self.noise_scale.to(loc.dtype) * torch.ones_like(loc),
            batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)


class Emission(nn.Module):
    """y_t = C x_t + eps, eps ~ N(0, diag(scale^2)); C `[D_obs, D]`
    trainable, the scale as in `Transition`."""

    def __init__(self, matrix, scale, train_scale: bool = False):
        super().__init__()
        self.matrix = _param(matrix)                         # [D_obs, D]
        _scale(self, scale, self.matrix.shape[0], train_scale)

    @property
    def noise_scale(self):
        """The `[D_obs]` noise scale, whether trainable or frozen."""
        return self.scale if self.scale is not None else self.frozen_scale

    def forward(self, latents=None, time=None, previous_observations=None):
        loc = latents[-1] @ self.matrix.T
        return MultivariateNormalDiag(
            loc, self.noise_scale.to(loc.dtype) * torch.ones_like(loc),
            batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)


class Proposal(nn.Module):
    """q(x_t | x_{t-1}, y_t) = N(W_x x_{t-1} + W_y y_t + b,
    diag(exp(log_scale)^2)); at t = 0 N(W_y0 y_0 + b_0,
    diag(exp(log_scale_0)^2))."""

    def __init__(self, w_prev, w_obs, bias, log_scale, w_obs_0, bias_0,
                 log_scale_0):
        super().__init__()
        self.w_prev = _param(w_prev)                         # [D, D]
        self.w_obs = _param(w_obs)                           # [D, D_obs]
        self.bias = _param(bias)                             # [D]
        self.log_scale = _param(log_scale)                   # [D]
        self.w_obs_0 = _param(w_obs_0)                       # [D, D_obs]
        self.bias_0 = _param(bias_0)                         # [D]
        self.log_scale_0 = _param(log_scale_0)               # [D]

    @classmethod
    def create(cls, dim: int, obs_dim: int,
               generator: Optional[torch.Generator] = None,
               init_scale: float = 1.0) -> "Proposal":
        """Weights uniform in +-1/sqrt(dim + obs_dim), zero biases and
        scales ``init_scale``, as the JAX package initializes them."""
        bound = 1.0 / np.sqrt(dim + obs_dim)

        def uniform(shape):
            u = torch.rand(shape, generator=generator)
            return ((2.0 * u - 1.0) * bound).numpy()

        log_scale = np.full((dim,), np.log(init_scale))
        return cls(uniform((dim, dim)), uniform((dim, obs_dim)),
                   np.zeros(dim), log_scale, uniform((dim, obs_dim)),
                   np.zeros(dim), log_scale)

    def forward(self, previous_latents=None, time=None, observations=None):
        if time == 0:
            loc = observations[0] @ self.w_obs_0.T + self.bias_0  # [B, D]
            return MultivariateNormalDiag(
                loc, torch.exp(self.log_scale_0) * torch.ones_like(loc),
                batch_shape_mode=BatchShapeMode.BATCH_EXPANDED)
        obs = observations[time]                             # [B, D_obs]
        loc = (previous_latents[-1] @ self.w_prev.T +
               (obs @ self.w_obs.T)[:, None, :] + self.bias)
        return MultivariateNormalDiag(
            loc, torch.exp(self.log_scale) * torch.ones_like(loc),
            batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)


class OptimalProposal(nn.Module):
    """The exact p(x_t | x_{t-1}, y_t) of the model, fixed: a Gaussian with
    covariance S = (Q^-1 + C^T R^-1 C)^-1 and mean S (Q^-1 A x_{t-1} +
    C^T R^-1 y_t), and at t = 0 the same update of the prior."""

    def __init__(self, initial_loc, initial_scale: float, matrix,
                 transition_scale, emission_matrix, emission_scale):
        super().__init__()
        a = np.asarray(matrix, np.float64)
        c = np.asarray(emission_matrix, np.float64)
        dim, obs_dim = a.shape[0], c.shape[0]
        q_inv = np.diag(1.0 / np.broadcast_to(
            np.asarray(transition_scale, np.float64) ** 2, (dim,)))
        r_inv = np.diag(1.0 / np.broadcast_to(
            np.asarray(emission_scale, np.float64) ** 2, (obs_dim,)))
        p0_inv = np.eye(dim) / float(initial_scale) ** 2
        gain = c.T @ r_inv                                   # [D, D_obs]
        cov_0 = np.linalg.inv(p0_inv + gain @ c)
        cov_t = np.linalg.inv(q_inv + gain @ c)

        def buffer(name, x):
            self.register_buffer(name, torch.tensor(
                np.asarray(x, np.float32)))

        buffer("mean_0", cov_0 @ p0_inv @ np.asarray(initial_loc, np.float64))
        buffer("obs_0", cov_0 @ gain)
        buffer("tril_0", np.linalg.cholesky(0.5 * (cov_0 + cov_0.T)))
        buffer("prev_t", cov_t @ q_inv @ a)
        buffer("obs_t", cov_t @ gain)
        buffer("tril_t", np.linalg.cholesky(0.5 * (cov_t + cov_t.T)))

    def forward(self, previous_latents=None, time=None, observations=None):
        if time == 0:
            loc = observations[0] @ self.obs_0.T + self.mean_0    # [B, D]
            return MultivariateNormalTriL(
                loc, self.tril_0,
                batch_shape_mode=BatchShapeMode.BATCH_EXPANDED)
        obs = observations[time]
        loc = (previous_latents[-1] @ self.prev_t.T +
               (obs @ self.obs_t.T)[:, None, :])
        return MultivariateNormalTriL(
            loc, self.tril_t,
            batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)


def make_model(dim: int = 10, obs_dim: Optional[int] = None, seed: int = 0,
               spectral_radius: float = 0.9, transition_scale: float = 1.0,
               emission_scale: float = 0.1, device=None):
    """A random stable D-dim model: (initial, transition, emission,
    proposal) on ``device`` (default: the card; raises without one).

    A = N(0, 1/D) entries scaled to ``spectral_radius``, C = N(0, 1/D)
    entries, drawn from a `torch.Generator` seeded with ``seed`` (the
    JAX package draws from a PRNG key, so the two models differ; use
    `from_numpy` for the same one).
    """
    device = _device.resolve(device)
    obs_dim = dim if obs_dim is None else obs_dim
    generator = torch.Generator().manual_seed(seed)
    a = (torch.randn((dim, dim), generator=generator) / np.sqrt(dim)).numpy()
    a = a * (spectral_radius / np.max(np.abs(np.linalg.eigvals(a))))
    c = (torch.randn((obs_dim, dim), generator=generator) /
         np.sqrt(dim)).numpy()
    return tuple(module.to(device) for module in (
        Initial.create(dim), Transition(a, transition_scale),
        Emission(c, emission_scale),
        Proposal.create(dim, obs_dim, generator)))


def optimal_proposal(initial: Initial, transition: Transition,
                     emission: Emission) -> OptimalProposal:
    """The `OptimalProposal` of the model's current parameters, on their
    device."""
    return OptimalProposal(
        initial.loc.detach().cpu().numpy(), initial.scale,
        transition.matrix.detach().cpu().numpy(),
        transition.noise_scale.detach().cpu().numpy(),
        emission.matrix.detach().cpu().numpy(),
        emission.noise_scale.detach().cpu().numpy()).to(
            transition.matrix.device)


def kalman_params(initial: Initial, transition: Transition,
                  emission: Emission) -> kalman_nd.KalmanNdParams:
    """The model's current parameters for `kalman_nd.kalman_filter_nd`."""
    def numpy(x):
        return x.detach().cpu().numpy().astype(np.float64)

    dim = initial.loc.shape[0]
    return kalman_nd.KalmanNdParams(
        initial_mean=numpy(initial.loc),
        initial_cov=np.eye(dim) * initial.scale ** 2,
        transition_matrix=numpy(transition.matrix),
        transition_cov=np.diag(numpy(transition.noise_scale) ** 2),
        emission_matrix=numpy(emission.matrix),
        emission_cov=np.diag(numpy(emission.noise_scale) ** 2))


def from_numpy(params: dict, device=None):
    """Builds (initial, transition, emission, proposal) from numpy fields,
    on ``device`` (default: the card; raises without one).

    ``params`` maps 'initial', 'transition', 'emission' and 'proposal' to
    dicts of the JAX components' fields: {'loc', 'scale'}; {'matrix',
    'scale', 'frozen_scale'} twice (a None 'scale' means the frozen one);
    and {'w_prev', 'w_obs', 'bias', 'log_scale', 'w_obs_0', 'bias_0',
    'log_scale_0'}.
    """
    device = _device.resolve(device)
    init, tr, em, prop = (params[k] for k in
                          ("initial", "transition", "emission", "proposal"))

    def linear(cls, fields):
        scale = fields.get("scale")
        trained = scale is not None and np.asarray(scale).dtype != object
        return cls(fields["matrix"],
                   scale if trained else fields["frozen_scale"],
                   train_scale=trained)

    return tuple(module.to(device) for module in (
        Initial(init["loc"], float(init["scale"])),
        linear(Transition, tr), linear(Emission, em),
        Proposal(*(prop[k] for k in ("w_prev", "w_obs", "bias", "log_scale",
                                     "w_obs_0", "bias_0", "log_scale_0")))))
