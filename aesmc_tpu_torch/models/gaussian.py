"""Conjugate-Gaussian test model (a one-timestep VAE), as `nn.Module`s.

Counterpart of `aesmc_tpu.models.gaussian`: a learnable prior mean, a
learnable observation std, a learnable affine amortized proposal, the
closed-form optimal proposal parameters, and a training-stats callback.
`from_numpy` builds the three modules from the JAX components' fields.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import device as _device
from ..distributions import Normal
from ..state import BatchShapeMode


def _param(x):
    """A float32 `nn.Parameter` of a number or numpy array; a `torch.Tensor`
    is kept as given (device, dtype and graph, not registered, not moved
    by `.to()`), as `lgssm._param` documents."""
    if isinstance(x, torch.Tensor):
        return x
    return nn.Parameter(torch.tensor(np.asarray(x, dtype=np.float32)))


def _log(x) -> np.ndarray:
    return np.log(np.float32(x))


class Prior(nn.Module):
    """p(x) = N(mean, std^2); `mean` trainable."""

    def __init__(self, mean, std: float):
        super().__init__()
        self.mean = _param(mean)
        self.std = float(std)

    @classmethod
    def create(cls, init_mean, std) -> "Prior":
        return cls(float(init_mean), std)

    def forward(self):
        return Normal(self.mean, self.std)


class Likelihood(nn.Module):
    """p(y|x) = N(x, exp(log_std)^2); `log_std` trainable."""

    def __init__(self, log_std):
        super().__init__()
        self.log_std = _param(log_std)

    @classmethod
    def create(cls, init_std) -> "Likelihood":
        return cls(_log(init_std))

    def forward(self, latents=None, time=None, previous_observations=None):
        return Normal(latents[-1], torch.exp(self.log_std),
                      batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)


class InferenceNetwork(nn.Module):
    """q(x|y) = N(mult * y + bias, exp(log_std)^2); all three trainable."""

    def __init__(self, mult, bias, log_std):
        super().__init__()
        self.mult = _param(mult)
        self.bias = _param(bias)
        self.log_std = _param(log_std)

    @classmethod
    def create(cls, init_mult, init_bias, init_std) -> "InferenceNetwork":
        return cls(float(init_mult), float(init_bias), _log(init_std))

    def forward(self, previous_latents=None, time=None, observations=None):
        loc = self.mult * observations[0] + self.bias
        return Normal(loc, torch.exp(self.log_std),
                      batch_shape_mode=BatchShapeMode.BATCH_EXPANDED)


def get_proposal_params(prior_mean, prior_std, obs_std):
    """Closed-form optimal proposal N(mult * y + offset, std^2) of the
    conjugate model: (mult, offset, std)."""
    posterior_var = 1.0 / (1.0 / prior_std ** 2 + 1.0 / obs_std ** 2)
    posterior_std = np.sqrt(posterior_var)
    multiplier = posterior_var / obs_std ** 2
    offset = posterior_var * prior_mean / prior_std ** 2
    return multiplier, offset, posterior_std


def from_numpy(params: dict, device=None):
    """Builds (prior, likelihood, inference_network) from numpy fields, on
    ``device`` (default: the card; raises without one).

    ``params`` maps 'prior', 'likelihood' and 'inference_network' to dicts
    of the JAX components' fields: {'mean', 'std'}, {'log_std'} and
    {'mult', 'bias', 'log_std'}.
    """
    device = _device.resolve(device)
    prior, lik, q = (params[k] for k in
                     ("prior", "likelihood", "inference_network"))
    return tuple(module.to(device) for module in (
        Prior(prior["mean"], prior["std"]),
        Likelihood(lik["log_std"]),
        InferenceNetwork(q["mult"], q["bias"], q["log_std"])))


class TrainingStats:
    """Per-iteration parameter-history callback for `train.train`. Stores
    plain floats (it reads each value back from the device)."""

    def __init__(self, logging_interval: int = 100, verbose: bool = True):
        self.prior_mean_history = []
        self.obs_std_history = []
        self.q_mult_history = []
        self.q_bias_history = []
        self.q_std_history = []
        self.iteration_idx_history = []
        self.loss_history = []
        self.logging_interval = logging_interval
        self.verbose = verbose

    def __call__(self, epoch_idx, epoch_iteration_idx, loss, initial,
                 transition, emission, proposal):
        self.prior_mean_history.append(initial.mean.item())
        self.obs_std_history.append(torch.exp(emission.log_std).item())
        self.q_mult_history.append(proposal.mult.item())
        self.q_bias_history.append(proposal.bias.item())
        self.q_std_history.append(torch.exp(proposal.log_std).item())
        self.loss_history.append(loss.item())
        self.iteration_idx_history.append(epoch_iteration_idx)
        if self.verbose and epoch_iteration_idx % self.logging_interval == 0:
            print('Iteration: {} - Loss: {}'.format(
                epoch_iteration_idx, loss.item()))
