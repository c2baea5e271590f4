"""1-D linear-Gaussian SSM (the flagship workload), as `nn.Module`s.

Counterpart of `aesmc_tpu.models.lgssm` (`Initial`, `Transition`,
`Emission`, `Proposal`, and `Lookahead` for the auxiliary particle
filter) with the same call contract: each component's `forward` returns
a `distributions.Normal` tagged with its batch-shape mode (the
lookahead its `[B, K]` log-scores). `from_numpy` builds the four modules from the JAX components' fields,
so that both packages compute the same model in the tests.
"""

from __future__ import annotations

import math as _stdmath
from typing import Optional

import numpy as np
import torch
from torch import nn

from .. import device as _device
from ..distributions import Normal
from ..state import BatchShapeMode


def _param(x) -> nn.Parameter:
    return nn.Parameter(torch.tensor(np.asarray(x, dtype=np.float32)))


class Initial(nn.Module):
    """p(x_0) = N(loc, scale^2), not trainable."""

    def __init__(self, loc: float, scale: float):
        super().__init__()
        self.loc = float(loc)
        self.scale = float(scale)

    def forward(self):
        return Normal(self.loc, self.scale)


class Transition(nn.Module):
    """p(x_t | x_{t-1}) = N(mult * x_{t-1}, scale^2); `mult` trainable."""

    def __init__(self, mult: float, scale: float):
        super().__init__()
        self.mult = _param(mult)
        self.scale = float(scale)

    def forward(self, previous_latents=None, time=None,
                previous_observations=None):
        return Normal(self.mult * previous_latents[-1], self.scale,
                      batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)


class Emission(nn.Module):
    """p(y_t | x_t) = N(mult * x_t, scale^2); `mult` trainable."""

    def __init__(self, mult: float, scale: float):
        super().__init__()
        self.mult = _param(mult)
        self.scale = float(scale)

    def forward(self, latents=None, time=None, previous_observations=None):
        return Normal(self.mult * latents[-1], self.scale,
                      batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)


class Proposal(nn.Module):
    """Affine proposal with time-0 / time-t branches.

    q(x_0 | y_0)          = N(w0 * y_0 + b0, scale_0^2)
    q(x_t | x_{t-1}, y_t) = N(w[0] * x_{t-1} + w[1] * y_t + b, scale_t^2)
    """

    def __init__(self, lin_0_weight, lin_0_bias, lin_t_weight, lin_t_bias,
                 scale_0: float, scale_t: float):
        super().__init__()
        self.lin_0_weight = _param(lin_0_weight)
        self.lin_0_bias = _param(lin_0_bias)
        self.lin_t_weight = _param(lin_t_weight)     # [2]
        self.lin_t_bias = _param(lin_t_bias)
        self.scale_0 = float(scale_0)
        self.scale_t = float(scale_t)

    @classmethod
    def create(cls, scale_0: float, scale_t: float,
               generator: Optional[torch.Generator] = None) -> "Proposal":
        """Random affine init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)) as torch's
        `nn.Linear` (fan-in 1 at t = 0, 2 after)."""
        def uniform(shape, bound):
            u = torch.rand(shape, generator=generator)
            return ((2.0 * u - 1.0) * bound).numpy()

        bound_t = 1.0 / _stdmath.sqrt(2.0)
        return cls(uniform((), 1.0), uniform((), 1.0), uniform((2,), bound_t),
                   uniform((), bound_t), scale_0, scale_t)

    def forward(self, previous_latents=None, time=None, observations=None):
        if time == 0:
            loc = self.lin_0_weight * observations[0] + self.lin_0_bias
            return Normal(loc, self.scale_0,
                          batch_shape_mode=BatchShapeMode.BATCH_EXPANDED)
        previous_latent = previous_latents[-1]              # [B, K]
        obs_t = observations[time]                          # [B]
        loc = (self.lin_t_weight[0] * previous_latent +
               self.lin_t_weight[1] * obs_t[:, None] +
               self.lin_t_bias)
        return Normal(loc, self.scale_t,
                      batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)


class Lookahead(nn.Module):
    """The exact one-step predictive log p(y_t | x_{t-1}), the score of the
    fully adapted auxiliary particle filter on this model
    (``infer(..., lookahead=Lookahead(...))``): y_t | x_{t-1} ~
    N(em tr x_{t-1}, em^2 tr_scale^2 + em_scale^2). The multipliers are
    trainable."""

    def __init__(self, transition_mult: float, transition_scale: float,
                 emission_mult: float, emission_scale: float):
        super().__init__()
        self.transition_mult = _param(transition_mult)
        self.emission_mult = _param(emission_mult)
        self.transition_scale = float(transition_scale)
        self.emission_scale = float(emission_scale)

    def forward(self, previous_latents=None, time=None, observations=None):
        loc = (self.emission_mult * self.transition_mult *
               previous_latents[-1])                        # [B, K]
        scale = torch.sqrt((self.emission_mult * self.transition_scale) ** 2
                           + self.emission_scale ** 2)
        obs_t = observations[time]                          # [B]
        return Normal(loc, scale).log_prob(obs_t[:, None])


def optimal_proposal(initial_loc: float, initial_scale: float,
                     transition_mult: float, transition_scale: float,
                     emission_mult: float, emission_scale: float
                     ) -> Proposal:
    """The exactly optimal proposal p(x_t | x_{t-1}, y_t) of the LGSSM,
    which is affine: a Gaussian with precision 1/q + c^2/r."""
    q0, q = initial_scale ** 2, transition_scale ** 2
    r = emission_scale ** 2
    c = emission_mult
    prec_0 = 1.0 / q0 + c * c / r
    prec_t = 1.0 / q + c * c / r
    return Proposal(
        lin_0_weight=(c / r) / prec_0,
        lin_0_bias=(initial_loc / q0) / prec_0,
        lin_t_weight=[(transition_mult / q) / prec_t, (c / r) / prec_t],
        lin_t_bias=0.0,
        scale_0=_stdmath.sqrt(1.0 / prec_0),
        scale_t=_stdmath.sqrt(1.0 / prec_t))


def optimal_proposal_scales(initial_scale, transition_scale, emission_mult,
                            emission_scale):
    """The optimal proposal's standard deviations (scale_0, scale_t): the
    prior scale shrunk by one Kalman update."""
    def scale(prior_scale):
        v = prior_scale ** 2
        return np.sqrt(v - v * emission_mult /
                       (emission_scale ** 2 + v * emission_mult ** 2) *
                       emission_mult * v)
    return scale(initial_scale), scale(transition_scale)


def from_numpy(params: dict, device=None):
    """Builds (initial, transition, emission, proposal) from numpy fields,
    on ``device`` (default: the card; raises without one).

    ``params`` maps 'initial', 'transition', 'emission' and 'proposal' to
    dicts of the JAX components' fields: {'loc', 'scale'}, {'mult',
    'scale'}, {'mult', 'scale'} and {'lin_0_weight', 'lin_0_bias',
    'lin_t_weight', 'lin_t_bias', 'scale_0', 'scale_t'}.
    """
    device = _device.resolve(device)
    init, tr, em, prop = (params[k] for k in
                          ("initial", "transition", "emission", "proposal"))
    return tuple(module.to(device) for module in (
        Initial(init["loc"], init["scale"]),
        Transition(tr["mult"], tr["scale"]),
        Emission(em["mult"], em["scale"]),
        Proposal(prop["lin_0_weight"], prop["lin_0_bias"],
                 prop["lin_t_weight"], prop["lin_t_bias"],
                 prop["scale_0"], prop["scale_t"])))
