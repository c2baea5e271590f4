"""1-D linear-Gaussian SSM (the flagship workload), as `nn.Module`s.

Counterpart of `aesmc_tpu.models.lgssm` (`Initial`, `Transition`,
`Emission`, `Proposal`, and `Lookahead` for the auxiliary particle
filter) with the same call contract: each component's `forward` returns
a `distributions.Normal` tagged with its batch-shape mode (the
lookahead its `[B, K]` log-scores). `from_numpy` builds the four modules
from the JAX components' fields, so that both packages compute the same
model in the tests. `lgssm_true_posterior` is the exact smoothed
posterior, and `TrainingStats` the training callback that tracks the
parameters' and the proposal's distance to it.
"""

from __future__ import annotations

import math as _stdmath
from typing import Optional

import numpy as np
import torch
from torch import nn

from .. import device as _device
from .. import inference, statistics, train
from ..distributions import Normal
from ..noise import NoiseSource
from ..state import BatchShapeMode
from . import kalman


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


def lgssm_true_posterior(observations, initial_loc, initial_scale,
                         transition_mult, transition_bias, transition_scale,
                         emission_mult, emission_bias, emission_scale):
    """The exact smoothed posterior of one observation sequence `[T]`, by
    the RTS smoother (`kalman.kalman_smoother`, numpy float64): (means
    `[T, 1]`, variances `[T, 1, 1]`), in pykalman's shapes."""
    params = kalman.KalmanParams(
        initial_mean=float(initial_loc),
        initial_variance=float(initial_scale) ** 2,
        transition_mult=float(transition_mult),
        transition_offset=float(transition_bias),
        transition_variance=float(transition_scale) ** 2,
        emission_mult=float(emission_mult),
        emission_offset=float(emission_bias),
        emission_variance=float(emission_scale) ** 2)
    means, variances = kalman.kalman_smoother(
        np.asarray(observations, dtype=np.float64).reshape(-1), params)
    return means[:, None], variances[:, None, None]


class TrainingStats:
    """`train.train` callback: every ``saving_interval`` iterations it
    records ||theta - theta*|| of the (transition, emission) multipliers
    and the mean L2 distance between the proposal's importance-sampled
    posterior means and the exact smoother's on ``num_test_obs`` held-out
    sequences; every ``logging_interval`` it prints the loss. Each record
    reads the device.

    The held-out data and the inference noise come from ``generator`` (a
    `torch.Generator`, whose device is where the data and the noise live;
    default a card generator seeded 42). On the CPU pass
    ``generator=torch.Generator()``.
    """

    def __init__(self, initial_loc, initial_scale, true_transition_mult,
                 transition_scale, true_emission_mult, emission_scale,
                 num_timesteps, num_test_obs, test_inference_num_particles,
                 saving_interval=100, logging_interval=100, generator=None,
                 verbose: bool = True):
        if generator is None:
            generator = torch.Generator(device=_device.resolve())
            generator.manual_seed(42)
        device = generator.device
        self.noise = NoiseSource(generator)
        self.true_transition_mult = true_transition_mult
        self.true_emission_mult = true_emission_mult
        self.test_inference_num_particles = test_inference_num_particles
        self.saving_interval = saving_interval
        self.logging_interval = logging_interval
        self.verbose = verbose
        self.p_l2_history = []
        self.q_l2_history = []
        self.iteration_idx_history = []
        self.initial = Initial(initial_loc, initial_scale).to(device)
        self.true_transition = Transition(true_transition_mult,
                                          transition_scale).to(device)
        self.true_emission = Emission(true_emission_mult,
                                      emission_scale).to(device)
        dataloader = train.get_synthetic_dataloader(
            self.initial, self.true_transition, self.true_emission,
            num_timesteps, num_test_obs, noise=self.noise)
        self.test_obs = next(iter(dataloader))          # [T, num_test_obs]
        test_obs_np = self.test_obs.cpu().numpy()
        self.true_posterior_means = np.stack([
            lgssm_true_posterior(
                test_obs_np[:, i], initial_loc, initial_scale,
                true_transition_mult, 0.0, transition_scale,
                true_emission_mult, 0.0, emission_scale)[0].reshape(-1)
            for i in range(num_test_obs)], axis=0)      # [num_test_obs, T]

    def _held_out_posterior_means(self, proposal):
        with torch.no_grad():
            result = inference.infer(
                "is", self.test_obs, self.initial, self.true_transition,
                self.true_emission, proposal,
                self.test_inference_num_particles, noise=self.noise)
        # latents [T, B, K] -> value [B, K, T] for empirical_mean.
        value = result["latents"].permute(1, 2, 0)
        return statistics.empirical_mean(value, result["log_weight"])

    def __call__(self, epoch_idx, epoch_iteration_idx, loss, initial,
                 transition, emission, proposal):
        if epoch_iteration_idx % self.saving_interval == 0:
            self.p_l2_history.append(float(np.linalg.norm(
                np.array([float(transition.mult.detach()),
                          float(emission.mult.detach())]) -
                np.array([self.true_transition_mult,
                          self.true_emission_mult]))))
            posterior_means = self._held_out_posterior_means(
                proposal).cpu().numpy()
            self.q_l2_history.append(float(np.mean(np.linalg.norm(
                self.true_posterior_means - posterior_means, axis=1))))
            self.iteration_idx_history.append(epoch_iteration_idx)
        if self.verbose and epoch_iteration_idx % self.logging_interval == 0:
            print("Iteration {}: Loss = {}".format(
                epoch_iteration_idx, float(loss)))
