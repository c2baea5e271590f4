"""Bouncing-ball deep SSM with an amortized MLP proposal, as `nn.Module`s.

Counterpart of `aesmc_tpu.models.bouncing_ball` (the JAX bench's config 4:
64-step sequences, 32 pixels, MLP hidden width 64). A ball bounces
elastically in [0, 1]:

    latent x_t = (position p_t, velocity v_t) in R^2
    p_t = reflect(p_{t-1} + dt * v_{t-1}) + noise
    v_t = v_{t-1} (sign-flipped at bounces) + noise
    y_t = render(p_t) + noise   -- a P-pixel 1-D frame: a Gaussian bump
                                   of width `blur` centred at p_t

The emission adds a learned MLP residual to the renderer; the proposal is
an amortized MLP encoder over (previous latent, current frame). The
reflection is the triangular wave, with no data-dependent branch.
`from_numpy` carries the JAX model's parameters across (MLP weights in
the JAX `[in, out]` layout, and the log-noises). `gaussian_spec` is the
twisted-SMC view of the dynamics (`twisted.GaussianSSMSpec`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from .. import device as _device
from ..distributions import MultivariateNormalDiag
from ..state import BatchShapeMode
from ..utils import MLP

NUM_PIXELS = 32
DT = 0.1


def reflect(p):
    """Positions folded into [0, 1] with elastic reflection (the triangular
    wave): reflect(p) = 1 - |mod(p, 2) - 1|."""
    return 1.0 - torch.abs(torch.remainder(p, 2.0) - 1.0)


def reflected_velocity_sign(p):
    """-1 where the unfolded position sits on a descending segment, else
    1."""
    return torch.where(torch.remainder(p, 2.0) < 1.0, 1.0, -1.0)


def render(position, num_pixels: int = NUM_PIXELS, blur: float = 0.08):
    """`[...]` positions -> `[..., P]` Gaussian-bump frames."""
    grid = torch.linspace(0.0, 1.0, num_pixels, device=position.device,
                          dtype=position.dtype)
    diff = position[..., None] - grid
    return torch.exp(-0.5 * (diff / blur) ** 2)


def _param(x):
    """A float32 `nn.Parameter` of a number or numpy array; a `torch.Tensor`
    is kept as given (device, dtype and graph, not registered, not moved
    by `.to()`), as `lgssm._param` documents."""
    if isinstance(x, torch.Tensor):
        return x
    return nn.Parameter(torch.tensor(np.asarray(x, dtype=np.float32)))


class Initial(nn.Module):
    """p(x_0) = N([0.5, 0], diag(position_scale, velocity_scale)^2), not
    trainable."""

    def __init__(self, position_scale: float = 0.25,
                 velocity_scale: float = 1.0):
        super().__init__()
        self.position_scale = float(position_scale)
        self.velocity_scale = float(velocity_scale)
        self.register_buffer("loc", torch.tensor([0.5, 0.0]))
        self.register_buffer("scale", torch.tensor(
            [self.position_scale, self.velocity_scale]))

    def forward(self):
        return MultivariateNormalDiag(self.loc, self.scale)


class Transition(nn.Module):
    """The reflected constant-velocity step with diagonal Gaussian noise;
    the two log-noises are trainable."""

    def __init__(self, log_pos_noise, log_vel_noise):
        super().__init__()
        self.log_pos_noise = _param(log_pos_noise)
        self.log_vel_noise = _param(log_vel_noise)

    @classmethod
    def create(cls, pos_noise: float = 0.01, vel_noise: float = 0.05):
        return cls(np.log(pos_noise), np.log(vel_noise))

    def forward(self, previous_latents=None, time=None,
                previous_observations=None):
        prev = previous_latents[-1]                     # [..., 2]
        p, v = prev[..., 0], prev[..., 1]
        raw = p + DT * v
        loc = torch.stack([reflect(raw), v * reflected_velocity_sign(raw)],
                          dim=-1)
        scale = torch.stack(
            [torch.exp(self.log_pos_noise).expand_as(p),
             torch.exp(self.log_vel_noise).expand_as(v)], dim=-1)
        return MultivariateNormalDiag(
            loc, scale, batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)


class Emission(nn.Module):
    """Deep emission: the frame's loc is the renderer plus a learned MLP
    residual (`decoder`, [2 -> hidden -> P]) when ``use_decoder``."""

    def __init__(self, decoder: MLP, log_noise, num_pixels: int = NUM_PIXELS,
                 use_decoder: bool = True):
        super().__init__()
        self.decoder = decoder
        self.log_noise = _param(log_noise)
        self.num_pixels = int(num_pixels)
        self.use_decoder = bool(use_decoder)

    @classmethod
    def create(cls, generator: Optional[torch.Generator] = None,
               noise: float = 0.05, hidden: int = 64,
               num_pixels: int = NUM_PIXELS, use_decoder: bool = True,
               compute_dtype=None, device=None):
        """The decoder's first layer random (`MLP.create`), its output layer
        zero: the decoder starts as a no-op residual."""
        decoder = MLP.create((2, hidden, num_pixels), generator,
                             compute_dtype=compute_dtype, device=device)
        with torch.no_grad():
            decoder.weights[1].zero_()
        return cls(decoder, np.log(noise), num_pixels,
                   use_decoder).to(decoder.weights[0].device)

    def forward(self, latents=None, time=None, previous_observations=None):
        x = latents[-1]                                 # [..., 2]
        loc = render(x[..., 0], self.num_pixels)
        if self.use_decoder:
            loc = loc + self.decoder(x)
        scale = torch.exp(self.log_noise).expand_as(loc)
        return MultivariateNormalDiag(
            loc, scale, batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)


class Proposal(nn.Module):
    """Amortized MLP encoder q(x_t | x_{t-1}, y_t).

    t = 0: encoder_0(y_0) -> (loc, log_scale) of the 2-d latent.
    t >= 1: encoder_t([x_{t-1}, y_t]) -> (loc, log_scale).
    """

    def __init__(self, encoder_0: MLP, encoder_t: MLP):
        super().__init__()
        self.encoder_0 = encoder_0          # MLP [P -> hidden -> 4]
        self.encoder_t = encoder_t          # MLP [2 + P -> hidden -> 4]

    @classmethod
    def create(cls, generator: Optional[torch.Generator] = None,
               hidden: int = 64, num_pixels: int = NUM_PIXELS,
               compute_dtype=None, device=None):
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        return cls(MLP.create((num_pixels, hidden, 4), generator,
                              compute_dtype=compute_dtype, device=device),
                   MLP.create((2 + num_pixels, hidden, 4), generator,
                              compute_dtype=compute_dtype, device=device))

    @staticmethod
    def _dist(out, mode):
        loc, log_scale = out[..., :2], out[..., 2:]
        return MultivariateNormalDiag(
            loc, torch.exp(torch.clamp(log_scale, -5.0, 2.0)),
            batch_shape_mode=mode)

    def forward(self, previous_latents=None, time=None, observations=None):
        # `time == 0` reads nothing from the device, even for a
        # `DeviceTimeIndex`, which `observations[time]` then indexes with.
        if time == 0:
            y = observations[0]                          # [B, P]
            return self._dist(self.encoder_0(y),
                              BatchShapeMode.BATCH_EXPANDED)
        prev = previous_latents[-1]                      # [B, K, 2]
        y = observations[time]                           # [B, P]
        y_expanded = y[:, None, :].expand(
            tuple(prev.shape[:2]) + tuple(y.shape[-1:]))
        inp = torch.cat([prev, y_expanded], dim=-1)
        return self._dist(self.encoder_t(inp),
                          BatchShapeMode.FULLY_EXPANDED)


def gaussian_spec(transition: Transition, initial: Optional[Initial] = None):
    """`twisted.GaussianSSMSpec` view of the bouncing-ball dynamics, on the
    transition's device and in its dtype.

    The transition is a diagonal Gaussian around the reflection map, so
    twisted SMC's closed-form Gaussian kernels apply as they are; the
    renderer emission makes the optimal twist p(y_{t:T-1} | x_t) far from
    log-quadratic in x_t (the deep-model regime of `twisted.learn_twist`).
    The scales come from the transition's log-noises (not detached) and
    the initial's scales (``Initial()``'s when None).
    """
    from .. import twisted

    if initial is None:
        initial = Initial()
    like = transition.log_pos_noise

    def mean_fn(prev, time):
        del time
        p, v = prev[..., 0], prev[..., 1]
        raw = p + DT * v
        return torch.stack([reflect(raw), v * reflected_velocity_sign(raw)],
                           dim=-1)

    def const(values):
        return torch.stack([torch.full((), v, dtype=like.dtype,
                                       device=like.device) for v in values])

    return twisted.GaussianSSMSpec(
        initial_loc=const([0.5, 0.0]),
        initial_scale=const([initial.position_scale,
                             initial.velocity_scale]),
        transition_scale=torch.stack(
            [torch.exp(transition.log_pos_noise),
             torch.exp(transition.log_vel_noise)]).to(like.dtype),
        mean_fn=mean_fn)


def make_model(generator: Optional[torch.Generator] = None,
               num_pixels: int = NUM_PIXELS, hidden: int = 64,
               compute_dtype=None, device=None):
    """(initial, transition, emission, proposal) with random MLPs drawn
    from ``generator`` (a CPU `torch.Generator`; seed 0 if None), on
    ``device`` (default: the card; raises without one).
    ``compute_dtype='bfloat16'``: bf16 MLP product inputs with float32
    outputs (`utils.mixed_dot`)."""
    device = _device.resolve(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return (Initial().to(device),
            Transition.create().to(device),
            Emission.create(generator, hidden=hidden, num_pixels=num_pixels,
                            compute_dtype=compute_dtype, device=device),
            Proposal.create(generator, hidden=hidden, num_pixels=num_pixels,
                            compute_dtype=compute_dtype, device=device))


def from_numpy(params: dict, compute_dtype=None, device=None):
    """Builds (initial, transition, emission, proposal) from numpy fields,
    on ``device`` (default: the card; raises without one).

    ``params`` maps 'initial' to {'position_scale', 'velocity_scale'},
    'transition' to {'log_pos_noise', 'log_vel_noise'}, 'emission' to
    {'decoder', 'log_noise', 'num_pixels', 'use_decoder'} and 'proposal'
    to {'encoder_0', 'encoder_t'}, where each MLP is {'weights',
    'biases'} in the JAX `[in, out]` layout.
    """
    device = _device.resolve(device)
    init, tr, em, prop = (params[k] for k in
                          ("initial", "transition", "emission", "proposal"))

    def mlp(fields):
        return MLP.from_numpy(fields["weights"], fields["biases"],
                              compute_dtype=compute_dtype, device=device)

    return (Initial(init["position_scale"],
                    init["velocity_scale"]).to(device),
            Transition(tr["log_pos_noise"], tr["log_vel_noise"]).to(device),
            Emission(mlp(em["decoder"]), em["log_noise"],
                     em.get("num_pixels", NUM_PIXELS),
                     em.get("use_decoder", True)).to(device),
            Proposal(mlp(prop["encoder_0"]),
                     mlp(prop["encoder_t"])).to(device))
