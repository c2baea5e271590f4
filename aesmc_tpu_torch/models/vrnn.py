"""VRNN-style recurrent deep state-space model (the FIVO construction).

Counterpart of `aesmc_tpu.models.vrnn`: the deep SSM with an amortized
proposal network. A causal GRU runs over the observations,

    h_t = GRU(h_{t-1}, y_{t-1}),        h_0 = 0,

so h_t is a deterministic function of y_{<t}, and the SSM is

    z_0 ~ N(0, I)
    z_t ~ N(prior_net([z_{t-1}, h_t]))          (transition)
    y_t ~ N(decoder([z_t, h_t]), noise)         (emission)
    q(z_t | .) = N(encoder_net([h_t, y_t]))     (proposal)

Because h depends only on the data, `Encoder.encode` computes it once per
batch and `bind` hands the same `h_seq` tensor to the transition, the
emission and the proposal, so the GRU's gradient sums over its three
consumers. `vrnn_loss` packages this for training. `bind_on_call` gives
components that encode the observations they are called with, for the
training loops that sample their own (`train.train_on_device`), and
`generative_components` the model as `statistics.sample_from_prior`
draws it (the GRU advancing on the sampled observations), on which
`generate` rests. Every product is one matmul over `[B, K, .]`
(`utils.mixed_dot`; ``compute_dtype='bfloat16'`` for bf16 inputs with
float32 outputs). Weights keep the JAX package's `[in, out]` layout, and
`from_numpy` carries its parameters across.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch
from torch import nn

from .. import device as _device
from .. import losses as _losses
from .. import statistics
from ..distributions import Deterministic, MultivariateNormalDiag
from ..state import BatchShapeMode
from ..utils import MLP, mixed_dot


def _param(x) -> nn.Parameter:
    return nn.Parameter(torch.tensor(np.asarray(x, dtype=np.float32)))


class GRUCell(nn.Module):
    """A minimal GRU; input `[.., I]`, hidden `[.., H]`. ``w_ru``
    `[I + H, 2H]` (reset and update gates), ``w_c`` `[I + H, H]` (the
    candidate). ``compute_dtype`` as `utils.MLP`'s."""

    def __init__(self, w_ru, b_ru, w_c, b_c,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        self.w_ru, self.b_ru = _param(w_ru), _param(b_ru)
        self.w_c, self.b_c = _param(w_c), _param(b_c)
        self.compute_dtype = compute_dtype

    @classmethod
    def create(cls, input_dim: int, hidden_dim: int,
               generator: torch.Generator,
               compute_dtype: Optional[str] = None):
        s = 1.0 / np.sqrt(input_dim + hidden_dim)

        def uniform(shape):
            return ((2.0 * torch.rand(shape, generator=generator) - 1.0) *
                    s).numpy()

        return cls(uniform((input_dim + hidden_dim, 2 * hidden_dim)),
                   np.zeros(2 * hidden_dim),
                   uniform((input_dim + hidden_dim, hidden_dim)),
                   np.zeros(hidden_dim), compute_dtype)

    def forward(self, h, x):
        hidden_dim = h.shape[-1]
        ru = torch.sigmoid(mixed_dot(torch.cat([x, h], dim=-1), self.w_ru,
                                     self.compute_dtype) + self.b_ru)
        r, u = ru[..., :hidden_dim], ru[..., hidden_dim:]
        c = torch.tanh(mixed_dot(torch.cat([x, r * h], dim=-1), self.w_c,
                                 self.compute_dtype) + self.b_c)
        return (1.0 - u) * h + u * c


class Encoder(nn.Module):
    """Owns the GRU; h_t = GRU(h_{t-1}, y_{t-1}) over a `[T, B, D]`
    batch."""

    def __init__(self, cell: GRUCell):
        super().__init__()
        self.cell = cell

    @property
    def hidden_dim(self) -> int:
        return self.cell.b_c.shape[0]

    def initial_state(self, batch_size: int):
        return self.cell.b_c.new_zeros((batch_size, self.hidden_dim))

    def encode(self, observations):
        """`[T, B, D_obs]` -> h_seq `[T, B, H]` (h_t sees y_{<t})."""
        h = self.initial_state(observations.shape[1])
        hs = [h]
        for y_prev in observations[:-1]:
            h = self.cell(h, y_prev)
            hs.append(h)
        return torch.stack(hs, dim=0)


def _gaussian_head(out):
    d = out.shape[-1] // 2
    loc, log_scale = out[..., :d], out[..., d:]
    return loc, torch.exp(torch.clamp(log_scale, -5.0, 2.0))


def _with_h(z, h_t):
    """``[z, h_t]`` over the last dim, ``h_t`` `[B, H]` broadcast over
    ``z``'s `[B, K, ...]` particle dims."""
    h = h_t.reshape((h_t.shape[0],) + (1,) * (z.ndim - 2) + h_t.shape[-1:])
    return torch.cat([z, h.expand(tuple(z.shape[:-1]) + h_t.shape[-1:])],
                     dim=-1)


class Initial(nn.Module):
    """p(z_0) = N(0, I) over `latent_dim`."""

    def __init__(self, latent_dim: int):
        super().__init__()
        self.register_buffer("loc", torch.zeros(latent_dim))

    def forward(self):
        return MultivariateNormalDiag(self.loc, torch.ones_like(self.loc))


class Transition(nn.Module):
    """z_t ~ N(prior_net([z_{t-1}, h_t])); ``h_seq`` `[T, B, H]` is bound
    per batch (`bind`)."""

    def __init__(self, prior_net: MLP):
        super().__init__()
        self.prior_net = prior_net
        self.h_seq = None

    def forward(self, previous_latents=None, time=None,
                previous_observations=None):
        z_prev = previous_latents[-1]                 # [B, K, Dz]
        loc, scale = _gaussian_head(self.prior_net(
            _with_h(z_prev, self.h_seq[time])))
        return MultivariateNormalDiag(
            loc, scale, batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)


class Emission(nn.Module):
    """y_t ~ N(decoder([z_t, h_t]), exp(log_noise)^2 I)."""

    def __init__(self, decoder: MLP, log_noise):
        super().__init__()
        self.decoder = decoder
        self.log_noise = _param(log_noise)
        self.h_seq = None

    def forward(self, latents=None, time=None, previous_observations=None):
        loc = self.decoder(_with_h(latents[-1], self.h_seq[time]))
        return MultivariateNormalDiag(
            loc, torch.exp(self.log_noise) * torch.ones_like(loc),
            batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)


class Proposal(nn.Module):
    """q(z_t | .) = N(encoder_net([h_t, y_t])), one distribution a batch
    row (BATCH_EXPANDED)."""

    def __init__(self, encoder_net: MLP):
        super().__init__()
        self.encoder_net = encoder_net
        self.h_seq = None

    def forward(self, previous_latents=None, time=None, observations=None):
        y = observations[time]                        # [B, D_obs]
        h_t = self.h_seq[time]                        # [B, H]
        loc, scale = _gaussian_head(self.encoder_net(
            torch.cat([h_t, y], dim=-1)))
        return MultivariateNormalDiag(
            loc, scale, batch_shape_mode=BatchShapeMode.BATCH_EXPANDED)


def _bound(module, h_seq):
    """A shallow copy of ``module`` (sharing its parameters and
    submodules) with ``h_seq`` bound."""
    bound = copy.copy(module)
    bound.h_seq = h_seq
    return bound


def bind(encoder, transition, emission, proposal, observations):
    """Encodes ``observations`` `[T, B, D]` once and returns (transition,
    emission, proposal) with that same `h_seq` tensor bound: shallow
    copies that share the parameters, so the GRU's gradient flows through
    all three."""
    h_seq = encoder.encode(observations)
    return (_bound(transition, h_seq), _bound(emission, h_seq),
            _bound(proposal, h_seq))


class _EncodingProposal(nn.Module):
    """The proposal of `bind_on_call`: at t = 0 it encodes the observations
    it is called with and binds the result to the transition and emission
    it was built with, then proposes."""

    def __init__(self, encoder, proposal, bound):
        super().__init__()
        self.encoder = encoder
        self.proposal = proposal
        self._bound = bound

    def forward(self, previous_latents=None, time=None, observations=None):
        if time == 0:
            # Drop the last call's encoding first: it holds that call's
            # autograd graph, whose gradient accumulators the new graph
            # would otherwise reuse (on whatever stream made them).
            modules = self._bound + (self.proposal,)
            for module in modules:
                module.h_seq = None
            h_seq = self.encoder.encode(observations.stacked)
            for module in modules:
                module.h_seq = h_seq
        return self.proposal(previous_latents=previous_latents, time=time,
                             observations=observations)


def bind_on_call(initial, encoder, transition, emission, proposal):
    """(initial, transition, emission, proposal) for the training loops
    that call the components with observations of their own
    (`train.make_train_step`, `train.train_on_device`): the proposal
    encodes the observations at its t = 0 call (the first call of every
    `infer` and TMC run) and binds them, as `bind` does, to copies of the
    transition, the emission and itself that share the parameters. Every
    parameter, the encoder's too, is reachable from the four components
    (`train.get_chained_params`)."""
    transition_b, emission_b, proposal_b = (
        _bound(m, None) for m in (transition, emission, proposal))
    return (initial, transition_b, emission_b,
            _EncodingProposal(encoder, proposal_b,
                              (transition_b, emission_b)))


def vrnn_loss(observations, num_particles, algorithm, initial, encoder,
              transition, emission, proposal, noise=None, **kwargs):
    """``-mean(ELBO)`` with the recurrent encoding bound per batch;
    ``kwargs`` go to `losses.get_loss`. Differentiate with respect to
    every component's parameters at once (the encoder's included)."""
    transition_b, emission_b, proposal_b = bind(
        encoder, transition, emission, proposal, observations)
    return _losses.get_loss(observations, num_particles, algorithm,
                            initial, transition_b, emission_b, proposal_b,
                            noise=noise, **kwargs)


class _GenInitial(nn.Module):
    def __init__(self, initial, encoder):
        super().__init__()
        self.initial, self.encoder = initial, encoder

    def forward(self):
        h0 = self.encoder.initial_state(1)[0]
        return {"z": self.initial(),
                "h": Deterministic(h0, event_ndims=1)}


class _GenTransition(nn.Module):
    def __init__(self, encoder, transition):
        super().__init__()
        self.encoder, self.transition = encoder, transition

    def forward(self, previous_latents=None, time=None,
                previous_observations=None):
        prev = previous_latents[-1]
        h = self.encoder.cell(prev["h"], previous_observations[-1])
        loc, scale = _gaussian_head(self.transition.prior_net(
            torch.cat([prev["z"], h], dim=-1)))
        mode = BatchShapeMode.FULLY_EXPANDED
        return {"z": MultivariateNormalDiag(loc, scale,
                                            batch_shape_mode=mode),
                "h": Deterministic(h, event_ndims=1, batch_shape_mode=mode)}


class _GenEmission(nn.Module):
    def __init__(self, emission):
        super().__init__()
        self.emission = emission

    def forward(self, latents=None, time=None, previous_observations=None):
        latent = latents[-1]
        loc = self.emission.decoder(torch.cat([latent["z"], latent["h"]],
                                              dim=-1))
        return MultivariateNormalDiag(
            loc, torch.exp(self.emission.log_noise) * torch.ones_like(loc),
            batch_shape_mode=BatchShapeMode.FULLY_EXPANDED)


def generative_components(encoder, initial, transition, emission):
    """(initial, transition, emission) of the generative model for
    `statistics.sample_from_prior` (and `train.train_on_device`): the
    latent is {'z': z_t, 'h': h_t}, with h_t = GRU(h_{t-1}, y_{t-1}) a
    `Deterministic` part of it, so the GRU advances on the sampled
    observations. Draws: z_0, y_0, z_1, y_1, ..., one standard-normal
    tensor each."""
    return (_GenInitial(initial, encoder), _GenTransition(encoder, transition),
            _GenEmission(emission))


def generate(encoder, initial, transition, emission, num_timesteps: int,
             batch_size: int, noise=None):
    """Ancestral sampling of (z `[T, B, Dz]`, y `[T, B, D_obs]`): the GRU
    advances on the generated observations, the same causal function as
    `Encoder.encode`. ``noise`` as `statistics.sample_from_prior`'s (the
    draws of `generative_components`)."""
    latents, observations = statistics.sample_from_prior(
        *generative_components(encoder, initial, transition, emission),
        num_timesteps, batch_size, noise)
    return latents["z"], observations


def _mlp(sizes, generator, compute_dtype, device):
    return MLP.create(sizes, generator, compute_dtype=compute_dtype,
                      device=device)


def make_model(latent_dim: int = 4, hidden_dim: int = 16, obs_dim: int = 8,
               seed: int = 0, mlp_hidden: int = 32, noise: float = 0.1,
               compute_dtype: Optional[str] = None, device=None):
    """(initial, encoder, transition, emission, proposal) with weights from
    a `torch.Generator` seeded with ``seed`` (the JAX package draws from a
    PRNG key, so the two models differ; use `from_numpy` for the same
    one), on ``device`` (default: the card; raises without one).
    ``compute_dtype='bfloat16'`` runs every GRU and MLP product with bf16
    inputs and float32 outputs."""
    device = _device.resolve(device)
    generator = torch.Generator().manual_seed(seed)
    cell = GRUCell.create(obs_dim, hidden_dim, generator, compute_dtype)
    return (Initial(latent_dim).to(device), Encoder(cell).to(device),
            Transition(_mlp((latent_dim + hidden_dim, mlp_hidden,
                             2 * latent_dim), generator, compute_dtype,
                            device)),
            Emission(_mlp((latent_dim + hidden_dim, mlp_hidden, obs_dim),
                          generator, compute_dtype, device),
                     np.log(noise)).to(device),
            Proposal(_mlp((hidden_dim + obs_dim, mlp_hidden, 2 * latent_dim),
                          generator, compute_dtype, device)))


def from_numpy(params: dict, compute_dtype: Optional[str] = None,
               device=None):
    """(initial, encoder, transition, emission, proposal) from numpy
    fields, on ``device`` (default: the card; raises without one).

    ``params`` maps 'latent_dim' to an int; 'encoder' to the GRU's
    {'w_ru', 'b_ru', 'w_c', 'b_c'}; 'transition', 'emission' and
    'proposal' to their MLP's {'weights', 'biases'} (lists of `[in,
    out]` and `[out]` arrays, the JAX layout), the emission's also with
    'log_noise'."""
    device = _device.resolve(device)

    def mlp(fields):
        return MLP.from_numpy(fields["weights"], fields["biases"],
                              compute_dtype=compute_dtype, device=device)

    gru = params["encoder"]
    cell = GRUCell(gru["w_ru"], gru["b_ru"], gru["w_c"], gru["b_c"],
                   compute_dtype)
    return (Initial(int(params["latent_dim"])).to(device),
            Encoder(cell).to(device), Transition(mlp(params["transition"])),
            Emission(mlp(params["emission"]),
                     params["emission"]["log_noise"]).to(device),
            Proposal(mlp(params["proposal"])))
