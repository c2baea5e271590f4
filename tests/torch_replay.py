"""Replaying the JAX package's random draws into the PyTorch port.

The two packages draw different numbers from the same seed, so the port's
tests run the JAX function first and hand its draws to the port through a
noise source: the proposal's standard-normal draws are recovered as
eps = (x - loc) / scale from the JAX run's latents, and the resampling
noise is redrawn from its key schedule (`split(key, (T, 2))[t, 0]`, as
`aesmc_tpu.inference.infer` draws it). A categorical proposal's Gumbel
noise is redrawn from the proposal's keys (`split(key, (T, 2))[t, 1]`) in
the shape `jax.random.categorical` draws it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_threads  # noqa: F401  (caps PyTorch's threads)


def tensor(x):
    """A tensor holding a copy of ``x`` (JAX hands out read-only arrays)."""
    return torch.tensor(np.asarray(x))


class ReplayNoise:
    """A noise source on the CPU that hands out given draws, each kind in
    order."""

    device = torch.device("cpu")

    def __init__(self, uniforms=(), normals=(), exponentials=(),
                 gumbels=(), bits=()):
        self.uniforms = [tensor(u) for u in uniforms]
        self.normals = [tensor(e) for e in normals]
        self.exponentials = [tensor(e) for e in exponentials]
        self.gumbels = [tensor(g) for g in gumbels]
        # uint32 words as int64, as `NoiseSource.bits` hands them out.
        self.bits_ = [torch.tensor(np.asarray(b).astype(np.int64))
                      for b in bits]

    @staticmethod
    def _pop(queue, shape):
        x = queue.pop(0)
        assert tuple(shape) == tuple(x.shape), (tuple(shape), x.shape)
        return x

    def uniform(self, shape):
        return self._pop(self.uniforms, shape)

    def normal(self, shape):
        return self._pop(self.normals, shape)

    def exponential(self, shape):
        return self._pop(self.exponentials, shape)

    def gumbel(self, shape):
        return self._pop(self.gumbels, shape)

    def bits(self, shape):
        return self._pop(self.bits_, shape)

    def exhausted(self):
        return not (self.uniforms or self.normals or self.exponentials or
                    self.gumbels or self.bits_)


def fields(component):
    """The numpy fields of a JAX component dataclass."""
    return {f.name: np.asarray(getattr(component, f.name))
            for f in dataclasses.fields(component)}


def lgssm_params(jax_comps):
    """`lgssm.from_numpy`'s argument for JAX (initial, transition,
    emission, proposal)."""
    return dict(zip(("initial", "transition", "emission", "proposal"),
                    (fields(c) for c in jax_comps)))


def simulate(seed, num_timesteps, batch, mult=0.9, em_scale=0.5):
    """Observations of the LGSSM x' = mult x + N(0, 1), y = x + N(0, s^2)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(batch)
    ys = []
    for _ in range(num_timesteps):
        ys.append(x + em_scale * rng.randn(batch))
        x = mult * x + rng.randn(batch)
    return np.asarray(ys, dtype=np.float32)


def replayed_noise(proposal, obs, key, latents, ancestors,
                   method="systematic"):
    """The JAX run's draws: the LGSSM ``proposal``'s eps per step, and the
    resampling noise of ``method`` when ``ancestors`` is given (smc)."""
    w0, b0 = float(proposal.lin_0_weight), float(proposal.lin_0_bias)
    w = np.asarray(proposal.lin_t_weight, np.float64)
    b = float(proposal.lin_t_bias)
    x = np.asarray(latents, np.float64)
    y = np.asarray(obs, np.float64)
    eps = [(x[0] - (w0 * y[0] + b0)[:, None]) / proposal.scale_0]
    for t in range(1, len(y)):
        prev = (x[t - 1] if ancestors is None else
                np.take_along_axis(x[t - 1], np.asarray(ancestors[t - 1]), 1))
        loc = w[0] * prev + w[1] * y[t][:, None] + b
        eps.append((x[t] - loc) / proposal.scale_t)
    eps = [e.astype(np.float32) for e in eps]
    if ancestors is None:
        return ReplayNoise(normals=eps)
    batch, k = x.shape[1:3]
    return ReplayNoise(normals=eps, **resampling_draws(key, len(y), batch,
                                                       k, method))


def resampling_draws(key, num_timesteps, batch, k, method):
    """`ReplayNoise` keyword arguments holding the resampling noise that
    `aesmc_tpu.inference.infer` draws at t = 1 .. T-1 from ``key``: soft
    resampling draws as multinomial does, residual as stratified."""
    step_keys = jax.random.split(key, (num_timesteps, 2))
    keys = [step_keys[t, 0] for t in range(1, num_timesteps)]
    if method in ("multinomial", "soft"):
        return {"exponentials": [
            np.asarray(jax.random.exponential(kk, (batch, k + 1),
                                              dtype=jnp.float32))
            for kk in keys]}
    shape = (batch, 1) if method == "systematic" else (batch, k)
    return {"uniforms": [
        np.asarray(jax.random.uniform(kk, shape, dtype=jnp.float32))
        for kk in keys]}


def categorical_gumbels(key, num_timesteps, batch, k, num_states,
                        first="batch_expanded"):
    """The Gumbel noise of a categorical proposal in `infer`, one draw a
    step from ``split(key, (T, 2))[t, 1]``, in the shape in which
    `jax.random.categorical` draws it: `[K, B, D]` at t = 0 for a
    BATCH_EXPANDED proposal (``first``; 'not_expanded' draws `[B, K, D]`),
    and `[B, K, D]` for the FULLY_EXPANDED proposals after."""
    step_keys = jax.random.split(key, (num_timesteps, 2))
    shapes = [(k, batch, num_states) if first == "batch_expanded" else
              (batch, k, num_states)]
    shapes += [(batch, k, num_states)] * (num_timesteps - 1)
    return [np.asarray(jax.random.gumbel(step_keys[t, 1], shape,
                                         dtype=jnp.float32))
            for t, shape in enumerate(shapes)]


def proposal_eps(proposal, obs, latents, ancestors):
    """The standard-normal draws that make the port's ``proposal`` (a
    `Normal` or `MultivariateNormalDiag` proposal module) reproduce the
    JAX run's ``latents`` `[T, B, K, ...]`: eps = (x - loc) / scale, with
    loc and scale from the port's proposal on the JAX run's latents,
    gathered by its ``ancestors`` (None for 'is')."""
    from aesmc_tpu_torch import inference, state
    from aesmc_tpu_torch.state import BatchShapeMode

    obs_seq = inference.ObservationSequence(tensor(obs))
    x = tensor(latents)
    eps = []
    with torch.no_grad():
        for t in range(len(obs_seq)):
            if t == 0:
                dist = proposal(time=0, observations=obs_seq)
            else:
                prev = (x[t - 1] if ancestors is None else state.resample(
                    x[t - 1], tensor(ancestors[t - 1])))
                dist = proposal(previous_latents=[prev],
                                time=inference.TimeIndex(t),
                                observations=obs_seq)
            loc = dist.loc
            scale = getattr(dist, "scale_diag", getattr(dist, "scale", None))
            scale = torch.as_tensor(scale, dtype=torch.float32)
            if dist.batch_shape_mode == BatchShapeMode.BATCH_EXPANDED:
                loc = loc.unsqueeze(1)
                if scale.ndim:
                    scale = scale.unsqueeze(1)
            eps.append(((x[t] - loc) / scale).numpy())
    return eps


def mlp_fields(mlp):
    """`utils.MLP.from_numpy`'s weights and biases of a JAX `MLP`."""
    return {"weights": [np.asarray(w) for w in mlp.weights],
            "biases": [np.asarray(b) for b in mlp.biases]}


def vrnn_params(jax_model):
    """`vrnn.from_numpy`'s argument for the JAX package's VRNN (initial,
    encoder, transition, emission, proposal)."""
    initial, encoder, transition, emission, proposal = jax_model
    return {"latent_dim": initial.latent_dim,
            "encoder": fields(encoder.cell),
            "transition": mlp_fields(transition.prior_net),
            "emission": dict(mlp_fields(emission.decoder),
                             log_noise=np.asarray(emission.log_noise)),
            "proposal": mlp_fields(proposal.encoder_net)}


def normal_draw(key, sample_shape, batch_shape=(), batch_expanded=False):
    """The standard-normal eps with which a JAX `Normal`/MVNDiag draws
    ``sample_shape`` from ``key`` (`jax.random.normal(key, sample_shape +
    batch_shape)`), in the port's `[batch, particle, ...]` layout: a
    BATCH_EXPANDED draw is `[K, B, ...]` in JAX, swapped here."""
    eps = np.asarray(jax.random.normal(key, tuple(sample_shape) +
                                       tuple(batch_shape)))
    return np.swapaxes(eps, 0, 1) if batch_expanded else eps


class IslandOnlyMesh:
    """Enough of a `DeviceMesh` to be refused: its one axis is 'island',
    so a module asked to shard a particle axis over it raises."""

    mesh_dim_names = ("island",)

    def get_group(self, name):
        return None


class PlainSystematic:
    """A plain (one-device) callable ``resampling_implementation``: the
    port's systematic indices on the 'torch' route, counting its calls.
    A module that passes it through must give the bits of its default
    CPU route."""

    def __init__(self):
        self.calls = 0

    def __call__(self, log_weight, noise):
        from aesmc_tpu_torch import resampling
        self.calls += 1
        return resampling.sample_indices(log_weight, noise, "systematic",
                                         "torch")
