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


def tensor(x):
    """A tensor holding a copy of ``x`` (JAX hands out read-only arrays)."""
    return torch.tensor(np.asarray(x))


class ReplayNoise:
    """A noise source on the CPU that hands out given draws, each kind in
    order."""

    device = torch.device("cpu")

    def __init__(self, uniforms=(), normals=(), exponentials=(),
                 gumbels=()):
        self.uniforms = [tensor(u) for u in uniforms]
        self.normals = [tensor(e) for e in normals]
        self.exponentials = [tensor(e) for e in exponentials]
        self.gumbels = [tensor(g) for g in gumbels]

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

    def exhausted(self):
        return not (self.uniforms or self.normals or self.exponentials or
                    self.gumbels)


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
    `aesmc_tpu.inference.infer` draws at t = 1 .. T-1 from ``key``."""
    step_keys = jax.random.split(key, (num_timesteps, 2))
    keys = [step_keys[t, 0] for t in range(1, num_timesteps)]
    if method == "multinomial":
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
