"""The one source of randomness of the engine.

The JAX package threads an explicit PRNG key and splits it per step
(`aesmc_tpu.inference.infer` splits `key` into `(T, 2)` streams: stream 0
resamples, stream 1 proposes). Here every draw goes through a
`NoiseSource` instead, which hands out five kinds of noise:

- `uniform(shape)`: the resampling uniforms (`[B, 1]` systematic, `[B, K]`
  stratified and residual), and the uniforms in [0, 1) of `Laplace`,
  `Uniform` and `Bernoulli` draws (see `distributions`);
- `exponential(shape)`: the `[B, K + 1]` Exp(1) draws whose spacings give
  the sorted multinomial positions (multinomial and soft resampling);
- `normal(shape)`: standard-normal `eps` for reparameterized samples of
  the normal family, in the `[batch, particle, ...]` layout of the
  sample it makes;
- `gumbel(shape)`: standard Gumbel draws ``-log(-log(U))``, U uniform in
  (tiny, 1), for categorical and one-hot categorical samples, in the
  layout in which `jax.random.categorical` draws them (see
  `state.sample`);
- `bits(shape)`: uniform 32-bit words, as int64 in [0, 2^32), the draws
  of `jax.random.bits(key, shape, uint32)`: the Sobol scrambles of
  `sqmc`. They are int64 because PyTorch's uint32 has no shifts on the
  CPU and int32's shift is arithmetic.

The default source is backed by a `torch.Generator` on the card. Tests
pass a source with the same methods that replays the reference's draws,
so both packages compute from the same noise.

Draws in the engine are laid out `[batch, particle, ...]`, except a
discrete BATCH_EXPANDED sample's, which `jax.random` draws `[particle,
batch, ...]` (`particle_major`). Two views build on that:

- `ShardNoise`, a rank's view on a mesh: every rank holds the same
  generator state, draws the GLOBAL shape and keeps its own block, so a
  mesh run replays the single-device run (the JAX package draws "over
  the global grid, then slices"). It costs each rank the whole draw,
  O(B K) numbers a step;
- `StackedNoise`, N sources side by side along the batch axis (island
  SMC's islands, each with its own stream from `NoiseSource.fold_in`).
"""

from __future__ import annotations

from typing import Sequence

import torch

from . import device as _device


class NoiseSource:
    """Draws float32 noise (and int64 words) from a `torch.Generator`, on
    its device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    @classmethod
    def seeded(cls, seed: int = 0, device=None) -> "NoiseSource":
        """A source seeded with ``seed`` on ``device`` (default: the card;
        raises without one)."""
        generator = torch.Generator(device=_device.resolve(device))
        generator.manual_seed(seed)
        return cls(generator)

    @property
    def device(self) -> torch.device:
        return self.generator.device

    def fold_in(self, i: int) -> "NoiseSource":
        """A new source for stream ``i``, seeded from this source's seed and
        ``i`` (the counterpart of `jax.random.fold_in`; it does not read or
        advance this source's state)."""
        seed = (self.generator.initial_seed() * 6364136223846793005 +
                (int(i) + 1) * 1442695040888963407) % (1 << 63)
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)
        return NoiseSource(generator)

    def uniform(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self.device, dtype=torch.float32)

    def exponential(self, shape: Sequence[int]) -> torch.Tensor:
        out = torch.empty(tuple(shape), device=self.device,
                          dtype=torch.float32)
        return out.exponential_(generator=self.generator)

    def normal(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.device, dtype=torch.float32)

    def gumbel(self, shape: Sequence[int]) -> torch.Tensor:
        # As jax.random.gumbel draws it: U is kept off 0 (where the log
        # diverges) by the smallest normal float32.
        u = self.uniform(shape).clamp_(min=torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))

    def bits(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.randint(0, 1 << 32, tuple(shape),
                             generator=self.generator, device=self.device,
                             dtype=torch.int64)


def particle_major(noise, kind: str, shape: Sequence[int]) -> torch.Tensor:
    """A draw of ``kind`` laid out `[particle, batch, ...]` (a discrete
    BATCH_EXPANDED sample's); sources without a layout of their own draw
    it as any other."""
    draw = getattr(noise, "particle_major", None)
    if draw is not None:
        return draw(kind, shape)
    return getattr(noise, kind)(shape)


class _View:
    """A noise source made of other sources: each kind of draw goes
    through `_draw(kind, shape, particle_major)`."""

    def uniform(self, shape):
        return self._draw("uniform", tuple(shape), False)

    def exponential(self, shape):
        return self._draw("exponential", tuple(shape), False)

    def normal(self, shape):
        return self._draw("normal", tuple(shape), False)

    def gumbel(self, shape):
        return self._draw("gumbel", tuple(shape), False)

    def bits(self, shape):
        return self._draw("bits", tuple(shape), False)

    def particle_major(self, kind, shape):
        return self._draw(kind, tuple(shape), True)


class ShardNoise(_View):
    """This rank's view of a `[B, K, ...]` draw on a mesh.

    ``replicated`` is a source whose state is the same on every rank;
    ``rows`` = (data rank, data ranks) and ``particles`` = (particle rank,
    particle ranks). A draw of the local shape `[B_l, K_l, ...]` draws the
    global `[B_l n_data, K_l n_particle, ...]` from ``replicated`` and keeps
    this rank's block, so every rank consumes the generator as the
    single-device run does. Draws that are the same on every rank (the
    resampling positions) go to ``replicated`` itself.

    ``row_dim`` and ``particle_dim`` name the axes the two groups cut (0
    and 1 by default; None: not cut, the draw is the same on every rank
    of that group): a backward tile `[B, M, K_parents]` cuts its parents
    on axis 2, a sampler's `[K, ...]` cloud its particles on axis 0
    (`along`). A particle-major draw swaps the roles of axes 0 and 1.
    """

    def __init__(self, replicated, rows, particles, row_dim=0,
                 particle_dim=1):
        self.replicated = replicated
        self.rows = rows
        self.particles = particles
        self.row_dim = row_dim
        self.particle_dim = particle_dim

    @property
    def device(self):
        return self.replicated.device

    def along(self, row_dim=0, particle_dim=1) -> "ShardNoise":
        """The same view with the data group cutting axis ``row_dim`` and
        the particle group axis ``particle_dim`` (None: no cut)."""
        return ShardNoise(self.replicated, self.rows, self.particles,
                          row_dim, particle_dim)

    def _draw(self, kind, shape, particle_major_):
        cuts = [(self.row_dim, self.rows), (self.particle_dim,
                                            self.particles)]
        if particle_major_:
            swap = {0: 1, 1: 0}
            cuts = [(swap.get(dim, dim), part) for dim, part in cuts]
        cuts = [(dim, part) for dim, part in cuts
                if dim is not None and part[1] > 1]
        for dim, _ in cuts:
            if dim >= len(shape):
                raise ValueError(f"a sharded draw cuts axis {dim}; got "
                                 f"{shape}")
        full = list(shape)
        for dim, (_, n) in cuts:
            full[dim] *= n
        full = tuple(full)
        draw = (particle_major(self.replicated, kind, full)
                if particle_major_ else
                getattr(self.replicated, kind)(full))
        for dim, (r, _) in cuts:
            draw = draw.narrow(dim, r * shape[dim], shape[dim])
        return draw


class StackedNoise(_View):
    """N sources side by side: a draw of `[N B, ...]` is each source's
    `[B, ...]` draw, concatenated along the batch axis (the second axis of
    a particle-major draw)."""

    def __init__(self, sources):
        self.sources = list(sources)

    @property
    def device(self):
        return self.sources[0].device

    def _draw(self, kind, shape, particle_major_):
        axis = 1 if particle_major_ else 0
        n = len(self.sources)
        if shape[axis] % n:
            raise ValueError(f"a draw of {shape} does not split over {n} "
                             "sources")
        part = list(shape)
        part[axis] //= n
        draws = [particle_major(s, kind, part) if particle_major_ else
                 getattr(s, kind)(part) for s in self.sources]
        return torch.cat(draws, dim=axis)
