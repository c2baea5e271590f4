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
