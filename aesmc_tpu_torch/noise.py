"""The one source of randomness of the engine.

The JAX package threads an explicit PRNG key and splits it per step
(`aesmc_tpu.inference.infer` splits `key` into `(T, 2)` streams: stream 0
resamples, stream 1 proposes). Here every draw goes through a
`NoiseSource` instead, which hands out two kinds of noise:

- `uniform(shape)`: the per-step resampling uniforms `u [B, 1]`;
- `normal(shape)`: standard-normal `eps` for reparameterized samples,
  in the `[batch, particle, ...]` layout of the sample it makes.

The default source is backed by a `torch.Generator` on the tensors'
device. Tests pass a source with the same two methods that replays the
reference's draws, so both packages compute from the same noise.
"""

from __future__ import annotations

from typing import Sequence

import torch


class NoiseSource:
    """Draws float32 noise from a `torch.Generator`, on its device."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    @classmethod
    def seeded(cls, seed: int = 0, device="cpu") -> "NoiseSource":
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        return cls(generator)

    @property
    def device(self) -> torch.device:
        return self.generator.device

    def uniform(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self.device, dtype=torch.float32)

    def normal(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.device, dtype=torch.float32)
