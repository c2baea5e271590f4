"""Noise for the references, drawn from a generator of their own.

`FreshDraws` makes uniform and normal draws of the port's noise layout
(`[batch, particle, ...]`) on demand: the reference put in the program's
place (the control, and its sound twin) has no program run to follow.
"""

from __future__ import annotations

import torch


class FreshDraws:
    """Draws made on demand from ``generator``, in ``dtype``."""

    def __init__(self, generator: torch.Generator, dtype=torch.float64):
        self.generator = generator
        self.dtype = dtype

    @property
    def device(self):
        return self.generator.device

    def uniform(self, shape):
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self.device).to(self.dtype)

    def normal(self, shape):
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.device).to(self.dtype)
