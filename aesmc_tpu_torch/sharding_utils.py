"""This rank's block of a sharded particle cloud.

Counterpart of `aesmc_tpu.sharding_utils`. Its `make_cloud_constrainer`
pins GSPMD shardings on global arrays inside a traced program; it has no
meaning here, where a rank only ever holds its own block. What takes its
place is `Cloud`: for a `DeviceMesh` and its batch and particle axes,
this rank's place on the mesh (the slices of a global `[B, K, ...]`
cloud it holds), the helpers that cut a global tensor to this rank's
block and put the blocks back together, the noise view that draws the
global shape and keeps this block, and the particle-axis reductions the
engine needs (`distributed_logsumexp`).
"""

from __future__ import annotations

import torch

from . import math as amath
from .noise import ShardNoise
from .parallel import collectives

__all__ = ["Cloud", "local_block", "gather_block"]


class Cloud:
    """This rank's block of a `[B, K, ...]` cloud on ``mesh``: rows
    `[d B_l, (d + 1) B_l)` of the data axis and particles `[p K_l, (p + 1)
    K_l)` of the particle axis. The mesh must have ``particle_axis``;
    without ``data_axis`` among its names the batch is not sharded."""

    def __init__(self, mesh, data_axis: str = "data",
                 particle_axis: str = "particle"):
        names = tuple(mesh.mesh_dim_names or ())
        if particle_axis not in names:
            raise ValueError(f"mesh has axes {names}; particle_axis="
                             f"{particle_axis!r} is not one of them")
        self.mesh = mesh
        self.data_axis, self.particle_axis = data_axis, particle_axis
        self.particle_group = mesh.get_group(particle_axis)
        self.n_particle = collectives.size(self.particle_group)
        self.particle_rank = collectives.rank_in(self.particle_group)
        if data_axis in names:
            self.data_group = mesh.get_group(data_axis)
            self.n_data = collectives.size(self.data_group)
            self.data_rank = collectives.rank_in(self.data_group)
        else:
            self.data_group, self.n_data, self.data_rank = None, 1, 0

    def local_particles(self, num_particles: int) -> int:
        """K_l = K / n for the global particle count K (ValueError unless
        n divides K)."""
        if num_particles % self.n_particle:
            raise ValueError(
                f"num_particles={num_particles} does not split over "
                f"{self.n_particle} particle shards")
        return num_particles // self.n_particle

    def rows(self, batch_size: int) -> slice:
        """This rank's rows of a global batch of ``batch_size``."""
        if batch_size % self.n_data:
            raise ValueError(f"batch_size={batch_size} does not split over "
                             f"{self.n_data} data shards")
        b = batch_size // self.n_data
        return slice(self.data_rank * b, (self.data_rank + 1) * b)

    def particles(self, num_particles: int) -> slice:
        """This rank's particles of a global ``num_particles``."""
        k = self.local_particles(num_particles)
        return slice(self.particle_rank * k, (self.particle_rank + 1) * k)

    def offset(self, local_particles: int) -> int:
        """The global index of this rank's first particle."""
        return self.particle_rank * local_particles

    def noise(self, noise) -> ShardNoise:
        """The shard view of the replicated source ``noise``."""
        if isinstance(noise, ShardNoise):
            return noise
        return ShardNoise(noise, (self.data_rank, self.n_data),
                          (self.particle_rank, self.n_particle))

    def logsumexp(self, values: torch.Tensor) -> torch.Tensor:
        """logsumexp over the particle axis (dim 1) of the whole cloud:
        `[B_l]` from `[B_l, K_l]`, the same on every particle rank."""
        return amath.distributed_logsumexp(values, self.particle_group,
                                           dim=1)

    def gather_particles(self, x: torch.Tensor, dim: int = 1):
        """The whole particle axis (``dim``) of this rank's rows."""
        return collectives.all_gather(x, self.particle_group, dim=dim)

    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the data group (x itself without a data axis)."""
        if self.data_group is None:
            return x
        return collectives.all_reduce(x, self.data_group, "sum")


def local_block(x, mesh, dims: dict):
    """This rank's block of the global tensor (or dict of tensors) ``x``:
    ``dims`` maps a dimension to the mesh axis it is sharded over, e.g.
    ``{1: 'data'}`` for `[T, B, ...]` observations or ``{0: 'data', 1:
    'particle'}`` for a `[B, K, ...]` cloud."""
    if isinstance(x, dict):
        return {k: local_block(v, mesh, dims) for k, v in x.items()}
    for dim, axis in dims.items():
        group = mesh.get_group(axis)
        n, r = collectives.size(group), collectives.rank_in(group)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} does not "
                             f"split over {n} ranks of {axis!r}")
        m = x.shape[dim] // n
        x = x.narrow(dim, r * m, m)
    return x


def gather_block(x, mesh, dims: dict):
    """The inverse of `local_block`: every rank's block put back together
    (a collective; every rank gets the global tensor)."""
    if isinstance(x, dict):
        return {k: gather_block(v, mesh, dims) for k, v in x.items()}
    for dim, axis in dims.items():
        x = collectives.all_gather(x, mesh.get_group(axis), dim=dim)
    return x
