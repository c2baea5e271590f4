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

The module-level `particle_*` helpers (and `batch_mean`, over the data
group) take a cloud or None (one device), so that a module holds one
code path for both: over a group of one rank they compute with the
single-device arithmetic (the same bits), otherwise their local
reduction crosses the group.
"""

from __future__ import annotations

import torch

from . import math as amath
from .noise import ShardNoise

# `parallel.collectives` is imported where it is used: the package
# `parallel` imports modules that import this one.

__all__ = ["Cloud", "cloud_of", "local_block", "gather_block",
           "particle_logsumexp", "particle_sum", "particle_mean",
           "particle_softmax", "particle_ess", "particle_gather",
           "batch_mean"]


class Cloud:
    """This rank's block of a `[B, K, ...]` cloud on ``mesh``: rows
    `[d B_l, (d + 1) B_l)` of the data axis and particles `[p K_l, (p + 1)
    K_l)` of the particle axis. The mesh must have ``particle_axis``;
    without ``data_axis`` among its names the batch is not sharded."""

    def __init__(self, mesh, data_axis: str = "data",
                 particle_axis: str = "particle"):
        from .parallel import collectives
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

    def logsumexp(self, values: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """logsumexp over the particle axis (``dim``) of the whole cloud:
        `[B_l]` from `[B_l, K_l]`, the same on every particle rank."""
        return amath.distributed_logsumexp(values, self.particle_group,
                                           dim=dim)

    def particle_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the particle group of ``x`` (x itself over one
        rank)."""
        if self.n_particle == 1:
            return x
        from .parallel import collectives
        return collectives.all_reduce(x, self.particle_group, "sum")

    def global_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over every rank of the mesh (both groups):
        what a host read that every rank must agree on reads."""
        return self.batch_sum(self.particle_sum(x))

    def gather_particles(self, x: torch.Tensor, dim: int = 1):
        """The whole particle axis (``dim``) of this rank's rows."""
        from .parallel import collectives
        return collectives.all_gather(x, self.particle_group, dim=dim)

    def gather_rows(self, x: torch.Tensor, dim: int = 0):
        """The whole batch axis (``dim``) of ``x`` (x itself without a
        data axis)."""
        if self.data_group is None:
            return x
        from .parallel import collectives
        return collectives.all_gather(x, self.data_group, dim=dim)

    def gather_rows(self, x: torch.Tensor, dim: int = 0):
        """The whole batch axis (``dim``) of ``x`` (x itself without a
        data axis)."""
        if self.data_group is None:
            return x
        from .parallel import collectives
        return collectives.all_gather(x, self.data_group, dim=dim)

    def over_data(self):
        """The data group as the particle group of a `Cloud`: the
        `particle_*` helpers on it reduce over the data axis (SMC^2's theta
        cloud, whose thetas lie along it). None without a data axis: the
        theta cloud is then whole on every rank."""
        if self.data_group is None:
            return None
        return Cloud(self.mesh, None, self.data_axis)

    def batch_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the data group (x itself without a data axis)."""
        if self.data_group is None:
            return x
        from .parallel import collectives
        return collectives.all_reduce(x, self.data_group, "sum")


def local_block(x, mesh, dims: dict):
    """This rank's block of the global tensor (or dict of tensors) ``x``:
    ``dims`` maps a dimension to the mesh axis it is sharded over, e.g.
    ``{1: 'data'}`` for `[T, B, ...]` observations or ``{0: 'data', 1:
    'particle'}`` for a `[B, K, ...]` cloud."""
    if isinstance(x, dict):
        return {k: local_block(v, mesh, dims) for k, v in x.items()}
    from .parallel import collectives
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
    from .parallel import collectives
    for dim, axis in dims.items():
        x = collectives.all_gather(x, mesh.get_group(axis), dim=dim)
    return x


def cloud_of(mesh=None, implementation=None, data_axis: str = "data",
             particle_axis: str = "particle"):
    """The `Cloud` of ``mesh``, or of a distributed resampler's mesh (a
    callable ``implementation`` carrying ``.mesh``, with its own axis
    names), or None (one device)."""
    if mesh is None:
        mesh = getattr(implementation, "mesh", None) if callable(
            implementation) else None
        if mesh is None:
            return None
        data_axis = getattr(implementation, "data_axis", data_axis)
        particle_axis = getattr(implementation, "particle_axis",
                                particle_axis)
    return Cloud(mesh, data_axis, particle_axis)


def _single(cloud) -> bool:
    return cloud is None or cloud.n_particle == 1


def particle_logsumexp(x: torch.Tensor, cloud, dim: int = 1):
    """logsumexp over the particle axis ``dim`` of the whole cloud."""
    if _single(cloud):
        return torch.logsumexp(x, dim=dim)
    return cloud.logsumexp(x, dim=dim)


def particle_sum(x: torch.Tensor, cloud, dim: int = 1):
    """The sum over the particle axis ``dim`` of the whole cloud."""
    if _single(cloud):
        return torch.sum(x, dim=dim)
    return cloud.particle_sum(torch.sum(x, dim=dim))


def particle_mean(x: torch.Tensor, cloud, dim: int = 1):
    """The mean over the particle axis ``dim`` of the whole cloud."""
    if _single(cloud):
        return torch.mean(x, dim=dim)
    return particle_sum(x, cloud, dim) / (x.shape[dim] * cloud.n_particle)


def particle_softmax(log_weight: torch.Tensor, cloud, dim: int = 1):
    """The normalized weights of the whole cloud, this rank's block."""
    if _single(cloud):
        return torch.softmax(log_weight, dim=dim)
    return torch.exp(log_weight - cloud.logsumexp(log_weight, dim=dim
                                                   ).unsqueeze(dim))


def particle_ess(log_weight: torch.Tensor, cloud, dim: int = 1):
    """The effective sample size of the whole cloud's weights."""
    return torch.exp(2.0 * particle_logsumexp(log_weight, cloud, dim) -
                     particle_logsumexp(2.0 * log_weight, cloud, dim))


def particle_gather(x: torch.Tensor, cloud, dim: int = 1):
    """The whole particle axis ``dim`` (x itself on one device)."""
    if _single(cloud):
        return x
    return cloud.gather_particles(x, dim=dim)


def batch_mean(values: torch.Tensor, cloud):
    """The mean of `[B]` ``values`` over the global batch: the mean of the
    data ranks' means (equal blocks; over one data rank, the
    single-device mean's bits), the same on every rank."""
    if cloud is None or cloud.data_group is None:
        return values.mean()
    return cloud.batch_sum(values.mean()) / cloud.n_data
