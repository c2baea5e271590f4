"""Device meshes over `torch.distributed` ranks.

Counterpart of `aesmc_tpu.parallel.mesh`. JAX runs one controller over a
grid of devices; here every rank is a process that runs the same program
on its own block (SPMD), and a mesh is PyTorch's named `DeviceMesh`,
whose per-axis process groups carry the collectives
(`collectives.py`).

Launching is PyTorch's: `torchrun --nproc-per-node N script.py` (one rank
a card, NCCL), or `torch.multiprocessing` with the spawn start method and
`torch.distributed.init_process_group` given its address, rank and world
size (the tests: gloo on the CPU).
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import device as _device

__all__ = ["make_mesh", "make_island_mesh", "data_particle_specs"]

DEFAULT_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _init_mesh(shape, names, device_type, backend) -> DeviceMesh:
    if device_type not in DEFAULT_BACKENDS:
        raise ValueError(f"device_type must be 'cuda' or 'cpu'. currently = "
                         f"{device_type}")
    # No card and no explicit CPU request: raise, never run on the CPU.
    _device.resolve(device_type)
    backend = backend or DEFAULT_BACKENDS[device_type]
    if not dist.is_initialized():
        # torchrun's environment (MASTER_ADDR, RANK, WORLD_SIZE, ...).
        dist.init_process_group(backend)
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks; the world "
                         f"has {world}")
    return init_device_mesh(
        device_type, tuple(shape), mesh_dim_names=tuple(names),
        backend_override={name: backend for name in names})


def make_mesh(data: int = 1, particle: int = 1, device_type: str = "cuda",
              backend=None) -> DeviceMesh:
    """A 2-D `('data', 'particle')` mesh over all `data * particle` ranks.

    `data` shards the batch axis (the loss mean over the batch crosses
    the data group); `particle` shards the particle axis (weight
    normalization and resampling become collectives over the particle
    group). Ranks are laid out data-major: rank = d * particle + p.

    ``device_type`` 'cuda' (the default: one card a rank, NCCL) or 'cpu'
    (gloo). Without a card 'cuda' raises; nothing falls back to the CPU.
    ``backend`` overrides the process groups' backend (gloo on CUDA
    tensors, several ranks on one card). When no process group exists
    yet, the default one is made from torchrun's environment. The mesh
    must cover the whole world: other sizes raise ValueError.
    """
    return _init_mesh((data, particle), ("data", "particle"), device_type,
                      backend)


def make_island_mesh(islands: int, device_type: str = "cuda",
                     backend=None) -> DeviceMesh:
    """A 1-D `('island',)` mesh over all ``islands`` ranks, for
    `islands.island_infer(mesh=...)` (arguments as `make_mesh`)."""
    return _init_mesh((islands,), ("island",), device_type, backend)


def data_particle_specs(mesh: DeviceMesh, batch_size: int,
                        num_particles: int, data_axis: str = "data",
                        particle_axis: str = "particle"):
    """This rank's (rows, particles) slices of a global `[B, K, ...]`
    cloud on ``mesh`` (and of `[T, B, ...]` observations along B): the
    counterpart of the JAX package's (observation, state) shardings. An
    axis the mesh lacks is not sharded."""
    from ..sharding_utils import Cloud

    cloud = Cloud(mesh, data_axis, particle_axis)
    return cloud.rows(batch_size), cloud.particles(num_particles)
