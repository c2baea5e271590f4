"""Mesh parallelism over ('data', 'particle') grids of ranks.

Counterpart of `aesmc_tpu.parallel`, on `torch.distributed`: every rank
runs the same program on its block of the batch and of the particle axis
(SPMD by hand), over the process groups of a named `DeviceMesh`, and the
collectives are explicit (`collectives`). `infer`, `losses.get_loss`,
`losses.get_loss_and_metrics` and `online.make_online_filter` take
``mesh=``; this package adds the distributed resamplers (all-gather and
ring exchanges, soft resampling), the sharded train step and island SMC.

Not ported yet (slice E2 of the port): `make_distributed_ot_resampler`,
which raises NotImplementedError.
"""

from .mesh import make_mesh, make_island_mesh, data_particle_specs
from .dist_resampling import (
    make_distributed_resampler,
    make_distributed_ot_resampler,
    make_distributed_systematic_resampler,
    make_distributed_fused_resampler,
    distributed_resampling_indices,
    distributed_systematic_indices,
    distributed_systematic_resample,
    distributed_systematic_resample_streaming,
    distributed_soft_resample,
)
from .sharded import make_sharded_train_step, shard_batch
from .islands import island_infer

__all__ = [
    "island_infer",
    "make_mesh", "data_particle_specs",
    "make_distributed_resampler",
    "make_distributed_ot_resampler",
    "make_distributed_systematic_resampler",
    "make_distributed_fused_resampler",
    "distributed_resampling_indices",
    "distributed_systematic_indices",
    "distributed_systematic_resample",
    "distributed_systematic_resample_streaming",
    "distributed_soft_resample",
    "make_sharded_train_step", "shard_batch",
    "make_island_mesh",
]
