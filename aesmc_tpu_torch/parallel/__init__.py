"""Mesh parallelism over ('data', 'particle') grids of ranks.

Counterpart of `aesmc_tpu.parallel`, on `torch.distributed`: every rank
runs the same program on its block of the batch and of the particle axis
(SPMD by hand), over the process groups of a named `DeviceMesh`, and the
collectives are explicit (`collectives`). `infer`, `losses.get_loss`,
`losses.get_loss_and_metrics`, `online.make_online_filter` (streaming
PaRIS and genealogy too), `smoothing.backward_simulation`,
`smoothing.paris`, `rbpf.rbpf`, `smc2.smc2`, `twisted.twisted_smc` and
`twisted.learn_twist` take ``mesh=``; `resample_move`, `blockpf`, `samplers` and `if2` take a
distributed resampler as their ``resampling_implementation`` and run on
this rank's block of its mesh. This package adds the distributed
resamplers (all-gather and ring exchanges, soft resampling, the
ring-streamed OT), the sharded train step and island SMC.
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
