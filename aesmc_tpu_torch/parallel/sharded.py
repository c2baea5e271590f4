"""Sharded training: the AESMC/IWAE train step over a device mesh.

Counterpart of `aesmc_tpu.parallel.sharded`. The JAX step is one `jit`
over the mesh, in which XLA inserts the gradient sums and the resampling
collectives. Here every rank runs the same eager step on its block: its
rows of the observations (`shard_batch`) and its particles of each row;
the loss is the batch mean across the data group (`losses.get_loss(
mesh=...)`, the same value on every rank), and after the backward pass
each parameter's gradient is averaged over the mesh's W ranks. The
collectives' backward passes (`collectives`) give each rank its part of
the gradient of the sum of the ranks' losses, which is W times the
loss: their average is the single-device step's gradient, and the
optimizer takes the same step on every rank. Parameters are replicated:
every rank holds the same values.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .. import losses

__all__ = ["shard_batch", "make_sharded_train_step"]


def shard_batch(observations, mesh, data_axis: str = "data"):
    """This rank's block `[T, B / data, ...]` of stacked `[T, B, ...]`
    observations (a tensor or a dict of them): the rows of its data shard
    (all of them when ``data_axis`` is not one of the mesh's axes)."""
    from ..sharding_utils import local_block

    if data_axis not in tuple(mesh.mesh_dim_names or ()):
        return observations
    return local_block(observations, mesh, {1: data_axis})


def make_sharded_train_step(num_particles: int, algorithm: str,
                            optimizer: torch.optim.Optimizer, mesh,
                            resampling_method: str = "systematic",
                            resampling_implementation="auto",
                            data_axis: str = "data",
                            particle_axis: str = "particle") -> Callable:
    """Builds the multi-rank train step ``step(components, observations,
    noise) -> loss``: the port's form of the JAX step's ``(components,
    opt_state, observations, key) -> (components, opt_state, loss)``, as
    `train.make_train_step` is (``optimizer`` holds the parameters and
    their state, and updates them in place).

    ``observations`` is this rank's block (`shard_batch`), ``noise`` the
    step's source, whose state must be the same on every rank (seed it
    alike); ``num_particles`` is the whole cloud's K. The loss comes back
    as a detached device scalar, the same on every rank.
    ``resampling_implementation`` may be a distributed callable
    (`make_distributed_fused_resampler`, ...); by default the all-gather
    exchange of ``resampling_method``. The mesh must span the whole
    world (`make_mesh` makes such meshes): the gradients are summed over
    the default process group.
    """
    world = dist.get_world_size()

    def step(components, observations, noise):
        initial, transition, emission, proposal = components
        optimizer.zero_grad(set_to_none=True)
        loss = losses.get_loss(
            observations, num_particles, algorithm, initial, transition,
            emission, proposal, noise=noise,
            resampling_method=resampling_method,
            resampling_implementation=resampling_implementation,
            mesh=mesh, data_axis=data_axis, particle_axis=particle_axis)
        loss.backward()
        params = [p for group in optimizer.param_groups
                  for p in group["params"]]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if grads and world > 1:
            # The ranks' parts of each gradient, averaged over the mesh
            # in one all-reduce of the flattened gradients.
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat)
            flat = flat / world
            offset = 0
            for p, g in zip(params, grads):
                n = g.numel()
                p.grad = flat[offset:offset + n].view_as(p).clone()
                offset += n
        optimizer.step()
        return loss.detach()

    return step
