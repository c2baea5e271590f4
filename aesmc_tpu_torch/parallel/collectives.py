"""The collectives of the multi-device layer, in one place.

Counterpart of the `jax.lax` collectives the JAX package's `parallel`
modules call inside `shard_map` (`all_gather`, `pmax`, `psum`,
`ppermute`, `axis_index`). Every rank runs the same code on its own
block, and these functions are the only places where blocks meet. Each
takes the `torch.distributed` process group of one mesh axis
(`DeviceMesh.get_group(name)`).

Gradients. Each collective's backward is that of its sum: the ranks'
objectives add up to the global one, and a rank's backward pass gives
its part of each gradient, the parts summing to the whole:

- `all_gather` hands every rank the whole tensor: the backward sums the
  ranks' cotangents and keeps this rank's slice;
- `all_reduce` with 'sum' hands every rank the sum: the backward sums
  the ranks' cotangents (the same on every rank) for each input; 'max'
  is for detached shifts and has no gradient;
- `ring_shift` moves tensors one rank along the ring: the backward moves
  the cotangents one rank back.

A loss that every rank holds alike (the batch mean of log-Z) counts once
on each of the W ranks, so its parts sum to W times its gradient: the
sharded train step averages the ranks' gradients (`sharded`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["size", "rank_in", "all_gather", "all_reduce", "ring_shift"]


def size(group) -> int:
    """The number of ranks in ``group``."""
    return dist.get_world_size(group)


def rank_in(group) -> int:
    """This rank's index in ``group`` (`jax.lax.axis_index`)."""
    return dist.get_rank(group)


def _gather_into(out, x, group):
    # torch 2.13 renamed all_gather_into_tensor to all_gather_single and
    # warns on the old name; older versions (2.11) have the old name only.
    fn = getattr(dist, "all_gather_single", None)
    if fn is None:
        fn = dist.all_gather_into_tensor
    fn(out, x, group=group)


def _scatter_into(out, x, group):
    # The same renaming as `_gather_into` (reduce_scatter_tensor).
    fn = getattr(dist, "reduce_scatter_single", None)
    if fn is None:
        fn = dist.reduce_scatter_tensor
    fn(out, x, group=group)


def _gather_stacked(x, group):
    """`[n, *x.shape]`: every rank's ``x``, in rank order."""
    n = size(group)
    x = x.contiguous()
    if x.ndim == 0:
        x = x.reshape(1)
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    _gather_into(out, x, group)
    return out.reshape((n,) + tuple(x.shape))


def _gather_tiled(x, group, dim):
    stacked = _gather_stacked(x, group)                   # [n, ..., m, ...]
    shape = list(x.shape)
    shape[dim] *= stacked.shape[0]
    return stacked.movedim(0, dim).reshape(shape)         # [..., n m, ...]


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather_tiled(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        group, dim = ctx.group, ctx.dim
        n = size(group)
        shape = list(grad.shape)
        shape[dim:dim + 1] = [n, shape[dim] // n]
        blocks = grad.reshape(shape).movedim(dim, 0).contiguous()
        # This rank's block of the sum of every rank's cotangent.
        out = blocks.new_empty(blocks.shape[1:])
        _scatter_into(out, blocks.reshape((-1,) + tuple(blocks.shape[2:])),
                      group)
        return out, None, None


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (tiled):
    `[.., n * m, ..]` from `[.., m, ..]`. Differentiable: the backward sums
    the ranks' cotangents and keeps this rank's slice."""
    dim = dim % x.ndim
    if x.requires_grad:
        return _AllGather.apply(x, group, dim)
    return _gather_tiled(x, group, dim)


def _reduce(x, group, op=dist.ReduceOp.SUM):
    out = x.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _reduce(grad.contiguous(), ctx.group), None


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The elementwise sum or max of every rank's ``x``, on every rank (a
    new tensor). The sum is differentiable (the backward sums the ranks'
    cotangents); the max is for detached values (it raises on one that
    needs a gradient)."""
    if op == "sum":
        if x.requires_grad:
            return _AllReduceSum.apply(x, group)
        return _reduce(x, group)
    if op == "max":
        if x.requires_grad:
            raise ValueError("all_reduce(op='max') has no gradient; pass a "
                             "detached tensor")
        return _reduce(x, group, dist.ReduceOp.MAX)
    raise ValueError(f"op must be 'sum' or 'max'. currently = {op}")


def _peers(group, step):
    n = size(group)
    me = rank_in(group)
    return (dist.get_global_rank(group, (me - step) % n),
            dist.get_global_rank(group, (me + step) % n))


def _shift_direct(tensors, group, step):
    """`_shift` with the tensors themselves (NCCL, or gloo on host
    tensors): one batch of P2P ops."""
    to, frm = _peers(group, step)
    tensors = [t.contiguous() for t in tensors]
    received = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, r in zip(tensors, received):
        ops.append(dist.P2POp(dist.isend, t, to, group))
        ops.append(dist.P2POp(dist.irecv, r, frm, group))
    for request in dist.batch_isend_irecv(ops):
        request.wait()
    return received


def _shift_staged(tensors, group, step):
    """`_shift` through host copies: gloo's point-to-point ops take host
    tensors only (its collectives stage device tensors through host
    memory themselves; its send/recv abort the process on a CUDA
    tensor). The received host copies go back to each tensor's device."""
    host = [t.detach().contiguous().cpu() for t in tensors]
    received = _shift_direct(host, group, step)
    return [r.to(t.device) for r, t in zip(received, tensors)]


def _shift(tensors, group, step):
    """Sends each tensor to the rank ``step`` places back on the ring and
    receives the one from ``step`` places ahead. A gloo group stages
    device tensors through host memory (`_shift_staged`)."""
    if (dist.get_backend(group) == "gloo" and
            any(t.device.type != "cpu" for t in tensors)):
        return _shift_staged(tensors, group, step)
    return _shift_direct(tensors, group, step)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        ctx.floating = [t.is_floating_point() for t in tensors]
        out = _shift(tensors, group, 1)
        for t, o in zip(tensors, out):
            if not t.is_floating_point():
                ctx.mark_non_differentiable(o)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        moving = [g for g, f in zip(grads, ctx.floating) if f]
        back = iter(_shift([g.contiguous() for g in moving], ctx.group, -1))
        return (None,) + tuple(next(back) if f else None
                               for f in ctx.floating)


def ring_shift(tensors, group):
    """Pulls each tensor of ``tensors`` one rank along the ring: rank d gets
    rank d + 1's (mod n), as the JAX ring's `ppermute` with pairs
    (i, i - 1) does. Differentiable in the floating-point tensors: the
    backward moves the cotangents one rank back. Returns a list."""
    tensors = list(tensors)
    if size(group) == 1:
        return tensors
    if any(t.requires_grad for t in tensors):
        return list(_RingShift.apply(group, *tensors))
    return _shift(tensors, group, 1)
