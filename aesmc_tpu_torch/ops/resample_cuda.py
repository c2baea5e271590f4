"""Fused systematic resample + gather: kernel K1 and its plain version.

For each batch row b and slot j < K:

    pos_j       = min((u_b + j) / K, nextafter(1, 0))
    idx_j       = min(#{i : cdf_i <= pos_j}, K - 1)
    out[b, j, :] = value[b, idx_j, :]

Replaces `aesmc_tpu/ops/resample_pallas.py::_window_kernel_impl` in
systematic mode (reached through `_window_call`'s `pl.pallas_call`, from
`systematic_search_gather_pallas` and `resample_and_gather_systematic`).
The TPU kernel's window starts, row-maximum tables, merge rows, VMEM/HBM
regimes and 12-column cap worked around the TPU's vector layout and VMEM
size; none of them is carried over.

Bound on an H100: at the main path's shape (B = 10, K = 10,000, D = 1) the
kernel moves about 1.2 MB (CDF, value and output, 400 KB each), 0.36 us of
HBM bandwidth; what bounds it is latency. The kernel
(`csrc/resample_systematic.cu`) gives each block a tile of 512 slots.
Their positions are sorted by construction, so the block stages the CDF
window under the tile in shared memory and searches all of its positions
there (`csrc/sorted_search.cuh`, K4's search), then writes its output
tile as one contiguous run, coalesced for any D (`csrc/tile_gather.cuh`).
Its source note gives the chain of steps that bounds it.

The gradient flows to the values only (ancestors and weights are
detached, as in the JAX package): the backward rebuilds the positions
with `systematic_positions`, bit-equal to the kernel's own, and runs the
range sum (`ops.range_sum_cuda`, K2) over them.

`resample_and_gather_systematic` launches the kernel for CUDA tensors (it
never falls back) and runs `resample_and_gather_systematic_torch`, the
plain PyTorch version, for CPU tensors. Each launch adds one to
`LAUNCHES`. Under tracing (`torch.export`; `_launch.tracing`) the launch
goes through the operator `aesmc_tpu_torch::resample_systematic`
(`torch.library.custom_op`, with a fake version), so that an exported
program records the kernel (`online.export_step`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _launch, range_sum_cuda

SOURCE = "resample_systematic.cu"

BELOW_ONE = float(np.nextafter(np.float32(1.0), np.float32(0.0)))

# Kernel launches made by `resample_and_gather_systematic` in this process.
LAUNCHES = 0


def systematic_positions(u: torch.Tensor, k: int) -> torch.Tensor:
    """The grid ``min((u + j) / k, nextafter(1, 0))`` for j < k, `[B, k]`.

    ``u`` is `[B]` or `[B, 1]` (systematic: one uniform a row) or `[B, k]`
    (stratified: one uniform a stratum). Divides by a tensor, not a Python
    number: on CUDA PyTorch turns division by a host scalar into a
    multiplication by its reciprocal, which can differ from the division
    in the last bit.
    """
    u = u.to(torch.float32)
    if u.ndim == 1:
        u = u[:, None]
    grid = u + torch.arange(k, dtype=torch.float32, device=u.device)
    kf = torch.full((), float(k), dtype=torch.float32, device=u.device)
    return torch.clamp(grid / kf, max=BELOW_ONE)


def resample_and_gather_systematic_torch(cdf, u, value, emit_idx=True):
    """The plain PyTorch version of K1: (idx `[B, K]` int32 or None,
    gathered `[B, K, D]`)."""
    k = cdf.shape[1]
    pos = systematic_positions(u, k)
    idx = torch.searchsorted(cdf, pos, right=True).clamp_(max=k - 1)
    out = torch.take_along_dim(value, idx.unsqueeze(-1), dim=1)
    return (idx.to(torch.int32) if emit_idx else None), out


def _check(cdf, u, value):
    _launch.check_float32(cdf.device, cdf=cdf, u=u, value=value)
    if cdf.ndim != 2:
        raise ValueError(f"cdf must be [B, K], got {tuple(cdf.shape)}")
    batch, k = cdf.shape
    if value.ndim != 3 or tuple(value.shape[:2]) != (batch, k):
        raise ValueError(f"value must be [B, K, D] = [{batch}, {k}, D], "
                         f"got {tuple(value.shape)}")
    if tuple(u.shape) not in ((batch,), (batch, 1)):
        raise ValueError(f"u must be [B] or [B, 1], got {tuple(u.shape)}")
    _launch.check_sizes(k)
    _launch.check_columns(value.shape[2])


def _launch_kernel(cdf, u, value, emit_idx):
    global LAUNCHES
    fn = _launch.entry(SOURCE, "aesmc_resample_systematic",
                       [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 +
                       [ctypes.c_int, ctypes.c_void_p])
    batch, k, d = value.shape
    out = torch.empty_like(value)
    idx = (torch.empty((batch, k), dtype=torch.int32, device=cdf.device)
           if emit_idx else None)
    device, stream = _launch.target(cdf)
    err = fn(cdf.data_ptr(), u.data_ptr(), _launch.pointer(value),
             _launch.pointer(out), _launch.pointer(idx), batch, k, d, device,
             stream)
    _launch.check_error(err, "resample_systematic")
    LAUNCHES += 1
    return idx, out


@torch.library.custom_op("aesmc_tpu_torch::resample_systematic",
                         mutates_args=(), device_types="cuda")
def _kernel_op(cdf: torch.Tensor, u: torch.Tensor, value: torch.Tensor,
               emit_idx: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The launch as an operator PyTorch can trace (`torch.export`, fake
    tensors): an empty index tensor stands for no index output."""
    idx, out = _launch_kernel(cdf, u, value, emit_idx)
    return (cdf.new_empty((0,), dtype=torch.int32) if idx is None
            else idx), out


@_kernel_op.register_fake
def _(cdf, u, value, emit_idx):
    batch, k, d = value.shape
    return (cdf.new_empty((batch, k) if emit_idx else (0,),
                          dtype=torch.int32), value.new_empty((batch, k, d)))


class _ResampleGatherSystematic(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cdf, u, value, emit_idx):
        if cdf.device.type == "cuda":
            if _launch.tracing():
                idx, out = _kernel_op(cdf, u, value, emit_idx)
                idx = idx if emit_idx else None
            else:
                idx, out = _launch_kernel(cdf, u, value, emit_idx)
        else:
            idx, out = resample_and_gather_systematic_torch(cdf, u, value,
                                                            emit_idx)
        ctx.save_for_backward(cdf, u)
        if idx is not None:
            ctx.mark_non_differentiable(idx)
        return idx, out

    @staticmethod
    def backward(ctx, grad_idx, grad_out):
        cdf, u = ctx.saved_tensors
        pos = systematic_positions(u, cdf.shape[1])
        grad_value = range_sum_cuda.range_sum(cdf, pos,
                                              grad_out.contiguous())
        return None, None, grad_value, None


def resample_and_gather_systematic(cdf, u, value, emit_idx=True):
    """Fused systematic resample + gather (K1), differentiable in
    ``value`` (the backward is K2).

    Args:
        cdf: `[B, K]` float32 normalized CDF, nondecreasing, last entry 1.
        u: `[B]` or `[B, 1]` float32 uniforms.
        value: `[B, K, D]` float32 particles; D may be 0, and then the
            launch only finds the indices.
        emit_idx: whether to return the ancestor indices.

    Returns:
        (idx `[B, K]` int32, or None without emit_idx; gathered `[B, K, D]`).
    """
    _check(cdf, u, value)
    return _ResampleGatherSystematic.apply(cdf, u.reshape(-1), value,
                                           bool(emit_idx))
