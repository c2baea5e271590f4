"""Search + gather over loaded sorted positions: kernel K3 and its plain
version.

For each batch row b and slot j < Kp (Kp may differ from K):

    idx_j        = min(#{i : cdf_i <= pos_j}, K - 1)
    out[b, j, :] = value[b, idx_j, :]

Replaces `aesmc_tpu/ops/resample_pallas.py::_window_kernel_impl` in
sorted-positions mode (`sorted_search_gather_pallas`, reached through
`resample_and_gather` and `resample_and_gather_cdf`). Stratified and
multinomial resampling run it. The kernel (`csrc/resample_sorted.cu`) is
K4's search (a shared-memory CDF window per tile of 512 sorted
positions, `csrc/sorted_search.cuh`) followed by a tile gather coalesced
for any D (`csrc/tile_gather.cuh`); its source note gives the bound on
the card.

With no value columns (value None or D = 0) there is nothing to gather,
and `resample_and_gather_sorted` hands the search to K4
(`ops.searchsorted_sorted_cuda`), so that every index-only launch is K4's;
K3 runs with D >= 1 only.

The gradient flows to the values only (ancestors and weights are
detached, as in the JAX package): the backward is the range sum
(`ops.range_sum_cuda`, K2) over the positions the forward searched.

`resample_and_gather_sorted` launches the kernel for CUDA tensors (it
never falls back) and runs its plain PyTorch version (searchsorted,
take_along_dim) for CPU tensors. Each launch adds one to `LAUNCHES`.
Under tracing (`torch.export`; `_launch.tracing`) the launch goes
through the operator `aesmc_tpu_torch::resample_sorted`
(`torch.library.custom_op`, with a fake version), so that an
exported program records the kernel (`online.export_step`).
"""

from __future__ import annotations

import ctypes

import torch

from . import _launch, range_sum_cuda, searchsorted_sorted_cuda

SOURCE = "resample_sorted.cu"

# Kernel launches made by `resample_and_gather_sorted` in this process.
LAUNCHES = 0


def resample_and_gather_sorted_torch(cdf, pos, value, emit_idx=True):
    """The plain PyTorch version of K3: (idx `[B, Kp]` int32 or None,
    gathered `[B, Kp, D]`)."""
    idx = searchsorted_sorted_cuda.searchsorted_sorted_torch(cdf, pos)
    out = torch.take_along_dim(value, idx.long().unsqueeze(-1), dim=1)
    return (idx if emit_idx else None), out


def _check(cdf, pos, value):
    _launch.check_float32(cdf.device, cdf=cdf, pos=pos, value=value)
    if cdf.ndim != 2 or pos.ndim != 2 or pos.shape[0] != cdf.shape[0]:
        raise ValueError(f"cdf must be [B, K] and pos [B, Kp], got "
                         f"{tuple(cdf.shape)} and {tuple(pos.shape)}")
    batch, k = cdf.shape
    if value.ndim != 3 or tuple(value.shape[:2]) != (batch, k):
        raise ValueError(f"value must be [B, K, D] = [{batch}, {k}, D], "
                         f"got {tuple(value.shape)}")
    _launch.check_sizes(k, pos.shape[1])
    _launch.check_columns(value.shape[2])


def _launch_kernel(cdf, pos, value, emit_idx):
    global LAUNCHES
    fn = _launch.entry(SOURCE, "aesmc_resample_sorted",
                       [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 4 +
                       [ctypes.c_int, ctypes.c_void_p])
    batch, k, d = value.shape
    kp = pos.shape[1]
    out = torch.empty((batch, kp, d), dtype=torch.float32,
                      device=value.device)
    idx = (torch.empty((batch, kp), dtype=torch.int32, device=cdf.device)
           if emit_idx else None)
    device, stream = _launch.target(cdf)
    err = fn(cdf.data_ptr(), pos.data_ptr(), _launch.pointer(value),
             _launch.pointer(out), _launch.pointer(idx), batch, k, kp, d,
             device, stream)
    _launch.check_error(err, "resample_sorted")
    LAUNCHES += 1
    return idx, out


@torch.library.custom_op("aesmc_tpu_torch::resample_sorted",
                         mutates_args=(), device_types="cuda")
def _kernel_op(cdf: torch.Tensor, pos: torch.Tensor, value: torch.Tensor,
               emit_idx: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The launch as an operator PyTorch can trace (`torch.export`, fake
    tensors): an empty index tensor stands for no index output."""
    idx, out = _launch_kernel(cdf, pos, value, emit_idx)
    return (cdf.new_empty((0,), dtype=torch.int32) if idx is None
            else idx), out


@_kernel_op.register_fake
def _(cdf, pos, value, emit_idx):
    batch, kp = pos.shape
    return (cdf.new_empty((batch, kp) if emit_idx else (0,),
                          dtype=torch.int32),
            value.new_empty((batch, kp, value.shape[2])))


class _ResampleGatherSorted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cdf, pos, value, emit_idx):
        if cdf.device.type == "cuda":
            if _launch.tracing():
                idx, out = _kernel_op(cdf, pos, value, emit_idx)
                idx = idx if emit_idx else None
            else:
                idx, out = _launch_kernel(cdf, pos, value, emit_idx)
        else:
            idx, out = resample_and_gather_sorted_torch(cdf, pos, value,
                                                        emit_idx)
        ctx.save_for_backward(cdf, pos)
        if idx is not None:
            ctx.mark_non_differentiable(idx)
        return idx, out

    @staticmethod
    def backward(ctx, grad_idx, grad_out):
        cdf, pos = ctx.saved_tensors
        grad_value = range_sum_cuda.range_sum(cdf, pos,
                                              grad_out.contiguous())
        return None, None, grad_value, None


def resample_and_gather_sorted(cdf, pos, value, emit_idx=True):
    """Fused search + gather over sorted positions (K3), differentiable in
    ``value`` (the backward is K2).

    Args:
        cdf: `[B, K]` float32 normalized CDF, nondecreasing, last entry 1.
        pos: `[B, Kp]` float32 sorted positions in [0, 1).
        value: `[B, K, D]` float32 particles; with None or D = 0 the
            search is K4's (`searchsorted_sorted_cuda.searchsorted_sorted`)
            and nothing is gathered.
        emit_idx: whether to return the ancestor indices.

    Returns:
        (idx `[B, Kp]` int32, or None without emit_idx; gathered
        `[B, Kp, D]`).
    """
    if value is not None:
        _check(cdf, pos, value)
    if value is None or value.shape[2] == 0:
        idx = searchsorted_sorted_cuda.searchsorted_sorted(cdf, pos)
        out = pos.new_empty((pos.shape[0], pos.shape[1], 0))
        return (idx if emit_idx else None), out
    return _ResampleGatherSorted.apply(cdf, pos, value, bool(emit_idx))
