"""Search + gather over loaded sorted positions: kernel K3 and its plain
version, and its index-only launch, the counterpart of kernel K4.

For each batch row b and slot j < Kp (Kp may differ from K):

    idx_j        = min(#{i : cdf_i <= pos_j}, K - 1)
    out[b, j, :] = value[b, idx_j, :]

Replaces `aesmc_tpu/ops/resample_pallas.py::_window_kernel_impl` in
sorted-positions mode (`sorted_search_gather_pallas`, reached through
`resample_and_gather` and `resample_and_gather_cdf`). Stratified and
multinomial resampling run it. The kernel (`csrc/resample_sorted.cu`) is
K1's thread-per-slot design with the positions read from global memory;
its source note gives the bound on the card.

With no value columns (D = 0, `searchsorted_sorted`) the same kernel is
index-only. That is the function of K4, the v1 merge kernel
`_make_resample_kernel(cdf_input=True)` that
`searchsorted_sorted_cdf_pallas` launches: the index-only search of
stratified and multinomial `sample_ancestral_index`, and of resampling
whose particles are all gathered apart (integer particles, through K5).
Index-only launches add one to `INDEX_LAUNCHES`, all others to
`LAUNCHES`.

The gradient flows to the values only (ancestors and weights are
detached, as in the JAX package): the backward is the range sum
(`ops.range_sum_cuda`, K2) over the positions the forward searched.

`resample_and_gather_sorted` and `searchsorted_sorted` launch the kernel
for CUDA tensors (they never fall back) and run their plain PyTorch
versions (searchsorted, take_along_dim) for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import _launch, range_sum_cuda

SOURCE = "resample_sorted.cu"

# Kernel launches in this process with value columns (K3) and without
# (index-only: K4's counterpart).
LAUNCHES = 0
INDEX_LAUNCHES = 0


def resample_and_gather_sorted_torch(cdf, pos, value, emit_idx=True):
    """The plain PyTorch version of K3: (idx `[B, Kp]` int32 or None,
    gathered `[B, Kp, D]`)."""
    idx = searchsorted_sorted_torch(cdf, pos)
    out = torch.take_along_dim(value, idx.long().unsqueeze(-1), dim=1)
    return (idx if emit_idx else None), out


def searchsorted_sorted_torch(cdf, pos):
    """The plain PyTorch version of the index-only launch: `[B, Kp]` int32,
    ``torch.searchsorted(cdf, pos, right=True)`` clamped to K - 1."""
    k = cdf.shape[1]
    idx = torch.searchsorted(cdf, pos, right=True).clamp_(max=k - 1)
    return idx.to(torch.int32)


def _check(cdf, pos, value):
    _launch.check_float32(cdf.device, cdf=cdf, pos=pos, value=value)
    if cdf.ndim != 2 or pos.ndim != 2 or pos.shape[0] != cdf.shape[0]:
        raise ValueError(f"cdf must be [B, K] and pos [B, Kp], got "
                         f"{tuple(cdf.shape)} and {tuple(pos.shape)}")
    batch, k = cdf.shape
    if value.ndim != 3 or tuple(value.shape[:2]) != (batch, k):
        raise ValueError(f"value must be [B, K, D] = [{batch}, {k}, D], "
                         f"got {tuple(value.shape)}")
    _launch.check_sizes(batch, k, pos.shape[1])


def _no_columns(cdf):
    """An empty `[B, K, 0]` value for an index-only launch."""
    if not isinstance(cdf, torch.Tensor):
        raise TypeError(f"cdf must be a tensor, got {type(cdf)}")
    return torch.empty(tuple(cdf.shape) + (0,), dtype=torch.float32,
                       device=cdf.device)


def _launch_kernel(cdf, pos, value, emit_idx):
    global LAUNCHES, INDEX_LAUNCHES
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
    if d:
        LAUNCHES += 1
    else:
        INDEX_LAUNCHES += 1
    return idx, out


class _ResampleGatherSorted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cdf, pos, value, emit_idx):
        if cdf.device.type == "cuda":
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
        value: `[B, K, D]` float32 particles; None or D = 0 makes the
            launch index-only (as `searchsorted_sorted`).
        emit_idx: whether to return the ancestor indices.

    Returns:
        (idx `[B, Kp]` int32, or None without emit_idx; gathered
        `[B, Kp, D]`).
    """
    if value is None:
        value = _no_columns(cdf)
    _check(cdf, pos, value)
    return _ResampleGatherSorted.apply(cdf, pos, value, bool(emit_idx))


def searchsorted_sorted(cdf, pos):
    """Index-only search of sorted positions in a CDF (K4's function):
    ``min(#{i : cdf_i <= pos_j}, K - 1)`` as `[B, Kp]` int32, any Kp.

    Args:
        cdf: `[B, K]` float32 normalized CDF, nondecreasing.
        pos: `[B, Kp]` float32 positions; sorted positions make the
            searches of neighbouring threads share their cache lines.
    """
    empty = _no_columns(cdf)
    _check(cdf, pos, empty)
    if cdf.device.type == "cuda":
        return _launch_kernel(cdf, pos, empty, True)[0]
    return searchsorted_sorted_torch(cdf, pos)
