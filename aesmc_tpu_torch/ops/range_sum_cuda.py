"""Deterministic range sum: kernel K2 and its plain version.

The backward of the fused resample+gather kernels (K1, K3). The forward
sent slot j (sorted position pos_j) to source
idx_j = min(#{i : cdf_i <= pos_j}, K - 1); the gradient of source i is the
sum of the cotangents of its slots:

    grad[b, i, :] = sum of g[b, j, :] over the j with idx_j = i

Replaces `aesmc_tpu/ops/resample_pallas.py::_window_kernel_impl` in
range-sum mode (`range_sum_pallas`, reached through
`gather_backward_pallas` from the VJPs `_rgs_bwd`, `_rg_bwd` and
`_rgc_bwd`). The kernel (`csrc/range_sum.cu`) is a segmented sum over
tiles of 1,024 slots: each block finds the source of each of its slots
through a window of the CDF in shared memory (the search K4 uses), sums
each segment that starts in its tile in a fixed order, finishing a
segment that runs past the tile itself, and writes 0 for the sources with
no slot. One launch, no atomics, no scratch: the same bits on every run.
Its source note gives the design and the bound on the card.

`range_sum` launches the kernel for CUDA tensors (it never falls back) and
runs `range_sum_torch`, the plain PyTorch version (searchsorted, clamp,
scatter_add), for CPU tensors. Each launch adds one to `LAUNCHES`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _launch

SOURCE = "range_sum.cu"

# Kernel launches made by `range_sum` in this process.
LAUNCHES = 0


def range_sum_torch(cdf, pos, g):
    """The plain PyTorch version of K2: `[B, K, D]` gradients."""
    batch, k = cdf.shape
    idx = torch.searchsorted(cdf, pos, right=True).clamp_(max=k - 1)
    out = torch.zeros((batch, k, g.shape[2]), dtype=g.dtype, device=g.device)
    return out.scatter_add_(1, idx.unsqueeze(-1).expand(g.shape), g)


def _check(cdf, pos, g):
    _launch.check_float32(cdf.device, cdf=cdf, pos=pos, g=g)
    if cdf.ndim != 2 or pos.ndim != 2 or pos.shape[0] != cdf.shape[0]:
        raise ValueError(f"cdf must be [B, K] and pos [B, Kp], got "
                         f"{tuple(cdf.shape)} and {tuple(pos.shape)}")
    batch, kp = pos.shape
    if g.ndim != 3 or tuple(g.shape[:2]) != (batch, kp):
        raise ValueError(f"g must be [B, Kp, D] = [{batch}, {kp}, D], got "
                         f"{tuple(g.shape)}")
    _launch.check_sizes(cdf.shape[1], kp)


def _launch_kernel(cdf, pos, g):
    global LAUNCHES
    fn = _launch.entry(SOURCE, "aesmc_range_sum",
                       [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4 +
                       [ctypes.c_int, ctypes.c_void_p])
    batch, k = cdf.shape
    kp, d = g.shape[1:]
    out = torch.empty((batch, k, d), dtype=torch.float32, device=g.device)
    device, stream = _launch.target(cdf)
    err = fn(cdf.data_ptr(), pos.data_ptr(), g.data_ptr(), out.data_ptr(),
             batch, k, kp, d, device, stream)
    _launch.check_error(err, "range_sum")
    LAUNCHES += 1
    return out


def range_sum(cdf, pos, g):
    """Gradient of the fused sorted gather with respect to its values (K2).

    Args:
        cdf: `[B, K]` float32 normalized CDF, nondecreasing.
        pos: `[B, Kp]` float32 positions the forward searched,
            nondecreasing along each row (the kernel sums runs of them).
        g: `[B, Kp, D]` float32 cotangents of the gathered values.

    Returns:
        `[B, K, D]` float32: source i gets the sum of the cotangents of the
        slots the forward gathered from it.
    """
    _check(cdf, pos, g)
    if cdf.device.type == "cuda":
        return _launch_kernel(cdf, pos, g)
    return range_sum_torch(cdf, pos, g)
