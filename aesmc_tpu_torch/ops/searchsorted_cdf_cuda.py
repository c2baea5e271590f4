"""Fused CDF + search + gather from log-weights: kernel K6 and its plain
version.

For each batch row b and slot j < Kp:

    w     = round(exp(logw - max logw) * 2^38)     (int64 fixed point)
    cum   = float32(cumsum(w))
    cdf   = min(cum * (1 / cum[-1]), 1), and its last entry 1
    idx_j = min(#{i : cdf_i <= pos_j}, K - 1)
    out[b, j, :] = value[b, idx_j, :]

Replaces `aesmc_tpu/ops/resample_pallas.py::_make_resample_kernel` with
`cdf_input=False` (the in-kernel exp and prefix sums `_lane_prefix`,
`_row_prefix`), launched by `searchsorted_cdf_pallas`, the entry point
this module ports. The JAX engine never calls it: it searches the CDF that
`_normalized_cumsum` builds, whose summation order the in-kernel prefix
does not share (`resample_pallas.py:1192-1197`). The same holds here: the
engine builds the CDF with torch ops and runs K1 or K3.

The TPU kernel sums its float32 weights in float32, and float32 prefix
sums taken in two orders drift apart as K grows: on an H100, float32
`torch.cumsum` put 70% of the indices off those of a float64 CDF, by up
to 119, at K = 4,194,304 (PERF.md, K6). Here the weights are summed as
integers, exactly, so the kernel (`csrc/searchsorted_cdf.cu`, which
splits each row over a cluster of 8 blocks) and the plain version build
the same CDF bit for bit in any order, and their indices are equal. A
weight below 2^-39 of the row's largest counts as 0, so no position
picks it. Against the JAX package's float32 CDF the indices stay within
its bound for CDFs summed in another order (fewer than 0.5% differ, each
by at most 3; `tests/test_resample_pallas.py:39-49`) up to K = 100,000
on N(0, 2^2) log-weights; beyond, the float32 CDF drifts. Gathered
values are always the values at the kernel's own indices. Forward only,
like `searchsorted_cdf_pallas`.

`searchsorted_cdf` launches the kernel for CUDA tensors (it never falls
back) and runs `searchsorted_cdf_torch` for CPU tensors. Each launch adds
one to `LAUNCHES`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _launch

SOURCE = "searchsorted_cdf.cu"

# A weight of 1 (the row's largest) in the CDF's fixed point: 2^38.
FIXED_ONE = 2.0 ** 38

# Kernel launches made by `searchsorted_cdf` in this process.
LAUNCHES = 0


def searchsorted_cdf_torch(log_weight, pos, values=None):
    """The plain PyTorch version of K6: idx `[B, Kp]` int32, or (idx,
    gathered `[B, Kp, D]`) when ``values`` is given."""
    k = log_weight.shape[1]
    w = torch.exp(log_weight - log_weight.max(dim=1, keepdim=True).values)
    fixed = torch.round(w * FIXED_ONE).to(torch.int64)
    cum = torch.cumsum(fixed, dim=1).to(torch.float32)
    cdf = (cum * (1.0 / cum[:, -1:])).clamp_(max=1.0)
    cdf[:, -1] = 1.0
    idx = torch.searchsorted(cdf, pos, right=True).clamp_(max=k - 1)
    idx = idx.to(torch.int32)
    if values is None:
        return idx
    return idx, torch.take_along_dim(values, idx.long().unsqueeze(-1), dim=1)


def _check(log_weight, pos, values):
    tensors = dict(log_weight=log_weight, pos=pos)
    if values is not None:
        tensors["values"] = values
    _launch.check_float32(log_weight.device, **tensors)
    if (log_weight.ndim != 2 or pos.ndim != 2 or
            pos.shape[0] != log_weight.shape[0]):
        raise ValueError(f"log_weight must be [B, K] and pos [B, Kp], got "
                         f"{tuple(log_weight.shape)} and {tuple(pos.shape)}")
    batch, k = log_weight.shape
    if values is not None and (values.ndim != 3 or
                               tuple(values.shape[:2]) != (batch, k)):
        raise ValueError(f"values must be [B, K, D] = [{batch}, {k}, D], "
                         f"got {tuple(values.shape)}")
    _launch.check_sizes(k, pos.shape[1])


def _launch_kernel(log_weight, pos, values):
    global LAUNCHES
    fn = _launch.entry(SOURCE, "aesmc_searchsorted_cdf",
                       [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 4 +
                       [ctypes.c_int, ctypes.c_void_p])
    batch, k = log_weight.shape
    kp = pos.shape[1]
    d = 0 if values is None else values.shape[2]
    dev = log_weight.device
    idx = torch.empty((batch, kp), dtype=torch.int32, device=dev)
    out = torch.empty((batch, kp, d), dtype=torch.float32, device=dev)
    scratch = torch.empty((batch, k), dtype=torch.float32, device=dev)
    device, stream = _launch.target(log_weight)
    err = fn(log_weight.data_ptr(), pos.data_ptr(), _launch.pointer(values),
             _launch.pointer(out), idx.data_ptr(), scratch.data_ptr(),
             batch, k, kp, d, device, stream)
    _launch.check_error(err, "searchsorted_cdf")
    LAUNCHES += 1
    return idx if values is None else (idx, out)


def searchsorted_cdf(log_weight, pos, values=None):
    """Ancestor indices straight from log-weights (K6), and optionally the
    particles at them; the counterpart of `searchsorted_cdf_pallas`.

    Args:
        log_weight: `[B, K]` float32 unnormalized log-weights.
        pos: `[B, Kp]` float32 sorted positions in [0, 1).
        values: optional `[B, K, D]` float32 particles (forward only).

    Returns:
        idx `[B, Kp]` int32, or (idx, gathered `[B, Kp, D]`) with values.
    """
    _check(log_weight, pos, values)
    if log_weight.device.type == "cuda":
        if values is not None and values.requires_grad:
            raise ValueError("searchsorted_cdf (K6) is forward-only")
        return _launch_kernel(log_weight, pos, values)
    return searchsorted_cdf_torch(log_weight, pos, values)
