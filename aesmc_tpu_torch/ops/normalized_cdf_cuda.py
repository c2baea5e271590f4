"""The normalized CDF of log-weights in one launch: the CDF build of the
engine's resampling step on the card.

For each batch row b of `[B, K]` float32 log-weights:

    w     = exp(logw - max logw)
    r     = the running max of the cumulative sum of w (float32)
    cdf   = r / r[-1], and its last entry 1

the contract of `resampling._normalized_cumsum` (whose ~15 PyTorch
launches it replaces on the 'cuda' route), summed in the kernel's own
fixed order (`csrc/normalized_cdf.cu`): entries differ from the plain
version's by float32 rounding (about 1e-7), and the same input gives the
same bits on every launch, for any B. The normalizing constant cancels in
the division, so the kernel takes no logsumexp. A row whose maximum is not
finite comes out NaN with its last entry 1, as the plain version's does.
The kernel puts a row on a cluster of blocks, one a 2,048 entries, up to
8.

`normalized_cdf` launches the kernel; it takes CUDA tensors only (the
plain version is `resampling._normalized_cumsum`, which the CPU takes) and
never falls back. Each launch adds one to `LAUNCHES`. Under tracing
(`torch.export`; `_launch.tracing`) the launch goes through the operator
``aesmc_tpu_torch::normalized_cdf`` (`torch.library.custom_op`, with a
fake version), so that an exported program records the kernel
(`online.export_step`). Forward only: the engine's CDF carries no
gradient.
"""

from __future__ import annotations

import ctypes

import torch

from . import _launch

SOURCE = "normalized_cdf.cu"

# Kernel launches made by `normalized_cdf` in this process.
LAUNCHES = 0


def _check(log_weight):
    _launch.check_float32(log_weight.device, log_weight=log_weight)
    if log_weight.device.type != "cuda":
        raise ValueError(
            f"log_weight is on {log_weight.device}: normalized_cdf launches "
            f"the CUDA kernel (the plain version is "
            f"resampling._normalized_cumsum)")
    if log_weight.ndim != 2:
        raise ValueError(
            f"log_weight must be [B, K], got {tuple(log_weight.shape)}")
    _launch.check_sizes(log_weight.shape[1])


def _launch_kernel(log_weight):
    global LAUNCHES
    fn = _launch.entry(SOURCE, "aesmc_normalized_cdf",
                       [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 2 +
                       [ctypes.c_int, ctypes.c_void_p])
    batch, k = log_weight.shape
    cdf = torch.empty_like(log_weight)
    device, stream = _launch.target(log_weight)
    err = fn(_launch.pointer(log_weight), _launch.pointer(cdf), batch, k,
             device, stream)
    _launch.check_error(err, "normalized_cdf")
    LAUNCHES += 1
    return cdf


@torch.library.custom_op("aesmc_tpu_torch::normalized_cdf", mutates_args=(),
                         device_types="cuda")
def _kernel_op(log_weight: torch.Tensor) -> torch.Tensor:
    """The launch as an operator PyTorch can trace (`torch.export`, fake
    tensors)."""
    return _launch_kernel(log_weight)


@_kernel_op.register_fake
def _(log_weight):
    return torch.empty_like(log_weight)


def normalized_cdf(log_weight):
    """The normalized CDF of each row of log-weights, in one launch.

    Args:
        log_weight: `[B, K]` float32 unnormalized log-weights, contiguous,
            on a CUDA card; 1 <= K <= `_launch.MAX_PARTICLES`.

    Returns:
        `[B, K]` float32: nondecreasing, each entry in [0, 1], the last
        exactly 1.0.
    """
    _check(log_weight)
    if _launch.tracing():
        return _kernel_op(log_weight)
    return _launch_kernel(log_weight)
