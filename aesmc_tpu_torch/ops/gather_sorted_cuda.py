"""Gather by sorted ancestor indices: kernel K5 and its plain version.

For each batch row b and slot j < Kp (Kp may differ from K):

    out[b, j, ...] = value[b, idx[b, j], ...]

with idx clamped into [0, K - 1]. Replaces
`aesmc_tpu/ops/gather_pallas.py::_gather_kernel` (`gather_sorted_pallas`,
reached through `resampling.resample_particles` on the kernel route). The
TPU kernel moves float32 only, so the JAX package carries integer
particles through it as 16-bit halves in float32 columns
(`aesmc_tpu/resampling.py:588-598`); the kernel here
(`csrc/gather_sorted.cu`) copies elements as raw bits, so every dtype of
1, 2, 4 or 8 bytes moves bit for bit with no transport. A row of D
elements moves as fewer, wider elements where its bytes and the addresses
allow (`_unit`). Its source note gives the design and the bound on the
card.

Forward only, like `gather_sorted_pallas`: a CUDA value that requires a
gradient raises ValueError. Float32 particles that need gradients travel
through K1 or K3, whose backward is K2.

`gather_sorted` launches the kernel for CUDA tensors (it never falls
back) and runs `gather_sorted_torch`, the plain PyTorch version
(take_along_dim, as `state.resample` gathers), for CPU tensors. Each
launch adds one to `LAUNCHES`.
Under tracing (`torch.export`; `_launch.tracing`) the launch goes
through the operator `aesmc_tpu_torch::gather_sorted`
(`torch.library.custom_op`, with a fake version), so that an
exported program records the kernel (`online.export_step`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _launch

SOURCE = "gather_sorted.cu"

# Kernel launches made by `gather_sorted` in this process.
LAUNCHES = 0


def gather_sorted_torch(value, idx):
    """The plain PyTorch version of K5: `[B, Kp, ...]`, ``value``'s dtype."""
    k = value.shape[1]
    index = idx.long().clamp(0, k - 1)
    index = index.reshape(tuple(index.shape) + (1,) * (value.ndim - 2))
    return torch.take_along_dim(value, index, dim=1)


def _unit(row_bytes, *addresses):
    """The widest element the kernel copies (16, 8, 4, 2 or 1 bytes) that a
    particle's row of ``row_bytes`` bytes splits into, with every address
    in ``addresses`` aligned to it: the kernel copies each row as
    row_bytes / unit elements of that width (D = 8 int32 columns as two
    16-byte elements)."""
    return next(unit for unit in (16, 8, 4, 2, 1)
                if row_bytes % unit == 0 and
                all(a % unit == 0 for a in addresses))


def _check(value, idx):
    for name, t in (("value", value), ("idx", idx)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if value.device != idx.device:
        raise ValueError(f"value is on {value.device}, idx on {idx.device}")
    if value.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {value.device}")
    if value.element_size() not in (1, 2, 4, 8):
        raise TypeError(f"value's elements must be 1, 2, 4 or 8 bytes, got "
                        f"{value.dtype}")
    if value.ndim < 2 or idx.ndim != 2 or idx.shape[0] != value.shape[0]:
        raise ValueError(f"value must be [B, K, ...] and idx [B, Kp], got "
                         f"{tuple(value.shape)} and {tuple(idx.shape)}")
    _launch.check_sizes(value.shape[1], idx.shape[1])


def _launch_kernel(value, idx):
    global LAUNCHES
    fn = _launch.entry(SOURCE, "aesmc_gather_sorted",
                       [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 4 +
                       [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    batch, k = value.shape[:2]
    kp = idx.shape[1]
    out = torch.empty((batch, kp) + tuple(value.shape[2:]),
                      dtype=value.dtype, device=value.device)
    if out.numel() == 0:
        return out
    row_bytes = math.prod(value.shape[2:]) * value.element_size()
    unit = _unit(row_bytes, value.data_ptr(), out.data_ptr())
    device, stream = _launch.target(value)
    err = fn(value.data_ptr(), idx.data_ptr(), out.data_ptr(), batch, k, kp,
             row_bytes // unit, unit, device, stream)
    _launch.check_error(err, "gather_sorted")
    LAUNCHES += 1
    return out


@torch.library.custom_op("aesmc_tpu_torch::gather_sorted", mutates_args=(),
                         device_types="cuda")
def _kernel_op(value: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The launch as an operator PyTorch can trace (`torch.export`, fake
    tensors)."""
    return _launch_kernel(value, idx)


@_kernel_op.register_fake
def _(value, idx):
    return value.new_empty(tuple(idx.shape) + tuple(value.shape[2:]))


def gather_sorted(value, idx):
    """Gathers particles by sorted ancestor indices (K5), forward only.

    Args:
        value: `[B, K, ...]` tensor of any dtype with 1-, 2-, 4- or 8-byte
            elements (int8, bool, int32, int64, bfloat16, float32,
            float64, ...).
        idx: `[B, Kp]` int32 ancestor indices, nondecreasing along each row
            (the kernel is right for any indices; sorted ones coalesce).

    Returns:
        `[B, Kp, ...]` tensor of ``value``'s dtype.
    """
    _check(value, idx)
    if value.device.type == "cuda":
        if value.requires_grad:
            raise ValueError(
                "gather_sorted (K5) is forward-only: it cannot carry a "
                "gradient to a value that requires one; float32 particles "
                "that need gradients resample through K1 or K3")
        return (_kernel_op(value, idx) if _launch.tracing() else
                _launch_kernel(value, idx))
    return gather_sorted_torch(value, idx)
