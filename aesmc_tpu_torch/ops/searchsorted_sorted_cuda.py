"""Index-only search of sorted positions in a CDF: kernel K4 and its plain
version.

For each batch row b and slot j < Kp (Kp may differ from Kc):

    idx[b, j] = min(#{i : cdf[b, i] <= pos[b, j]}, Kc - 1)

Replaces `aesmc_tpu/ops/resample_pallas.py::_make_resample_kernel` with
`cdf_input=True`, as `searchsorted_sorted_cdf_pallas` launches it: the
index-only search of stratified and multinomial `sample_ancestral_index`,
and of resampling whose particles are all gathered apart (integer
particles, through K5). The kernel (`csrc/searchsorted_sorted.cu`) stages,
for each tile of 1,024 sorted positions, the window of the CDF that decides
them in shared memory and searches there; its source note gives the design
and the bound on the card. The indices carry no gradient, so there is no
autograd node.

`searchsorted_sorted` launches the kernel for CUDA tensors (it never falls
back) and runs `searchsorted_sorted_torch`, the plain PyTorch version, for
CPU tensors. Each launch adds one to `LAUNCHES`. Under tracing
(`torch.export`; `_launch.tracing`) the launch goes through the operator
`aesmc_tpu_torch::searchsorted_sorted` (`torch.library.custom_op`, with a
fake version), so that an exported program records the kernel
(`online.export_step`).
"""

from __future__ import annotations

import ctypes

import torch

from . import _launch

SOURCE = "searchsorted_sorted.cu"
_SYMBOL = "aesmc_searchsorted_sorted"
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 +
             [ctypes.c_int, ctypes.c_void_p])

# Kernel launches made by `searchsorted_sorted` in this process.
LAUNCHES = 0
# The bound C entry, from the first launch on.
_entry = None


def searchsorted_sorted_torch(cdf, pos):
    """The plain PyTorch version of K4: `[B, Kp]` int32,
    ``torch.searchsorted(cdf, pos, right=True)`` clamped to K - 1."""
    k = cdf.shape[1]
    idx = torch.searchsorted(cdf, pos, right=True).clamp_(max=k - 1)
    return idx.to(torch.int32)


def _check(cdf, pos):
    """One pass over both tensors: float32, contiguous, one device (the
    CPU or a card), `[B, Kc]` and `[B, Kp]`. Returns (B, Kc, Kp)."""
    for name, t in (("cdf", cdf), ("pos", pos)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t)}")
        if t.dtype is not torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if pos.device != cdf.device:
        raise ValueError(f"pos is on {pos.device}, cdf on {cdf.device}")
    if not (cdf.is_cuda or cdf.is_cpu):
        raise ValueError(f"unsupported device {cdf.device}")
    if cdf.dim() != 2 or pos.dim() != 2 or pos.shape[0] != cdf.shape[0]:
        raise ValueError(f"cdf must be [B, Kc] and pos [B, Kp], got "
                         f"{tuple(cdf.shape)} and {tuple(pos.shape)}")
    batch, kc = cdf.shape
    kp = pos.shape[1]
    _launch.check_sizes(kc, kp)
    return batch, kc, kp


def searchsorted_sorted(cdf, pos):
    """Index-only search of sorted positions in a CDF (K4).

    Args:
        cdf: `[B, Kc]` float32 normalized CDF, nondecreasing.
        pos: `[B, Kp]` float32 positions, sorted along each row (any
            positions give the exact indices; sorted ones keep each
            block's search inside its shared-memory window).

    Returns:
        `[B, Kp]` int32: ``min(#{i : cdf_i <= pos_j}, Kc - 1)``.
    """
    _check(cdf, pos)
    if not cdf.is_cuda:
        return searchsorted_sorted_torch(cdf, pos)
    return (_kernel_op(cdf, pos) if _launch.tracing() else
            _launch_kernel(cdf, pos))


def _launch_kernel(cdf, pos):
    global LAUNCHES, _entry
    batch, kc = cdf.shape
    kp = pos.shape[1]
    if _entry is None:
        _entry = _launch.entry(SOURCE, _SYMBOL, _ARGTYPES)
    idx = torch.empty_like(pos, dtype=torch.int32)
    card, stream = _launch.target(cdf)
    err = _entry(cdf.data_ptr(), pos.data_ptr(), idx.data_ptr(), batch, kc,
                 kp, card, stream)
    if err:
        _launch.check_error(err, "searchsorted_sorted")
    LAUNCHES += 1
    return idx


@torch.library.custom_op("aesmc_tpu_torch::searchsorted_sorted",
                         mutates_args=(), device_types="cuda")
def _kernel_op(cdf: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The launch as an operator PyTorch can trace (`torch.export`, fake
    tensors)."""
    return _launch_kernel(cdf, pos)


@_kernel_op.register_fake
def _(cdf, pos):
    return pos.new_empty(pos.shape, dtype=torch.int32)
