"""What every kernel wrapper does around its launch: input checks, binding
the C entry, the card and stream to launch on, and the error check."""

from __future__ import annotations

import ctypes

import torch

from . import _build

# Largest K: slot indices and K must be exact in float32 for the
# positions to be bit-exact, and ancestor indices fit int32.
MAX_PARTICLES = 1 << 24
# Largest D of K1's and K3's values: a block's output tile (512 slots of D
# floats) is indexed in 32 bits.
MAX_COLUMNS = 1 << 22


def check_float32(device: torch.device, **tensors) -> None:
    """Each tensor is float32, contiguous and on ``device``, which is the
    CPU (the plain version) or a CUDA card (the kernel)."""
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(t)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")


def check_sizes(*lengths: int) -> None:
    """Each particle count is in [1, MAX_PARTICLES]. Any number of batch
    rows is taken: the kernels put rows on the grid's second and third
    dimensions, or a cluster a row on its first."""
    for n in lengths:
        if n < 1 or n > MAX_PARTICLES:
            raise ValueError(
                f"particle counts must be in [1, {MAX_PARTICLES}], got {n}")


def check_columns(d: int) -> None:
    if d > MAX_COLUMNS:
        raise ValueError(f"D must be at most {MAX_COLUMNS}, got {d}")


# (source, symbol) -> the bound C entry, resolved at its first launch.
_entries: dict = {}


def entry(source: str, symbol: str, argtypes):
    """The C entry ``symbol`` of the library built from ``source``, with
    its argument types set (ctypes would otherwise pass each pointer as a
    32-bit int). Bound once per process: later calls are a dict lookup,
    with none of `_build.load`'s locks."""
    fn = _entries.get((source, symbol))
    if fn is None:
        fn = getattr(_build.load(source), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[(source, symbol)] = fn
    return fn


def pointer(t):
    """``t``'s device address, or None (a null pointer) for an empty tensor
    or None: an empty tensor's `data_ptr()` may be 0 or dangling, and the
    kernels never touch a pointer whose extent is 0."""
    return t.data_ptr() if t is not None and t.numel() else None


def target(t: torch.Tensor):
    """(card index, PyTorch's current stream on it) for a CUDA tensor. The
    raw stream handle is read without building a `torch.cuda.Stream`
    object (as Triton's launcher reads it), which costs a few µs of host
    time a launch."""
    device = t.get_device()
    return device, torch._C._cuda_getCurrentRawStream(device)


def check_error(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def tracing() -> bool:
    """Whether PyTorch is tracing the caller (`torch.export`,
    `torch.compile`). The wrappers then launch through their operators
    (`torch.library.custom_op`, with fake versions), which a trace records;
    eagerly and under a CUDA-graph capture they launch directly, without
    the operator's dispatch (11-29 us more host time a launch on the
    H100's host, `chip_smoke.py` phase 3e)."""
    return torch.compiler.is_compiling()
