"""Hand-written CUDA kernels for the hot inner ops, each with its plain
PyTorch version beside it. Kernels are built at first use (`_build`)."""

from . import resample_cuda

__all__ = ["resample_cuda"]
