"""Hand-written CUDA kernels for the hot inner ops, each with its plain
PyTorch version beside it. Kernels are built at first use (`_build`).

- `resample_cuda`: K1, fused systematic resample + gather;
- `resample_sorted_cuda`: K3, search + gather over loaded sorted
  positions (stratified, multinomial);
- `range_sum_cuda`: K2, the deterministic range sum, backward of both.
"""

from . import range_sum_cuda
from . import resample_cuda
from . import resample_sorted_cuda

__all__ = ["range_sum_cuda", "resample_cuda", "resample_sorted_cuda"]
