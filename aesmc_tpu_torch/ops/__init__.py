"""Hand-written CUDA kernels for the hot inner ops, each with its plain
PyTorch version beside it. Kernels are built at first use (`_build`).

- `resample_cuda`: K1, fused systematic resample + gather;
- `resample_sorted_cuda`: K3, search + gather over loaded sorted
  positions (stratified, multinomial);
- `searchsorted_sorted_cuda`: K4, the index-only search of loaded sorted
  positions;
- `range_sum_cuda`: K2, the deterministic range sum, backward of K1 and
  K3;
- `gather_sorted_cuda`: K5, the gather by sorted indices, any dtype;
- `searchsorted_cdf_cuda`: K6, CDF, search and gather from log-weights;
- `normalized_cdf_cuda`: the engine's normalized CDF from log-weights, in
  one launch (the card's side of `resampling._normalized_cumsum`).
"""

from . import gather_sorted_cuda
from . import normalized_cdf_cuda
from . import range_sum_cuda
from . import resample_cuda
from . import resample_sorted_cuda
from . import searchsorted_cdf_cuda
from . import searchsorted_sorted_cuda

__all__ = ["gather_sorted_cuda", "normalized_cdf_cuda", "range_sum_cuda",
           "resample_cuda", "resample_sorted_cuda", "searchsorted_cdf_cuda",
           "searchsorted_sorted_cuda"]
