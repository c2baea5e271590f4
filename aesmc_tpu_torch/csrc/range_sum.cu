// Deterministic range sum (kernel K2): the backward of the fused
// resample+gather kernels (K1 and K3), for sm_90a.
//
// Replaces aesmc_tpu/ops/resample_pallas.py::_window_kernel_impl in
// range-sum mode (range_sum_pallas, reached through gather_backward_pallas
// from the VJPs _rgs_bwd, _rg_bwd and _rgc_bwd). The forward sent slot j
// (sorted position pos_j) to source idx_j = min(#{i : cdf_i <= pos_j},
// K - 1), so source i owns the slots with pos_j in [cdf_{i-1}, cdf_i),
// the first source from 0 and the last source to the end of the row:
//
//   grad[b, i, c] = sum over j in [lo_i, hi_i) of g[b, j, c]
//   lo_i = first j with pos_j >= cdf_{i-1}   (0 for i = 0)
//   hi_i = first j with pos_j >= cdf_i       (Kp for i = K - 1)
//
// One thread per source; grid (ceil(K / 256), B). Each thread runs two
// lower-bound binary searches over its row of positions in global memory
// and sums its range in increasing j. No float atomics: every run gives
// the same bits, the contract the JAX package keeps. A row whose mass
// sits on one source makes that thread sum all Kp slots alone; a
// segmented reduction over slot tiles is later work.
//
// Bound on an H100: at (B, K = Kp, D) = (10, 10,000, 1) the kernel moves
// about 1.6 MB (CDF, positions, cotangents, gradient: 400 KB each), well
// under a microsecond of HBM bandwidth; what bounds it is the launch and
// the ~14 dependent L2 loads of each binary search.
//
// Offsets are 64-bit so that K and Kp up to 2^24 (and B * K * D beyond
// 2^31) index correctly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// The first j in [0, n) with row[j] >= x, or n.
__device__ long long first_at_least(const float* row, long long n, float x) {
  long long lo = 0;
  long long hi = n;
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (row[mid] < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void range_sum_kernel(const float* __restrict__ cdf,
                                 const float* __restrict__ pos,
                                 const float* __restrict__ g,
                                 float* __restrict__ out, long long k,
                                 long long kp, long long d) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= k) return;
  const long long b = blockIdx.y;
  const float* cdf_row = cdf + b * k;
  const float* pos_row = pos + b * kp;
  const long long lo =
      i == 0 ? 0 : first_at_least(pos_row, kp, cdf_row[i - 1]);
  long long hi = i == k - 1 ? kp : first_at_least(pos_row, kp, cdf_row[i]);
  if (hi < lo) hi = lo;

  const float* from = g + b * kp * d;
  float* to = out + (b * k + i) * d;
  for (long long c = 0; c < d; ++c) {
    float acc = 0.0f;
    for (long long j = lo; j < hi; ++j) acc += from[j * d + c];
    to[c] = acc;
  }
}

}  // namespace

// Launches on `stream` of card `device`; returns the CUDA error of the
// launch (0 on success). cdf [B, K], pos [B, Kp], g [B, Kp, D] and
// out [B, K, D], all float32 and contiguous.
extern "C" int aesmc_range_sum(const float* cdf, const float* pos,
                               const float* g, float* out, long long batch,
                               long long k, long long kp, long long d,
                               int device, void* stream) {
  if (batch == 0 || k == 0 || d == 0) return static_cast<int>(cudaSuccess);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(static_cast<unsigned int>((k + kThreads - 1) / kThreads),
                  static_cast<unsigned int>(batch));
  range_sum_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cdf, pos, g, out, k, kp, d);
  return static_cast<int>(cudaGetLastError());
}
