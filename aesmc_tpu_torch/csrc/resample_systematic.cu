// Fused systematic resample + gather (kernel K1), for sm_90a.
//
// Replaces aesmc_tpu/ops/resample_pallas.py::_window_kernel_impl in
// systematic mode (launched by _window_call through
// systematic_search_gather_pallas). For each batch row b and slot j < K:
//
//   pos_j   = min((u_b + j) / K, nextafter(1, 0))
//   idx_j   = min(#{i : cdf_i <= pos_j}, K - 1)
//   out_j,: = value[b, idx_j, :]
//
// One thread per output slot; grid (ceil(K / 256), B). Each thread runs an
// upper-bound binary search over its row of the CDF in global memory
// (the row stays in L2: 40 KB at K = 10,000) and copies one D-row.
//
// Bit-exactness with the JAX package and the PyTorch version is the
// contract: the position is computed with round-to-nearest add and divide
// in the order of resampling_positions ((u + j) / K, then the clamp), and
// this file must never be built with --use_fast_math.
//
// Offsets are 64-bit so that K up to 8,388,608 (and B * K * D beyond
// 2^31) index correctly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void resample_systematic_kernel(const float* __restrict__ cdf,
                                           const float* __restrict__ u,
                                           const float* __restrict__ value,
                                           float* __restrict__ out,
                                           int32_t* __restrict__ idx,
                                           long long k, long long d) {
  const long long j =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= k) return;
  const long long b = blockIdx.y;
  // nextafter(1.0f, 0.0f): positions stay strictly below the last CDF
  // entry, which is pinned to exactly 1.0.
  const float below_one = __int_as_float(0x3f7fffff);
  const float pos = fminf(
      __fdiv_rn(__fadd_rn(u[b], static_cast<float>(j)),
                static_cast<float>(k)),
      below_one);

  // Upper bound: the first i with cdf[i] > pos, i.e. #{i : cdf[i] <= pos}.
  const float* row = cdf + b * k;
  long long lo = 0;
  long long hi = k;
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (row[mid] <= pos) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const long long src = lo < k - 1 ? lo : k - 1;

  if (idx != nullptr) idx[b * k + j] = static_cast<int32_t>(src);
  if (d > 0) {
    const float* from = value + (b * k + src) * d;
    float* to = out + (b * k + j) * d;
    for (long long c = 0; c < d; ++c) to[c] = from[c];
  }
}

}  // namespace

// Launches on `stream` of card `device`; returns the CUDA error of the
// launch (0 on success). `idx` may be null, and then no index is written
// (emit_idx off). With D = 0 (indices only) `value` and `out` are not
// touched and may be null.
extern "C" int aesmc_resample_systematic(const float* cdf, const float* u,
                                         const float* value, float* out,
                                         int32_t* idx, long long batch,
                                         long long k, long long d,
                                         int device, void* stream) {
  if (batch == 0 || k == 0) return static_cast<int>(cudaSuccess);
  // This library carries its own CUDA runtime: select the tensors' card
  // in it before launching on that card's stream.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(static_cast<unsigned int>((k + kThreads - 1) / kThreads),
                  static_cast<unsigned int>(batch));
  resample_systematic_kernel<<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      cdf, u, value, out, idx, k, d);
  return static_cast<int>(cudaGetLastError());
}
