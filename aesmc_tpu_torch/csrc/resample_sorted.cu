// Search + gather over loaded sorted positions (kernel K3), for sm_90a.
//
// Replaces aesmc_tpu/ops/resample_pallas.py::_window_kernel_impl in
// sorted-positions mode (sorted_search_gather_pallas, reached through
// resample_and_gather and resample_and_gather_cdf): the search and gather
// of K1 (resample_systematic.cu), with the positions read from global
// memory instead of generated. Stratified and multinomial resampling run
// it. For each batch row b and slot j < Kp (Kp may differ from K):
//
//   idx_j   = min(#{i : cdf_i <= pos_j}, K - 1)
//   out_j,: = value[b, idx_j, :]
//
// Its wrapper launches it with D >= 1 only: the index-only search is K4's
// (searchsorted_sorted.cu).
//
// One thread per output slot; grid (ceil(Kp / 256), B). Each thread runs an
// upper-bound binary search over its row of the CDF in global memory and
// copies one D-row. The comparison is exact, so the indices equal
// torch.searchsorted(right=True) bit for bit.
//
// Bound on an H100: at (B, K = Kp, D) = (10, 10,000, 1) the kernel moves
// about 1.6 MB (CDF, positions, values, output), under a microsecond of
// HBM bandwidth; as for K1, latency bounds it: the launch and the ~14
// dependent L2 loads of each search.
//
// Offsets are 64-bit so that K and Kp up to 2^24 (and B * Kp * D beyond
// 2^31) index correctly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void resample_sorted_kernel(const float* __restrict__ cdf,
                                       const float* __restrict__ pos,
                                       const float* __restrict__ value,
                                       float* __restrict__ out,
                                       int32_t* __restrict__ idx, long long k,
                                       long long kp, long long d) {
  const long long j =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= kp) return;
  const long long b = blockIdx.y;
  const float p = pos[b * kp + j];

  // Upper bound: the first i with cdf[i] > p, i.e. #{i : cdf[i] <= p}.
  const float* row = cdf + b * k;
  long long lo = 0;
  long long hi = k;
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (row[mid] <= p) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const long long src = lo < k - 1 ? lo : k - 1;

  if (idx != nullptr) idx[b * kp + j] = static_cast<int32_t>(src);
  if (d > 0) {
    const float* from = value + (b * k + src) * d;
    float* to = out + (b * kp + j) * d;
    for (long long c = 0; c < d; ++c) to[c] = from[c];
  }
}

}  // namespace

// Launches on `stream` of card `device`; returns the CUDA error of the
// launch (0 on success). cdf [B, K], pos [B, Kp], value [B, K, D],
// out [B, Kp, D], neither touched when D = 0 (they may be null then);
// `idx` [B, Kp] may be null, and then no index is written.
extern "C" int aesmc_resample_sorted(const float* cdf, const float* pos,
                                     const float* value, float* out,
                                     int32_t* idx, long long batch,
                                     long long k, long long kp, long long d,
                                     int device, void* stream) {
  if (batch == 0 || kp == 0) return static_cast<int>(cudaSuccess);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(static_cast<unsigned int>((kp + kThreads - 1) / kThreads),
                  static_cast<unsigned int>(batch));
  resample_sorted_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      cdf, pos, value, out, idx, k, kp, d);
  return static_cast<int>(cudaGetLastError());
}
