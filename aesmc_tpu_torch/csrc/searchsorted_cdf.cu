// Fused CDF + search + gather from log-weights (kernel K6), for sm_90a.
//
// Replaces aesmc_tpu/ops/resample_pallas.py::_make_resample_kernel with
// cdf_input=False (the in-kernel exp, _lane_prefix and _row_prefix), as
// launched by searchsorted_cdf_pallas. For each batch row b:
//
//   w_i     = exp(logw_i - max_i logw_i)
//   cum_i   = max_{i' <= i} (w_0 + ... + w_i')      (a running max of the
//             prefix sums: a parallel float32 scan is not monotone)
//   cdf_i   = cum_i / cum_{K-1}
//   idx_j   = min(#{i : cdf_i <= pos_j}, K - 1)     for each j < Kp
//   out_j,: = value[b, idx_j, :]                    (D float32 columns)
//
// One block of 1024 threads per batch row:
//   1. a block reduction for the row's maximum;
//   2. tiles of 4096 entries: each thread sums its 4 entries in order, a
//      block-wide scan (warp shuffles, then one warp over the 32 warp
//      totals) adds the earlier threads' totals and the carried total of
//      the earlier tiles; a block-wide max-scan of the same shape, with a
//      carried maximum, makes the prefix sums monotone; the tile goes to
//      the [B, K] scratch row;
//   3. every entry divided by the row's last (= largest) entry, so the
//      last is exactly 1.0;
//   4. one upper-bound binary search a position over the scratch row
//      (L2-resident: 40 KB at K = 10,000), then the gather.
// The summation order differs from torch.cumsum's, so an index may differ
// from the plain version's where a position lies within rounding of a
// bin edge; never at a degenerate row (all mass on one particle).
//
// Bound on an H100: at (B, K = Kp, D) = (10, 10,000, 1) the kernel moves
// 1.6 MB plus its scratch row, under a microsecond of HBM bandwidth. What
// bounds it is that one block per row runs on B of the 132 SMs, and the
// scan's ten block barriers a tile and the searches' dependent L2 loads
// run in series there. A scan split over several blocks a row is later
// work.
//
// Offsets are 64-bit. Round-to-nearest division (__fdiv_rn), never fast
// math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 4;
constexpr long long kTile = static_cast<long long>(kThreads) * kItems;
constexpr unsigned int kFull = 0xffffffffu;

struct Sum {
  __device__ float operator()(float a, float b) const { return a + b; }
};
struct Max {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// Exclusive block-wide scan of one value a thread, in thread order, with
// `op`'s identity `zero`. `shared` holds kWarps floats. Returns the
// thread's exclusive prefix; `*total` gets the block's total.
template <typename Op>
__device__ float block_exclusive_scan(float x, float zero, float* shared,
                                      float* total, Op op) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl = op(n, incl);
  }
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = zero;
  if (lane == 31) shared[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    float v = shared[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(kFull, v, o);
      if (lane >= o) v = op(n, v);
    }
    shared[lane] = v;
  }
  __syncthreads();
  *total = shared[kWarps - 1];
  const float before = warp > 0 ? shared[warp - 1] : zero;
  __syncthreads();  // `shared` is reused by the next scan
  return warp > 0 ? op(before, excl) : excl;
}

__global__ void searchsorted_cdf_kernel(const float* __restrict__ logw,
                                        const float* __restrict__ pos,
                                        const float* __restrict__ value,
                                        float* __restrict__ out,
                                        int32_t* __restrict__ idx,
                                        float* __restrict__ scratch,
                                        long long k, long long kp,
                                        long long d) {
  __shared__ float shared[kWarps];
  const long long b = blockIdx.x;
  const float* row = logw + b * k;
  float* cum = scratch + b * k;

  // 1. The row's maximum.
  float m = -INFINITY;
  for (long long i = threadIdx.x; i < k; i += kThreads) m = fmaxf(m, row[i]);
  float row_max;
  block_exclusive_scan(m, -INFINITY, shared, &row_max, Max());

  // 2. Monotone prefix sums, tile by tile.
  float carry_sum = 0.0f;
  float carry_max = 0.0f;
  for (long long t0 = 0; t0 < k; t0 += kTile) {
    const long long first = t0 + static_cast<long long>(threadIdx.x) * kItems;
    float s[kItems];
    float acc = 0.0f;
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const long long i = first + q;
      const float w = i < k ? expf(row[i] - row_max) : 0.0f;
      acc = acc + w;
      s[q] = acc;
    }
    float tile_sum;
    const float before = block_exclusive_scan(acc, 0.0f, shared, &tile_sum,
                                              Sum());
    // Only entries of the row enter the maximum: the last one's value is
    // the total the row is divided by.
    float run = -INFINITY;
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      if (first + q < k) {
        s[q] = fmaxf(run, carry_sum + (before + s[q]));
        run = s[q];
      }
    }
    float tile_max;
    const float max_before = block_exclusive_scan(run, -INFINITY, shared,
                                                  &tile_max, Max());
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const long long i = first + q;
      if (i < k) cum[i] = fmaxf(carry_max, fmaxf(max_before, s[q]));
    }
    carry_sum = carry_sum + tile_sum;
    carry_max = fmaxf(carry_max, tile_max);
  }
  __syncthreads();

  // 3. Normalize by the last entry, the row's largest.
  const float total = carry_max;
  for (long long i = threadIdx.x; i < k; i += kThreads) {
    cum[i] = __fdiv_rn(cum[i], total);
  }
  __syncthreads();

  // 4. Upper-bound search and gather, one position a thread at a time.
  for (long long j = threadIdx.x; j < kp; j += kThreads) {
    const float p = pos[b * kp + j];
    long long lo = 0;
    long long hi = k;
    while (lo < hi) {
      const long long mid = lo + ((hi - lo) >> 1);
      if (cum[mid] <= p) {
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
}

}  // namespace

// Launches on `stream` of card `device`; returns the CUDA error of the
// launch (0 on success). logw [B, K], pos [B, Kp], scratch [B, K];
// value [B, K, D] and out [B, Kp, D] are not touched when D = 0 (they may
// be null then); `idx` [B, Kp] may be null, and then no index is written.
extern "C" int aesmc_searchsorted_cdf(const float* logw, const float* pos,
                                      const float* value, float* out,
                                      int32_t* idx, float* scratch,
                                      long long batch, long long k,
                                      long long kp, long long d, int device,
                                      void* stream) {
  if (batch == 0 || k == 0 || kp == 0) return static_cast<int>(cudaSuccess);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  searchsorted_cdf_kernel<<<static_cast<unsigned int>(batch), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      logw, pos, value, out, idx, scratch, k, kp, d);
  return static_cast<int>(cudaGetLastError());
}
