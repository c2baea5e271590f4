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
// The search is K4's (searchsorted_sorted.cu, sorted_search.cuh) on
// positions the kernel makes itself, and a tile gather follows
// (tile_gather.cuh):
//
// - one block a (row, tile) pair, tiles on blockIdx.x and rows on
//   blockIdx.y and z (any number of rows),
//   kTile = 512 slots a block, 2 a thread
//   (thread t holds slots t and t + 256 of the tile, so index stores are
//   coalesced);
// - pos_j is nondecreasing in j (round-to-nearest add and divide are
//   monotone), so the tile's ends pos(j0) and pos(j1 - 1), computed like
//   every other position, bound all of its positions with no load; the
//   block narrows the CDF window between them with 256 loads a round until
//   it fits kWindowCap = 8,192 floats (no round at K <= 8,192, one at
//   K = 10,000), stages it in shared memory with cp.async, and every thread
//   searches its 2 positions there, interleaved; a window over the cap (a
//   tile under which thousands of weights are near zero) is searched in
//   global memory, within the window;
// - the block writes its output tile out[b, j0:j1, :], one contiguous run
//   of (j1 - j0) * D floats, with consecutive threads on consecutive
//   floats for every D. D = 0 (indices only) skips the gather.
//
// Why 512: at the main path's shape (B, K) = (10, 10,000) it makes 200
// blocks, all resident at once (34.8 KB of shared memory each), with
// windows of about 500 entries, so each block's staging and search are
// shorter than with 1,024 slots; measured side by side on an H100, 512
// was faster than 256 and 1,024 at that shape with D = 0 and 1 and on
// degenerate weights. 1,024 wins from K of about a million, where every
// block pays the narrowing rounds over the whole row.
//
// Bound on an H100: at (B, K, D) = (10, 10,000, 1) the kernel reads the
// CDF and the values and writes the output, 1.2 MB: 0.36 us at 3.35 TB/s.
// It is latency-bound: the launch, one narrowing round, the staging round
// trip, about 9 shared-memory search steps and one dependent gather load.
//
// Bit-exactness with the JAX package and the PyTorch version is the
// contract: the position is computed with round-to-nearest add and divide
// in the order of resampling_positions ((u + j) / K, then the clamp), the
// comparisons are those of torch.searchsorted(right=True), and this file
// must never be built with --use_fast_math.
//
// Offsets across rows are 64-bit, so that B * K * D may pass 2^31; indices
// within a row are 32-bit (K <= 2^24).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sorted_search.cuh"
#include "tile_gather.cuh"

namespace {

constexpr int kThreads = aesmc::kBlockThreads;
constexpr int kPerThread = 2;
constexpr int kTile = kThreads * kPerThread;

// pos_j; nextafter(1.0f, 0.0f) keeps positions strictly below the last CDF
// entry, which is pinned to exactly 1.0. j < 2^24 converts exactly.
__device__ __forceinline__ float position(float u, int j, float k) {
  return fminf(__fdiv_rn(__fadd_rn(u, static_cast<float>(j)), k),
               __int_as_float(0x3f7fffff));
}

__global__ void __launch_bounds__(kThreads)
    resample_systematic_kernel(const float* __restrict__ cdf,
                               const float* __restrict__ u,
                               const float* __restrict__ value,
                               float* __restrict__ out,
                               int32_t* __restrict__ idx, int n,
                               long long d, long long batch) {
  if (d == 0 && idx == nullptr) return;
  __shared__ __align__(16) float window[aesmc::kWindowCap + 4];
  __shared__ int tile[kTile];
  const long long b = aesmc::block_row();
  if (b >= batch) return;
  const int j0 = static_cast<int>(blockIdx.x) * kTile;
  const int j1 = min(j0 + kTile, n);
  const float ub = u[b];
  const float kf = static_cast<float>(n);
  const float* row = cdf + b * n;

  // Slots past the row's end search the tile's first position, inside the
  // window, and write nothing.
  float p[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int j = j0 + r * kThreads + static_cast<int>(threadIdx.x);
    p[r] = position(ub, j < j1 ? j : j0, kf);
  }
  const aesmc::Window w = aesmc::block_window(
      row, n, position(ub, j0, kf), position(ub, j1 - 1, kf), window);
  int src[kPerThread];
  aesmc::window_upper_bounds(w, row, n, p, src);

#pragma unroll
  for (int r = 0; r < kPerThread; ++r) src[r] = min(src[r], n - 1);
  if (idx != nullptr) {
    int32_t* to = idx + b * n;
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const int j = j0 + r * kThreads + static_cast<int>(threadIdx.x);
      if (j < j1) to[j] = src[r];
    }
  }
  aesmc::gather_tile(value + b * n * d, out + (b * n + j0) * d, d, j1 - j0,
                     src, tile);
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
  const dim3 grid = aesmc::row_grid(batch, (k + kTile - 1) / kTile);
  if (grid.z == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  resample_systematic_kernel<<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      cdf, u, value, out, idx, static_cast<int>(k), d,
      batch);
  return static_cast<int>(cudaGetLastError());
}
