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
// (searchsorted_sorted.cu), and this kernel is K4 with a tile gather at
// the end (tile_gather.cuh):
//
// - one block a (row, tile) pair, tiles on blockIdx.x and rows on
//   blockIdx.y and z (any number of rows),
//   kTile = 512 positions a block, 2 a thread
//   (thread t holds positions t and t + 256 of the tile, so loads and
//   index stores are coalesced);
// - the block loads the tile's first and last positions and narrows the
//   CDF window between them with 256 loads a round until it fits
//   kWindowCap = 8,192 floats (no round at K <= 8,192, one at K = 10,000),
//   stages it in shared memory with cp.async, and every thread searches
//   its 2 positions there, interleaved; a window over the cap (K >> Kp, or
//   a tile under which the CDF is flat) is searched in global memory,
//   within the window;
// - the block writes its output tile out[b, j0:j1, :], one contiguous run
//   of (j1 - j0) * D floats, with consecutive threads on consecutive
//   floats for every D.
//
// Why 512: as for K1 (resample_systematic.cu), at (B, K = Kp) = (10,
// 10,000) it makes 200 blocks, all resident at once, with windows of
// about 500 entries; measured on an H100 it was faster there than 256
// and 1,024.
//
// Bound on an H100: at (B, K = Kp, D) = (10, 10,000, 1) the kernel reads
// the CDF, the positions and the values and writes the output, 1.6 MB:
// 0.48 us at 3.35 TB/s. It is latency-bound: the launch, the load of the
// tile's ends, one narrowing round, the staging round trip, about 9
// shared-memory search steps and one dependent gather load.
//
// Exact: the comparisons are those of torch.searchsorted(right=True) (the
// build never uses fast math), so the indices equal it, clamped, bit for
// bit, and the values are copied. Positions that are not sorted stay
// exact too: one outside its tile's [first, last] range is searched over
// the whole row.
//
// Offsets across rows are 64-bit, so that B * K * D and B * Kp * D may
// pass 2^31; indices within a row are 32-bit (K, Kp <= 2^24).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sorted_search.cuh"
#include "tile_gather.cuh"

namespace {

constexpr int kThreads = aesmc::kBlockThreads;
constexpr int kPerThread = 2;
constexpr int kTile = kThreads * kPerThread;

__global__ void __launch_bounds__(kThreads)
    resample_sorted_kernel(const float* __restrict__ cdf,
                           const float* __restrict__ pos,
                           const float* __restrict__ value,
                           float* __restrict__ out,
                           int32_t* __restrict__ idx, int n, int kp,
                           long long d, long long batch) {
  if (d == 0 && idx == nullptr) return;
  __shared__ __align__(16) float window[aesmc::kWindowCap + 4];
  __shared__ int tile[kTile];
  const long long b = aesmc::block_row();
  if (b >= batch) return;
  const int j0 = static_cast<int>(blockIdx.x) * kTile;
  const int j1 = min(j0 + kTile, kp);
  const float* row = cdf + b * n;
  const float* prow = pos + b * kp;
  const float first = prow[j0];
  const float last = prow[j1 - 1];

  // Slots past the row's end search the tile's first position, inside the
  // window, and write nothing.
  float p[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int j = j0 + r * kThreads + static_cast<int>(threadIdx.x);
    p[r] = j < j1 ? prow[j] : first;
  }
  const aesmc::Window w = aesmc::block_window(
      row, n, fminf(first, last), fmaxf(first, last), window);
  int src[kPerThread];
  aesmc::window_upper_bounds(w, row, n, p, src);

#pragma unroll
  for (int r = 0; r < kPerThread; ++r) src[r] = min(src[r], n - 1);
  if (idx != nullptr) {
    int32_t* to = idx + b * kp;
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const int j = j0 + r * kThreads + static_cast<int>(threadIdx.x);
      if (j < j1) to[j] = src[r];
    }
  }
  aesmc::gather_tile(value + b * n * d, out + (b * kp + j0) * d, d,
                     j1 - j0, src, tile);
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
  if (batch == 0 || k == 0 || kp == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid = aesmc::row_grid(batch, (kp + kTile - 1) / kTile);
  if (grid.z == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  resample_sorted_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      cdf, pos, value, out, idx, static_cast<int>(k), static_cast<int>(kp),
      d, batch);
  return static_cast<int>(cudaGetLastError());
}
