// Index-only search of sorted positions in a CDF (kernel K4), for sm_90a.
//
// Replaces aesmc_tpu/ops/resample_pallas.py::_make_resample_kernel with
// cdf_input=True, as launched by searchsorted_sorted_cdf_pallas: for each
// batch row b and slot j < Kp (Kp may differ from Kc),
//
//   idx_j = min(#{i : cdf_i <= pos_j}, Kc - 1)
//
// over a nondecreasing CDF and sorted positions. The TPU kernel walks two
// cursors through both sorted sequences; here the sortedness shrinks each
// block's search to a window of the CDF (sorted_search.cuh):
//
// - one block a (row, tile) pair, tiles on blockIdx.x and rows on
//   blockIdx.y and z (any number of rows),
//   kTile = 1024 positions a block, 4 a thread
//   (thread t holds positions t, t + 256, t + 512 and t + 768 of the tile,
//   so loads and stores are coalesced);
// - the block narrows the window of the tile's first and last positions
//   with 256 loads a round until it fits kWindowCap = 8,192 floats: no
//   round at Kc <= 8,192, one at Kc = 10,000;
// - the block stages the window in shared memory with cp.async, and every
//   thread searches its 4 positions there, interleaved; a window over the
//   cap (Kc >> Kp, or a tile under which the CDF is flat) is searched in
//   global memory instead, within the window.
//
// Why 1024: at the main path's shape (B, Kc = Kp) = (10, 10,000) it makes
// 100 blocks, one wave on 132 SMs, and a window of about 1,000 entries
// (4 KB; 4,600 at most on N(0, 3^2) log-weights), so the 32 KB cap holds
// windows 8 times the mean. A smaller tile adds blocks that each pay the
// same chain of loads.
//
// Bound on an H100: at (10, 10,000) the kernel reads the CDF and positions
// and writes the indices, 1.2 MB, 0.36 us of HBM bandwidth. It is
// latency-bound: the launch, one load of the tile's ends, one round of
// the window search, one round of staging, then ~10 shared-memory steps.
//
// Exact: the comparisons are those of torch.searchsorted(right=True), so
// the indices equal it, clamped, bit for bit. Positions that are not
// sorted stay exact too: one outside its tile's [first, last] range is
// searched over the whole row.
//
// Offsets across rows are 64-bit, so that B * Kc and B * Kp may pass 2^31;
// indices within a row are 32-bit (Kc, Kp <= 2^24).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sorted_search.cuh"

namespace {

constexpr int kThreads = aesmc::kBlockThreads;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;

__global__ void __launch_bounds__(kThreads)
    searchsorted_sorted_kernel(const float* __restrict__ cdf,
                               const float* __restrict__ pos,
                               int32_t* __restrict__ idx, long long kc,
                               long long kp, long long batch) {
  __shared__ __align__(16) float window[aesmc::kWindowCap + 4];
  const long long b = aesmc::block_row();
  if (b >= batch) return;
  const long long j0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long j1 = j0 + kTile < kp ? j0 + kTile : kp;
  const float* row = cdf + b * kc;
  const float* prow = pos + b * kp;
  const float first = prow[j0];
  const float last = prow[j1 - 1];

  // Slots past the row's end search the tile's first position, inside the
  // window, and write nothing.
  float p[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const long long j = j0 + r * kThreads + threadIdx.x;
    p[r] = j < j1 ? prow[j] : first;
  }
  const int n = static_cast<int>(kc);
  const aesmc::Window w = aesmc::block_window(
      row, n, fminf(first, last), fmaxf(first, last), window);
  int u[kPerThread];
  aesmc::window_upper_bounds(w, row, n, p, u);

  int32_t* out = idx + b * kp;
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const long long j = j0 + r * kThreads + threadIdx.x;
    if (j < j1) out[j] = u[r] < n - 1 ? u[r] : n - 1;
  }
}

}  // namespace

// Launches on `stream` of card `device`; returns the CUDA error of the
// launch (0 on success). cdf [B, Kc] and pos [B, Kp] float32, idx [B, Kp]
// int32, all contiguous.
extern "C" int aesmc_searchsorted_sorted(const float* cdf, const float* pos,
                                         int32_t* idx, long long batch,
                                         long long kc, long long kp,
                                         int device, void* stream) {
  if (batch == 0 || kc == 0 || kp == 0) return static_cast<int>(cudaSuccess);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid = aesmc::row_grid(batch, (kp + kTile - 1) / kTile);
  if (grid.z == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  searchsorted_sorted_kernel<<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      cdf, pos, idx, kc, kp, batch);
  return static_cast<int>(cudaGetLastError());
}
