// Deterministic range sum (kernel K2): the backward of the fused
// resample+gather kernels (K1 and K3), for sm_90a.
//
// Replaces aesmc_tpu/ops/resample_pallas.py::_window_kernel_impl in
// range-sum mode (range_sum_pallas, reached through gather_backward_pallas
// from the VJPs _rgs_bwd, _rg_bwd and _rgc_bwd). The forward sent slot j
// (sorted position pos_j) to source src_j = min(#{i : cdf_i <= pos_j},
// K - 1), so source i owns the slots with pos_j in [cdf_{i-1}, cdf_i), the
// first source from 0 and the last source to the end of the row:
//
//   grad[b, i, c] = sum over the j with src_j = i of g[b, j, c]
//
// Positions are sorted, so src is nondecreasing along the row and each
// source's slots are one run (a segment). A segmented sum over slot tiles:
//
// - one block a (row, tile) pair, tiles on blockIdx.x and rows on
//   blockIdx.y and z (any number of rows),
//   kTile = 1024 slots a block, 4 consecutive slots a thread;
// - the block finds the source of each slot of its tile, and of the slots
//   just before and after it, through a window of the CDF staged in shared
//   memory (sorted_search.cuh, shared with K4);
// - each source is written by exactly one block: the one that holds its
//   first slot. A block writes the sources (src(first slot - 1),
//   src(last slot)], from source 0 in the row's first block and to K - 1 in
//   its last. Sources of that range with no slot get 0: the block zeroes
//   the whole range, and after a barrier writes the sums over them;
// - per column, a segmented scan in a fixed order: each thread adds its 4
//   slots in order, warps combine the threads' (segment start, sum) pairs
//   with shuffles in a fixed tree, and warps combine through shared
//   memory in order. Each segment's sum is written at its last slot;
// - a segment that starts in the tile and runs past its end is finished by
//   the same block: it finds where the segment ends (a block-wide
//   lower-bound search of cdf at the source over the following positions,
//   256 loads a round) and adds those slots with coalesced loads, each
//   thread in order, then a fixed shuffle tree and the warps in order. A
//   block whose tile lies inside an earlier block's segment writes
//   nothing.
//
// One launch, no atomics, no scratch: every run gives the same bits, the
// contract the JAX package keeps. Integer cotangents whose partial sums
// stay below 2^24 are summed exactly. Work is O(Kp * D) coalesced loads
// and O(K * D) stores whatever the weights, except that one block adds a
// segment that spans later tiles alone (a row whose mass sits on one
// particle: Kp - 1024 slots). Columns are handled one at a time, so shared
// memory (36 KB) does not grow with D.
//
// Bound on an H100: at (B, K = Kp, D) = (10, 10,000, 1) the kernel moves
// 1.6 MB (CDF, positions, cotangents, gradient: 400 KB each), 0.48 us of
// HBM bandwidth; the chain of dependent steps (window search, staging,
// search, scan, barriers) and the launch bound it.
//
// Offsets are 64-bit so that B * K * D and B * Kp * D may pass 2^31;
// indices within a row are 32-bit (K, Kp <= 2^24).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sorted_search.cuh"

namespace {

constexpr int kThreads = aesmc::kBlockThreads;
constexpr int kPerThread = 4;
constexpr int kTile = kThreads * kPerThread;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;

// A run of slots in a segmented sum: whether a segment starts in it, and
// the sum of its slots from the last such start (or from its first slot).
struct Run {
  bool starts;
  float sum;
};

// The run `a` followed by the run `b`.
__device__ __forceinline__ Run join(Run a, Run b) {
  return Run{a.starts || b.starts, b.starts ? b.sum : a.sum + b.sum};
}

__global__ void __launch_bounds__(kThreads)
    range_sum_kernel(const float* __restrict__ cdf,
                     const float* __restrict__ pos,
                     const float* __restrict__ g, float* __restrict__ out,
                     long long k, long long kp, long long d,
                     long long batch) {
  __shared__ __align__(16) float window[aesmc::kWindowCap + 4];
  __shared__ int src[kTile];
  __shared__ float warp_sum[kWarps];
  __shared__ int warp_starts[kWarps];
  __shared__ float tile_part;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long b = aesmc::block_row();
  if (b >= batch) return;
  const long long j0 = static_cast<long long>(blockIdx.x) * kTile;
  const long long j1 = j0 + kTile < kp ? j0 + kTile : kp;
  const int n = static_cast<int>(j1 - j0);
  const float* row = cdf + b * k;
  const float* prow = pos + b * kp;
  const float* grow = g + b * kp * d;
  float* orow = out + b * k * d;

  // The window's keys are the positions just before and just after the
  // tile (clipped to the row), searched beside the tile's own: their
  // sources are those of the neighbouring tiles' edge slots. Slots past
  // the row's end search the first key and write nothing.
  const float key_lo = prow[j0 > 0 ? j0 - 1 : 0];
  const float key_hi = prow[j1 < kp ? j1 : kp - 1];
  float p[kPerThread + 2];
  float v[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const int i = kPerThread * t + r;
    p[r] = i < n ? prow[j0 + i] : key_lo;
    v[r] = i < n ? grow[(j0 + i) * d] : 0.0f;  // column 0, ahead of time
  }
  p[kPerThread] = key_lo;
  p[kPerThread + 1] = key_hi;
  const int sources = static_cast<int>(k);
  const aesmc::Window w =
      aesmc::block_window(row, sources, key_lo, key_hi, window);
  int u[kPerThread + 2];
  aesmc::window_upper_bounds(w, row, sources, p, u);
  // This thread's slots are i0 + r; their sources, clamped to K - 1.
  const int i0 = kPerThread * t;
  int own[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    own[r] = u[r] < sources - 1 ? u[r] : sources - 1;
    if (i0 + r < n) src[i0 + r] = own[r];
  }
  // The source of the slot before the tile (-1: none) and after it (K:
  // none).
  const int before =
      j0 > 0 ? (u[kPerThread] < sources - 1 ? u[kPerThread] : sources - 1)
             : -1;
  const int after =
      j1 < kp
          ? (u[kPerThread + 1] < sources - 1 ? u[kPerThread + 1] : sources - 1)
          : sources;
  __syncthreads();
  // The sources of the slots beside this thread's.
  const int left = i0 == 0 ? before : src[i0 - 1];
  const int right = i0 + kPerThread < n ? src[i0 + kPerThread] : after;

  const int last = src[n - 1];
  const int first_owned = before + 1;
  const int last_owned = j1 < kp ? last : sources - 1;
  // The tile's last segment starts in it and runs past its end, to the
  // first slot at or above cdf[last] (the row's end for the last source).
  const bool continues = last >= first_owned && after == last;
  long long end = kp;
  if (continues && last < sources - 1) {
    end = aesmc::block_count<true>(prow, static_cast<int>(j1),
                                   static_cast<int>(kp), row[last]);
  }
  if (first_owned <= last_owned) {
    float* zero = orow + first_owned * d;
    const long long count = (last_owned - first_owned + 1) * d;
    for (long long e = t; e < count; e += kThreads) zero[e] = 0.0f;
  }
  // The zeros land before any sum over them.
  __syncthreads();

  for (long long c = 0; c < d; ++c) {
    if (c > 0) {
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) {
        const int i = i0 + r;
        v[r] = i < n ? grow[(j0 + i) * d + c] : 0.0f;
      }
    }
    Run mine{false, 0.0f};
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      if (i0 + r < n) {
        const int prev = r == 0 ? left : own[r - 1];
        mine = join(mine, Run{prev != own[r], v[r]});
      }
    }
    // Inclusive scan of the threads' runs within the warp.
    Run scan = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float sum = __shfl_up_sync(kFullMask, scan.sum, o);
      const int starts = __shfl_up_sync(kFullMask,
                                        static_cast<int>(scan.starts), o);
      if (lane >= o) scan = join(Run{starts != 0, sum}, scan);
    }
    const float lane_sum = __shfl_up_sync(kFullMask, scan.sum, 1);
    const int lane_starts = __shfl_up_sync(kFullMask,
                                           static_cast<int>(scan.starts), 1);
    if (lane == 31) {
      warp_sum[warp] = scan.sum;
      warp_starts[warp] = scan.starts;
    }
    __syncthreads();
    // What the open segment has summed before this thread's first slot.
    Run carry{false, 0.0f};
    for (int x = 0; x < warp; ++x) {
      carry = join(carry, Run{warp_starts[x] != 0, warp_sum[x]});
    }
    if (lane > 0) carry = join(carry, Run{lane_starts != 0, lane_sum});

    float acc = carry.sum;
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const int i = i0 + r;
      if (i < n) {
        const int s = own[r];
        const int prev = r == 0 ? left : own[r - 1];
        const int next =
            i == n - 1 ? after : (r == kPerThread - 1 ? right : own[r + 1]);
        acc = prev != s ? v[r] : acc + v[r];
        if (next != s && s >= first_owned) orow[s * d + c] = acc;
        if (i == n - 1 && continues) tile_part = acc;
      }
    }
    if (continues) {
      __syncthreads();
      float part = 0.0f;
#pragma unroll 8
      for (long long j = j1 + t; j < end; j += kThreads) {
        part += grow[j * d + c];
      }
      // A butterfly: every lane ends with the same bits.
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        part += __shfl_xor_sync(kFullMask, part, o);
      }
      if (lane == 0) warp_sum[warp] = part;
      __syncthreads();
      if (t == 0) {
        float total = tile_part;
        for (int x = 0; x < kWarps; ++x) total += warp_sum[x];
        orow[last * d + c] = total;
      }
    }
    // warp_sum, warp_starts and tile_part serve the next column.
    __syncthreads();
  }
}

}  // namespace

// Launches on `stream` of card `device`; returns the CUDA error of the
// launch (0 on success). cdf [B, K], pos [B, Kp] (sorted along each row),
// g [B, Kp, D] and out [B, K, D], all float32 and contiguous.
extern "C" int aesmc_range_sum(const float* cdf, const float* pos,
                               const float* g, float* out, long long batch,
                               long long k, long long kp, long long d,
                               int device, void* stream) {
  if (batch == 0 || k == 0 || kp == 0 || d == 0) {
    return static_cast<int>(cudaSuccess);
  }
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid = aesmc::row_grid(batch, (kp + kTile - 1) / kTile);
  if (grid.z == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  range_sum_kernel<<<grid, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      cdf, pos, g, out, k, kp, d, batch);
  return static_cast<int>(cudaGetLastError());
}
