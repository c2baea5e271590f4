// The normalized CDF of log-weights in one launch, for sm_90a: the CDF that
// the engine's resampling step searches (resampling._normalized_cumsum's
// contract, summed in this kernel's order). It replaces no TPU kernel: the
// JAX engine builds this CDF with XLA ops, and on the card the same ops
// made about 15 small PyTorch launches a resampling step. For each batch
// row b of [B, K] float32 log-weights:
//
//   m     = max_i logw_i
//   w_i   = expf(logw_i - m)                  (0 for a -inf log-weight)
//   c_i   = w_0 + ... + w_i                   (float32, one fixed order)
//   r_i   = max(c_0, ..., c_i)                (the running max: monotone)
//   cdf_i = r_i / r_{K-1}, and cdf_{K-1} = 1  (round-to-nearest divide)
//
// The normalizing constant cancels in the division, so no logsumexp is
// taken. A row whose maximum is not finite (a NaN, a +inf, or no finite
// entry) comes out NaN with its last entry 1, as the plain version gives
// it. K = 1 gives 1.
//
// The order of the sum. Thread t holds kItems consecutive entries of a
// tile and sums them in order; the exclusive prefix of the threads' totals
// is a warp scan by shuffles, then a scan of the warps' totals by
// shuffles, the same tree on every launch (block_scan,
// sorted_search.cuh); the tiles' totals of a chunk are folded in order,
// the chunks' in rank order. No atomics and no order
// that depends on scheduling, so a launch gives the same bits every time,
// for any B (PyTorch's single-pass scan of one row on the card does not:
// resampling._row_cumsum). A thread's partial sums s_q grow with q, and
// p + s_q (p the thread's prefix) grows with s_q: round-to-nearest
// addition is monotone. So a thread's largest entry is its last, the
// running max is each entry's max with the exclusive max-scan of the
// threads' last entries, and the row's last running max r_{K-1} is the
// largest of those, known before any entry is written.
//
// A row goes to a thread block cluster of `size` blocks on neighbouring
// SMs, which read each other's shared memory (as K6, searchsorted_cdf.cu,
// does): one block up to kBlockEntries entries, then one block a
// kBlockEntries, up to kMaxCluster = 8 (the portable maximum). Block r owns
// chunk r of the row, in tiles of kItems entries a thread:
//
//   (i)   each block reduces its chunk to a maximum and publishes it; after
//         cluster barrier 1 every block reads the partials, so all agree on
//         the row's maximum;
//   (ii)  each block sums its chunk tile by tile and finds the largest of
//         its prefix sums, from the chunk's start, and publishes both;
//         after barrier 2 each block folds the earlier chunks' sums into
//         its carry, and finds the running max before its chunk and the
//         row's last;
//   (iii) each block writes its chunk: a chunk of one tile keeps its sums
//         in registers from (ii), a longer one sums its tiles again, in the
//         same order, from the log-weights.
//
// A third barrier, arrived at once the partials are read and waited on
// before the block exits, keeps every block's shared memory alive while
// the others read it. Loads and stores are coalesced: each warp moves its
// 32 kItems consecutive entries between the threads' registers and device
// memory through shared memory (a row of entries a thread, padded by one
// float every 32, so neither side has bank conflicts).
//
// Bound on an H100: at (B, K) = (10, 10,000) the kernel reads 400 KB and
// writes 400 KB, 0.24 us of HBM bandwidth. Latency bounds it: the launch,
// the load, the block and cluster barriers, the exp and divide of kItems
// entries a thread, the store.
//
// The rows go on the grid as sorted_search.cuh's row_grid puts them, the
// cluster on blockIdx.x. Offsets across rows are 64-bit; indices within a
// row 32-bit. Round-to-nearest arithmetic (expf, __fdiv_rn), never fast
// math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "sorted_search.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
// Consecutive entries a thread, and a warp's run of them in shared memory
// (one float of padding every 32).
constexpr int kItems = 8;
constexpr int kWarpItems = 32 * kItems;
constexpr int kStage = kWarpItems + kWarpItems / 32;
// Entries a block of a cluster (side by side on an H100, graphed, 1,024,
// 2,048, 4,096 and 8,192 took 6.50, 5.95, 6.49 and 6.60 us a launch at
// (B, K) = (10, 10,000), 8.20, 7.40, 7.45 and 6.96 at (64, 10,000), and
// 5.19, 5.12, 5.85 and 5.83 at (16, 4,096)), and the largest cluster.
constexpr int kBlockEntries = 2048;
constexpr int kMaxCluster = 8;

// The max that keeps a NaN, as torch.logsumexp's does.
struct NanMax {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return (isnan(a) || a > b) ? a : b;
  }
};

// Where entry q of a lane lies in its warp's padded run.
__device__ __forceinline__ int blocked(int lane, int q) {
  return lane * kItems + q + lane * kItems / 32;
}

// The warp's run of entries from `first` (-inf at and past `end`) into x,
// kItems consecutive entries a lane: coalesced loads, then a transpose in
// the warp's `stage`.
__device__ __forceinline__ void load_run(const float* __restrict__ row,
                                         int first, int end,
                                         float (&x)[kItems], float* stage) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = first + j * 32 + lane;
    stage[j * 33 + lane] = i < end ? row[i] : -INFINITY;
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < kItems; ++q) x[q] = stage[blocked(lane, q)];
  __syncwarp();
}

// y, kItems consecutive entries a lane, to the warp's run from `first`
// (below `end`): a transpose in `stage`, then coalesced stores.
__device__ __forceinline__ void store_run(float* __restrict__ out, int first,
                                          int end, const float (&y)[kItems],
                                          float* stage) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < kItems; ++q) stage[blocked(lane, q)] = y[q];
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = first + j * 32 + lane;
    if (i < end) out[i] = stage[j * 33 + lane];
  }
  __syncwarp();
}

// A tile's sum and its largest prefix sum, from the tile's start.
struct Tile {
  float sum;
  float top;
};

// One tile, kItems log-weights x a thread (`any`: whether the thread has
// an entry of the row): s[q] gets the thread's partial sums, `before` its
// exclusive prefix in the tile, and `top` the exclusive max-scan of the
// threads' largest entries (before + s[kItems - 1], or 0 for a thread
// with no entry). Two barriers.
__device__ __forceinline__ Tile scan_tile(const float (&x)[kItems],
                                          float row_max, bool any,
                                          float (&s)[kItems], float* before,
                                          float* top, float* sums,
                                          float* tops) {
  float acc = 0.0f;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    acc += expf(x[q] - row_max);
    s[q] = acc;
  }
  const aesmc::Scan<float> sum =
      aesmc::block_scan(acc, 0.0f, aesmc::Sum{}, sums);
  *before = sum.before;
  const float last = any ? sum.before + acc : 0.0f;
  const aesmc::Scan<float> most =
      aesmc::block_scan(last, 0.0f, aesmc::Max{}, tops);
  *top = most.before;
  return Tile{sum.total, most.total};
}

// A thread's entries from `first` of a row of k: the running max r =
// max(running, carry + (tile_carry + top), carry + (tile_carry + (before +
// s[q]))), divided by `last`; entry k - 1 is 1. NaN everywhere else for a
// row whose maximum is not finite.
__device__ __forceinline__ void cdf_items(int first, int k, bool finite,
                                          const float (&s)[kItems],
                                          float carry, float tile_carry,
                                          float before, float top,
                                          float running, float last,
                                          float (&y)[kItems]) {
  const float below = fmaxf(running, carry + (tile_carry + top));
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const float r = fmaxf(below, carry + (tile_carry + (before + s[q])));
    y[q] = first + q == k - 1 ? 1.0f : finite ? __fdiv_rn(r, last) : NAN;
  }
}

// What a block of a cluster publishes to the others.
struct Partial {
  float max;  // (i) the largest log-weight of its chunk
  float sum;  // (ii) the sum of its chunk's weights
  float top;  // (ii) the largest prefix sum of its chunk, from its start
};

__global__ void __launch_bounds__(kMaxThreads)
    normalized_cdf_kernel(const float* __restrict__ logw,
                          float* __restrict__ cdf, int k, long long batch) {
  __shared__ float shared[3][kMaxWarps];
  __shared__ Partial published;
  // kStage floats a warp.
  extern __shared__ float stages[];
  cg::cluster_group cluster = cg::this_cluster();
  // A cluster spans blockIdx.x only, so all of it has one row.
  const long long b = aesmc::block_row();
  if (b >= batch) return;
  const int size = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x;
  const int warp_first = (t >> 5) * kWarpItems;
  float* stage = stages + (t >> 5) * kStage;
  const float* row = logw + b * k;
  float* out = cdf + b * k;
  const int tile = blockDim.x * kItems;
  const int chunk = (k + size - 1) / size;
  const int c0 = min(rank * chunk, k);
  const int c1 = min(c0 + chunk, k);
  const int tiles = (c1 - c0 + tile - 1) / tile;

  // (i) The row's maximum. The first tile's log-weights stay in registers.
  float x[kItems];
  load_run(row, c0 + warp_first, c1, x, stage);
  float m = -INFINITY;
#pragma unroll
  for (int q = 0; q < kItems; ++q) m = NanMax{}(m, x[q]);
  for (int i = c0 + tile + t; i < c1; i += blockDim.x) {
    m = NanMax{}(m, row[i]);
  }
  m = aesmc::block_scan(m, -INFINITY, NanMax{}, shared[0]).total;
  if (t == 0) published.max = m;
  cluster.sync();
  const float row_max = aesmc::cluster_fold(cluster, &published,
                                            &Partial::max, size, -INFINITY,
                                            NanMax{});
  const bool finite = isfinite(row_max);

  // (ii) The chunk's sum and its largest prefix sum. A chunk of one tile
  // keeps s, before and top for (iii).
  float s[kItems] = {};
  float before = 0.0f;
  float top = 0.0f;
  float sum = 0.0f;
  float chunk_top = 0.0f;
  if (finite) {
    for (int tt = 0; tt < tiles; ++tt) {
      const int first = c0 + tt * tile;
      if (tt > 0) load_run(row, first + warp_first, c1, x, stage);
      const Tile r = scan_tile(x, row_max, first + t * kItems < c1, s,
                               &before, &top, shared[1], shared[2]);
      chunk_top = fmaxf(chunk_top, sum + r.top);
      sum += r.sum;
    }
  }
  if (t == 0) {
    published.sum = sum;
    published.top = chunk_top;
  }
  cluster.sync();

  // The carry of the earlier chunks, the running max before this chunk,
  // and the row's last running max (an empty chunk has no entry).
  float carry = 0.0f;
  float running = 0.0f;
  float last = 0.0f;
  float folded = 0.0f;
  for (int r = 0; r < size; ++r) {
    const Partial* p = cluster.map_shared_rank(&published, r);
    if (r == rank) {
      carry = folded;
      running = last;
    }
    if (min(r * chunk, k) < k) last = fmaxf(last, folded + p->top);
    folded += p->sum;
  }
  // Every partial is read: the barrier that ends the kernel.
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");

  // (iii) The chunk of the CDF.
  float y[kItems];
  float tile_carry = 0.0f;
  for (int tt = 0; tt < tiles; ++tt) {
    const int first = c0 + tt * tile;
    if (tiles > 1 && finite) {
      load_run(row, first + warp_first, c1, x, stage);
      const Tile r = scan_tile(x, row_max, first + t * kItems < c1, s,
                               &before, &top, shared[1], shared[2]);
      cdf_items(first + t * kItems, k, finite, s, carry, tile_carry, before,
                top, running, last, y);
      running = fmaxf(running, carry + (tile_carry + r.top));
      tile_carry += r.sum;
    } else {
      cdf_items(first + t * kItems, k, finite, s, carry, 0.0f, before, top,
                running, last, y);
    }
    store_run(out, first + warp_first, c1, y, stage);
  }
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

}  // namespace

// Launches on `stream` of card `device`; returns the CUDA error of the
// launch (0 on success). logw and cdf are [B, K].
extern "C" int aesmc_normalized_cdf(const float* logw, float* cdf,
                                    long long batch, long long k, int device,
                                    void* stream) {
  if (batch == 0 || k == 0) return static_cast<int>(cudaSuccess);
  // This library carries its own CUDA runtime: select the tensors' card
  // in it before launching on that card's stream.
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const long long size = std::min<long long>(
      kMaxCluster, (k + kBlockEntries - 1) / kBlockEntries);
  const long long chunk = (k + size - 1) / size;
  const long long threads = std::min<long long>(
      kMaxThreads, ((chunk + kItems - 1) / kItems + 31) / 32 * 32);
  const dim3 grid = aesmc::row_grid(batch, size);
  if (grid.z == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(static_cast<unsigned>(threads));
  config.dynamicSmemBytes = threads / 32 * kStage * sizeof(float);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = static_cast<unsigned>(size);
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  config.attrs = cluster;
  config.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&config, normalized_cdf_kernel,
                                             logw, cdf, static_cast<int>(k),
                                             batch));
}
