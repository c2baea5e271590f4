// Fused CDF + search + gather from log-weights (kernel K6), for sm_90a.
//
// Replaces aesmc_tpu/ops/resample_pallas.py::_make_resample_kernel with
// cdf_input=False (the in-kernel exp, _lane_prefix and _row_prefix), as
// launched by searchsorted_cdf_pallas. For each batch row b:
//
//   w_i     = round(exp(logw_i - max_i logw_i) * 2^38)   (float32 exp, the
//             weight in 38-bit fixed point, an int64)
//   cum_i   = w_0 + ... + w_i                     (exact: integer sums)
//   cdf_i   = min(float(cum_i) * (1 / float(cum_{K-1})), 1), and
//   cdf_K-1 = 1                                   (round-to-nearest)
//   idx_j   = min(#{i : cdf_i <= pos_j}, K - 1)   for each j < Kp
//   out_j,: = value[b, idx_j, :]                  (D float32 columns)
//
// The TPU kernel sums in float32, and a float32 prefix sum depends on its
// order: two orders drift apart with K (on an H100, torch.cumsum put 77%
// of the indices off a float64 CDF's, by up to 130, at K = 4,194,304).
// Integer sums are exact in any order, so the kernel, split over many
// blocks, gives the plain version's CDF bit for bit; the CDF is monotone
// by construction and its last entry is exactly 1.0. A weight below 2^-39
// of the largest counts as 0 (K <= 2^24 keeps every sum below 2^62).
// The CDF multiplies by the total's reciprocal: a division an entry cost
// 0.9 us at (10, 10,000) on an H100.
//
// Each row is split over a thread block cluster of kCluster = 8 blocks
// (the portable maximum) on neighbouring SMs, which read each other's
// shared memory. Block r of a row's cluster owns the chunk r of its CDF
// entries and the chunk r of its positions. One launch, no atomics:
//
//   (i)   each block reduces its chunk to a maximum and publishes it in its
//         shared memory; after cluster barrier 1 every block reads the
//         kCluster partials, so all agree on the row's maximum;
//   (ii)  each block sums its chunk's fixed-point weights in tiles of
//         2,048 (each thread adds its 8 entries, then one block scan of
//         the threads' sums), and publishes the chunk's sum. After
//         barrier 2 each block's carry is the sum of the earlier chunks',
//         and the row's total the sum of all;
//   (iii) each block writes its chunk of the CDF to the [B, K] scratch.
//         A chunk of one scan tile keeps its prefix sums in registers from
//         (ii); a longer one scans its tiles again;
//   (iv)  after barrier 3 (release and acquire at cluster scope, so every
//         block sees the whole row), each block searches its positions in
//         tiles of 2,048, 8 a thread, through a shared-memory window of the
//         CDF (sorted_search.cuh, as K1, K3 and K4 do), and gathers with
//         the shared tile gather (tile_gather.cuh). The CDF at the chunks'
//         ends, known from the sums, bounds each tile's window before any
//         load: at K = 10,000 the window needs no narrowing round.
//
// Blocks with an empty chunk (K or Kp below kCluster) take part in every
// barrier and do nothing else.
//
// Bound on an H100: at (B, K = Kp, D) = (10, 10,000, 1) the kernel moves
// 2.0 MB (log-weights, positions, values, output, indices), 0.6 us of HBM
// bandwidth. Latency bounds it: the launch, three cluster barriers (about
// 0.5 us each on an H100), the block reductions and scan, the window's
// staging, about 12 shared-memory search steps and one dependent gather
// load. A call runs on 8 B SMs.
//
// Offsets across rows are 64-bit; indices within a row 32-bit (K, Kp <=
// 2^24). Round-to-nearest conversions and arithmetic (__fdiv_rn,
// __fmul_rn), never fast math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sorted_search.cuh"
#include "tile_gather.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = aesmc::kBlockThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;
// Consecutive entries a thread in a scan tile, and the tile.
constexpr int kItems = 8;
constexpr int kScanTile = kThreads * kItems;
// Positions a thread in a search tile (strided), and the tile.
constexpr int kPerThread = 8;
constexpr int kSearchTile = kThreads * kPerThread;
constexpr unsigned int kFull = 0xffffffffu;
// A weight of 1 (the row's largest) in fixed point: 2^38.
constexpr float kOne = 274877906944.0f;

// Exclusive block-wide scan of one integer a thread, in thread order,
// behind one barrier: a warp scan, then every thread adds the warps'
// totals before its own. `shared` holds kWarps values and must not be
// written again until every thread has passed a later barrier. Returns
// the thread's exclusive prefix; `*total` gets the block's total. Not
// sorted_search.cuh's block_scan: reading the 8 warps' totals from shared
// memory beats its shuffle scan of them here (2,326 against 2,486 us a
// launch at (2, 4,194,304) on an H100).
__device__ __forceinline__ long long block_scan(long long x,
                                                long long* shared,
                                                long long* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long n = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += n;
  }
  if (lane == 31) shared[warp] = incl;
  __syncthreads();
  long long before = 0;
  long long all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const long long v = shared[w];
    if (w < warp) before += v;
    all += v;
  }
  *total = all;
  return before + incl - x;
}

// The CDF at a prefix sum, below the last entry (which is 1).
__device__ __forceinline__ float cdf_entry(long long prefix, float inv_total) {
  return fminf(__fmul_rn(__ll2float_rn(prefix), inv_total), 1.0f);
}

// What a block publishes to its cluster.
struct Partial {
  float max;      // (i) the largest log-weight of its chunk
  long long sum;  // (ii) the sum of its chunk's fixed-point weights
};

// One scan tile of a chunk: s[q] gets the prefix sum, within the chunk, of
// entry first + q (for the entries below c1), and *sum carries the chunk's
// sum from tile to tile. Tile 0's log-weights are x, the others' are read
// from row. `shared` is two buffers of kWarps, used by turns.
__device__ __forceinline__ void scan_tile(const float* __restrict__ row,
                                          int tt, int first, int c1,
                                          float row_max,
                                          const float (&x)[kItems],
                                          long long (&s)[kItems],
                                          long long* sum,
                                          long long (*shared)[kWarps]) {
  long long acc = 0;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int i = first + q;
    const float lw = tt == 0 ? x[q] : (i < c1 ? row[i] : -INFINITY);
    if (i < c1) acc += __float2ll_rn(expf(lw - row_max) * kOne);
    s[q] = acc;
  }
  long long tile_sum;
  const long long before = block_scan(acc, shared[tt & 1], &tile_sum);
#pragma unroll
  for (int q = 0; q < kItems; ++q) s[q] += *sum + before;
  *sum += tile_sum;
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    searchsorted_cdf_kernel(const float* __restrict__ logw,
                            const float* __restrict__ pos,
                            const float* __restrict__ value,
                            float* __restrict__ out, int32_t* __restrict__ idx,
                            float* scratch, int k, int kp, long long d) {
  __shared__ __align__(16) float window[aesmc::kWindowCap + 4];
  __shared__ int tile[kSearchTile];
  __shared__ float maxes[kWarps];
  __shared__ long long sums[2][kWarps];
  __shared__ float chunk_end[kCluster];
  __shared__ Partial published;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long b = blockIdx.x / kCluster;
  const int t = threadIdx.x;
  const float* row = logw + b * k;
  float* cum = scratch + b * k;
  const int chunk = (k + kCluster - 1) / kCluster;
  const int c0 = min(rank * chunk, k);
  const int c1 = min(c0 + chunk, k);
  const int tiles = (c1 - c0 + kScanTile - 1) / kScanTile;

  // The first search tile's positions, loaded ahead: they do not depend
  // on the CDF.
  const int pchunk = (kp + kCluster - 1) / kCluster;
  const int p0 = min(rank * pchunk, kp);
  const int p1 = min(p0 + pchunk, kp);
  const float* prow = pos + b * kp;
  float p[kPerThread];
  float lo = 0.0f;
  float hi = 0.0f;
  // Slots past a tile's end search its first position and write nothing.
  auto load_positions = [&](int j0, int j1) {
    lo = prow[j0];
    hi = prow[j1 - 1];
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const int j = j0 + r * kThreads + t;
      p[r] = j < j1 ? prow[j] : lo;
    }
  };
  if (p0 < p1) load_positions(p0, min(p0 + kSearchTile, p1));

  // (i) The row's maximum. The first scan tile's log-weights stay in
  // registers for (ii).
  float x[kItems];
  float m = -INFINITY;
#pragma unroll
  for (int q = 0; q < kItems; ++q) {
    const int i = c0 + t * kItems + q;
    x[q] = i < c1 ? row[i] : -INFINITY;
    m = fmaxf(m, x[q]);
  }
  for (int i = c0 + kScanTile + t; i < c1; i += kThreads) {
    m = fmaxf(m, row[i]);
  }
  m = aesmc::block_scan(m, -INFINITY, aesmc::Max{}, maxes).total;
  if (t == 0) published.max = m;
  cluster.sync();
  const float row_max = aesmc::cluster_fold(cluster, &published,
                                            &Partial::max, kCluster,
                                            -INFINITY, aesmc::Max{});

  // (ii) The chunk's sum; with one tile its prefix sums stay in s.
  long long s[kItems];
  long long sum = 0;
  for (int tt = 0; tt < tiles; ++tt) {
    scan_tile(row, tt, c0 + tt * kScanTile + t * kItems, c1, row_max, x, s,
              &sum, sums);
  }
  if (t == 0) published.sum = sum;
  cluster.sync();

  // The carry of the earlier chunks and the row's total; thread r <
  // kCluster also finds the CDF at the end of chunk r, as (iii) writes it.
  long long carry = 0;
  long long running = 0;
  long long through_t = 0;
#pragma unroll
  for (int r = 0; r < kCluster; ++r) {
    if (r == rank) carry = running;
    running += cluster.map_shared_rank(&published, r)->sum;
    if (r == t) through_t = running;
  }
  const float inv_total = __fdiv_rn(1.0f, __ll2float_rn(running));
  if (t < kCluster) {
    chunk_end[t] = min((t + 1) * chunk, k) == k
                       ? 1.0f
                       : cdf_entry(through_t, inv_total);
  }

  // (iii) The chunk of the CDF.
  auto finish = [&](int first) {
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
      const int i = first + q;
      if (i < c1) {
        cum[i] = i == k - 1 ? 1.0f : cdf_entry(carry + s[q], inv_total);
      }
    }
  };
  if (tiles == 1) {
    finish(c0 + t * kItems);
  } else {
    // Scanned again tile by tile: the same sums, now written.
    sum = 0;
    for (int tt = 0; tt < tiles; ++tt) {
      const int first = c0 + tt * kScanTile + t * kItems;
      scan_tile(row, tt, first, c1, row_max, x, s, &sum, sums);
      finish(first);
    }
  }
  // Every block's chunk is written and visible to the cluster; no block
  // reads another's shared memory after this.
  cluster.sync();

  // (iv) Search and gather, a tile of this block's positions at a time.
  for (int j0 = p0; j0 < p1; j0 += kSearchTile) {
    const int j1 = min(j0 + kSearchTile, p1);
    if (j0 != p0) load_positions(j0, j1);
    const float x_lo = fminf(lo, hi);
    const float x_hi = fmaxf(lo, hi);
    // Where the upper bounds of x_lo and x_hi lie, from the CDF at the
    // chunks' ends: all of a chunk ending at or below x comes before x,
    // and none of what follows a chunk ending above x.
    aesmc::Range a{0, k};
    aesmc::Range bx{0, k};
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      const int r_end = min((r + 1) * chunk, k);
      const float e = chunk_end[r];
      if (e > x_lo) {
        a.hi = min(a.hi, r_end);
      } else {
        a.lo = max(a.lo, r_end);
      }
      if (e > x_hi) {
        bx.hi = min(bx.hi, r_end);
      } else {
        bx.lo = max(bx.lo, r_end);
      }
    }
    if (a.lo > a.hi) a = aesmc::Range{0, k};
    if (bx.lo > bx.hi) bx = aesmc::Range{0, k};
    const aesmc::Window w =
        aesmc::block_window(cum, k, x_lo, x_hi, window, a, bx);
    int src[kPerThread];
    aesmc::window_upper_bounds(w, cum, k, p, src);
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) src[r] = min(src[r], k - 1);
    if (idx != nullptr) {
      int32_t* to = idx + b * kp;
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) {
        const int j = j0 + r * kThreads + t;
        if (j < j1) to[j] = src[r];
      }
    }
    aesmc::gather_tile(value + b * k * d, out + (b * kp + j0) * d, d,
                       j1 - j0, src, tile);
    // The window and the index tile serve the next tile.
    __syncthreads();
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
  if (batch > 0x7fffffffLL / kCluster) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const unsigned blocks = static_cast<unsigned>(batch * kCluster);
  searchsorted_cdf_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      logw, pos, value, out, idx, scratch, static_cast<int>(k),
      static_cast<int>(kp), d);
  return static_cast<int>(cudaGetLastError());
}
