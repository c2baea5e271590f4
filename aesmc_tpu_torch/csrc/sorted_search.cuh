// The search of sorted positions in a CDF shared by K4
// (searchsorted_sorted.cu), K2 (range_sum.cu), K1 (resample_systematic.cu),
// K3 (resample_sorted.cu) and K6 (searchsorted_cdf.cu), for sm_90a.
//
// A block owns a tile of consecutive positions of one batch row. For every
// position p of the tile with x_lo <= p <= x_hi, its upper bound
// #{i : cdf_i <= p} lies in [a, b], where a and b are the upper bounds of
// x_lo and x_hi, and only the entries cdf[a, b) decide it. So:
//
// 1. The block narrows the ranges that hold a and b until [a's low end,
//    b's high end) fits kWindowCap floats (`block_window`). In each round
//    every thread loads the last entry of one of kBlockThreads = 256 equal
//    chunks of a range and `__syncthreads_count` counts those at or below
//    the key; a row of n entries needs no round at n <= 8,192 and one up
//    to about 2 M (the window plus 2 n / 256 entries), where a binary
//    search takes log2 n dependent loads (14 at 10,000).
// 2. The block copies that window into shared memory with cp.async, 16
//    bytes a thread where the addresses allow (`stage_window`).
// 3. Each thread searches all its positions in the staged window at once
//    (`window_upper_bounds`): the same fixed number of halving steps for
//    every position; in each step it first issues one shared-memory load
//    per position (the index clamped into the window), then makes the
//    selects, so the loads are in flight together (when each load is
//    followed by its select, the compiled search waits out each load in
//    turn). A window over the cap (the narrowing ran to the exact bounds)
//    is searched the same way in global memory, and a position outside
//    [x_lo, x_hi] (positions that are not sorted) over the whole row.
//
// Indices within a row are 32-bit: rows hold at most 2^24 entries (the
// wrappers' limit). Blocks that search have kBlockThreads threads.
//
// It also holds the launch geometry K1-K5 share: any number of batch
// rows in one launch (`row_grid`, `block_row`); and what K6 and the CDF
// kernel (normalized_cdf.cu) share to build a CDF with a cluster a row:
// the block scan in one fixed order (`block_scan`: K6's maximum, the CDF
// kernel's maxima and sums) and the fold of the partials the cluster's
// blocks publish (`cluster_fold`).
//
// Comparisons are exact (the build never uses fast math) and follow
// torch.searchsorted(right=True): an entry counts when !(entry > p).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace aesmc {

constexpr int kBlockThreads = 256;
constexpr int kLogBlockThreads = 8;
// CDF entries a block stages in shared memory: 32 KB, static.
constexpr int kWindowCap = 8192;

struct Sum {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const {
    return a + b;
  }
};

struct Max {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return fmaxf(a, b);
  }
};

template <typename T>
struct Scan {
  T before;  // op over the threads before this one (identity for 0)
  T total;   // op over the whole block
};

// The exclusive scan of one value a thread, in thread order: an inclusive
// warp scan by shuffles, then the same scan of the warps' totals, in one
// fixed tree, behind one barrier. Every thread of the block calls it; the
// block has a multiple of 32 threads, at most 1,024. `shared` holds
// blockDim.x / 32 values; it is written before the barrier and read after
// it, so it must not be written again until every thread has passed a
// later barrier.
template <typename T, typename Op>
__device__ __forceinline__ Scan<T> block_scan(T x, T identity, Op op,
                                              T* shared) {
  constexpr unsigned int kFull = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  T incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T n = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl = op(n, incl);
  }
  T excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = identity;
  if (lane == 31) shared[warp] = incl;
  __syncthreads();
  T w_incl = lane < warps ? shared[lane] : identity;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T n = __shfl_up_sync(kFull, w_incl, o);
    if (lane >= o) w_incl = op(n, w_incl);
  }
  T w_excl = __shfl_up_sync(kFull, w_incl, 1);
  if (lane == 0) w_excl = identity;
  const T warps_before = __shfl_sync(kFull, w_excl, warp);
  return Scan<T>{op(warps_before, excl), __shfl_sync(kFull, w_incl, 31)};
}

// op over `field` of the partial each of a cluster's first `size` blocks
// published at `published` in its shared memory, in rank order. Call it
// after the cluster barrier that follows the publishing, and keep every
// block's shared memory alive until all have read it.
template <typename T, typename Partial, typename Op>
__device__ __forceinline__ T cluster_fold(
    cooperative_groups::cluster_group cluster, Partial* published,
    T Partial::*field, int size, T init, Op op) {
  T acc = init;
  for (int r = 0; r < size; ++r) {
    acc = op(acc, cluster.map_shared_rank(published, r)->*field);
  }
  return acc;
}

// The grid of every kernel: blockIdx.x runs over a row's tiles, and
// blockIdx.y + blockIdx.z * gridDim.y over the rows, up to 65,535 a
// dimension, so any number of rows fits one launch and no block divides.
// Blocks past the last row (in the last z slice) return at once.
__device__ __forceinline__ long long block_row() {
  return blockIdx.y + static_cast<long long>(blockIdx.z) * gridDim.y;
}

// The grid of a launch over `tiles` tiles of each of `batch` rows; its z
// extent is 0 (no launch) when the rows exceed 65,535^2.
inline dim3 row_grid(long long batch, long long tiles) {
  const long long rows = batch < 65535 ? batch : 65535;
  const long long slices = (batch + rows - 1) / rows;
  return dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(rows),
              slices > 65535 ? 0u : static_cast<unsigned>(slices));
}

// The order of a search: upper bound (an entry goes before x when
// !(entry > x)) or lower bound (when entry < x).
template <bool kLower>
__device__ __forceinline__ bool goes_before(float entry, float x) {
  return kLower ? entry < x : !(entry > x);
}

// Where an answer of a search can still be: in [lo, hi], the entries
// [lo, hi) unread.
struct Range {
  int lo;
  int hi;
};

// One round of a block-wide search, this thread's part: its chunk's
// length (0 once the range is exact) and whether the last entry of its
// chunk goes before x.
template <bool kLower>
__device__ __forceinline__ bool probe(const float* __restrict__ row,
                                      const Range& r, float x, int* step) {
  *step = (r.hi - r.lo + kBlockThreads - 1) >> kLogBlockThreads;
  const int q = r.lo + (static_cast<int>(threadIdx.x) + 1) * *step - 1;
  return *step > 0 && q < r.hi && goes_before<kLower>(row[q], x);
}

// The rest of the round: `count` chunks go before x entirely (the entries
// that go before x are a prefix), so the answer lies between their end
// and the last entry of the next chunk.
__device__ __forceinline__ void shrink(Range* r, int step, int count) {
  if (step == 0) return;
  const int end = r->lo + (count + 1) * step - 1;
  r->lo += count * step;
  if (end < r->hi) r->hi = end;
}

// lo + #{i in [lo, hi) : goes_before(row[i], x)} over a nondecreasing row,
// searched by the whole block. Every thread calls it with the same
// arguments and gets the result.
template <bool kLower>
__device__ __forceinline__ int block_count(const float* __restrict__ row,
                                           int lo, int hi, float x) {
  Range r{lo, hi};
  while (r.lo < r.hi) {
    int step;
    const bool before = probe<kLower>(row, r, x, &step);
    shrink(&r, step, __syncthreads_count(before));
  }
  return r.lo;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to),
               "l"(src)
               : "memory");
}

// Copies src[0, n), n <= kWindowCap, to `to`, which has src's float offset
// within 16 bytes, so that every 16-byte group of src lands on a 16-byte
// shared address and moves in one cp.async. Every thread of the block
// calls it; it ends with a barrier.
__device__ __forceinline__ void stage_window(float* to, const float* src,
                                             int n, int shift) {
  const int head = min((4 - shift) & 3, n);
  const int vecs = (n - head) >> 2;
  for (int i = threadIdx.x; i < head; i += kBlockThreads) {
    cp_async4(to + i, src + i);
  }
  for (int v = threadIdx.x; v < vecs; v += kBlockThreads) {
    cp_async16(to + head + 4 * v, src + head + 4 * v);
  }
  for (int i = head + 4 * vecs + threadIdx.x; i < n; i += kBlockThreads) {
    cp_async4(to + i, src + i);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
}

// The entries [lo, hi) of a row that decide the upper bound of every
// position in [x_lo, x_hi], and whether their copy is staged at shared
// address `copy` (they number at most kWindowCap).
struct Window {
  int lo;
  int hi;
  float x_lo;
  float x_hi;
  bool staged;
  unsigned copy;
};

// Finds the window of [x_lo, x_hi] in row[0, n) and stages it, where the
// upper bounds of x_lo and x_hi are known to lie in the ranges a and b
// (the whole row when nothing is known). Every thread of the block calls
// it with the same arguments; `shared` is kWindowCap + 4 floats (16-byte
// aligned) of shared memory. It ends with a barrier.
__device__ __forceinline__ Window block_window(const float* __restrict__ row,
                                               int n, float x_lo, float x_hi,
                                               float* shared, Range a,
                                               Range b) {
  while (b.hi - a.lo > kWindowCap && (a.lo < a.hi || b.lo < b.hi)) {
    int step_a, step_b;
    const bool before_a = probe<false>(row, a, x_lo, &step_a);
    const bool before_b = probe<false>(row, b, x_hi, &step_b);
    shrink(&a, step_a, __syncthreads_count(before_a));
    shrink(&b, step_b, __syncthreads_count(before_b));
  }
  const float* src = row + a.lo;
  const int shift =
      static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  Window w{a.lo, b.hi, x_lo, x_hi, a.lo <= b.hi && b.hi - a.lo <= kWindowCap,
           static_cast<unsigned>(__cvta_generic_to_shared(shared + shift))};
  if (w.staged) stage_window(shared + shift, src, w.hi - w.lo, shift);
  return w;
}

__device__ __forceinline__ Window block_window(const float* __restrict__ row,
                                               int n, float x_lo, float x_hi,
                                               float* shared) {
  return block_window(row, n, x_lo, x_hi, shared, Range{0, n}, Range{0, n});
}

// The largest power of two <= n, for n >= 1.
__device__ __forceinline__ int top_bit(int n) { return 1 << (31 - __clz(n)); }

// Entry i of a window staged at a shared address. Volatile, so that no
// load moves above the barrier that ends the staging.
struct SharedEntries {
  unsigned base;
  __device__ __forceinline__ float operator()(int i) const {
    float entry;
    asm volatile("ld.shared.f32 %0, [%1];"
                 : "=f"(entry)
                 : "r"(base + 4u * static_cast<unsigned>(i)));
    return entry;
  }
};

// Entry i of a row in global memory.
struct GlobalEntries {
  const float* __restrict__ row;
  __device__ __forceinline__ float operator()(int i) const { return row[i]; }
};

// out[r] = #{i in [0, n) : !(w_i > x[r])} over a nondecreasing w, for kN
// keys at once: the same halving steps for all; each step issues one load
// a key (its index clamped into w), then makes the kN selects.
template <int kN, typename Entries>
__device__ __forceinline__ void count_at_most(Entries w, int n,
                                              const float (&x)[kN],
                                              int (&out)[kN]) {
#pragma unroll
  for (int r = 0; r < kN; ++r) out[r] = 0;
  if (n <= 0) return;
  for (int step = top_bit(n); step > 0; step >>= 1) {
    float entry[kN];
#pragma unroll
    for (int r = 0; r < kN; ++r) entry[r] = w(min(out[r] + step, n) - 1);
#pragma unroll
    for (int r = 0; r < kN; ++r) {
      const int next = out[r] + step;
      out[r] = next <= n && !(entry[r] > x[r]) ? next : out[r];
    }
  }
}

// u[r] = #{i : row_i <= p[r]} for a row of n entries, through the window.
template <int kN>
__device__ __forceinline__ void window_upper_bounds(
    const Window& w, const float* __restrict__ row, int n,
    const float (&p)[kN], int (&u)[kN]) {
  if (w.staged) {
    count_at_most(SharedEntries{w.copy}, w.hi - w.lo, p, u);
  } else {
    count_at_most(GlobalEntries{row + w.lo}, w.hi - w.lo, p, u);
  }
#pragma unroll
  for (int r = 0; r < kN; ++r) {
    u[r] += w.lo;
    if (!(p[r] >= w.x_lo && p[r] <= w.x_hi)) {
      const float one[1] = {p[r]};
      int whole[1];
      count_at_most(GlobalEntries{row}, n, one, whole);
      u[r] = whole[0];
    }
  }
}

}  // namespace aesmc
