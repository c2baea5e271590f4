// The gather at the end of K1 (resample_systematic.cu), K3
// (resample_sorted.cu), K5 (gather_sorted.cu) and K6 (searchsorted_cdf.cu),
// for sm_90a.
//
// A block owns a tile of consecutive output slots of one batch row, and
// each thread holds the source indices of kN of its slots, in one of two
// layouts:
//
// - strided (K1, K3, K6): slot r * kBlockThreads + t in idx[r] of thread
//   t, so that neighbouring threads hold neighbouring slots;
// - run (K5): slots kN * t + r, so that a thread loads its indices, and
//   stores its D = 1 values, as one vector.
//
// The output tile out[slots, 0:D] is one contiguous run of slots * D
// elements of type T (any of 1, 2, 4, 8 or 16 bytes; elements are copied
// as raw bits), and consecutive threads write consecutive elements of it,
// whatever D:
//
// - D = 1: each thread stores its own slots straight from its registers,
//   with no shared memory and no barrier; in the run layout, as one vector
//   of kN elements where the run's address allows and kN * sizeof(T) <= 16;
// - D > 1: the block puts its indices in shared memory, and after a
//   barrier element e of the run is column e % D of the source row
//   idx[e / D]. Each thread issues kBatch loads before it stores any of
//   them, so that they are in flight together: a loop that stores each
//   value before its next load waits out one L2 round trip an element.
//
// Loads are near-coalesced too: the indices of a tile are sorted, so
// neighbouring slots read the same or neighbouring source rows.
//
// The run is indexed in 32 bits when slots * D < 2^32, else in 64 bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "sorted_search.cuh"

namespace aesmc {

constexpr int kBatch = 8;

// The slot of a thread's r-th index.
template <int kN, bool kRun>
__device__ __forceinline__ int tile_slot(int r) {
  return kRun ? kN * static_cast<int>(threadIdx.x) + r
              : r * kBlockThreads + static_cast<int>(threadIdx.x);
}

// The native vector type of kBytes bytes, for one store.
template <int kBytes>
struct Vector;
template <>
struct Vector<4> {
  using type = unsigned;
};
template <>
struct Vector<8> {
  using type = uint2;
};
template <>
struct Vector<16> {
  using type = uint4;
};

// kN elements of T, seen as one vector.
template <typename T, int kN>
union Pack {
  T v[kN];
  typename Vector<sizeof(T) * kN>::type word;
};

// D > 1: element e of the run is column e % d of source row tile[e / d].
template <typename I, typename T>
__device__ __forceinline__ void gather_columns(const T* __restrict__ src,
                                               T* __restrict__ dst, I width,
                                               I count, const int* tile) {
  for (I e0 = threadIdx.x; e0 < count; e0 += kBatch * kBlockThreads) {
    T v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const I e = e0 + static_cast<I>(i) * kBlockThreads;
      if (e < count) {
        const I s = e / width;
        v[i] = src[static_cast<long long>(tile[s]) * width + (e - s * width)];
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const I e = e0 + static_cast<I>(i) * kBlockThreads;
      if (e < count) dst[e] = v[i];
    }
  }
}

// dst[s * d + c] = src[idx_s * d + c] for s < slots, c < d, where this
// thread holds idx_s of slot s = tile_slot<kN, kRun>(r) in idx[r]. `tile`
// is kN * kBlockThreads ints of shared memory. Every thread of the block
// calls it with the same d and slots; with d = 0 it does nothing.
template <typename T, int kN, bool kRun = false>
__device__ __forceinline__ void gather_tile(const T* __restrict__ src,
                                            T* __restrict__ dst, long long d,
                                            int slots, const int (&idx)[kN],
                                            int* tile) {
  if (d <= 0) return;
  if (d == 1) {
    T v[kN];
#pragma unroll
    for (int r = 0; r < kN; ++r) {
      if (tile_slot<kN, kRun>(r) < slots) v[r] = src[idx[r]];
    }
    if constexpr (kRun && sizeof(T) * kN >= 4 && sizeof(T) * kN <= 16) {
      T* to = dst + tile_slot<kN, kRun>(0);
      if (tile_slot<kN, kRun>(kN - 1) < slots &&
          reinterpret_cast<uintptr_t>(to) % (sizeof(T) * kN) == 0) {
        Pack<T, kN> pack;
#pragma unroll
        for (int r = 0; r < kN; ++r) pack.v[r] = v[r];
        using Word = typename Vector<sizeof(T) * kN>::type;
        *reinterpret_cast<Word*>(to) = pack.word;
        return;
      }
    }
#pragma unroll
    for (int r = 0; r < kN; ++r) {
      const int s = tile_slot<kN, kRun>(r);
      if (s < slots) dst[s] = v[r];
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < kN; ++r) tile[tile_slot<kN, kRun>(r)] = idx[r];
  __syncthreads();
  const unsigned long long count = static_cast<unsigned long long>(slots) *
                                   static_cast<unsigned long long>(d);
  if (count <= 0xffffffffull) {
    gather_columns<unsigned, T>(src, dst, static_cast<unsigned>(d),
                                static_cast<unsigned>(count), tile);
  } else {
    gather_columns<unsigned long long, T>(
        src, dst, static_cast<unsigned long long>(d), count, tile);
  }
}

}  // namespace aesmc
