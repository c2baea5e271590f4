// The gather at the end of K1 (resample_systematic.cu) and K3
// (resample_sorted.cu), for sm_90a.
//
// A block owns a tile of consecutive output slots of one batch row, and
// thread t holds the source indices of slots t + r * kBlockThreads. The
// output tile out[slots, 0:D] is one contiguous run of slots * D floats,
// and consecutive threads write consecutive floats of it, whatever D:
//
// - D = 1: each thread stores its own slots straight from its registers
//   (slot s is float s of the run), with no shared memory and no barrier;
// - D > 1: the block puts its indices in shared memory, and after a
//   barrier float e of the run is column e % D of the source row
//   idx[e / D]. Each thread issues kBatch loads before it stores any of
//   them, so that they are in flight together: a loop that stores each
//   value before its next load waits out one L2 round trip a float.
//
// Loads are near-coalesced too: the indices of a tile are sorted, so
// neighbouring slots read the same or neighbouring source rows.
//
// The run is indexed in 32 bits: slots * D < 2^32 (the wrappers cap D).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "sorted_search.cuh"

namespace aesmc {

constexpr int kBatch = 8;

// dst[s * d + c] = src[idx_s * d + c] for s < slots, c < d, where thread t
// holds idx_s of slot s = t + r * kBlockThreads in idx[r]. `tile` is
// kN * kBlockThreads ints of shared memory. Every thread of the block calls
// it with the same d and slots; with d = 0 it does nothing.
template <int kN>
__device__ __forceinline__ void gather_tile(const float* __restrict__ src,
                                            float* __restrict__ dst,
                                            long long d, int slots,
                                            const int (&idx)[kN], int* tile) {
  if (d <= 0) return;
  if (d == 1) {
#pragma unroll
    for (int r = 0; r < kN; ++r) {
      const int s = r * kBlockThreads + static_cast<int>(threadIdx.x);
      if (s < slots) dst[s] = src[idx[r]];
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < kN; ++r) tile[r * kBlockThreads + threadIdx.x] = idx[r];
  __syncthreads();
  const unsigned width = static_cast<unsigned>(d);
  const unsigned count = static_cast<unsigned>(slots) * width;
  for (unsigned e0 = threadIdx.x; e0 < count;
       e0 += kBatch * kBlockThreads) {
    float v[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const unsigned e = e0 + i * kBlockThreads;
      if (e < count) {
        const unsigned s = e / width;
        v[i] = src[static_cast<long long>(tile[s]) * d + (e - s * width)];
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const unsigned e = e0 + i * kBlockThreads;
      if (e < count) dst[e] = v[i];
    }
  }
}

}  // namespace aesmc
