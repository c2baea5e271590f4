// Gather by sorted ancestor indices (kernel K5), for sm_90a.
//
// Replaces aesmc_tpu/ops/gather_pallas.py::_gather_kernel (launched by
// gather_sorted_pallas). For each batch row b, slot j < Kp and column
// c < D:
//
//   out[b, j, c] = value[b, clamp(idx[b, j], 0, K - 1), c]
//
// The TPU kernel moves float32 only (a two-cursor tile merge of one-hot
// masked sums), so integer particles reach it as 16-bit halves carried in
// float32 columns. Here the kernel copies elements as raw bits, templated
// on their width (1, 2, 4, 8 or 16 bytes): int8, bool, int16, int32,
// int64, bfloat16, float32 and float64 all move bit for bit. The wrapper
// hands a row of D elements over as fewer, wider elements where the
// row's bytes and the addresses allow (ops/gather_sorted_cuda.py,
// `_unit`): D = 8 int32 columns move as two 16-byte elements.
//
// The design:
// - a block owns a tile of 1,024 consecutive slots of one row (tiles on
//   blockIdx.x, rows on blockIdx.y and z: any number of rows), and
//   in-row indices are 32-bit;
// - thread t holds slots 4t .. 4t + 3 of the tile and loads their indices
//   with one 16-byte load where the address allows (no division, no
//   64-bit index arithmetic); rows of at most 256 slots take one slot a
//   thread, in tiles of 256, so that a short row's block is not three
//   quarters idle;
// - the gather is the shared tile gather (tile_gather.cuh, run layout):
//   at D = 1 each thread issues its 4 value loads together and stores
//   them as one vector (4 bytes of int8, 16 of int32); at D > 1 the block
//   writes its output tile as one contiguous run with kBatch loads a
//   thread in flight before its stores.
//
// Bound on an H100: at (B, K = Kp, D) = (10, 10,000, 1) with int32 values
// the kernel moves 1.2 MB (idx, value, output), 0.36 us of HBM bandwidth;
// the launch and the two dependent loads (index, then value) bound it.
// At (4, 8,388,608, 1) it moves 403 MB, 120 us: bytes bound it there.
//
// Offsets across rows are 64-bit, so that B * Kp * D beyond 2^31 indexes
// correctly.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sorted_search.cuh"
#include "tile_gather.cuh"

namespace {

constexpr int kThreads = aesmc::kBlockThreads;

// A tile of kThreads * kN slots; kN = 4 but for rows of at most kThreads
// slots, which take one a thread (the HMM train step's K = 256 rows).
template <typename T, int kN>
__global__ void __launch_bounds__(kThreads)
    gather_sorted_kernel(const T* __restrict__ value,
                         const int32_t* __restrict__ idx, T* __restrict__ out,
                         int k, int kp, long long d, long long batch) {
  constexpr int kTile = kThreads * kN;
  __shared__ int tile[kTile];
  const long long b = aesmc::block_row();
  if (b >= batch) return;
  const int j0 = static_cast<int>(blockIdx.x) * kTile;
  const int slots = min(kTile, kp - j0);
  const int32_t* from = idx + b * kp + j0;
  const int first = kN * static_cast<int>(threadIdx.x);

  int src[kN];
  bool loaded = false;
  if constexpr (kN == 4) {
    if (first + kN <= slots &&
        reinterpret_cast<uintptr_t>(from + first) % 16 == 0) {
      const int4 four = *reinterpret_cast<const int4*>(from + first);
      src[0] = four.x;
      src[1] = four.y;
      src[2] = four.z;
      src[3] = four.w;
      loaded = true;
    }
  }
  if (!loaded) {
#pragma unroll
    for (int r = 0; r < kN; ++r) {
      src[r] = first + r < slots ? from[first + r] : 0;
    }
  }
#pragma unroll
  for (int r = 0; r < kN; ++r) src[r] = min(max(src[r], 0), k - 1);
  aesmc::gather_tile<T, kN, true>(value + b * k * d, out + (b * kp + j0) * d,
                                  d, slots, src, tile);
}

template <typename T, int kN>
int launch_tiles(const void* value, const int32_t* idx, void* out,
                 long long batch, long long k, long long kp, long long d,
                 cudaStream_t stream) {
  constexpr int kTile = kThreads * kN;
  const dim3 grid = aesmc::row_grid(batch, (kp + kTile - 1) / kTile);
  if (grid.z == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  gather_sorted_kernel<T, kN><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(value), idx, static_cast<T*>(out),
      static_cast<int>(k), static_cast<int>(kp), d, batch);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* value, const int32_t* idx, void* out, long long batch,
           long long k, long long kp, long long d, cudaStream_t stream) {
  return kp <= kThreads
             ? launch_tiles<T, 1>(value, idx, out, batch, k, kp, d, stream)
             : launch_tiles<T, 4>(value, idx, out, batch, k, kp, d, stream);
}

}  // namespace

// Launches on `stream` of card `device`; returns the CUDA error of the
// launch (0 on success). value [B, K, D], idx [B, Kp], out [B, Kp, D], with
// elements of `element_bytes` bytes (1, 2, 4, 8 or 16).
extern "C" int aesmc_gather_sorted(const void* value, const int32_t* idx,
                                   void* out, long long batch, long long k,
                                   long long kp, long long d,
                                   int element_bytes, int device,
                                   void* stream) {
  if (batch == 0 || kp == 0 || d == 0) return static_cast<int>(cudaSuccess);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (element_bytes) {
    case 1:
      return launch<uint8_t>(value, idx, out, batch, k, kp, d, s);
    case 2:
      return launch<uint16_t>(value, idx, out, batch, k, kp, d, s);
    case 4:
      return launch<uint32_t>(value, idx, out, batch, k, kp, d, s);
    case 8:
      return launch<unsigned long long>(value, idx, out, batch, k, kp, d, s);
    case 16:
      return launch<uint4>(value, idx, out, batch, k, kp, d, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
