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
// float32 columns. Here the kernel is templated on the element width (1,
// 2, 4 or 8 bytes) and copies elements as raw bits: int8, bool, int32,
// int64, bfloat16, float32 and float64 all move bit for bit.
//
// One thread per output element (j, c); grid (ceil(Kp * D / 256), B).
// Because idx is sorted, neighbouring threads read neighbouring or equal
// source addresses, and every thread writes the element next to its
// neighbour's: reads and writes coalesce as far as this needs.
//
// Bound on an H100: at (B, K = Kp, D) = (10, 10,000, 1) with int32
// values the kernel moves 1.2 MB (idx, value, output), well under a
// microsecond of HBM bandwidth; the launch and one dependent load (idx,
// then value) bound it. At (4, 8,388,608, 1) it moves 403 MB: bytes bound
// it there.
//
// Offsets are 64-bit, so that B * Kp * D beyond 2^31 indexes correctly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void gather_sorted_kernel(const T* __restrict__ value,
                                     const int32_t* __restrict__ idx,
                                     T* __restrict__ out, long long k,
                                     long long kp, long long d) {
  const long long n = kp * d;
  const long long e =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const long long b = blockIdx.y;
  const long long j = e / d;
  const long long c = e - j * d;
  long long src = idx[b * kp + j];
  src = src < 0 ? 0 : (src < k ? src : k - 1);
  out[b * n + e] = value[(b * k + src) * d + c];
}

template <typename T>
int launch(const void* value, const int32_t* idx, void* out, long long batch,
           long long k, long long kp, long long d, cudaStream_t stream) {
  const long long n = kp * d;
  const dim3 grid(static_cast<unsigned int>((n + kThreads - 1) / kThreads),
                  static_cast<unsigned int>(batch));
  gather_sorted_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(value), idx, static_cast<T*>(out), k, kp, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` of card `device`; returns the CUDA error of the
// launch (0 on success). value [B, K, D], idx [B, Kp], out [B, Kp, D], with
// elements of `element_bytes` bytes (1, 2, 4 or 8).
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
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
