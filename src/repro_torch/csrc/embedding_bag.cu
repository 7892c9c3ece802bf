// EmbeddingBag (gather + per-bag weighted sum or mean) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel embedding_bag_pallas
// (src/repro/kernels/embedding_bag/embedding_bag.py, _kernel).
// table (V, E) fp32 or bf16, contiguous; indices (B, L) int32 with -1 as
// padding; optional weights (B, L) fp32.  out (B, E) in the table's type,
// accumulated in fp32 (the reference oracle's rule; the TPU kernel
// accumulates in the output type).
//
// What bounds it on an H100: bytes, and of the worst kind: every lookup
// is a random row, and a random read moves at least one 32-byte sector
// however narrow the row.  At the recsys path's shape (Wide&Deep's wide
// term: V = 40M, E = 1, L = 40) a bag reads 40 sectors for 160 bytes of
// table.
//
// Design: the TPU prefetches the indices into SMEM and DMAs one (1, E)
// row per grid step, in order.  Here each thread loads its own indices.
// E = 1, the path's shape: one thread per bag, its loop over L unrolled
// so that several independent row loads are in flight.  E > 1: one warp
// per bag, lanes along E (neighbouring lanes read neighbouring columns of
// a row), the index and weight loads warp-uniform.  The sum over L is a
// register sum in eb_bag_column (embedding_bag.cuh), which the CPU tests
// compile with g++.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "embedding_bag.cuh"

#define EB_THREADS 256

__host__ __device__ inline float eb_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void eb_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void eb_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// E = 1: one thread per bag.
template <typename T>
__global__ void __launch_bounds__(EB_THREADS) embedding_bag_column_kernel(
    const T* __restrict__ table, const int* __restrict__ idx,
    const float* __restrict__ w, T* __restrict__ out, int64_t V, int B,
    int L, int mean) {
  const int b = blockIdx.x * EB_THREADS + threadIdx.x;
  if (b >= B) return;
  const int64_t o = (int64_t)b * L;
  eb_store(out + b, eb_bag_column(table, V, 1, idx + o, w ? w + o : nullptr,
                                  L, 0, mean));
}

// E > 1: one warp per bag, lane e takes columns e, e + 32, ...
template <typename T>
__global__ void __launch_bounds__(EB_THREADS) embedding_bag_warp_kernel(
    const T* __restrict__ table, const int* __restrict__ idx,
    const float* __restrict__ w, T* __restrict__ out, int64_t V, int B,
    int L, int E, int mean) {
  const int b = blockIdx.x * (EB_THREADS / 32) + (threadIdx.x >> 5);
  if (b >= B) return;
  const int64_t o = (int64_t)b * L;
  for (int e = threadIdx.x & 31; e < E; e += 32)
    eb_store(out + (int64_t)b * E + e,
             eb_bag_column(table, V, E, idx + o, w ? w + o : nullptr, L, e,
                           mean));
}

template <typename T>
static int eb_launch(const void* table, const int* idx, const float* w,
                     void* out, int64_t V, int B, int L, int E, int mean,
                     cudaStream_t stream) {
  if (E == 1) {
    const int grid = (B + EB_THREADS - 1) / EB_THREADS;
    embedding_bag_column_kernel<T><<<grid, EB_THREADS, 0, stream>>>(
        (const T*)table, idx, w, (T*)out, V, B, L, mean);
  } else {
    const int per = EB_THREADS / 32;
    const int grid = (B + per - 1) / per;
    embedding_bag_warp_kernel<T><<<grid, EB_THREADS, 0, stream>>>(
        (const T*)table, idx, w, (T*)out, V, B, L, E, mean);
  }
  return (int)cudaGetLastError();
}

// Plain C entry point for ctypes.  dtype: 0 = fp32, 1 = bf16; weights
// may be null; mean: 0 = sum, 1 = mean.  Launches on the given stream and
// returns the CUDA error code (0 on success).
extern "C" int embedding_bag_launch(const void* table, const void* idx,
                                    const void* weights, void* out,
                                    int dtype, int64_t V, int B, int L,
                                    int E, int mean, void* stream) {
  if (dtype == 1)
    return eb_launch<__nv_bfloat16>(table, (const int*)idx,
                                    (const float*)weights, out, V, B, L, E,
                                    mean, (cudaStream_t)stream);
  return eb_launch<float>(table, (const int*)idx, (const float*)weights, out,
                          V, B, L, E, mean, (cudaStream_t)stream);
}
