// EmbeddingBag (gather + per-bag weighted sum or mean) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel embedding_bag_pallas
// (src/repro/kernels/embedding_bag/embedding_bag.py, _kernel).
// table (V, E) fp32 or bf16, contiguous; indices (B, L) int32 with -1 as
// padding; optional weights (B, L) fp32.  out (B, E) in the table's type,
// accumulated in fp32 (the reference oracle's rule; the TPU kernel
// accumulates in the output type).  A bag with an id at or past V is NaN
// in every column, as in the reference, and no row past V is read
// (embedding_bag.cuh).
//
// What bounds it on an H100: bytes, and of the worst kind: every lookup
// is a random row, and a random read moves at least one 32-byte sector
// however narrow the row.  At the recsys path's shape (Wide&Deep's wide
// term: V = 40M, E = 1, L = 40) a bag reads 40 sectors for 160 bytes of
// table.  At serve_p99's 512 bags that is 0.74 MB, 0.2 us at 3.35 TB/s:
// there the kernel is bound by latency, not bytes.
//
// Design: the TPU prefetches the indices into SMEM and DMAs one (1, E)
// row per grid step, in order.  Here each thread loads its own indices.
// Three routes, chosen by the wrapper (kernels/embedding_bag/ops.py,
// bag_route):
//   E = 1, many bags (embedding_bag_launch, column route): one thread per
//     bag, its loop unrolled by 8 (eb_bag_range: 8 id loads, then the rows
//     one at a time), in passes of EB_PASS_IDS ids, one launch a pass,
//     each bag's running sum kept in global memory between passes.  At
//     serve_bulk's 262,144 bags the card holds every bag's thread at
//     once.  In one pass over all 40 ids those threads drift apart, so
//     the rows they want at once lie all over the table; in passes they
//     all want rows of the same 16 ids, which in Wide&Deep's and DeepFM's
//     bags are 16 fields, each with its own rows (PERF.md: 0.199 ms in
//     one pass, 0.157 in passes, as fast as a plain gather of the same
//     ids in field order).  More rows in flight a thread, ids staged in
//     shared memory, L2 prefetches and fewer threads an SM were all
//     slower there.
//   E = 1, few bags (embedding_bag_lanes_launch, lane route): one thread
//     per bag would put 512 bags on 2 of 132 SMs, each thread walking ~5
//     dependent rounds of (index load, row load).  Instead a group of G
//     lanes takes a bag (G = 32 at L = 40): lane j loads ids j, j + G, ...
//     (neighbouring lanes, neighbouring ids: one coalesced round per G
//     ids), then their rows, all in flight at once, and the group adds
//     its shares by a fixed butterfly of __shfl_xor_sync.  Four warps a
//     CTA, so 512 bags are 128 CTAs on 128 SMs, and a bag's critical path
//     is one index round trip, one row round trip and the shuffle tree.
//   E > 1 (embedding_bag_launch, warp route): one warp per bag, lanes
//     along E (neighbouring lanes read neighbouring columns of a row), the
//     index and weight loads warp-uniform.
// The per-bag sums, the lane shares and the butterfly's order are the
// __host__ __device__ functions of embedding_bag.cuh, which the CPU tests
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

// E = 1, column route: one thread per bag, ids [i0, i1) of every bag
// (eb_column_pass; between passes a bag's running state waits in
// run_sum and run_n).
template <typename T>
__global__ void __launch_bounds__(EB_THREADS) embedding_bag_column_kernel(
    const T* __restrict__ table, const int* __restrict__ idx,
    const float* __restrict__ w, T* __restrict__ out,
    float* __restrict__ run_sum, int* __restrict__ run_n, int64_t V, int B,
    int L, int i0, int i1, int mean) {
  const int b = blockIdx.x * EB_THREADS + threadIdx.x;
  if (b >= B) return;
  float x;
  if (eb_column_pass(table, V, idx, w, run_sum, run_n, B, L, i0, i1, b, mean,
                     &x))
    eb_store(out + b, x);
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

// E = 1, lane route: a group of G lanes per bag (see the note above).
template <typename T, int G>
__global__ void __launch_bounds__(EB_LANE_THREADS) embedding_bag_lanes_kernel(
    const T* __restrict__ table, const int* __restrict__ idx,
    const float* __restrict__ w, T* __restrict__ out, int64_t V, int B,
    int L, int mean) {
  const int b = blockIdx.x * (EB_LANE_THREADS / G) + threadIdx.x / G;
  const int lane = threadIdx.x & (G - 1);
  if (b >= B) return;              // a whole group leaves together
  const int64_t o = (int64_t)b * L;
  EbPart s = eb_lane_part(table, V, idx + o, w ? w + o : nullptr, L, lane, G);
  // the group's lanes of the warp: G consecutive lanes, all present
  const unsigned mask = G == 32 ? 0xFFFFFFFFu
                                : (((1u << G) - 1u) << (threadIdx.x & 31 & ~(G - 1)));
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    EbPart other;
    other.sum = __shfl_xor_sync(mask, s.sum, off, G);
    other.count = __shfl_xor_sync(mask, s.count, off, G);
    other.past = __shfl_xor_sync(mask, s.past, off, G);
    s = eb_combine(s, other);
  }
  if (lane == 0) eb_store(out + b, eb_finish(s, mean));
}

template <typename T>
static int eb_launch(const void* table, const int* idx, const float* w,
                     void* out, int64_t V, int B, int L, int E, int mean,
                     void* run, cudaStream_t stream) {
  if (E == 1) {
    if (eb_passes(L) > 1 && run == nullptr) return (int)cudaErrorInvalidValue;
    const int grid = (B + EB_THREADS - 1) / EB_THREADS;
    for (int p = 0; p < eb_passes(L); ++p) {
      const int i0 = p * EB_PASS_IDS;
      const int i1 = i0 + EB_PASS_IDS < L ? i0 + EB_PASS_IDS : L;
      embedding_bag_column_kernel<T><<<grid, EB_THREADS, 0, stream>>>(
          (const T*)table, idx, w, (T*)out, (float*)run, (int*)run + B, V, B,
          L, i0, i1, mean);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  } else {
    const int per = EB_THREADS / 32;
    const int grid = (B + per - 1) / per;
    embedding_bag_warp_kernel<T><<<grid, EB_THREADS, 0, stream>>>(
        (const T*)table, idx, w, (T*)out, V, B, L, E, mean);
  }
  return (int)cudaGetLastError();
}

template <typename T, int G>
static int eb_lanes_launch_g(const void* table, const int* idx,
                             const float* w, void* out, int64_t V, int B,
                             int L, int mean, cudaStream_t stream) {
  const int per = EB_LANE_THREADS / G;
  const int grid = (B + per - 1) / per;
  embedding_bag_lanes_kernel<T, G><<<grid, EB_LANE_THREADS, 0, stream>>>(
      (const T*)table, idx, w, (T*)out, V, B, L, mean);
  return (int)cudaGetLastError();
}

template <typename T>
static int eb_lanes_launch(const void* table, const int* idx, const float* w,
                           void* out, int64_t V, int B, int L, int mean,
                           cudaStream_t stream) {
  const int g = eb_group_lanes(L);
  auto launch = g == 32 ? eb_lanes_launch_g<T, 32>
              : g == 16 ? eb_lanes_launch_g<T, 16>
                        : eb_lanes_launch_g<T, 8>;
  return launch(table, idx, w, out, V, B, L, mean, stream);
}

// Plain C entry points for ctypes.  dtype: 0 = fp32, 1 = bf16; weights
// may be null; mean: 0 = sum, 1 = mean.  Each launches on the given
// stream and returns the CUDA error code (0 on success).
// embedding_bag_launch: the column route (E = 1; run: 3 B words of
// scratch for the running state, null only where eb_passes(L) is 1) or
// the warp route (E > 1).
extern "C" int embedding_bag_launch(const void* table, const void* idx,
                                    const void* weights, void* out,
                                    int dtype, int64_t V, int B, int L,
                                    int E, int mean, void* run,
                                    void* stream) {
  if (dtype == 1)
    return eb_launch<__nv_bfloat16>(table, (const int*)idx,
                                    (const float*)weights, out, V, B, L, E,
                                    mean, run, (cudaStream_t)stream);
  return eb_launch<float>(table, (const int*)idx, (const float*)weights, out,
                          V, B, L, E, mean, run, (cudaStream_t)stream);
}

// embedding_bag_lanes_launch: the lane route, E = 1 only.
extern "C" int embedding_bag_lanes_launch(const void* table, const void* idx,
                                          const void* weights, void* out,
                                          int dtype, int64_t V, int B, int L,
                                          int mean, void* stream) {
  if (dtype == 1)
    return eb_lanes_launch<__nv_bfloat16>(table, (const int*)idx,
                                          (const float*)weights, out, V, B,
                                          L, mean, (cudaStream_t)stream);
  return eb_lanes_launch<float>(table, (const int*)idx, (const float*)weights,
                                out, V, B, L, mean, (cudaStream_t)stream);
}
