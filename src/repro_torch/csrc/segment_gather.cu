// Segment gather-sum over a CSR for Hopper (sm_90a): the GNN's mean
// aggregation and its gradient.
//
// Replaces no TPU kernel.  The reference aggregates with jnp.take of the
// source rows and jax.ops.segment_sum by destination
// (src/repro/models/gnn.py, _aggregate), which XLA fuses.  Done the plain
// way on the card it materialises the (E, d) messages (24.7 GB at
// ogb_products' layer 0, 31.7 GB at layer 1, kept for the backward),
// and index_add_ sums through atomics in an order that changes from run
// to run.  This kernel keeps no (E, d) buffer, sums each segment in edge
// order, and is its own backward over the transposed CSR.
//
// x (N, d) fp32, idx (E,) int32 grouped by segment, ptr (R + 1,) int64,
// scale (R,) fp32 or null; out (R, d) fp32:
//   out[r] = scale[r] * sum_{e in [ptr[r], ptr[r+1])} x[idx[e]]
// in fp32 in e's order; an id outside [0, N) adds nothing
// (segment_gather.cuh).
//
// What bounds it on an H100: bytes.  Each edge reads one row of x
// (400 B at d = 100, 512 B at d = 128) at a data-dependent address; the
// compulsory traffic is x, idx, ptr and scale read once and out written
// once, but rows are re-read once per edge, from L2 where the graph's
// locality allows and from device memory where it does not.
//
// Design, right and simple first: one warp per segment, a grid-stride
// loop over segments; lanes along the columns (one float4 a lane where
// d % 4 == 0 and the pointers are 16-byte aligned, so a warp reads a
// 512-byte row in one instruction, else one float a lane, in passes of
// 32 columns); the segment's ids loaded 32 at a time, one a lane, and
// broadcast with __shfl_sync; one store per output element and no
// atomics, so two launches give the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_gather.cuh"

template <int V>
__global__ void __launch_bounds__(SG_THREADS) segment_gather_kernel(
    const float* __restrict__ x, const int* __restrict__ idx,
    const int64_t* __restrict__ ptr, const float* __restrict__ scale,
    float* __restrict__ out, int64_t n, int64_t d, int64_t r_count) {
  const int lane = threadIdx.x & (SG_WARP - 1);
  const int64_t warps = (int64_t)gridDim.x * (SG_THREADS / SG_WARP);
  for (int64_t r = (int64_t)blockIdx.x * (SG_THREADS / SG_WARP) +
                   threadIdx.x / SG_WARP;
       r < r_count; r += warps) {
    const float s = scale ? __ldg(scale + r) : 1.0f;
    sg_segment_lane<V>(x, idx, n, d, __ldg(ptr + r), __ldg(ptr + r + 1), s,
                       out + r * d, lane);
  }
}

extern "C" int segment_gather_launch(const void* x, const void* idx,
                                     const void* ptr, const void* scale,
                                     void* out, int64_t n, int64_t d,
                                     int64_t r_count, void* stream_) {
  if (r_count == 0 || d == 0) return 0;
  cudaStream_t stream = (cudaStream_t)stream_;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int64_t per_cta = SG_THREADS / SG_WARP;
  const int64_t want = (r_count + per_cta - 1) / per_cta;
  const int64_t most = (int64_t)sms * (2048 / SG_THREADS);   // one wave
  const int grid = (int)(want < most ? want : most);
  const float* xs = (const float*)x;
  const int* ids = (const int*)idx;
  const int64_t* ps = (const int64_t*)ptr;
  const float* sc = (const float*)scale;
  float* o = (float*)out;
  if (sg_vector_path(d, (uintptr_t)x, (uintptr_t)out))
    segment_gather_kernel<4><<<grid, SG_THREADS, 0, stream>>>(xs, ids, ps, sc,
                                                            o, n, d, r_count);
  else
    segment_gather_kernel<1><<<grid, SG_THREADS, 0, stream>>>(xs, ids, ps, sc,
                                                            o, n, d, r_count);
  return (int)cudaGetLastError();
}
