// The segment gather-sum kernel in its first form, before its Hopper
// redesign (src/repro_torch/csrc/segment_gather.{cu,cuh}: a warp per
// segment in a grid-stride walk, one row in flight a warp), frozen in one
// file under its own entry point, segment_gather_first_launch, so that
// tools/segment_gather_ab.py can time it beside the current kernel in one
// process.  Not on any path of the port.
//
// ---- segment_gather.cuh as it was ----
// Per-segment core of the segment gather-sum kernel: one lane's share of
// one segment's output row, in the order the card adds it.
//
// Shared by the CUDA kernel (segment_gather.cu) and by a host harness
// built with g++ in the CPU tests, which replays every lane of every
// warp, so the dummy-row rule, the order of the sum, the column map of
// both load paths and the final scale are checked on a machine without
// a GPU.  Only the launch, the grid-stride walk over segments and the
// shuffle that broadcasts a round's ids stay CUDA-only (on the host,
// sg_round_id reads the id that lane j loaded).
//
// For segment r and column c:
//   out[r, c] = scale[r] * sum_{e in [ptr[r], ptr[r+1])} x[idx[e], c]
// summed in fp32 in e's order, starting from +0; an id outside [0, N)
// adds nothing (the GNN's zero dummy row, src == N).  Without scale the
// factor is 1.


#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

#define SG_WARP 32
#define SG_THREADS 256           // threads of a CTA: 8 warps, a segment each

// A host harness may define SG_HOST_READ(p) to see every x value the
// replayed lanes read (the card's loads are the same).
#ifndef SG_HOST_READ
#define SG_HOST_READ(p)
#endif

// The 16-byte path: each lane takes 4 neighbouring columns (one float4
// load a row) where d is a multiple of 4 and x and out lie on 16-byte
// boundaries; else one column a lane.  Both paths add each column's
// terms in the same order, so they give the same bits.
__host__ __device__ inline bool sg_vector_path(int64_t d, uintptr_t x,
                                               uintptr_t out) {
  return d % 4 == 0 && x % 16 == 0 && out % 16 == 0;
}

// The id of round position j: lane j loaded it (my, on the card).
__host__ __device__ inline int sg_round_id(const int* idx, int64_t base,
                                           int j, int my) {
#ifdef __CUDA_ARCH__
  (void)idx;
  (void)base;
  return __shfl_sync(0xffffffffu, my, j);
#else
  (void)my;
  return idx[base + j];
#endif
}

// Adds row `row` of x at columns [col, col + V) into acc.
template <int V>
__host__ __device__ inline void sg_add(float* acc, const float* row, int64_t col) {
#ifdef __CUDA_ARCH__
  if constexpr (V == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row + col));
    acc[0] += v.x;
    acc[1] += v.y;
    acc[2] += v.z;
    acc[3] += v.w;
  } else {
    acc[0] += __ldg(row + col);
  }
#else
  for (int k = 0; k < V; ++k) {
    SG_HOST_READ(row + col + k);
    acc[k] += row[col + k];
  }
#endif
}

// Lane `lane` of the warp that owns segment [lo, hi): its columns of the
// output row out_row, in passes of 32 * V columns.  Every lane runs
// every loop (the bounds are the warp's), so the shuffle always has the
// whole warp; only the adds and the store are masked by column.
template <int V>
__host__ __device__ inline void sg_segment_lane(const float* x,
                                                const int* idx, int64_t n,
                                                int64_t d, int64_t lo,
                                                int64_t hi, float s,
                                                float* out_row, int lane) {
  for (int64_t c0 = 0; c0 < d; c0 += SG_WARP * V) {
    const int64_t col = c0 + (int64_t)lane * V;
    const bool active = col < d;     // V = 4: d % 4 == 0, so col + 3 < d
    float acc[V];
    for (int k = 0; k < V; ++k) acc[k] = 0.0f;
    for (int64_t base = lo; base < hi; base += SG_WARP) {
      const int m = hi - base < SG_WARP ? (int)(hi - base) : SG_WARP;
      int my = 0;
#ifdef __CUDA_ARCH__
      if (lane < m) my = __ldg(idx + base + lane);
#endif
#pragma unroll 4
      for (int j = 0; j < m; ++j) {
        const int id = sg_round_id(idx, base, j, my);
        if (active && id >= 0 && id < n) sg_add<V>(acc, x + (int64_t)id * d, col);
      }
    }
    if (active) {
      for (int k = 0; k < V; ++k) out_row[col + k] = acc[k] * s;
    }
  }
}

// ---- segment_gather.cu as it was ----
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

extern "C" int segment_gather_first_launch(const void* x, const void* idx,
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
