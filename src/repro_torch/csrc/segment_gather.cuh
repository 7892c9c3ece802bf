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
#pragma once

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
