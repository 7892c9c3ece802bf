// Per-lane core of the segment gather-sum kernel: one lane's share of a
// group of consecutive segments, in the order the card adds it.
//
// Shared by the CUDA kernel (segment_gather.cu) and by a host harness
// built with g++ in the CPU tests, which replays every lane of every
// ticket, the tickets in any order, so the dummy-row rule, the order of
// the sum, the prefetch depth, the work order (heavy segments first,
// then runs of light ones), the segment boundaries inside a run's stream
// of edges, the column map of both load paths and the final scale are
// checked on a machine without a GPU.  Only the launch, the ticket (an
// atomicAdd), the loads' cache path, the shuffles and the ballot stay
// CUDA-only (on the host, a shuffle reads again what lane j loaded).
//
// For segment r and column c:
//   out[r, c] = scale[r] * sum_{e in [ptr[r], ptr[r+1])} x[idx[e], c]
// summed in fp32 in e's order by one accumulator a column, starting from
// +0; an id outside [0, N) reads nothing and adds +0 (the GNN's zero
// dummy row, src == N), which leaves the sum's bits as they are: a sum
// that starts at +0 is never -0.  Without scale the factor is 1.
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

#define SG_WARP 32
#define SG_THREADS 256           // threads of a CTA: 8 warps, a group each
#define SG_GROUP 32              // segments a ticket: one a lane's end
#ifndef SG_DEPTH
#define SG_DEPTH 8               // rows a lane has in flight
#endif
#define SG_HEAVY 1024            // edges past which a segment goes first

static_assert(SG_GROUP <= SG_WARP, "a lane holds one segment's end");
static_assert(SG_WARP % SG_DEPTH == 0, "a round of ids holds whole batches");

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

// The work order.  Segments lie in groups of SG_GROUP, [r0, r1).  There
// are two tickets a group: ticket t < G takes group t's heavy segments
// (more than SG_HEAVY edges), one after the other; ticket G + t takes
// its other segments, as runs of consecutive light ones.  On the card a
// warp takes the next ticket by an atomicAdd, so the heavy segments all
// start in the launch's first tickets and none of them, however late in
// the index, sets a tail of its own (in-degrees are skewed: the largest
// is hundreds of times the mean).  Every segment is summed and stored by
// the one warp that takes it, whatever the order of the tickets, so the
// order changes when a segment is summed and never how.
__host__ __device__ inline int64_t sg_groups(int64_t r_count) {
  return (r_count + SG_GROUP - 1) / SG_GROUP;
}

__host__ __device__ inline int64_t sg_tickets(int64_t r_count) {
  return 2 * sg_groups(r_count);
}

__host__ __device__ inline void sg_group_bounds(int64_t t, int64_t r_count,
                                                int64_t* r0, int64_t* r1) {
  *r0 = t * SG_GROUP;
  *r1 = *r0 + SG_GROUP < r_count ? *r0 + SG_GROUP : r_count;
}

// The lowest set bit of a non-zero mask.
__host__ __device__ inline int sg_lowest(uint32_t m) {
#ifdef __CUDA_ARCH__
  return __ffs(m) - 1;
#else
  return __builtin_ctz(m);
#endif
}

// Bit j set where the group's segment r0 + j (j < g) is heavy.
__host__ __device__ inline uint32_t sg_heavy_mask(const int64_t* ptr,
                                                  int64_t r0, int g, int lane) {
#ifdef __CUDA_ARCH__
  bool heavy = false;
  if (lane < g) heavy = __ldg(ptr + r0 + 1 + lane) - __ldg(ptr + r0 + lane) > SG_HEAVY;
  return __ballot_sync(0xffffffffu, heavy);
#else
  (void)lane;
  uint32_t m = 0;
  for (int j = 0; j < g; ++j) {
    if (ptr[r0 + 1 + j] - ptr[r0 + j] > SG_HEAVY) m |= 1u << j;
  }
  return m;
#endif
}

// The id of round position j (< m): lane j loaded it (my, on the card).
__host__ __device__ inline int sg_round_id(const int* idx, int64_t base,
                                           int j, int m, int my) {
#ifdef __CUDA_ARCH__
  (void)idx;
  (void)base;
  (void)m;
  return __shfl_sync(0xffffffffu, my, j);
#else
  (void)my;
  return j < m ? idx[base + j] : 0;
#endif
}

// The end ptr[r0 + 1 + j] of the group's segment j: lane j loaded it.
__host__ __device__ inline int64_t sg_seg_end(const int64_t* ptr, int64_t r0,
                                              int j, int64_t my) {
#ifdef __CUDA_ARCH__
  (void)ptr;
  (void)r0;
  return __shfl_sync(0xffffffffu, (long long)my, j);
#else
  (void)my;
  return ptr[r0 + 1 + j];
#endif
}

// The factor of the group's segment j: lane j loaded it.
__host__ __device__ inline float sg_seg_scale(const float* scale, int64_t r0,
                                              int j, float my) {
#ifdef __CUDA_ARCH__
  (void)scale;
  (void)r0;
  return __shfl_sync(0xffffffffu, my, j);
#else
  (void)my;
  return scale ? scale[r0 + j] : 1.0f;
#endif
}

// Row id of x at columns [col, col + V) into v, or +0 where !ok (the
// load is predicated off: nothing is read).
template <int V>
__host__ __device__ inline void sg_load(float* v, const float* x, int id,
                                        int64_t d, int64_t col, bool ok) {
#ifdef __CUDA_ARCH__
  if constexpr (V == 4) {
    float4 t = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (ok) t = __ldg(reinterpret_cast<const float4*>(x + (int64_t)id * d + col));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = ok ? __ldg(x + (int64_t)id * d + col) : 0.0f;
  }
#else
  for (int k = 0; k < V; ++k) {
    v[k] = 0.0f;
    if (ok) {
      SG_HOST_READ(x + (int64_t)id * d + col + k);
      v[k] = x[(int64_t)id * d + col + k];
    }
  }
#endif
}

// Stores acc * s at dst (where the lane's columns lie in the row) and
// restarts acc from +0.
template <int V>
__host__ __device__ inline void sg_store(float* dst, float* acc, float s,
                                         bool active) {
  if (active) {
#ifdef __CUDA_ARCH__
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[0] * s, acc[1] * s, acc[2] * s, acc[3] * s);
    } else {
      dst[0] = acc[0] * s;
    }
#else
    for (int k = 0; k < V; ++k) dst[k] = acc[k] * s;
#endif
  }
  for (int k = 0; k < V; ++k) acc[k] = 0.0f;
}

// Lane `lane` of the warp that sums the run of segments [r0, r1) (1 to
// SG_GROUP): its columns of those output rows, in passes of 32 * V
// columns.  The run's edges [ptr[r0], ptr[r1]) are one stream: ids 32
// a round, one a lane, the next round's ids loaded under this round's
// rows; rows SG_DEPTH at a time, every load issued before the first add;
// where the stream crosses a segment's end the lane stores that segment
// (acc * scale) and starts the next from +0, so short segments share
// rounds and batches and pay no round trip of their own.  Every lane
// runs every loop (the bounds are the warp's), so the shuffles always
// have the whole warp; only the loads, adds and stores are masked by
// column.
template <int V>
__host__ __device__ inline void sg_group_lane(const float* x, const int* idx,
                                              const int64_t* ptr,
                                              const float* scale, float* out,
                                              int64_t n, int64_t d, int64_t r0,
                                              int64_t r1, int lane) {
  const int g = (int)(r1 - r0);
  int64_t my_end = 0;
  float my_scale = 1.0f;
  int64_t lo;
#ifdef __CUDA_ARCH__
  if (lane < g) {
    my_end = __ldg(ptr + r0 + 1 + lane);
    if (scale) my_scale = __ldg(scale + r0 + lane);
  }
  lo = __ldg(ptr + r0);
#else
  lo = ptr[r0];
#endif
  const int64_t hi = sg_seg_end(ptr, r0, g - 1, my_end);
  for (int64_t c0 = 0; c0 < d; c0 += SG_WARP * V) {
    const int64_t col = c0 + (int64_t)lane * V;
    const bool active = col < d;     // V = 4: d % 4 == 0, so col + 3 < d
    float acc[V];
    for (int k = 0; k < V; ++k) acc[k] = 0.0f;
    int j = 0;                       // the open segment: r0 + j
    int64_t seg_end = sg_seg_end(ptr, r0, 0, my_end);
    int next = 0;
#ifdef __CUDA_ARCH__
    if (lo + lane < hi) next = __ldg(idx + lo + lane);
#endif
    for (int64_t base = lo; base < hi; base += SG_WARP) {
      const int m = hi - base < SG_WARP ? (int)(hi - base) : SG_WARP;
      const int my = next;
#ifdef __CUDA_ARCH__
      if (base + SG_WARP + lane < hi) next = __ldg(idx + base + SG_WARP + lane);
#endif
      for (int b = 0; b < m; b += SG_DEPTH) {
        float v[SG_DEPTH][V];
#pragma unroll
        for (int u = 0; u < SG_DEPTH; ++u) {
          const int id = sg_round_id(idx, base, b + u, m, my);
          sg_load<V>(v[u], x, id, d, col,
                     active && b + u < m && id >= 0 && id < n);
        }
#pragma unroll
        for (int u = 0; u < SG_DEPTH; ++u) {
          if (b + u >= m) break;
          while (base + b + u >= seg_end) {   // segment r0 + j has ended
            sg_store<V>(out + (r0 + j) * d + col, acc,
                        sg_seg_scale(scale, r0, j, my_scale), active);
            seg_end = sg_seg_end(ptr, r0, ++j, my_end);
          }
          for (int k = 0; k < V; ++k) acc[k] += v[u][k];
        }
      }
    }
    for (; j < g; ++j) {             // the last open segment, then empty ones
      sg_store<V>(out + (r0 + j) * d + col, acc,
                  sg_seg_scale(scale, r0, j, my_scale), active);
    }
  }
}

// Lane `lane` of the warp that took ticket t (the work order above).
template <int V>
__host__ __device__ inline void sg_ticket_lane(const float* x, const int* idx,
                                               const int64_t* ptr,
                                               const float* scale, float* out,
                                               int64_t n, int64_t d,
                                               int64_t r_count, int64_t t,
                                               int lane) {
  const int64_t groups = sg_groups(r_count);
  const bool first = t < groups;
  int64_t r0, r1;
  sg_group_bounds(first ? t : t - groups, r_count, &r0, &r1);
  const int g = (int)(r1 - r0);
  uint32_t heavy = sg_heavy_mask(ptr, r0, g, lane);
  if (first) {
    while (heavy) {
      const int j = sg_lowest(heavy);
      heavy &= heavy - 1;
      sg_group_lane<V>(x, idx, ptr, scale, out, n, d, r0 + j, r0 + j + 1, lane);
    }
    return;
  }
  for (int j = 0; j < g;) {          // runs of light segments between them
    const uint32_t rest = heavy >> j;
    const int stop = rest ? j + sg_lowest(rest) : g;
    if (stop > j) sg_group_lane<V>(x, idx, ptr, scale, out, n, d, r0 + j, r0 + stop, lane);
    j = stop + 1;
  }
}
