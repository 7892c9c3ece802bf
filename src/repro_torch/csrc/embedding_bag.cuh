// Per-bag core of the EmbeddingBag kernels: one output column of one
// bag, whole (the warp route) or a pass over a range of its ids at a
// time (the E = 1 column route), and one lane's share of a bag plus the
// fixed order in which a group of lanes adds its shares (the E = 1 lane
// route).
//
// Shared by the CUDA kernels (embedding_bag.cu) and by a host harness
// built with g++ in the CPU tests, so the padding rule, the weights, the
// ids past the table, the fp32 accumulation, the mean's divisor, the
// column route's passes and the lane route's summation order are
// checked on a machine without a GPU.  Only the launch, the mapping of
// bags and columns onto threads and the shuffles stay CUDA-only.
//
// For bag b and column e, as the reference (jnp.take fills NaN past V):
//   valid_i = idx_i >= 0                       (-1, or any id < 0, is padding)
//   out     = sum_{valid i} w_i * table[idx_i, e]     (fp32)
//   w_i     = weights[b, i], or 1 without weights
//   mean:     out / max(#{valid i}, 1)
// and a bag with any id >= V gives NaN in every column: the id counts as
// valid (in the mean's divisor too) and its row is NaN.  The kernels
// write that NaN without reading outside the table.
#pragma once

#include <stdint.h>

#include <cmath>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

#define EB_LANE_THREADS 128   // threads of a lane-route CTA
#define EB_BATCH 8            // ids whose rows a thread loads at once
#define EB_PASS_IDS 16        // ids of every bag a column-route launch adds

// A host harness may define EB_HOST_READ(p) to see every table value
// the replayed threads read (the card's loads are the same).
#ifndef EB_HOST_READ
#define EB_HOST_READ(p)
#endif

__host__ __device__ inline float eb_load(const float* p) {
#ifndef __CUDA_ARCH__
  EB_HOST_READ(p);
#endif
  return *p;
}

__host__ __device__ inline float eb_nan() {
#ifdef __CUDA_ARCH__
  return __int_as_float(0x7fffffff);
#else
  return std::nanf("");
#endif
}

// A bag's (or a lane's) running state: the weighted sum, the number of
// valid ids, and whether one of them lies at or past V.
struct EbPart {
  float sum;
  int count;
  int past;
};

// Add id r, its weight wi and its row value x (read only when 0 <= r < V)
// to the state.
__host__ __device__ inline void eb_add(EbPart& s, int64_t V, int r, float wi,
                                       float x) {
  s.count += r >= 0;
  s.past |= r >= V;
  if (r >= 0 && r < V) s.sum += wi * x;
}

__host__ __device__ inline float eb_finish(const EbPart& s, int mean) {
  if (s.past) return eb_nan();
  return mean ? s.sum / (float)(s.count > 1 ? s.count : 1) : s.sum;
}

// Column e of ids first, first + step, ... of a bag, added in that order
// (the lane route's share of a bag).  The ids come in batches of
// EB_BATCH: first their indices, then their rows, then the sums, so that
// a batch's row loads are all in flight at once on the card.
template <typename T>
__host__ __device__ inline EbPart eb_sum_strided(const T* table, int64_t V,
                                                 int E, const int* idx,
                                                 const float* w, int L, int e,
                                                 int first, int step) {
  EbPart s = {0.0f, 0, 0};
  for (int i0 = first; i0 < L; i0 += EB_BATCH * step) {
    int r[EB_BATCH];
    float x[EB_BATCH];
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int u = 0; u < EB_BATCH; ++u) {
      const int i = i0 + u * step;
      r[u] = i < L ? idx[i] : -1;
    }
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int u = 0; u < EB_BATCH; ++u)
      x[u] = r[u] >= 0 && r[u] < V ? eb_load(table + (int64_t)r[u] * E + e)
                                   : 0.0f;
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int u = 0; u < EB_BATCH; ++u) {
      const int i = i0 + u * step;
      if (i < L) eb_add(s, V, r[u], w ? w[i] : 1.0f, x[u]);
    }
  }
  return s;
}

// The column and warp routes' running state of a bag: the weighted sum,
// the ids inside the table and the ids past it (counted apart,
// branch-free).  The column route keeps it in global memory between its
// passes: the same float, so the same bits.
struct EbRun {
  float sum;
  int count;
  int past;
};

// The column and warp routes' per-bag loop over ids [i0, i1), in order,
// unrolled by 8 on the card: 8 id loads, then each row load and its add,
// one row in flight a thread.  It keeps the loop's form from before ids
// past V gave NaN, whose loads the compiler schedules best at
// serve_bulk's 262,144 bags of all the forms tried (more rows in flight
// a thread were slower there; PERF.md).
template <typename T>
__host__ __device__ inline void eb_bag_range(const T* table, int64_t V,
                                             int E, const int* idx,
                                             const float* w, int i0, int i1,
                                             int e, EbRun& s) {
  float sum = s.sum;
  int count = s.count, past = s.past;
#ifdef __CUDA_ARCH__
#pragma unroll 8
#endif
  for (int i = i0; i < i1; ++i) {
    const int r = idx[i];
    if (r >= 0 && r < V) {
      sum += (w ? w[i] : 1.0f) * eb_load(table + (int64_t)r * E + e);
      ++count;
    }
    past += r >= V;
  }
  s.sum = sum, s.count = count, s.past = past;
}

__host__ __device__ inline float eb_run_finish(const EbRun& s, int mean) {
  const EbPart p = {s.sum, s.count + s.past, s.past};
  return eb_finish(p, mean);
}

// A whole bag through the loop (the warp route, column e).
template <typename T>
__host__ __device__ inline float eb_bag_column(
    const T* table, int64_t V, int E, const int* idx, const float* w, int L,
    int e, int mean) {
  EbRun s = {0.0f, 0, 0};
  eb_bag_range(table, V, E, idx, w, 0, L, e, s);
  return eb_run_finish(s, mean);
}

// The column route's passes over bags of L ids, one launch each: pass p
// adds ids [p EB_PASS_IDS, min(L, (p + 1) EB_PASS_IDS)) of every bag (at
// L = 0 one pass, which only writes the 0s).
__host__ __device__ inline int eb_passes(int L) {
  return L > 0 ? (L + EB_PASS_IDS - 1) / EB_PASS_IDS : 1;
}

// Bag b's part of the column route's pass over ids [i0, i1) (E = 1): its
// running state from run_sum[b], run_n[b] and run_n[B + b] (none at
// i0 = 0), those ids added, then either the state put back, or, at
// i1 = L, the bag's output in *value and true returned.
template <typename T>
__host__ __device__ inline bool eb_column_pass(
    const T* table, int64_t V, const int* idx, const float* w,
    float* run_sum, int* run_n, int B, int L, int i0, int i1, int b,
    int mean, float* value) {
  const int64_t o = (int64_t)b * L;
  EbRun s = {0.0f, 0, 0};
  if (i0 > 0) s = {run_sum[b], run_n[b], run_n[B + b]};
  eb_bag_range(table, V, 1, idx + o, w ? w + o : nullptr, i0, i1, 0, s);
  if (i1 == L) {
    *value = eb_run_finish(s, mean);
    return true;
  }
  run_sum[b] = s.sum;
  run_n[b] = s.count;
  run_n[B + b] = s.past;
  return false;
}

// The E = 1 lane route: a group of G lanes (8, 16 or 32) takes one bag.
// Lane j sums ids j, j + G, j + 2G, ... in that order; the group then
// adds its G shares by a butterfly: at offset G/2, G/4, ..., 1 every lane
// adds the share of lane (its own ^ offset), so after the last step every
// lane holds the same sum.  eb_group_lanes picks G from L.
__host__ __device__ inline int eb_group_lanes(int L) {
  return L > 16 ? 32 : (L > 8 ? 16 : 8);
}

template <typename T>
__host__ __device__ inline EbPart eb_lane_part(const T* table, int64_t V,
                                               const int* idx, const float* w,
                                               int L, int lane, int G) {
  return eb_sum_strided(table, V, 1, idx, w, L, 0, lane, G);
}

// One butterfly step, as a lane sees it: its own share and its partner's.
// fp32 addition is commutative, so both lanes of a pair get the same bits.
__host__ __device__ inline EbPart eb_combine(const EbPart& a, const EbPart& b) {
  EbPart s = {a.sum + b.sum, a.count + b.count, a.past | b.past};
  return s;
}

// The host's form of the card's shuffle tree: the G shares of one group,
// combined in place in the same steps, lane by lane; parts[0] ends with
// the bag's state.
__host__ __device__ inline void eb_butterfly(EbPart* parts, int G) {
  for (int off = G / 2; off > 0; off >>= 1)
    for (int j = 0; j < G; ++j)
      if ((j & off) == 0) {
        const EbPart lo = parts[j], hi = parts[j ^ off];
        parts[j] = eb_combine(lo, hi);
        parts[j ^ off] = eb_combine(hi, lo);
      }
}
