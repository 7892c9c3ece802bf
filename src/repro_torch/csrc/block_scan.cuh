// Per-word core of the static whole-index block scan, and the
// constants and meta layout all three block scans share.
//
// Shared by the CUDA kernels and by host harnesses built with g++ in the
// CPU tests, so the arithmetic is checked bit for bit on a machine
// without a GPU.  Only the launches, the grids and the reductions across
// threads are CUDA-only.
//
// A rule reaches a kernel as a plane list: the ids (t*F + f) of its
// active planes (allowed AND present), each plane's term id, their
// count n_active, and one required flag (required AND present) per
// term.  Each kernel builds that list its own way:
//   block_scan.cu         from its meta rows (below), per lane, by
//                         ballots and shuffles (block_scan_warp.cuh)
//   block_scan_tile.cu    from the query's bool rule tensors, per CTA,
//                         by ballots into shared memory
//                         (block_scan_warp.cuh)
//   block_scan_static.cu  on the host, passed by value as a kernel
//                         parameter (BsStaticRule); its CTAs run
//                         bs_scan_blocks over bs_eval_planes below
//
// Chunk-kernel meta layout (int32, one row block of 4 x ncols per lane,
// as build_rule_meta writes it):
//   row 0: plane id (t*F + f) per step; column ncols-1 holds the block start
//   row 1: term id per step
//   row 2: step valid flag; the active steps come first, so the first
//          0 ends the list (this is how n_active is read)
//   row 3: required flag per term (required AND present), first T columns
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

#define BS_META_ROWS 4
#define BS_MAX_TERMS 4
#define BS_MAX_PLANES 16   // T*F at T = F = 4
#define BS_PLANE_GROUP 4   // a word's plane loads in flight together
#define BS_MAX_BB 8        // index blocks per CTA in the static scan

__host__ __device__ inline int bs_popc(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

struct BsWord {
  uint32_t match;   // the rule's match word
  int v_pop;        // sum over terms of popcount(term bitmap word)
  int match_pop;    // popcount(match)
};

// Evaluates one 32-bit word w of one block under a plane list.
// occ_block points at the block's (T*F, W) words.  Only the n_active
// listed planes are read; each is OR-ed into its term's bitmap word.
// match is the AND of the required terms' words (0 if no term is
// required); v_pop sums the popcounts of the first n_terms term words.
__host__ __device__ inline BsWord bs_eval_planes(const uint32_t* occ_block,
                                                 int W, int w,
                                                 const int32_t* plane_ids,
                                                 const int32_t* term_ids,
                                                 int n_active,
                                                 const int32_t* req,
                                                 int n_terms) {
  uint32_t tf[BS_MAX_TERMS];
#pragma unroll
  for (int k = 0; k < BS_MAX_TERMS; ++k) tf[k] = 0u;

  // The active planes go in groups of BS_PLANE_GROUP: a group's loads
  // are issued together (predicated off past n_active) before any of
  // them is used, so they are in flight at the same time.
  for (int base = 0; base < n_active; base += BS_PLANE_GROUP) {
    uint32_t x[BS_PLANE_GROUP];
#pragma unroll
    for (int j = 0; j < BS_PLANE_GROUP; ++j)
      x[j] = base + j < n_active
                 ? occ_block[(int64_t)plane_ids[base + j] * W + w]
                 : 0u;
#pragma unroll
    for (int j = 0; j < BS_PLANE_GROUP; ++j) {
      const int term = base + j < n_active ? term_ids[base + j] : -1;
#pragma unroll
      for (int k = 0; k < BS_MAX_TERMS; ++k)
        if (k == term) tf[k] |= x[j];
    }
  }

  uint32_t match = 0xFFFFFFFFu;
  int any_req = 0;
  int v_pop = 0;
#pragma unroll
  for (int k = 0; k < BS_MAX_TERMS; ++k) {
    if (k < n_terms) {
      v_pop += bs_popc(tf[k]);
      if (req[k] != 0) {
        match &= tf[k];
        any_req = 1;
      }
    }
  }
  if (!any_req) match = 0u;

  BsWord out;
  out.match = match;
  out.v_pop = v_pop;
  out.match_pop = bs_popc(match);
  return out;
}

// The static kernel's rule, passed by value as a kernel parameter: no
// device tensor and no host-to-device copy.
struct BsStaticRule {
  int32_t n_active;
  int32_t plane_ids[BS_MAX_PLANES];
  int32_t term_ids[BS_MAX_PLANES];
  int32_t req[BS_MAX_TERMS];
};

// Fills a BsStaticRule from host arrays (the wrapper's plane list).
__host__ __device__ inline BsStaticRule bs_static_rule(
    const int32_t* plane_ids, const int32_t* term_ids, int n_active,
    const int32_t* req, int n_terms) {
  BsStaticRule r;
  r.n_active = n_active;
  for (int p = 0; p < BS_MAX_PLANES; ++p) {
    r.plane_ids[p] = p < n_active ? plane_ids[p] : 0;
    r.term_ids[p] = p < n_active ? term_ids[p] : 0;
  }
  for (int t = 0; t < BS_MAX_TERMS; ++t) r.req[t] = t < n_terms ? req[t] : 0;
  return r;
}

#ifdef __CUDACC__
// One CTA of the static whole-index scan (block_scan_static.cu):
// blocks [b0, b0 + n_blk) of one query's
// (nb, T*F, W) occupancy under one plane list held in shared memory.
// Thread w owns word w of every block; per block the popcounts are
// summed with warp shuffles, each warp's sum is kept in shared memory,
// and after the loop thread i sums block i over the warps.  n_blk is
// the same for the whole CTA, so the last tile's missing blocks are
// skipped, not read.  Needs blockDim.x >= 32 * ceil(W / 32) and
// n_blk <= min(BS_MAX_BB, blockDim.x).
__device__ inline void bs_scan_blocks(const uint32_t* __restrict__ occ_q,
                                      uint32_t* __restrict__ match_q,
                                      int32_t* __restrict__ v_q,
                                      int32_t* __restrict__ n_q, int b0,
                                      int n_blk, int tf_planes, int W,
                                      const int32_t* plane_ids,
                                      const int32_t* term_ids, int n_active,
                                      const int32_t* req, int n_terms) {
  __shared__ int s_v[BS_MAX_BB][32];
  __shared__ int s_m[BS_MAX_BB][32];
  const int w = threadIdx.x;
  const int warp = w >> 5;
  for (int i = 0; i < n_blk; ++i) {
    const int64_t blk = b0 + i;
    int v_pop = 0, m_pop = 0;
    if (w < W) {
      const BsWord r = bs_eval_planes(occ_q + blk * tf_planes * W, W, w,
                                      plane_ids, term_ids, n_active, req,
                                      n_terms);
      match_q[blk * W + w] = r.match;
      v_pop = r.v_pop;
      m_pop = r.match_pop;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v_pop += __shfl_down_sync(0xFFFFFFFFu, v_pop, off);
      m_pop += __shfl_down_sync(0xFFFFFFFFu, m_pop, off);
    }
    if ((w & 31) == 0) {
      s_v[i][warp] = v_pop;
      s_m[i][warp] = m_pop;
    }
  }
  __syncthreads();
  if (w < n_blk) {
    int tv = 0, tm = 0;
    const int n_warps = blockDim.x >> 5;
    for (int k = 0; k < n_warps; ++k) {
      tv += s_v[w][k];
      tm += s_m[w][k];
    }
    v_q[b0 + w] = tv;
    n_q[b0 + w] = tm;
  }
}
#endif  // __CUDACC__
