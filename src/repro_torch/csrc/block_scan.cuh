// Per-word core of the plane-pruned chunked block scan.
//
// Shared by the CUDA kernel (block_scan.cu) and by a host harness built
// with g++ in the CPU tests, so the arithmetic is checked bit for bit
// on a machine without a GPU.  Only the launch, the grid and the
// reductions across threads are CUDA-only.
//
// Meta layout (int32, one row block of 4 x ncols per lane, as
// build_rule_meta writes it):
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

// Evaluates one 32-bit word w of one block for one lane's rule.
// occ_block points at the block's (tf_planes, W) words.
__host__ __device__ inline BsWord bs_eval_word(const uint32_t* occ_block,
                                               const int32_t* meta_lane,
                                               int ncols, int tf_planes,
                                               int W, int w, int n_terms) {
  uint32_t tf[BS_MAX_TERMS];
#pragma unroll
  for (int k = 0; k < BS_MAX_TERMS; ++k) tf[k] = 0u;

  const int32_t* plane_ids = meta_lane;
  const int32_t* term_ids = meta_lane + ncols;
  const int32_t* valid = meta_lane + 2 * ncols;
  const int32_t* req = meta_lane + 3 * ncols;

  // Only the active planes are read; each is OR-ed into its term.
  for (int p = 0; p < tf_planes && valid[p] != 0; ++p) {
    const uint32_t x = occ_block[(int64_t)plane_ids[p] * W + w];
    const int term = term_ids[p];
#pragma unroll
    for (int k = 0; k < BS_MAX_TERMS; ++k)
      if (k == term) tf[k] |= x;
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
