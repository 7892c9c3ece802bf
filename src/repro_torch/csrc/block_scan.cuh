// The constants, the static kernel's rule and the meta layout the
// three block scans share; their core is block_scan_warp.cuh.
//
// Shared by the CUDA kernels and by host harnesses built with g++ in the
// CPU tests, so the arithmetic is checked bit for bit on a machine
// without a GPU.
//
// A rule reaches a kernel as a plane list: the ids (t*F + f) of its
// active planes (allowed AND present), each plane's term id, their
// count n_active, and one required flag (required AND present) per
// term.  Each kernel builds that list its own way, and all three run
// their blocks a warp each through block_scan_warp.cuh:
//   block_scan.cu         from its meta rows (below), per lane, by
//                         ballots and shuffles
//   block_scan_tile.cu    from the query's bool rule tensors, per CTA,
//                         by ballots into shared memory
//   block_scan_static.cu  on the host, passed by value as a kernel
//                         parameter (BsStaticRule), read by every warp
//                         into registers (bs_static_slots)
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

__host__ __device__ inline int bs_popc(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// The static kernel's rule, passed by value as a kernel parameter: no
// device tensor and no host-to-device copy.  Slots past n_active hold 0
// (never read); bit k of req_mask is term k's required-and-present flag.
struct BsStaticRule {
  int32_t n_active;
  uint32_t req_mask;
  int32_t plane_ids[BS_MAX_PLANES];
  int32_t term_ids[BS_MAX_PLANES];
};

// Fills a BsStaticRule from host arrays (the wrapper's plane list).
__host__ __device__ inline BsStaticRule bs_static_rule(
    const int32_t* plane_ids, const int32_t* term_ids, int n_active,
    const int32_t* req, int n_terms) {
  BsStaticRule r;
  r.n_active = n_active;
  r.req_mask = 0u;
  for (int p = 0; p < BS_MAX_PLANES; ++p) {
    r.plane_ids[p] = p < n_active ? plane_ids[p] : 0;
    r.term_ids[p] = p < n_active ? term_ids[p] : 0;
  }
  for (int t = 0; t < n_terms && t < BS_MAX_TERMS; ++t)
    if (req[t] != 0) r.req_mask |= 1u << t;
  return r;
}
