// Whole-index block scan under a runtime rule per query, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel block_scan_pallas
// (src/repro/kernels/block_scan/block_scan.py), which the JAX package's
// kernel API reaches through block_scan and, vmapped over a query
// batch, block_scan_batched.  For each of Q queries, with that query's
// own rule, it evaluates every one of the nb index blocks:
//   match[q, b, :]  = AND over required terms of (OR over the term's
//                     active planes), 0 if no term is required
//   v_inc[q, b]     = sum of popcounts of the term bitmaps
//   n_match[q, b]   = popcount(match)
//
// The rule arrives as the caller's bool tensors on the device, one rule
// per query: allowed (Q, T, F), required (Q, T), present (Q, T).  Each
// CTA ANDs them itself (the TPU kernel's masks rows 0 and 1), so a
// launch needs no host sync and no tensor op before it.
//
// What bounds it on an H100: memory.  It does a handful of integer
// operations per word read and reads n_active * W * 4 bytes per block:
// the TPU kernel reads the full T*F tile and masks it in VMEM, but here
// a plane whose mask is 0 is never read (the plane list is the same for
// the whole CTA, so the skip costs no divergence).  Design: one CTA per
// (query, tile of bb consecutive blocks), bb the wrapper's choice (the
// TPU kernel's block_bb axis; nothing carries over between tiles, so
// the grid has no order).  The CTA stages the query's rule in shared
// memory and thread 0 turns it into a plane list there; then each
// thread owns one 32-bit word of every block of the tile, so every
// plane is one coalesced W-word row read, and the active planes of a
// word are loaded together (block_scan.cuh).  The last tile's missing
// blocks are skipped, not padded.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

__global__ void block_scan_tile_kernel(
    const uint32_t* __restrict__ occ,     // (Q, nb, tf_planes, W)
    const uint8_t* __restrict__ allowed,  // (Q, T, F) bool
    const uint8_t* __restrict__ required, // (Q, T) bool
    const uint8_t* __restrict__ present,  // (Q, T) bool
    uint32_t* __restrict__ match,         // (Q, nb, W)
    int32_t* __restrict__ v_inc,          // (Q, nb)
    int32_t* __restrict__ n_match,        // (Q, nb)
    int nb, int tf_planes, int F, int W, int n_terms, int bb, int n_tiles) {
  const int q = blockIdx.x / n_tiles;
  const int b0 = (blockIdx.x % n_tiles) * bb;

  // The rule is staged in one parallel load, so that thread 0's walk
  // over it reads shared memory, not a chain of global loads.
  __shared__ uint8_t s_rule[BS_MAX_PLANES + 2 * BS_MAX_TERMS];
  __shared__ int32_t s_plane[BS_MAX_PLANES];
  __shared__ int32_t s_term[BS_MAX_PLANES];
  __shared__ int32_t s_req[BS_MAX_TERMS];
  __shared__ int s_n;
  const int i = threadIdx.x;
  if (i < tf_planes) s_rule[i] = allowed[(int64_t)q * tf_planes + i];
  if (i < n_terms) {
    s_rule[BS_MAX_PLANES + i] = required[(int64_t)q * n_terms + i];
    s_rule[BS_MAX_PLANES + BS_MAX_TERMS + i] =
        present[(int64_t)q * n_terms + i];
  }
  __syncthreads();
  if (i == 0)
    s_n = bs_planes_from_rule(s_rule, s_rule + BS_MAX_PLANES,
                              s_rule + BS_MAX_PLANES + BS_MAX_TERMS, n_terms,
                              F, s_plane, s_term, s_req);
  __syncthreads();

  const int64_t q_blocks = (int64_t)q * nb;
  bs_scan_blocks(occ + q_blocks * tf_planes * W, match + q_blocks * W,
                 v_inc + q_blocks, n_match + q_blocks, b0, min(bb, nb - b0),
                 tf_planes, W, s_plane, s_term, s_n, s_req, n_terms);
}

// Plain C entry point for ctypes.  Launches on the given stream and
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue
// for a tile outside [1, BS_MAX_BB].
extern "C" int block_scan_tile_launch(const void* occ, const void* allowed,
                                      const void* required,
                                      const void* present, void* match,
                                      void* v_inc, void* n_match,
                                      int n_queries, int nb, int tf_planes,
                                      int F, int W, int n_terms, int bb,
                                      void* stream) {
  if (bb < 1 || bb > BS_MAX_BB) return (int)cudaErrorInvalidValue;
  const int threads = ((W + 31) / 32) * 32;
  const int n_tiles = (nb + bb - 1) / bb;
  const unsigned blocks = (unsigned)n_queries * (unsigned)n_tiles;
  block_scan_tile_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)occ, (const uint8_t*)allowed,
      (const uint8_t*)required, (const uint8_t*)present, (uint32_t*)match,
      (int32_t*)v_inc, (int32_t*)n_match, nb, tf_planes, F, W, n_terms, bb,
      n_tiles);
  return (int)cudaGetLastError();
}
