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
// CTA reads them itself, so a launch needs no host sync and no tensor
// op before it.
//
// What bounds it on an H100: memory.  It does a handful of integer
// operations per word read and reads n_active * W * 4 bytes per block:
// the TPU kernel reads the full T*F tile and masks it in VMEM, but here
// a plane whose mask is 0 is never read.  Design (block_scan_warp.cuh):
// one CTA of BS_TILE_WARPS warps per (query, tile of bb consecutive
// blocks), bb the wrapper's choice (nothing carries over between tiles,
// so the grid has no order).  Warp 0 turns the query's rule into a
// plane list by two ballots (no serial walk) in shared memory, behind
// the kernel's only __syncthreads.  Then each warp owns a contiguous run
// of the tile's blocks, a whole block at a time: a lane moves 16 bytes
// of each plane row per load, so one warp instruction reads a 512-byte
// row at W = 128; every active plane of a round's blocks is loaded
// before the first is used (a shallow rule keeps several blocks in
// flight per warp); the popcount sums are warp shuffles and match
// leaves in 16-byte streaming stores.  No shared memory and no barrier
// sits in the block loop.  The last tile's missing blocks are skipped.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan_warp.cuh"

#define BS_TILE_WARPS 4          // warps per CTA
#define BS_TILE_MAX_BLOCKS 64    // blocks per CTA: a full round of 16 a warp

template <bool VEC>
__global__ void __launch_bounds__(BS_TILE_WARPS * BS_WARP)
    block_scan_tile_kernel(
        const uint32_t* __restrict__ occ,     // (Q, nb, tf_planes, W)
        const uint8_t* __restrict__ allowed,  // (Q, T, F) bool
        const uint8_t* __restrict__ required, // (Q, T) bool
        const uint8_t* __restrict__ present,  // (Q, T) bool
        uint32_t* __restrict__ match,         // (Q, nb, W)
        int32_t* __restrict__ v_inc,          // (Q, nb)
        int32_t* __restrict__ n_match,        // (Q, nb)
        int nb, int tf_planes, int F, int W, int n_terms, int bb,
        int n_tiles) {
  const int q = blockIdx.x / n_tiles;
  const int b0 = (blockIdx.x % n_tiles) * bb;
  const int warp = threadIdx.x / BS_WARP;
  const int lane = threadIdx.x % BS_WARP;

  // The plane list: slot s holds the s-th active plane's word offset in
  // a block and its term; slots past n_active stay 0 (never read).
  __shared__ int32_t s_off[BS_SLOTS];
  __shared__ int32_t s_term[BS_SLOTS];
  __shared__ uint32_t s_mask[2];   // active planes, required terms
  if (warp == 0) {
    const uint8_t* p = present + (int64_t)q * n_terms;
    const bool vote = bs_plane_vote(allowed + (int64_t)q * tf_planes, p,
                                    tf_planes, F, lane);
    const bool req = bs_req_vote(required + (int64_t)q * n_terms, p, n_terms,
                                 lane);
    const uint32_t mask = __ballot_sync(BS_FULL_MASK, vote);
    const uint32_t req_mask = __ballot_sync(BS_FULL_MASK, req);
    if (lane < BS_SLOTS) {
      s_off[lane] = 0;
      s_term[lane] = 0;
    }
    __syncwarp();
    if (vote) {
      const int s = bs_rank(mask, lane);
      s_off[s] = lane * W;
      s_term[s] = lane / F;
    }
    if (lane == 0) {
      s_mask[0] = mask;
      s_mask[1] = req_mask;
    }
  }
  __syncthreads();

  int first, count;
  bs_warp_span(min(bb, nb - b0), warp, BS_TILE_WARPS, &first, &count);
  if (count == 0) return;
  const int64_t q_blocks = (int64_t)q * nb;
  bs_warp_scan<VEC>(occ + q_blocks * tf_planes * W, match + q_blocks * W,
                    b0 + first, count, tf_planes, W, lane, s_off, s_term,
                    bs_popc(s_mask[0]), s_mask[1], n_terms,
                    BsWarpFinish{v_inc + q_blocks, n_match + q_blocks, lane});
}

// Plain C entry point for ctypes.  Takes the 16-byte path where
// bs_vector_path allows it, else the scalar path.  Launches on the
// given stream and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a tile outside [1, BS_TILE_MAX_BLOCKS].
extern "C" int block_scan_tile_launch(const void* occ, const void* allowed,
                                      const void* required,
                                      const void* present, void* match,
                                      void* v_inc, void* n_match,
                                      int n_queries, int nb, int tf_planes,
                                      int F, int W, int n_terms, int bb,
                                      void* stream) {
  if (bb < 1 || bb > BS_TILE_MAX_BLOCKS) return (int)cudaErrorInvalidValue;
  const int n_tiles = (nb + bb - 1) / bb;
  const unsigned blocks = (unsigned)n_queries * (unsigned)n_tiles;
  const int threads = BS_TILE_WARPS * BS_WARP;
  auto kernel = bs_vector_path(W, (uintptr_t)occ, (uintptr_t)match)
                    ? block_scan_tile_kernel<true>
                    : block_scan_tile_kernel<false>;
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)occ, (const uint8_t*)allowed,
      (const uint8_t*)required, (const uint8_t*)present, (uint32_t*)match,
      (int32_t*)v_inc, (int32_t*)n_match, nb, tf_planes, F, W, n_terms, bb,
      n_tiles);
  return (int)cudaGetLastError();
}
