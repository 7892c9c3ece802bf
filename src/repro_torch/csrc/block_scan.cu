// Plane-pruned chunked block scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel block_scan_pruned_chunk
// (src/repro/kernels/block_scan/block_scan_pruned.py, _chunk_kernel).
// For each of B query lanes, with that lane's own runtime rule, it
// evaluates C consecutive index blocks starting at the lane's block
// start (blocks past nb-1 are clamped to the last block):
//   match[b, c, :]  = AND over required terms of (OR over the term's
//                     active planes), 0 if no term is required
//   v_inc[b, c]     = sum of popcounts of the term bitmaps
//   n_match[b, c]   = popcount(match)
//
// What bounds it on an H100: at the serve path's shapes (B = 256 lanes,
// C = 4, about 1 µs of bytes) latency, not bandwidth: the launch and
// the chain of dependent loads.  It reads only the rule's active
// planes, n_active * W * 4 bytes per lane-block, so bytes read stay
// proportional to the paper's cost u, as in the TPU kernel.  Design
// (block_scan_warp.cuh): one warp per (lane, chunk position),
// BS_CHUNK_WARPS of them per CTA, and two DRAM round trips: first each
// lane of the warp loads its step of the meta rows (plane id, term,
// valid flag, required flag) and the block start, all independent
// loads; n_active and the required terms come from ballots, and a
// slot's plane and term reach the lanes by shuffles.  Then every active
// plane's row is loaded at once, 16 bytes a lane (a rule of more than
// BS_SLOTS active planes loads them in groups of BS_SLOTS), and the
// popcounts are summed by warp shuffles.  No shared memory, no barrier.
// W > 128 walks 128-word strips; W % 4 != 0 or a misaligned view takes
// the scalar path of the same kernel.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan_warp.cuh"

#define BS_CHUNK_WARPS 4   // (lane, chunk position) pairs per CTA

template <bool VEC, bool MANY>
__global__ void __launch_bounds__(BS_CHUNK_WARPS * BS_WARP)
    block_scan_pruned_chunk_kernel(
        const uint32_t* __restrict__ occ,     // (B, nb, tf_planes, W)
        const int32_t* __restrict__ meta,     // (B, 4, ncols)
        uint32_t* __restrict__ match,         // (B, chunk, W)
        int32_t* __restrict__ v_inc,          // (B, chunk)
        int32_t* __restrict__ n_match,        // (B, chunk)
        int batch, int nb, int tf_planes, int W, int ncols, int n_terms,
        int chunk) {
  const int g = blockIdx.x * BS_CHUNK_WARPS + threadIdx.x / BS_WARP;
  if (g >= batch * chunk) return;          // a whole warp
  const int lane = threadIdx.x % BS_WARP;
  const int b = g / chunk;

  const int32_t* meta_lane = meta + (int64_t)b * BS_META_ROWS * ncols;
  const BsMetaLane r = bs_meta_lane(meta_lane, ncols, tf_planes, n_terms,
                                    lane);
  const uint32_t valid = __ballot_sync(BS_FULL_MASK, r.valid);
  const uint32_t req_mask = __ballot_sync(BS_FULL_MASK, r.req);
  const int blk = bs_chunk_block(r.start, g % chunk, nb);
  const uint32_t* occ_blk = occ + ((int64_t)b * nb + blk) * tf_planes * W;
  const BsWarpFinish finish{v_inc + g, n_match + g, lane};
  if (MANY) {
    const int n_active = bs_count_active(valid, tf_planes, [&](int s0) {
      return __ballot_sync(
          BS_FULL_MASK, bs_step_valid(meta_lane, ncols, tf_planes, s0 + lane));
    });
    bs_warp_block<VEC>(occ_blk, match + (int64_t)g * W, W, lane,
                       BsStep{r.plane, meta_lane, tf_planes, W},
                       BsStep{r.term, meta_lane + ncols, tf_planes, 1},
                       n_active, req_mask, n_terms, finish);
  } else {
    // One block a warp: one round of all 16 slots.
    bs_warp_blocks<BS_SLOTS, VEC>(occ_blk, match + (int64_t)g * W, 0, 1,
                                  tf_planes, W, lane, BsShfl{r.plane * W},
                                  BsShfl{r.term}, bs_leading_ones(valid),
                                  req_mask, n_terms, finish);
  }
}

// Plain C entry point for ctypes.  Takes the 16-byte path where
// bs_vector_path allows it, else the scalar path, and the plane-group
// loop only where T*F asks for it (bs_many_planes).  Launches on the
// given stream and returns cudaGetLastError() (0 on success).
extern "C" int block_scan_pruned_chunk_launch(
    const void* occ, const void* meta, void* match, void* v_inc,
    void* n_match, int batch, int nb, int tf_planes, int W, int ncols,
    int n_terms, int chunk, void* stream) {
  const long long pairs = (long long)batch * chunk;
  const unsigned blocks =
      (unsigned)((pairs + BS_CHUNK_WARPS - 1) / BS_CHUNK_WARPS);
  const int threads = BS_CHUNK_WARPS * BS_WARP;
  const bool vec = bs_vector_path(W, (uintptr_t)occ, (uintptr_t)match);
  auto kernel = bs_many_planes(tf_planes)
                    ? (vec ? block_scan_pruned_chunk_kernel<true, true>
                           : block_scan_pruned_chunk_kernel<false, true>)
                    : (vec ? block_scan_pruned_chunk_kernel<true, false>
                           : block_scan_pruned_chunk_kernel<false, false>);
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)occ, (const int32_t*)meta, (uint32_t*)match,
      (int32_t*)v_inc, (int32_t*)n_match, batch, nb, tf_planes, W, ncols,
      n_terms, chunk);
  return (int)cudaGetLastError();
}
