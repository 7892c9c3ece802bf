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
// What bounds it on an H100: memory.  It does a handful of integer
// operations per word read, far below the card's op/byte balance, and
// reads n_active * W * 4 bytes per lane-block: only the rule's active
// (term, field) planes, so bytes read stay proportional to the paper's
// cost u, as in the TPU kernel.  Design: one CUDA block per
// (lane, chunk position); each thread owns one 32-bit word of the
// block, so every plane is one coalesced W-word row read.  The TPU
// kernel's sequential plane axis with a VMEM scratch becomes a loop
// inside the thread over the active planes (stopping at the first
// invalid step); nothing carries over between blocks.  Popcounts are
// summed with warp shuffles, then across warps in shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

__global__ void block_scan_pruned_chunk_kernel(
    const uint32_t* __restrict__ occ,     // (B, nb, tf_planes, W)
    const int32_t* __restrict__ meta,     // (B, 4, ncols)
    uint32_t* __restrict__ match,         // (B, chunk, W)
    int32_t* __restrict__ v_inc,          // (B, chunk)
    int32_t* __restrict__ n_match,        // (B, chunk)
    int nb, int tf_planes, int W, int ncols, int n_terms, int chunk) {
  const int lane = blockIdx.x / chunk;
  const int c = blockIdx.x % chunk;
  const int w = threadIdx.x;

  const int32_t* meta_lane = meta + (int64_t)lane * BS_META_ROWS * ncols;
  const int bp = meta_lane[ncols - 1];
  const int blk = min(bp + c, nb - 1);
  const uint32_t* occ_block =
      occ + ((int64_t)lane * nb + blk) * tf_planes * W;

  int v_pop = 0, m_pop = 0;
  if (w < W) {
    const BsWord r =
        bs_eval_word(occ_block, meta_lane, ncols, tf_planes, W, w, n_terms);
    match[(int64_t)blockIdx.x * W + w] = r.match;
    v_pop = r.v_pop;
    m_pop = r.match_pop;
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v_pop += __shfl_down_sync(0xFFFFFFFFu, v_pop, off);
    m_pop += __shfl_down_sync(0xFFFFFFFFu, m_pop, off);
  }
  __shared__ int s_v[32];
  __shared__ int s_m[32];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s_v[warp] = v_pop;
    s_m[warp] = m_pop;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int tv = 0, tm = 0;
    const int n_warps = blockDim.x >> 5;
    for (int i = 0; i < n_warps; ++i) {
      tv += s_v[i];
      tm += s_m[i];
    }
    v_inc[blockIdx.x] = tv;
    n_match[blockIdx.x] = tm;
  }
}

// Plain C entry point for ctypes.  Launches on the given stream and
// returns cudaGetLastError() (0 on success).
extern "C" int block_scan_pruned_chunk_launch(
    const void* occ, const void* meta, void* match, void* v_inc,
    void* n_match, int batch, int nb, int tf_planes, int W, int ncols,
    int n_terms, int chunk, void* stream) {
  const int threads = ((W + 31) / 32) * 32;
  const unsigned blocks = (unsigned)batch * (unsigned)chunk;
  block_scan_pruned_chunk_kernel<<<blocks, threads, 0,
                                   (cudaStream_t)stream>>>(
      (const uint32_t*)occ, (const int32_t*)meta, (uint32_t*)match,
      (int32_t*)v_inc, (int32_t*)n_match, nb, tf_planes, W, ncols, n_terms,
      chunk);
  return (int)cudaGetLastError();
}
