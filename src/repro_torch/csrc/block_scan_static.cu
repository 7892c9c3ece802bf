// Whole-index plane-pruned block scan under a static rule, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel block_scan_pruned_pallas
// (src/repro/kernels/block_scan/block_scan_pruned.py, _kernel): the
// same function as block_scan_tile.cu for one query, with the rule
// fixed on the host.  The wrapper turns the rule into its active-plane
// list on the host, as the TPU kernel does at trace time, and it
// reaches the kernel by value, as a BsStaticRule kernel parameter: no
// meta tensor and no host-to-device copy.  A rule with no active plane
// reads nothing (match = 0, v_inc = 0).
//
// What bounds it on an H100: memory, n_active * W * 4 bytes read per
// block.  The TPU kernel's grid (nb, n_active) walks the planes one
// step at a time into a VMEM scratch; here one CTA takes a tile of bb
// consecutive blocks, copies the plane list into shared memory, and
// each thread owns one word of every block of the tile, with the
// active planes of a word loaded together (block_scan.cuh).
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan.cuh"

__global__ void block_scan_static_kernel(
    const uint32_t* __restrict__ occ,     // (nb, tf_planes, W)
    uint32_t* __restrict__ match,         // (nb, W)
    int32_t* __restrict__ v_inc,          // (nb,)
    int32_t* __restrict__ n_match,        // (nb,)
    const BsStaticRule rule, int nb, int tf_planes, int W, int n_terms,
    int bb) {
  const int b0 = blockIdx.x * bb;

  __shared__ int32_t s_plane[BS_MAX_PLANES];
  __shared__ int32_t s_term[BS_MAX_PLANES];
  __shared__ int32_t s_req[BS_MAX_TERMS];
  if (threadIdx.x < BS_MAX_PLANES) {
    s_plane[threadIdx.x] = rule.plane_ids[threadIdx.x];
    s_term[threadIdx.x] = rule.term_ids[threadIdx.x];
  }
  if (threadIdx.x < BS_MAX_TERMS) s_req[threadIdx.x] = rule.req[threadIdx.x];
  __syncthreads();

  bs_scan_blocks(occ, match, v_inc, n_match, b0, min(bb, nb - b0),
                 tf_planes, W, s_plane, s_term, rule.n_active, s_req,
                 n_terms);
}

// Plain C entry point for ctypes.  plane_ids, term_ids (n_active each)
// and req (n_terms) are HOST arrays; they are copied into the kernel's
// parameter struct.  Launches on the given stream and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a
// plane list longer than BS_MAX_PLANES or a tile outside [1, BS_MAX_BB].
extern "C" int block_scan_static_launch(const void* occ, void* match,
                                        void* v_inc, void* n_match,
                                        const int32_t* plane_ids,
                                        const int32_t* term_ids, int n_active,
                                        const int32_t* req, int nb,
                                        int tf_planes, int W, int n_terms,
                                        int bb, void* stream) {
  if (n_active < 0 || n_active > BS_MAX_PLANES || n_terms > BS_MAX_TERMS ||
      bb < 1 || bb > BS_MAX_BB)
    return (int)cudaErrorInvalidValue;
  const BsStaticRule rule =
      bs_static_rule(plane_ids, term_ids, n_active, req, n_terms);
  const int threads = ((W + 31) / 32) * 32;
  const unsigned blocks = (unsigned)((nb + bb - 1) / bb);
  block_scan_static_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)occ, (uint32_t*)match, (int32_t*)v_inc,
      (int32_t*)n_match, rule, nb, tf_planes, W, n_terms, bb);
  return (int)cudaGetLastError();
}
