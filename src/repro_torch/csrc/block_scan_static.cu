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
// step at a time into a VMEM scratch.  Here (block_scan_warp.cuh, the
// tile and chunk kernels' core) one CTA of BS_STATIC_WARPS warps takes a
// tile of bb consecutive blocks and each warp a contiguous run of them:
// a lane moves 16 bytes of each plane row per load, every active plane
// of a round's blocks is loaded before the first is used (the deepest
// rule's 16 rows of one block, a shallow rule's rows of several), the
// popcount sums are warp shuffles and match leaves in 16-byte streaming
// stores.  The plane list comes from the kernel parameter into
// registers, so a warp's first instruction of substance is an occupancy
// load: no ballot, no shared memory, no barrier.  The host knows the
// rule, so it picks the kernel built for the rule's slot width
// (registers for exactly that many plane rows) and the tile
// (static_tile in block_scan_pruned.py: one round a warp at 4096
// blocks).  The scalar path of the same kernel runs where
// bs_vector_path says so.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan_warp.cuh"

#define BS_STATIC_WARPS 4          // warps per CTA
#define BS_STATIC_MAX_BLOCKS 64    // blocks per CTA: a round of 16 a warp

template <int NP, bool VEC>
__global__ void __launch_bounds__(BS_STATIC_WARPS * BS_WARP)
    block_scan_static_kernel(
        const uint32_t* __restrict__ occ,     // (nb, tf_planes, W)
        uint32_t* __restrict__ match,         // (nb, W)
        int32_t* __restrict__ v_inc,          // (nb,)
        int32_t* __restrict__ n_match,        // (nb,)
        const BsStaticRule rule, int nb, int tf_planes, int W, int n_terms,
        int bb) {
  const int warp = threadIdx.x / BS_WARP;
  const int lane = threadIdx.x % BS_WARP;
  const int b0 = blockIdx.x * bb;
  int first, count;
  bs_warp_span(min(bb, nb - b0), warp, BS_STATIC_WARPS, &first, &count);
  if (count == 0) return;
  BsSlots off, term;
  bs_static_slots(rule, W, &off, &term);
  bs_warp_blocks<NP, VEC>(occ, match, b0 + first, count, tf_planes, W, lane,
                          off, term, rule.n_active, rule.req_mask, n_terms,
                          BsWarpFinish{v_inc, n_match, lane});
}

typedef void (*BsStaticKernel)(const uint32_t*, uint32_t*, int32_t*,
                               int32_t*, const BsStaticRule, int, int, int,
                               int, int);

// The kernel built for n_active's slot width.
template <bool VEC>
static BsStaticKernel bs_static_kernel(int n_active) {
  switch (bs_slot_width(n_active)) {
    case 1: return block_scan_static_kernel<1, VEC>;
    case 2: return block_scan_static_kernel<2, VEC>;
    case 4: return block_scan_static_kernel<4, VEC>;
    case 8: return block_scan_static_kernel<8, VEC>;
    default: return block_scan_static_kernel<16, VEC>;
  }
}

// Plain C entry point for ctypes.  plane_ids, term_ids (n_active each)
// and req (n_terms) are HOST arrays; they are copied into the kernel's
// parameter struct.  Takes the 16-byte path where bs_vector_path allows
// it, else the scalar path, at the slot width of n_active.  Launches on
// the given stream and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a plane list longer than BS_MAX_PLANES or a
// tile outside [1, BS_STATIC_MAX_BLOCKS].
extern "C" int block_scan_static_launch(const void* occ, void* match,
                                        void* v_inc, void* n_match,
                                        const int32_t* plane_ids,
                                        const int32_t* term_ids, int n_active,
                                        const int32_t* req, int nb,
                                        int tf_planes, int W, int n_terms,
                                        int bb, void* stream) {
  if (n_active < 0 || n_active > BS_MAX_PLANES || n_terms > BS_MAX_TERMS ||
      bb < 1 || bb > BS_STATIC_MAX_BLOCKS)
    return (int)cudaErrorInvalidValue;
  const BsStaticRule rule =
      bs_static_rule(plane_ids, term_ids, n_active, req, n_terms);
  auto kernel = bs_vector_path(W, (uintptr_t)occ, (uintptr_t)match)
                    ? bs_static_kernel<true>(n_active)
                    : bs_static_kernel<false>(n_active);
  const unsigned blocks = (unsigned)((nb + bb - 1) / bb);
  kernel<<<blocks, BS_STATIC_WARPS * BS_WARP, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)occ, (uint32_t*)match, (int32_t*)v_inc,
      (int32_t*)n_match, rule, nb, tf_planes, W, n_terms, bb);
  return (int)cudaGetLastError();
}
