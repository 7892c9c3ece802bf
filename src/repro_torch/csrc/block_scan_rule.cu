// One rule execution (paper §3) for every query lane in one launch, for
// Hopper (sm_90a): the "block_scan" scan backend's route on the card.
//
// For each of B lanes, with its own rule (the caller's bool tensors
// allowed (B, T, F), required (B, T), present (B, T)) and quotas, it
// scans index blocks from the lane's block pointer while
//   u - u0 < du  and  v - v0 < dv  and  bp < nb  and  u < u_budget
//   and not done
// holds before the block, reading only the rule's active planes; it ORs
// each scanned block's matching documents that the lane had not matched
// yet into matched (in place), appends them to cand in scan order (at
// most K), merges their scores into topn and advances bp, u and v.  The
// state it ends at is the one the host loop over the chunk kernel
// (block_scan.cu and core/scan_backends.py) ends at, bit for bit.
//
// What bounds it on an H100: latency.  A call of 256 lanes reads a few
// MB of plane rows; what costs is the chain of dependent round trips in
// each lane's loop, so a round takes 8 blocks at once and has two of
// them: the plane rows with the old matched words, then the scores of
// the new documents.  Design (block_scan_rule.cuh): one CTA of
// BS_RULE_WARPS warps per lane; warp 0 turns the lane's rule into a
// plane list by ballots in shared memory; each round a warp scans one
// block on the warp core of block_scan_warp.cuh (16 bytes a lane where
// bs_vector_path allows) and keeps its new words in shared memory; the
// stop comes from the warps' v_inc, the candidate slots from a CTA-wide
// prefix (warp shuffles, then the warps' totals), the top-n from the
// threads' own lists merged by warp shuffles (a top-n longer than
// BS_RULE_MAX_TOP: one thread's merge in the lane's topn row, rare and
// slow, but any n_top is taken).  Nothing crosses lanes,
// so the grid has no order; nothing goes to the host.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_scan_rule.cuh"

// The CTA's exclusive prefix of c in thread order, and its total.
__device__ inline int bs_cta_exclusive(int c, int warp, int lane,
                                       int32_t* s_wsum, int* total) {
  int inc = c;
#pragma unroll
  for (int off = 1; off < BS_WARP; off <<= 1) {
    const int y = __shfl_up_sync(BS_FULL_MASK, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == BS_WARP - 1) s_wsum[warp] = inc;
  __syncthreads();
  int base = 0, all = 0;
#pragma unroll
  for (int w = 0; w < BS_RULE_WARPS; ++w) {
    const int x = s_wsum[w];
    if (w < warp) base += x;
    all += x;
  }
  *total = all;
  return base + inc - c;
}

// Pops the warp's largest list head n times into out[0..n) (lane 0
// writes): each lane holds a descending list of BS_RULE_MAX_TOP values;
// ties go to the lower lane, so every lane agrees on the winner.
__device__ inline void bs_warp_top(float* top, int n, int lane, float* out) {
  for (int k = 0; k < n; ++k) {
    float x = top[0];
    int who = lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float y = __shfl_xor_sync(BS_FULL_MASK, x, off);
      const int w = __shfl_xor_sync(BS_FULL_MASK, who, off);
      if (bs_above(y, x) || (!bs_above(x, y) && w < who)) {
        x = y;
        who = w;
      }
    }
    if (lane == 0) out[k] = x;
    if (lane == who) {
#pragma unroll
      for (int i = 0; i + 1 < BS_RULE_MAX_TOP; ++i) top[i] = top[i + 1];
      top[BS_RULE_MAX_TOP - 1] = -INFINITY;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(BS_RULE_THREADS)
    block_scan_pruned_chunk_rule_kernel(
        const uint32_t* __restrict__ occ,       // (B, nb, tf_planes, W)
        const uint8_t* __restrict__ allowed,    // (B, T, F) bool
        const uint8_t* __restrict__ required,   // (B, T) bool
        const uint8_t* __restrict__ present,    // (B, T) bool
        const float* __restrict__ scores,       // (B, n_pad)
        const int32_t* __restrict__ du,         // (B,)
        const int32_t* __restrict__ dv,         // (B,)
        const int32_t* __restrict__ bp_in,      // (B,)
        const int32_t* __restrict__ u_in,       // (B,)
        const int32_t* __restrict__ v_in,       // (B,)
        const int32_t* __restrict__ cnt_in,     // (B,)
        const uint8_t* __restrict__ done,       // (B,) bool
        const int32_t* __restrict__ cand_in,    // (B, K)
        const float* __restrict__ topn_in,      // (B, n_top)
        uint32_t* __restrict__ matched,         // (B, nb * W), OR-ed in place
        int32_t* __restrict__ small_out,        // (4, B): bp, u, v, cand_cnt
        int32_t* __restrict__ cand_out,         // (B, K)
        float* __restrict__ topn_out,           // (B, n_top)
        int batch, int nb, int tf_planes, int F, int W, int n_terms,
        int64_t n_pad, int K, int n_top, int u_budget) {
  extern __shared__ uint4 bs_rule_smem[];
  uint32_t* s_new = reinterpret_cast<uint32_t*>(bs_rule_smem);  // (8, W)
  __shared__ int32_t s_off[BS_RULE_SLOT_ROWS];
  __shared__ int32_t s_term[BS_RULE_SLOT_ROWS];
  __shared__ int32_t s_vinc[BS_RULE_WARPS];
  __shared__ int32_t s_wsum[BS_RULE_WARPS];
  __shared__ float s_top[BS_RULE_MAX_TOP];
  __shared__ float s_wtop[BS_RULE_WARPS * BS_RULE_MAX_TOP];
  __shared__ int32_t s_rule[2];                // n_active, required mask

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / BS_WARP;
  const int lane = tid % BS_WARP;

  BsRuleState s;
  s.bp = bp_in[b];
  s.u = s.u0 = u_in[b];
  s.v = s.v0 = v_in[b];
  s.cnt = cnt_in[b];
  s.du = du[b];
  s.dv = dv[b];
  s.done = done[b] != 0;
  const int32_t* cin = cand_in + (int64_t)b * K;
  int32_t* cout = cand_out + (int64_t)b * K;
  for (int i = tid; i < K; i += BS_RULE_THREADS) cout[i] = cin[i];
  // The lane's top-n: in shared memory, or past BS_RULE_MAX_TOP in its
  // topn_out row, where thread 0 alone writes it after the copy.
  const bool long_top = n_top > BS_RULE_MAX_TOP;
  float* top_lane = long_top ? topn_out + (int64_t)b * n_top : s_top;
  for (int i = tid; i < n_top; i += BS_RULE_THREADS)
    top_lane[i] = topn_in[(int64_t)b * n_top + i];

  // The plane list: slot s holds the s-th active plane (ascending, as
  // build_rule_meta lists them) as its word offset in a block and its
  // term; the slots after the last stay 0, since a group of BS_SLOTS
  // reads a term up to BS_SLOTS slots past n_active.
  if (warp == 0) {
    const uint8_t* a = allowed + (int64_t)b * tf_planes;
    const uint8_t* p = present + (int64_t)b * n_terms;
    for (int i = lane; i < BS_RULE_SLOT_ROWS; i += BS_WARP) {
      s_off[i] = 0;
      s_term[i] = 0;
    }
    __syncwarp();
    int n_active = 0;
    for (int g = 0; g < tf_planes; g += BS_WARP) {
      const bool vote = bs_plane_vote(a, p, tf_planes, F, g + lane);
      const uint32_t mask = __ballot_sync(BS_FULL_MASK, vote);
      if (vote) {
        const int slot = n_active + bs_rank(mask, lane);
        s_off[slot] = (g + lane) * W;
        s_term[slot] = (g + lane) / F;
      }
      n_active += bs_popc(mask);
    }
    const uint32_t req_mask = __ballot_sync(
        BS_FULL_MASK,
        bs_req_vote(required + (int64_t)b * n_terms, p, n_terms, lane));
    if (lane == 0) {
      s_rule[0] = n_active;
      s_rule[1] = (int32_t)req_mask;
    }
  }
  __syncthreads();
  const int u_inc = s_rule[0];
  const uint32_t req_mask = (uint32_t)s_rule[1];

  if (u_inc == 0) {
    // No plane: every block to the end matches nothing and adds nothing.
    if (bs_rule_scans(s, 0, s.v, 0, nb, u_budget)) s.bp = nb;
  } else {
    const uint32_t* occ_lane = occ + (int64_t)b * nb * tf_planes * W;
    uint32_t* matched_lane = matched + (int64_t)b * nb * W;
    const float* scores_lane = scores + (int64_t)b * n_pad;
    const BsRuleSlots off{s_off}, term{s_term};
    while (bs_rule_scans(s, 0, s.v, u_inc, nb, u_budget)) {
      int32_t vj = 0;
      if (bs_rule_scans(s, warp, s.v, u_inc, nb, u_budget)) {
        const int64_t blk = s.bp + warp;
        vj = bs_warp_sum(bs_rule_block<VEC>(
            occ_lane + blk * tf_planes * W, matched_lane + blk * W,
            s_new + warp * W, W, lane, off, term, u_inc, req_mask, n_terms));
      }
      if (lane == 0) s_vinc[warp] = vj;
      __syncthreads();

      int32_t v_end;
      const int n = bs_rule_stop(s, s_vinc, u_inc, nb, u_budget, &v_end);
      int lo, len;
      bs_warp_span(n * W, tid, BS_RULE_THREADS, &lo, &len);
      int n_new;
      const int first = s.cnt + bs_cta_exclusive(
          bs_rule_count(s_new, lo, lo + len), warp, lane, s_wsum, &n_new);
      float top[BS_RULE_MAX_TOP];
#pragma unroll
      for (int i = 0; i < BS_RULE_MAX_TOP; ++i) top[i] = -INFINITY;
      const int64_t doc0 = (int64_t)s.bp * W * 32;
      const bool any = bs_rule_emit(
          s_new, lo, lo + len, first, K, doc0,
          matched_lane + (int64_t)s.bp * W, cout, scores_lane, n_pad,
          top_lane[n_top - 1], top, long_top ? 0 : n_top);
      if (__syncthreads_or(any)) {
        if (long_top) {
          if (tid == 0)
            bs_rule_merge_long(s_new, n * W, doc0, scores_lane, n_pad,
                               top_lane, n_top);
        } else {
          bs_warp_top(top, n_top, lane, s_wtop + warp * BS_RULE_MAX_TOP);
          __syncthreads();
          if (warp == 0) {
#pragma unroll
            for (int i = 0; i < BS_RULE_MAX_TOP; ++i) {
              const bool in = i < n_top;
              top[i] = !in ? -INFINITY
                       : lane < BS_RULE_WARPS
                           ? s_wtop[lane * BS_RULE_MAX_TOP + i]
                           : lane == BS_RULE_WARPS ? s_top[i] : -INFINITY;
            }
            __syncwarp();
            bs_warp_top(top, n_top, lane, s_top);
          }
        }
        __syncthreads();
      }
      bs_rule_advance(&s, n, u_inc, v_end, n_new, K);
    }
  }

  if (tid == 0) {
    small_out[b] = s.bp;
    small_out[batch + b] = s.u;
    small_out[2 * batch + b] = s.v;
    small_out[3 * batch + b] = s.cnt;
  }
  if (!long_top && tid < n_top)
    topn_out[(int64_t)b * n_top + tid] = s_top[tid];
}

// Plain C entry point for ctypes: one CTA per lane, the 16-byte path
// where bs_vector_path allows it (occupancy and matched), else the
// scalar path, BS_RULE_WARPS * W words of shared memory for the round's
// new words.  Launches on the given stream and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a
// shape the kernel does not take.
extern "C" int block_scan_pruned_chunk_rule_launch(
    const void* occ, const void* allowed, const void* required,
    const void* present, const void* scores, const void* du, const void* dv,
    const void* bp_in, const void* u_in, const void* v_in, const void* cnt_in,
    const void* done, const void* cand_in, const void* topn_in,
    void* matched, void* small_out, void* cand_out, void* topn_out,
    int batch, int nb, int tf_planes, int F, int W, int n_terms,
    long long n_pad, int K, int n_top, int u_budget, void* stream) {
  if (batch < 1 || tf_planes > BS_RULE_MAX_PLANES || n_terms > BS_MAX_TERMS ||
      n_top < 1 || W < 1 ||
      W > BS_STRIP_WORDS * 8 || n_pad < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)BS_RULE_WARPS * W * sizeof(uint32_t);
  auto kernel = bs_vector_path(W, (uintptr_t)occ, (uintptr_t)matched)
                    ? block_scan_pruned_chunk_rule_kernel<true>
                    : block_scan_pruned_chunk_rule_kernel<false>;
  kernel<<<(unsigned)batch, BS_RULE_THREADS, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)occ, (const uint8_t*)allowed, (const uint8_t*)required,
      (const uint8_t*)present, (const float*)scores, (const int32_t*)du,
      (const int32_t*)dv, (const int32_t*)bp_in, (const int32_t*)u_in,
      (const int32_t*)v_in, (const int32_t*)cnt_in, (const uint8_t*)done,
      (const int32_t*)cand_in, (const float*)topn_in, (uint32_t*)matched,
      (int32_t*)small_out, (int32_t*)cand_out, (float*)topn_out, batch, nb,
      tf_planes, F, W, n_terms, (int64_t)n_pad, K, n_top, u_budget);
  return (int)cudaGetLastError();
}
