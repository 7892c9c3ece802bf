// The rule kernel's core (block_scan_rule.cu): one query lane's whole
// rule execution (paper §3), from its entry state to the state at which
// its stopping condition fails, in one CTA.
//
// Shared by the CUDA kernel and by the g++ host harness of the CPU tests,
// which replays the CTA round by round, warp by warp and thread by
// thread: the plane slots, the per-block scan and dedup, the stop, the
// candidate slots, the matched words and the thread-local top-n below
// are the kernel's own.  Only the ballots, the shuffles, the barriers
// and the atomic OR are CUDA-only; the harness takes a ballot as the OR
// of its replayed lanes' votes, a warp sum by adding the lanes' shares,
// the CTA's exclusive prefix by adding in thread order, and the top-n
// merge of the threads' lists by inserting them one after another (the
// same values: a top-n holds values, not positions).
//
// A round.  BS_RULE_WARPS warps take the blocks bp .. bp + 7 ahead of the
// lane's state, a block a warp, speculatively: a warp loads its block
// only if the condition can still hold there with v at the round's
// start (v only grows, so that is every block the lane may scan).  Each
// warp ORs its block's active planes per term, ANDs the required terms
// (bs_lane_or, bs_lane_match of block_scan_warp.cuh), drops the bits the
// lane's matched already holds (its old words are loaded with the
// planes), keeps the new words in shared memory and sums v_inc.  Then
// every thread finds the same stop from the warps' v_inc (bs_rule_stop),
// takes a contiguous run of the scanned blocks' new words (bs_warp_span
// over the CTA's threads), and from a CTA-wide exclusive prefix of the
// runs' popcounts writes its bits' documents into cand in scan order
// (slots at K or past dropped), ORs its words into matched and keeps the
// scores above the round's n-th best in a list of its own, which the CTA
// merges into topn.  A top-n longer than BS_RULE_MAX_TOP does not fit a
// thread's registers: it stays in the lane's topn row in device memory,
// and one thread inserts the round's new scores above its n-th there, in
// scan order (bs_rule_merge_long).  The lane loops until its condition
// fails; no value goes to the host.  A rule with no active plane reads nothing and
// changes nothing but the block pointer, so the lane jumps to nb.
#pragma once

#include <math.h>

#include "block_scan_warp.cuh"

#define BS_RULE_WARPS 8                              // blocks a round
#define BS_RULE_THREADS (BS_RULE_WARPS * BS_WARP)
#define BS_RULE_MAX_PLANES 64                        // T*F: two ballots
#define BS_RULE_SLOT_ROWS (BS_RULE_MAX_PLANES + BS_SLOTS)
#define BS_RULE_MAX_TOP 8      // n_top kept in registers; longer: memory

// One lane's state through the rule execution: the same in every thread
// of its CTA (each computes it from the same shared values).
struct BsRuleState {
  int32_t bp, u, v, cnt;   // block_ptr, u, v, cand_cnt
  int32_t u0, v0;          // u and v at entry
  int32_t du, dv;          // the quotas
  bool done;
};

// Whether block bp + j is scanned, v_before being the lane's v before it:
// the §3 condition at the state before block j.
__host__ __device__ inline bool bs_rule_scans(const BsRuleState& s, int j,
                                              int32_t v_before, int u_inc,
                                              int nb, int u_budget) {
  const int32_t u_before = s.u + j * u_inc;
  return u_before - s.u0 < s.du && v_before - s.v0 < s.dv && s.bp + j < nb &&
         u_before < u_budget && !s.done;
}

// The blocks of a round that the lane scans: the leading j <
// BS_RULE_WARPS whose condition holds, v_inc[j] being block bp + j's
// increment (0 for a block no warp loaded: its condition fails with v
// at the round's start already); *v_end gets v after them.
__host__ __device__ inline int bs_rule_stop(const BsRuleState& s,
                                            const int32_t* v_inc, int u_inc,
                                            int nb, int u_budget,
                                            int32_t* v_end) {
  int32_t v = s.v;
  int j = 0;
  for (; j < BS_RULE_WARPS && bs_rule_scans(s, j, v, u_inc, nb, u_budget); ++j)
    v += v_inc[j];
  *v_end = v;
  return j;
}

// A plane list kept in shared memory (a plain array in the harness):
// slot s's word offset in a block (plane id * W) or its term.
struct BsRuleSlots {
  const int32_t* v;
  __host__ __device__ int operator[](int s) const { return v[s]; }
};

// One warp's block of a round, seen by lane `lane`: strip by strip, the
// lane's words of the block's old matched row and of its active planes
// (in groups of BS_SLOTS rows, every row of a group loaded before the
// first is used), their match words less the old bits written to
// new_row.  Returns the lane's share of the block's v_inc.
BS_HD_TEMPLATE
template <bool VEC>
__host__ __device__ inline int bs_rule_block(
    const uint32_t* occ_blk, const uint32_t* old_row, uint32_t* new_row,
    int W, int lane, const BsRuleSlots& off, const BsRuleSlots& term,
    int n_active, uint32_t req_mask, int n_terms) {
  int v_acc = 0, m_acc = 0;
  for (int st = 0; st < bs_n_strips(W); ++st) {
    // A lane's matched words are read once a launch, before any write to
    // them (each round's blocks lie past the last round's).
    const BsLane old = bs_load_lane<VEC>(old_row, st, lane, W, true);
    uint32_t tf[BS_MAX_TERMS][4] = {};
    int g = 0;
    do {
      BsLane x[BS_SLOTS];
#pragma unroll
      for (int s = 0; s < BS_SLOTS; ++s)
        x[s] = bs_load_lane<VEC>(occ_blk + off[g + s], st, lane, W,
                                 g + s < n_active);
      bs_lane_or<BS_SLOTS>(x, term, g, tf);
      g += BS_SLOTS;
    } while (g < n_active);
    BsLane m;
    bs_lane_match(tf, req_mask, n_terms, &m, &v_acc, &m_acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int w = bs_lane_word(st, lane, j, VEC);
      if (w < W) new_row[w] = m.w[j] & ~old.w[j];
    }
  }
  return v_acc;
}

// A float above another in torch.topk's order: NaN above every number.
__host__ __device__ inline bool bs_above(float x, float y) {
  return x > y || (x != x && y == y);
}

// Inserts x into a list of n <= BS_RULE_MAX_TOP values in descending
// order, the smallest dropping out; a value not above the n-th leaves
// the values as they were.  The loop is unrolled, so the list stays in
// registers.
__host__ __device__ inline void bs_top_insert(float* top, int n, float x) {
#pragma unroll
  for (int i = 0; i < BS_RULE_MAX_TOP; ++i) {
    if (i < n && bs_above(x, top[i])) {
      const float t = top[i];
      top[i] = x;
      x = t;
    }
  }
}

// bs_top_insert for a list of any length n, kept in memory.
__host__ __device__ inline void bs_top_insert_long(float* top, int n,
                                                   float x) {
  if (!bs_above(x, top[n - 1])) return;
  int i = n - 1;
  for (; i > 0 && bs_above(x, top[i - 1]); --i) top[i] = top[i - 1];
  top[i] = x;
}

// The OR of a thread's new bits into the lane's matched word: a reduction
// in memory on the card, which the thread does not wait for.
__host__ __device__ inline void bs_or_word(uint32_t* p, uint32_t x) {
#ifdef __CUDA_ARCH__
  atomicOr(p, x);
#else
  *p |= x;
#endif
}

__host__ __device__ inline int bs_rule_count(const uint32_t* words, int lo,
                                             int hi) {
  int c = 0;
  for (int w = lo; w < hi; ++w) c += bs_popc(words[w]);
  return c;
}

// A thread's words [lo, hi) of the round's new words (the scanned blocks
// in scan order, word w of the round being word w of matched_round): the
// document of each set bit, in order, goes to cand from slot `first` on
// (slots at K or past are dropped), the words are OR-ed into matched, and
// each document's score above `thr` goes into the thread's top list.
// Returns whether any score did.  Documents are doc0 + 32 w + bit; a
// score index past the scores row reads its last element.
__host__ __device__ inline bool bs_rule_emit(
    const uint32_t* new_words, int lo, int hi, int32_t first, int K,
    int64_t doc0, uint32_t* matched_round, int32_t* cand,
    const float* scores_row, int64_t n_pad, float thr, float* top,
    int n_top) {
  int32_t pos = first;
  bool any = false;
  for (int w = lo; w < hi; ++w) {
    uint32_t x = new_words[w];
    if (x == 0u) continue;
    bs_or_word(matched_round + w, x);
    while (x != 0u) {
#ifdef __CUDA_ARCH__
      const int bit = __ffs(x) - 1;
#else
      const int bit = __builtin_ctz(x);
#endif
      x &= x - 1u;
      const int64_t doc = doc0 + 32 * (int64_t)w + bit;
      if (pos < K) cand[pos] = (int32_t)doc;
      ++pos;
      const float sc = scores_row[doc < n_pad - 1 ? doc : n_pad - 1];
      if (bs_above(sc, thr)) {
        bs_top_insert(top, n_top, sc);
        any = true;
      }
    }
  }
  return any;
}

// The lane's state after a round of n scanned blocks holding n_new new
// documents.
__host__ __device__ inline void bs_rule_advance(BsRuleState* s, int n,
                                                int u_inc, int32_t v_end,
                                                int n_new, int K) {
  s->bp += n;
  s->u += n * u_inc;
  s->v = v_end;
  s->cnt = s->cnt + n_new < K ? s->cnt + n_new : K;
}

// The round's new words [0, n_words) in scan order, each document's score
// inserted into a top-n list of any length (one thread's merge for
// n_top > BS_RULE_MAX_TOP).  Documents and scores as in bs_rule_emit.
__host__ __device__ inline void bs_rule_merge_long(
    const uint32_t* new_words, int n_words, int64_t doc0,
    const float* scores_row, int64_t n_pad, float* top, int n_top) {
  for (int w = 0; w < n_words; ++w) {
    uint32_t x = new_words[w];
    while (x != 0u) {
#ifdef __CUDA_ARCH__
      const int bit = __ffs(x) - 1;
#else
      const int bit = __builtin_ctz(x);
#endif
      x &= x - 1u;
      const int64_t doc = doc0 + 32 * (int64_t)w + bit;
      bs_top_insert_long(top, n_top,
                         scores_row[doc < n_pad - 1 ? doc : n_pad - 1]);
    }
  }
}
