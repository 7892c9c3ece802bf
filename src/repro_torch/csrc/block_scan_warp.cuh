// Warp-per-block core of the three block scans (block_scan_tile.cu,
// block_scan.cu, block_scan_static.cu).
//
// Shared by the CUDA kernels and by the g++ host harnesses of the CPU
// tests, which replay the three grids warp by warp and lane by lane: the
// word ownership, the plane lists built from ballots or taken from the
// static rule, the slot plan, the strip walk and the per-lane arithmetic
// below are the kernels' own.
// Only the 16-byte loads and stores, the ballots and the shuffles are
// CUDA-only; a harness computes a ballot over its 32 replayed lanes and
// a warp sum by adding the lanes' shares.
//
// Word ownership.  A warp covers a block's W words in strips of
// BS_STRIP_WORDS = 128 words, four words a lane:
//   16-byte path: lane l owns words 4l .. 4l+3 of the strip, one uint4,
//                 so one warp instruction moves a whole 512-byte strip
//                 of a plane row;
//   scalar path:  lane l owns words l, l+32, l+64, l+96, each a
//                 coalesced 128-byte warp load; taken for W % 4 != 0 or
//                 an occupancy or match pointer that is not 16-byte
//                 aligned (bs_vector_path, the launch entries' choice).
// Words at or past W are neither read nor written.
//
// Plane slots.  A lane holds BS_SLOTS plane rows of its words in
// registers, and all of them are loaded before the first is used:
//   np  = bs_slot_width(n_active): slots per block, a power of two
//         >= n_active (1 for a rule with no active plane);
//   BS_SLOTS / np blocks (or strips, for W > 128) per round.
// So a shallow rule (2 planes) keeps 8 blocks' rows in flight per warp
// and the deepest (16 planes) one block's 16 rows.  Only active planes
// are read: bytes read stay n_active * W * 4 per block.
#pragma once

#include "block_scan.cuh"

#define BS_WARP 32
#define BS_STRIP_WORDS 128  // words of a block a warp covers per step
#define BS_SLOTS 16         // plane rows in flight per lane (4 words each)

// A host harness may define BS_HOST_READ(p) to see every occupancy word
// the replayed lanes read (the card's loads are the same words).
#ifndef BS_HOST_READ
#define BS_HOST_READ(p)
#endif

#ifdef __CUDACC__
#define BS_FULL_MASK 0xFFFFFFFFu
// The templates below call their Off / Term / Finish arguments, which
// are __device__-only in the kernels and host-only in the harnesses.
#define BS_HD_TEMPLATE _Pragma("nv_exec_check_disable")
#else
#define BS_HD_TEMPLATE
#endif

// One lane's four words of one strip: of one plane row, or of match.
struct BsLane {
  uint32_t w[4];
};

__host__ __device__ inline int bs_n_strips(int W) {
  return (W + BS_STRIP_WORDS - 1) / BS_STRIP_WORDS;
}

// The word of the block that lane `lane` owns as its j-th (0..3) in
// strip `strip`.
__host__ __device__ inline int bs_lane_word(int strip, int lane, int j,
                                            bool vec) {
  return strip * BS_STRIP_WORDS + (vec ? 4 * lane + j : lane + BS_WARP * j);
}

// Slots per block: the smallest power of two >= n_active, at least 1.
__host__ __device__ inline int bs_slot_width(int n_active) {
  int np = 1;
  while (np < n_active) np <<= 1;
  return np;
}

// The number of set bits of a ballot below lane `lane`: the slot of an
// active plane, so that slots list the planes in ascending order.
__host__ __device__ inline int bs_rank(uint32_t mask, int lane) {
  return bs_popc(mask & ((1u << lane) - 1u));
}

// The steps of a ballot before its first clear bit: the meta rows'
// n_active (the active steps come first).
__host__ __device__ inline int bs_leading_ones(uint32_t mask) {
  if (mask == 0xFFFFFFFFu) return 32;
#ifdef __CUDA_ARCH__
  return __ffs(~mask) - 1;
#else
  return __builtin_ffs((int)~mask) - 1;
#endif
}

// ---------------------------------------------- the tile kernel's rule
// Lane l's votes on one query's rule as bytes (the 0/1 of torch bools):
// plane l active (allowed AND its term present), term l required (AND
// present).  A ballot of each gives the plane mask and the required
// mask.
__host__ __device__ inline bool bs_plane_vote(const uint8_t* allowed,
                                              const uint8_t* present,
                                              int tf_planes, int F,
                                              int lane) {
  return lane < tf_planes && allowed[lane] != 0 && present[lane / F] != 0;
}

__host__ __device__ inline bool bs_req_vote(const uint8_t* required,
                                            const uint8_t* present,
                                            int n_terms, int lane) {
  return lane < n_terms && required[lane] != 0 && present[lane] != 0;
}

// The blocks of a tile of n_blk that warp `warp` of n_warps scans: a
// contiguous run from tile block *first of *count blocks (0 for a warp
// past a ragged last tile).
__host__ __device__ inline void bs_warp_span(int n_blk, int warp,
                                             int n_warps, int* first,
                                             int* count) {
  const int per = (n_blk + n_warps - 1) / n_warps;
  *first = warp * per;
  const int left = n_blk - *first;
  *count = left < 0 ? 0 : (left < per ? left : per);
}

// The 16-byte path's contract: W a multiple of 4 words and the
// occupancy and match pointers 16-byte aligned (a view at an offset
// need not be).  Else the scalar path of the same kernel runs.
__host__ __device__ inline bool bs_vector_path(int W, uintptr_t occ,
                                               uintptr_t match) {
  return W % 4 == 0 && (occ | match) % 16 == 0;
}

// ---------------------------------------------- the static kernel's rule
// A plane list by value: read at the constant slot indices of an
// unrolled round, so it stays in registers (no shared memory, no
// barrier).
static_assert(BS_SLOTS == BS_MAX_PLANES, "a slot for every plane");

struct BsSlots {
  int32_t v[BS_SLOTS];
  __host__ __device__ int operator[](int s) const { return v[s]; }
};

// The static rule's slots: off[s] = plane_ids[s] * W (the plane's word
// offset in a block), term[s] = term_ids[s].
__host__ __device__ inline void bs_static_slots(const BsStaticRule& rule,
                                                int W, BsSlots* off,
                                                BsSlots* term) {
#pragma unroll
  for (int s = 0; s < BS_SLOTS; ++s) {
    off->v[s] = rule.plane_ids[s] * W;
    term->v[s] = rule.term_ids[s];
  }
}

// ---------------------------------------------- the chunk kernel's meta
// Step s's valid flag in one query lane's meta rows (build_rule_meta's
// layout, block_scan.cuh); false past the tf_planes steps.
__host__ __device__ inline bool bs_step_valid(const int32_t* meta_lane,
                                              int ncols, int tf_planes,
                                              int s) {
  return s < tf_planes && meta_lane[2 * ncols + s] != 0;
}

// n_active from the valid row: the leading ones of its first 32 steps'
// ballot (`first`), and for a rule of more than 32 planes of the next
// 32 steps' ballots (ballot(s0): the ballot of step s0 + lane's valid
// flag) until one is clear.
BS_HD_TEMPLATE
template <class Ballot>
__host__ __device__ inline int bs_count_active(uint32_t first, int tf_planes,
                                               const Ballot& ballot) {
  int n_active = bs_leading_ones(first);
  for (int s0 = BS_WARP; n_active == s0 && s0 < tf_planes; s0 += BS_WARP)
    n_active += bs_leading_ones(ballot(s0));
  return n_active;
}

// Lane l's share of one query lane's meta rows: step l's plane id, term
// and valid flag, term l's required flag, and the block start.  Every
// load is independent of the others, so the whole meta block arrives in
// one round trip.
struct BsMetaLane {
  int32_t plane, term, start;
  bool valid, req;
};

__host__ __device__ inline BsMetaLane bs_meta_lane(const int32_t* meta_lane,
                                                   int ncols, int tf_planes,
                                                   int n_terms, int lane) {
  const bool step = lane < tf_planes;
  BsMetaLane r;
  r.plane = step ? meta_lane[lane] : 0;
  r.term = step ? meta_lane[ncols + lane] : 0;
  r.valid = bs_step_valid(meta_lane, ncols, tf_planes, lane);
  r.req = lane < n_terms && meta_lane[3 * ncols + lane] != 0;
  r.start = meta_lane[ncols - 1];
  return r;
}

// Step s of a meta row (row 0: plane ids, row 1: terms) as the chunk
// kernel reads it: steps below BS_WARP come from lane s, which loaded
// them in the meta round (`shuffled`, the value of a shuffle from lane
// s % BS_WARP); a rule of more than BS_WARP planes reads the rest from
// the row itself; 0 past the tf_planes steps.
__host__ __device__ inline int bs_step_value(const int32_t* row, int tf_planes,
                                             int s, int shuffled) {
  if (s < BS_WARP) return shuffled;
  return s < tf_planes ? row[s] : 0;
}

// Chunk position c's block: the start plus c, clamped to the last block.
__host__ __device__ inline int bs_chunk_block(int start, int c, int nb) {
  return start + c < nb - 1 ? start + c : nb - 1;
}

// ------------------------------------------------- loads and the words
__host__ __device__ inline uint32_t bs_ld(const uint32_t* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  BS_HOST_READ(p);
  return *p;
#endif
}

// Lane `lane`'s words of strip `strip` of one plane row; zeros where
// `on` is false or the word is at or past W (nothing is read there).
template <bool VEC>
__host__ __device__ inline BsLane bs_load_lane(const uint32_t* row, int strip,
                                               int lane, int W, bool on) {
  BsLane x = {{0u, 0u, 0u, 0u}};
  if (VEC) {
    const int w0 = bs_lane_word(strip, lane, 0, true);
    if (on && w0 < W) {   // W % 4 == 0: all four words or none
#ifdef __CUDA_ARCH__
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + w0));
      x.w[0] = v.x;
      x.w[1] = v.y;
      x.w[2] = v.z;
      x.w[3] = v.w;
#else
      for (int j = 0; j < 4; ++j) x.w[j] = bs_ld(row + w0 + j);
#endif
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int w = bs_lane_word(strip, lane, j, false);
      if (on && w < W) x.w[j] = bs_ld(row + w);
    }
  }
  return x;
}

// Stores lane `lane`'s match words of strip `strip` into a match row
// (streaming stores on the card: match is written once, never reread).
template <bool VEC>
__host__ __device__ inline void bs_store_lane(uint32_t* row, int strip,
                                              int lane, int W,
                                              const BsLane& m) {
  if (VEC) {
    const int w0 = bs_lane_word(strip, lane, 0, true);
    if (w0 < W) {
#ifdef __CUDA_ARCH__
      __stcs(reinterpret_cast<uint4*>(row + w0),
             make_uint4(m.w[0], m.w[1], m.w[2], m.w[3]));
#else
      for (int j = 0; j < 4; ++j) row[w0 + j] = m.w[j];
#endif
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int w = bs_lane_word(strip, lane, j, false);
      if (w < W) row[w] = m.w[j];
    }
  }
}

// OR-s one lane's words of one strip under NP plane slots into its term
// words: x[s] holds slot s's words (zeros past n_active and past W),
// term[first + s] its term; tf[k] is term k's four words.
BS_HD_TEMPLATE
template <int NP, class Term>
__host__ __device__ inline void bs_lane_or(const BsLane* x, const Term& term,
                                           int first,
                                           uint32_t (*tf)[4]) {
#pragma unroll
  for (int s = 0; s < NP; ++s) {
    const int t = term[first + s];
#pragma unroll
    for (int k = 0; k < BS_MAX_TERMS; ++k) {
      if (k == t) {
#pragma unroll
        for (int j = 0; j < 4; ++j) tf[k][j] |= x[s].w[j];
      }
    }
  }
}

// One lane's match words from its term words: the AND of the required
// terms' words, 0 if none is required.  Adds the popcounts of the first
// n_terms term words to *v_pop and of match to *m_pop.  Bit k of
// req_mask is term k's required-and-present flag (k < n_terms).
__host__ __device__ inline void bs_lane_match(const uint32_t (*tf)[4],
                                              uint32_t req_mask, int n_terms,
                                              BsLane* match, int* v_pop,
                                              int* m_pop) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t m = 0xFFFFFFFFu;
#pragma unroll
    for (int k = 0; k < BS_MAX_TERMS; ++k) {
      if (k < n_terms) {
        *v_pop += bs_popc(tf[k][j]);
        if ((req_mask >> k) & 1u) m &= tf[k][j];
      }
    }
    if (req_mask == 0u) m = 0u;
    match->w[j] = m;
    *m_pop += bs_popc(m);
  }
}

// One warp's run of n_blk consecutive blocks from block `first` of one
// query's (nb, T*F, W) occupancy, seen by lane `lane`: strips of
// BS_STRIP_WORDS words, rounds of BS_SLOTS / NP strips whose plane rows
// are all loaded before the round's first strip is evaluated.
// off[s] is slot s's word offset in a block (plane id * W), term[s] its
// term: any type with operator[] (a shared-memory array in the tile
// kernel, a lane shuffle in the chunk kernel, arrays in the harness).
// finish(blk, v, m) gets this lane's share of block blk's popcount sums
// once per block, after its last strip; the kernels sum the shares
// over the warp with shuffles, a harness adds them up.
BS_HD_TEMPLATE
template <int NP, bool VEC, class Off, class Term, class Finish>
__host__ __device__ inline void bs_warp_blocks(
    const uint32_t* occ_q, uint32_t* match_q, int first, int n_blk,
    int tf_planes, int W, int lane, const Off& off, const Term& term,
    int n_active, uint32_t req_mask, int n_terms, const Finish& finish) {
  constexpr int kStrips = BS_SLOTS / NP;   // strips per round
  const int n_strips = bs_n_strips(W);
  const int n_units = n_blk * n_strips;
  int blk = first, strip = 0;              // the round's first strip
  int v_acc = 0, m_acc = 0;
  for (int u0 = 0; u0 < n_units; u0 += kStrips) {
    BsLane x[kStrips][NP];
    int b = blk, st = strip;
#pragma unroll
    for (int k = 0; k < kStrips; ++k) {
      const uint32_t* base = occ_q + (int64_t)b * tf_planes * W;
      const bool unit = u0 + k < n_units;
#pragma unroll
      for (int s = 0; s < NP; ++s)
        x[k][s] = bs_load_lane<VEC>(base + off[s], st, lane, W,
                                    unit && s < n_active);
      if (++st == n_strips) {
        st = 0;
        ++b;
      }
    }
#pragma unroll
    for (int k = 0; k < kStrips; ++k) {
      if (u0 + k >= n_units) break;        // the same for the whole warp
      uint32_t tf[BS_MAX_TERMS][4] = {};
      bs_lane_or<NP>(x[k], term, 0, tf);
      BsLane m;
      bs_lane_match(tf, req_mask, n_terms, &m, &v_acc, &m_acc);
      bs_store_lane<VEC>(match_q + (int64_t)blk * W, strip, lane, W, m);
      if (++strip == n_strips) {
        finish(blk, v_acc, m_acc);
        v_acc = m_acc = 0;
        strip = 0;
        ++blk;
      }
    }
  }
}

// bs_warp_blocks at NP = bs_slot_width(n_active).
BS_HD_TEMPLATE
template <bool VEC, class Off, class Term, class Finish>
__host__ __device__ inline void bs_warp_scan(
    const uint32_t* occ_q, uint32_t* match_q, int first, int n_blk,
    int tf_planes, int W, int lane, const Off& off, const Term& term,
    int n_active, uint32_t req_mask, int n_terms, const Finish& finish) {
  switch (bs_slot_width(n_active)) {
    case 1:
      bs_warp_blocks<1, VEC>(occ_q, match_q, first, n_blk, tf_planes, W, lane,
                             off, term, n_active, req_mask, n_terms, finish);
      break;
    case 2:
      bs_warp_blocks<2, VEC>(occ_q, match_q, first, n_blk, tf_planes, W, lane,
                             off, term, n_active, req_mask, n_terms, finish);
      break;
    case 4:
      bs_warp_blocks<4, VEC>(occ_q, match_q, first, n_blk, tf_planes, W, lane,
                             off, term, n_active, req_mask, n_terms, finish);
      break;
    case 8:
      bs_warp_blocks<8, VEC>(occ_q, match_q, first, n_blk, tf_planes, W, lane,
                             off, term, n_active, req_mask, n_terms, finish);
      break;
    default:
      bs_warp_blocks<16, VEC>(occ_q, match_q, first, n_blk, tf_planes, W,
                              lane, off, term, n_active, req_mask, n_terms,
                              finish);
  }
}

// Whether the chunk kernel may meet a rule of more than BS_SLOTS active
// planes: T*F > BS_SLOTS.  Then it walks its block with bs_warp_block's
// plane groups; else (the serve path's T*F = 16) with one round of
// bs_warp_blocks<BS_SLOTS>, whose slots are compile-time constants.
__host__ __device__ inline bool bs_many_planes(int tf_planes) {
  return tf_planes > BS_SLOTS;
}

// One warp's block of the chunk kernel at T*F > BS_SLOTS, seen by lane
// `lane`: strip by strip, the active planes in groups of BS_SLOTS rows,
// every row of a group loaded before the first is used, the term words
// OR-ed across groups.  off[s] / term[s] are step s's word offset in the
// block and term, for any s < n_active + BS_SLOTS (0 past the rule's
// steps).  finish(0, v, m) gets this lane's share of the block's
// popcount sums.
BS_HD_TEMPLATE
template <bool VEC, class Off, class Term, class Finish>
__host__ __device__ inline void bs_warp_block(
    const uint32_t* occ_blk, uint32_t* match_row, int W, int lane,
    const Off& off, const Term& term, int n_active, uint32_t req_mask,
    int n_terms, const Finish& finish) {
  const int n_strips = bs_n_strips(W);
  int v_acc = 0, m_acc = 0;
  for (int st = 0; st < n_strips; ++st) {
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
    bs_store_lane<VEC>(match_row, st, lane, W, m);
  }
  finish(0, v_acc, m_acc);
}

#ifdef __CUDACC__
__device__ inline int bs_warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(BS_FULL_MASK, v, off);
  return v;
}

// The kernels' finish: the warp's sums of block blk, written by lane 0
// into v[blk] and n[blk].
struct BsWarpFinish {
  int32_t* v;
  int32_t* n;
  int lane;
  __device__ void operator()(int blk, int v_pop, int m_pop) const {
    v_pop = bs_warp_sum(v_pop);
    m_pop = bs_warp_sum(m_pop);
    if (lane == 0) {
      v[blk] = v_pop;
      n[blk] = m_pop;
    }
  }
};

// Slot s's value from lane s of the warp: the chunk kernel's plane
// offsets and terms at T*F <= BS_SLOTS, kept in the lanes that loaded
// them.
struct BsShfl {
  int value;
  __device__ int operator[](int s) const {
    return __shfl_sync(BS_FULL_MASK, value, s);
  }
};

// Step s of a meta row, as bs_step_value reads it, times `scale`: the
// chunk kernel's plane offsets (scale W) and terms (scale 1) at
// T*F > BS_SLOTS.
struct BsStep {
  int value;             // this lane's step of the row
  const int32_t* row;
  int tf_planes, scale;
  __device__ int operator[](int s) const {
    const int v = __shfl_sync(BS_FULL_MASK, value, s % BS_WARP);
    return bs_step_value(row, tf_planes, s, v) * scale;
  }
};
#endif  // __CUDACC__
