// Host-checkable logic of the CUDA-core decode-attention kernel
// (decode_attention.cu): the slice and tile plan, the copy map of a
// warp's shared-memory ring, the lanes' ownership of key rows and
// columns, the reduce-scatter that sums a chunk's dot products over a
// team of lanes, and the weights of its two merges (the warps' states of
// a CTA, then the slices of a (b, kv head)).
//
// Shared by the CUDA kernel and by a host harness built with g++ in the
// CPU tests, which replays every CTA of a launch warp by warp and lane
// by lane through these functions against the plain version; only the
// cp.async copies, the shuffles, the barriers and the atomics stay
// CUDA-only.  The per-tile rescale and probabilities are flash
// attention's (flash_attention.cuh): the same recurrence with one query
// row per head.
//
// A row (b, query head h) attends over keys [0, len) of its KV head,
// len = min(max(kv_len, 0), S).  The keys are cut into n_split slices
// of split_keys keys each (whole rounds of DA_BK keys, chosen by the
// wrapper's split_plan); a CTA takes one slice of one (b, kv head), and
// warp w of the CTA takes the warp tiles w, w + DA_WARPS, ... of
// DA_WARP_KEYS keys each (da_tile_key).  Within a warp, the lanes form
// teams of da_row_lanes(D) lanes: a team takes every teams-th key row of
// the tile (da_team_key), each lane of it 4 columns of D
// (da_lane_col); a team keeps one online-softmax state (m, l, acc) for
// the group's query rows, m and l spread over its lanes (da_rs_base) and
// acc over their columns.  Each state leaves a partial relative to its own max m_i,
// or (0, -inf, 0) if it saw no valid key.  Both merges are
//   m   = max_i m_i               (-inf if no part saw a key)
//   w_i = exp(m_i - m_safe)       (0 for a part with m_i = -inf)
//   l   = sum_i w_i l_i ;  acc = sum_i w_i acc_i
// in part order, and the last one gives out = acc / l (acc itself with
// return_partial; 0 where l = 0).
#pragma once

#include "flash_attention.cuh"

#define DA_WARPS 4           // warps of a CTA
#define DA_THREADS 128
#define DA_WARP_KEYS 8       // keys of a warp tile: one stage of its ring
#define DA_BK 32             // keys of a CTA round (DA_WARPS warp tiles);
                             // a slice is whole rounds
#define DA_STAGES 3          // warp tiles in a warp's ring
#define DA_CTAS_PER_SM 2     // 4 warps x 3 stages x 8 KB at fp32 D = 128:
                             // 96 KB a CTA, two CTAs an SM
#define DA_MAX_D 128         // largest head dim
#define DA_MAX_GROUP 16      // largest GQA group (query heads per KV head)

// Valid keys of a row: kv_len clamped to [0, S].
__host__ __device__ inline int da_valid_len(int kv_len, int S) {
  return kv_len < 0 ? 0 : (kv_len > S ? S : kv_len);
}

// Weight of a partial with max m_i in a merge whose max is m, m_safe =
// da_finite_or_zero(m).
__host__ __device__ inline float da_merge_weight(float m_i, float m_safe) {
  return fa_finite(m_i) ? fa_exp(m_i - m_safe) : 0.0f;
}

__host__ __device__ inline float da_finite_or_zero(float m) {
  return fa_finite(m) ? m : 0.0f;
}

// Lanes that share a key row: 32 above D = 64, else 16 (two teams a
// warp, each on its own keys).  A lane owns 4 columns, so D / 4 lanes of
// a team hold columns and the rest hold zeros.
__host__ __device__ inline int da_row_lanes(int D) { return D > 64 ? 32 : 16; }

// The first of lane `lane`'s 4 columns of D (it holds none if >= D).
__host__ __device__ inline int da_lane_col(int lane, int row_lanes) {
  return 4 * (lane % row_lanes);
}

// Warp `warp`'s warp tiles among the ceil(n_keys / DA_WARP_KEYS) of a
// slice with n_keys valid keys (tiles wholly past them are not visited).
__host__ __device__ inline int da_warp_tiles(int n_keys, int warp) {
  const int tiles = n_keys > 0 ? (n_keys + DA_WARP_KEYS - 1) / DA_WARP_KEYS : 0;
  return tiles > warp ? (tiles - warp + DA_WARPS - 1) / DA_WARPS : 0;
}

// The first key (from the slice's start) of warp `warp`'s r-th tile.
__host__ __device__ inline int da_tile_key(int warp, int r) {
  return DA_WARP_KEYS * (warp + DA_WARPS * r);
}

// The row of a warp tile that team `team` of `teams` takes as its j-th.
__host__ __device__ inline int da_team_key(int team, int teams, int j) {
  return team + teams * j;
}

// The copy map of one warp tile into its stage: a tensor's tile is
// DA_WARP_KEYS rows of cpr 16-byte chunks, stored row-major (chunk e at
// byte 16 e); lane l copies chunks l, l + 32, ...; chunk e is row
// e / cpr, chunk e % cpr of that row.  Rows at or past the slice's last
// valid key are zero-filled (nothing is read there).
__host__ __device__ inline int da_tile_chunks(int cpr) {
  return DA_WARP_KEYS * cpr;
}

__host__ __device__ inline int da_chunk_row(int e, int cpr) { return e / cpr; }

__host__ __device__ inline int da_chunk_col(int e, int cpr) { return e % cpr; }

// Keys of a team's online-softmax chunk at GM rows a lane: at most 32
// partial dot products a lane in registers, never more than the team's
// keys of a tile.
__host__ __device__ constexpr int da_chunk_keys(int gm, int team_keys) {
  return team_keys < (gm >= 32 ? 1 : 32 / gm) ? team_keys
                                               : (gm >= 32 ? 1 : 32 / gm);
}

// The team's sums of a chunk's N = KC * GM partial dot products, value
// f = j * GM + g (key j of the chunk, query row g), by a reduce-scatter
// over the team's lpr lanes: at the xor step of offset `off` a lane
// keeps the half of its values given by its bit `off` and adds the other
// half of its partner's, da_rs_half(N, lpr, off) values; once a single
// value is left, the remaining steps add it whole (every lane of a
// group then holds the same sum).  A lane ends with da_rs_kept(N, lpr)
// values, f = da_rs_base(l, lpr, N) + i for lane l of the team; the
// lane that holds f (the lowest, if several do) is da_rs_lane.  So the
// keys' bits of f are the top lane bits (offsets lpr / 2 .. lpr / KC):
// a row's max and sum over the chunk's keys are xor steps over them,
// and every lane holds the same key for its values.
__host__ __device__ constexpr int da_rs_half(int N, int lpr, int off) {
  return N * off / lpr;
}

__host__ __device__ constexpr int da_rs_kept(int N, int lpr) {
  return N >= lpr ? N / lpr : 1;
}

__host__ __device__ inline int da_rs_base(int l, int lpr, int N) {
  int base = 0;
  for (int off = lpr / 2; off > 0; off >>= 1)
    if (da_rs_half(N, lpr, off) >= 1 && (l & off)) base += da_rs_half(N, lpr, off);
  return base;
}

__host__ __device__ inline int da_rs_lane(int f, int lpr, int N) {
  int l = 0;
  for (int off = lpr / 2; off > 0; off >>= 1)
    if (da_rs_half(N, lpr, off) >= 1 && (f & da_rs_half(N, lpr, off))) l += off;
  return l;
}

// Dynamic shared memory of a launch, in bytes: the warps' rings, reused
// after the last tile for the warps' states (m, l and D columns of acc
// per query row, per team of each warp) and, in the last CTA of a
// (b, kv head), for the slices' m and l.
__host__ __device__ inline int da_smem_bytes(int elt, int D, int group,
                                             int n_split) {
  const int ring = DA_WARPS * DA_STAGES * 2 * DA_WARP_KEYS * D * elt;
  const int states = DA_WARPS * (32 / da_row_lanes(D)) * group * (D + 2) * 4;
  const int slices = 2 * n_split * group * 4;
  const int most = ring > states ? ring : states;
  return most > slices ? most : slices;
}
