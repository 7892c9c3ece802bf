// Host-checkable logic of the tensor-core decode-attention kernel
// (decode_attention_tc.cu): the swizzled shared-memory ring's slots, the
// ldmatrix row addresses, the mma.sync m16n8k16 fragment maps, the key
// mask at kv_len, the online softmax in base 2, and the weights of the
// two merges (the warps of a CTA, then the slices of a (b, kv head)).
// The CPU tests compile this header with g++ and replay a CTA's tiles
// thread by thread through it against the plain version; only the
// cp.async copies, the ldmatrix / mma / movmatrix instructions, the
// shuffles and the atomics stay CUDA-only.
//
// A CTA takes one slice of the keys of one (b, kv head); warp w takes
// keys [16 w, 16 w + 16) of every 64-key tile of the slice and keeps its
// own state over them for the group's query heads h (columns of the
// fragments).  For each tile:
//   S^T = K Q^T            (mma m16n8k16: keys in M, heads in N, D in K)
//   s   = datc_score(S^T, scale, key < k_end)       (-inf if masked)
//   m_cur(h) = max over the warp's 16 keys; r = datc_rescale(m(h), m_cur)
//   p   = datc_prob(s, r.m_neg) = 2^((s - m_safe) log2 e)
//   l   = r.alpha l + sum p ;  O^T = r.alpha O^T + V^T P^T   (P in bf16)
//   m   = r.m_new
// Then the warps merge (datc_weight, warp order 0..3) into the slice's
// partial (acc, m, l), and the last CTA of the (b, kv head) to finish
// merges the slices (datc_weight, slice order 0..n-1) and normalises
// (fa_finalize).  A row that sees no key keeps m = -inf, l = 0, acc = 0
// and gives exactly 0: 2^-inf is 0 on the card's ex2 and in std::exp2.
#pragma once

#include <cmath>

#include "decode_attention.cuh"

#define DATC_BK 64          // keys of a K/V tile
#define DATC_WARP_KEYS 16   // keys of a tile per warp: the M of S^T
#define DATC_WARPS 4
#define DATC_THREADS 128
#define DATC_STAGES 3       // K/V tiles in the shared-memory ring
#define DATC_CTAS_PER_SM 2  // 3 stages x 32 KB at D = 128: two CTAs an SM
#define DATC_MAX_GROUP 16   // query heads per KV head: two n8 tiles
#define DATC_MAX_SPLIT 256  // slices: their m and l fit the ring at D = 64

#define DATC_LOG2E 1.4426950408889634f

__host__ __device__ inline float datc_exp2(float x) {
#ifdef __CUDA_ARCH__
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
#else
  return std::exp2(x);
#endif
}

// Shared memory: a tile row of D bf16 is cpr = D / 8 chunks of 16 bytes;
// chunk c of row r lies in 16-byte slot datc_slot(r, c, cpr).  The XOR
// of the chunk's low three bits with the row's puts the eight rows that
// one 8 x 8 ldmatrix reads (one chunk column) on eight distinct 16-byte
// bank groups, at a row length of 128 or 256 bytes alike.
__host__ __device__ inline int datc_slot(int row, int chunk, int cpr) {
  return row * cpr + (chunk ^ (row & 7));
}

// ldmatrix.x4 row address of a lane for a 16-key x 16-column block: the
// block's row (key) and chunk (0 or 1, the 8 columns) the lane points
// at.  Lanes 8i..8i+7 give the rows of matrix i, and matrix i lands in
// register i.  K (A of S^T = K Q^T, plain ldmatrix): matrices (keys
// 0-7, cols 0-7), (keys 8-15, cols 0-7), (keys 0-7, cols 8-15), (keys
// 8-15, cols 8-15), the A fragment's a0a1, a2a3, a4a5, a6a7.  V (A of
// O^T = V^T P^T, ldmatrix.trans: rows of V are keys, rows of V^T are
// columns of D): matrices (cols 0-7, keys 0-7), (cols 8-15, keys 0-7),
// (cols 0-7, keys 8-15), (cols 8-15, keys 8-15).
__host__ __device__ inline int datc_ldm_row(int lane, int trans) {
  return (lane & 7) + 8 * ((lane >> (trans ? 4 : 3)) & 1);
}

__host__ __device__ inline int datc_ldm_chunk(int lane, int trans) {
  return (lane >> (trans ? 3 : 4)) & 1;
}

// C fragment of m16n8 (fp32): register i (0..3) of a lane holds element
// (row, col) of the 16 x 8 tile.  For S^T the row is a key of the warp's
// 16 and the column a query head of the n8 tile; for O^T the row is a
// column of D within the m16 tile and the column a query head.  A lane's
// two heads are the same in both, so its softmax state needs no shuffle
// to reach its accumulators.
__host__ __device__ inline int datc_c_row(int lane, int i) {
  return (lane >> 2) + 8 * (i >> 1);
}

__host__ __device__ inline int datc_c_col(int lane, int i) {
  return 2 * (lane & 3) + (i & 1);
}

// B fragment of S^T = K Q^T (k16 x n8, Q^T): register r (0, 1), half h
// of a lane holds Q[head][16 ks + datc_qb_d(lane, r, h)], head =
// datc_qb_head(lane) of the n8 tile.  The two halves are neighbours in
// Q's row, so a register is two bf16 read from Q once per CTA.
__host__ __device__ inline int datc_qb_d(int lane, int r, int h) {
  return 2 * (lane & 3) + h + 8 * r;
}

__host__ __device__ inline int datc_qb_head(int lane) { return lane >> 2; }

// P for O^T = V^T P^T: the S^T C fragment's registers 2r and 2r + 1 (key
// rows g + 8r, heads 2c and 2c + 1) pack into one bf16 pair, the lane's
// row of the 8 x 8 block (keys 8r..8r+7) x (heads); movmatrix.trans
// turns it into the same lane's B-fragment register r (keys 2c, 2c+1 or
// 2c+8, 2c+9, head g).  datc_p_reg gives the C register of half h.
__host__ __device__ inline int datc_p_reg(int r, int h) { return 2 * r + h; }

// The key mask: keys at or past k_end (the slice's end, or kv_len) are
// not seen.
__host__ __device__ inline bool datc_key_valid(int key, int k_end) {
  return key < k_end;
}

__host__ __device__ inline float datc_score(float dot, float scale,
                                            bool valid) {
  return valid ? dot * scale : fa_neg_inf();
}

struct DatcRescale {
  float m_new;   // running max of the scaled scores (-inf if none seen)
  float m_neg;   // -m_safe * log2 e: the exponent's offset (0 while none)
  float alpha;   // factor for the old l and acc (0 while m was -inf)
};

__host__ __device__ inline DatcRescale datc_rescale(float m_prev,
                                                    float m_cur) {
  DatcRescale r;
  r.m_new = m_prev > m_cur ? m_prev : m_cur;
  const float m_safe = fa_finite(r.m_new) ? r.m_new : 0.0f;
  r.m_neg = -m_safe * DATC_LOG2E;
  r.alpha = datc_exp2((m_prev - m_safe) * DATC_LOG2E);
  return r;
}

__host__ __device__ inline float datc_prob(float s, float m_neg) {
  return datc_exp2(fmaf(s, DATC_LOG2E, m_neg));
}

// Weight of a partial with max m_i in a merge whose max is m (m_safe =
// da_finite_or_zero(m)); 0 for a partial that saw no key.
__host__ __device__ inline float datc_weight(float m_i, float m_safe) {
  return datc_exp2((m_i - m_safe) * DATC_LOG2E);
}
