// Host-checkable logic of the tensor-core flash-attention kernel
// (flash_attention_tc.cu): the tile plan, the per-element mask of the
// tiles that cross the diagonal or the end of the keys, the map from a
// thread's accumulator registers to (row, column) of a wgmma m64nN
// tile, and the per-row online softmax in base 2 with the scale folded
// in.  The CPU tests compile this header with g++ and replay the
// kernel's tiles through it; only the TMA loads, the wgmma products and
// the shuffles across a quad stay CUDA-only.
//
// One query row's state over the key tiles it visits: the running max
// m of the raw dot products (-inf until a key is seen), the running sum
// l and the fp32 accumulator.  For each tile of FATC_BK keys:
//   s_j   = fatc_score(q.k_j, visible)               (-inf if masked)
//   m_cur = max_j s_j            (the thread's values, then its quad)
//   r     = fatc_rescale(m, m_cur, sl2)  -> m_new, m_safe, alpha
//   p_j   = fatc_prob(s_j, -r.m_safe * sl2, sl2) = 2^((s_j - m_safe) sl2)
//   l     = alpha * l + sum_j p_j ;  acc = alpha * acc + sum_j p_j v_j
//   m     = r.m_new
// with sl2 = scale * log2(e), so p_j = exp(scale (s_j - m_safe)) as in
// flash_attention.cuh; at the end o = fa_finalize(acc, l).  A row that
// sees no key keeps m = -inf, l = 0 and acc = 0 and gives exactly 0:
// 2^-inf is 0 on the card's ex2 and in std::exp2, so p and alpha need
// no isfinite test, only m_safe does.
#pragma once

#include <cmath>

#include "flash_attention.cuh"

#define FATC_BQ 128        // query rows of a CTA: two consumer warpgroups
#define FATC_WG_ROWS 64    // rows of one warpgroup: wgmma's M
#define FATC_BK 128        // keys of a K/V tile: the N of S = Q K^T
#define FATC_BOX_COLS 64   // head-dim columns of one 128-byte-swizzled box
#define FATC_STAGES 2      // K/V tiles in the shared-memory ring
#define FATC_WG_THREADS 128
#define FATC_CONSUMERS 256 // two consumer warpgroups
#define FATC_THREADS 288   // and one producer warp

#define FATC_LOG2E 1.4426950408889634f

__host__ __device__ inline float fatc_exp2(float x) {
#ifdef __CUDA_ARCH__
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
#else
  return std::exp2(x);
#endif
}

// Key tiles a CTA of query rows [q0, q0 + rows) visits: those below
// fa_kv_end, the first key that every row of the tile has past it.
__host__ __device__ inline int fatc_n_tiles(int q0, int rows, int kv_len,
                                            int causal, int offset) {
  const int end = fa_kv_end(q0, rows, kv_len, causal, offset);
  return end <= 0 ? 0 : (end + FATC_BK - 1) / FATC_BK;
}

// Does the tile of keys [k0, k0 + FATC_BK) need the per-element mask for
// a CTA whose first row is q0?  Only if it runs past the keys or, when
// causal, past the diagonal of the CTA's first row; every other tile is
// wholly visible to every row of the CTA and takes no mask arithmetic.
__host__ __device__ inline bool fatc_tile_needs_mask(int k0, int q0,
                                                     int kv_len, int causal,
                                                     int offset) {
  return k0 + FATC_BK > kv_len ||
         (causal && k0 + FATC_BK - 1 > q0 + offset);
}

// On a masked tile, row qpos sees the tile's columns c < fatc_row_limit:
// one compare per element instead of fa_visible's two.
__host__ __device__ inline int fatc_row_limit(int qpos, int k0, int kv_len,
                                              int causal, int offset) {
  int lim = kv_len - k0;
  if (causal) {
    const int diag = qpos + offset + 1 - k0;
    lim = diag < lim ? diag : lim;
  }
  return lim;
}

// wgmma m64nN fp32 accumulator: thread t (0..127) of the warpgroup holds
// N/2 registers; register i is element (row, col) of the 64 x N tile.
// Warp t/32 owns rows 16 (t/32) .. +15; within the warp the layout is
// mma.m16n8's C fragment repeated along N: g = lane/4 picks the row pair
// (g, g + 8), c = lane%4 the column pair of each 8-column chunk i/4.
// A row's N values are spread over the four lanes of one quad.
__host__ __device__ inline int fatc_acc_row(int t, int i) {
  return 16 * (t >> 5) + ((t & 31) >> 2) + 8 * ((i >> 1) & 1);
}

__host__ __device__ inline int fatc_acc_col(int t, int i) {
  return 8 * (i >> 2) + 2 * (t & 3) + (i & 1);
}

// The same thread's A fragment of a m64k16 wgmma with A in registers
// (P for P V): 32-bit register a (0..3) of k-step kk holds the two
// values of accumulator registers 8 kk + 2 a and 8 kk + 2 a + 1, so the
// S accumulator becomes P's A fragments with no shuffle.
__host__ __device__ inline int fatc_p_reg(int kk, int a, int half) {
  return 8 * kk + 2 * a + half;
}

__host__ __device__ inline float fatc_score(float dot, bool visible) {
  return visible ? dot : fa_neg_inf();
}

struct FatcRescale {
  float m_new;   // running max of the raw scores (-inf if none seen yet)
  float m_neg;   // -m_safe * sl2: the exponent's offset (0 while no key)
  float alpha;   // factor for the old l and acc (0 while m was -inf)
};

__host__ __device__ inline FatcRescale fatc_rescale(float m_prev,
                                                    float m_cur, float sl2) {
  FatcRescale r;
  r.m_new = m_prev > m_cur ? m_prev : m_cur;
  const float m_safe = fa_finite(r.m_new) ? r.m_new : 0.0f;
  r.m_neg = -m_safe * sl2;
  r.alpha = fatc_exp2((m_prev - m_safe) * sl2);
  return r;
}

__host__ __device__ inline float fatc_prob(float s, float m_neg, float sl2) {
  return fatc_exp2(fmaf(s, sl2, m_neg));
}
