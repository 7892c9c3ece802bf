// Per-row online-softmax update of the attention kernels, and the tile
// plan and register micro-tiles of the CUDA-core flash-attention kernel.
//
// Shared by the CUDA kernels (flash_attention.cu; the row functions also
// by the tensor-core and decode kernels) and by host harnesses built
// with g++ in the CPU tests, so masking, rescaling, the guards of fully
// masked rows, finalisation, the ownership of every score and output
// element and the choice of the staging path are checked on a machine
// without a GPU.  Only the launch, the copies into shared memory, the
// barriers and the reductions across the threads that share a row stay
// CUDA-only.
//
// One query row's state over the KV tiles it visits: the running max m
// (-inf until a key is seen), the running sum l and the fp32
// accumulator acc (D values).  For each tile:
//   s_j   = fa_score(q.k_j, scale, fa_visible(...))     (-inf if masked)
//   m_cur = max_j s_j
//   r     = fa_rescale(m, m_cur)   -> m_new, m_safe, alpha
//   p_j   = fa_prob(s_j, r.m_safe)
//   l     = alpha * l + sum_j p_j ;  acc = alpha * acc + sum_j p_j v_j
//   m     = r.m_new
// and at the end o = fa_finalize(acc, l).  A row that sees no key keeps
// m = -inf, l = 0 and acc = 0, and gives 0 without a NaN, as the TPU
// kernel's isfinite and l == 0 guards make it.
#pragma once

#include <cmath>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

#include <stdint.h>

#define FA_BQ 128         // query rows of a CUDA-core kernel's CTA (tall)
#define FA_BQ_SHORT 64    // ... where tall tiles leave SMs without a CTA
#define FA_BK 64          // keys of a K/V tile
#define FA_MAX_D 128      // largest head dim
#define FA_K_STRIDE (FA_MAX_D + 4)  // K tile's row stride in shared memory:
                                    // 16-byte reads of 8 key rows hit 8
                                    // distinct bank groups
#define FA_ROWS 8         // query rows of a thread (of S and of O)
#define FA_KEYS 4         // S columns of a thread, per row
#define FA_DCOLS 8        // O columns of a thread, per row

__host__ __device__ inline bool fa_finite(float x) {
#ifdef __CUDA_ARCH__
  return isfinite(x);
#else
  return std::isfinite(x);
#endif
}

__host__ __device__ inline float fa_exp(float x) {
#ifdef __CUDA_ARCH__
  return expf(x);
#else
  return std::exp(x);
#endif
}

__host__ __device__ inline float fa_neg_inf() { return -INFINITY; }

// Can query position qpos see key position kpos?  Keys at or past
// kv_len are masked; causal rows see keys up to qpos + offset, where
// offset = kv_len - q_len.
__host__ __device__ inline bool fa_visible(int qpos, int kpos, int kv_len,
                                           int causal, int offset) {
  return kpos < kv_len && (!causal || qpos + offset >= kpos);
}

// Number of keys a query tile of rows [q0, q0 + rows) must visit: keys
// from this one on lie wholly above the diagonal for every row of the
// tile (or past kv_len) and their tiles are skipped.  May be <= 0.
__host__ __device__ inline int fa_kv_end(int q0, int rows, int kv_len,
                                         int causal, int offset) {
  if (!causal) return kv_len;
  const int end = q0 + rows + offset;   // last row's last key + 1
  return end < kv_len ? end : kv_len;
}

__host__ __device__ inline float fa_score(float dot, float scale,
                                          bool visible) {
  return visible ? dot * scale : fa_neg_inf();
}

struct FaRescale {
  float m_new;   // running max after this tile (-inf if nothing seen yet)
  float m_safe;  // m_new, or 0 while the row has seen no key
  float alpha;   // factor for the old l and acc (0 while m was -inf)
};

__host__ __device__ inline FaRescale fa_rescale(float m_prev, float m_cur) {
  FaRescale r;
  r.m_new = m_prev > m_cur ? m_prev : m_cur;
  r.m_safe = fa_finite(r.m_new) ? r.m_new : 0.0f;
  r.alpha = fa_finite(m_prev) ? fa_exp(m_prev - r.m_safe) : 0.0f;
  return r;
}

__host__ __device__ inline float fa_prob(float s, float m_safe) {
  return fa_finite(s) ? fa_exp(s - m_safe) : 0.0f;
}

__host__ __device__ inline float fa_finalize(float acc, float l) {
  return acc / (l == 0.0f ? 1.0f : l);
}

// Query rows a CUDA-core CTA takes, for bh = B * Hq heads of Sq rows on
// a card with `sms` SMs: FA_BQ, or FA_BQ_SHORT where FA_BQ-row tiles
// would give fewer CTAs than SMs (one CTA an SM fits, so such a grid
// leaves SMs idle and gives the others twice the rows).  A CTA has 2
// threads a row: 16-lane row groups of FA_ROWS rows.
__host__ __device__ inline int fa_tile_rows(int bh, int Sq, int sms) {
  return bh * ((Sq + FA_BQ - 1) / FA_BQ) >= sms ? FA_BQ : FA_BQ_SHORT;
}

// The CUDA-core kernel's register micro-tiles.  Thread t of a CTA: its
// row group t / 16 owns query rows 8 (t / 16) .. + 7 of the tile, in S
// and in O, so a row's max and sum reduce over the 16 lanes of one half
// warp; lane t % 16 owns the tile's keys t % 16 + 16 j (j < FA_KEYS) of
// S, 16 apart so that eight lanes reading 16 bytes of eight key rows hit
// eight bank groups, and the head-dim columns 4 (t % 16) + e and
// 64 + 4 (t % 16) + e (e < 4) of O, two 16-byte reads of a V row.
__host__ __device__ inline int fa_row(int t, int i) {
  return FA_ROWS * (t >> 4) + i;
}

__host__ __device__ inline int fa_key(int t, int j) { return (t & 15) + 16 * j; }

__host__ __device__ inline int fa_dcol(int t, int e) {
  return (e < 4 ? 0 : 64) + 4 * (t & 15) + (e & 3);
}

// K/V tiles a CTA of query rows [q0, q0 + rows) visits.
__host__ __device__ inline int fa_n_tiles(int q0, int rows, int kv_len,
                                          int causal, int offset) {
  const int end = fa_kv_end(q0, rows, kv_len, causal, offset);
  return end <= 0 ? 0 : (end + FA_BK - 1) / FA_BK;
}

// Does the tile of keys [k0, k0 + FA_BK) need the per-element mask for a
// CTA whose first row is q0?  Only if it runs past the keys or, when
// causal, past the diagonal of that row, the one that sees fewest keys.
__host__ __device__ inline bool fa_tile_needs_mask(int k0, int q0,
                                                   int kv_len, int causal,
                                                   int offset) {
  return k0 + FA_BK > kv_len || (causal && k0 + FA_BK - 1 > q0 + offset);
}

// The launch's one choice of copy path, for elements of `elt` bytes:
// 16-byte units (cp.async for fp32, loads of 8 for bf16) where a row is
// whole 16-byte units and q, k, v are 16-byte aligned; element by
// element otherwise.
__host__ __device__ inline bool fa_vector_path(int elt, int D, uint64_t q,
                                               uint64_t k, uint64_t v) {
  return D * elt % 16 == 0 && q % 16 == 0 && k % 16 == 0 && v % 16 == 0;
}
