// Per-row online-softmax update of the flash-attention kernel.
//
// Shared by the CUDA kernel (flash_attention.cu) and by a host harness
// built with g++ in the CPU tests, so masking, rescaling, the guards of
// fully masked rows and finalisation are checked on a machine without
// a GPU.  Only the launch, the shared-memory staging and the reductions
// across the threads that share a row stay CUDA-only.
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

#define FA_BQ 64          // query rows of a CTA's tile (largest block_q)
#define FA_BK 64          // keys of a KV tile (largest block_k)
#define FA_MAX_D 128      // largest head dim
#define FA_THREADS 256    // 16 row groups x 16 lanes

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
