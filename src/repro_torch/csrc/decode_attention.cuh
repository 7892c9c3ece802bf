// Per-row online-softmax update and LSE merge of the decode-attention
// kernel.
//
// Shared by the CUDA kernel (decode_attention.cu) and by a host harness
// built with g++ in the CPU tests, which replays the splits and the
// merge against the plain version.  The per-tile rescale and
// probabilities are flash attention's (flash_attention.cuh): the same
// recurrence with one query row per head.
//
// A row (b, query head h) attends over keys [0, len) of its KV head,
// len = min(max(kv_len, 0), S).  The keys are cut into n_split slices
// of split_keys keys each (a multiple of the tile, chosen by the
// wrapper's split_plan and passed in as it is); slice i
// leaves a partial (acc_i, m_i, l_i) relative to its own max m_i, or
// (0, -inf, 0) if it holds no valid key.  The merge:
//   m   = max_i m_i               (-inf if no slice saw a key)
//   w_i = exp(m_i - m_safe)       (0 for a slice with m_i = -inf)
//   l   = sum_i w_i l_i ;  acc = sum_i w_i acc_i
//   out = acc / l  (acc itself with return_partial; 0 where l = 0)
#pragma once

#include "flash_attention.cuh"

#define DA_BK 64          // keys of a KV tile
#define DA_MAX_D 128      // largest head dim
#define DA_MAX_GROUP 16   // largest GQA group (query heads per KV head)
#define DA_THREADS 128

// Valid keys of a row: kv_len clamped to [0, S].
__host__ __device__ inline int da_valid_len(int kv_len, int S) {
  return kv_len < 0 ? 0 : (kv_len > S ? S : kv_len);
}

// Weight of a partial with max m_i in the merge.
__host__ __device__ inline float da_merge_weight(float m_i, float m_safe) {
  return fa_finite(m_i) ? fa_exp(m_i - m_safe) : 0.0f;
}

__host__ __device__ inline float da_finite_or_zero(float m) {
  return fa_finite(m) ? m : 0.0f;
}
