// Per-bag core of the EmbeddingBag kernel: one output column of one bag.
//
// Shared by the CUDA kernel (embedding_bag.cu) and by a host harness
// built with g++ in the CPU tests, so the padding rule, the weights, the
// fp32 accumulation and the mean's divisor are checked on a machine
// without a GPU.  Only the launch and the mapping of bags and columns
// onto threads stay CUDA-only.
//
// For bag b and column e:
//   out = sum_{i < L, 0 <= idx_i < V} w_i * table[idx_i, e]     (fp32)
//   w_i = weights[b, i], or 1 without weights
//   mean: out / max(#{i : 0 <= idx_i < V}, 1)
// An index at or past V is not read and counts as padding, so the kernel
// never reads outside the table; the plain version (ref.py) does the same.
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

__host__ __device__ inline float eb_load(const float* p) { return *p; }

template <typename T>
__host__ __device__ inline float eb_bag_column(
    const T* table, int64_t V, int E, const int* idx, const float* w, int L,
    int e, int mean) {
  float sum = 0.0f;
  int count = 0;
#ifdef __CUDA_ARCH__
#pragma unroll 8
#endif
  for (int i = 0; i < L; ++i) {
    const int r = idx[i];
    if (r >= 0 && r < V) {
      sum += (w ? w[i] : 1.0f) * eb_load(table + (int64_t)r * E + e);
      ++count;
    }
  }
  return mean ? sum / (float)(count > 1 ? count : 1) : sum;
}
