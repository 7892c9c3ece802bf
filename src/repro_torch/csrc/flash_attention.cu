// Causal / bidirectional GQA flash attention (forward) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/flash_attention.py, _kernel).
// q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), fp32 or bf16, contiguous;
// query head h reads KV head h / (Hq / Hkv), and K/V are never repeated
// in memory.  Causal rows see keys up to their position + Skv - Sq; keys
// past Skv are masked; a row that sees no key gives 0.  Scores, the
// softmax and the accumulator are fp32; the output has q's type.
//
// What bounds it on an H100: operations.  At the LM path's shape
// (Hq=32, Hkv=8, S=8192, D=128, causal, B=2) it does ~1.1 TFLOP, about
// 1.1 ms at the 989 TFLOP/s bf16 tensor rate, against ~0.1 ms to move
// q, k, v and o once at 3.35 TB/s.
//
// Design (simple and right first): one CTA of 256 threads per
// (b * Hq, query tile of block_q <= 64 rows).  The TPU kernel's
// sequential ("arbitrary") KV grid axis with VMEM scratch becomes a loop
// inside the CTA over KV tiles of block_k <= 64 keys, staged in shared
// memory as fp32; tiles wholly above the diagonal are never visited, and
// the longest (last) query tiles are scheduled first.  Nothing carries
// between CTAs.  Each thread owns 4 query rows (a group of 16 threads
// shares them): a 4x4 block of the score tile and a 4x8 block of the
// accumulator, with the running max and sum, all in registers; a row's
// max and sum are reduced over its 16 threads with warp shuffles.  The
// per-row update lives in flash_attention.cuh, which the CPU tests
// compile with g++.
//
// What it leaves on the table: both products run on the fp32 CUDA cores
// (67 TFLOP/s peak), not the tensor cores (wgmma / mma.sync on bf16,
// ~15x the rate); tiles are loaded synchronously by every thread with no
// cp.async or TMA pipeline, so load latency is not hidden; 118 KB of
// shared memory leaves one CTA (8 warps) per SM.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention.cuh"

#define FA_QK_STRIDE (FA_MAX_D + 4)  // sQ, sK row stride: float4 reads of
                                     // 8 rows hit 32 distinct banks
#define FA_P_STRIDE (FA_BK + 4)
#define FA_SMEM_FLOATS \
  ((FA_BQ + FA_BK) * FA_QK_STRIDE + FA_BK * FA_MAX_D + FA_BQ * FA_P_STRIDE)

__device__ __forceinline__ float fa_load(const float* p) { return *p; }
__device__ __forceinline__ float fa_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void fa_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void fa_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(FA_THREADS) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv, int Sq,
    int Skv, int D, int bq, int bk, int causal, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                          // FA_BQ x FA_QK_STRIDE
  float* sK = sQ + FA_BQ * FA_QK_STRIDE;     // FA_BK x FA_QK_STRIDE
  float* sV = sK + FA_BK * FA_QK_STRIDE;     // FA_BK x FA_MAX_D
  float* sP = sV + FA_BK * FA_MAX_D;         // FA_BQ x FA_P_STRIDE

  const int tid = threadIdx.x;
  const int ty = tid >> 4;   // row group: tile rows 4*ty .. 4*ty + 3
  const int tx = tid & 15;   // score columns tx + 16 j; acc columns
                             // 4 tx + e and 64 + 4 tx + e

  const int bh = blockIdx.x;                        // b * Hq + h
  const int qt = gridDim.y - 1 - blockIdx.y;        // longest tiles first
  const int b = bh / Hq, h = bh % Hq;
  const int64_t kv_head = (int64_t)b * Hkv + h / (Hq / Hkv);
  const T* qb = q + (int64_t)bh * Sq * D;
  const T* kb = k + kv_head * Skv * D;
  const T* vb = v + kv_head * Skv * D;
  T* ob = o + (int64_t)bh * Sq * D;

  const int q0 = qt * bq;
  const int rows = min(bq, Sq - q0);
  const int offset = Skv - Sq;
  const int kv_end = fa_kv_end(q0, rows, Skv, causal, offset);
  const int d4 = (D + 3) & ~3;   // float4 steps; smem columns D..d4 are 0

  for (int e = tid; e < FA_BQ * d4; e += FA_THREADS) {
    const int r = e / d4, c = e - r * d4;
    sQ[r * FA_QK_STRIDE + c] =
        (r < rows && c < D) ? fa_load(qb + (int64_t)(q0 + r) * D + c) : 0.0f;
  }

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = fa_neg_inf();
    l[i] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) acc[i][jj] = 0.0f;
  }

  for (int k0 = 0; k0 < kv_end; k0 += bk) {
    const int keys = min(bk, Skv - k0);
    __syncthreads();   // sQ staged; the last tile's sK, sV, sP reads done
    for (int e = tid; e < FA_BK * d4; e += FA_THREADS) {
      const int r = e / d4, c = e - r * d4;
      const bool in = r < keys && c < D;
      const int64_t g = (int64_t)(k0 + r) * D + c;
      sK[r * FA_QK_STRIDE + c] = in ? fa_load(kb + g) : 0.0f;
      sV[r * FA_MAX_D + c] = in ? fa_load(vb + g) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < d4; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            &sQ[(4 * ty + i) * FA_QK_STRIDE + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(
            &sK[(tx + 16 * j) * FA_QK_STRIDE + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }

    // Online softmax, one row at a time; the 16 threads of a row group
    // are 16 consecutive lanes of one warp, so xor shuffles of 8..1 stay
    // inside the group.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      float mc = fa_neg_inf();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool vis = r < rows && c < keys &&
                         fa_visible(q0 + r, k0 + c, Skv, causal, offset);
        s[i][j] = fa_score(s[i][j], scale, vis);
        mc = fmaxf(mc, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xFFFFFFFFu, mc, off));
      const FaRescale rs = fa_rescale(m[i], mc);
      float ps = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = fa_prob(s[i][j], rs.m_safe);
        sP[r * FA_P_STRIDE + tx + 16 * j] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xFFFFFFFFu, ps, off);
      l[i] = rs.alpha * l[i] + ps;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) acc[i][jj] *= rs.alpha;
      m[i] = rs.m_new;
    }
    __syncthreads();

    const int keys4 = (keys + 3) & ~3;   // P is 0 and V rows are 0 past keys
    for (int kk = 0; kk < keys4; kk += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(
            &sP[(4 * ty + i) * FA_P_STRIDE + kk]);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* vrow = &sV[(kk + t) * FA_MAX_D];
        const float4 va = *reinterpret_cast<const float4*>(&vrow[4 * tx]);
        const float4 vc = *reinterpret_cast<const float4*>(&vrow[64 + 4 * tx]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = t == 0 ? p4[i].x
                        : t == 1 ? p4[i].y
                        : t == 2 ? p4[i].z
                                 : p4[i].w;
          acc[i][0] = fmaf(p, va.x, acc[i][0]);
          acc[i][1] = fmaf(p, va.y, acc[i][1]);
          acc[i][2] = fmaf(p, va.z, acc[i][2]);
          acc[i][3] = fmaf(p, va.w, acc[i][3]);
          acc[i][4] = fmaf(p, vc.x, acc[i][4]);
          acc[i][5] = fmaf(p, vc.y, acc[i][5]);
          acc[i][6] = fmaf(p, vc.z, acc[i][6]);
          acc[i][7] = fmaf(p, vc.w, acc[i][7]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= rows) continue;
    T* orow = ob + (int64_t)(q0 + r) * D;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = (jj < 4 ? 4 * tx : 64 + 4 * tx - 4) + jj;
      if (col < D) fa_store(orow + col, fa_finalize(acc[i][jj], l[i]));
    }
  }
}

template <typename T>
static int fa_launch(const void* q, const void* k, const void* v, void* o,
                     int B, int Hq, int Hkv, int Sq, int Skv, int D, int bq,
                     int bk, int causal, float scale, cudaStream_t stream) {
  const int smem = FA_SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * Hq), (unsigned)((Sq + bq - 1) / bq));
  flash_attention_kernel<T><<<grid, FA_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Hq, Hkv, Sq, Skv, D, bq,
      bk, causal, scale);
  return (int)cudaGetLastError();
}

// Plain C entry point for ctypes.  dtype: 0 = fp32, 1 = bf16.  Launches
// on the given stream and returns the CUDA error code (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int B, int Hq, int Hkv, int Sq,
                                      int Skv, int D, int bq, int bk,
                                      int causal, float scale,
                                      void* stream) {
  if (dtype == 1)
    return fa_launch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, bq,
                                    bk, causal, scale, (cudaStream_t)stream);
  return fa_launch<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, bq, bk, causal,
                          scale, (cudaStream_t)stream);
}
