// Causal / bidirectional GQA flash attention (forward) on the CUDA cores,
// for Hopper (sm_90a): the fp32 route, and bf16 at the head dims the
// tensor-core kernel (flash_attention_tc.cu) is not built for.
//
// Replaces the Pallas TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/flash_attention.py, _kernel).
// q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), fp32 or bf16, contiguous,
// D <= 128; query head h reads KV head h / (Hq / Hkv), and K/V are never
// repeated in memory.  Causal rows see keys up to their position + Skv -
// Sq; keys past Skv are masked; a row that sees no key gives 0.  Scores,
// the softmax and the accumulator are fp32; the output has q's type.
//
// What bounds it on an H100: operations, at the fp32 rate (67 TFLOP/s
// outside the tensor cores; no tensor-core type keeps fp32's 2e-5
// tolerance).  At the fp32 LM route's shape (B=2, Hq=32, Hkv=8, S=1024,
// D=128, causal) it does 17.2 GFLOP, 0.26 ms at that rate, against
// 0.03 ms to move q, k, v and o once at 3.35 TB/s.
//
// Design: an SGEMM-like pair of products per K/V tile, fed from shared
// memory so that the FMA units, not the loads, set the pace.  One CTA of
// 256 threads (8 warps, one CTA an SM) per (b * Hq, tile of FA_BQ = 128
// query rows), or of 128 threads and 64 rows where 128-row tiles would
// leave SMs idle (fa_tile_rows, chosen per launch), the longest (last)
// query tiles scheduled first; a loop over K/V tiles of FA_BK = 64 keys,
// as the TPU kernel's sequential KV grid axis, with the tiles wholly
// above the diagonal skipped.
//   - Q's tile is copied into shared memory once; K and V tiles come
//     through a two-slot ring: tile j + 1 is copied while tile j is used.
//     Where rows are whole 16-byte units and q, k, v 16-byte aligned
//     (fa_vector_path, chosen once per launch), fp32 rows come by 16-byte
//     cp.async, zero-filled past the keys and rows, and bf16 rows by
//     16-byte loads of 8 through registers, converted to fp32; otherwise
//     every thread loads element by element.
//   - Each thread owns an 8 x 4 micro-tile of S (8 rows, keys 16 apart)
//     and an 8 x 8 micro-tile of O (flash_attention.cuh's fa_row, fa_key,
//     fa_dcol): one 16-byte read of Q feeds 16 FMAs of S = Q K^T, and
//     one of P or V feeds 32 of O += P V.
//   - Online softmax in base 2 (flash_attention_tc.cuh's fatc_rescale,
//     fatc_prob: the scale times log2(e) folded into one FMA before
//     ex2), a row's max and sum over its 16 lanes by xor shuffles; masks
//     only on tiles that cross the diagonal or the end of the keys.
//   - P goes through shared memory, but only within a warp: a row's 16
//     lanes are one half warp, and they alone write and read its P row.
//     So one barrier a tile (the K/V ring's) is all the CTA shares; Q
//     (unpadded: its reads are broadcasts), the ring and P take 226 KB
//     with 128-row tiles.
// The maps, the tile plan, the mask and the path choice are the
// __host__ __device__ functions of flash_attention.cuh, which the CPU
// tests replay thread by thread with g++.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention_tc.cuh"

#define FA_K_SLOT (FA_BK * FA_K_STRIDE)
#define FA_V_SLOT (FA_BK * FA_MAX_D)
#define FA_SMEM_FLOATS(BQ) \
  ((BQ) * FA_MAX_D + 2 * FA_K_SLOT + 2 * FA_V_SLOT + (BQ) * FA_BK)

__device__ __forceinline__ float fa_load(const float* p) { return *p; }
__device__ __forceinline__ float fa_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void fa_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void fa_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Two bf16 (the low half first) as two floats.
__device__ __forceinline__ float2 fa_bf16x2(uint32_t w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xFFFF0000u));
}

// 16-byte asynchronous copy, zero-filled when `bytes` is 0.
__device__ __forceinline__ void fa_cp16(float* dst, const void* src,
                                        int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

// Rows [0, n) of a (rows x D) block at src into shared memory rows of
// `stride` floats, by the CTA's NT threads; rows at or past `valid` are
// zeros, and so are the columns D .. (D + 3) & ~3 on the element path.
// VEC: fp32 by 16-byte cp.async; WIDE: bf16 by 16-byte loads; neither:
// element by element.
template <typename T, bool VEC, bool WIDE, int NT>
__device__ __forceinline__ void fa_stage(float* dst, const T* src, int n,
                                         int valid, int D, int stride) {
  if (VEC) {   // T is float
    const int per = D / 4;
    for (int u = threadIdx.x; u < n * per; u += NT) {
      const int r = u / per, c = 4 * (u - r * per);
      const bool in = r < valid;
      fa_cp16(dst + r * stride + c, in ? src + (int64_t)r * D + c : src,
              in ? 16 : 0);
    }
  } else if (WIDE) {   // bf16 rows by 16-byte loads of 8
    const int per = D / 8;
    for (int u = threadIdx.x; u < n * per; u += NT) {
      const int r = u / per, c = 8 * (u - r * per);
      float4 lo = make_float4(0.0f, 0.0f, 0.0f, 0.0f), hi = lo;
      if (r < valid) {
        const uint4 w =
            *reinterpret_cast<const uint4*>(src + (int64_t)r * D + c);
        const float2 a = fa_bf16x2(w.x), b = fa_bf16x2(w.y),
                     e = fa_bf16x2(w.z), f = fa_bf16x2(w.w);
        lo = make_float4(a.x, a.y, b.x, b.y);
        hi = make_float4(e.x, e.y, f.x, f.y);
      }
      *reinterpret_cast<float4*>(dst + r * stride + c) = lo;
      *reinterpret_cast<float4*>(dst + r * stride + c + 4) = hi;
    }
  } else {
    const int d4 = (D + 3) & ~3;
    for (int u = threadIdx.x; u < n * d4; u += NT) {
      const int r = u / d4, c = u - r * d4;
      dst[r * stride + c] =
          r < valid && c < D ? fa_load(src + (int64_t)r * D + c) : 0.0f;
    }
  }
}

__device__ __forceinline__ void fa_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void fa_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// BQ query rows a CTA, 2 BQ threads.
template <typename T, bool VEC, bool WIDE, int BQ>
__global__ void __launch_bounds__(2 * BQ, 1) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv, int Sq,
    int Skv, int D, int causal, float scale) {
  constexpr int NT = 2 * BQ;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                      // BQ x FA_MAX_D
  float* sK = sQ + BQ * FA_MAX_D;        // 2 slots of FA_BK x FA_K_STRIDE
  float* sV = sK + 2 * FA_K_SLOT;        // 2 slots of FA_BK x FA_MAX_D
  float* sP = sV + 2 * FA_V_SLOT;        // BQ x FA_BK

  const int tid = threadIdx.x, tx = tid & 15;
  const int bh = blockIdx.x;                        // b * Hq + h
  const int qt = gridDim.y - 1 - blockIdx.y;        // longest tiles first
  const int b = bh / Hq, h = bh % Hq;
  const int64_t kv_head = (int64_t)b * Hkv + h / (Hq / Hkv);
  const T* qb = q + (int64_t)bh * Sq * D;
  const T* kb = k + kv_head * Skv * D;
  const T* vb = v + kv_head * Skv * D;
  T* ob = o + (int64_t)bh * Sq * D;

  const int q0 = qt * BQ;
  const int rows = min(BQ, Sq - q0);
  const int offset = Skv - Sq;
  const int n_tiles = fa_n_tiles(q0, rows, Skv, causal, offset);
  const int d4 = (D + 3) & ~3;
  const float sl2 = scale * FATC_LOG2E;

  float m[FA_ROWS], l[FA_ROWS], acc[FA_ROWS][FA_DCOLS];
#pragma unroll
  for (int i = 0; i < FA_ROWS; ++i) {
    m[i] = fa_neg_inf();
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < FA_DCOLS; ++e) acc[i][e] = 0.0f;
  }

  if (n_tiles > 0) {
    fa_stage<T, VEC, WIDE, NT>(sQ, qb + (int64_t)q0 * D, BQ, rows, D, FA_MAX_D);
    const int keys = min(FA_BK, Skv);
    fa_stage<T, VEC, WIDE, NT>(sK, kb, FA_BK, keys, D, FA_K_STRIDE);
    fa_stage<T, VEC, WIDE, NT>(sV, vb, FA_BK, keys, D, FA_MAX_D);
    fa_commit();
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * FA_BK;
    fa_wait_all();
    // tile j is in its slot for every thread, and every thread is done
    // with tile j - 1, whose slot takes tile j + 1
    __syncthreads();
    if (j + 1 < n_tiles) {
      const int k1 = k0 + FA_BK, nxt = (j + 1) & 1;
      const int keys = min(FA_BK, Skv - k1);
      fa_stage<T, VEC, WIDE, NT>(sK + nxt * FA_K_SLOT, kb + (int64_t)k1 * D,
                           FA_BK, keys, D, FA_K_STRIDE);
      fa_stage<T, VEC, WIDE, NT>(sV + nxt * FA_V_SLOT, vb + (int64_t)k1 * D,
                           FA_BK, keys, D, FA_MAX_D);
      fa_commit();
    }
    const float* sKj = sK + (j & 1) * FA_K_SLOT;
    const float* sVj = sV + (j & 1) * FA_V_SLOT;

    // S = Q K^T over the thread's 8 x 4 micro-tile (raw dot products)
    float s[FA_ROWS][FA_KEYS];
#pragma unroll
    for (int i = 0; i < FA_ROWS; ++i)
#pragma unroll
      for (int c = 0; c < FA_KEYS; ++c) s[i][c] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < d4; d += 4) {
      float4 kv[FA_KEYS];
#pragma unroll
      for (int c = 0; c < FA_KEYS; ++c)
        kv[c] = *reinterpret_cast<const float4*>(
            &sKj[fa_key(tid, c) * FA_K_STRIDE + d]);
#pragma unroll
      for (int i = 0; i < FA_ROWS; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(
            &sQ[fa_row(tid, i) * FA_MAX_D + d]);
#pragma unroll
        for (int c = 0; c < FA_KEYS; ++c) {
          float a = s[i][c];
          a = fmaf(qv.x, kv[c].x, a);
          a = fmaf(qv.y, kv[c].y, a);
          a = fmaf(qv.z, kv[c].z, a);
          a = fmaf(qv.w, kv[c].w, a);
          s[i][c] = a;
        }
      }
    }

    // Online softmax, row by row; a row's 16 lanes are one half warp,
    // so xor shuffles of 8 .. 1 stay inside it.
    const bool masked = fa_tile_needs_mask(k0, q0, Skv, causal, offset);
#pragma unroll
    for (int i = 0; i < FA_ROWS; ++i) {
      float mc = fa_neg_inf();
      if (masked) {
        const int lim =
            fatc_row_limit(q0 + fa_row(tid, i), k0, Skv, causal, offset);
#pragma unroll
        for (int c = 0; c < FA_KEYS; ++c)
          s[i][c] = fatc_score(s[i][c], fa_key(tid, c) < lim);
      }
#pragma unroll
      for (int c = 0; c < FA_KEYS; ++c) mc = fmaxf(mc, s[i][c]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xFFFFFFFFu, mc, off));
      const FatcRescale rs = fatc_rescale(m[i], mc, sl2);
      float ps = 0.0f;
#pragma unroll
      for (int c = 0; c < FA_KEYS; ++c) {
        s[i][c] = fatc_prob(s[i][c], rs.m_neg, sl2);
        ps += s[i][c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xFFFFFFFFu, ps, off);
      l[i] = rs.alpha * l[i] + ps;
#pragma unroll
      for (int e = 0; e < FA_DCOLS; ++e) acc[i][e] *= rs.alpha;
      m[i] = rs.m_new;
    }
    // P's rows: written and read by the same half warp (the last tile's
    // reads of them came before these writes in every lane's order)
    __syncwarp();
#pragma unroll
    for (int i = 0; i < FA_ROWS; ++i)
#pragma unroll
      for (int c = 0; c < FA_KEYS; ++c)
        sP[fa_row(tid, i) * FA_BK + fa_key(tid, c)] = s[i][c];
    __syncwarp();

    // O += P V over the thread's 8 x 8 micro-tile; past the keys P is 0
    // and the V rows are zeros.
#pragma unroll 2
    for (int kk = 0; kk < FA_BK; kk += 4) {
      float4 p4[FA_ROWS];
#pragma unroll
      for (int i = 0; i < FA_ROWS; ++i)
        p4[i] = *reinterpret_cast<const float4*>(
            &sP[fa_row(tid, i) * FA_BK + kk]);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* vrow = &sVj[(kk + t) * FA_MAX_D];
        const float4 va = *reinterpret_cast<const float4*>(&vrow[fa_dcol(tid, 0)]);
        const float4 vc = *reinterpret_cast<const float4*>(&vrow[fa_dcol(tid, 4)]);
#pragma unroll
        for (int i = 0; i < FA_ROWS; ++i) {
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
  for (int i = 0; i < FA_ROWS; ++i) {
    const int r = fa_row(tid, i);
    if (r >= rows) continue;
    T* orow = ob + (int64_t)(q0 + r) * D;
#pragma unroll
    for (int e = 0; e < FA_DCOLS; ++e) {
      const int col = fa_dcol(tid, e);
      if (col < D) fa_store(orow + col, fa_finalize(acc[i][e], l[i]));
    }
  }
}

template <typename T, bool VEC, bool WIDE, int BQ>
static int fa_launch(const void* q, const void* k, const void* v, void* o,
                     int B, int Hq, int Hkv, int Sq, int Skv, int D,
                     int causal, float scale, cudaStream_t stream) {
  const int smem = FA_SMEM_FLOATS(BQ) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, VEC, WIDE, BQ>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * Hq), (unsigned)((Sq + BQ - 1) / BQ));
  flash_attention_kernel<T, VEC, WIDE, BQ><<<grid, 2 * BQ, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, Hq, Hkv, Sq, Skv, D,
      causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, bool VEC, bool WIDE>
static int fa_launch_rows(const void* q, const void* k, const void* v,
                          void* o, int B, int Hq, int Hkv, int Sq, int Skv,
                          int D, int causal, float scale,
                          cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  auto launch = fa_tile_rows(B * Hq, Sq, sms) == FA_BQ
                    ? fa_launch<T, VEC, WIDE, FA_BQ>
                    : fa_launch<T, VEC, WIDE, FA_BQ_SHORT>;
  return launch(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal, scale, stream);
}

// Plain C entry point for ctypes.  dtype: 0 = fp32, 1 = bf16.  Launches
// on the given stream and returns the CUDA error code (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int B, int Hq, int Hkv, int Sq,
                                      int Skv, int D, int causal, float scale,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int elt = dtype == 1 ? 2 : 4;
  const bool wide =
      fa_vector_path(elt, D, (uint64_t)q, (uint64_t)k, (uint64_t)v);
  if (dtype == 1)
    return wide ? fa_launch_rows<__nv_bfloat16, false, true>(
                      q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal, scale, st)
                : fa_launch_rows<__nv_bfloat16, false, false>(
                      q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal, scale, st);
  return wide ? fa_launch_rows<float, true, false>(q, k, v, o, B, Hq, Hkv, Sq,
                                                   Skv, D, causal, scale, st)
              : fa_launch_rows<float, false, false>(q, k, v, o, B, Hq, Hkv,
                                                    Sq, Skv, D, causal, scale,
                                                    st);
}
