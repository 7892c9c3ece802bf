// Single-token GQA decode attention over a KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel decode_attention_pallas
// (src/repro/kernels/decode_attention/decode_attention.py, _kernel).
// q (B, Hq, D) contiguous; k and v (B, Hkv, S, D) given by their strides
// (D contiguous), so the LM path passes a transposed view of its
// (B, S, Hkv, D) cache with no copy.  Query head h reads KV head
// h / (Hq / Hkv).  Keys at or past a row's kv_len (one per sequence, or
// one for all) are masked here, so nothing is padded.  Returns out
// (B, Hq, D) in q's type (normalised, or the unnormalised accumulator
// with return_partial), m and l (B, Hq) in fp32; a row with no valid key
// gives 0, -inf, 0.  Scores, softmax and accumulators are fp32.
//
// What bounds it on an H100: bytes.  Each key and value is read once for
// all the query heads of its group; at the LM path's shape (B=2, Hkv=8,
// S=8208, D=128, bf16) that is 67.2 MB a layer, 20 us at 3.35 TB/s,
// against ~0.3 GFLOP.
//
// Design (simple and right first): the TPU kernel walks the KV sequence
// in order on one core with (m, l, acc) in VMEM.  Here B * Hkv is only 16
// at the path's shape, so one CTA per (b, kv head) would leave 116 of the
// 132 SMs idle.  The keys are cut into n_split slices (the wrapper's
// split_plan picks at most two CTAs per SM, one wave) and pass 1 runs
// one 128-thread CTA per (slice, b, kv head): it loops over tiles of 64
// keys staged in shared memory as fp32, the next tile's 16-byte loads
// (eight per tensor per thread) in flight in registers while this tile is
// computed on;
// each thread scores one key for its query rows, one warp per row does
// the online-softmax update with shuffles, and each thread accumulates
// one column of P.V for R rows of the group in registers (R a template
// parameter, P rows past the group kept at zero, so the loop carries no
// predicates).  It writes fp32 partials (acc, m, l) per slice.  Pass 2,
// one CTA per (b, query head), merges the slices by their log-sum-exp
// and normalises.  The rescale, probabilities and merge weights are the
// __host__ __device__ functions of decode_attention.cuh and
// flash_attention.cuh, which the CPU tests compile with g++.
//
// What it leaves on the table: one tile in flight (no deeper cp.async or
// TMA ring); ~83 KB of shared memory a CTA leaves two CTAs per SM; K and
// V are widened to fp32 in shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_attention.cuh"

#define DA_K_STRIDE (DA_MAX_D + 4)   // sK row stride: float4 reads of 8
                                     // rows hit 32 distinct banks
#define DA_UNROLL 8                  // 16-byte loads per tensor per batch
#define DA_P_ROWS (2 * DA_MAX_GROUP) // sP rows; those past the group stay 0
#define DA_SMEM_FLOATS                                                    \
  (DA_BK * DA_K_STRIDE + DA_BK * DA_MAX_D + DA_MAX_GROUP * DA_MAX_D +     \
   DA_P_ROWS * DA_BK + DA_P_ROWS)
#define DA_ROWS_PER_WARP (DA_MAX_GROUP / (DA_THREADS / 32))

__device__ __forceinline__ float da_load(const float* p) { return *p; }
__device__ __forceinline__ float da_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void da_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void da_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes of T widened to fp32 into dst (4 fp32 or 8 bf16 values).
__device__ __forceinline__ void da_widen(const uint4& raw, float* dst,
                                         const float*) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(&raw);
}
__device__ __forceinline__ void da_widen(const uint4& raw, float* dst,
                                         const __nv_bfloat16*) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float4 lo, hi;
  float2 f;
  f = __bfloat1622float2(h[0]); lo.x = f.x; lo.y = f.y;
  f = __bfloat1622float2(h[1]); lo.z = f.x; lo.w = f.y;
  f = __bfloat1622float2(h[2]); hi.x = f.x; hi.y = f.y;
  f = __bfloat1622float2(h[3]); hi.z = f.x; hi.w = f.y;
  *reinterpret_cast<float4*>(dst) = lo;
  *reinterpret_cast<float4*>(dst + 4) = hi;
}

// One batch of a KV tile's 16-byte chunks in registers: chunk
// e = base + u * DA_THREADS + tid is row e / cpr, element (e % cpr) * EPC;
// rows at or past `keys` are zeros.
struct DaBatch {
  uint4 k[DA_UNROLL], v[DA_UNROLL];
};

template <typename T>
__device__ __forceinline__ void da_load_batch(
    DaBatch& t, const T* kb, const T* vb, int64_t k_ss, int64_t v_ss, int k0,
    int keys, int base, int cpr, int chunks, int tid) {
  constexpr int EPC = 16 / sizeof(T);
#pragma unroll
  for (int u = 0; u < DA_UNROLL; ++u) {
    const int e = base + u * DA_THREADS + tid;
    const int r = e / cpr, c = (e - r * cpr) * EPC;
    t.k[u] = t.v[u] = make_uint4(0u, 0u, 0u, 0u);
    if (e < chunks && r < keys) {
      t.k[u] = *reinterpret_cast<const uint4*>(kb + (k0 + r) * k_ss + c);
      t.v[u] = *reinterpret_cast<const uint4*>(vb + (k0 + r) * v_ss + c);
    }
  }
}

template <typename T>
__device__ __forceinline__ void da_store_batch(const DaBatch& t, float* sK,
                                               float* sV, int base, int cpr,
                                               int chunks, int tid) {
  constexpr int EPC = 16 / sizeof(T);
#pragma unroll
  for (int u = 0; u < DA_UNROLL; ++u) {
    const int e = base + u * DA_THREADS + tid;
    const int r = e / cpr, c = (e - r * cpr) * EPC;
    if (e < chunks) {
      const T* tag = nullptr;     // picks the widening for T
      da_widen(t.k[u], &sK[r * DA_K_STRIDE + c], tag);
      da_widen(t.v[u], &sV[r * DA_MAX_D + c], tag);
    }
  }
}

// R: query rows per thread in P.V (a power of two >= group / nsets).
template <typename T, int R>
__global__ void __launch_bounds__(DA_THREADS) decode_attention_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ kv_lens,
    int kv_len_all, float* __restrict__ acc_part, float* __restrict__ m_part,
    float* __restrict__ l_part, int Hq, int Hkv, int S, int D, int64_t k_sb,
    int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss,
    int split_keys, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;                              // DA_BK x DA_K_STRIDE
  float* sV = sK + DA_BK * DA_K_STRIDE;          // DA_BK x DA_MAX_D
  float* sQ = sV + DA_BK * DA_MAX_D;             // DA_MAX_GROUP x DA_MAX_D
  float* sP = sQ + DA_MAX_GROUP * DA_MAX_D;      // DA_P_ROWS x DA_BK
  float* sAlpha = sP + DA_P_ROWS * DA_BK;        // DA_P_ROWS

  const int split = blockIdx.x, n_split = gridDim.x;
  const int bkv = blockIdx.y;                    // b * Hkv + kv head
  const int b = bkv / Hkv, kvh = bkv - b * Hkv;
  const int group = Hq / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = da_valid_len(kv_lens ? kv_lens[b] : kv_len_all, S);
  const int k_begin = split * split_keys;
  const int k_end = min(k_begin + split_keys, len);

  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;
  const T* qb = q + ((int64_t)b * Hq + (int64_t)kvh * group) * D;
  for (int e = tid; e < group * D; e += DA_THREADS) {
    const int g = e / D;
    sQ[g * DA_MAX_D + (e - g * D)] = da_load(qb + e);
  }
  // P rows past the group are read by P.V as zeros (no predicates there)
  for (int e = tid; e < DA_P_ROWS * DA_BK; e += DA_THREADS) sP[e] = 0.0f;
  for (int e = tid; e < DA_P_ROWS; e += DA_THREADS) sAlpha[e] = 0.0f;

  // P.V: this thread owns column col of rows set, set + nsets, ...
  const int nsets = DA_THREADS / D;
  const int set = tid / D, col = tid - set * D;
  const bool owns = set < nsets;
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.0f;
  // Online softmax: warp w owns rows w, w + 4, ...
  float m_row[DA_ROWS_PER_WARP], l_row[DA_ROWS_PER_WARP];
#pragma unroll
  for (int i = 0; i < DA_ROWS_PER_WARP; ++i) {
    m_row[i] = fa_neg_inf();
    l_row[i] = 0.0f;
  }

  constexpr int EPC = 16 / sizeof(T);            // elements per 16 bytes
  const int cpr = D / EPC;                       // 16-byte chunks per row
  const int chunks = DA_BK * cpr;
  constexpr int BATCH = DA_THREADS * DA_UNROLL;
  // The first batch of each tile is loaded while the tile before it is
  // computed on; the rest of a tile (fp32 with D > 64) when it is staged.
  DaBatch next;
  if (k_begin < k_end)
    da_load_batch<T>(next, kb, vb, k_ss, v_ss, k_begin,
                     min(DA_BK, k_end - k_begin), 0, cpr, chunks, tid);
  for (int k0 = k_begin; k0 < k_end; k0 += DA_BK) {
    const int keys = min(DA_BK, k_end - k0);
    __syncthreads();   // sQ, sP staged; the last tile's reads of smem done
    da_store_batch<T>(next, sK, sV, 0, cpr, chunks, tid);
    for (int base = BATCH; base < chunks; base += BATCH) {
      DaBatch rest;
      da_load_batch<T>(rest, kb, vb, k_ss, v_ss, k0, keys, base, cpr, chunks,
                       tid);
      da_store_batch<T>(rest, sK, sV, base, cpr, chunks, tid);
    }
    if (k0 + DA_BK < k_end)
      da_load_batch<T>(next, kb, vb, k_ss, v_ss, k0 + DA_BK,
                       min(DA_BK, k_end - k0 - DA_BK), 0, cpr, chunks, tid);
    __syncthreads();

    // Scores: this thread takes key j for rows tid / DA_BK, + 2, ...
    {
      const int j = tid & (DA_BK - 1);
      for (int g = tid / DA_BK; g < group; g += DA_THREADS / DA_BK) {
        float dot = 0.0f;
        for (int d = 0; d < D; d += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(
              &sK[j * DA_K_STRIDE + d]);
          const float4 qv = *reinterpret_cast<const float4*>(
              &sQ[g * DA_MAX_D + d]);
          dot = fmaf(qv.x, kv.x, dot);
          dot = fmaf(qv.y, kv.y, dot);
          dot = fmaf(qv.z, kv.z, dot);
          dot = fmaf(qv.w, kv.w, dot);
        }
        sP[g * DA_BK + j] = fa_score(dot, scale, j < keys);
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < DA_ROWS_PER_WARP; ++i) {
      const int g = warp + i * (DA_THREADS / 32);
      if (g < group) {   // warp-uniform
        const float s0 = sP[g * DA_BK + lane];
        const float s1 = sP[g * DA_BK + lane + 32];
        float mc = fmaxf(s0, s1);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mc = fmaxf(mc, __shfl_xor_sync(0xFFFFFFFFu, mc, off));
        const FaRescale rs = fa_rescale(m_row[i], mc);
        const float p0 = fa_prob(s0, rs.m_safe), p1 = fa_prob(s1, rs.m_safe);
        sP[g * DA_BK + lane] = p0;
        sP[g * DA_BK + lane + 32] = p1;
        float ps = p0 + p1;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          ps += __shfl_xor_sync(0xFFFFFFFFu, ps, off);
        l_row[i] = rs.alpha * l_row[i] + ps;
        m_row[i] = rs.m_new;
        if (lane == 0) sAlpha[g] = rs.alpha;
      }
    }
    __syncthreads();

    if (owns) {
#pragma unroll
      for (int i = 0; i < R; ++i) acc[i] *= sAlpha[set + i * nsets];
      // keys past `keys` have P = 0 and zero V rows: whole steps of 4
      const int keys4 = (keys + 3) & ~3;
      for (int j = 0; j < keys4; j += 4) {
        const float v0 = sV[(j + 0) * DA_MAX_D + col];
        const float v1 = sV[(j + 1) * DA_MAX_D + col];
        const float v2 = sV[(j + 2) * DA_MAX_D + col];
        const float v3 = sV[(j + 3) * DA_MAX_D + col];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float4 p = *reinterpret_cast<const float4*>(
              &sP[(set + i * nsets) * DA_BK + j]);
          float a = acc[i];
          a = fmaf(p.x, v0, a);
          a = fmaf(p.y, v1, a);
          a = fmaf(p.z, v2, a);
          a = fmaf(p.w, v3, a);
          acc[i] = a;
        }
      }
    }
  }

  // Partials of this slice, (b * Hkv + kvh, split, g): a slice with no
  // valid key leaves acc 0, m -inf, l 0.
  const int64_t part = ((int64_t)bkv * n_split + split) * group;
  if (owns) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int g = set + i * nsets;
      if (g < group) acc_part[(part + g) * D + col] = acc[i];
    }
  }
#pragma unroll
  for (int i = 0; i < DA_ROWS_PER_WARP; ++i) {
    const int g = warp + i * (DA_THREADS / 32);
    if (g < group && lane == 0) {
      m_part[part + g] = m_row[i];
      l_part[part + g] = l_row[i];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(DA_THREADS) decode_attention_merge_kernel(
    const float* __restrict__ acc_part, const float* __restrict__ m_part,
    const float* __restrict__ l_part, T* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out, int Hq, int Hkv,
    int D, int n_split, int return_partial) {
  const int bh = blockIdx.x;                     // b * Hq + h
  const int b = bh / Hq, h = bh - b * Hq;
  const int group = Hq / Hkv;
  const int kvh = h / group, g = h - kvh * group;
  const int64_t part0 = ((int64_t)b * Hkv + kvh) * n_split;

  float m_all = fa_neg_inf();
  for (int i = 0; i < n_split; ++i)
    m_all = fmaxf(m_all, m_part[(part0 + i) * group + g]);
  const float m_safe = da_finite_or_zero(m_all);
  const int d = threadIdx.x;
  float l = 0.0f, acc = 0.0f;
  for (int i = 0; i < n_split; ++i) {
    const int64_t p = (part0 + i) * group + g;
    const float w = da_merge_weight(m_part[p], m_safe);
    l += w * l_part[p];
    if (d < D) acc += w * acc_part[p * D + d];
  }
  if (d < D)
    da_store(out + (int64_t)bh * D + d,
             return_partial ? acc : fa_finalize(acc, l));
  if (d == 0) {
    m_out[bh] = m_all;
    l_out[bh] = l;
  }
}

template <typename T, int R>
static int da_launch_rows(const void* q, const void* k, const void* v,
                          const int* kv_lens, int kv_len_all,
                          float* acc_part, float* m_part, float* l_part,
                          int B, int Hq, int Hkv, int S, int D, int64_t k_sb,
                          int64_t k_sh, int64_t k_ss, int64_t v_sb,
                          int64_t v_sh, int64_t v_ss, int n_split,
                          int split_keys, float scale, cudaStream_t stream) {
  const int smem = DA_SMEM_FLOATS * (int)sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      decode_attention_split_kernel<T, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)n_split, (unsigned)(B * Hkv));
  decode_attention_split_kernel<T, R><<<grid, DA_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, kv_lens, kv_len_all, acc_part,
      m_part, l_part, Hq, Hkv, S, D, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
      split_keys, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int da_launch(const void* q, const void* k, const void* v,
                     const int* kv_lens, int kv_len_all, float* acc_part,
                     float* m_part, float* l_part, void* out, float* m_out,
                     float* l_out, int B, int Hq, int Hkv, int S, int D,
                     int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb,
                     int64_t v_sh, int64_t v_ss, int n_split, int split_keys,
                     int return_partial, float scale, cudaStream_t stream) {
  // rows of P.V per thread: the group over the thread sets of a column
  const int nsets = DA_THREADS / D;
  const int need = (Hq / Hkv + nsets - 1) / nsets;
  auto pass1 = need <= 1 ? da_launch_rows<T, 1>
             : need <= 2 ? da_launch_rows<T, 2>
             : need <= 4 ? da_launch_rows<T, 4>
             : need <= 8 ? da_launch_rows<T, 8>
                         : da_launch_rows<T, 16>;
  const int err = pass1(q, k, v, kv_lens, kv_len_all, acc_part, m_part,
                        l_part, B, Hq, Hkv, S, D, k_sb, k_sh, k_ss, v_sb,
                        v_sh, v_ss, n_split, split_keys, scale, stream);
  if (err != 0) return err;
  decode_attention_merge_kernel<T><<<B * Hq, DA_THREADS, 0, stream>>>(
      acc_part, m_part, l_part, (T*)out, m_out, l_out, Hq, Hkv, D, n_split,
      return_partial);
  return (int)cudaGetLastError();
}

// Plain C entry point for ctypes.  dtype: 0 = fp32, 1 = bf16.  kv_lens:
// (B,) int32 on the device, or null to use kv_len_all for every row.
// Strides are in elements.  Pass 1 cuts the keys into n_split slices of
// split_keys each (a multiple of DA_BK, n_split * split_keys >= S); the
// wrapper's split_plan picks both.  acc_part (B * Hkv * n_split * group
// * D), m_part and l_part (B * Hkv * n_split * group) are fp32 scratch.
// Launches both passes on the given stream and returns the CUDA error
// code (0 on success).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* kv_lens,
    int kv_len_all, void* acc_part, void* m_part, void* l_part, void* out,
    void* m_out, void* l_out, int dtype, int B, int Hq, int Hkv, int S, int D,
    int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
    int64_t v_ss, int n_split, int split_keys, int return_partial,
    float scale, void* stream) {
  if (dtype == 1)
    return da_launch<__nv_bfloat16>(
        q, k, v, (const int*)kv_lens, kv_len_all, (float*)acc_part,
        (float*)m_part, (float*)l_part, out, (float*)m_out, (float*)l_out, B,
        Hq, Hkv, S, D, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, n_split,
        split_keys, return_partial, scale, (cudaStream_t)stream);
  return da_launch<float>(
      q, k, v, (const int*)kv_lens, kv_len_all, (float*)acc_part,
      (float*)m_part, (float*)l_part, out, (float*)m_out, (float*)l_out, B,
      Hq, Hkv, S, D, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, n_split,
      split_keys, return_partial, scale, (cudaStream_t)stream);
}
