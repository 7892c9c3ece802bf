// Single-token GQA decode attention over a KV cache on Hopper's CUDA
// cores (sm_90a): fp32, and bf16 at the head dims the tensor-core kernel
// is not built for.
//
// Replaces the Pallas TPU kernel decode_attention_pallas
// (src/repro/kernels/decode_attention/decode_attention.py, _kernel) on the
// route the wrapper (kernels/decode_attention/ops.py, tensor_core_route)
// gives it; bf16 at D 64/128 goes to decode_attention_tc.cu.
// q (B, Hq, D) contiguous; k and v (B, Hkv, S, D) given by their strides
// (D contiguous), so the LM path passes a transposed view of its
// (B, S, Hkv, D) cache with no copy.  Query head h reads KV head
// h / (Hq / Hkv).  Keys at or past a row's kv_len (one per sequence, or
// one for all) are masked here, so nothing is padded.  Returns out
// (B, Hq, D) in q's type (normalised, or the unnormalised accumulator
// with return_partial 1; return_partial 2 writes that accumulator to an
// fp32 out), m and l (B, Hq) in fp32; a row with no valid key
// gives 0, -inf, 0.  Scores, softmax and accumulators are fp32.
//
// What bounds it on an H100: bytes.  Each key and value is read once for
// all the query heads of its group: at phase 4's fp32 route (B=2, Hkv=8,
// kv_len 1025, D=128) 16.8 MB a launch, 5 us at 3.35 TB/s, against
// ~34 MFLOP (0.5 us at the fp32 rate); at the same model's 8208-key
// cache 134 MB, 40 us.
//
// Design (decode_attention.cuh has the maps):
//   - One launch.  The keys are cut into slices (split_plan in ops.py:
//     one wave of DA_CTAS_PER_SM CTAs an SM); a CTA takes one slice of
//     one (b, kv head).  Each CTA fences its partial (acc, m, l) and adds
//     one to its (b, kv head)'s counter; the CTA that sees n_split - 1 is
//     the last, resets the counter to 0 and merges the n_split partials in
//     slice order.  The wrapper keeps the zeroed counters per device and
//     stream (the tensor-core kernel's mechanism).
//   - K and V go straight into shared memory by 16-byte cp.async.cg, in
//     the input's type (fp32 stays fp32; bf16 is widened at use), rows
//     past the slice's last valid key zero-filled.  Each warp has its own
//     ring of DA_STAGES tiles of DA_WARP_KEYS keys and takes the warp
//     tiles w, w + 4, ... of the slice: at fp32 D = 128 a stage is 8 KB,
//     a CTA 96 KB, two CTAs an SM, and the first DA_STAGES tiles of every
//     warp are in flight at once (at phase 4's fp32 route, the whole
//     slice).  No CTA barrier sits in the key loop: a warp waits for its
//     own copies (cp.async.wait_group, __syncwarp).
//   - Lanes own 4 columns of D (float4 loads of a K or V row), in teams
//     of 32 lanes (16 at D <= 64, two teams a warp on alternate keys).
//     A chunk of keys' partial q.k for the group's rows (32 values a
//     lane) is summed over the team by a reduce-scatter of xor shuffles
//     (31 at a team of 32, against 160 for a butterfly of each value), so
//     each lane ends with the sums of one key and one or two rows; it
//     scales and masks them, takes each row's max and sum over the
//     chunk's keys by 3 xor steps, and keeps those rows' (m, l), so
//     each score's exp is computed once.  Every lane then takes the rows'
//     alpha and the chunk's P by shuffles from the lanes that hold them
//     and updates its 4 columns of acc for every row: no shared memory
//     between the scores and P.V.
//   - The warps' and teams' states merge through shared memory once, at
//     the slice's end, in order, 4 columns a thread; the last CTA's
//     merge loads 4 columns of every slice at once.
// The maps and the rescale, probability and merge weights are the
// __host__ __device__ functions of decode_attention.cuh and
// flash_attention.cuh, which the CPU tests replay warp by warp and lane
// by lane with g++.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_attention.cuh"

#define DA_FULL 0xFFFFFFFFu

__device__ __forceinline__ void da_cp16(uint32_t dst, const void* src,
                                        int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void da_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void da_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four consecutive elements as fp32.
__device__ __forceinline__ void da_ld4(const float* p, float (&x)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  x[0] = f.x;
  x[1] = f.y;
  x[2] = f.z;
  x[3] = f.w;
}

__device__ __forceinline__ void da_ld4(const __nv_bfloat16* p,
                                       float (&x)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  x[0] = lo.x;
  x[1] = lo.y;
  x[2] = hi.x;
  x[3] = hi.y;
}

__device__ __forceinline__ void da_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void da_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Element i of out: the normalised output (return_partial 0) or the
// accumulator (1) in T; with return_partial 2 the accumulator to an fp32
// out whatever T is, for a merge across ranks.
template <typename T>
__device__ __forceinline__ void da_store_out(T* out, int64_t i, float a,
                                             float l, int return_partial) {
  if (return_partial == 2)
    reinterpret_cast<float*>(out)[i] = a;
  else
    da_store(out + i, return_partial ? a : fa_finalize(a, l));
}

// The team's reduce-scatter of a chunk's N partial dot products
// (decode_attention.cuh, da_rs_half): the xor step of offset OFF, then
// the next; the indices are compile-time constants, so v stays in
// registers.
template <int N, int LPR, int OFF>
struct DaReduce {
  __device__ __forceinline__ static void run(float (&v)[N], int lane) {
    constexpr int HALF = da_rs_half(N, LPR, OFF);
    const bool upper = (lane & OFF) != 0;
    if constexpr (HALF >= 1) {
#pragma unroll
      for (int i = 0; i < HALF; ++i) {
        const float keep = upper ? v[i + HALF] : v[i];
        const float send = upper ? v[i] : v[i + HALF];
        v[i] = keep + __shfl_xor_sync(DA_FULL, send, OFF);
      }
    } else {
      v[0] += __shfl_xor_sync(DA_FULL, v[0], OFF);
    }
    if constexpr (OFF > 1) DaReduce<N, LPR, OFF / 2>::run(v, lane);
  }
};

// GM: query rows a lane keeps (a power of two >= the group; rows past
// the group hold q = 0 and are never written); LPR: da_row_lanes(D).
template <typename T, int GM, int LPR>
__global__ void __launch_bounds__(DA_THREADS, DA_CTAS_PER_SM)
    decode_attention_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const int* __restrict__ kv_lens,
        int kv_len_all, float* __restrict__ acc_part,
        float* __restrict__ m_part, float* __restrict__ l_part,
        int* __restrict__ counters, T* __restrict__ out,
        float* __restrict__ m_out, float* __restrict__ l_out, int Hq,
        int Hkv, int S, int D, int64_t k_sb, int64_t k_sh, int64_t k_ss,
        int64_t v_sb, int64_t v_sh, int64_t v_ss, int split_keys,
        float scale, int return_partial) {
  constexpr int TEAMS = 32 / LPR;
  constexpr int TEAM_KEYS = DA_WARP_KEYS / TEAMS;
  constexpr int KC = da_chunk_keys(GM, TEAM_KEYS);
  constexpr int N = KC * GM;                   // a chunk's dots a lane
  constexpr int R = da_rs_kept(N, LPR);        // of which it keeps the sums
  constexpr int EPC = 16 / sizeof(T);          // elements of a chunk
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_last;

  const int split = blockIdx.x, n_split = gridDim.x;
  const int bkv = blockIdx.y;                  // b * Hkv + kv head
  const int b = bkv / Hkv, kvh = bkv - b * Hkv;
  const int group = Hq / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = da_valid_len(kv_lens ? kv_lens[b] : kv_len_all, S);
  const int k_begin = split * split_keys;
  const int k_end = min(k_begin + split_keys, len);
  const int n_tiles = da_warp_tiles(k_end - k_begin, warp);

  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;
  const int cpr = D / EPC;                     // 16-byte chunks of a row
  const int tile_bytes = DA_WARP_KEYS * D * (int)sizeof(T);
  const int stage_bytes = 2 * tile_bytes;      // K then V
  uint8_t* ring = smem + warp * DA_STAGES * stage_bytes;
  const uint32_t ring_s = (uint32_t)__cvta_generic_to_shared(ring);

  // Warp tile r into stage st (da_tile_chunks: the copy map).
  auto load_tile = [&](int r, int st) {
    const int k0 = k_begin + da_tile_key(warp, r);
    const uint32_t sk = ring_s + st * stage_bytes, sv = sk + tile_bytes;
    for (int e = lane; e < da_tile_chunks(cpr); e += 32) {
      const int row = da_chunk_row(e, cpr), c = da_chunk_col(e, cpr);
      const bool ok = k0 + row < k_end;
      const int64_t key = ok ? k0 + row : k_begin;
      da_cp16(sk + e * 16, kb + key * k_ss + c * EPC, ok ? 16 : 0);
      da_cp16(sv + e * 16, vb + key * v_ss + c * EPC, ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int st = 0; st < DA_STAGES; ++st) {
    if (st < n_tiles) load_tile(st, st);
    da_commit();
  }

  const int team = lane / LPR, tl = lane % LPR, lane0 = team * LPR;
  const int col = da_lane_col(lane, LPR);
  const bool has_col = col < D;
  // After a chunk's reduce-scatter this lane holds R sums: key jk of the
  // chunk, query rows g0 .. g0 + R - 1, whose (m, l) it keeps.
  const int f0 = da_rs_base(tl, LPR, N);
  const int jk = f0 / GM, g0 = f0 % GM;
  float qr[GM][4], acc[GM][4], m[R], l[R];
  const T* qb = q + ((int64_t)b * Hq + (int64_t)kvh * group) * D;
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int e = 0; e < 4; ++e) qr[g][e] = acc[g][e] = 0.0f;
    if (g < group && has_col) da_ld4(qb + g * D + col, qr[g]);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = fa_neg_inf();
    l[i] = 0.0f;
  }

  for (int r = 0; r < n_tiles; ++r) {
    da_wait<DA_STAGES - 1>();   // this lane's copies of tile r landed
    __syncwarp();               // and the other lanes'
    const int st = r % DA_STAGES;
    const T* sK = reinterpret_cast<const T*>(ring + st * stage_bytes);
    const T* sV = sK + DA_WARP_KEYS * D;
    const int k0 = k_begin + da_tile_key(warp, r);
#pragma unroll
    for (int c0 = 0; c0 < TEAM_KEYS; c0 += KC) {
      float sc[N], vv[KC][4];
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        const int row = da_team_key(team, TEAMS, c0 + j);
        float kk[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int e = 0; e < 4; ++e) vv[j][e] = 0.0f;
        if (has_col) {
          da_ld4(sK + row * D + col, kk);
          da_ld4(sV + row * D + col, vv[j]);
        }
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          float d = qr[g][0] * kk[0];
          d = fmaf(qr[g][1], kk[1], d);
          d = fmaf(qr[g][2], kk[2], d);
          sc[j * GM + g] = fmaf(qr[g][3], kk[3], d);
        }
      }
      DaReduce<N, LPR, LPR / 2>::run(sc, lane);
      // this lane's rows: the max and sum over the chunk's keys are the
      // xor steps over the lane bits that hold the key
      const bool ok = k0 + da_team_key(team, TEAMS, c0 + jk) < k_end;
      float s[R], mc[R], p[R], alpha[R], ps[R];
#pragma unroll
      for (int i = 0; i < R; ++i) mc[i] = s[i] = fa_score(sc[i], scale, ok);
#pragma unroll
      for (int off = LPR / 2; off * KC >= LPR; off >>= 1)
#pragma unroll
        for (int i = 0; i < R; ++i)
          mc[i] = fmaxf(mc[i], __shfl_xor_sync(DA_FULL, mc[i], off));
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const FaRescale rs = fa_rescale(m[i], mc[i]);
        ps[i] = p[i] = fa_prob(s[i], rs.m_safe);
        alpha[i] = rs.alpha;
        m[i] = rs.m_new;
      }
#pragma unroll
      for (int off = LPR / 2; off * KC >= LPR; off >>= 1)
#pragma unroll
        for (int i = 0; i < R; ++i)
          ps[i] += __shfl_xor_sync(DA_FULL, ps[i], off);
#pragma unroll
      for (int i = 0; i < R; ++i) l[i] = alpha[i] * l[i] + ps[i];
      // every row's alpha and every (key, row)'s p from the lane that
      // holds it, into this lane's columns of acc
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float a = __shfl_sync(DA_FULL, alpha[g % R],
                                    lane0 + da_rs_lane(g, LPR, N));
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][e] *= a;
      }
#pragma unroll
      for (int j = 0; j < KC; ++j)
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          const int f = j * GM + g;
          const float pf = __shfl_sync(DA_FULL, p[f % R],
                                       lane0 + da_rs_lane(f, LPR, N));
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[g][e] = fmaf(pf, vv[j][e], acc[g][e]);
        }
    }
    __syncwarp();               // every lane is done with stage st
    if (r + DA_STAGES < n_tiles) load_tile(r + DA_STAGES, st);
    da_commit();
  }
  da_wait<0>();
  __syncthreads();              // every ring is free for the states

  // The states (warp, team) into shared memory: m, l per row (from the
  // lane that holds the row at key 0), acc per (row, column).
  constexpr int STATES = DA_WARPS * TEAMS;
  float* sM = reinterpret_cast<float*>(smem);   // [state][row]
  float* sL = sM + STATES * group;
  float* sAcc = sL + STATES * group;            // [state][row][d]
  const int state = warp * TEAMS + team;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int g = g0 + i;
    if (g < group && tl == da_rs_lane(g, LPR, N)) {
      sM[state * group + g] = m[i];
      sL[state * group + g] = l[i];
    }
  }
  if (has_col) {
#pragma unroll
    for (int g = 0; g < GM; ++g)
      if (g < group)
        *reinterpret_cast<float4*>(&sAcc[(state * group + g) * D + col]) =
            make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  }
  __syncthreads();

  // The slice's partial, 4 columns a thread: the states merged in order.
  // A launch of one slice writes the result itself.
  const int64_t part = ((int64_t)bkv * n_split + split) * group;
  const int64_t bh0 = (int64_t)b * Hq + (int64_t)kvh * group;
  for (int e = 4 * tid; e < group * D; e += 4 * DA_THREADS) {
    const int h = e / D, d = e - h * D;
    float mx = fa_neg_inf();
#pragma unroll
    for (int s = 0; s < STATES; ++s) mx = fmaxf(mx, sM[s * group + h]);
    const float m_safe = da_finite_or_zero(mx);
    float ls = 0.0f, a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int s = 0; s < STATES; ++s) {
      const float w = da_merge_weight(sM[s * group + h], m_safe);
      const float4 x =
          *reinterpret_cast<const float4*>(&sAcc[(s * group + h) * D + d]);
      ls += w * sL[s * group + h];
      a[0] += w * x.x;
      a[1] += w * x.y;
      a[2] += w * x.z;
      a[3] += w * x.w;
    }
    if (n_split == 1) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        da_store_out(out, (bh0 + h) * D + d + c, a[c], ls, return_partial);
      if (d == 0) {
        m_out[bh0 + h] = mx;
        l_out[bh0 + h] = ls;
      }
    } else {
      *reinterpret_cast<float4*>(acc_part + (part + h) * D + d) =
          make_float4(a[0], a[1], a[2], a[3]);
      if (d == 0) {
        m_part[part + h] = mx;
        l_part[part + h] = ls;
      }
    }
  }
  if (n_split == 1) return;

  // The last CTA of this (b, kv head) merges the slices, 4 columns a
  // thread, the slices' loads in flight together.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int done = atomicAdd(counters + bkv, 1);
    s_last = done == n_split - 1;
    if (s_last) counters[bkv] = 0;   // ready for the next launch
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int64_t part0 = (int64_t)bkv * n_split * group;
  float* sMp = reinterpret_cast<float*>(smem);  // [slice][row]
  float* sLp = sMp + n_split * group;
  for (int e = tid; e < n_split * group; e += DA_THREADS) {
    sMp[e] = __ldcg(m_part + part0 + e);
    sLp[e] = __ldcg(l_part + part0 + e);
  }
  __syncthreads();
  for (int e = 4 * tid; e < group * D; e += 4 * DA_THREADS) {
    const int h = e / D, d = e - h * D;
    float m_all = fa_neg_inf();
    for (int i = 0; i < n_split; ++i) m_all = fmaxf(m_all, sMp[i * group + h]);
    const float m_safe = da_finite_or_zero(m_all);
    float ls = 0.0f, a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
    for (int i = 0; i < n_split; ++i) {
      const int p = i * group + h;
      const float w = da_merge_weight(sMp[p], m_safe);
      const float4 x = __ldcg(
          reinterpret_cast<const float4*>(acc_part + (part0 + p) * D + d));
      ls += w * sLp[p];
      a[0] += w * x.x;
      a[1] += w * x.y;
      a[2] += w * x.z;
      a[3] += w * x.w;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      da_store_out(out, (bh0 + h) * D + d + c, a[c], ls, return_partial);
    if (d == 0) {
      m_out[bh0 + h] = m_all;
      l_out[bh0 + h] = ls;
    }
  }
}

template <typename T, int GM, int LPR>
static int da_launch(const void* q, const void* k, const void* v,
                     const int* kv_lens, int kv_len_all, float* acc_part,
                     float* m_part, float* l_part, int* counters, void* out,
                     float* m_out, float* l_out, int B, int Hq, int Hkv,
                     int S, int D, int64_t k_sb, int64_t k_sh, int64_t k_ss,
                     int64_t v_sb, int64_t v_sh, int64_t v_ss, int n_split,
                     int split_keys, int return_partial, float scale,
                     cudaStream_t stream) {
  const int smem = da_smem_bytes((int)sizeof(T), D, Hq / Hkv, n_split);
  const cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<T, GM, LPR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)n_split, (unsigned)(B * Hkv));
  decode_attention_kernel<T, GM, LPR><<<grid, DA_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, kv_lens, kv_len_all, acc_part,
      m_part, l_part, counters, (T*)out, m_out, l_out, Hq, Hkv, S, D, k_sb,
      k_sh, k_ss, v_sb, v_sh, v_ss, split_keys, scale, return_partial);
  return (int)cudaGetLastError();
}

template <typename T, int LPR>
static int da_launch_rows(int group, const void* q, const void* k,
                          const void* v, const int* kv_lens, int kv_len_all,
                          float* acc_part, float* m_part, float* l_part,
                          int* counters, void* out, float* m_out,
                          float* l_out, int B, int Hq, int Hkv, int S, int D,
                          int64_t k_sb, int64_t k_sh, int64_t k_ss,
                          int64_t v_sb, int64_t v_sh, int64_t v_ss,
                          int n_split, int split_keys, int return_partial,
                          float scale, cudaStream_t stream) {
  auto launch = group <= 1   ? da_launch<T, 1, LPR>
              : group <= 2   ? da_launch<T, 2, LPR>
              : group <= 4   ? da_launch<T, 4, LPR>
              : group <= 8   ? da_launch<T, 8, LPR>
                             : da_launch<T, 16, LPR>;
  return launch(q, k, v, kv_lens, kv_len_all, acc_part, m_part, l_part,
                counters, out, m_out, l_out, B, Hq, Hkv, S, D, k_sb, k_sh,
                k_ss, v_sb, v_sh, v_ss, n_split, split_keys, return_partial,
                scale, stream);
}

// Plain C entry point for ctypes.  dtype: 0 = fp32, 1 = bf16; D a
// multiple of 8 up to DA_MAX_D; Hq / Hkv at most DA_MAX_GROUP.  kv_lens:
// (B,) int32 on the device, or null to use kv_len_all for every row.
// Strides in elements.  The keys are cut into n_split slices of
// split_keys each (a multiple of DA_BK, n_split * split_keys >= S; the
// wrapper's split_plan).  acc_part (B * Hkv * n_split * group * D),
// m_part and l_part (B * Hkv * n_split * group) are fp32 scratch;
// counters (B * Hkv) int32, zero on entry and left zero.  Launches one
// kernel on the given stream and returns the CUDA error code (0 on
// success; cudaErrorInvalidValue for a shape it does not take).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* kv_lens,
    int kv_len_all, void* acc_part, void* m_part, void* l_part,
    void* counters, void* out, void* m_out, void* l_out, int dtype, int B,
    int Hq, int Hkv, int S, int D, int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss, int n_split, int split_keys,
    int return_partial, float scale, void* stream) {
  const int group = Hq / Hkv;
  const int elt = dtype == 1 ? 2 : 4;
  if (D < 8 || D > DA_MAX_D || D % 8 || group < 1 ||
      group > DA_MAX_GROUP || split_keys % DA_BK || n_split < 1 ||
      da_smem_bytes(elt, D, group, n_split) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const bool wide = da_row_lanes(D) == 32;
  auto launch = dtype == 1
      ? (wide ? da_launch_rows<__nv_bfloat16, 32> : da_launch_rows<__nv_bfloat16, 16>)
      : (wide ? da_launch_rows<float, 32> : da_launch_rows<float, 16>);
  return launch(group, q, k, v, (const int*)kv_lens, kv_len_all,
                (float*)acc_part, (float*)m_part, (float*)l_part,
                (int*)counters, out, (float*)m_out, (float*)l_out, B, Hq, Hkv,
                S, D, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, n_split, split_keys,
                return_partial, scale, (cudaStream_t)stream);
}
