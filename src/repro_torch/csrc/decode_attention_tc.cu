// Single-token GQA decode attention over a KV cache on Hopper's tensor
// cores (sm_90a), for bf16 at head dim 64 or 128 and groups up to 16.
//
// Replaces the Pallas TPU kernel decode_attention_pallas
// (src/repro/kernels/decode_attention/decode_attention.py, _kernel) on the
// route the wrapper (kernels/decode_attention/ops.py, tensor_core_route)
// gives it; fp32, and every other shape, stay on decode_attention.cu.  The
// function is the same: q (B, Hq, D) contiguous; k and v (B, Hkv, S, D)
// given by their strides (D contiguous, rows 16-byte aligned), so the LM
// path passes a transposed view of its (B, S, Hkv, D) cache with no copy;
// query head h reads KV head h / (Hq / Hkv); keys at or past a row's
// kv_len are masked; out (B, Hq, D) bf16 (normalised, or the
// unnormalised accumulator with return_partial 1; with return_partial 2
// that accumulator in fp32), m and l (B, Hq) fp32; a
// row with no valid key gives 0, -inf, 0.  Scores, softmax and
// accumulators are fp32.
//
// What bounds it on an H100: bytes.  Each key and value is read once for
// all the query heads of its group; at the LM path's shape (B=2, Hkv=8,
// S=8208, kv_len 8193, D=128) that is 67.2 MB a launch, 20 us at
// 3.35 TB/s, against ~0.27 GFLOP.
//
// Design.  The CUDA-core kernel (decode_attention.cu) widens K and V to
// fp32 in shared memory (~83 KB a CTA), keeps one tile in flight, runs
// scalar FMA chains with four __syncthreads a tile and merges the slices
// in a second launch.  Here:
//   - K and V stay bf16 in shared memory, in a ring of DATC_STAGES = 3
//     tiles of 64 keys fed by 16-byte cp.async.cg (zero-filled past the
//     slice's last valid key): 32 KB a stage at D = 128, 96 KB a CTA, so
//     two CTAs fit an SM.  Two tiles (64 KB) are in flight per CTA, past
//     the ~38 KB per SM that 3.35 TB/s needs at ~1.5 us of loaded
//     latency.  The 16-byte chunks are XOR-swizzled (datc_slot), so
//     ldmatrix reads no bank twice.  One __syncthreads a tile.
//   - Scores and P.V on the tensor cores with mma.sync m16n8k16 (bf16 in,
//     fp32 accumulate): S^T = K Q^T puts 16 keys in M and the group's
//     heads in N (8, or 16 as two n8 tiles), so a group of 4 wastes half
//     of N and not three quarters of a 16-row M; O^T = V^T P^T puts D in
//     M (V^T by ldmatrix.trans), the heads in N and the keys in K.  P
//     goes from S^T's C fragment to O^T's B fragment through
//     movmatrix.trans, two per n8 tile, and is rounded to bf16 on the way,
//     as the flash kernel's tensor-core route does.  Q's B fragments are
//     read once, into registers.  Why mma.sync and not wgmma: the query
//     side is 4 rows at Mistral-NeMo's group, so wgmma's 64-row M would
//     have to go on the keys, and the work (~0.27 GFLOP a launch) is far
//     below the bytes' time anyway.
//   - Each warp keeps its own online softmax over its 16 keys of every
//     tile (the max over a lane's column by three xor shuffles, l summed
//     per lane and reduced once at the end), so the warps never wait for
//     each other inside a tile; at the slice's end they merge through
//     shared memory into the slice's partial (acc, m, l), fp32 in global
//     memory.
//   - The merge across slices is in the same launch: each CTA fences its
//     partial and adds one to its (b, kv head)'s counter; the CTA that
//     sees n_split - 1 is the last, resets the counter to 0 (the counters
//     need no memset per call) and merges the n_split partials in slice
//     order.  The wrapper keeps the zeroed counters per device and
//     stream.
// The split plan (split_plan_tc in ops.py) runs one wave of one CTA per
// SM: at the LM path's batch of 2, 8 slices of 17 tiles, which beat 15
// and 33 slices on the H100 (PERF.md).  What holds it back there
// is the launch's fixed cost (the first tile's round trip, the merges,
// the tail) against 20 us of bytes: at batch 8 the same kernel moves
// its bytes at a higher rate (chip_smoke.py's path_b8 row).  The
// fragment maps, the swizzle, the mask,
// the softmax and both merges are the __host__ __device__ functions of
// decode_attention_tc.cuh, which the CPU tests replay thread by thread
// with g++.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_attention_tc.cuh"

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ void datc_cp16(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void datc_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void datc_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void datc_ldm(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void datc_ldm_trans(uint32_t addr,
                                               uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a b (m16n8k16, bf16 in, fp32 accumulate)
__device__ __forceinline__ void datc_mma(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t datc_movtrans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

// Two fp32 rounded to a bf16 pair, lo in the low half.
__device__ __forceinline__ uint32_t datc_pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------- kernel
// D: head dim (64 or 128); NT: n8 tiles of query heads (1 for a group
// up to 8, 2 up to 16).
template <int D, int NT>
__global__ void __launch_bounds__(DATC_THREADS, DATC_CTAS_PER_SM)
    decode_attention_tc_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ k,
        const bf16* __restrict__ v, const int* __restrict__ kv_lens,
        int kv_len_all, float* __restrict__ acc_part,
        float* __restrict__ m_part, float* __restrict__ l_part,
        int* __restrict__ counters, bf16* __restrict__ out,
        float* __restrict__ m_out, float* __restrict__ l_out, int Hq,
        int Hkv, int S, int64_t k_sb, int64_t k_sh, int64_t k_ss,
        int64_t v_sb, int64_t v_sh, int64_t v_ss, int split_keys,
        float scale, int return_partial) {
  constexpr int CPR = D / 8;                   // 16-byte chunks of a row
  constexpr int TILE_CHUNKS = DATC_BK * CPR;   // of one tensor's tile
  constexpr int TILE_BYTES = TILE_CHUNKS * 16;
  constexpr int STAGE_BYTES = 2 * TILE_BYTES;  // K then V
  constexpr int KS = D / 16;                   // k16 steps of S^T, m16 tiles of O^T
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int s_last;
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);

  const int split = blockIdx.x, n_split = gridDim.x;
  const int bkv = blockIdx.y;                  // b * Hkv + kv head
  const int b = bkv / Hkv, kvh = bkv - b * Hkv;
  const int group = Hq / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = da_valid_len(kv_lens ? kv_lens[b] : kv_len_all, S);
  const int k_begin = split * split_keys;
  const int k_end = min(k_begin + split_keys, len);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + DATC_BK - 1) / DATC_BK : 0;

  const bf16* kb = k + b * k_sb + kvh * k_sh;
  const bf16* vb = v + b * v_sb + kvh * v_sh;

  // Tile t of the slice into stage st: rows past k_end are zero-filled
  // (nothing read), so P.V meets zeros there, never stale bits.
  auto load_tile = [&](int t, int st) {
    const int k0 = k_begin + t * DATC_BK;
    const uint32_t sk = sbase + st * STAGE_BYTES, sv = sk + TILE_BYTES;
#pragma unroll
    for (int u = 0; u < TILE_CHUNKS / DATC_THREADS; ++u) {
      const int e = u * DATC_THREADS + tid;
      const int r = e / CPR, c = e - r * CPR;
      const bool ok = k0 + r < k_end;
      const int64_t row = ok ? k0 + r : k_begin;
      const uint32_t off = datc_slot(r, c, CPR) * 16;
      datc_cp16(sk + off, kb + row * k_ss + c * 8, ok ? 16 : 0);
      datc_cp16(sv + off, vb + row * v_ss + c * 8, ok ? 16 : 0);
    }
  };

#pragma unroll
  for (int st = 0; st < DATC_STAGES - 1; ++st) {
    if (st < n_tiles) load_tile(st, st);
    datc_commit();
  }

  // Q's B fragments, once: heads past the group are zeros.
  uint32_t qf[NT][KS][2];
  const uint16_t* qb = reinterpret_cast<const uint16_t*>(q) +
                       ((int64_t)b * Hq + (int64_t)kvh * group) * D;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int h = nt * 8 + datc_qb_head(lane);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int d = 16 * ks + datc_qb_d(lane, r, 0);
        qf[nt][ks][r] = h < group ? (uint32_t)qb[h * D + d] |
                                        ((uint32_t)qb[h * D + d + 1] << 16)
                                  : 0u;
      }
  }

  float acc[NT][KS][4];
  float m_run[NT][2], l_run[NT][2];   // heads datc_c_col(lane, 0 / 1)
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      m_run[nt][j] = fa_neg_inf();
      l_run[nt][j] = 0.0f;
    }
#pragma unroll
    for (int mt = 0; mt < KS; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][mt][i] = 0.0f;
  }

  const int wrow = DATC_WARP_KEYS * warp;     // the warp's first key row
  for (int t = 0; t < n_tiles; ++t) {
    datc_wait<DATC_STAGES - 2>();   // this thread's copies of tile t landed
    __syncthreads();                // everyone's; and tile t-1 is done with
    if (t + DATC_STAGES - 1 < n_tiles)
      load_tile(t + DATC_STAGES - 1, (t + DATC_STAGES - 1) % DATC_STAGES);
    datc_commit();
    const uint32_t sk = sbase + (t % DATC_STAGES) * STAGE_BYTES;
    const uint32_t sv = sk + TILE_BYTES;

    // S^T = K Q^T over the warp's 16 keys: even and odd k16 steps in two
    // accumulators, so that the chain of dependent mma is half as long
    float sc[NT][4], sc2[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[nt][i] = sc2[nt][i] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      datc_ldm(sk + datc_slot(wrow + datc_ldm_row(lane, 0),
                              2 * ks + datc_ldm_chunk(lane, 0), CPR) * 16,
               a);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        datc_mma(ks & 1 ? sc2[nt] : sc[nt], a, qf[nt][ks][0], qf[nt][ks][1]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[nt][i] += sc2[nt][i];

    // mask, online softmax, P as O^T's B fragment
    const int kw = k_begin + t * DATC_BK + wrow;
    uint32_t pb[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float s[4], p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[i] = datc_score(sc[nt][i], scale,
                          datc_key_valid(kw + datc_c_row(lane, i), k_end));
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float mc = fmaxf(s[j], s[j + 2]);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          mc = fmaxf(mc, __shfl_xor_sync(0xFFFFFFFFu, mc, off));
        const DatcRescale rs = datc_rescale(m_run[nt][j], mc);
        p[j] = datc_prob(s[j], rs.m_neg);
        p[j + 2] = datc_prob(s[j + 2], rs.m_neg);
        l_run[nt][j] = rs.alpha * l_run[nt][j] + p[j] + p[j + 2];
        m_run[nt][j] = rs.m_new;
#pragma unroll
        for (int mt = 0; mt < KS; ++mt) {
          acc[nt][mt][j] *= rs.alpha;
          acc[nt][mt][j + 2] *= rs.alpha;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        pb[nt][r] = datc_movtrans(
            datc_pack(p[datc_p_reg(r, 0)], p[datc_p_reg(r, 1)]));
    }

    // O^T += V^T P^T
#pragma unroll
    for (int mt = 0; mt < KS; ++mt) {
      uint32_t a[4];
      datc_ldm_trans(sv + datc_slot(wrow + datc_ldm_row(lane, 1),
                                    2 * mt + datc_ldm_chunk(lane, 1), CPR) *
                              16,
                     a);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        datc_mma(acc[nt][mt], a, pb[nt][0], pb[nt][1]);
    }
  }
  datc_wait<0>();
  __syncthreads();                  // the ring is free for the warp merge

  // The warps' states into shared memory: m, l per head, acc per (head, d).
  float* sM = reinterpret_cast<float*>(smem);          // [warp][head]
  float* sL = sM + DATC_WARPS * DATC_MAX_GROUP;
  float* sAcc = sL + DATC_WARPS * DATC_MAX_GROUP;      // [warp][head][d]
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float l = l_run[nt][j];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        l += __shfl_xor_sync(0xFFFFFFFFu, l, off);
      if (lane < 4) {
        const int h = nt * 8 + datc_c_col(lane, j);
        sM[warp * DATC_MAX_GROUP + h] = m_run[nt][j];
        sL[warp * DATC_MAX_GROUP + h] = l;
      }
    }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int mt = 0; mt < KS; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sAcc[(warp * DATC_MAX_GROUP + nt * 8 + datc_c_col(lane, i)) * D +
             16 * mt + datc_c_row(lane, i)] = acc[nt][mt][i];
  __syncthreads();

  // The slice's partial: the warps merged in order 0..3.
  const int64_t part = ((int64_t)bkv * n_split + split) * group;
  for (int e = tid; e < group * D; e += DATC_THREADS) {
    const int h = e / D, d = e - h * D;
    float m = fa_neg_inf();
#pragma unroll
    for (int w = 0; w < DATC_WARPS; ++w) m = fmaxf(m, sM[w * DATC_MAX_GROUP + h]);
    const float m_safe = da_finite_or_zero(m);
    float l = 0.0f, a = 0.0f;
#pragma unroll
    for (int w = 0; w < DATC_WARPS; ++w) {
      const float wt = datc_weight(sM[w * DATC_MAX_GROUP + h], m_safe);
      l += wt * sL[w * DATC_MAX_GROUP + h];
      a += wt * sAcc[(w * DATC_MAX_GROUP + h) * D + d];
    }
    acc_part[(part + h) * D + d] = a;
    if (d == 0) {
      m_part[part + h] = m;
      l_part[part + h] = l;
    }
  }

  // The last CTA of this (b, kv head) merges the slices.
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
  // The slices' m and l into shared memory, all at once; then each
  // (head, column) adds the slices in order 0..n_split-1, its acc loads
  // several in flight.
  const int64_t part0 = (int64_t)bkv * n_split * group;
  float* sMp = reinterpret_cast<float*>(smem);         // [slice][head]
  float* sLp = sMp + n_split * group;
  for (int e = tid; e < n_split * group; e += DATC_THREADS) {
    sMp[e] = __ldcg(m_part + part0 + e);
    sLp[e] = __ldcg(l_part + part0 + e);
  }
  __syncthreads();
  for (int e = tid; e < group * D; e += DATC_THREADS) {
    const int h = e / D, d = e - h * D;
    float m_all = fa_neg_inf();
    for (int i = 0; i < n_split; ++i) m_all = fmaxf(m_all, sMp[i * group + h]);
    const float m_safe = da_finite_or_zero(m_all);
    float l = 0.0f, a = 0.0f;
#pragma unroll 8
    for (int i = 0; i < n_split; ++i) {
      const int p = i * group + h;
      const float wt = datc_weight(sMp[p], m_safe);
      l += wt * sLp[p];
      a += wt * __ldcg(acc_part + (part0 + p) * D + d);
    }
    const int64_t bh = (int64_t)b * Hq + (int64_t)kvh * group + h;
    if (return_partial == 2)   // the fp32 accumulator, for a merge across ranks
      reinterpret_cast<float*>(out)[bh * D + d] = a;
    else
      out[bh * D + d] = __float2bfloat16(return_partial ? a : fa_finalize(a, l));
    if (d == 0) {
      m_out[bh] = m_all;
      l_out[bh] = l;
    }
  }
}

template <int D, int NT>
static int datc_launch(const void* q, const void* k, const void* v,
                       const int* kv_lens, int kv_len_all, float* acc_part,
                       float* m_part, float* l_part, int* counters, void* out,
                       float* m_out, float* l_out, int B, int Hq, int Hkv,
                       int S, int64_t k_sb, int64_t k_sh, int64_t k_ss,
                       int64_t v_sb, int64_t v_sh, int64_t v_ss, int n_split,
                       int split_keys, int return_partial, float scale,
                       cudaStream_t stream) {
  const int smem = DATC_STAGES * 2 * DATC_BK * D * 2;
  const cudaError_t err = cudaFuncSetAttribute(
      decode_attention_tc_kernel<D, NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)n_split, (unsigned)(B * Hkv));
  decode_attention_tc_kernel<D, NT><<<grid, DATC_THREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, kv_lens, kv_len_all,
      acc_part, m_part, l_part, counters, (bf16*)out, m_out, l_out, Hq, Hkv,
      S, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, split_keys, scale,
      return_partial);
  return (int)cudaGetLastError();
}

// Plain C entry point for ctypes.  bf16 only; D 64 or 128; Hq / Hkv at
// most DATC_MAX_GROUP.  kv_lens: (B,) int32 on the device, or null to use
// kv_len_all for every row.  Strides in elements.  The keys are cut into
// n_split slices of split_keys each (a multiple of DATC_BK, n_split *
// split_keys >= S, n_split <= DATC_MAX_SPLIT; the wrapper's
// split_plan_tc).  acc_part (B * Hkv *
// n_split * group * D), m_part and l_part (B * Hkv * n_split * group) are
// fp32 scratch; counters (B * Hkv) int32, zero on entry and left zero.
// Launches one kernel on the given stream and returns the CUDA error
// code (0 on success; cudaErrorInvalidValue for a shape it does not take).
extern "C" int decode_attention_tc_launch(
    const void* q, const void* k, const void* v, const void* kv_lens,
    int kv_len_all, void* acc_part, void* m_part, void* l_part,
    void* counters, void* out, void* m_out, void* l_out, int B, int Hq,
    int Hkv, int S, int D, int64_t k_sb, int64_t k_sh, int64_t k_ss,
    int64_t v_sb, int64_t v_sh, int64_t v_ss, int n_split, int split_keys,
    int return_partial, float scale, void* stream) {
  const int group = Hq / Hkv;
  if ((D != 64 && D != 128) || group < 1 || group > DATC_MAX_GROUP ||
      split_keys % DATC_BK || n_split < 1 || n_split > DATC_MAX_SPLIT)
    return (int)cudaErrorInvalidValue;
  auto launch = D == 64 ? (group <= 8 ? datc_launch<64, 1> : datc_launch<64, 2>)
                        : (group <= 8 ? datc_launch<128, 1> : datc_launch<128, 2>);
  return launch(q, k, v, (const int*)kv_lens, kv_len_all, (float*)acc_part,
                (float*)m_part, (float*)l_part, (int*)counters, out,
                (float*)m_out, (float*)l_out, B, Hq, Hkv, S, k_sb, k_sh, k_ss,
                v_sb, v_sh, v_ss, n_split, split_keys, return_partial, scale,
                (cudaStream_t)stream);
}
