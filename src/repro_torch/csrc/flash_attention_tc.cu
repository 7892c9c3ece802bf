// Causal / bidirectional GQA flash attention (forward) on Hopper's tensor
// cores (sm_90a), for bf16 inputs with head dim 64 or 128.
//
// Replaces the Pallas TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/flash_attention.py, _kernel) on the
// route the wrapper (kernels/flash_attention/ops.py) gives it: bf16 and
// D in {64, 128}.  fp32, and bf16 at other head dims, stay on
// flash_attention.cu.  The function is the same: q (B, Hq, Sq, D), k
// and v (B, Hkv, Skv, D), contiguous; query head h reads KV head
// h / (Hq / Hkv) and K/V are never repeated in memory; causal rows see
// keys up to their position + Skv - Sq; keys past Skv are masked; a row
// that sees no key gives exactly 0; scores, the softmax and the
// accumulator are fp32; the output is bf16.
//
// What bounds it on an H100: operations.  At the LM path's shape (B=2,
// Hq=32, Hkv=8, S=8192, D=128, causal) it does 1.1 TFLOP, 1.112 ms at
// the 989 TFLOP/s bf16 tensor rate, against 0.1 ms to move q, k, v and
// o once at 3.35 TB/s; at S=32768 (B=1) 8.894 ms.
//
// Design.  One CTA per (b * Hq, 128-row query tile): two consumer
// warpgroups of 64 rows each (wgmma's M) and one producer warp.  Q
// (128 x D) reaches shared memory once by TMA; K and V tiles of 128 keys
// arrive by TMA into a ring of FATC_STAGES stages, each guarded by a
// "full" mbarrier per operand (the TMA's transaction count) and an
// "empty" one that the 256 consumer threads arrive on when they are done
// with the stage.  One thread of the producer warp waits on "empty" and
// refills the stage, so loads run ahead of both warpgroups and neither
// waits for the other.  Tensor maps are 3-D (D, S, B * H), so rows
// past Sq or Skv of one head are zero-filled by the TMA and never taken
// from the next head; each 128 x D tile is D/64 boxes of 64 columns,
// the widest that the 128-byte swizzle takes.
//   S = Q K^T: wgmma m64n128k16 with both operands in shared memory,
//   K-major (K is stored (keys, D)), 128-byte swizzle descriptors.
//   Softmax: in registers, in the accumulator's layout: a row's 128
//   values lie in the four lanes of one quad, so its max and sum take
//   two xor shuffles; base 2 with scale * log2(e) folded into one FMA
//   per score (flash_attention_tc.cuh).  Only the tiles that cross the
//   diagonal or the end of the keys are masked.
//   O += P V: P is rounded to bf16 in registers, where the S
//   accumulator's layout already is the A fragment of eight k16 steps
//   (register A operand); V (keys, D) is MN-major for this product and
//   is read through the transpose bit with a descriptor for that layout.
// Key tiles wholly above the diagonal are not visited, query tiles with
// no visible key write zeros and load nothing, and the longest query
// tiles are scheduled first.
//
// Numerics: P is rounded to bf16 before P V, as SDPA and FlashAttention
// do (the TPU kernel multiplies an fp32 P by bf16 V).  That moves each
// term of an output by at most 2^-9 relative, well inside the bf16
// tolerance of 2e-2 + 2e-2 |want| that the output's own bf16 rounding
// (2^-9) already needs; the row sums l stay fp32.
//
// The producer is a warp, not a warpgroup: at 288 threads ptxas may give
// every thread 224 registers, so no setmaxnreg is needed (the consumers
// use 162).  What it leaves on the table: inside a warpgroup one tile's
// softmax does not overlap the tensor cores; only the other warpgroup's
// products do.  Issuing the next Q K^T with this P V, as FlashAttention-3
// does, is untried at this 288-thread layout: the builds of that order
// that were timed ran 384 threads (capped at 168 registers a thread,
// where ptxas serialised the wgmmas) or 256 threads with no producer.
// The output is written from registers with 4-byte stores.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention_tc.cuh"

#define FATC_BOX_BYTES (FATC_BK * FATC_BOX_COLS * 2)   // 16 KB: 128 rows x 128 B
#define FATC_TMA_ERROR 1000   // + CUresult: a tensor map could not be built
#define FATC_WAIT_POLLS (1u << 26)

// ---------------------------------------------------------------- PTX
__device__ __forceinline__ void fatc_bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fatc_bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void fatc_bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of the given parity has completed.  A wait that
// never ends (a fault in the pipeline) traps after FATC_WAIT_POLLS polls,
// seconds at least, so the launch fails instead of holding the card.
__device__ __forceinline__ void fatc_bar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == FATC_WAIT_POLLS) __trap();
  }
}

// One box (FATC_BOX_COLS columns x FATC_BK rows of head `head`) by TMA.
__device__ __forceinline__ void fatc_tma_load(uint32_t dst,
                                              const CUtensorMap* map,
                                              int col, int row, int head,
                                              uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head),
      "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, the
// leading and stride byte offsets (16-byte units), layout type 1.
__device__ __forceinline__ uint64_t fatc_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void fatc_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void fatc_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across its issue and its wait.
template <int N>
__device__ __forceinline__ void fatc_fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fatc_fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// ------------------------------------------- wgmma (bf16 in, fp32 out)
// S += A B with A (64 x 16) and B (16 x 128) in shared memory, both K-major.
__device__ __forceinline__ void fatc_wgmma_ss_n128(float (&d)[64], uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O += A B with A (64 x 16) in registers and B (16 x N) in shared memory,
// MN-major (the transpose bit).
__device__ __forceinline__ void fatc_wgmma_rs_n128(float (&d)[64], uint32_t a0,
                                                 uint32_t a1, uint32_t a2,
                                                 uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ void fatc_wgmma_rs_n64(float (&d)[32], uint32_t a0,
                                                 uint32_t a1, uint32_t a2,
                                                 uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t fatc_pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// ------------------------------------------------------------- kernel
__device__ __forceinline__ void fatc_wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// S = Q K^T for one warpgroup: 64 rows x FATC_BK keys, D/16 k-steps of
// 16 columns, each inside one 128-byte swizzled box.  Issued, not waited.
template <int D>
__device__ __forceinline__ void fatc_qk(float (&sc)[FATC_BK / 2],
                                        uint32_t q_rows, uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * FATC_BOX_BYTES + (kk % 4) * 32;
    fatc_wgmma_ss_n128(sc, fatc_desc(q_rows + off, 16, 1024),
                       fatc_desc(k_tile + off, 16, 1024), kk > 0);
  }
}

// O += P V for one warpgroup: FATC_BK / 16 k-steps of 16 keys; V's D
// columns are D / 64 boxes FATC_BOX_BYTES apart.  Issued, not waited.
template <int D>
__device__ __forceinline__ void fatc_pv(float (&acc)[D / 2],
                                        const uint32_t (&p)[FATC_BK / 4],
                                        uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < FATC_BK / 16; ++kk) {
    const uint64_t db =
        fatc_desc(v_tile + kk * 16 * 128, FATC_BOX_BYTES, 1024);
    if constexpr (D == 128)
      fatc_wgmma_rs_n128(acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                         p[4 * kk + 3], db);
    else
      fatc_wgmma_rs_n64(acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                        p[4 * kk + 3], db);
  }
}

// The online-softmax step of one tile for the thread's two rows (halves
// 0 and 1 of the accumulator map): mask if the tile needs it, take each
// row's max over its quad, rescale, and turn the scores into fp32
// probabilities in place; l and m move on, alpha is left for acc.
__device__ __forceinline__ void fatc_softmax(float (&sc)[FATC_BK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int t,
                                             bool masked, int limA, int limB,
                                             float sl2) {
  if (masked) {
#pragma unroll
    for (int i = 0; i < FATC_BK / 2; ++i)
      sc[i] = fatc_score(sc[i], fatc_acc_col(t, i) < (((i >> 1) & 1) ? limB
                                                                     : limA));
  }
  float mc[2] = {fa_neg_inf(), fa_neg_inf()};
#pragma unroll
  for (int i = 0; i < FATC_BK / 2; ++i)
    mc[(i >> 1) & 1] = fmaxf(mc[(i >> 1) & 1], sc[i]);
  float m_neg[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    mc[hf] = fmaxf(mc[hf], __shfl_xor_sync(0xFFFFFFFFu, mc[hf], 1));
    mc[hf] = fmaxf(mc[hf], __shfl_xor_sync(0xFFFFFFFFu, mc[hf], 2));
    const FatcRescale rs = fatc_rescale(m[hf], mc[hf], sl2);
    m[hf] = rs.m_new;
    m_neg[hf] = rs.m_neg;
    alpha[hf] = rs.alpha;
  }
  float ps[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < FATC_BK / 2; ++i) {
    const int hf = (i >> 1) & 1;
    sc[i] = fatc_prob(sc[i], m_neg[hf], sl2);
    ps[hf] += sc[i];
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    ps[hf] += __shfl_xor_sync(0xFFFFFFFFu, ps[hf], 1);
    ps[hf] += __shfl_xor_sync(0xFFFFFFFFu, ps[hf], 2);
    l[hf] = alpha[hf] * l[hf] + ps[hf];
  }
}

// P in bf16 pairs, the A fragments of the k16 steps of P V.
__device__ __forceinline__ void fatc_pack_p(const float (&sc)[FATC_BK / 2],
                                            uint32_t (&p)[FATC_BK / 4]) {
#pragma unroll
  for (int kk = 0; kk < FATC_BK / 16; ++kk)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = fatc_p_reg(kk, a, 0);
      p[4 * kk + a] = fatc_pack_bf16(sc[i], sc[i + 1]);
    }
}

template <int D>
__global__ void __launch_bounds__(FATC_THREADS, 1) flash_attention_tc_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
    int Hq, int Hkv, int Sq, int Skv, int causal, float sl2) {
  constexpr int BOXES = D / FATC_BOX_COLS;             // 1 or 2
  constexpr uint32_t TILE = FATC_BK * D * 2;           // one K or V tile
  constexpr uint32_t QTILE = FATC_BQ * D * 2;

  extern __shared__ __align__(1024) uint8_t fatc_smem[];
  const uint32_t base =
      ((uint32_t)__cvta_generic_to_shared(fatc_smem) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + QTILE;                      // + stage * TILE
  const uint32_t sV = sK + FATC_STAGES * TILE;         // + stage * TILE
  const uint32_t bars = sV + FATC_STAGES * TILE;
  const uint32_t q_full = bars;
  const uint32_t k_full = bars + 8;                    // + 8 * stage
  const uint32_t v_full = k_full + 8 * FATC_STAGES;
  const uint32_t empty = v_full + 8 * FATC_STAGES;

  const int tid = threadIdx.x;
  const int wg = tid / FATC_WG_THREADS;   // 0, 1: consumers; 2: producer
  const int t = tid % FATC_WG_THREADS;
  const int bh = blockIdx.x;                           // b * Hq + h
  const int qt = gridDim.y - 1 - blockIdx.y;           // longest tiles first
  const int b = bh / Hq, h = bh % Hq;
  const int kv_head = b * Hkv + h / (Hq / Hkv);
  const int q0 = qt * FATC_BQ;
  const int rows = min(FATC_BQ, Sq - q0);
  const int offset = Skv - Sq;
  const int n_tiles = fatc_n_tiles(q0, rows, Skv, causal, offset);

  if (tid == 0 && n_tiles > 0) {
    fatc_bar_init(q_full, 1);
    for (int s = 0; s < FATC_STAGES; ++s) {
      fatc_bar_init(k_full + 8 * s, 1);
      fatc_bar_init(v_full + 8 * s, 1);
      fatc_bar_init(empty + 8 * s, FATC_CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == FATC_CONSUMERS / FATC_WG_THREADS) {
    // ---- producer warp: one thread keeps the ring of K/V stages full
    if (t == 0 && n_tiles > 0) {
      fatc_bar_expect(q_full, QTILE);
#pragma unroll
      for (int c = 0; c < BOXES; ++c)
        fatc_tma_load(sQ + c * FATC_BOX_BYTES, &tq, c * FATC_BOX_COLS, q0, bh,
                      q_full);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % FATC_STAGES;
        if (j >= FATC_STAGES)   // the consumers' release of tile j - STAGES
          fatc_bar_wait(empty + 8 * s, ((j / FATC_STAGES) - 1) & 1);
        fatc_bar_expect(k_full + 8 * s, TILE);
#pragma unroll
        for (int c = 0; c < BOXES; ++c)
          fatc_tma_load(sK + s * TILE + c * FATC_BOX_BYTES, &tk,
                        c * FATC_BOX_COLS, j * FATC_BK, kv_head,
                        k_full + 8 * s);
        fatc_bar_expect(v_full + 8 * s, TILE);
#pragma unroll
        for (int c = 0; c < BOXES; ++c)
          fatc_tma_load(sV + s * TILE + c * FATC_BOX_BYTES, &tv,
                        c * FATC_BOX_COLS, j * FATC_BK, kv_head,
                        v_full + 8 * s);
      }
    }
  } else {
    // ---- consumers: two warpgroups of 64 query rows each
    const int row0 = q0 + wg * FATC_WG_ROWS;           // the warpgroup's rows
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    float m[2] = {fa_neg_inf(), fa_neg_inf()}, l[2] = {0.0f, 0.0f};

    if (n_tiles > 0) {
      const uint32_t q_rows = sQ + wg * FATC_WG_ROWS * 128;
      // The thread's two rows (fatc_acc_row of halves 0 and 1).
      const int rA = row0 + fatc_acc_row(t, 0), rB = row0 + fatc_acc_row(t, 2);
      float sc[FATC_BK / 2], alpha[2];
      uint32_t p[FATC_BK / 4];

      fatc_bar_wait(q_full, 0);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % FATC_STAGES;
        const int k0 = j * FATC_BK;
        fatc_bar_wait(k_full + 8 * s, (j / FATC_STAGES) & 1);
        fatc_wgmma_fence();
        fatc_qk<D>(sc, q_rows, sK + s * TILE);
        fatc_wgmma_commit();
        fatc_wgmma_wait();
        fatc_fence_regs(sc);
        fatc_softmax(sc, m, l, alpha, t,
                     fatc_tile_needs_mask(k0, q0, Skv, causal, offset),
                     fatc_row_limit(rA, k0, Skv, causal, offset),
                     fatc_row_limit(rB, k0, Skv, causal, offset), sl2);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
        fatc_pack_p(sc, p);
        fatc_bar_wait(v_full + 8 * s, (j / FATC_STAGES) & 1);
        fatc_wgmma_fence();
        fatc_pv<D>(acc, p, sV + s * TILE);
        fatc_wgmma_commit();
        fatc_wgmma_wait();
        fatc_fence_regs(acc);
        fatc_fence_regs(p);
        fatc_bar_arrive(empty + 8 * s);
      }
    }

    // ---- o = acc / l in bf16, two adjacent columns per 4-byte store
    __nv_bfloat16* ob = o + (int64_t)bh * Sq * D;
    const float inv[2] = {fa_finalize(1.0f, l[0]), fa_finalize(1.0f, l[1])};
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int hf = (i >> 1) & 1;
      const int r = row0 + fatc_acc_row(t, i);
      if (r < Sq) {
        __nv_bfloat162 pair =
            __floats2bfloat162_rn(acc[i] * inv[hf], acc[i + 1] * inv[hf]);
        *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)r * D +
                                           fatc_acc_col(t, i)) = pair;
      }
    }
  }
}

// --------------------------------------------------------------- host
typedef CUresult (*FatcEncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA driver API, reached through the
// runtime's entry-point query, so that the library needs no -lcuda.
static FatcEncodeTiled fatc_encode_fn() {
  static FatcEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<FatcEncodeTiled>(ptr);
  }
  return fn;
}

// (D, S, B * H) bf16, boxes of FATC_BOX_COLS x FATC_BK x 1, 128-byte
// swizzle; out-of-range rows read as zeros.
static int fatc_map(FatcEncodeTiled encode, CUtensorMap* map, const void* ptr,
                    int D, int S, int BH) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {FATC_BOX_COLS, FATC_BK, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : FATC_TMA_ERROR + (int)r;
}

template <int D>
static int fatc_launch(const void* q, const void* k, const void* v, void* o,
                       int B, int Hq, int Hkv, int Sq, int Skv, int causal,
                       float scale, cudaStream_t stream) {
  FatcEncodeTiled encode = fatc_encode_fn();
  if (encode == nullptr) return FATC_TMA_ERROR;
  CUtensorMap tq, tk, tv;
  int err = fatc_map(encode, &tq, q, D, Sq, B * Hq);
  if (!err) err = fatc_map(encode, &tk, k, D, Skv, B * Hkv);
  if (!err) err = fatc_map(encode, &tv, v, D, Skv, B * Hkv);
  if (err) return err;
  const int smem = 1024 + FATC_BQ * D * 2 + 2 * FATC_STAGES * FATC_BK * D * 2 +
                   8 * (1 + 3 * FATC_STAGES);
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_attention_tc_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return (int)cerr;
  const dim3 grid((unsigned)(B * Hq), (unsigned)((Sq + FATC_BQ - 1) / FATC_BQ));
  flash_attention_tc_kernel<D><<<grid, FATC_THREADS, smem, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, Hq, Hkv, Sq, Skv, causal,
      scale * FATC_LOG2E);
  return (int)cudaGetLastError();
}

// Plain C entry point for ctypes: bf16 q, k, v, o; D must be 64 or 128.
// Launches on the given stream and returns 0, a CUDA error code, or
// FATC_TMA_ERROR (+ the CUresult) if a tensor map was refused.
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* o, int B,
                                         int Hq, int Hkv, int Sq, int Skv,
                                         int D, int causal, float scale,
                                         void* stream) {
  if (D == 128)
    return fatc_launch<128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, scale,
                            (cudaStream_t)stream);
  if (D == 64)
    return fatc_launch<64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, scale,
                           (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
