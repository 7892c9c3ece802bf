"""The port's decode-attention module against the JAX reference.

The wrapper on CPU tensors (the plain version) is held against the JAX
``decode_attention`` (Pallas, interpret mode on the CPU, ``block_k=256``)
and its oracle ``decode_attention_reference`` at the shapes of
``tests/test_kernels.py``, with that file's tolerances: 2e-5 in fp32 (both
sides sum in fp32, in another order) and 2e-2 in bf16 (one bf16 rounding
of the output, 2**-8 relative).  m and l are fp32 on both sides and are
held to the same numbers.  The partials and their LSE merge are held to
the JAX merge at 1e-4 (``tests/test_kernels.py``'s own bound for the
merge).  Per-row lengths, which the jitted JAX entry point does not take,
are held to the JAX oracle called one row at a time.  The CUDA kernel's
per-row update and merge (``csrc/decode_attention.cuh``) are compiled
with g++ into a host harness that replays the kernel's slices (from
``split_plan``) and tiles, and the tensor-core kernel's header
(``csrc/decode_attention_tc.cuh``) into one that replays its CTAs thread
by thread, fragment by fragment, under the PTX layouts; the kernels
themselves are held against the plain version on a GPU by
``tests/test_torch_gpu.py``.
"""
import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import (
    decode_attention as jax_decode, decode_attention_reference as jax_ref,
    merge_partials as jax_merge)
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_ref_fn
from repro_torch.kernels.decode_attention import (
    BLOCK_K, TC_BLOCK_K, decode_attention, decode_attention_ref, merge_partials,
    split_plan, split_plan_tc, tensor_core_route)
from repro_torch.kernels.native import CSRC_DIR, csrc_define

SHAPES = [   # tests/test_kernels.py's decode cases
    (2, 8, 8, 512, 64, "float32"),       # MHA
    (2, 8, 2, 1024, 64, "float32"),      # GQA 4:1
    (1, 48, 8, 640, 128, "bfloat16"),    # GQA 6:1, S not a block multiple
    (1, 16, 16, 300, 64, "float32"),     # S below one JAX block
]


def _qkv(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, s, d)).astype(np.float32),
            rng.normal(size=(b, hkv, s, d)).astype(np.float32))


def _f32(x):
    return np.array(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    """Equal infinities where both are infinite (rows with no key),
    within ``tol`` elsewhere."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=tol, rtol=tol)


@pytest.mark.parametrize("b,hq,hkv,s,d,dtype", SHAPES)
def test_plain_matches_pallas_and_oracle(b, hq, hkv, s, d, dtype):
    arrays = _qkv(2, b, hq, hkv, s, d)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrays)
    tq, tk, tv = (torch.from_numpy(_f32(a)).to(tdt) for a in (jq, jk, jv))
    out, m, l = decode_attention(tq, tk, tv)
    assert out.dtype == tdt and m.shape == l.shape == (b, hq, 1)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for want in (jax_decode(jq, jk, jv, block_k=256), jax_ref(jq, jk, jv)):
        _close(out.float(), _f32(want[0]), tol)
        _close(m, _f32(want[1]), tol)
        _close(l, _f32(want[2]), tol)


def test_partials_and_merge_match_reference():
    """tests/test_kernels.py's sequence-sharded decode: per-shard partials
    (acc, m, l) against the Pallas kernel's, their merge against the JAX
    merge and the full attention."""
    b, h, s, d, shards = 2, 4, 512, 64, 4
    q, k, v = _qkv(3, b, h, h, s, d)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    parts, jparts = [], []
    for i in range(shards):
        sl = slice(i * s // shards, (i + 1) * s // shards)
        parts.append(decode_attention(tq, tk[:, :, sl],
                                      tv[:, :, sl], return_partial=True))
        jparts.append(jax_decode(jq, jk[:, :, sl], jv[:, :, sl], block_k=64,
                                 return_partial=True))
        for got, want in zip(parts[-1], jparts[-1]):
            _close(got, _f32(want), 2e-5)
    merged = merge_partials(*(list(x) for x in zip(*parts)))
    jmerged = jax_merge(*(list(x) for x in zip(*jparts)))
    full, _, _ = jax_ref(jq, jk, jv)
    for want in (jmerged, full):
        _close(merged, _f32(want), 1e-4)


def test_per_row_kv_len_matches_oracle_row_by_row():
    """A (B,) length tensor, one row with no valid key (kv_len 0: out 0,
    m -inf, l 0) and one past S (clamped to S), against the JAX oracle
    with an int kv_len, one row at a time; and the int form itself."""
    b, hq, hkv, s, d = 5, 8, 2, 200, 64
    q, k, v = _qkv(4, b, hq, hkv, s, d)
    lens = [0, 1, 77, s, s + 9]
    out, m, l = decode_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 kv_len=torch.tensor(lens))
    for i, n in enumerate(lens):
        want = jax_ref_fn(*(jnp.asarray(a[i:i + 1]) for a in (q, k, v)),
                          kv_len=min(n, s))
        for got, w in zip((out, m, l), want):
            _close(got[i:i + 1], _f32(w), 2e-5)
    assert (out[0] == 0).all() and torch.isinf(m[0]).all() and (l[0] == 0).all()
    got = decode_attention(*(torch.from_numpy(a) for a in (q, k, v)), kv_len=77)
    for g, w in zip(got, jax_ref_fn(*(jnp.asarray(a) for a in (q, k, v)),
                                   kv_len=77)):
        _close(g, _f32(w), 2e-5)


def test_wrapper_rejects_unsupported_inputs():
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 1, 4, 2, 16, 32))
    with pytest.raises(ValueError, match="GQA"):
        decode_attention(q[:, :3], k, v)
    for dt in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="dtypes"):
            decode_attention(q.to(dt), k.to(dt), v.to(dt))
    with pytest.raises(ValueError, match="want q"):
        decode_attention(q[:, :, None], k, v)


def test_n_splits_plan():
    """At most two CTAs per SM over B * Hkv (one wave), whole tiles that
    cover S, no empty slice."""
    for b, hkv, s, sms in [(2, 8, 8208, 132), (1, 8, 640, 132),
                           (64, 8, 8208, 132), (1, 1, 10, 132)]:
        n, per = split_plan(b, hkv, s, sms)
        assert per % BLOCK_K == 0
        assert 1 <= n <= max(1, 2 * sms // (b * hkv))
        assert (n - 1) * per < s <= n * per
    assert split_plan(2, 8, 8208, 132) == (15, 576)   # 240 CTAs


_HARNESS = r"""
#include <vector>
#include "decode_attention.cuh"
// Host replay of the CUDA kernel: pass 1 per (b, kv head, slice) and
// query row, the same tiles and per-tile update, into partials; pass 2
// the same merge.  The sums the kernel reduces across threads are plain
// loops here.
extern "C" void da_host(const float* q, const float* k, const float* v,
                        const int* kv_lens, float* out, float* m_out,
                        float* l_out, int B, int Hq, int Hkv, int S, int D,
                        long k_sb, long k_sh, long k_ss, long v_sb,
                        long v_sh, long v_ss, int n_split,
                        int split_keys, int return_partial, float scale) {
  const int group = Hq / Hkv;
  const size_t parts = (size_t)B * Hkv * n_split * group;
  std::vector<float> acc_part(parts * D), m_part(parts), l_part(parts);
  std::vector<float> s(DA_BK), acc(D);
  for (int b = 0; b < B; ++b)
    for (int kvh = 0; kvh < Hkv; ++kvh)
      for (int sp = 0; sp < n_split; ++sp) {
        const int len = da_valid_len(kv_lens[b], S);
        const int k_begin = sp * split_keys;
        const int k_end = k_begin + split_keys < len ? k_begin + split_keys
                                                     : len;
        const float* kb = k + b * k_sb + kvh * k_sh;
        const float* vb = v + b * v_sb + kvh * v_sh;
        for (int g = 0; g < group; ++g) {
          const float* qr = q + ((long)b * Hq + kvh * group + g) * D;
          float m = fa_neg_inf(), l = 0.0f;
          for (int d = 0; d < D; ++d) acc[d] = 0.0f;
          for (int k0 = k_begin; k0 < k_end; k0 += DA_BK) {
            const int keys = DA_BK < k_end - k0 ? DA_BK : k_end - k0;
            float mc = fa_neg_inf();
            for (int j = 0; j < DA_BK; ++j) {
              float dot = 0.0f;
              if (j < keys)
                for (int d = 0; d < D; ++d) dot += qr[d] * kb[(k0 + j) * k_ss + d];
              s[j] = fa_score(dot, scale, j < keys);
              mc = s[j] > mc ? s[j] : mc;
            }
            const FaRescale rs = fa_rescale(m, mc);
            float ps = 0.0f;
            for (int j = 0; j < DA_BK; ++j) {
              s[j] = fa_prob(s[j], rs.m_safe);
              ps += s[j];
            }
            l = rs.alpha * l + ps;
            for (int d = 0; d < D; ++d) {
              float a = rs.alpha * acc[d];
              for (int j = 0; j < keys; ++j) a += s[j] * vb[(k0 + j) * v_ss + d];
              acc[d] = a;
            }
            m = rs.m_new;
          }
          const size_t p = (((size_t)b * Hkv + kvh) * n_split + sp) * group + g;
          m_part[p] = m;
          l_part[p] = l;
          for (int d = 0; d < D; ++d) acc_part[p * D + d] = acc[d];
        }
      }
  for (int bh = 0; bh < B * Hq; ++bh) {
    const int b = bh / Hq, h = bh % Hq, kvh = h / group, g = h % group;
    const size_t p0 = ((size_t)b * Hkv + kvh) * n_split;
    float m_all = fa_neg_inf();
    for (int i = 0; i < n_split; ++i) {
      const float mi = m_part[(p0 + i) * group + g];
      m_all = mi > m_all ? mi : m_all;
    }
    const float m_safe = da_finite_or_zero(m_all);
    float l = 0.0f;
    for (int d = 0; d < D; ++d) acc[d] = 0.0f;
    for (int i = 0; i < n_split; ++i) {
      const size_t p = (p0 + i) * group + g;
      const float w = da_merge_weight(m_part[p], m_safe);
      l += w * l_part[p];
      for (int d = 0; d < D; ++d) acc[d] += w * acc_part[p * D + d];
    }
    for (int d = 0; d < D; ++d)
      out[(long)bh * D + d] = return_partial ? acc[d] : fa_finalize(acc[d], l);
    m_out[bh] = m_all;
    l_out[bh] = l;
  }
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not on PATH: the split plan and merge are not checked")
    d = tmp_path_factory.mktemp("da_host")
    (d / "harness.cpp").write_text(_HARNESS)
    lib = d / "libda_host.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-w",
                    "-I", str(CSRC_DIR), "-o", str(lib), str(d / "harness.cpp")],
                   check=True)
    fn = ctypes.CDLL(str(lib)).da_host
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    fn.argtypes = [P] * 7 + [I] * 5 + [L] * 6 + [I, I, I, ctypes.c_float]
    fn.restype = None
    return fn


@pytest.mark.parametrize("b,hq,hkv,s,d,lens,split_keys,partial,cache_layout", [
    (2, 8, 2, 300, 64, [0, 300], 128, False, False),   # kv_len 0; ragged tail
    (3, 6, 2, 517, 32, [1, 129, 517], None, False, True),   # cache view
    (2, 32, 8, 1000, 128, [1000, 513], None, False, True),  # the LM's heads
    (1, 4, 4, 64, 16, [64], 64, True, False),           # one slice, partial
    (2, 4, 1, 400, 8, [390, 65], 64, True, False),      # slices past kv_len
])
def test_host_kernel_matches_plain(host_kernel, b, hq, hkv, s, d, lens,
                                   split_keys, partial, cache_layout):
    """The kernel's slices, tiles and merge (csrc/decode_attention.cuh),
    built by g++, against the plain version; fp32 on both sides, 2e-5 as
    above.  The slices are ``split_plan``'s on 132 SMs, or the given
    ``split_keys``.  With ``cache_layout`` k and v are the transposed view
    of a (B, S, Hkv, D) cache, as the LM decode path passes them."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(9 + s, b, hq, hkv, s, d))
    if cache_layout:
        k = k.transpose(1, 2).contiguous().transpose(1, 2)
        v = v.transpose(1, 2).contiguous().transpose(1, 2)
    if split_keys is None:
        n_split, split_keys = split_plan(b, hkv, s, 132)
    else:
        n_split = -(-s // split_keys)
    kv = torch.tensor(lens, dtype=torch.int32)
    out = torch.empty_like(q)
    m = torch.empty((b, hq, 1))
    l = torch.empty_like(m)
    host_kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv.data_ptr(),
                out.data_ptr(), m.data_ptr(), l.data_ptr(), b, hq, hkv, s, d,
                *k.stride()[:3], *v.stride()[:3], n_split, split_keys,
                int(partial), d ** -0.5)
    want = decode_attention_ref(q, k, v, kv_len=kv, return_partial=partial)
    for got, w in zip((out, m, l), want):
        _close(got, w, 2e-5)
    assert torch.isfinite(out).all()


# ------------------------------------------- the tensor-core kernel (bf16)
_TC_HARNESS = r"""
#include <cstring>
#include <vector>
#include "decode_attention_tc.cuh"

// The PTX ISA's layouts for mma.m16n8k16 (.bf16, row.col) and for
// ldmatrix / movmatrix, written out here independently of the header: a
// fragment map in the header that disagrees with them gives wrong numbers.
static int ptx_a_row(int t, int e) { return (t >> 2) + 8 * ((e >> 1) & 1); }
static int ptx_a_col(int t, int e) { return 2 * (t & 3) + (e & 1) + 8 * (e >> 2); }
static int ptx_b_row(int t, int e) { return 2 * (t & 3) + (e & 1) + 8 * (e >> 1); }
static int ptx_b_col(int t) { return t >> 2; }
static int ptx_c_row(int t, int e) { return (t >> 2) + 8 * (e >> 1); }
static int ptx_c_col(int t, int e) { return 2 * (t & 3) + (e & 1); }

struct Reg { float h[2]; };          // a 32-bit register: two b16 halves

// ldmatrix.x4 (trans or not) from a tile in "shared memory" (float per
// b16 element, 8 per 16-byte slot): lanes 8j..8j+7 name matrix j's rows.
static void ldm(const float* sm, int cpr, int row0, int chunk0, int trans,
                Reg out[32][4]) {
  int addr[32];
  for (int l = 0; l < 32; ++l)
    addr[l] = datc_slot(row0 + datc_ldm_row(l, trans),
                        chunk0 + datc_ldm_chunk(l, trans), cpr) * 8;
  for (int t = 0; t < 32; ++t)
    for (int j = 0; j < 4; ++j)
      for (int h = 0; h < 2; ++h)
        out[t][j].h[h] = trans
            ? sm[addr[8 * j + 2 * (t & 3) + h] + (t >> 2)]
            : sm[addr[8 * j + (t >> 2)] + 2 * (t & 3) + h];
}

// d += a b over a warp's fragments, through dense 16x16, 16x8 matrices.
static void mma(float d[32][4], Reg a[32][4], Reg b[32][2]) {
  float A[16][16], B[16][8];
  for (int t = 0; t < 32; ++t) {
    for (int e = 0; e < 8; ++e) A[ptx_a_row(t, e)][ptx_a_col(t, e)] = a[t][e >> 1].h[e & 1];
    for (int e = 0; e < 4; ++e) B[ptx_b_row(t, e)][ptx_b_col(t)] = b[t][e >> 1].h[e & 1];
  }
  for (int t = 0; t < 32; ++t)
    for (int e = 0; e < 4; ++e) {
      float s = 0.0f;
      for (int kk = 0; kk < 16; ++kk) s += A[ptx_c_row(t, e)][kk] * B[kk][ptx_c_col(t, e)];
      d[t][e] += s;
    }
}

// movmatrix.trans: lane t's (row t/4, cols 2(t%4)+h) of M^T.
static void movtrans(Reg in[32], Reg out[32]) {
  float M[8][8];
  for (int t = 0; t < 32; ++t)
    for (int h = 0; h < 2; ++h) M[t >> 2][2 * (t & 3) + h] = in[t].h[h];
  for (int t = 0; t < 32; ++t)
    for (int h = 0; h < 2; ++h) out[t].h[h] = M[2 * (t & 3) + h][t >> 2];
}

// One launch, CTA by CTA and thread by thread: D in {64, 128}, group <=
// 16; q, k, v fp32 (P is not rounded: the algorithm, not bf16, is held).
extern "C" void datc_host(const float* q, const float* k, const float* v,
                          const int* kv_lens, float* out, float* m_out,
                          float* l_out, int B, int Hq, int Hkv, int S, int D,
                          long k_sb, long k_sh, long k_ss, long v_sb,
                          long v_sh, long v_ss, int n_split, int split_keys,
                          int return_partial, float scale) {
  const int group = Hq / Hkv, cpr = D / 8, KS = D / 16;
  const int NT = group <= 8 ? 1 : 2;
  const size_t parts = (size_t)B * Hkv * n_split * group;
  std::vector<float> acc_part(parts * D), m_part(parts), l_part(parts);
  std::vector<float> sK(DATC_BK * D), sV(DATC_BK * D);
  static float acc[DATC_WARPS][2][8][32][4];
  static Reg qf[2][8][32][2];
  float m_run[DATC_WARPS][2][32][2], l_run[DATC_WARPS][2][32][2];
  for (int bkv = 0; bkv < B * Hkv; ++bkv) {
    const int b = bkv / Hkv, kvh = bkv % Hkv;
    const int len = da_valid_len(kv_lens[b], S);
    const float* kb = k + b * k_sb + kvh * k_sh;
    const float* vb = v + b * v_sb + kvh * v_sh;
    for (int nt = 0; nt < NT; ++nt)
      for (int ks = 0; ks < KS; ++ks)
        for (int t = 0; t < 32; ++t)
          for (int r = 0; r < 2; ++r)
            for (int h = 0; h < 2; ++h) {
              const int hd = nt * 8 + datc_qb_head(t);
              qf[nt][ks][t][r].h[h] = hd < group
                  ? q[((long)b * Hq + kvh * group + hd) * D + 16 * ks + datc_qb_d(t, r, h)]
                  : 0.0f;
            }
    for (int split = 0; split < n_split; ++split) {
      const int k_begin = split * split_keys;
      const int k_end = k_begin + split_keys < len ? k_begin + split_keys : len;
      const int n_tiles = k_end > k_begin ? (k_end - k_begin + DATC_BK - 1) / DATC_BK : 0;
      for (int w = 0; w < DATC_WARPS; ++w)
        for (int nt = 0; nt < NT; ++nt)
          for (int t = 0; t < 32; ++t) {
            for (int j = 0; j < 2; ++j) {
              m_run[w][nt][t][j] = fa_neg_inf();
              l_run[w][nt][t][j] = 0.0f;
            }
            for (int mt = 0; mt < KS; ++mt)
              for (int i = 0; i < 4; ++i) acc[w][nt][mt][t][i] = 0.0f;
          }
      for (int tile = 0; tile < n_tiles; ++tile) {
        const int k0 = k_begin + tile * DATC_BK;
        for (int e = 0; e < DATC_BK * cpr; ++e) {     // the cp.async copies
          const int r = e / cpr, c = e % cpr;
          const bool ok = k0 + r < k_end;
          for (int x = 0; x < 8; ++x) {
            const int sl = datc_slot(r, c, cpr) * 8 + x;
            sK[sl] = ok ? kb[(k0 + r) * k_ss + c * 8 + x] : 0.0f;
            sV[sl] = ok ? vb[(k0 + r) * v_ss + c * 8 + x] : 0.0f;
          }
        }
        for (int w = 0; w < DATC_WARPS; ++w) {
          const int wrow = DATC_WARP_KEYS * w, kw = k0 + wrow;
          static float sc[2][32][4], sc2[2][32][4];
          static Reg a[32][4], pin[32], pb[2][2][32];
          for (int nt = 0; nt < NT; ++nt)
            for (int t = 0; t < 32; ++t)
              for (int i = 0; i < 4; ++i) sc[nt][t][i] = sc2[nt][t][i] = 0.0f;
          for (int ks = 0; ks < KS; ++ks) {
            ldm(sK.data(), cpr, wrow, 2 * ks, 0, a);
            for (int nt = 0; nt < NT; ++nt) {
              Reg bq[32][2];
              for (int t = 0; t < 32; ++t) { bq[t][0] = qf[nt][ks][t][0]; bq[t][1] = qf[nt][ks][t][1]; }
              mma(ks & 1 ? sc2[nt] : sc[nt], a, bq);
            }
          }
          for (int nt = 0; nt < NT; ++nt) {
            float s[32][4], p[32][4], mc[32];
            for (int t = 0; t < 32; ++t)
              for (int i = 0; i < 4; ++i)
                s[t][i] = datc_score(sc[nt][t][i] + sc2[nt][t][i], scale,
                                     datc_key_valid(kw + datc_c_row(t, i), k_end));
            for (int j = 0; j < 2; ++j) {
              for (int t = 0; t < 32; ++t) mc[t] = s[t][j] > s[t][j + 2] ? s[t][j] : s[t][j + 2];
              for (int off = 4; off < 32; off <<= 1) {      // __shfl_xor_sync
                float nx[32];
                for (int t = 0; t < 32; ++t) nx[t] = mc[t] > mc[t ^ off] ? mc[t] : mc[t ^ off];
                for (int t = 0; t < 32; ++t) mc[t] = nx[t];
              }
              for (int t = 0; t < 32; ++t) {
                const DatcRescale rs = datc_rescale(m_run[w][nt][t][j], mc[t]);
                p[t][j] = datc_prob(s[t][j], rs.m_neg);
                p[t][j + 2] = datc_prob(s[t][j + 2], rs.m_neg);
                l_run[w][nt][t][j] = rs.alpha * l_run[w][nt][t][j] + p[t][j] + p[t][j + 2];
                m_run[w][nt][t][j] = rs.m_new;
                for (int mt = 0; mt < KS; ++mt) {
                  acc[w][nt][mt][t][j] *= rs.alpha;
                  acc[w][nt][mt][t][j + 2] *= rs.alpha;
                }
              }
            }
            for (int r = 0; r < 2; ++r) {
              for (int t = 0; t < 32; ++t)
                for (int h = 0; h < 2; ++h) pin[t].h[h] = p[t][datc_p_reg(r, h)];
              movtrans(pin, pb[nt][r]);
            }
          }
          for (int mt = 0; mt < KS; ++mt) {
            ldm(sV.data(), cpr, wrow, 2 * mt, 1, a);
            for (int nt = 0; nt < NT; ++nt) {
              Reg bp[32][2];
              for (int t = 0; t < 32; ++t) { bp[t][0] = pb[nt][0][t]; bp[t][1] = pb[nt][1][t]; }
              mma(acc[w][nt][mt], a, bp);
            }
          }
        }
      }
      // the warps' states into "shared memory", then merged in warp order
      std::vector<float> sM(DATC_WARPS * DATC_MAX_GROUP, 0.0f),
          sL(DATC_WARPS * DATC_MAX_GROUP, 0.0f),
          sAcc(DATC_WARPS * DATC_MAX_GROUP * D, 0.0f);
      for (int w = 0; w < DATC_WARPS; ++w)
        for (int nt = 0; nt < NT; ++nt) {
          for (int j = 0; j < 2; ++j) {
            float l[32];
            for (int t = 0; t < 32; ++t) l[t] = l_run[w][nt][t][j];
            for (int off = 4; off < 32; off <<= 1) {
              float nx[32];
              for (int t = 0; t < 32; ++t) nx[t] = l[t] + l[t ^ off];
              for (int t = 0; t < 32; ++t) l[t] = nx[t];
            }
            for (int t = 0; t < 4; ++t) {
              const int h = nt * 8 + datc_c_col(t, j);
              sM[w * DATC_MAX_GROUP + h] = m_run[w][nt][t][j];
              sL[w * DATC_MAX_GROUP + h] = l[t];
            }
          }
          for (int mt = 0; mt < KS; ++mt)
            for (int t = 0; t < 32; ++t)
              for (int i = 0; i < 4; ++i)
                sAcc[(w * DATC_MAX_GROUP + nt * 8 + datc_c_col(t, i)) * D +
                     16 * mt + datc_c_row(t, i)] = acc[w][nt][mt][t][i];
        }
      const size_t part = ((size_t)bkv * n_split + split) * group;
      for (int h = 0; h < group; ++h)
        for (int d = 0; d < D; ++d) {
          float m = fa_neg_inf();
          for (int w = 0; w < DATC_WARPS; ++w)
            m = m > sM[w * DATC_MAX_GROUP + h] ? m : sM[w * DATC_MAX_GROUP + h];
          const float m_safe = da_finite_or_zero(m);
          float l = 0.0f, a = 0.0f;
          for (int w = 0; w < DATC_WARPS; ++w) {
            const float wt = datc_weight(sM[w * DATC_MAX_GROUP + h], m_safe);
            l += wt * sL[w * DATC_MAX_GROUP + h];
            a += wt * sAcc[(w * DATC_MAX_GROUP + h) * D + d];
          }
          acc_part[(part + h) * D + d] = a;
          if (d == 0) { m_part[part + h] = m; l_part[part + h] = l; }
        }
    }
    // the last CTA's merge of the slices, in slice order
    const size_t part0 = (size_t)bkv * n_split * group;
    for (int h = 0; h < group; ++h)
      for (int d = 0; d < D; ++d) {
        float m_all = fa_neg_inf();
        for (int i = 0; i < n_split; ++i) {
          const float mi = m_part[part0 + i * group + h];
          m_all = m_all > mi ? m_all : mi;
        }
        const float m_safe = da_finite_or_zero(m_all);
        float l = 0.0f, a = 0.0f;
        for (int i = 0; i < n_split; ++i) {
          const size_t p = part0 + i * group + h;
          const float wt = datc_weight(m_part[p], m_safe);
          l += wt * l_part[p];
          a += wt * acc_part[p * D + d];
        }
        const long bh = (long)b * Hq + kvh * group + h;
        out[bh * D + d] = return_partial ? a : fa_finalize(a, l);
        if (d == 0) { m_out[bh] = m_all; l_out[bh] = l; }
      }
  }
}

// The header's maps, for the tests' own checks.
extern "C" int datc_slot_h(int row, int chunk, int cpr) { return datc_slot(row, chunk, cpr); }
extern "C" int datc_ldm_row_h(int lane, int trans) { return datc_ldm_row(lane, trans); }
extern "C" int datc_ldm_chunk_h(int lane, int trans) { return datc_ldm_chunk(lane, trans); }
extern "C" int datc_c_row_h(int lane, int i) { return datc_c_row(lane, i); }
extern "C" int datc_c_col_h(int lane, int i) { return datc_c_col(lane, i); }
extern "C" int datc_qb_d_h(int lane, int r, int h) { return datc_qb_d(lane, r, h); }
extern "C" int datc_qb_head_h(int lane) { return datc_qb_head(lane); }
"""


@pytest.fixture(scope="module")
def host_tc(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not on PATH: the tensor-core kernel's maps are "
                    "not checked")
    d = tmp_path_factory.mktemp("datc_host")
    (d / "harness.cpp").write_text(_TC_HARNESS)
    lib = d / "libdatc_host.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-w",
                    "-I", str(CSRC_DIR), "-o", str(lib), str(d / "harness.cpp")],
                   check=True)
    lib = ctypes.CDLL(str(lib))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.datc_host.argtypes = [P] * 7 + [I] * 5 + [L] * 6 + [I, I, I, ctypes.c_float]
    lib.datc_host.restype = None
    return lib


@pytest.mark.parametrize("b,hq,hkv,s,d,lens,plan,partial,cache_layout", [
    (4, 32, 8, 1000, 128, [0, 1, 517, 1000], None, False, True),  # ragged
    (2, 32, 8, 1100, 128, [1100, 1025], 3, False, True),   # the LM's heads
    (1, 48, 8, 640, 128, [640], None, False, False),       # group 6
    (2, 8, 2, 300, 64, [0, 300], 2, False, False),         # kv_len 0; D 64
    (2, 32, 2, 300, 128, [300, 17], 1, True, True),        # group 16, partial
    (1, 24, 2, 129, 64, [129], 3, False, False),           # group 12, D 64
    (2, 4, 4, 64, 128, [1, 64], 1, False, False),          # MHA, one tile
    (1, 8, 1, 400, 64, [390], 7, True, False),             # slices past kv_len
])
def test_host_tensor_core_kernel_matches_plain(host_tc, b, hq, hkv, s, d, lens,
                                               plan, partial, cache_layout):
    """The tensor-core kernel's CTAs replayed thread by thread by g++
    (csrc/decode_attention_tc.cuh: the swizzled slots, ldmatrix rows,
    mma and movmatrix fragment maps under the PTX layouts, the key mask,
    the base-2 online softmax per warp, the warps' merge and the last
    CTA's merge of the slices) against the plain version, in fp32 at
    2e-5 as above (P is not rounded to bf16 here: that is the card's
    test).  ``plan``: that many slices of whole tiles, or None for
    ``split_plan_tc`` on 132 SMs."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(21 + s, b, hq, hkv, s, d))
    if cache_layout:
        k = k.transpose(1, 2).contiguous().transpose(1, 2)
        v = v.transpose(1, 2).contiguous().transpose(1, 2)
    if plan is None:
        n_split, split_keys = split_plan_tc(b, hkv, s, 132)
    else:
        split_keys = -(-(-(-s // TC_BLOCK_K)) // plan) * TC_BLOCK_K
        n_split = -(-s // split_keys)
    kv = torch.tensor(lens, dtype=torch.int32)
    out = torch.empty_like(q)
    m = torch.empty((b, hq, 1))
    l = torch.empty_like(m)
    host_tc.datc_host(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv.data_ptr(),
                      out.data_ptr(), m.data_ptr(), l.data_ptr(), b, hq, hkv,
                      s, d, *k.stride()[:3], *v.stride()[:3], n_split,
                      split_keys, int(partial), d ** -0.5)
    want = decode_attention_ref(q, k, v, kv_len=kv, return_partial=partial)
    for got, w in zip((out, m, l), want):
        _close(got, w, 2e-5)
    assert torch.isfinite(out).all()
    empty = kv == 0
    assert (out[empty] == 0).all() and torch.isinf(m[empty]).all()


@pytest.mark.parametrize("cpr", [8, 16])
def test_tensor_core_swizzle_is_conflict_free(host_tc, cpr):
    """Each row's chunks land on distinct slots of that row, and the 8
    rows one 8x8 ldmatrix phase reads (lanes 8j..8j+7, plain and trans)
    fall on 8 distinct 16-byte bank groups (slot mod 8), for every
    16-key block and column pair of a tile."""
    f = host_tc
    for r in range(TC_BLOCK_K):
        slots = {f.datc_slot_h(r, c, cpr) for c in range(cpr)}
        assert slots == set(range(r * cpr, (r + 1) * cpr))
    for row0 in range(0, TC_BLOCK_K, 16):
        for chunk0 in range(0, cpr, 2):
            for trans in (0, 1):
                for j in range(4):
                    banks = {f.datc_slot_h(row0 + f.datc_ldm_row_h(8 * j + i, trans),
                                           chunk0 + f.datc_ldm_chunk_h(8 * j + i, trans),
                                           cpr) % 8 for i in range(8)}
                    assert len(banks) == 8


def test_tensor_core_fragment_maps_cover_tiles(host_tc):
    """The C map covers the 16 x 8 tile once over the warp, heads by
    lane % 4 only (so a lane's softmax state serves its accumulators);
    the Q^T B map covers the 16 x 8 (d, head) tile once."""
    f = host_tc
    c = {(f.datc_c_row_h(t, i), f.datc_c_col_h(t, i))
         for t in range(32) for i in range(4)}
    assert c == {(r, col) for r in range(16) for col in range(8)}
    for t in range(32):
        assert {f.datc_c_col_h(t, i) for i in (0, 2)} == {2 * (t % 4)}
    bq = {(f.datc_qb_d_h(t, r, h), f.datc_qb_head_h(t))
          for t in range(32) for r in range(2) for h in range(2)}
    assert bq == {(dd, n) for dd in range(16) for n in range(8)}


def test_split_plan_tc():
    """One wave of one CTA per SM: at most ``sms`` CTAs over b * hkv (at
    least one slice), whole tiles that cover S, no empty slice; at the
    LM path's decode, 8 slices of 1088 keys."""
    for b, hkv, s, sms in [(2, 8, 8208, 132), (4, 8, 1000, 132),
                           (1, 8, 640, 132), (64, 8, 8208, 132),
                           (1, 1, 10, 132), (1, 1, 10**6, 132),
                           (128, 8, 32768, 132)]:
        n, per = split_plan_tc(b, hkv, s, sms)
        assert per % TC_BLOCK_K == 0
        assert 1 <= n <= max(1, sms // (b * hkv))
        assert (n - 1) * per < s <= n * per
    assert split_plan_tc(2, 8, 8208, 132) == (8, 1088)   # 128 CTAs
    assert split_plan_tc(1, 1, 10**6, 132)[0] <= csrc_define(
        "decode_attention_tc.cuh", "DATC_MAX_SPLIT")


@pytest.mark.parametrize("dtype,d,group,want", [
    (torch.bfloat16, 128, 4, True), (torch.bfloat16, 64, 16, True),
    (torch.bfloat16, 96, 4, False), (torch.bfloat16, 128, 32, False),
    (torch.float32, 128, 4, False), (torch.bfloat16, 32, 1, False)])
def test_tensor_core_route(dtype, d, group, want):
    """bf16 at D 64/128 with a group of at most 16 goes to the
    tensor-core kernel; fp32 and every other shape keep the CUDA-core
    kernel."""
    assert tensor_core_route(dtype, d, group) is want
