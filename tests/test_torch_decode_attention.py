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
are held to the JAX oracle called one row at a time.  The CUDA-core
kernel's maps and merges (``csrc/decode_attention.cuh``) are compiled
with g++ into a host harness that replays every CTA of a launch warp by
warp and lane by lane (its slices from ``split_plan``), held against
the plain version and the Pallas kernel, and the tensor-core kernel's header
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
from repro.kernels.decode_attention.decode_attention import \
    decode_attention_pallas
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
    """At most two CTAs per SM over B * Hkv (one wave), whole rounds of
    ``BLOCK_K`` keys that cover S, no empty slice; at the LM path's
    fp32 route (2 x 8 pairs, S = 1026) 11 slices of 96 keys, and 16 of
    544 at the 8208-key cache."""
    for b, hkv, s, sms in [(2, 8, 8208, 132), (1, 8, 640, 132),
                           (64, 8, 8208, 132), (1, 1, 10, 132),
                           (2, 8, 1026, 132), (1, 1, 10**6, 132)]:
        n, per = split_plan(b, hkv, s, sms)
        assert per % BLOCK_K == 0
        assert 1 <= n <= max(1, 2 * sms // (b * hkv))
        assert (n - 1) * per < s <= n * per
    assert BLOCK_K == 32
    assert split_plan(2, 8, 1026, 132) == (11, 96)     # 176 CTAs
    assert split_plan(2, 8, 8208, 132) == (16, 544)    # 256 CTAs


_HARNESS = r"""
#include <cstring>
#include <vector>
#include "decode_attention.cuh"

// Elements: fp32, or bf16 as its 16 bits.
static float to_f(float x) { return x; }
static float to_f(uint16_t x) {
  const uint32_t u = (uint32_t)x << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
static void poison(float* x) { *x = NAN; }
static void poison(uint16_t* x) { *x = 0x7FC0; }   // a bf16 NaN

// Host replay of one launch of decode_attention.cu, CTA by CTA, warp by
// warp and lane by lane: each warp's ring (stages filled with NaN before
// the slice, so a read of a stage no copy wrote shows), the copy map with
// its zero-fill, the teams' reduce-scatter of the chunk's dot products,
// the xor steps of each row's max and sum over the chunk's keys, the rows'
// alpha and p from the lanes that hold them (the kernel's __shfl_sync),
// each lane's online softmax, the states' merge in (warp, team) order into the
// slice's partial, and the last CTA's merge of the slices in slice
// order (or the result written at once for one slice).
template <typename T, int GM, int LPR>
static void replay(const T* q, const T* k, const T* v, const int* kv_lens,
                   float* out, float* m_out, float* l_out, int B, int Hq,
                   int Hkv, int S, int D, long k_sb, long k_sh, long k_ss,
                   long v_sb, long v_sh, long v_ss, int n_split,
                   int split_keys, int return_partial, float scale) {
  constexpr int TEAMS = 32 / LPR, TEAM_KEYS = DA_WARP_KEYS / TEAMS;
  constexpr int KC = da_chunk_keys(GM, TEAM_KEYS), N = KC * GM;
  constexpr int R = da_rs_kept(N, LPR);
  constexpr int EPC = 16 / sizeof(T), STATES = DA_WARPS * TEAMS;
  const int group = Hq / Hkv, cpr = D / EPC, tile = DA_WARP_KEYS * D;
  const size_t parts = (size_t)B * Hkv * n_split * group;
  std::vector<float> acc_part(parts * D), m_part(parts), l_part(parts);
  std::vector<T> ring(DA_STAGES * 2 * tile);
  std::vector<float> sM(STATES * group), sL(STATES * group),
      sAcc(STATES * group * D);
  static float qr[32][GM][4], acc[32][GM][4], m[32][R], l[32][R];
  static float sc[32][N], nx[32][N], vv[32][KC][4];
  static float s[32][R], mc[32][R], p[32][R], alpha[32][R], ps[32][R];
  for (int bkv = 0; bkv < B * Hkv; ++bkv) {
    const int b = bkv / Hkv, kvh = bkv % Hkv;
    const int len = da_valid_len(kv_lens[b], S);
    const T* kb = k + b * k_sb + kvh * k_sh;
    const T* vb = v + b * v_sb + kvh * v_sh;
    const long bh0 = (long)b * Hq + (long)kvh * group;
    for (int split = 0; split < n_split; ++split) {
      const int k_begin = split * split_keys;
      const int k_end = k_begin + split_keys < len ? k_begin + split_keys : len;
      for (int warp = 0; warp < DA_WARPS; ++warp) {
        const int n_tiles = da_warp_tiles(k_end - k_begin, warp);
        for (auto& x : ring) poison(&x);
        auto load = [&](int r, int st) {
          const int k0 = k_begin + da_tile_key(warp, r);
          T* sk = ring.data() + st * 2 * tile;
          for (int lane = 0; lane < 32; ++lane)
            for (int e = lane; e < da_tile_chunks(cpr); e += 32) {
              const int row = da_chunk_row(e, cpr), c = da_chunk_col(e, cpr);
              const bool ok = k0 + row < k_end;
              for (int x = 0; x < EPC; ++x) {
                sk[e * EPC + x] = ok ? kb[(k0 + row) * k_ss + c * EPC + x] : T(0);
                sk[tile + e * EPC + x] = ok ? vb[(k0 + row) * v_ss + c * EPC + x] : T(0);
              }
            }
        };
        for (int st = 0; st < DA_STAGES; ++st)
          if (st < n_tiles) load(st, st);
        for (int lane = 0; lane < 32; ++lane) {
          const int col = da_lane_col(lane, LPR);
          for (int g = 0; g < GM; ++g)
            for (int e = 0; e < 4; ++e) {
              acc[lane][g][e] = 0.0f;
              qr[lane][g][e] = g < group && col < D
                  ? to_f(q[(bh0 + g) * D + col + e]) : 0.0f;
            }
          for (int i = 0; i < R; ++i) {
            m[lane][i] = fa_neg_inf();
            l[lane][i] = 0.0f;
          }
        }
        for (int r = 0; r < n_tiles; ++r) {
          const int st = r % DA_STAGES;
          const T* sK = ring.data() + st * 2 * tile;
          const T* sV = sK + tile;
          const int k0 = k_begin + da_tile_key(warp, r);
          for (int c0 = 0; c0 < TEAM_KEYS; c0 += KC) {
            for (int lane = 0; lane < 32; ++lane) {
              const int team = lane / LPR, col = da_lane_col(lane, LPR);
              for (int j = 0; j < KC; ++j) {
                const int row = da_team_key(team, TEAMS, c0 + j);
                float kk[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                for (int e = 0; e < 4; ++e) vv[lane][j][e] = 0.0f;
                if (col < D)
                  for (int e = 0; e < 4; ++e) {
                    kk[e] = to_f(sK[row * D + col + e]);
                    vv[lane][j][e] = to_f(sV[row * D + col + e]);
                  }
                for (int g = 0; g < GM; ++g) {
                  float d = qr[lane][g][0] * kk[0];
                  d = fmaf(qr[lane][g][1], kk[1], d);
                  d = fmaf(qr[lane][g][2], kk[2], d);
                  sc[lane][j * GM + g] = fmaf(qr[lane][g][3], kk[3], d);
                }
              }
            }
            // the reduce-scatter (DaReduce): xor steps LPR / 2 .. 1
            for (int off = LPR / 2; off > 0; off >>= 1) {
              const int half = da_rs_half(N, LPR, off);
              memcpy(nx, sc, sizeof(sc));
              for (int lane = 0; lane < 32; ++lane) {
                if (half >= 1) {
                  const bool upper = lane & off, partner_upper = !upper;
                  for (int i = 0; i < half; ++i) {
                    const float keep = upper ? nx[lane][i + half] : nx[lane][i];
                    const int o = lane ^ off;
                    const float send = partner_upper ? nx[o][i] : nx[o][i + half];
                    sc[lane][i] = keep + send;
                  }
                } else {
                  sc[lane][0] = nx[lane][0] + nx[lane ^ off][0];
                }
              }
            }
            for (int lane = 0; lane < 32; ++lane) {
              const int team = lane / LPR, f0 = da_rs_base(lane % LPR, LPR, N);
              const bool ok = k0 + da_team_key(team, TEAMS, c0 + f0 / GM) < k_end;
              for (int i = 0; i < R; ++i)
                mc[lane][i] = s[lane][i] = fa_score(sc[lane][i], scale, ok);
            }
            auto xor_steps = [&](float (*x)[R], bool take_max) {
              for (int off = LPR / 2; off * KC >= LPR; off >>= 1) {
                float y[32][R];
                for (int lane = 0; lane < 32; ++lane)
                  for (int i = 0; i < R; ++i) {
                    const float a = x[lane][i], o = x[lane ^ off][i];
                    y[lane][i] = take_max ? (a > o ? a : o) : a + o;
                  }
                memcpy(x, y, sizeof(y));
              }
            };
            xor_steps(mc, true);
            for (int lane = 0; lane < 32; ++lane)
              for (int i = 0; i < R; ++i) {
                const FaRescale rs = fa_rescale(m[lane][i], mc[lane][i]);
                ps[lane][i] = p[lane][i] = fa_prob(s[lane][i], rs.m_safe);
                alpha[lane][i] = rs.alpha;
                m[lane][i] = rs.m_new;
              }
            xor_steps(ps, false);
            for (int lane = 0; lane < 32; ++lane) {
              const int lane0 = lane / LPR * LPR;
              for (int i = 0; i < R; ++i)
                l[lane][i] = alpha[lane][i] * l[lane][i] + ps[lane][i];
              for (int g = 0; g < GM; ++g) {        // __shfl_sync
                const float a = alpha[lane0 + da_rs_lane(g, LPR, N)][g % R];
                for (int e = 0; e < 4; ++e) acc[lane][g][e] *= a;
              }
            }
            for (int lane = 0; lane < 32; ++lane) {
              const int lane0 = lane / LPR * LPR;
              for (int j = 0; j < KC; ++j)
                for (int g = 0; g < GM; ++g) {
                  const int f = j * GM + g;
                  const float pf = p[lane0 + da_rs_lane(f, LPR, N)][f % R];
                  for (int e = 0; e < 4; ++e)
                    acc[lane][g][e] = fmaf(pf, vv[lane][j][e], acc[lane][g][e]);
                }
            }
          }
          if (r + DA_STAGES < n_tiles) load(r + DA_STAGES, st);
        }
        for (int lane = 0; lane < 32; ++lane) {
          const int team = lane / LPR, tl = lane % LPR;
          const int col = da_lane_col(lane, LPR), state = warp * TEAMS + team;
          const int g0 = da_rs_base(tl, LPR, N) % GM;
          for (int i = 0; i < R; ++i) {
            const int g = g0 + i;
            if (g < group && tl == da_rs_lane(g, LPR, N)) {
              sM[state * group + g] = m[lane][i];
              sL[state * group + g] = l[lane][i];
            }
          }
          if (col < D)
            for (int g = 0; g < group; ++g)
              for (int e = 0; e < 4; ++e)
                sAcc[(state * group + g) * D + col + e] = acc[lane][g][e];
        }
      }
      const size_t part = ((size_t)bkv * n_split + split) * group;
      for (int h = 0; h < group; ++h)
        for (int d = 0; d < D; ++d) {
          float mx = fa_neg_inf();
          for (int s = 0; s < STATES; ++s)
            mx = mx > sM[s * group + h] ? mx : sM[s * group + h];
          const float m_safe = da_finite_or_zero(mx);
          float ls = 0.0f, a = 0.0f;
          for (int s = 0; s < STATES; ++s) {
            const float w = da_merge_weight(sM[s * group + h], m_safe);
            ls += w * sL[s * group + h];
            a += w * sAcc[(s * group + h) * D + d];
          }
          if (n_split == 1) {
            out[(bh0 + h) * D + d] = return_partial ? a : fa_finalize(a, ls);
            if (d == 0) { m_out[bh0 + h] = mx; l_out[bh0 + h] = ls; }
          } else {
            acc_part[(part + h) * D + d] = a;
            if (d == 0) { m_part[part + h] = mx; l_part[part + h] = ls; }
          }
        }
    }
    if (n_split == 1) continue;
    const size_t part0 = (size_t)bkv * n_split * group;
    for (int h = 0; h < group; ++h)
      for (int d = 0; d < D; ++d) {
        float m_all = fa_neg_inf();
        for (int i = 0; i < n_split; ++i) {
          const float mi = m_part[part0 + i * group + h];
          m_all = m_all > mi ? m_all : mi;
        }
        const float m_safe = da_finite_or_zero(m_all);
        float ls = 0.0f, a = 0.0f;
        for (int i = 0; i < n_split; ++i) {
          const size_t p = part0 + i * group + h;
          const float w = da_merge_weight(m_part[p], m_safe);
          ls += w * l_part[p];
          a += w * acc_part[p * D + d];
        }
        out[(bh0 + h) * D + d] = return_partial ? a : fa_finalize(a, ls);
        if (d == 0) { m_out[bh0 + h] = m_all; l_out[bh0 + h] = ls; }
      }
  }
}

template <typename T, int LPR>
static void replay_rows(const void* q, const void* k, const void* v,
                        const int* kv_lens, float* out, float* m_out,
                        float* l_out, int B, int Hq, int Hkv, int S, int D,
                        long k_sb, long k_sh, long k_ss, long v_sb, long v_sh,
                        long v_ss, int n_split, int split_keys,
                        int return_partial, float scale) {
  const int group = Hq / Hkv;
  auto run = group <= 1 ? replay<T, 1, LPR> : group <= 2 ? replay<T, 2, LPR>
           : group <= 4 ? replay<T, 4, LPR> : group <= 8 ? replay<T, 8, LPR>
                        : replay<T, 16, LPR>;
  run((const T*)q, (const T*)k, (const T*)v, kv_lens, out, m_out, l_out, B,
      Hq, Hkv, S, D, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, n_split, split_keys,
      return_partial, scale);
}

// The launch entry's dispatch: dtype 0 fp32, 1 bf16; da_row_lanes(D).
extern "C" void da_host(const void* q, const void* k, const void* v,
                        const int* kv_lens, float* out, float* m_out,
                        float* l_out, int dtype, int B, int Hq, int Hkv,
                        int S, int D, long k_sb, long k_sh, long k_ss,
                        long v_sb, long v_sh, long v_ss, int n_split,
                        int split_keys, int return_partial, float scale) {
  const bool wide = da_row_lanes(D) == 32;
  auto run = dtype == 1 ? (wide ? replay_rows<uint16_t, 32> : replay_rows<uint16_t, 16>)
                        : (wide ? replay_rows<float, 32> : replay_rows<float, 16>);
  run(q, k, v, kv_lens, out, m_out, l_out, B, Hq, Hkv, S, D, k_sb, k_sh,
      k_ss, v_sb, v_sh, v_ss, n_split, split_keys, return_partial, scale);
}

// The copy map of one warp tile: how often each 16-byte chunk of the
// tile is copied, and whether its copy is a zero-fill.
extern "C" void da_host_copy_map(int cpr, int n_valid, int* copies,
                                 int* zero) {
  for (int e = 0; e < da_tile_chunks(cpr); ++e) copies[e] = zero[e] = 0;
  for (int lane = 0; lane < 32; ++lane)
    for (int e = lane; e < da_tile_chunks(cpr); e += 32) {
      const int row = da_chunk_row(e, cpr), c = da_chunk_col(e, cpr);
      ++copies[row * cpr + c];
      zero[row * cpr + c] = !(row < n_valid);
    }
}

extern "C" int da_host_warp_tiles(int n_keys, int warp) {
  return da_warp_tiles(n_keys, warp);
}

extern "C" int da_host_rs_base(int l, int lpr, int n) { return da_rs_base(l, lpr, n); }
extern "C" int da_host_rs_lane(int f, int lpr, int n) { return da_rs_lane(f, lpr, n); }
extern "C" int da_host_rs_kept(int n, int lpr) { return da_rs_kept(n, lpr); }
extern "C" int da_host_chunk_keys(int gm, int team_keys) {
  return da_chunk_keys(gm, team_keys);
}

extern "C" int da_host_smem_bytes(int elt, int d, int group, int n_split) {
  return da_smem_bytes(elt, d, group, n_split);
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not on PATH: the kernel's warps are not replayed")
    d = tmp_path_factory.mktemp("da_host")
    (d / "harness.cpp").write_text(_HARNESS)
    lib = d / "libda_host.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-w",
                    "-I", str(CSRC_DIR), "-o", str(lib), str(d / "harness.cpp")],
                   check=True)
    lib = ctypes.CDLL(str(lib))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.da_host.argtypes = [P] * 7 + [I] * 6 + [L] * 6 + [I, I, I, ctypes.c_float]
    lib.da_host.restype = None
    lib.da_host_copy_map.argtypes = [I, I, P, P]
    lib.da_host_copy_map.restype = None
    lib.da_host_warp_tiles.argtypes = [I, I]
    lib.da_host_smem_bytes.argtypes = [I, I, I, I]
    for name in ("da_host_rs_base", "da_host_rs_lane"):
        getattr(lib, name).argtypes = [I, I, I]
    lib.da_host_rs_kept.argtypes = [I, I]
    lib.da_host_chunk_keys.argtypes = [I, I]
    return lib


def _pallas_rows(q, k, v, lens, partial):
    """The Pallas kernel in interpret mode, one call per distinct length
    (its kv_len is an int), on fp32 copies of the inputs laid out (B,
    Hkv, S, D), S padded to whole 64-key blocks → (out, m, l) numpy."""
    b, hq, d = q.shape
    s = k.shape[2]
    s_p = -(-s // 64) * 64
    kp, vp = (np.pad(x.float().contiguous().numpy(),
                     ((0, 0), (0, 0), (0, s_p - s), (0, 0))) for x in (k, v))
    qn = q.float().numpy()
    out = np.zeros((b, hq, d), np.float32)
    m = np.zeros((b, hq, 1), np.float32)
    l = np.zeros((b, hq, 1), np.float32)
    for n in sorted(set(lens)):
        rows = [i for i, x in enumerate(lens) if x == n]
        got = decode_attention_pallas(
            jnp.asarray(qn[rows]), jnp.asarray(kp[rows]), jnp.asarray(vp[rows]),
            block_k=64, kv_len=min(n, s), return_partial=partial,
            interpret=True)
        for dst, src in zip((out, m, l), got):
            dst[rows] = _f32(src)
    return out, m, l


@pytest.mark.parametrize(
    "b,hq,hkv,s,d,dtype,lens,split_keys,partial,cache_layout", [
        (2, 8, 2, 300, 64, "float32", [0, 300], 128, False, False),  # kv_len 0
        (3, 6, 2, 517, 32, "float32", [1, 129, 517], None, False, True),
        (2, 32, 8, 1000, 128, "float32", [1000, 513], None, False, True),
        (1, 4, 4, 64, 16, "float32", [64], 64, True, False),    # one slice
        (2, 4, 1, 400, 8, "float32", [390, 65], 64, True, False),  # past kv_len
        (2, 32, 8, 258, 128, "float32", [257, 257], None, False, True),  # path
        (3, 8, 2, 300, 96, "bfloat16", [300, 77, 0], None, False, True),
        (2, 32, 2, 300, 128, "float32", [300, 17], 96, True, True),  # group 16
        (1, 8, 1, 700, 128, "float32", [700], 352, False, False),  # ring wraps
        (2, 12, 2, 130, 48, "bfloat16", [130, 5], 160, True, False),
    ], ids=["kv_len0", "cache_view", "lm_heads", "one_slice", "past_kv_len",
            "path_fp32", "bf16_d96", "group16_partial", "ring_wraps",
            "bf16_one_slice"])
def test_host_kernel_matches_plain(host_kernel, b, hq, hkv, s, d, dtype,
                                   lens, split_keys, partial, cache_layout):
    """Every CTA of a launch of csrc/decode_attention.cu replayed by g++
    warp by warp and lane by lane (decode_attention.cuh: the warps'
    rings and copy map with its zero-fill, the teams' shuffle sums, each
    lane's online softmax, the states' merge and the last CTA's merge of
    the slices in slice order) against the plain version and the Pallas
    kernel in interpret mode, on the same seeded inputs, fp32 on all
    sides (bf16 inputs as their fp32 values), 2e-5 as above.  The slices
    are ``split_plan``'s on 132 SMs, or the given ``split_keys``; with
    ``cache_layout`` k and v are the transposed view of a (B, S, Hkv, D)
    cache, as the LM decode path passes them."""
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(dt)
               for a in _qkv(9 + s, b, hq, hkv, s, d))
    if cache_layout:
        k = k.transpose(1, 2).contiguous().transpose(1, 2)
        v = v.transpose(1, 2).contiguous().transpose(1, 2)
    if split_keys is None:
        n_split, split_keys = split_plan(b, hkv, s, 132)
    else:
        n_split = -(-s // split_keys)
    assert split_keys % BLOCK_K == 0
    kv = torch.tensor(lens, dtype=torch.int32)
    out = torch.empty((b, hq, d))
    m = torch.empty((b, hq, 1))
    l = torch.empty_like(m)
    host_kernel.da_host(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        kv.data_ptr(), out.data_ptr(), m.data_ptr(),
                        l.data_ptr(), int(dtype == "bfloat16"), b, hq, hkv,
                        s, d, *k.stride()[:3], *v.stride()[:3], n_split,
                        split_keys, int(partial), d ** -0.5)
    want = decode_attention_ref(q.float(), k.float(), v.float(), kv_len=kv,
                                return_partial=partial)
    for got, w in zip((out, m, l), want):
        _close(got, w, 2e-5)
    for got, w in zip((out, m, l), _pallas_rows(q, k, v, lens, partial)):
        _close(got, w, 2e-5)
    assert torch.isfinite(out).all()
    empty = kv == 0
    assert (out[empty] == 0).all() and torch.isinf(m[empty]).all()


@pytest.mark.parametrize("cpr,n_valid", [(32, 8), (32, 3), (16, 0), (12, 5),
                                         (2, 7), (1, 1)])
def test_host_copy_map(host_kernel, cpr, n_valid):
    """A warp tile's copy map (fp32 D 128, 64, 8; bf16 D 96, 16, 8):
    every 16-byte chunk of the tile copied exactly once, the chunks of
    rows at or past the slice's last valid key zero-filled, the rest
    read; and each warp's tiles of a slice cover its tiles once."""
    chunks = csrc_define("decode_attention.cuh", "DA_WARP_KEYS") * cpr
    copies = (ctypes.c_int * chunks)()
    zero = (ctypes.c_int * chunks)()
    host_kernel.da_host_copy_map(cpr, n_valid, copies, zero)
    assert list(copies) == [1] * chunks
    assert list(zero) == [int(e // cpr >= n_valid) for e in range(chunks)]
    warps = csrc_define("decode_attention.cuh", "DA_WARPS")
    for n_keys in (0, 1, 8, 9, 32, 33, 96, 545):
        tiles = sum(host_kernel.da_host_warp_tiles(n_keys, w)
                    for w in range(warps))
        assert tiles == -(-n_keys // 8)


@pytest.mark.parametrize("gm", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("lpr", [16, 32])
def test_host_reduce_scatter_maps(host_kernel, gm, lpr):
    """Every kernel instantiation's reduce-scatter of a chunk's
    N = KC * GM dot products over a team: each value f = j * GM + g is
    held by lpr * R / N lanes (R values a lane, consecutive from a
    multiple of R), ``da_rs_lane`` names the lowest of them, a lane's
    values share one key j, and the lanes of a row g over the chunk's
    keys are those that differ in the top log2(KC) lane bits only."""
    f = host_kernel
    kc = f.da_host_chunk_keys(gm, 8 * lpr // 32)
    n = kc * gm
    r = f.da_host_rs_kept(n, lpr)
    held = {}
    for lane in range(lpr):
        base = f.da_host_rs_base(lane, lpr, n)
        assert base % r == 0 and len({(base + i) // gm for i in range(r)}) == 1
        for i in range(r):
            held.setdefault(base + i, []).append(lane)
    assert sorted(held) == list(range(n))
    for v, lanes in held.items():
        assert len(lanes) == lpr * r // n
        assert f.da_host_rs_lane(v, lpr, n) == min(lanes)
    key_bits = sum(lpr >> (b + 1) for b in range(kc.bit_length() - 1))
    for lane in range(lpr):
        g_of = {(f.da_host_rs_base(x, lpr, n) % gm) for x in range(lpr)
                if x & ~key_bits == lane & ~key_bits}
        keys = {(f.da_host_rs_base(x, lpr, n) // gm) for x in range(lpr)
                if x & ~key_bits == lane & ~key_bits}
        assert len(g_of) == 1 and keys == set(range(kc))


def test_host_smem_fits_two_ctas(host_kernel):
    """The fp32 route's launch at D 128: three 8 KB stages a warp, 96 KB
    a CTA, two CTAs an SM (228 KB); the warps' states and the slices' m
    and l fit in the ring."""
    assert host_kernel.da_host_smem_bytes(4, 128, 4, 11) == 96 * 1024
    assert 2 * (host_kernel.da_host_smem_bytes(4, 128, 16, 264) + 1024) \
        <= 228 * 1024


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
