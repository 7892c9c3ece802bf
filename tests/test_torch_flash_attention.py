"""The port's flash-attention module against the JAX reference.

The wrapper on CPU tensors (the plain version) is held against the JAX
``flash_attention`` (Pallas, interpret mode on the CPU) and its oracle
``flash_attention_reference`` at the shapes of ``tests/test_kernels.py``,
with that file's tolerances: 2e-5 in fp32 (both sides sum in fp32, in
another order) and 2e-2 in bf16 (one bf16 rounding of the output,
2**-8 relative, plus the inputs' own).  The CUDA kernel's per-row update
(``csrc/flash_attention.cuh``) is compiled with g++ into a host harness
that replays the kernel's tiles and is held against the plain version.
The CUDA kernel itself is held against the plain version on a GPU by
``tests/test_torch_gpu.py``.
"""
import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import (
    flash_attention as jax_flash, flash_attention_reference as jax_ref)
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.native import CSRC_DIR

SHAPES = [   # tests/test_kernels.py's flash cases
    (1, 4, 4, 128, 128, 64, True, "float32"),
    (2, 8, 2, 256, 256, 64, True, "float32"),    # GQA 4:1
    (1, 6, 2, 128, 128, 128, True, "bfloat16"),  # GQA 3:1, bf16
    (1, 2, 2, 128, 384, 64, False, "float32"),   # bidirectional, Skv > Sq
    (1, 4, 1, 100, 200, 64, True, "float32"),    # ragged
]


def _qkv(seed, b, hq, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, sq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32))


def _f32(x):
    return np.array(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,dtype", SHAPES)
def test_plain_matches_pallas_and_oracle(b, hq, hkv, sq, skv, d, causal, dtype):
    arrays = _qkv(0, b, hq, hkv, sq, skv, d)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrays)
    # the same (rounded) values on both sides
    tq, tk, tv = (torch.from_numpy(_f32(a)).to(tdt) for a in (jq, jk, jv))
    got = flash_attention(tq, tk, tv, causal=causal).float().numpy()
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for want in (jax_flash(jq, jk, jv, causal=causal, block_q=64, block_k=64),
                 jax_ref(jq, jk, jv, causal=causal)):
        np.testing.assert_allclose(got, _f32(want), atol=tol, rtol=tol)


def test_block_size_invariance():
    """The port at two block choices against the reference at the two of
    ``tests/test_kernels.py``: all four agree to 1e-5."""
    q, k, v = _qkv(1, 1, 2, 2, 256, 256, 64)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    ports = [flash_attention(tq, tk, tv, block_q=64, block_k=64).numpy(),
             flash_attention(tq, tk, tv, block_q=32, block_k=16).numpy()]
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    refs = [_f32(jax_flash(jq, jk, jv, block_q=64, block_k=64)),
            _f32(jax_flash(jq, jk, jv, block_q=128, block_k=32))]
    for got in ports:
        for want in refs:
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_fully_masked_rows_are_zero():
    """Causal with Sq > Skv: the first Sq - Skv rows see no key."""
    q, k, v = _qkv(2, 1, 4, 2, 40, 24, 32)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v))).numpy()
    assert np.isfinite(got).all()
    assert (got[:, :, :16] == 0).all() and (np.abs(got[:, :, 16:]) > 0).any()
    np.testing.assert_allclose(got, _f32(jax_flash(jq, jk, jv)), atol=2e-5,
                               rtol=2e-5)


def test_wrapper_rejects_unsupported_inputs():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 4, 2, 16, 16, 32))
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros((1, 4, 16, 160))
        flash_attention(big, big[:, :2], big[:, :2])
    for dt in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="dtypes"):
            flash_attention(q.to(dt), k.to(dt), v.to(dt))
    with pytest.raises(ValueError, match="GQA"):
        flash_attention(q[:, :3], k, v)
    with pytest.raises(ValueError, match="blocks"):
        flash_attention(torch.zeros((1, 4, 128, 32)), k, v, block_q=128)


_HARNESS = r"""
#include <vector>
#include "flash_attention.cuh"
// Host replay of the CUDA kernel's tiles: per (b*Hq, query block) the
// same kv_end, per row the same per-tile update; the sums that the
// kernel reduces across threads are plain loops here.
extern "C" void fa_host(const float* q, const float* k, const float* v,
                        float* o, int B, int Hq, int Hkv, int Sq, int Skv,
                        int D, int bq, int bk, int causal, float scale) {
  const int offset = Skv - Sq;
  std::vector<float> s(bk), acc(D);
  for (int bh = 0; bh < B * Hq; ++bh) {
    const int b = bh / Hq, h = bh % Hq;
    const long kvh = (long)b * Hkv + h / (Hq / Hkv);
    for (int q0 = 0; q0 < Sq; q0 += bq) {
      const int rows = bq < Sq - q0 ? bq : Sq - q0;
      const int kv_end = fa_kv_end(q0, rows, Skv, causal, offset);
      for (int r = 0; r < rows; ++r) {
        const int qpos = q0 + r;
        const float* qr = q + ((long)bh * Sq + qpos) * D;
        float m = fa_neg_inf(), l = 0.0f;
        for (int d = 0; d < D; ++d) acc[d] = 0.0f;
        for (int k0 = 0; k0 < kv_end; k0 += bk) {
          const int keys = bk < Skv - k0 ? bk : Skv - k0;
          float mc = fa_neg_inf();
          for (int j = 0; j < keys; ++j) {
            const float* kr = k + (kvh * Skv + k0 + j) * D;
            float dot = 0.0f;
            for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
            s[j] = fa_score(dot, scale,
                            fa_visible(qpos, k0 + j, Skv, causal, offset));
            mc = s[j] > mc ? s[j] : mc;
          }
          const FaRescale rs = fa_rescale(m, mc);
          float ps = 0.0f;
          for (int j = 0; j < keys; ++j) {
            s[j] = fa_prob(s[j], rs.m_safe);
            ps += s[j];
          }
          l = rs.alpha * l + ps;
          for (int d = 0; d < D; ++d) {
            float a = rs.alpha * acc[d];
            for (int j = 0; j < keys; ++j)
              a += s[j] * v[(kvh * Skv + k0 + j) * D + d];
            acc[d] = a;
          }
          m = rs.m_new;
        }
        float* orow = o + ((long)bh * Sq + qpos) * D;
        for (int d = 0; d < D; ++d) orow[d] = fa_finalize(acc[d], l);
      }
    }
  }
}
"""


@pytest.fixture(scope="module")
def host_update(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not on PATH: the per-row update is not checked")
    d = tmp_path_factory.mktemp("fa_host")
    (d / "harness.cpp").write_text(_HARNESS)
    lib = d / "libfa_host.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-w",
                    "-I", str(CSRC_DIR), "-o", str(lib), str(d / "harness.cpp")],
                   check=True)
    fn = ctypes.CDLL(str(lib)).fa_host
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P] + [I] * 9 + [ctypes.c_float]
    fn.restype = None
    return fn


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,bq,bk", [
    (1, 4, 1, 100, 200, 64, True, 64, 64),    # ragged tiles, GQA 4:1
    (2, 6, 2, 70, 70, 32, True, 32, 16),      # GQA 3:1, small blocks
    (1, 2, 2, 48, 130, 40, False, 32, 64),    # bidirectional, ragged keys
    (1, 4, 2, 80, 40, 16, True, 64, 32),      # rows 0..39 fully masked
    (1, 2, 1, 5, 1, 8, True, 8, 8),           # one key; rows 0..3 masked
])
def test_host_update_matches_plain(host_update, b, hq, hkv, sq, skv, d,
                                   causal, bq, bk):
    """The kernel's per-row online softmax (csrc/flash_attention.cuh),
    built by g++ and run tile by tile, against the plain version; fp32
    on both sides, 2e-5 as above."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(7 + sq, b, hq, hkv, sq, skv, d))
    out = torch.empty_like(q)
    host_update(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b, hq, hkv, sq, skv, d, bq, bk, int(causal), d ** -0.5)
    want = attention_ref(q, k, v, causal=causal)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)
    masked = max(sq - skv, 0) if causal else 0
    assert (out[:, :, :masked] == 0).all()


# ---------------------------------------------------------------------
# The tensor-core kernel (csrc/flash_attention_tc.cu): its host-checkable
# logic (csrc/flash_attention_tc.cuh) built by g++ into a harness that
# replays the kernel's CTAs, warpgroups and threads.

_TC_HARNESS = r"""
#include <vector>
#include "flash_attention_tc.cuh"

// The PTX ISA's register fragment of A for wgmma m64k16 with A in
// registers (the same as mma.m16n8k16's A per warp): thread t's 32-bit
// register a holds elements (row, k) and (row, k + 1) of the 64 x 16 A.
static int ptx_a_row(int t, int a) {
  return 16 * (t / 32) + (t % 32) / 4 + 8 * (a & 1);
}
static int ptx_a_k(int t, int a) { return 2 * (t % 4) + 8 * (a >> 1); }

extern "C" void fatc_acc_map(int n, int* rows, int* cols) {
  for (int t = 0; t < FATC_WG_THREADS; ++t)
    for (int i = 0; i < n / 2; ++i) {
      rows[t * (n / 2) + i] = fatc_acc_row(t, i);
      cols[t * (n / 2) + i] = fatc_acc_col(t, i);
    }
}

// Mismatches between the S accumulator element that fatc_p_reg packs
// into A-fragment slot (kk, a, half) and the element the PTX layout puts
// in that slot.
extern "C" int fatc_p_map_errors() {
  int bad = 0;
  for (int t = 0; t < FATC_WG_THREADS; ++t)
    for (int kk = 0; kk < FATC_BK / 16; ++kk)
      for (int a = 0; a < 4; ++a)
        for (int half = 0; half < 2; ++half) {
          const int i = fatc_p_reg(kk, a, half);
          bad += fatc_acc_row(t, i) != ptx_a_row(t, a) ||
                 fatc_acc_col(t, i) != 16 * kk + ptx_a_k(t, a) + half;
        }
  return bad;
}

// The kernel's mask over every element of every CTA's visited tiles
// against fa_visible; out = {mismatches, masked tiles, unmasked tiles,
// keys visible in tiles the kernel skips}.
extern "C" void fatc_mask_check(int Sq, int Skv, int causal, int* out) {
  const int offset = Skv - Sq;
  out[0] = out[1] = out[2] = out[3] = 0;
  for (int q0 = 0; q0 < Sq; q0 += FATC_BQ) {
    const int rows = FATC_BQ < Sq - q0 ? FATC_BQ : Sq - q0;
    const int n_tiles = fatc_n_tiles(q0, rows, Skv, causal, offset);
    for (int k0 = 0; k0 < Skv; k0 += FATC_BK) {
      const bool visited = k0 / FATC_BK < n_tiles;
      const bool masked = fatc_tile_needs_mask(k0, q0, Skv, causal, offset);
      if (visited) ++out[masked ? 1 : 2];
      for (int r = q0; r < q0 + rows; ++r)
        for (int c = 0; c < FATC_BK; ++c) {
          const bool want = fa_visible(r, k0 + c, Skv, causal, offset);
          if (!visited) {
            out[3] += want;
            continue;
          }
          // keys past Skv are zero rows of the TMA, which score 0, not
          // -inf: a tile that holds them must take the mask
          const bool got =
              !masked || c < fatc_row_limit(r, k0, Skv, causal, offset);
          out[0] += got != want;
        }
    }
  }
}

// Host replay of the kernel: per (b * Hq, 128-row tile) the same tile
// plan, per warpgroup and thread the same registers (accumulator map),
// masks, quad reductions (two xor steps, as the shuffles), rescaling,
// P's A fragments and 1/l.  Keys and rows past the ends read as zeros,
// as the TMA fills them.  round_p rounds P to bf16 as the kernel does.
static float bf16_round(float x) {
  unsigned u;
  memcpy(&u, &x, 4);
  u += 0x7FFF + ((u >> 16) & 1);
  u &= 0xFFFF0000u;
  memcpy(&x, &u, 4);
  return x;
}

extern "C" void fatc_host(const float* q, const float* k, const float* v,
                          float* o, int B, int Hq, int Hkv, int Sq, int Skv,
                          int D, int causal, float scale, int round_p) {
  const int offset = Skv - Sq, T = FATC_WG_THREADS;
  const int NS = FATC_BK / 2, NO = D / 2;
  const float sl2 = scale * FATC_LOG2E;
  std::vector<float> sc(T * NS), acc(T * NO), P(FATC_WG_ROWS * FATC_BK);
  std::vector<float> m(T * 2), l(T * 2), alpha(T * 2), x(T * 2);
  for (int bh = 0; bh < B * Hq; ++bh) {
    const long kvh = (long)(bh / Hq) * Hkv + (bh % Hq) / (Hq / Hkv);
    for (int q0 = 0; q0 < Sq; q0 += FATC_BQ) {
      const int rows = FATC_BQ < Sq - q0 ? FATC_BQ : Sq - q0;
      const int n_tiles = fatc_n_tiles(q0, rows, Skv, causal, offset);
      for (int wg = 0; wg < 2; ++wg) {
        const int row0 = q0 + wg * FATC_WG_ROWS;
        for (int e = 0; e < T * NO; ++e) acc[e] = 0.0f;
        for (int e = 0; e < T * 2; ++e) { m[e] = fa_neg_inf(); l[e] = 0.0f; }
        for (int j = 0; j < n_tiles; ++j) {
          const int k0 = j * FATC_BK;
          const bool masked =
              fatc_tile_needs_mask(k0, q0, Skv, causal, offset);
          for (int t = 0; t < T; ++t) {
            const int lim[2] = {
                fatc_row_limit(row0 + fatc_acc_row(t, 0), k0, Skv, causal,
                               offset),
                fatc_row_limit(row0 + fatc_acc_row(t, 2), k0, Skv, causal,
                               offset)};
            for (int i = 0; i < NS; ++i) {
              const int r = row0 + fatc_acc_row(t, i);
              const int c = fatc_acc_col(t, i), kp = k0 + c;
              float dot = 0.0f;
              if (r < Sq && kp < Skv)
                for (int d = 0; d < D; ++d)
                  dot += q[((long)bh * Sq + r) * D + d] *
                         k[(kvh * Skv + kp) * D + d];
              sc[t * NS + i] =
                  masked ? fatc_score(dot, c < lim[(i >> 1) & 1]) : dot;
            }
          }
          // row max: the thread's values, then its quad (xor 1, xor 2)
          for (int t = 0; t < T; ++t)
            for (int hf = 0; hf < 2; ++hf) {
              float mc = fa_neg_inf();
              for (int i = 0; i < NS; ++i)
                if (((i >> 1) & 1) == hf && sc[t * NS + i] > mc)
                  mc = sc[t * NS + i];
              x[t * 2 + hf] = mc;
            }
          for (int step = 1; step <= 2; step <<= 1) {
            std::vector<float> y(x);
            for (int e = 0; e < T * 2; ++e) {
              const float other = y[((e / 2) ^ step) * 2 + e % 2];
              x[e] = y[e] > other ? y[e] : other;
            }
          }
          std::vector<float> m_neg(T * 2);
          for (int e = 0; e < T * 2; ++e) {
            const FatcRescale rs = fatc_rescale(m[e], x[e], sl2);
            m[e] = rs.m_new;
            m_neg[e] = rs.m_neg;
            alpha[e] = rs.alpha;
            x[e] = 0.0f;
          }
          for (int t = 0; t < T; ++t)
            for (int i = 0; i < NS; ++i) {
              const int hf = (i >> 1) & 1;
              sc[t * NS + i] = fatc_prob(sc[t * NS + i], m_neg[t * 2 + hf], sl2);
              x[t * 2 + hf] += sc[t * NS + i];
            }
          for (int step = 1; step <= 2; step <<= 1) {
            std::vector<float> y(x);
            for (int e = 0; e < T * 2; ++e)
              x[e] = y[e] + y[((e / 2) ^ step) * 2 + e % 2];
          }
          for (int e = 0; e < T * 2; ++e) l[e] = alpha[e] * l[e] + x[e];
          // P (64 x 128) from the A fragments the kernel packs
          for (int t = 0; t < T; ++t)
            for (int kk = 0; kk < FATC_BK / 16; ++kk)
              for (int a = 0; a < 4; ++a)
                for (int half = 0; half < 2; ++half) {
                  const float pv = sc[t * NS + fatc_p_reg(kk, a, half)];
                  P[ptx_a_row(t, a) * FATC_BK + 16 * kk + ptx_a_k(t, a) +
                    half] = round_p ? bf16_round(pv) : pv;
                }
          for (int t = 0; t < T; ++t)
            for (int i = 0; i < NO; ++i) {
              const int r = fatc_acc_row(t, i), d = fatc_acc_col(t, i);
              float a = alpha[t * 2 + ((i >> 1) & 1)] * acc[t * NO + i];
              for (int c = 0; c < FATC_BK && k0 + c < Skv; ++c)
                a += P[r * FATC_BK + c] * v[(kvh * Skv + k0 + c) * D + d];
              acc[t * NO + i] = a;
            }
        }
        for (int t = 0; t < T; ++t)
          for (int i = 0; i < NO; ++i) {
            const int r = row0 + fatc_acc_row(t, i);
            if (r < Sq)
              o[((long)bh * Sq + r) * D + fatc_acc_col(t, i)] =
                  acc[t * NO + i] *
                  fa_finalize(1.0f, l[t * 2 + ((i >> 1) & 1)]);
          }
      }
    }
  }
}
"""


@pytest.fixture(scope="module")
def tc_host(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not on PATH: the tensor-core kernel's logic is "
                    "not checked")
    d = tmp_path_factory.mktemp("fatc_host")
    (d / "harness.cpp").write_text("#include <cstring>\n" + _TC_HARNESS)
    lib = d / "libfatc_host.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-w",
                    "-I", str(CSRC_DIR), "-o", str(lib), str(d / "harness.cpp")],
                   check=True)
    lib = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.fatc_acc_map.argtypes = [I, P, P]
    lib.fatc_p_map_errors.restype = I
    lib.fatc_mask_check.argtypes = [I, I, I, P]
    lib.fatc_host.argtypes = [P, P, P, P] + [I] * 7 + [ctypes.c_float, I]
    for fn in (lib.fatc_acc_map, lib.fatc_mask_check, lib.fatc_host):
        fn.restype = None
    return lib


@pytest.mark.parametrize("n", [64, 128])
def test_tc_accumulator_map_owns_each_element_once(tc_host, n):
    """wgmma m64nN's fp32 accumulator as the kernel reads it: every
    (row, col) of the 64 x N tile has exactly one (thread, register);
    a row's owners are the four lanes of one quad of one warp, and each
    thread holds two rows, g and g + 8 of its warp's 16."""
    rows = np.zeros((128, n // 2), np.int32)
    cols = np.zeros((128, n // 2), np.int32)
    tc_host.fatc_acc_map(n, rows.ctypes.data, cols.ctypes.data)
    owners = np.zeros((64, n), np.int32)
    np.add.at(owners, (rows, cols), 1)
    assert (owners == 1).all()
    for r in range(64):
        threads = np.unique(np.nonzero(rows == r)[0])
        assert len(threads) == 4 and threads[0] % 4 == 0
        assert (threads == threads[0] + np.arange(4)).all()
        assert (threads // 32 == r // 16).all()
    for t in range(128):
        assert set(rows[t]) == {16 * (t // 32) + (t % 32) // 4,
                                16 * (t // 32) + (t % 32) // 4 + 8}


def test_tc_p_fragments_need_no_shuffle(tc_host):
    """Each 32-bit A-fragment register of P V's k-steps holds, per the
    PTX layout, the two S-accumulator values the kernel packs into it:
    P goes from the S accumulator to the A operand in place."""
    assert tc_host.fatc_p_map_errors() == 0


@pytest.mark.parametrize("sq,skv,causal", [
    (128, 128, True), (1000, 1000, True), (300, 1000, True),
    (1000, 129, True), (129, 64, True), (1, 1, True), (127, 1000, False),
    (1000, 129, False), (64, 64, False), (8192 // 8, 8192 // 8, True),
])
def test_tc_diagonal_mask_matches_fa_visible(tc_host, sq, skv, causal):
    """The kernel masks only tiles across the diagonal or the end of the
    keys, with one compare per element against a row limit; over every
    element of every visited tile that equals ``fa_visible``, and the
    tiles it skips hold no visible key."""
    out = np.zeros(4, np.int32)
    tc_host.fatc_mask_check(sq, skv, int(causal), out.ctypes.data)
    mismatches, masked, unmasked, skipped_visible = out
    assert mismatches == 0 and skipped_visible == 0
    assert masked > 0
    if causal and sq >= 256 and skv >= 256:
        assert unmasked > 0     # interior tiles take no mask arithmetic


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal", [
    (1, 4, 1, 100, 200, 64, True),       # ragged, GQA 4:1
    (1, 2, 2, 300, 300, 128, True),      # 3 query tiles, 3 key tiles
    (1, 3, 1, 129, 1000, 64, False),     # bidirectional, ragged Skv
    (1, 4, 2, 200, 70, 128, True),       # rows 0..129 fully masked
    (1, 2, 1, 5, 1, 64, True),           # one key; rows 0..3 masked
    (2, 6, 2, 260, 390, 64, True),       # GQA 3:1, causal offset 130
])
def test_tc_host_replay_matches_plain(tc_host, b, hq, hkv, sq, skv, d, causal):
    """The tensor-core kernel's tiles, thread by thread, through its
    fragment maps, masks, exp2 online softmax with the folded scale and
    quad reductions (csrc/flash_attention_tc.cuh, built by g++), with P
    kept in fp32, against the plain version in fp32: 2e-5 as above."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(11 + sq, b, hq, hkv, sq, skv, d))
    out = torch.full_like(q, float("nan"))
    tc_host.fatc_host(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      b, hq, hkv, sq, skv, d, int(causal), d ** -0.5, 0)
    want = attention_ref(q, k, v, causal=causal)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)
    masked = max(sq - skv, 0) if causal else 0
    assert (out[:, :, :masked] == 0).all()


def test_tc_host_replay_with_bf16_p_within_bf16_tolerance(tc_host):
    """With P rounded to bf16 before P V, as the kernel does, the replay
    stays within the bf16 tolerance 2e-2 of the fp32 plain version."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, 1, 4, 2, 300, 300, 128))
    out = torch.empty_like(q)
    tc_host.fatc_host(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                      1, 4, 2, 300, 300, 128, 1, 128 ** -0.5, 1)
    want = attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(out, want, atol=2e-2, rtol=2e-2)
    assert (out - want).abs().max() > 0    # the rounding did happen
