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
