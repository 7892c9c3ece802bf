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
``split_plan``) and tiles; the kernel itself is held against the plain version on a GPU
by ``tests/test_torch_gpu.py``.
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
    BLOCK_K, decode_attention, decode_attention_ref, merge_partials, split_plan)
from repro_torch.kernels.native import CSRC_DIR

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
