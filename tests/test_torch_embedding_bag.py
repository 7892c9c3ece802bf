"""The port's EmbeddingBag module against the JAX reference.

The wrapper on CPU tensors (the plain version) is held against the JAX
``embedding_bag_kernel`` (Pallas, interpret mode on the CPU) and the
oracle ``embedding_bag_ref`` at the cases of ``tests/test_kernels.py``,
with that file's tolerances: 1e-5 in fp32 (sums of at most 10 terms in
another order) and 3e-2 in bf16 (the Pallas kernel rounds its running sum
to bf16 at every step, 2**-8 relative each).  The CUDA kernel's per-bag
core (``csrc/embedding_bag.cuh``) is compiled with g++ into a host
harness and held against the plain version; the kernel itself is held
against the plain version on a GPU by ``tests/test_torch_gpu.py``.
"""
import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.embedding_bag.ops import embedding_bag_kernel as jax_kernel
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jax_ref
from repro_torch.kernels.embedding_bag import (embedding_bag,
                                               embedding_bag_kernel,
                                               embedding_bag_ref)
from repro_torch.kernels.native import CSRC_DIR


def _f32(x):
    return np.array(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("v,e,b,l,mode,dtype", [   # tests/test_kernels.py
    (64, 8, 4, 6, "sum", "float32"),
    (128, 16, 8, 3, "mean", "float32"),
    (1000, 32, 16, 10, "sum", "float32"),
    (64, 128, 4, 4, "mean", "bfloat16"),
])
def test_plain_matches_pallas_and_oracle(v, e, b, l, mode, dtype):
    rng = np.random.default_rng(4)
    jtable = jnp.asarray(rng.normal(size=(v, e)), getattr(jnp, dtype))
    idx = rng.integers(-1, v, size=(b, l)).astype(np.int32)    # with padding
    table = torch.from_numpy(_f32(jtable)).to(getattr(torch, dtype))
    got = embedding_bag(table, torch.from_numpy(idx), mode=mode)
    assert got.dtype == table.dtype and got.shape == (b, e)
    tol = 3e-2 if dtype == "bfloat16" else 1e-5
    for want in (jax_kernel(jtable, jnp.asarray(idx), mode=mode),
                 jax_ref(jtable, jnp.asarray(idx), mode=mode)):
        np.testing.assert_allclose(got.float().numpy(), _f32(want), atol=tol,
                                   rtol=tol)


def test_weighted_matches_pallas_and_oracle():
    rng = np.random.default_rng(5)
    table = rng.normal(size=(32, 8)).astype(np.float32)
    idx = rng.integers(0, 32, size=(4, 5)).astype(np.int32)
    w = rng.normal(size=(4, 5)).astype(np.float32)
    got = embedding_bag_kernel(*(torch.from_numpy(a) for a in (table, idx, w)),
                               mode="sum")
    for want in (jax_kernel(*(jnp.asarray(a) for a in (table, idx, w)),
                            mode="sum"),
                 jax_ref(*(jnp.asarray(a) for a in (table, idx, w)), mode="sum")):
        np.testing.assert_allclose(got.numpy(), _f32(want), atol=1e-5, rtol=1e-5)


def test_wide_deep_shape_matches_pallas():
    """The recsys path's shape cut in size: E = 1, one id per field at
    per-field offsets, no padding."""
    fields, vocab, b = 40, 16, 8
    rng = np.random.default_rng(6)
    table = rng.normal(size=(fields * vocab, 1)).astype(np.float32)
    idx = (rng.integers(0, vocab, (b, fields))
           + np.arange(fields) * vocab).astype(np.int32)
    got = embedding_bag(torch.from_numpy(table), torch.from_numpy(idx))
    want = jax_kernel(jnp.asarray(table), jnp.asarray(idx), mode="sum")
    np.testing.assert_allclose(got.numpy(), _f32(want), atol=1e-5, rtol=1e-5)


@settings(deadline=None, max_examples=10)
@given(st.integers(0, 2**31 - 1))
def test_permutation_property(seed):
    """Permuting items within a bag leaves the sum unchanged."""
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(size=(50, 16)).astype(np.float32))
    idx = rng.integers(0, 50, size=(3, 8)).astype(np.int32)
    perm = np.stack([r[rng.permutation(8)] for r in idx])
    o1 = embedding_bag(table, torch.from_numpy(idx))
    o2 = embedding_bag(table, torch.from_numpy(perm))
    torch.testing.assert_close(o1, o2, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_index_past_table_is_padding(mode):
    """An index at or past V counts as padding (not summed, not counted
    by the mean), as in the CUDA kernel: the same result as -1 there."""
    rng = np.random.default_rng(7)
    table = torch.from_numpy(rng.normal(size=(20, 4)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 20, size=(3, 5)).astype(np.int32))
    past = idx.clone()
    past[0, 1], past[1, 0], past[2] = 20, 2**31 - 1, 25
    padded = torch.where(past >= 20, -1, past)
    for weights in (None, w):
        got = embedding_bag(table, past, weights, mode=mode)
        torch.testing.assert_close(got, embedding_bag(table, padded, weights,
                                                      mode=mode))
    assert (got[2] == 0).all()


def test_wrapper_rejects_unsupported_inputs():
    table = torch.zeros((8, 4))
    idx = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="mode"):
        embedding_bag(table, idx, mode="max")
    with pytest.raises(ValueError, match="table dtype"):
        embedding_bag(table.double(), idx)
    with pytest.raises(ValueError, match="indices dtype"):
        embedding_bag(table, idx.float())
    with pytest.raises(ValueError, match="weights"):
        embedding_bag(table, idx, torch.ones((2, 4)))
    with pytest.raises(ValueError, match="want table"):
        embedding_bag(table[0], idx)


_HARNESS = r"""
#include "embedding_bag.cuh"
// Host replay of the CUDA kernel: every (bag, column) through the same
// per-bag core.
extern "C" void eb_host(const float* table, const int* idx, const float* w,
                        float* out, long V, int B, int L, int E, int mean) {
  for (int b = 0; b < B; ++b)
    for (int e = 0; e < E; ++e)
      out[(long)b * E + e] = eb_bag_column(table, V, E, idx + (long)b * L,
                                           w ? w + (long)b * L : nullptr,
                                           L, e, mean);
}
"""


@pytest.fixture(scope="module")
def host_bag(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not on PATH: the per-bag core is not checked")
    d = tmp_path_factory.mktemp("eb_host")
    (d / "harness.cpp").write_text(_HARNESS)
    lib = d / "libeb_host.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-w",
                    "-I", str(CSRC_DIR), "-o", str(lib), str(d / "harness.cpp")],
                   check=True)
    fn = ctypes.CDLL(str(lib)).eb_host
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, ctypes.c_long, I, I, I, I]
    fn.restype = None
    return fn


@pytest.mark.parametrize("v,e,b,l,mode,weighted", [
    (640, 1, 64, 40, "sum", False),     # the Wide&Deep path's E = 1
    (100, 1, 9, 7, "mean", True),
    (64, 37, 5, 6, "sum", True),        # E not a multiple of the warp
    (1000, 32, 16, 10, "mean", False),
    (50, 8, 4, 1, "mean", False),       # one slot per bag
])
def test_host_core_matches_plain(host_bag, v, e, b, l, mode, weighted):
    """The kernel's per-bag core (csrc/embedding_bag.cuh), built by g++,
    against the plain version, with padding, an all-padding bag (mean
    divides by 1) and indices at or past V, which both read as padding;
    fp32 on both sides, 1e-5 as above."""
    rng = np.random.default_rng(v + e + l)
    table = torch.from_numpy(rng.normal(size=(v, e)).astype(np.float32))
    idx = rng.integers(-1, v, size=(b, l)).astype(np.int32)
    idx[0] = -1
    idx[1, 0] = v + 3
    w = (torch.from_numpy(rng.normal(size=(b, l)).astype(np.float32))
         if weighted else None)
    out = torch.empty((b, e))
    host_bag(table.data_ptr(), torch.from_numpy(idx).data_ptr(),
             None if w is None else w.data_ptr(), out.data_ptr(), v, b, l, e,
             int(mode == "mean"))
    want = embedding_bag_ref(table, torch.from_numpy(idx), w, mode=mode)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
    assert (out[0] == 0).all()
