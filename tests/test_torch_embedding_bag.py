"""The port's EmbeddingBag module against the JAX reference.

The wrapper on CPU tensors (the plain version) is held against the JAX
``embedding_bag_kernel`` (Pallas, interpret mode on the CPU) and the
oracle ``embedding_bag_ref`` at the cases of ``tests/test_kernels.py``,
with that file's tolerances: 1e-5 in fp32 (sums of at most 10 terms in
another order) and 3e-2 in bf16 (the Pallas kernel rounds its running sum
to bf16 at every step, 2**-8 relative each).  The CUDA kernel's per-bag
core (``csrc/embedding_bag.cuh``) is compiled with g++ into a host
harness and held against the plain version, and so is the E = 1 lane route's core with
its butterfly, in the kernel's exact order; the kernels themselves are
held against the plain version on a GPU by ``tests/test_torch_gpu.py``.
An index at or past V gives a NaN row, as the JAX ``embedding_bag``
(whose ``jnp.take`` fills NaN) does: held against it on every route.
"""
import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.embedding_bag.ops import embedding_bag as jax_bag
from repro.kernels.embedding_bag.ops import embedding_bag_kernel as jax_kernel
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jax_ref
from repro_torch.kernels.embedding_bag import (bag_route, embedding_bag,
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


def _assert_same_nan_rows(got, want, tol):
    """NaN in the same places (whole rows), within ``tol`` elsewhere."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isnan(got).any(1), np.isnan(got).all(1))
    keep = ~np.isnan(want)
    np.testing.assert_allclose(got[keep], want[keep], atol=tol, rtol=tol)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_index_past_table_matches_reference(mode, weighted):
    """An index at or past V (V itself, 2**31 - 1, a whole bag of them)
    gives its bag's row NaN in every column, whatever the weights, as the
    JAX ``embedding_bag`` that the recsys models call; the other bags,
    with -1 padding, match it within 1e-5, so such an index also counts
    in the mean's divisor of no other bag."""
    rng = np.random.default_rng(7)
    table = rng.normal(size=(20, 4)).astype(np.float32)
    w = rng.normal(size=(4, 5)).astype(np.float32) if weighted else None
    idx = rng.integers(-1, 20, size=(4, 5)).astype(np.int32)
    idx[0, 1], idx[1, 0], idx[2] = 20, 2**31 - 1, 25
    got = embedding_bag(torch.from_numpy(table), torch.from_numpy(idx),
                        None if w is None else torch.from_numpy(w), mode=mode)
    want = jax_bag(jnp.asarray(table), jnp.asarray(idx),
                   None if w is None else jnp.asarray(w), mode=mode)
    _assert_same_nan_rows(got.numpy(), want, 1e-5)
    assert torch.isnan(got[:3]).all() and not torch.isnan(got[3]).any()


def test_index_past_table_counts_in_mean():
    """A bag of ids {0, V}: NaN (the reference's row for V), and with the
    id of V moved to -1, the mean divides by 1, not 2: the id past the
    table counts as valid, padding does not."""
    table = torch.arange(6, dtype=torch.float32).reshape(3, 2) + 1
    got = embedding_bag(table, torch.tensor([[0, 3], [0, -1]]), mode="mean")
    assert torch.isnan(got[0]).all()
    torch.testing.assert_close(got[1], table[0])
    want = jax_bag(jnp.asarray(table.numpy()), jnp.asarray([[0, 3], [0, -1]]),
                   mode="mean")
    _assert_same_nan_rows(got.numpy(), want, 0.0)


@pytest.mark.parametrize("sms", [132, 114, 1])
def test_bag_route_rule(sms):
    """E > 1 takes the warp route; E = 1 the lane route up to
    LANE_BAGS_PER_SM bags per SM, and the column route past it."""
    from repro_torch.kernels.embedding_bag.ops import LANE_BAGS_PER_SM
    edge = LANE_BAGS_PER_SM * sms
    assert bag_route(512, 8, sms) == "warp"
    assert bag_route(edge, 1, sms) == "lanes"
    assert bag_route(edge + 1, 1, sms) == "column"
    assert bag_route(1, 1, sms) == "lanes"
    assert bag_route(262_144, 1, sms) == "column"
    assert bag_route(512, 1, 132) == "lanes"      # serve_p99 on an H100
    assert bag_route(262_144, 1, 132) == "column"  # serve_bulk on an H100


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
// Every table value the replayed threads read (EB_HOST_READ), and how
// many of them lie outside the table's V rows.
static const float* g_table = nullptr;
static long g_V = 0, g_table_reads = 0, g_table_outside = 0;
static void eb_host_read(const float* p) {
  ++g_table_reads;
  g_table_outside += p < g_table || p >= g_table + g_V;
}
#define EB_HOST_READ(p) eb_host_read(p)
#include "embedding_bag.cuh"
// Host replay of the CUDA kernels: every (bag, column) through the same
// per-bag core (column and warp routes) ...
extern "C" void eb_host(const float* table, const int* idx, const float* w,
                        float* out, long V, int B, int L, int E, int mean) {
  for (int b = 0; b < B; ++b)
    for (int e = 0; e < E; ++e)
      out[(long)b * E + e] = eb_bag_column(table, V, E, idx + (long)b * L,
                                           w ? w + (long)b * L : nullptr,
                                           L, e, mean);
}
// ... and the E = 1 lane route: each lane's share, then the butterfly.
// same[b] is 1 if every lane of the group ends with the same bits.
extern "C" int eb_host_lanes(const float* table, const int* idx,
                             const float* w, float* out, int* same, long V,
                             int B, int L, int mean) {
  const int G = eb_group_lanes(L);
  EbPart parts[32];
  for (int b = 0; b < B; ++b) {
    for (int j = 0; j < G; ++j)
      parts[j] = eb_lane_part(table, V, idx + (long)b * L,
                              w ? w + (long)b * L : nullptr, L, j, G);
    eb_butterfly(parts, G);
    same[b] = 1;
    for (int j = 1; j < G; ++j)
      same[b] &= parts[j].sum == parts[0].sum ||
                 (parts[j].sum != parts[j].sum && parts[0].sum != parts[0].sum);
    out[b] = eb_finish(parts[0], mean);
  }
  return G;
}
// ... and the E = 1 column route: its launches in order, every bag of
// each through eb_column_pass, the running state in one scratch block of
// 3 B words as the wrapper gives it (filled with NaN bits first, so a
// pass that read a state no pass wrote would show).  counts: {launches,
// table values read, of them outside the table, outputs written before
// the last launch, outputs written twice}.
#include <vector>
extern "C" void eb_host_column(const float* table, const int* idx,
                               const float* w, float* out, long V, int B,
                               int L, int mean, long* counts) {
  g_table = table, g_V = V, g_table_reads = g_table_outside = 0;
  std::vector<int> run(3 * (size_t)B, 0x7fc00001);
  std::vector<int> written(B, 0);
  long early = 0, twice = 0;
  const int passes = eb_passes(L);
  for (int p = 0; p < passes; ++p) {
    const int i0 = p * EB_PASS_IDS;
    const int i1 = i0 + EB_PASS_IDS < L ? i0 + EB_PASS_IDS : L;
    for (int b = 0; b < B; ++b) {
      float x;
      if (eb_column_pass(table, V, idx, w, (float*)run.data(),
                         run.data() + B, B, L, i0, i1, b, mean, &x)) {
        out[b] = x;
        early += p != passes - 1;
        twice += written[b]++ > 0;
      }
    }
  }
  counts[0] = passes, counts[1] = g_table_reads, counts[2] = g_table_outside;
  counts[3] = early, counts[4] = twice;
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not on PATH: the per-bag core is not checked")
    d = tmp_path_factory.mktemp("eb_host")
    (d / "harness.cpp").write_text(_HARNESS)
    lib = d / "libeb_host.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-w",
                    "-I", str(CSRC_DIR), "-o", str(lib), str(d / "harness.cpp")],
                   check=True)
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def host_bag(host_lib):
    fn = host_lib.eb_host
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, ctypes.c_long, I, I, I, I]
    fn.restype = None
    return fn


@pytest.fixture(scope="module")
def host_lanes(host_lib):
    fn = host_lib.eb_host_lanes
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, ctypes.c_long, I, I, I]
    fn.restype = I
    return fn


def _bag_case(seed, v, e, b, l, weighted):
    """Random ids with -1 padding, an all-padding bag 0, and ids past the
    table in bag 1 (V itself), bag 2 (2**31 - 1) and bag 3 (V + 3)."""
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(size=(v, e)).astype(np.float32))
    idx = rng.integers(-1, v, size=(b, l)).astype(np.int32)
    idx[0] = -1
    idx[1, 0] = v
    idx[2, l - 1] = 2**31 - 1
    idx[3, l // 2] = v + 3
    w = (torch.from_numpy(rng.normal(size=(b, l)).astype(np.float32))
         if weighted else None)
    return table, torch.from_numpy(idx), w


def _assert_rows(out, want):
    """NaN exactly where the plain version has it, bags 1 to 3 NaN, bag
    0 (all padding) 0, the rest within 1e-5."""
    assert torch.equal(torch.isnan(out), torch.isnan(want))
    assert torch.isnan(out[1:4]).all() and (out[0] == 0).all()
    keep = ~torch.isnan(want)
    torch.testing.assert_close(out[keep], want[keep], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("v,e,b,l,mode,weighted", [
    (640, 1, 64, 40, "sum", False),     # the Wide&Deep path's E = 1
    (100, 1, 9, 7, "mean", True),
    (64, 37, 5, 6, "sum", True),        # E not a multiple of the warp
    (1000, 32, 16, 10, "mean", False),
    (50, 8, 4, 1, "mean", False),       # one slot per bag
])
def test_host_core_matches_plain(host_bag, v, e, b, l, mode, weighted):
    """The column and warp routes' per-bag core (csrc/embedding_bag.cuh),
    built by g++, against the plain version, with padding, an
    all-padding bag (mean divides by 1) and indices at or past V, whose
    bags are NaN on both sides; fp32 on both sides, 1e-5 as above."""
    table, idx, w = _bag_case(v + e + l, v, e, b, l, weighted)
    out = torch.empty((b, e))
    host_bag(table.data_ptr(), idx.data_ptr(),
             None if w is None else w.data_ptr(), out.data_ptr(), v, b, l, e,
             int(mode == "mean"))
    _assert_rows(out, embedding_bag_ref(table, idx, w, mode=mode))


@pytest.mark.parametrize("l,group", [(40, 32), (33, 32), (17, 32), (16, 16),
                                     (9, 16), (8, 8), (3, 8), (1, 8),
                                     (100, 32)])
@pytest.mark.parametrize("mode,weighted", [("sum", False), ("mean", True)])
def test_host_lane_route_matches_plain(host_lanes, l, group, mode, weighted):
    """The E = 1 lane route's core (csrc/embedding_bag.cuh): each lane's
    share of ids lane, lane + G, ..., then the butterfly in the card's
    steps, replayed by g++, against the plain version (fp32, 1e-5: 40
    terms in another order), on bags with padding and ids past V; the
    group size G follows L, and every lane of a group ends with the same
    bits, as the shuffles leave them."""
    b, v = 12, 5000
    table, idx, w = _bag_case(l + 3, v, 1, b, l, weighted)
    out = torch.empty((b, 1))
    same = torch.zeros(b, dtype=torch.int32)
    g = host_lanes(table.data_ptr(), idx.data_ptr(),
                   None if w is None else w.data_ptr(), out.data_ptr(),
                   same.data_ptr(), v, b, l, int(mode == "mean"))
    assert g == group and bool(same.all())
    _assert_rows(out, embedding_bag_ref(table, idx, w, mode=mode))


@pytest.fixture(scope="module")
def host_column(host_lib):
    fn = host_lib.eb_host_column
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, ctypes.c_long, I, I, I, P]
    fn.restype = None
    return fn


@pytest.mark.parametrize("l", [1, 16, 17, 33, 40, 41])
@pytest.mark.parametrize("mode,weighted", [("sum", False), ("mean", True)])
def test_host_column_passes_bit_equal(host_bag, host_column, l, mode,
                                      weighted):
    """The E = 1 column route's passes (eb_column_pass over ids of
    ``PASS_IDS`` at a time, the running state carried between launches,
    csrc/embedding_bag.cuh), replayed launch by launch by g++: equal bit
    for bit to eb_bag_column (the whole bag in one loop, as the warp
    route runs it), on 300 bags (not a multiple of the 256-thread CTA)
    with padding, an all-padding bag and ids past V (NaN rows), L in one
    pass, at a pass's end and past it; one launch per ``PASS_IDS`` ids,
    each output written once, by the last; every table value read is
    one of an id inside the table, read once."""
    from repro_torch.kernels.embedding_bag.ops import PASS_IDS
    b, v = 300, 5000
    table, idx, w = _bag_case(l * 7, v, 1, b, l, weighted)
    want = torch.empty((b, 1))
    host_bag(table.data_ptr(), idx.data_ptr(),
             None if w is None else w.data_ptr(), want.data_ptr(), v, b, l, 1,
             int(mode == "mean"))
    got = torch.full((b, 1), 7.0)
    counts = np.zeros(5, np.int64)
    host_column(table.data_ptr(), idx.data_ptr(),
                None if w is None else w.data_ptr(), got.data_ptr(), v, b, l,
                int(mode == "mean"), counts.ctypes.data)
    passes, reads, outside, early, twice = counts
    assert passes == -(-l // PASS_IDS) and early == 0 and twice == 0
    assert outside == 0 and reads == int(((idx >= 0) & (idx < v)).sum())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    _assert_rows(got, embedding_bag_ref(table, idx, w, mode=mode))
