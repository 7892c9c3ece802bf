"""The port's whole-index block scans against the JAX reference.

``ops.block_scan``, ``ops.block_scan_batched`` and
``ops.block_scan_pruned`` take their plain versions on CPU tensors;
they are held bit for bit against the JAX package's ``block_scan``,
``block_scan_batched`` (Pallas ``block_scan_pallas`` in interpret mode)
and ``block_scan_pruned_pallas`` at the shapes and rules of
``tests/test_kernels.py``, degenerate rules included.  The kernels'
per-word core and plane lists (``csrc/block_scan.cuh``) are compiled
with g++ into a host replay of both grids and held bit for bit against
the plain version.  The CUDA kernels themselves are held against the
plain version on a GPU by ``tests/test_torch_gpu.py``.
"""
import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro.kernels.block_scan.block_scan_pruned import block_scan_pruned_pallas
from repro.kernels.block_scan.ops import block_scan as jax_block_scan
from repro.kernels.block_scan.ops import \
    block_scan_batched as jax_block_scan_batched
from repro_torch.kernels.block_scan import (
    BLOCK_SCAN_STATIC_KERNEL, BLOCK_SCAN_TILE_KERNEL, block_scan_pruned_ref,
    block_scan_reference, static_plane_list)
from repro_torch.kernels.block_scan import ops
from repro_torch.kernels.block_scan.block_scan import (MAX_BB, MAX_PLANES,
                                                       MAX_TERMS, tile_blocks)
from repro_torch.kernels.native import CSRC_DIR, csrc_define

T, F = 4, 4


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def _assert_equal(got, want):
    """Port (int32 words) against the reference (uint32 words), bit for
    bit, for (match, v_inc, n_match)."""
    m, v, c = got
    mr, vr, cr = (np.asarray(x) for x in want)
    np.testing.assert_array_equal(m.numpy().view(np.uint32), mr)
    np.testing.assert_array_equal(v.numpy(), vr)
    np.testing.assert_array_equal(c.numpy(), cr)


def _query(rng, nb, w, p_allowed=0.5, p_required=0.7):
    occ = rng.integers(0, 2**32, size=(nb, T, F, w), dtype=np.uint32)
    allowed = rng.random((T, F)) < p_allowed
    required = rng.random(T) < p_required
    return occ, allowed, required


# ---------------------------------------------------- runtime rule (tile)
@pytest.mark.parametrize("nb,w,bb", [(4, 16, 2), (16, 128, 8), (5, 32, 4),
                                     (1, 8, 8)])
def test_block_scan_matches_reference(nb, w, bb):
    """``tests/test_kernels.py``'s four shapes and rule draws; the JAX
    kernel at its own block_bb (the port picks its own tile)."""
    rng = np.random.default_rng(nb * 100 + w)
    occ, allowed, required = _query(rng, nb, w)
    present = np.array([1, 1, 1, 0], bool)
    want = jax_block_scan(jnp.asarray(occ), jnp.asarray(allowed),
                          jnp.asarray(required), jnp.asarray(present),
                          block_bb=bb)
    got = ops.block_scan(_t(occ), _t(allowed), _t(required), _t(present))
    _assert_equal(got, want)
    _assert_equal(ops.block_scan_reference(_t(occ), _t(allowed),
                                           _t(required), _t(present)), want)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_block_scan_random_rules(seed):
    """Seeded random rules and presence, as ``test_block_scan_property``
    draws them, against the JAX kernel."""
    rng = np.random.default_rng(seed)
    nb = int(rng.integers(1, 9))
    occ, allowed, required = _query(rng, nb, 8, 0.6, 0.6)
    present = rng.random(T) < 0.8
    want = jax_block_scan(jnp.asarray(occ), jnp.asarray(allowed),
                          jnp.asarray(required), jnp.asarray(present),
                          block_bb=4)
    _assert_equal(ops.block_scan(_t(occ), _t(allowed), _t(required),
                                 _t(present)), want)


def _batch(seed, q, nb, w):
    """Q queries with a random rule each, plus degenerate queries: zero
    active planes, zero required terms, no term present."""
    rng = np.random.default_rng(seed)
    occ = rng.integers(0, 2**32, size=(q, nb, T, F, w), dtype=np.uint32)
    allowed = rng.random((q, T, F)) < 0.5
    required = rng.random((q, T)) < 0.6
    present = rng.random((q, T)) < 0.8
    allowed[0] = False
    required[1] = False
    present[2] = False
    return occ, allowed, required, present


@pytest.mark.parametrize("q,nb,w", [(4, 5, 16), (6, 16, 128), (3, 1, 8)])
def test_block_scan_batched_matches_reference(q, nb, w):
    occ, allowed, required, present = _batch(q * nb + w, q, nb, w)
    want = jax_block_scan_batched(jnp.asarray(occ), jnp.asarray(allowed),
                                  jnp.asarray(required), jnp.asarray(present))
    got = ops.block_scan_batched(_t(occ), _t(allowed), _t(required),
                                 _t(present))
    _assert_equal(got, want)
    m, v, c = got
    assert (v[[0, 2]] == 0).all() and (c[:3] == 0).all() and (m[:3] == 0).all()
    assert (v[1] > 0).all()
    # one query through the single-query entry point: the same rows
    one = ops.block_scan(_t(occ[-1]), _t(allowed[-1]), _t(required[-1]),
                         _t(present[-1]))
    for a, b in zip(one, got):
        assert torch.equal(a, b[-1])


# ------------------------------------------------------- static rule
@pytest.mark.parametrize("n_terms,fields", [(2, (1, 3)), (3, (0, 1, 2, 3)),
                                            (4, (2,))])
def test_block_scan_pruned_matches_reference(n_terms, fields):
    """``test_block_scan_pruned_vs_ref``'s rules, against the JAX
    static-rule kernel."""
    rng = np.random.default_rng(n_terms * 10 + len(fields))
    occ = rng.integers(0, 2**32, (8, T, F, 16), dtype=np.uint32)
    allowed = np.zeros((T, F), bool)
    for f in fields:
        allowed[:, f] = True
    required = np.zeros(T, bool)
    required[:n_terms] = True
    present = np.zeros(T, bool)
    present[:n_terms] = True
    want = block_scan_pruned_pallas(jnp.asarray(occ), allowed, required,
                                    present, interpret=True)
    _assert_equal(ops.block_scan_pruned(_t(occ), allowed, required, present),
                  want)
    _assert_equal(ops.block_scan(_t(occ), _t(allowed), _t(required),
                                 _t(present)), want)


@pytest.mark.parametrize("allowed_rows,required,present", [
    ((), (True, False, False, False), (True, True, True, True)),
    ((0, 1, 2, 3), (True, True, True, True), (False,) * 4),
    ((0, 1), (False, False, False, False), (True, True, True, True)),
], ids=["no_active_plane", "no_present_term", "no_required_term"])
def test_block_scan_pruned_degenerate_rules(allowed_rows, required, present):
    """``test_block_scan_pruned_degenerate_rules_match_reference``'s
    rules: zero active planes, zero present terms, zero required terms
    (match empties, v_inc still counts)."""
    rng = np.random.default_rng(3)
    occ = rng.integers(0, 2**32, (6, T, F, 16), dtype=np.uint32)
    allowed = np.zeros((T, F), bool)
    for t in allowed_rows:
        allowed[t, :] = True
    required = np.asarray(required)
    present = np.asarray(present)
    want = block_scan_pruned_pallas(jnp.asarray(occ), allowed, required,
                                    present, interpret=True)
    got = ops.block_scan_pruned(_t(occ), allowed, required, present)
    _assert_equal(got, want)
    _assert_equal(ops.block_scan(_t(occ), _t(allowed), _t(required),
                                 _t(present)), want)
    m, v, c = got
    assert not m.any() and not c.any()
    assert bool(v.any()) == (allowed_rows == (0, 1))


class _CountReads(TorchFunctionMode):
    """Counts the elements of every tensor that an op returns from
    ``src`` (the occupancy tensor) as its first argument."""

    def __init__(self, src):
        super().__init__()
        self.src, self.words = src, 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if args and args[0] is self.src and isinstance(out, torch.Tensor):
            self.words += out.numel()
        return out


@pytest.mark.parametrize("fields", [(), (2,), (1, 3), (0, 1, 2, 3)])
def test_static_plain_reads_only_active_planes(fields):
    """Bytes read ∝ u: exactly n_active W-word rows per block."""
    nb, w = 5, 8
    rng = np.random.default_rng(len(fields))
    occ = _t(rng.integers(0, 2**32, (nb, T, F, w), dtype=np.uint32))
    allowed = np.zeros((T, F), bool)
    allowed[:, list(fields)] = True
    required = np.ones(T, bool)
    present = np.array([1, 1, 0, 1], bool)
    with _CountReads(occ) as counter:
        got = ops.block_scan_pruned(occ, allowed, required, present)
    n_active = int((allowed & present[:, None]).sum())
    assert counter.words == n_active * nb * w
    want = block_scan_reference(occ, _t(allowed), _t(required), _t(present))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_static_plane_list():
    """Active planes ascending, their terms, required ∧ present."""
    allowed = np.zeros((T, F), bool)
    allowed[0, [1, 3]] = allowed[2, 0] = allowed[3, :] = True
    required = np.array([1, 1, 0, 1], bool)
    present = np.array([1, 1, 1, 0], bool)
    planes, terms, req = static_plane_list(allowed, required, present)
    assert planes.tolist() == [1, 3, 8]
    assert terms.tolist() == [0, 0, 2]
    assert req.tolist() == [1, 1, 0, 0]
    assert planes.dtype == terms.dtype == req.dtype == np.int32


# ------------------------------------------------------------ wrappers
def test_tile_blocks():
    """The TPU kernel's 8 blocks per CTA at the batched shape; fewer
    for one query, so that its grid still fills the card."""
    assert tile_blocks(256, 4096) == 8
    assert tile_blocks(1, 4096) == 2
    assert tile_blocks(1, 5) == 1


def test_tile_cap_is_the_headers():
    """The wrappers' tile cap and plane limits are the values the
    kernels are built with (block_scan.cuh), and no tile exceeds the
    cap that sizes the kernels' shared arrays."""
    assert MAX_BB == csrc_define("block_scan.cuh", "BS_MAX_BB")
    assert MAX_PLANES == csrc_define("block_scan.cuh", "BS_MAX_PLANES")
    assert MAX_TERMS == csrc_define("block_scan.cuh", "BS_MAX_TERMS")
    assert all(1 <= tile_blocks(q, nb) <= MAX_BB
               for q in (1, 3, 256) for nb in (1, 5, 64, 4096))
    with pytest.raises(KeyError, match="BS_NO_SUCH"):
        csrc_define("block_scan.cuh", "BS_NO_SUCH")


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors no kernel is built or launched."""
    occ, allowed, required, present = _batch(11, 3, 3, 8)
    tile = BLOCK_SCAN_TILE_KERNEL.launches
    static = BLOCK_SCAN_STATIC_KERNEL.launches
    got = ops.block_scan_batched(_t(occ), _t(allowed), _t(required),
                                 _t(present))
    want = block_scan_reference(_t(occ), _t(allowed), _t(required), _t(present))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    ops.block_scan_pruned(_t(occ[0]), allowed[0], required[0], present[0])
    assert BLOCK_SCAN_TILE_KERNEL.launches == tile
    assert BLOCK_SCAN_STATIC_KERNEL.launches == static
    assert BLOCK_SCAN_TILE_KERNEL._fn is None
    assert BLOCK_SCAN_STATIC_KERNEL._fn is None


def test_wrappers_reject_bad_inputs():
    occ, allowed, required, present = _batch(12, 3, 3, 8)
    o, a, r, p = _t(occ), _t(allowed), _t(required), _t(present)
    with pytest.raises(ValueError, match="int32"):
        ops.block_scan_batched(o.to(torch.int64), a, r, p)
    with pytest.raises(ValueError, match="allowed"):
        ops.block_scan_batched(o, a[:, :2], r, p)
    with pytest.raises(ValueError, match="required"):
        ops.block_scan_batched(o, a, r.to(torch.int32), p)
    with pytest.raises(ValueError, match="Q, nb, T, F, W"):
        ops.block_scan_batched(o[0], a, r, p)
    with pytest.raises(ValueError, match="at most"):
        ops.block_scan_batched(torch.zeros((1, 2, 5, 4, 8), dtype=torch.int32),
                               torch.zeros((1, 5, 4), dtype=torch.bool),
                               torch.zeros((1, 5), dtype=torch.bool),
                               torch.zeros((1, 5), dtype=torch.bool))
    with pytest.raises(ValueError, match="different devices"):
        ops.block_scan_batched(o, a.to("meta"), r, p)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.block_scan_batched(o.to("meta"), a.to("meta"), r.to("meta"),
                               p.to("meta"))
    with pytest.raises(ValueError, match="nb, T, F, W"):
        ops.block_scan_pruned(o, allowed[0], required[0], present[0])
    with pytest.raises(ValueError, match="allowed"):
        ops.block_scan_pruned(o[0], allowed[0, :2], required[0], present[0])
    with pytest.raises(ValueError, match="term_present"):
        ops.block_scan_pruned(o[0], allowed[0], required[0], present[0, :3])
    with pytest.raises(ValueError, match="unsupported device"):
        ops.block_scan_pruned(o[0].to("meta"), allowed[0], required[0],
                              present[0])


# ------------------------------------------------- g++ replay of the grids
_HARNESS = r"""
#include "block_scan.cuh"
// Host replay of one CTA of either whole-index kernel: blocks
// [b0, b0 + n_blk) of one query, one word per inner iteration,
// popcounts summed per block.
static void replay_tile(const uint32_t* occ_q, uint32_t* match_q,
                        int32_t* v_q, int32_t* n_q, int b0, int n_blk,
                        int tf_planes, int W, const int32_t* plane,
                        const int32_t* term, int n_active,
                        const int32_t* req, int n_terms) {
  for (int i = 0; i < n_blk; ++i) {
    const int64_t blk = b0 + i;
    int tv = 0, tm = 0;
    for (int w = 0; w < W; ++w) {
      BsWord r = bs_eval_planes(occ_q + blk * tf_planes * W, W, w, plane,
                                term, n_active, req, n_terms);
      match_q[blk * W + w] = r.match;
      tv += r.v_pop;
      tm += r.match_pop;
    }
    v_q[blk] = tv;
    n_q[blk] = tm;
  }
}

// block_scan_tile.cu: a plane list per (query, tile) from the query's
// bool rule.
extern "C" void bs_host_tile(const uint32_t* occ, const uint8_t* allowed,
                             const uint8_t* required, const uint8_t* present,
                             uint32_t* match, int32_t* v_inc,
                             int32_t* n_match, int n_queries, int nb,
                             int tf_planes, int F, int W, int n_terms,
                             int bb) {
  const int n_tiles = (nb + bb - 1) / bb;
  for (int g = 0; g < n_queries * n_tiles; ++g) {
    const int q = g / n_tiles, b0 = (g % n_tiles) * bb;
    int32_t plane[BS_MAX_PLANES], term[BS_MAX_PLANES], req[BS_MAX_TERMS];
    const int n = bs_planes_from_rule(
        allowed + (int64_t)q * tf_planes, required + (int64_t)q * n_terms,
        present + (int64_t)q * n_terms, n_terms, F, plane, term, req);
    const int64_t qb = (int64_t)q * nb;
    replay_tile(occ + qb * tf_planes * W, match + qb * W, v_inc + qb,
                n_match + qb, b0, nb - b0 < bb ? nb - b0 : bb, tf_planes,
                W, plane, term, n, req, n_terms);
  }
}

// block_scan_static.cu: the rule struct built from the host arrays.
extern "C" void bs_host_static(const uint32_t* occ, uint32_t* match,
                               int32_t* v_inc, int32_t* n_match,
                               const int32_t* plane_ids,
                               const int32_t* term_ids, int n_active,
                               const int32_t* req, int nb, int tf_planes,
                               int W, int n_terms, int bb) {
  const BsStaticRule rule =
      bs_static_rule(plane_ids, term_ids, n_active, req, n_terms);
  for (int b0 = 0; b0 < nb; b0 += bb)
    replay_tile(occ, match, v_inc, n_match, b0, nb - b0 < bb ? nb - b0 : bb,
                tf_planes, W, rule.plane_ids, rule.term_ids, rule.n_active,
                rule.req, n_terms);
}
"""


@pytest.fixture(scope="module")
def host_core(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not on PATH: the per-word core is not checked")
    d = tmp_path_factory.mktemp("bs_full_host")
    (d / "harness.cpp").write_text(_HARNESS)
    lib = d / "libbs_full_host.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-w",
                    "-I", str(CSRC_DIR), "-o", str(lib), str(d / "harness.cpp")],
                   check=True)
    so = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    so.bs_host_tile.argtypes = [P] * 7 + [I] * 7
    so.bs_host_static.argtypes = [P, P, P, P, P, P, I, P] + [I] * 5
    so.bs_host_tile.restype = so.bs_host_static.restype = None
    return so


def _outputs(*lead, w):
    return (torch.empty((*lead, w), dtype=torch.int32),
            torch.empty(lead, dtype=torch.int32),
            torch.empty(lead, dtype=torch.int32))


@pytest.mark.parametrize("q,nb,w,bb", [(5, 9, 16, 4), (4, 16, 128, 8),
                                       (3, 3, 8, 8), (4, 7, 32, 1)])
def test_host_tile_core_matches_plain(host_core, q, nb, w, bb):
    """The tile kernel's plane lists from the bool rules and its
    per-word arithmetic, built by g++, with a ragged last tile and the
    degenerate queries, against the plain version."""
    occ, allowed, required, present = _batch(20 + w, q, nb, w)
    o, a, r, p = _t(occ), _t(allowed), _t(required), _t(present)
    got = _outputs(q, nb, w=w)
    host_core.bs_host_tile(o.data_ptr(), a.data_ptr(), r.data_ptr(),
                           p.data_ptr(), *(x.data_ptr() for x in got), q, nb,
                           T * F, F, w, T, bb)
    for g, want in zip(got, block_scan_reference(o, a, r, p)):
        assert torch.equal(g, want)


@pytest.mark.parametrize("fields,required,present", [
    ((0, 1, 2, 3), (1, 1, 1, 1), (1, 1, 1, 1)),      # the deepest rule
    ((3,), (1, 1, 0, 0), (1, 1, 0, 0)),               # shallow: 2 planes
    ((1, 2), (1, 0, 1, 1), (1, 1, 1, 0)),
    ((), (1, 1, 1, 1), (1, 1, 1, 1)),                 # no active plane
    ((0, 1), (0, 0, 0, 0), (1, 1, 1, 1)),             # no required term
], ids=["deep", "shallow", "mixed", "no_active_plane", "no_required_term"])
def test_host_static_core_matches_plain(host_core, fields, required, present):
    """The static kernel's rule struct and per-word arithmetic, built by
    g++, against the plain version."""
    nb, w, bb = 11, 16, 4
    rng = np.random.default_rng(len(fields))
    occ = _t(rng.integers(0, 2**32, (nb, T, F, w), dtype=np.uint32))
    allowed = np.zeros((T, F), bool)
    allowed[:, list(fields)] = True
    required, present = np.asarray(required, bool), np.asarray(present, bool)
    planes, terms, req = static_plane_list(allowed, required, present)
    got = _outputs(nb, w=w)
    host_core.bs_host_static(occ.data_ptr(), *(x.data_ptr() for x in got),
                             planes.ctypes.data, terms.ctypes.data,
                             len(planes), req.ctypes.data, nb, T * F, w, T, bb)
    want = block_scan_reference(occ, _t(allowed), _t(required), _t(present))
    for g, ref in zip(got, want):
        assert torch.equal(g, ref)
    for g, ref in zip(got, block_scan_pruned_ref(occ, planes.tolist(),
                                                 terms.tolist(), req.tolist())):
        assert torch.equal(g, ref)

