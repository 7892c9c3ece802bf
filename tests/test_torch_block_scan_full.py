"""The port's whole-index block scans against the JAX reference.

``ops.block_scan``, ``ops.block_scan_batched`` and
``ops.block_scan_pruned`` take their plain versions on CPU tensors;
they are held bit for bit against the JAX package's ``block_scan``,
``block_scan_batched`` (Pallas ``block_scan_pallas`` in interpret mode)
and ``block_scan_pruned_pallas`` at the shapes and rules of
``tests/test_kernels.py``, degenerate rules included.  The tile
and static kernels' grids (``csrc/block_scan_warp.cuh``: ballots or
the static rule's slots, slot widths, warps' runs, word ownership,
strips) are compiled with g++ into host replays of both grids and held
bit for bit against the plain version.  The CUDA kernels themselves are held against the
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
from repro_torch.kernels.block_scan.block_scan import (MAX_PLANES, MAX_TERMS,
                                                       MAX_TILE, tile_blocks)
from repro_torch.kernels.block_scan.block_scan_pruned import (
    SLOTS, STATIC_MAX_TILE, STATIC_MIN_CTAS, STATIC_WARPS, slot_width,
    static_tile)
from repro_torch.kernels.native import CSRC_DIR, csrc_define

T, F = 4, 4
TILE_WARPS = csrc_define("block_scan_tile.cu", "BS_TILE_WARPS")


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
    """The tile kernel's 64 blocks per CTA (16 a warp) at the batched
    shape; fewer for one query, so that its grid still fills the card
    (512 CTAs of 4 warps at 4096 blocks).  The static kernel's tile
    (``static_tile``, through the same ``tile_blocks``): a round of a
    warp's 16 plane rows a warp, at least 512 CTAs: at 4096 blocks one
    block a warp at the deepest rule (1,024 CTAs), two at 2 to 8 planes
    (512 CTAs)."""
    assert tile_blocks(256, 4096) == 64
    assert tile_blocks(1, 4096) == 8
    assert tile_blocks(1, 5) == 1
    assert [static_tile(4096, n) for n in (16, 9, 8, 6, 2, 1, 0)] == \
        [4, 4, 8, 8, 8, 8, 8]
    assert static_tile(5, 16) == static_tile(5, 2) == 1
    assert [static_tile(10**6, n) for n in (16, 8, 4, 2, 1)] == \
        [4, 8, 16, 32, 64]
    assert [slot_width(n) for n in (0, 1, 2, 3, 5, 9, 16)] == \
        [1, 1, 2, 4, 8, 16, 16]


def test_tile_cap_is_the_headers():
    """The wrappers' tile caps, warps and plane limits are the values
    the kernels are built with, and no tile exceeds the cap that the
    launch entry points enforce."""
    assert MAX_TILE == csrc_define("block_scan_tile.cu", "BS_TILE_MAX_BLOCKS")
    assert STATIC_MAX_TILE == STATIC_WARPS * SLOTS == 64
    assert SLOTS == csrc_define("block_scan_warp.cuh", "BS_SLOTS") == MAX_PLANES
    assert MAX_PLANES == csrc_define("block_scan.cuh", "BS_MAX_PLANES")
    assert MAX_TERMS == csrc_define("block_scan.cuh", "BS_MAX_TERMS")
    assert TILE_WARPS == 4
    assert all(1 <= tile_blocks(q, nb) <= MAX_TILE
               for q in (1, 3, 256) for nb in (1, 5, 64, 4096))
    assert all(1 <= static_tile(nb, n) <= STATIC_MAX_TILE
               for nb in (1, 5, 64, 4096, 10**6) for n in range(17))
    assert STATIC_MIN_CTAS == 512
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
#include <stdint.h>
// Every occupancy word a replayed lane reads: counted, and counted again
// if it lies outside the occupancy array.
static const uint32_t* g_lo;
static const uint32_t* g_hi;
static int64_t g_reads, g_outside;
#define BS_HOST_READ(p) \
  do { ++g_reads; if ((p) < g_lo || (p) >= g_hi) ++g_outside; } while (0)
#include "block_scan_warp.cuh"

static void reads_begin(const uint32_t* occ, int64_t words) {
  g_lo = occ;
  g_hi = occ + words;
  g_reads = g_outside = 0;
}

static void reads_end(int64_t* reads) {
  reads[0] = g_reads;
  reads[1] = g_outside;
}

// A warp sum as the harness sees it: every replayed lane adds its share;
// lane 0 counts the call, so each block must be finished once.
struct HostFinish {
  int32_t* v;
  int32_t* n;
  int32_t* calls;
  int lane;
  void operator()(int blk, int v_pop, int m_pop) const {
    v[blk] += v_pop;
    n[blk] += m_pop;
    if (lane == 0) ++calls[blk];
  }
};

// Host replay of block_scan_tile.cu's grid: per CTA (query, tile of bb
// blocks), warp 0's two ballots and the plane list they give, then
// every warp's run of blocks, its 32 lanes one after another.
extern "C" void bs_host_tile(const uint32_t* occ, const uint8_t* allowed,
                             const uint8_t* required, const uint8_t* present,
                             uint32_t* match, int32_t* v_inc,
                             int32_t* n_match, int32_t* calls,
                             int64_t* reads, int n_queries, int nb,
                             int tf_planes, int F, int W, int n_terms, int bb,
                             int n_warps, int vec) {
  reads_begin(occ, (int64_t)n_queries * nb * tf_planes * W);
  for (int64_t i = 0; i < (int64_t)n_queries * nb; ++i)
    v_inc[i] = n_match[i] = calls[i] = 0;
  const int n_tiles = (nb + bb - 1) / bb;
  for (int g = 0; g < n_queries * n_tiles; ++g) {
    const int q = g / n_tiles, b0 = (g % n_tiles) * bb;
    const uint8_t* p = present + (int64_t)q * n_terms;
    uint32_t mask = 0u, req = 0u;
    for (int l = 0; l < BS_WARP; ++l) {
      mask |= (uint32_t)bs_plane_vote(allowed + (int64_t)q * tf_planes, p,
                                      tf_planes, F, l) << l;
      req |= (uint32_t)bs_req_vote(required + (int64_t)q * n_terms, p,
                                   n_terms, l) << l;
    }
    int32_t off[BS_SLOTS] = {0}, term[BS_SLOTS] = {0};
    for (int l = 0; l < BS_WARP; ++l) {
      if ((mask >> l) & 1u) {
        off[bs_rank(mask, l)] = l * W;
        term[bs_rank(mask, l)] = l / F;
      }
    }
    const int64_t qb = (int64_t)q * nb;
    const int n_blk = nb - b0 < bb ? nb - b0 : bb;
    for (int warp = 0; warp < n_warps; ++warp) {
      int first, count;
      bs_warp_span(n_blk, warp, n_warps, &first, &count);
      if (count == 0) continue;
      for (int l = 0; l < BS_WARP; ++l) {
        const HostFinish fin{v_inc + qb, n_match + qb, calls + qb, l};
        if (vec)
          bs_warp_scan<true>(occ + qb * tf_planes * W, match + qb * W,
                             b0 + first, count, tf_planes, W, l, off, term,
                             bs_popc(mask), req, n_terms, fin);
        else
          bs_warp_scan<false>(occ + qb * tf_planes * W, match + qb * W,
                              b0 + first, count, tf_planes, W, l, off, term,
                              bs_popc(mask), req, n_terms, fin);
      }
    }
  }
  reads_end(reads);
}

// Host replay of block_scan_static.cu's grid: the rule struct built
// from the host arrays, its slots read into each warp's "registers",
// then per CTA (tile of bb blocks) every warp's run of blocks, its 32
// lanes one after another, at the launch entry's slot width (the
// kernel instantiation for bs_slot_width(n_active)).
extern "C" void bs_host_static(const uint32_t* occ, uint32_t* match,
                               int32_t* v_inc, int32_t* n_match,
                               int32_t* calls, int64_t* reads,
                               const int32_t* plane_ids,
                               const int32_t* term_ids, int n_active,
                               const int32_t* req, int nb, int tf_planes,
                               int W, int n_terms, int bb, int n_warps,
                               int vec) {
  reads_begin(occ, (int64_t)nb * tf_planes * W);
  for (int i = 0; i < nb; ++i) v_inc[i] = n_match[i] = calls[i] = 0;
  const BsStaticRule rule =
      bs_static_rule(plane_ids, term_ids, n_active, req, n_terms);
  for (int b0 = 0; b0 < nb; b0 += bb) {
    const int n_blk = nb - b0 < bb ? nb - b0 : bb;
    for (int warp = 0; warp < n_warps; ++warp) {
      int first, count;
      bs_warp_span(n_blk, warp, n_warps, &first, &count);
      if (count == 0) continue;
      BsSlots off, term;
      bs_static_slots(rule, W, &off, &term);
      for (int l = 0; l < BS_WARP; ++l) {
        const HostFinish fin{v_inc, n_match, calls, l};
        if (vec)
          bs_warp_scan<true>(occ, match, b0 + first, count, tf_planes, W, l,
                             off, term, rule.n_active, rule.req_mask,
                             n_terms, fin);
        else
          bs_warp_scan<false>(occ, match, b0 + first, count, tf_planes, W, l,
                              off, term, rule.n_active, rule.req_mask,
                              n_terms, fin);
      }
    }
  }
  reads_end(reads);
}

extern "C" int bs_host_slot_width(int n_active) {
  return bs_slot_width(n_active);
}

extern "C" void bs_host_warp_span(int n_blk, int warp, int n_warps,
                                  int* first, int* count) {
  bs_warp_span(n_blk, warp, n_warps, first, count);
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
    so.bs_host_tile.argtypes = [P] * 9 + [I] * 9
    so.bs_host_static.argtypes = [P] * 8 + [I, P] + [I] * 7
    so.bs_host_warp_span.argtypes = [I, I, I, P, P]
    so.bs_host_slot_width.argtypes = [I]
    so.bs_host_slot_width.restype = I
    so.bs_host_tile.restype = so.bs_host_static.restype = None
    so.bs_host_warp_span.restype = None
    return so


def _outputs(*lead, w):
    return (torch.empty((*lead, w), dtype=torch.int32),
            torch.empty(lead, dtype=torch.int32),
            torch.empty(lead, dtype=torch.int32))


def _replay_tile(so, o, a, r, p, bb, vec):
    """The tile kernel's grid replayed by the harness: (match, v_inc,
    n_match), each block finished exactly once, no match word left
    unwritten (match starts as a fill pattern), and exactly the active
    planes' words of every block read, nothing outside the occupancy."""
    q, nb, t, f, w = o.shape
    got = _outputs(q, nb, w=w)
    got[0].fill_(0x5A5A5A5A)
    calls = torch.empty((q, nb), dtype=torch.int32)
    reads = torch.empty(2, dtype=torch.int64)
    so.bs_host_tile(o.data_ptr(), a.data_ptr(), r.data_ptr(), p.data_ptr(),
                    *(x.data_ptr() for x in got), calls.data_ptr(),
                    reads.data_ptr(), q, nb, t * f, f, w, t, bb, TILE_WARPS,
                    vec)
    assert (calls == 1).all()
    n_active = int((a & p[:, :, None]).sum())
    assert reads.tolist() == [n_active * nb * w, 0]
    return got


@pytest.mark.parametrize("q,nb,w,bb,vec", [
    (5, 9, 16, 4, 1), (4, 16, 128, 8, 1), (3, 3, 8, 8, 1), (4, 7, 32, 1, 1),
    (4, 16, 128, 8, 0), (3, 70, 128, 64, 1), (3, 9, 33, 4, 0),
    (3, 6, 1024, 2, 1), (3, 6, 1024, 8, 0)])
def test_host_tile_core_matches_plain(host_core, q, nb, w, bb, vec):
    """The tile kernel's grid (csrc/block_scan_warp.cuh), built by g++
    and replayed warp by warp and lane by lane: the plane lists from the
    ballots, the 16-byte or scalar word ownership (W = 33: scalar only;
    W = 1024: eight strips a block), the warps' runs, ragged last tiles
    and the degenerate queries, against the plain version."""
    occ, allowed, required, present = _batch(20 + w, q, nb, w)
    o, a, r, p = _t(occ), _t(allowed), _t(required), _t(present)
    got = _replay_tile(host_core, o, a, r, p, bb, vec)
    for g, want in zip(got, block_scan_reference(o, a, r, p)):
        assert torch.equal(g, want)


@pytest.mark.parametrize("n_active", [0, 1, 2, 3, 4, 5, 8, 9, 16])
def test_host_tile_slot_widths(host_core, n_active):
    """Every slot width (1, 2, 4, 8, 16 plane rows a block; 16 to 1
    blocks a round), through full and partial rounds: n_active planes
    spread over the four terms, 70 blocks in tiles of 64 (a warp's run
    of 16, a ragged tile of 6), both word paths."""
    q, nb, w = 2, 70, 16
    rng = np.random.default_rng(n_active)
    occ = _t(rng.integers(0, 2**32, (q, nb, T, F, w), dtype=np.uint32))
    allowed = np.zeros((q, T * F), bool)
    for i in range(q):
        allowed[i, rng.permutation(T * F)[:n_active]] = True
    allowed = _t(allowed.reshape(q, T, F))
    required, present = _t(np.ones((q, T), bool)), _t(np.ones((q, T), bool))
    want = block_scan_reference(occ, allowed, required, present)
    for vec in (1, 0):
        got = _replay_tile(host_core, occ, allowed, required, present, 64,
                           vec)
        for g, ref in zip(got, want):
            assert torch.equal(g, ref)


@pytest.mark.parametrize("n_active,width", [(0, 1), (1, 1), (2, 2), (3, 4),
                                            (4, 4), (5, 8), (9, 16),
                                            (16, 16)])
def test_host_slot_width(host_core, n_active, width):
    """Slots per block: the smallest power of two >= n_active, at least
    one, so that a round holds BS_SLOTS / width blocks."""
    assert host_core.bs_host_slot_width(n_active) == width


@pytest.mark.parametrize("n_blk,spans", [
    (64, [(0, 16), (16, 16), (32, 16), (48, 16)]),
    (6, [(0, 2), (2, 2), (4, 2), (6, 0)]),
    (1, [(0, 1), (1, 0), (2, 0), (3, 0)]),
    (9, [(0, 3), (3, 3), (6, 3), (9, 0)])])
def test_host_warp_span(host_core, n_blk, spans):
    """A tile's blocks split among the CTA's warps: contiguous runs that
    cover the tile once; warps past a ragged tile get none."""
    first, count = ctypes.c_int(), ctypes.c_int()
    got = []
    for warp in range(TILE_WARPS):
        host_core.bs_host_warp_span(n_blk, warp, TILE_WARPS,
                                    ctypes.byref(first), ctypes.byref(count))
        got.append((first.value, count.value))
    assert got == spans


@pytest.mark.parametrize("nb,w,vec", [(11, 16, 1), (11, 6, 0)],
                         ids=["vec_w16", "scalar_w6"])
@pytest.mark.parametrize("fields,required,present", [
    ((0, 1, 2, 3), (1, 1, 1, 1), (1, 1, 1, 1)),      # the deepest rule
    ((3,), (1, 1, 0, 0), (1, 1, 0, 0)),               # shallow: 2 planes
    ((1, 2), (1, 0, 1, 1), (1, 1, 1, 0)),
    ((), (1, 1, 1, 1), (1, 1, 1, 1)),                 # no active plane
    ((0, 1), (0, 0, 0, 0), (1, 1, 1, 1)),             # no required term
], ids=["deep", "shallow", "mixed", "no_active_plane", "no_required_term"])
def test_host_static_core_matches_plain(host_core, fields, required, present,
                                        nb, w, vec):
    """The static kernel's grid (csrc/block_scan_static.cu over
    csrc/block_scan_warp.cuh), built by g++ and replayed warp by warp
    and lane by lane at the wrapper's tile for the rule (``static_tile``,
    and a ragged tile of 4), on the 16-byte path (W = 16) and the scalar
    path (W = 6): the rule struct and its slots, the warps' runs, every
    block finished once, every match word written, exactly the active
    planes' words read once each (``BS_HOST_READ``), nothing outside the
    occupancy; against the plain version."""
    rng = np.random.default_rng(len(fields))
    occ = _t(rng.integers(0, 2**32, (nb, T, F, w), dtype=np.uint32))
    allowed = np.zeros((T, F), bool)
    allowed[:, list(fields)] = True
    required, present = np.asarray(required, bool), np.asarray(present, bool)
    planes, terms, req = static_plane_list(allowed, required, present)
    want = block_scan_reference(occ, _t(allowed), _t(required), _t(present))
    for bb in (static_tile(nb, len(planes)), 4):
        got = _outputs(nb, w=w)
        got[0].fill_(0x5A5A5A5A)
        calls = torch.empty(nb, dtype=torch.int32)
        reads = torch.empty(2, dtype=torch.int64)
        host_core.bs_host_static(occ.data_ptr(), *(x.data_ptr() for x in got),
                                 calls.data_ptr(), reads.data_ptr(),
                                 planes.ctypes.data, terms.ctypes.data,
                                 len(planes), req.ctypes.data, nb, T * F, w,
                                 T, bb, STATIC_WARPS, vec)
        assert (calls == 1).all()
        assert reads.tolist() == [len(planes) * nb * w, 0]
        for g, ref in zip(got, want):
            assert torch.equal(g, ref)
        for g, ref in zip(got, block_scan_pruned_ref(
                occ, planes.tolist(), terms.tolist(), req.tolist())):
            assert torch.equal(g, ref)
