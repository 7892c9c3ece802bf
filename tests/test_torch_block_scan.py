"""The port's block-scan kernel module against the JAX reference.

``build_rule_meta`` and the plain torch version of the chunked
plane-pruned scan are held bit for bit against the reference's
``build_rule_meta`` and ``block_scan_pruned_chunk`` (Pallas, interpret
mode on the CPU), degenerate lanes included.  The CUDA kernel's grid
(``csrc/block_scan_warp.cuh``: word ownership, ballots, slots, strips)
is compiled with g++ into a host harness that replays it warp by warp
and is held bit for bit against the plain version.  The CUDA
kernel itself is held against the plain version on a GPU by
``tests/test_torch_gpu.py``.
"""
import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro.kernels.block_scan.block_scan_pruned import (
    block_scan_pruned_chunk as jax_chunk, build_rule_meta as jax_meta)
from repro_torch.kernels.block_scan import (
    block_scan_pruned_chunk, block_scan_pruned_chunk_ref, build_rule_meta)
from repro_torch.kernels.native import CSRC_DIR

T, F = 4, 4


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def _case(seed, b, nb, w, chunk, t=T, f=F):
    """Random per-lane rules plus the degenerate lanes: zero active
    planes, zero required terms, term_present all false, and a block
    start that runs off the end of the index."""
    rng = np.random.default_rng(seed)
    occ = rng.integers(0, 2**32, (b, nb, t * f, w), dtype=np.uint32)
    allowed = rng.random((b, t, f)) < 0.5
    required = rng.random((b, t)) < 0.6
    present = rng.random((b, t)) < 0.8
    bp = rng.integers(0, nb, b).astype(np.int32)
    allowed[0] = False                         # zero active planes
    required[1] = False                        # zero required terms
    present[2] = False                         # no term present
    bp[3] = nb - 2                             # runs off the end
    allowed[3], required[3], present[3] = True, True, True
    return occ, allowed, required, present, bp


def _meta_both(allowed, required, present, bp):
    mj = np.asarray(jax_meta(jnp.asarray(allowed), jnp.asarray(required),
                             jnp.asarray(present), jnp.asarray(bp)))
    mt = build_rule_meta(_t(allowed), _t(required), _t(present), _t(bp))
    return mj, mt


def test_build_rule_meta_matches_reference():
    occ, allowed, required, present, bp = _case(0, 12, 8, 4, 4)
    mj, mt = _meta_both(allowed, required, present, bp)
    assert mt.dtype == torch.int32
    np.testing.assert_array_equal(mt.numpy(), mj)


@pytest.mark.parametrize("w", [16, 128])
def test_plain_chunk_matches_reference(w):
    chunk, nb = 4, 6
    occ, allowed, required, present, bp = _case(1 + w, 6, nb, w, chunk)
    mj, mt = _meta_both(allowed, required, present, bp)
    m_ref, v_ref, c_ref = jax_chunk(jnp.asarray(occ), jnp.asarray(mj),
                                    chunk=chunk, n_terms=T, interpret=True)
    m, v, c = block_scan_pruned_chunk(_t(occ), mt, chunk=chunk, n_terms=T)
    np.testing.assert_array_equal(m.numpy().view(np.uint32), np.asarray(m_ref))
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))
    # the degenerate lanes really are degenerate
    assert (v.numpy()[[0, 2]] == 0).all() and (c.numpy()[[0, 1, 2]] == 0).all()
    assert (v.numpy()[1] > 0).all()


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


def test_plain_chunk_reads_only_active_planes():
    """Bytes read ∝ u: exactly n_active W-word rows per lane-block."""
    chunk, nb, w = 3, 5, 8
    occ, allowed, required, present, bp = _case(5, 7, nb, w, chunk)
    meta = build_rule_meta(_t(allowed), _t(required), _t(present), _t(bp))
    occ_t = _t(occ)
    n_active = (allowed & present[:, :, None]).sum(axis=(1, 2))
    with _CountReads(occ_t) as counter:
        block_scan_pruned_chunk_ref(occ_t, meta, chunk=chunk, n_terms=T)
    assert counter.words == int(n_active.sum()) * chunk * w


def test_wrapper_rejects_bad_inputs():
    occ, allowed, required, present, bp = _case(2, 4, 4, 8, 2)
    meta = build_rule_meta(_t(allowed), _t(required), _t(present), _t(bp))
    with pytest.raises(ValueError, match="int32"):
        block_scan_pruned_chunk(_t(occ).to(torch.int64), meta, chunk=2,
                                n_terms=T)
    with pytest.raises(ValueError, match="columns"):
        block_scan_pruned_chunk(_t(occ), meta[:, :, :8].contiguous(),
                                chunk=2, n_terms=T)
    with pytest.raises(ValueError, match="n_terms"):
        block_scan_pruned_chunk(_t(occ), meta, chunk=2, n_terms=5)


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
// lane 0 counts the call, so each lane-block must be finished once.
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

// Step s of a meta row as the chunk kernel's shuffles and loads give
// it: `lanes` holds each replayed lane's loaded value.
struct HostStep {
  const int32_t* lanes;
  const int32_t* row;
  int tf_planes, scale;
  int operator[](int s) const {
    return bs_step_value(row, tf_planes, s, lanes[s % BS_WARP]) * scale;
  }
};

// Host replay of block_scan.cu's grid: one warp per (lane, chunk
// position), its 32 lanes one after another.  A ballot is the OR of the
// lanes' votes; a shuffle from lane s reads lane s's value.
extern "C" void bs_host_chunk(const uint32_t* occ, const int32_t* meta,
                              uint32_t* match, int32_t* v_inc,
                              int32_t* n_match, int32_t* calls,
                              int64_t* reads, int batch, int nb,
                              int tf_planes, int W, int ncols, int n_terms,
                              int chunk, int vec) {
  reads_begin(occ, (int64_t)batch * nb * tf_planes * W);
  for (int g = 0; g < batch * chunk; ++g) {
    const int b = g / chunk;
    const int32_t* meta_lane = meta + (int64_t)b * BS_META_ROWS * ncols;
    BsMetaLane r[BS_WARP];
    int32_t plane[BS_WARP], term[BS_WARP];
    uint32_t valid = 0u, req = 0u;
    for (int l = 0; l < BS_WARP; ++l) {
      r[l] = bs_meta_lane(meta_lane, ncols, tf_planes, n_terms, l);
      valid |= (uint32_t)r[l].valid << l;
      req |= (uint32_t)r[l].req << l;
      plane[l] = r[l].plane;
      term[l] = r[l].term;
    }
    const bool many = bs_many_planes(tf_planes);
    const int n_active = !many ? bs_leading_ones(valid)
                               : bs_count_active(valid, tf_planes, [&](int s0) {
      uint32_t more = 0u;
      for (int l = 0; l < BS_WARP; ++l)
        more |= (uint32_t)bs_step_valid(meta_lane, ncols, tf_planes,
                                        s0 + l) << l;
      return more;
    });
    const HostStep off{plane, meta_lane, tf_planes, W};
    const HostStep trm{term, meta_lane + ncols, tf_planes, 1};
    v_inc[g] = n_match[g] = calls[g] = 0;
    for (int l = 0; l < BS_WARP; ++l) {
      const int blk = bs_chunk_block(r[l].start, g % chunk, nb);
      const uint32_t* ob = occ + ((int64_t)b * nb + blk) * tf_planes * W;
      const HostFinish fin{v_inc + g, n_match + g, calls + g, l};
      uint32_t* mg = match + (int64_t)g * W;
      if (many && vec)
        bs_warp_block<true>(ob, mg, W, l, off, trm, n_active, req, n_terms,
                            fin);
      else if (many)
        bs_warp_block<false>(ob, mg, W, l, off, trm, n_active, req, n_terms,
                             fin);
      else if (vec)
        bs_warp_blocks<BS_SLOTS, true>(ob, mg, 0, 1, tf_planes, W, l, off, trm,
                                       n_active, req, n_terms, fin);
      else
        bs_warp_blocks<BS_SLOTS, false>(ob, mg, 0, 1, tf_planes, W, l, off,
                                        trm, n_active, req, n_terms, fin);
    }
  }
  reads_end(reads);
}

extern "C" int bs_host_vector_path(int W, uint64_t occ, uint64_t match) {
  return bs_vector_path(W, (uintptr_t)occ, (uintptr_t)match);
}

extern "C" int bs_host_leading_ones(uint32_t mask) {
  return bs_leading_ones(mask);
}
"""


@pytest.fixture(scope="module")
def host_core(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not on PATH: the per-word core is not checked")
    d = tmp_path_factory.mktemp("bs_host")
    (d / "harness.cpp").write_text(_HARNESS)
    lib = d / "libbs_host.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-w",
                    "-I", str(CSRC_DIR), "-o", str(lib), str(d / "harness.cpp")],
                   check=True)
    so = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    so.bs_host_chunk.argtypes = [P] * 7 + [I] * 8
    so.bs_host_chunk.restype = None
    so.bs_host_leading_ones.argtypes = [ctypes.c_uint32]
    so.bs_host_leading_ones.restype = I
    so.bs_host_vector_path.argtypes = [I, ctypes.c_uint64, ctypes.c_uint64]
    so.bs_host_vector_path.restype = I
    return so


@pytest.mark.parametrize("w,chunk,vec", [
    (16, 4, 1), (128, 3, 1), (128, 3, 0), (128, 1, 1), (33, 4, 0),
    (1024, 2, 1), (1024, 3, 0), (8, 32, 1)])
def test_host_core_matches_plain(host_core, w, chunk, vec):
    """The chunk kernel's grid (csrc/block_scan_warp.cuh), built by g++
    and replayed warp by warp, lane by lane, on its 16-byte or scalar
    word ownership (W = 33: scalar only; W = 1024: eight strips), with
    the ballot-based n_active, random words, the degenerate lanes and
    chunk positions clamped to the last block (a start near the end and
    one past it), against the plain version bit for bit.  The lanes read
    exactly the active planes' words of each chunk position's block, and
    nothing outside the occupancy."""
    nb = 5
    occ, allowed, required, present, bp = _case(11 + w, 9, nb, w, chunk)
    bp[4] = nb                         # an exhausted lane's block pointer
    _replay_chunk(host_core, occ, allowed, required, present, bp, chunk, vec)


def _many_planes(seed, t, f, w, chunk):
    """A _case at T*F > 16 planes with, besides the random and the
    degenerate lanes, lanes of every plane active, of exactly 16 and
    17 active, and of exactly 32 and 33 where T*F allows."""
    nb = 5
    occ, allowed, required, present, bp = _case(seed, 12, nb, w, chunk, t, f)
    flat = allowed.reshape(len(allowed), t * f)
    present[4:] = True
    for lane, n in zip(range(4, 9), (t * f, 16, 17, 32, 33)):
        flat[lane] = np.arange(t * f) < min(n, t * f)
    return occ, flat.reshape(allowed.shape), required, present, bp


def _replay_chunk(so, occ, allowed, required, present, bp, chunk, vec):
    """The chunk kernel's grid replayed by the harness, against the plain
    version bit for bit; every lane-block finished once, and exactly the
    active planes' words of each chunk position's block read, nothing
    outside the occupancy."""
    b, nb, tf_planes, w = occ.shape
    t = required.shape[1]
    occ_t = _t(occ)
    meta = build_rule_meta(_t(allowed), _t(required), _t(present), _t(bp))
    match = torch.full((b, chunk, w), 0x5A5A5A5A, dtype=torch.int32)
    v = torch.empty((b, chunk), dtype=torch.int32)
    c = torch.empty((b, chunk), dtype=torch.int32)
    calls = torch.empty((b, chunk), dtype=torch.int32)
    reads = torch.empty(2, dtype=torch.int64)
    so.bs_host_chunk(occ_t.data_ptr(), meta.data_ptr(), match.data_ptr(),
                     v.data_ptr(), c.data_ptr(), calls.data_ptr(),
                     reads.data_ptr(), b, nb, tf_planes, w, meta.shape[2], t,
                     chunk, vec)
    n_active = (allowed & present[:, :, None]).sum()
    assert reads.tolist() == [int(n_active) * chunk * w, 0]
    m_ref, v_ref, c_ref = block_scan_pruned_chunk_ref(occ_t, meta,
                                                      chunk=chunk, n_terms=t)
    assert torch.equal(match, m_ref)
    assert torch.equal(v, v_ref)
    assert torch.equal(c, c_ref)
    assert (calls == 1).all()


@pytest.mark.parametrize("t,f,w,vec", [(4, 8, 128, 1), (4, 8, 33, 0),
                                       (2, 24, 16, 1), (4, 16, 256, 0)])
def test_host_core_many_planes(host_core, t, f, w, vec):
    """The chunk kernel at T*F > 16 planes (the JAX kernel bounds only
    T): rules of more than 16 active planes load in groups of 16, and
    past 32 planes n_active and the plane list come from further meta
    reads, all replayed lane by lane against the plain version."""
    _replay_chunk(host_core, *_many_planes(t * f + w, t, f, w, 3), 3, vec)


@pytest.mark.parametrize("t,f", [(4, 8), (2, 24)])
def test_plain_chunk_many_planes_matches_reference(t, f):
    """The plain version at T*F > 16 planes against the JAX kernel."""
    chunk = 2
    occ, allowed, required, present, bp = _many_planes(t + f, t, f, 8, chunk)
    mj, mt = _meta_both(allowed, required, present, bp)
    m_ref, v_ref, c_ref = jax_chunk(jnp.asarray(occ), jnp.asarray(mj),
                                    chunk=chunk, n_terms=t, interpret=True)
    m, v, c = block_scan_pruned_chunk(_t(occ), mt, chunk=chunk, n_terms=t)
    np.testing.assert_array_equal(m.numpy().view(np.uint32), np.asarray(m_ref))
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))


@pytest.mark.parametrize("mask,want", [
    (0x0, 0), (0x1, 1), (0x7, 3), (0xFFFF, 16), (0xFFFFFFFF, 32),
    (0b1011, 2), (0xFFFE, 0)])
def test_host_leading_ones(host_core, mask, want):
    """n_active from the valid row's ballot: the steps before the first
    invalid one, as the old per-thread loop counted them."""
    assert host_core.bs_host_leading_ones(mask) == want


def test_vector_path_choice(host_core):
    """The 16-byte path by contract (bs_vector_path, which both launch
    entries call): W % 4 == 0 and 16-byte aligned occupancy and match; a
    view at an offset of a multiple of 4 words keeps it, any other
    offset or W % 4 != 0 takes the scalar path."""
    base = torch.zeros(4 * 1024 + 8, dtype=torch.int32)
    assert base.data_ptr() % 16 == 0

    def vec(w, occ, match):
        return bool(host_core.bs_host_vector_path(w, occ.data_ptr(),
                                                  match.data_ptr()))

    whole = base[:4096].view(4, 1024)
    assert vec(1024, whole, whole)
    assert vec(1024, base[4:4100].view(4, 1024), whole)
    assert not vec(1024, base[1:4097].view(4, 1024), whole)
    assert not vec(1024, whole, base[2:4098].view(4, 1024))
    assert not vec(33, base[:33 * 4].view(4, 33), whole)
    assert not vec(6, base[:24].view(4, 6), base[:24].view(4, 6))
