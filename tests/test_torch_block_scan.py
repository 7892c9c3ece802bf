"""The port's block-scan kernel module against the JAX reference.

``build_rule_meta`` and the plain torch version of the chunked
plane-pruned scan are held bit for bit against the reference's
``build_rule_meta`` and ``block_scan_pruned_chunk`` (Pallas, interpret
mode on the CPU), degenerate lanes included.  The CUDA kernel's
per-word core (``csrc/block_scan.cuh``) is compiled with g++ into a
host harness and held bit for bit against the plain version.  The CUDA
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


def _case(seed, b, nb, w, chunk):
    """Random per-lane rules plus the degenerate lanes: zero active
    planes, zero required terms, term_present all false, and a block
    start that runs off the end of the index."""
    rng = np.random.default_rng(seed)
    occ = rng.integers(0, 2**32, (b, nb, T * F, w), dtype=np.uint32)
    allowed = rng.random((b, T, F)) < 0.5
    required = rng.random((b, T)) < 0.6
    present = rng.random((b, T)) < 0.8
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
#include "block_scan.cuh"
// Host replay of the CUDA grid: one (lane, chunk position) per step,
// one word per inner iteration, popcounts summed per lane-block.
extern "C" void bs_host_chunk(const uint32_t* occ, const int32_t* meta,
                              uint32_t* match, int32_t* v_inc,
                              int32_t* n_match, int batch, int nb,
                              int tf_planes, int W, int ncols, int n_terms,
                              int chunk) {
  for (int g = 0; g < batch * chunk; ++g) {
    const int lane = g / chunk, c = g % chunk;
    const int32_t* ml = meta + (int64_t)lane * BS_META_ROWS * ncols;
    const int bp = ml[ncols - 1];
    const int blk = bp + c < nb - 1 ? bp + c : nb - 1;
    const uint32_t* ob = occ + ((int64_t)lane * nb + blk) * tf_planes * W;
    int tv = 0, tm = 0;
    for (int w = 0; w < W; ++w) {
      BsWord r = bs_eval_word(ob, ml, ncols, tf_planes, W, w, n_terms);
      match[(int64_t)g * W + w] = r.match;
      tv += r.v_pop;
      tm += r.match_pop;
    }
    v_inc[g] = tv;
    n_match[g] = tm;
  }
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
    fn = ctypes.CDLL(str(lib)).bs_host_chunk
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I]
    fn.restype = None
    return fn


@pytest.mark.parametrize("w,chunk", [(16, 4), (128, 3)])
def test_host_core_matches_plain(host_core, w, chunk):
    """The kernel's per-word arithmetic (csrc/block_scan.cuh), built by
    g++, against the plain version on random words and degenerate rules."""
    nb = 5
    occ, allowed, required, present, bp = _case(11 + w, 9, nb, w, chunk)
    occ_t = _t(occ)
    meta = build_rule_meta(_t(allowed), _t(required), _t(present), _t(bp))
    b = occ.shape[0]
    match = torch.empty((b, chunk, w), dtype=torch.int32)
    v = torch.empty((b, chunk), dtype=torch.int32)
    c = torch.empty((b, chunk), dtype=torch.int32)
    host_core(occ_t.data_ptr(), meta.data_ptr(), match.data_ptr(),
              v.data_ptr(), c.data_ptr(), b, nb, T * F, w, meta.shape[2], T,
              chunk)
    m_ref, v_ref, c_ref = block_scan_pruned_chunk_ref(occ_t, meta,
                                                      chunk=chunk, n_terms=T)
    assert torch.equal(match, m_ref)
    assert torch.equal(v, v_ref)
    assert torch.equal(c, c_ref)
