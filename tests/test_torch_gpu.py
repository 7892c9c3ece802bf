"""The port's CUDA kernels on a GPU (marker ``gpu``; each test skips
without CUDA).  This file imports neither JAX nor the JAX package, so it
also runs on a machine without JAX:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_gpu.py

The kernels are compared with their plain torch versions, bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.environment import EnvConfig, env_reset
from repro_torch.core.scan_backends import BlockScanBackend, get_scan_backend
from repro_torch.kernels.block_scan import (
    BLOCK_SCAN_KERNEL, block_scan_pruned_chunk, block_scan_pruned_chunk_ref,
    build_rule_meta)

T, F = 4, 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(seed, b, nb, w, dev):
    """Random per-lane rules plus the degenerate lanes: zero active
    planes, zero required terms, no term present, and a block start
    that runs off the end of the index."""
    rng = np.random.default_rng(seed)
    occ = rng.integers(0, 2**32, (b, nb, T * F, w), dtype=np.uint32)
    allowed = rng.random((b, T, F)) < 0.5
    required = rng.random((b, T)) < 0.6
    present = rng.random((b, T)) < 0.8
    bp = rng.integers(0, nb, b).astype(np.int32)
    allowed[0] = False
    required[1] = False
    present[2] = False
    bp[3] = nb - 2
    allowed[3], required[3], present[3] = True, True, True

    def tt(a):
        return torch.from_numpy(np.array(a)).to(dev)

    meta = build_rule_meta(tt(allowed), tt(required), tt(present), tt(bp))
    return tt(occ.view(np.int32)), meta


@pytest.mark.gpu
@pytest.mark.parametrize("w,chunk", [(128, 4), (128, 32), (16, 3), (8, 1)])
def test_cuda_kernel_matches_plain(cuda, w, chunk):
    occ, meta = _case(21 + chunk, 64, 64, w, cuda)
    before = BLOCK_SCAN_KERNEL.launches
    got = block_scan_pruned_chunk(occ, meta, chunk=chunk, n_terms=T)
    torch.cuda.synchronize()
    assert BLOCK_SCAN_KERNEL.launches == before + 1
    want = block_scan_pruned_chunk_ref(occ, meta, chunk=chunk, n_terms=T)
    for g, r in zip(got, want):
        assert torch.equal(g, r)


@pytest.mark.gpu
def test_cuda_wrapper_rejects_non_contiguous(cuda):
    occ, meta = _case(3, 8, 8, 16, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        block_scan_pruned_chunk(occ.transpose(0, 1).contiguous().transpose(0, 1),
                                meta, chunk=2, n_terms=T)


@pytest.mark.gpu
@pytest.mark.parametrize("du,dv", [(40, 10**6), (1000, 150), (10**4, 10**6)])
def test_cuda_block_scan_backend_matches_reference(cuda, du, dv):
    """One rule execution on the card: the kernel backend (C=3, so a
    chunk window runs past the end of the index) against the
    block-at-a-time reference backend, every EnvState field."""
    b, nb, d = 8, 16, 256
    w = d // 32
    cfg = EnvConfig(n_blocks=nb, block_docs=d, k_rules=6, max_candidates=96,
                    n_top=5, u_budget=4096)
    rng = np.random.default_rng(5)
    occ = torch.from_numpy(
        (rng.integers(0, 2**32, (b, nb, T, F, w), dtype=np.uint32)
         & rng.integers(0, 2**32, (b, nb, T, F, w), dtype=np.uint32))
        .view(np.int32)).to(cuda)
    scores = torch.from_numpy(rng.normal(size=(b, nb * d)).astype(np.float32)).to(cuda)
    tp = torch.from_numpy(rng.random((b, T)) < 0.9).to(cuda)
    allowed = torch.from_numpy(rng.random((b, T, F)) < 0.6).to(cuda)
    required = torch.from_numpy(rng.random((b, T)) < 0.7).to(cuda)
    du_q = torch.full((b,), du, dtype=torch.int32, device=cuda)
    dv_q = torch.full((b,), dv, dtype=torch.int32, device=cuda)
    before = BLOCK_SCAN_KERNEL.launches
    states = [backend.run_rule(
        cfg, occ, scores, tp, env_reset(cfg, b, cuda), allowed, required,
        du_q, dv_q)
        for backend in (get_scan_backend("reference"), BlockScanBackend(3))]
    assert BLOCK_SCAN_KERNEL.launches > before
    for f in ("block_ptr", "u", "v", "matched", "cand", "cand_cnt", "topn",
              "done"):
        assert torch.equal(getattr(states[0], f), getattr(states[1], f)), f
