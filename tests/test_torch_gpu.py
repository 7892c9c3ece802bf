"""The port's CUDA kernels on a GPU (marker ``gpu``; each test skips
without CUDA).  This file imports neither JAX nor the JAX package, so it
also runs on a machine without JAX:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_gpu.py

The three block-scan kernels are compared with their plain torch
versions bit for bit; the flash- and decode-attention kernels within
2e-5 (fp32) and 2e-2 (bf16), the embedding-bag kernel within 1e-5 (fp32)
and 3e-2 (bf16): the JAX package's own tolerances (``tests/test_kernels.py``).  Decode
attention's out is also held row by row to a relative L2 error of 1e-2
(bf16) or 1e-4 (fp32): at the LM path's length a row averages thousands
of keys and |out| falls below the elementwise 2e-2.  Each call asserts
one launch of the kernel its route names (decode: ``tensor_core_route``;
bag: ``bag_route``) and none of the other.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core.environment import EnvConfig, env_reset
from repro_torch.core.scan_backends import BlockScanBackend, get_scan_backend
from repro_torch.kernels.block_scan import (
    BLOCK_SCAN_KERNEL, BLOCK_SCAN_RULE_KERNEL, BLOCK_SCAN_STATIC_KERNEL,
    BLOCK_SCAN_TILE_KERNEL,
    block_scan, block_scan_batched, block_scan_pruned,
    block_scan_pruned_chunk, block_scan_pruned_chunk_ref, block_scan_reference,
    build_rule_meta)
from repro_torch.kernels.decode_attention import (
    DECODE_ATTENTION_KERNEL, DECODE_ATTENTION_TC_KERNEL, decode_attention,
    decode_attention_ref, merge_partials)
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.embedding_bag import (
    EMBEDDING_BAG_KERNEL, EMBEDDING_BAG_LANES_KERNEL, bag_route, embedding_bag,
    embedding_bag_ref)
from repro_torch.kernels.embedding_bag.ops import LANE_BAGS_PER_SM, PASS_IDS
from repro_torch.kernels.flash_attention import (
    FLASH_ATTENTION_KERNEL, FLASH_ATTENTION_TC_KERNEL, attention_ref,
    flash_attention, tensor_core_route)
from repro_torch.models import recsys
from repro_torch.models.attention import gqa_forward
from repro_torch.models.moe import moe_ffn, moe_ffn_dense, moe_init, no_drop
from repro_torch.models.layers import rms_norm
from repro_torch.models.transformer import decode_step, init_params, prefill

T, F = 4, 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(seed, b, nb, w, dev, t=T, f=F):
    """Random per-lane rules plus the degenerate lanes: zero active
    planes, zero required terms, no term present, a block start that
    runs off the end of the index and one past its last block (an
    exhausted lane's pointer).  At T*F > 16 lanes 5-9 have every plane,
    16, 17, 32 and 33 planes active (as far as T*F allows)."""
    rng = np.random.default_rng(seed)
    occ = rng.integers(0, 2**32, (b, nb, t * f, w), dtype=np.uint32)
    allowed = rng.random((b, t, f)) < 0.5
    required = rng.random((b, t)) < 0.6
    present = rng.random((b, t)) < 0.8
    if t * f > 16:
        present[5:10] = True
        for lane, n in zip(range(5, 10), (t * f, 16, 17, 32, 33)):
            allowed[lane] = (np.arange(t * f) < min(n, t * f)).reshape(t, f)
    bp = rng.integers(0, nb, b).astype(np.int32)
    allowed[0] = False
    required[1] = False
    present[2] = False
    bp[3] = nb - 2
    bp[4] = nb
    allowed[3], required[3], present[3] = True, True, True

    def tt(a):
        return torch.from_numpy(np.array(a)).to(dev)

    meta = build_rule_meta(tt(allowed), tt(required), tt(present), tt(bp))
    return tt(occ.view(np.int32)), meta


def _at_offset(x, words):
    """x copied into a view that starts ``words`` int32 words into its
    storage: contiguous, but 16-byte aligned only if words % 4 == 0."""
    flat = torch.empty(x.numel() + words, dtype=x.dtype, device=x.device)
    view = flat[words:].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("w,chunk", [(128, 4), (128, 32), (16, 3), (8, 1),
                                     (128, 1), (33, 4), (1024, 3)])
def test_cuda_kernel_matches_plain(cuda, w, chunk, offset):
    """The chunk kernel on its 16-byte path and, for W % 4 != 0 or an
    occupancy view one word off alignment, its scalar path; C from 1 to
    32 with lanes whose chunk runs past the last block."""
    occ, meta = _case(21 + chunk, 64, 64, w, cuda)
    occ = _at_offset(occ, offset)
    before = BLOCK_SCAN_KERNEL.launches
    got = block_scan_pruned_chunk(occ, meta, chunk=chunk, n_terms=T)
    torch.cuda.synchronize()
    assert BLOCK_SCAN_KERNEL.launches == before + 1
    want = block_scan_pruned_chunk_ref(occ, meta, chunk=chunk, n_terms=T)
    for g, r in zip(got, want):
        assert torch.equal(g, r)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("t,f,w", [(4, 8, 128), (2, 24, 33), (4, 16, 256)])
def test_cuda_kernel_many_planes(cuda, t, f, w, offset):
    """The chunk kernel at T*F > 16 planes, which the contract allows:
    rules of more than 16 active planes load in groups of 16, and past
    32 planes n_active and the plane list come from further meta reads;
    one launch, bit-equal to the plain version."""
    occ, meta = _case(t * f + w, 64, 16, w, cuda, t, f)
    occ = _at_offset(occ, offset)
    before = BLOCK_SCAN_KERNEL.launches
    got = block_scan_pruned_chunk(occ, meta, chunk=3, n_terms=t)
    torch.cuda.synchronize()
    assert BLOCK_SCAN_KERNEL.launches == before + 1
    want = block_scan_pruned_chunk_ref(occ, meta, chunk=3, n_terms=t)
    for g, r in zip(got, want):
        assert torch.equal(g, r)


@pytest.mark.gpu
def test_cuda_wrapper_rejects_non_contiguous(cuda):
    occ, meta = _case(3, 8, 8, 16, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        block_scan_pruned_chunk(occ.transpose(0, 1).contiguous().transpose(0, 1),
                                meta, chunk=2, n_terms=T)


def _whole_index_case(seed, q, nb, w, dev):
    """Q queries with a random rule each; with Q >= 3 the first three
    are degenerate: zero active planes, zero required terms, no term
    present."""
    rng = np.random.default_rng(seed)
    occ = rng.integers(0, 2**32, (q, nb, T, F, w), dtype=np.uint32)
    allowed = rng.random((q, T, F)) < 0.5
    required = rng.random((q, T)) < 0.6
    present = rng.random((q, T)) < 0.8
    if q >= 3:
        allowed[0] = False
        required[1] = False
        present[2] = False
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (occ.view(np.int32), allowed, required, present))


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("q,nb,w", [(1, 4096, 128), (6, 37, 128), (5, 9, 16),
                                    (3, 3, 8), (4, 100, 32), (300, 16, 128),
                                    (3, 9, 33), (3, 7, 1024), (4, 70, 128)])
def test_cuda_block_scan_tile_matches_plain(cuda, q, nb, w, offset):
    """The runtime-rule whole-index kernel: one query over the
    websearch-rl config's 4096 blocks, ragged last tiles, narrow W,
    W % 4 != 0 and W = 1024 (eight strips), degenerate queries, an
    occupancy view one word off alignment (the scalar path); one launch
    per call.  ``block_scan(occ[-1])`` is a view at an offset too."""
    occ, allowed, required, present = _whole_index_case(q + nb + w, q, nb, w,
                                                        cuda)
    occ = _at_offset(occ, offset)
    before = BLOCK_SCAN_TILE_KERNEL.launches
    got = block_scan_batched(occ, allowed, required, present)
    torch.cuda.synchronize()
    assert BLOCK_SCAN_TILE_KERNEL.launches == before + 1
    want = block_scan_reference(occ, allowed, required, present)
    for g, r in zip(got, want):
        assert torch.equal(g, r)
    one = block_scan(occ[-1], allowed[-1], required[-1], present[-1])
    for g, r in zip(one, want):
        assert torch.equal(g, r[-1])


@pytest.mark.gpu
@pytest.mark.parametrize("fields,req,pres", [
    ((0, 1, 2, 3), (1, 1, 1, 1), (1, 1, 1, 1)),      # the deepest rule
    ((3,), (1, 1, 0, 0), (1, 1, 0, 0)),               # shallow: 2 planes
    ((1, 2), (1, 0, 1, 1), (1, 1, 1, 0)),
    ((), (1, 1, 1, 1), (1, 1, 1, 1)),                 # no active plane
    ((0, 1, 2, 3), (1, 1, 1, 1), (0, 0, 0, 0)),       # no present term
    ((0, 1), (0, 0, 0, 0), (1, 1, 1, 1)),             # no required term
])
@pytest.mark.parametrize("nb,w,offset", [(4096, 128, 0), (7, 16, 0), (7, 6, 0),
                                         (64, 128, 3), (9, 6, 1)])
def test_cuda_block_scan_static_matches_plain(cuda, fields, req, pres, nb, w,
                                              offset):
    """The static-rule whole-index kernel against the plain version,
    with the degenerate rules of ``tests/test_kernels.py``: on the
    16-byte path, on the scalar path (W = 6) and on an ``occ`` view
    that starts ``offset`` blocks into a larger index."""
    occ = _whole_index_case(nb + w + len(fields), 1, nb + offset, w,
                            cuda)[0][0][offset:]
    assert occ.is_contiguous() and occ.shape[0] == nb
    allowed = np.zeros((T, F), bool)
    allowed[:, list(fields)] = True
    required, present = np.asarray(req, bool), np.asarray(pres, bool)
    before = BLOCK_SCAN_STATIC_KERNEL.launches
    got = block_scan_pruned(occ, allowed, required, present)
    torch.cuda.synchronize()
    assert BLOCK_SCAN_STATIC_KERNEL.launches == before + 1
    want = block_scan_reference(occ, *(torch.from_numpy(a).to(cuda)
                                 for a in (allowed, required, present)))
    for g, r in zip(got, want):
        assert torch.equal(g, r)


@pytest.mark.gpu
def test_cuda_whole_index_wrappers_reject_non_contiguous(cuda):
    occ, allowed, required, present = _whole_index_case(4, 3, 8, 16, cuda)
    strided = occ.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        block_scan_batched(strided, allowed, required, present)
    with pytest.raises(ValueError, match="contiguous"):
        block_scan_pruned(strided[0].transpose(0, 1).contiguous().transpose(0, 1),
                          np.ones((T, F), bool), np.ones(T, bool),
                          np.ones(T, bool))


@pytest.mark.gpu
@pytest.mark.parametrize("du,dv", [(40, 10**6), (1000, 150), (10**4, 10**6)])
def test_cuda_block_scan_backend_matches_reference(cuda, du, dv):
    """One rule execution on the card: the kernel backend (one launch of
    the rule kernel) and its host loop on the card (the chunk kernel at
    C=3, so a chunk window runs past the end of the index) against the
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
    before = (BLOCK_SCAN_RULE_KERNEL.launches, BLOCK_SCAN_KERNEL.launches)
    args = (cfg, occ, scores, tp, env_reset(cfg, b, cuda), allowed, required,
            du_q, dv_q)
    states = [get_scan_backend("reference").run_rule(*args),
              BlockScanBackend(3).run_rule(*args),
              BlockScanBackend(3).host_loop(*args)]
    assert BLOCK_SCAN_RULE_KERNEL.launches == before[0] + 1
    assert BLOCK_SCAN_KERNEL.launches > before[1]
    for got in states[1:]:
        for f in ("block_ptr", "u", "v", "matched", "cand", "cand_cnt",
                  "topn", "done"):
            assert torch.equal(getattr(states[0], f), getattr(got, f)), f


@pytest.mark.gpu
@pytest.mark.parametrize("action", range(8))
def test_cuda_env_step_matches_cpu(cuda, action):
    """The single-step API on one query: ``env_step`` (rule 1, then the
    action twice) on CUDA tensors through the rule kernel equals it on
    CPU tensors through the host loop over the chunk kernel's plain
    version, every field; each rule alone through ``execute_rule`` too."""
    from repro_torch.core import default_rule_library, env_step, execute_rule

    nb, d = 16, 256
    cfg = EnvConfig(n_blocks=nb, block_docs=d, k_rules=6, max_candidates=96,
                    n_top=5, u_budget=4096)
    rng = np.random.default_rng(11)
    occ = torch.from_numpy(
        (rng.integers(0, 2**32, (nb, T, F, d // 32), dtype=np.uint32)
         & rng.integers(0, 2**32, (nb, T, F, d // 32), dtype=np.uint32))
        .view(np.int32))
    scores = torch.from_numpy(rng.normal(size=nb * d).astype(np.float32))
    tp = torch.tensor([True, True, True, False])
    out = {}
    for dev in ("cpu", cuda):
        rs = default_rule_library(device=dev)
        args = [x.to(dev) for x in (occ, scores, tp)]
        before = BLOCK_SCAN_RULE_KERNEL.launches
        s, states = env_reset(cfg, device=dev), []
        for a in (1, action, action):
            s = env_step(cfg, rs, *args, s, a)
            states.append(s)
        if action < cfg.k_rules:
            states.append(execute_rule(cfg, *args, env_reset(cfg, device=dev),
                                       *rs.gather(torch.tensor(action, device=dev))))
        out[str(dev)] = states
        if dev == cuda:
            assert BLOCK_SCAN_RULE_KERNEL.launches > before
    for i, (c, g) in enumerate(zip(out["cpu"], out[str(cuda)])):
        for f in ("block_ptr", "u", "v", "matched", "cand", "cand_cnt", "topn",
                  "done"):
            assert torch.equal(getattr(c, f), getattr(g, f).cpu()), (i, f)


@pytest.mark.gpu
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,dtype,bq,bk", [
    (1, 4, 4, 128, 128, 64, True, "float32", 64, 64),      # 1:1
    (2, 8, 2, 256, 256, 64, True, "float32", 64, 64),      # 4:1
    (1, 6, 2, 128, 128, 128, True, "bfloat16", 64, 64),    # 3:1, bf16
    (1, 2, 2, 128, 384, 64, False, "float32", 64, 64),     # bidirectional
    (1, 4, 1, 100, 200, 64, True, "float32", 64, 64),      # ragged
    (2, 32, 8, 300, 300, 128, True, "bfloat16", 64, 64),   # the LM's heads
    (2, 32, 8, 300, 300, 128, True, "float32", 32, 16),    # small blocks
    (1, 4, 2, 80, 40, 96, True, "float32", 64, 64),        # rows 0..39 masked
    (1, 4, 2, 80, 40, 128, True, "bfloat16", 64, 64),
    (1, 2, 1, 5, 1, 8, True, "float32", 8, 8),             # one key
    (1, 8, 2, 200, 200, 96, True, "bfloat16", 64, 64),     # bf16, CUDA cores
    (1, 4, 4, 130, 70, 32, False, "bfloat16", 64, 64),
    (1, 4, 2, 100, 150, 36, True, "bfloat16", 64, 64),    # bf16 by elements
])
def test_cuda_flash_attention_matches_plain(cuda, b, hq, hkv, sq, skv, d,
                                            causal, dtype, bq, bk):
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(sq + skv + d)
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(cuda, dt)
               for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    # the route's kernel, chosen by dtype and D alone, launches once
    assert tensor_core_route(dt, d) == (dtype == "bfloat16" and d in (64, 128))
    route, other = ((FLASH_ATTENTION_TC_KERNEL, FLASH_ATTENTION_KERNEL)
                    if tensor_core_route(dt, d) else
                    (FLASH_ATTENTION_KERNEL, FLASH_ATTENTION_TC_KERNEL))
    before, before_other = route.launches, other.launches
    got = flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
    torch.cuda.synchronize()
    assert route.launches == before + 1 and other.launches == before_other
    assert got.dtype == dt and got.shape == q.shape
    want = attention_ref(q, k, v, causal=causal)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    masked = max(sq - skv, 0) if causal else 0
    assert (got[:, :, :masked] == 0).all() and torch.isfinite(got.float()).all()


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal", [
    (2, 8, 2, 300, 200, 40, True),        # GQA 4:1, rows 0..99 see no key
    (1, 8, 2, 130, 390, 96, True),        # Sq < Skv, causal offset 260
    (2, 32, 8, 1024, 1024, 128, True),    # the fp32 LM route's launch
    (4, 32, 8, 300, 300, 40, True),       # 128-row tiles, D 40
    (1, 8, 2, 200, 333, 128, False),      # bidirectional, ragged keys
    (1, 4, 1, 70, 30, 128, True),         # rows 0..39 see no key
])
def test_cuda_flash_attention_fp32_route(cuda, b, hq, hkv, sq, skv, d,
                                         causal, offset):
    """fp32 on the CUDA-core kernel (128-row tiles on the two cases with
    at least one per SM, 64-row tiles on the rest): one launch of
    ``flash_attention`` and none of the tensor-core kernel, within 2e-5
    of the plain version, fully masked rows exactly 0; ``offset`` 1 puts
    q 4 bytes off 16-byte alignment, so that the launch takes the
    register path instead of the 16-byte cp.async copies."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(sq + skv + d + offset)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda)
               for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    q = _at_offset(q, offset)
    assert (q.data_ptr() % 16 == 0) == (offset == 0)
    before = FLASH_ATTENTION_KERNEL.launches
    before_other = FLASH_ATTENTION_TC_KERNEL.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FLASH_ATTENTION_KERNEL.launches == before + 1
    assert FLASH_ATTENTION_TC_KERNEL.launches == before_other
    want = attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    masked = max(sq - skv, 0) if causal else 0
    assert (got[:, :, :masked] == 0).all() and torch.isfinite(got).all()


_TC_LENGTHS = (1, 64, 127, 128, 129, 1000)
_TC_GROUPS = (1, 3, 4, 12)        # Hq / Hkv; 12 is starcoder2's 24 / 2


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("skv", _TC_LENGTHS)
@pytest.mark.parametrize("sq", _TC_LENGTHS)
def test_cuda_flash_attention_tensor_core_route(cuda, sq, skv, d, causal):
    """bf16 at D in {64, 128}: one launch of the tensor-core kernel and
    none of the CUDA-core one; within the bf16 tolerance 2e-2 of the
    plain version, which P's rounding to bf16 (2**-9 per term) keeps, and
    row by row within a relative L2 error of 1e-2, which out scaled by
    0.9 fails (over 1000 keys |out| is ~0.05, near the elementwise
    tolerance); rows that see no key (causal, Sq > Skv) exactly 0.  The
    GQA group cycles through 1, 3, 4 and 12 over the cases."""
    torch.backends.cuda.matmul.allow_tf32 = False
    group = _TC_GROUPS[(_TC_LENGTHS.index(sq) + _TC_LENGTHS.index(skv)
                        + d // 64 + int(causal)) % len(_TC_GROUPS)]
    b, hkv = 1 + (sq + skv) % 2, 2
    rng = np.random.default_rng(sq * 1009 + skv * 13 + d + int(causal))
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(cuda, torch.bfloat16)
               for s in ((b, group * hkv, sq, d), (b, hkv, skv, d),
                         (b, hkv, skv, d)))
    assert tensor_core_route(q.dtype, d)
    before = FLASH_ATTENTION_TC_KERNEL.launches
    before_other = FLASH_ATTENTION_KERNEL.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FLASH_ATTENTION_TC_KERNEL.launches == before + 1
    assert FLASH_ATTENTION_KERNEL.launches == before_other
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    want = attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    assert _row_rel_err(got, want) <= 1e-2
    assert _row_rel_err(got.float() * 0.9, want) > 1e-2   # a planted fault
    masked = max(sq - skv, 0) if causal else 0
    assert (got[:, :, :masked] == 0).all() and torch.isfinite(got.float()).all()


@pytest.mark.gpu
def test_cuda_flash_attention_rejects_unsupported(cuda):
    q = torch.zeros((1, 4, 16, 160), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q[:, :2], q[:, :2])
    q = torch.zeros((1, 4, 16, 64), device=cuda)
    for dt in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="dtypes"):
            flash_attention(q.to(dt), q[:, :2].to(dt), q[:, :2].to(dt))
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                        q[:, :2].contiguous(), q[:, :2].contiguous())
    # the tensor-core route's TMA maps need 16-byte aligned tensors
    kv = torch.zeros((1, 2, 16, 64), device=cuda, dtype=torch.bfloat16)
    off = torch.zeros(4 * 16 * 64 + 1, device=cuda,
                      dtype=torch.bfloat16)[1:].view(1, 4, 16, 64)
    before = FLASH_ATTENTION_TC_KERNEL.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(off, kv, kv)
    assert FLASH_ATTENTION_TC_KERNEL.launches == before


@pytest.mark.gpu
def test_cuda_mistral_nemo_two_layer_prefill_flash_and_plain(cuda):
    """Mistral-NeMo-12B at full width, 2 layers, random weights: prefill
    through the flash kernel (bf16, d_head 128: the tensor-core route,
    one launch per layer) and through the
    plain chunked attention.  Layer 0's K/V precede any attention and
    are bit-equal; its attention output agrees within the bf16
    tolerance 2e-2; the logits, after two layers of bf16 rounding that
    the two paths round differently (one bf16 ulp is 2**-8 relative, on
    logits of order 1), within 0.1 + 0.05|logit|."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch("mistral-nemo-12b").model_cfg(False),
                              n_layers=2, use_flash=True)
    plain = dataclasses.replace(cfg, use_flash=False)
    params = init_params(cfg, seed=0, device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 1000))).to(cuda)
    before = FLASH_ATTENTION_TC_KERNEL.launches
    logits, cache = prefill(params, tokens, cfg)
    torch.cuda.synchronize()
    assert FLASH_ATTENTION_TC_KERNEL.launches == before + cfg.n_layers
    plain_logits, plain_cache = prefill(params, tokens, plain)
    assert logits.shape == (2, cfg.vocab) and torch.isfinite(logits).all()
    for f in ("k", "v"):
        assert cache[f].shape == (2, 2, 1000, 8, 128)
        assert torch.equal(cache[f][0], plain_cache[f][0])
    lp = params["layers"]
    h = rms_norm(params["embed"][tokens], lp["ln1"][0])
    attn0 = {k: w[0] for k, w in lp["attn"].items()}
    torch.testing.assert_close(gqa_forward(attn0, h, cfg.attn_cfg()).float(),
                               gqa_forward(attn0, h, plain.attn_cfg()).float(),
                               atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(logits, plain_logits, atol=0.1, rtol=0.05)


def _assert_rows_close(got, want, tol):
    """Equal infinities (rows with no valid key), within tol elsewhere."""
    got, want = got.float(), want.float()
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], atol=tol, rtol=tol)


def _row_rel_err(got, want):
    """Largest relative L2 error over the rows (last axis) of ``want``
    that are not all zero."""
    got, want = got.float().flatten(0, -2), want.float().flatten(0, -2)
    norm = want.norm(dim=-1)
    keep = norm > 0
    return float(((got - want)[keep].norm(dim=-1) / norm[keep]).max())


def _decode_case(cuda, b, hq, hkv, s, d, dtype, lens, cache_view, seed):
    rng = np.random.default_rng(seed)
    dt = getattr(torch, dtype)
    q = torch.from_numpy(rng.normal(size=(b, hq, d)).astype(np.float32)).to(cuda, dt)
    kv_shape = (b, s, hkv, d) if cache_view else (b, hkv, s, d)
    k, v = (torch.from_numpy(rng.normal(size=kv_shape).astype(np.float32))
            .to(cuda, dt) for _ in range(2))
    if cache_view:      # the (B, S, Hkv, D) cache seen as (B, Hkv, S, D)
        k, v = k.transpose(1, 2), v.transpose(1, 2)
    kv_len = torch.tensor(lens, device=cuda) if isinstance(lens, list) else lens
    return q, k, v, kv_len


def _assert_decode(q, k, v, kv_len, lens, partial=False):
    """One launch of the route's kernel and none of the other; out, m, l
    against the plain version, out row by row (a planted x0.9 fails),
    rows with no key 0, -inf, 0.  With ``partial`` the unnormalised
    accumulator is held divided by the plain l, element by element: its
    own scale is l (hundreds of keys' weight at the LM's lengths), so
    the bf16 rounding of P and of the output moves it by up to ~4e-2 in
    absolute terms, ~1e-4 of the normalised value."""
    tc = decode_ops.tensor_core_route(q.dtype, q.shape[-1],
                                      q.shape[1] // k.shape[1])
    kernel, other = ((DECODE_ATTENTION_TC_KERNEL, DECODE_ATTENTION_KERNEL) if tc
                     else (DECODE_ATTENTION_KERNEL, DECODE_ATTENTION_TC_KERNEL))
    before, before_other = kernel.launches, other.launches
    got = decode_attention(q, k, v, kv_len=kv_len, return_partial=partial)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1 and other.launches == before_other
    want = decode_attention_ref(q, k, v, kv_len=kv_len, return_partial=partial)
    bf16 = q.dtype == torch.bfloat16
    tol = 2e-2 if bf16 else 2e-5
    assert got[0].dtype == q.dtype and got[0].shape == q.shape
    scale = want[2].clamp_min(1e-30) if partial else 1.0
    _assert_rows_close(got[0].float() / scale, want[0].float() / scale, tol)
    for g, w in zip(got[1:], want[1:]):
        _assert_rows_close(g, w, tol)
    row_tol = 1e-2 if bf16 else 1e-4
    assert _row_rel_err(got[0], want[0]) <= row_tol
    assert _row_rel_err(got[0] * 0.9, want[0]) > row_tol   # a planted fault
    if isinstance(lens, list):
        empty = torch.tensor(lens, device=q.device) == 0
        assert (got[0][empty] == 0).all() and (got[2][empty] == 0).all()
        assert torch.isinf(got[1][empty]).all()


@pytest.mark.gpu
@pytest.mark.parametrize("b,hq,hkv,s,d,dtype,lens,cache_view,partial,calls", [
    (2, 8, 8, 512, 64, "float32", None, False, False, 1),   # test_kernels.py
    (2, 8, 2, 1024, 64, "float32", None, False, False, 1),
    (1, 48, 8, 640, 128, "bfloat16", None, False, False, 1),
    (1, 16, 16, 300, 64, "float32", None, False, False, 1),
    (2, 32, 8, 8208, 128, "bfloat16", [8193, 8193], True, False, 1),  # LM path
    (4, 32, 8, 1000, 128, "bfloat16", [0, 1, 517, 1000], True, False, 1),
    (3, 8, 2, 700, 128, "float32", [700, 0, 65], True, False, 1),
    (2, 4, 1, 100, 32, "float32", 37, False, False, 1),    # an int kv_len
    (2, 8, 2, 300, 96, "bfloat16", [300, 77], True, False, 1),  # off tc route
    (2, 16, 4, 200, 32, "bfloat16", 150, False, False, 1),  # bf16 at D 32
    # many slices (63 of 64 keys), those of the short row wholly past it
    (2, 8, 2, 4000, 128, "float32", [4000, 1000], True, False, 1),
    (2, 8, 2, 4000, 96, "bfloat16", [1000, 4000], True, False, 1),
    # a second call on the same stream: the counters were left at 0
    (2, 32, 8, 1026, 128, "float32", [1025, 1025], True, False, 2),
    (2, 8, 2, 2000, 96, "bfloat16", [2000, 613], True, False, 2),
    # the unnormalised accumulator for an LSE merge
    (3, 32, 8, 1026, 128, "float32", [1025, 0, 300], True, True, 1),
    (2, 8, 2, 300, 96, "bfloat16", [300, 77], True, True, 1),
])
def test_cuda_decode_attention_matches_plain(cuda, b, hq, hkv, s, d, dtype,
                                             lens, cache_view, partial,
                                             calls):
    """The route's kernel against the plain version (see
    ``_assert_decode``); fp32 and bf16 off the tensor-core route take
    ``csrc/decode_attention.cu``, one launch whose last CTA per
    (sequence, KV head) merges the slices, so a second call right after
    the first on the same stream also shows the counters reset."""
    q, k, v, kv_len = _decode_case(cuda, b, hq, hkv, s, d, dtype, lens,
                                   cache_view, s + d + hq)
    for _ in range(calls):
        _assert_decode(q, k, v, kv_len, lens, partial)


@pytest.mark.gpu
@pytest.mark.parametrize("partial", [False, True])
@pytest.mark.parametrize("b,hq,hkv,s,d,lens,cache_view", [
    (2, 32, 8, 8208, 128, [8193, 8193], True),        # the LM path
    (4, 32, 8, 1000, 128, [0, 1, 517, 1000], True),   # ragged
    (2, 32, 8, 130, 128, [64, 65], True),             # a tile's edge
    (1, 48, 8, 640, 128, None, False),                # group 6
    (2, 8, 2, 700, 64, [700, 63], False),             # D 64
    (2, 32, 2, 300, 128, [300, 17], True),            # group 16: two n8 tiles
    (1, 24, 2, 129, 64, None, False),                 # group 12 at D 64
    (3, 4, 4, 64, 128, [1, 0, 64], False),            # MHA, one tile
    (1, 8, 1, 40000, 128, 39999, True),               # many tiles a slice
])
def test_cuda_decode_attention_tensor_core_route(cuda, b, hq, hkv, s, d, lens,
                                                 cache_view, partial):
    """bf16 at D 64/128 with a group of at most 16 runs the tensor-core
    kernel (one launch, the slices merged inside it), against the plain
    version at 2e-2 and row by row at 1e-2, with the unnormalised
    accumulator for ``return_partial``; and again on the same counters,
    which the last CTA of each (b, kv head) must leave at 0."""
    q, k, v, kv_len = _decode_case(cuda, b, hq, hkv, s, d, "bfloat16", lens,
                                   cache_view, s + d + hq + partial)
    if lens is None:
        lens = [s] * b
    for _ in range(2):
        _assert_decode(q, k, v, kv_len, lens if isinstance(lens, list) else
                       [lens] * b, partial)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_cuda_decode_partials_merge_to_full(cuda, dtype, tol):
    """tests/test_kernels.py's sequence-sharded decode on the card: the
    kernel's partials of four shards, LSE-merged, against the plain full
    attention (fp32 through the CUDA-core kernel: 1e-4, that test's
    bound; bf16 through the tensor-core kernel: 2e-2, as its partials
    are rounded to bf16)."""
    rng = np.random.default_rng(3)
    b, h, s, d, shards = 2, 4, 512, 64, 4
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.normal(size=sh).astype(np.float32)).to(cuda, dt)
               for sh in ((b, h, d), (b, h, s, d), (b, h, s, d)))
    parts = [decode_attention(q, k[:, :, i * s // shards:(i + 1) * s // shards],
                              v[:, :, i * s // shards:(i + 1) * s // shards],
                              return_partial=True) for i in range(shards)]
    merged = merge_partials(*(list(x) for x in zip(*parts))).float()
    full, _, _ = decode_attention_ref(q, k, v)
    torch.testing.assert_close(merged, full.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
def test_cuda_decode_attention_rejects_unsupported(cuda):
    q = torch.zeros((1, 4, 36), device=cuda)
    k = torch.zeros((1, 2, 16, 36), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        decode_attention(q, k, k)
    q = torch.zeros((1, 34, 64), device=cuda)
    k = torch.zeros((1, 2, 16, 64), device=cuda)
    with pytest.raises(ValueError, match="group"):
        decode_attention(q, k, k)
    q = torch.zeros((1, 4, 64), device=cuda)
    with pytest.raises(ValueError, match="contiguous last dim"):
        kt = k.transpose(2, 3).contiguous().transpose(2, 3)
        decode_attention(q, kt, kt)
    with pytest.raises(ValueError, match="kv_len"):
        decode_attention(q, k, k, kv_len=torch.tensor([3, 4], device=cuda))


def _assert_bag(table, idx, w, mode, nan_rows):
    """One launch of ``bag_route``'s kernel and none of the other; the
    bags in ``nan_rows`` (an id past the table) NaN in every column and
    NaN nowhere else, the rest against the plain version."""
    b, e = idx.shape[0], table.shape[1]
    sms = torch.cuda.get_device_properties(table.device).multi_processor_count
    lanes = bag_route(b, e, sms) == "lanes"
    kernel, other = ((EMBEDDING_BAG_LANES_KERNEL, EMBEDDING_BAG_KERNEL) if lanes
                     else (EMBEDDING_BAG_KERNEL, EMBEDDING_BAG_LANES_KERNEL))
    before, before_other = kernel.launches, other.launches
    got = embedding_bag(table, idx, w, mode=mode)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1 and other.launches == before_other
    assert got.dtype == table.dtype and got.shape == (b, e)
    nan = torch.zeros(b, dtype=torch.bool, device=table.device)
    nan[nan_rows] = True
    assert torch.isnan(got[nan]).all() and not torch.isnan(got[~nan]).any()
    tol = 3e-2 if table.dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(
        got[~nan].float(),
        embedding_bag_ref(table, idx, w, mode=mode)[~nan].float(),
        atol=tol, rtol=tol)
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("v,e,b,l,mode,dtype,weighted", [
    (64, 8, 4, 6, "sum", "float32", False),          # test_kernels.py
    (128, 16, 8, 3, "mean", "float32", False),
    (1000, 32, 16, 10, "sum", "float32", False),
    (64, 128, 4, 4, "mean", "bfloat16", False),
    (32, 8, 4, 5, "sum", "float32", True),
    (40 * 4096, 1, 512, 40, "sum", "float32", False),    # E = 1, wd_p99's B
    (5000, 1, 300, 7, "mean", "bfloat16", True),
    (300, 37, 33, 9, "mean", "float32", True),
    (5000, 1, 200_000, 40, "sum", "float32", False),     # the column route
    (5000, 1, 300, 17, "sum", "float32", True),          # 32-lane groups
    (5000, 1, 300, 12, "mean", "float32", False),        # 16-lane groups
    (5000, 1, 300, 5, "sum", "bfloat16", True),          # 8-lane groups
])
def test_cuda_embedding_bag_matches_plain(cuda, v, e, b, l, mode, dtype,
                                          weighted):
    """Padding, an all-padding bag (0), and an id past the table in bag
    1 (the bag's row NaN, as the reference's), through the route's
    kernel."""
    rng = np.random.default_rng(v + e + b)
    dt = getattr(torch, dtype)
    table = torch.from_numpy(rng.normal(size=(v, e)).astype(np.float32)).to(cuda, dt)
    idx = rng.integers(-1, v, size=(b, l)).astype(np.int32)
    idx[0] = -1                                       # an all-padding bag
    idx[1, 0] = v + 3                                 # past the table: NaN
    idx = torch.from_numpy(idx).to(cuda)
    w = (torch.from_numpy(rng.normal(size=(b, l)).astype(np.float32)).to(cuda)
         if weighted else None)
    got = _assert_bag(table, idx, w, mode, [1])
    assert (got[0] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("extra", [0, 1])
def test_cuda_embedding_bag_route_edge(cuda, extra):
    """At the rule's edge (``LANE_BAGS_PER_SM`` bags per SM: the lane
    route) and one bag past it (the column route), Wide&Deep's E = 1, L =
    40, with ids V, 2**31 - 1 and -1 planted."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    b, v, l = LANE_BAGS_PER_SM * sms + extra, 40 * 4096, 40
    assert bag_route(b, 1, sms) == ("lanes", "column")[extra]
    rng = np.random.default_rng(b)
    table = torch.from_numpy(rng.normal(size=(v, 1)).astype(np.float32)).to(cuda)
    idx = rng.integers(0, v, size=(b, l)).astype(np.int32)
    idx[3, 5], idx[7, 39], idx[b - 1, 0], idx[9, :20] = v, 2**31 - 1, v + 1, -1
    _assert_bag(table, torch.from_numpy(idx).to(cuda), None, "mean",
                [3, 7, b - 1])


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("l", [16, 40, 41])
@pytest.mark.parametrize("mode,weighted", [("sum", True), ("mean", False),
                                           ("mean", True)])
def test_cuda_embedding_bag_column_route(cuda, l, mode, weighted, offset):
    """Past the lane route's edge at E = 1 (the column route, in passes of
    ``PASS_IDS`` ids: one at L = 16, three at 40 and 41): one launch of
    ``embedding_bag`` and none of ``embedding_bag_lanes``, with ids past
    the table (NaN rows) and padding planted, against the plain version;
    and bit for bit equal to the warp route's loop (eb_bag_column, the
    whole bag at once) over column 0 of a two-column table that holds
    the table there.  ``offset`` 1 puts the ids (and weights) 4 bytes off
    16-byte alignment."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    b, v = LANE_BAGS_PER_SM * sms + 1000, 40 * 4096
    assert bag_route(b, 1, sms) == "column" and bag_route(b, 2, sms) == "warp"
    assert -(-l // PASS_IDS) == (1 if l == 16 else 3)
    rng = np.random.default_rng(l + offset)
    table = torch.from_numpy(rng.normal(size=(v, 1)).astype(np.float32)).to(cuda)
    idx = rng.integers(-1, v, size=(b, l)).astype(np.int32)
    idx[0] = -1
    idx[3, 5], idx[7, l - 1], idx[b - 1, 0] = v, 2**31 - 1, v + 1
    idx = _at_offset(torch.from_numpy(idx).to(cuda), offset)
    w = (_at_offset(torch.from_numpy(rng.normal(size=(b, l)).astype(np.float32))
                    .to(cuda), offset) if weighted else None)
    assert (idx.data_ptr() % 16 == 0) == (offset == 0)
    got = _assert_bag(table, idx, w, mode, [3, 7, b - 1])
    assert (got[0] == 0).all()
    wide = torch.zeros((v, 2), device=cuda)
    wide[:, 0] = table[:, 0]
    before = EMBEDDING_BAG_KERNEL.launches
    warp = embedding_bag(wide, idx, w, mode=mode)[:, :1]
    torch.cuda.synchronize()
    assert EMBEDDING_BAG_KERNEL.launches == before + 1
    assert torch.equal(got.view(torch.int32), warp.view(torch.int32))


@pytest.mark.gpu
def test_cuda_embedding_bag_rejects_unsupported(cuda):
    table = torch.zeros((8, 4), device=cuda)
    with pytest.raises(ValueError, match="int32"):
        embedding_bag(table, torch.zeros((2, 3), dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        embedding_bag(table.t().contiguous().t(),
                      torch.zeros((2, 3), dtype=torch.int32, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("arch_id", ["wide-deep", "deepfm"])
def test_cuda_recsys_forward_matches_cpu(cuda, arch_id):
    """A reduced Wide&Deep / DeepFM forward on the card (one embedding-bag
    launch) against the same weights on the CPU (the plain bag)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(arch_id).model_cfg(True)
    init, fwd = {"wide-deep": (recsys.wide_deep_init, recsys.wide_deep_forward),
                 "deepfm": (recsys.deepfm_init, recsys.deepfm_forward)}[arch_id]
    params = init(cfg, seed=0, device="cpu")
    ids = np.random.default_rng(1).integers(0, cfg.vocab_per_field,
                                            (64, cfg.n_sparse))
    before = EMBEDDING_BAG_LANES_KERNEL.launches    # 64 bags: the lane route
    on_card = fwd({k: (v.to(cuda) if isinstance(v, torch.Tensor) else
                       {kk: vv.to(cuda) for kk, vv in v.items()})
                   for k, v in params.items()}, ids, cfg)
    torch.cuda.synchronize()
    assert EMBEDDING_BAG_LANES_KERNEL.launches == before + 1
    torch.testing.assert_close(on_card.cpu(), fwd(params, ids, cfg, device="cpu"),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
def test_cuda_mistral_nemo_two_layer_decode_kernel_and_plain(cuda):
    """Mistral-NeMo-12B at full width, 2 layers, random weights: one
    decode step from a 700-token prefill cache through the decode kernel
    (one launch per layer) and through the plain einsums, from copies of
    the same cache; the logits within the bf16 bound of the prefill test
    above (0.1 + 0.05|logit|), and the caches written alike."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_arch("mistral-nemo-12b").model_cfg(False),
                              n_layers=2, use_flash=True)
    plain = dataclasses.replace(cfg, use_flash=False)
    params = init_params(cfg, seed=0, device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 700))).to(cuda)
    logits, cache = prefill(params, tokens, cfg)
    cache = {f: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 8))
             for f, c in cache.items()}
    other = {f: c.clone() for f, c in cache.items()}
    token, pos = logits.argmax(-1), torch.tensor([700, 650], device=cuda)
    before = DECODE_ATTENTION_TC_KERNEL.launches      # bf16, D 128: the tc route
    got, cache = decode_step(params, token, cache, pos, cfg)
    torch.cuda.synchronize()
    assert DECODE_ATTENTION_TC_KERNEL.launches == before + cfg.n_layers
    want, other = decode_step(params, token, other, pos, plain)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=0.1, rtol=0.05)
    for f in ("k", "v"):
        assert torch.equal(cache[f][0], other[f][0])


@pytest.mark.gpu
def test_cuda_deepseek_two_layer_fp32_decode_equals_prefill(cuda):
    """DeepSeek-V2-Lite at full width (MLA, 64-expert MoE), 2 layers, in
    fp32: a decode step for token S from prefill(S)'s compressed cache
    (the absorbed form) gives prefill(S + 1)'s last logits (the
    materialised form) within 1e-4 + 1e-4|logit|: float32 on both sides,
    TF32 off, only the summation order differs (a wrong cache row, RoPE
    position or mask moves logits by 1e-2 or more)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("deepseek-v2-lite-16b").model_cfg(False)
    cfg = dataclasses.replace(cfg, n_layers=2, param_dtype=torch.float32,
                              moe=no_drop(cfg.moe))
    params = init_params(cfg, seed=0, device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 513))).to(cuda)
    _, cache = prefill(params, tokens[:, :512], cfg)
    assert cache["c"].shape == (2, 2, 512, cfg.mla.kv_lora_rank)
    assert cache["k_rope"].shape == (2, 2, 512, cfg.mla.d_rope)
    cache = {f: torch.nn.functional.pad(c, (0, 0, 0, 8)) for f, c in cache.items()}
    pos = torch.full((2,), 512, device=cuda)
    got, cache = decode_step(params, tokens[:, 512], cache, pos, cfg)
    want, full = prefill(params, tokens, cfg)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    for f in ("c", "k_rope"):       # the decoded row is prefill's row 512
        torch.testing.assert_close(cache[f][:, :, 512], full[f][:, :, 512],
                                   atol=1e-4, rtol=1e-4)


@pytest.mark.gpu
def test_cuda_moe_ffn_matches_dense_and_reruns_bit_equal(cuda):
    """DeepSeek-V2-Lite's MoE FFN at full width (64 experts, top-6, 2
    shared), fp32: ``moe_ffn`` at a capacity of T against the dense
    formulation (every expert on every token, gates zeroed outside the
    top-k) within 1e-4 + 1e-4|out| (float32, summation order only); then
    bf16 over 4096 tokens at the config's own capacity, where some
    assignments drop: two calls give the same bits (no atomics)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("deepseek-v2-lite-16b").model_cfg(False).moe
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = moe_init(gen, cfg)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(64, cfg.d_model)).astype(np.float32)).to(cuda)
    got, aux = moe_ffn(params, x, cfg, capacity=64)
    want = moe_ffn_dense(params, x, cfg)
    assert torch.isfinite(got).all() and aux.item() > 0
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)

    bf = moe_init(gen, cfg, dtype=torch.bfloat16)
    assert bf["router"].dtype == torch.float32
    xb = torch.from_numpy(rng.normal(size=(4096, cfg.d_model)).astype(np.float32)
                          ).to(cuda, torch.bfloat16)
    first, _ = moe_ffn(bf, xb, cfg)
    again, _ = moe_ffn(bf, xb, cfg)
    assert first.dtype == torch.bfloat16 and torch.isfinite(first).all()
    assert torch.equal(first, again)


@pytest.mark.gpu
def test_cuda_grok1_one_layer_flash_and_decode_kernels_and_plain(cuda):
    """Grok-1 at full width (GQA 48:8, group 6, d_head 128, 8-expert
    MoE), 1 layer, bf16, random weights: prefill through the tensor-core
    flash kernel (one launch) and through the plain chunked attention;
    layer 0's attention output within the bf16 tolerance 2e-2, the
    logits within the bound of the Mistral-NeMo tests (0.1 +
    0.05|logit|); then one decode step from copies of one cache through
    the tensor-core decode kernel (one launch, none on the CUDA cores)
    and the plain einsums, within the same bound, the caches written
    alike.  Capacity >= T (``no_drop``), so a token's routing never
    hangs on another's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch("grok-1-314b").model_cfg(False)
    cfg = dataclasses.replace(cfg, n_layers=1, use_flash=True,
                              moe=no_drop(cfg.moe))
    plain = dataclasses.replace(cfg, use_flash=False)
    params = init_params(cfg, seed=0, device=cuda)
    assert params["layers"]["ffn"]["router"].dtype == torch.float32
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 700))).to(cuda)
    before = FLASH_ATTENTION_TC_KERNEL.launches
    logits, cache = prefill(params, tokens, cfg)
    torch.cuda.synchronize()
    assert FLASH_ATTENTION_TC_KERNEL.launches == before + 1
    plain_logits, plain_cache = prefill(params, tokens, plain)
    assert logits.shape == (2, cfg.vocab) and torch.isfinite(logits).all()
    for f in ("k", "v"):
        assert torch.equal(cache[f], plain_cache[f])
    lp = params["layers"]
    h = rms_norm(params["embed"][tokens], lp["ln1"][0])
    attn0 = {k: w[0] for k, w in lp["attn"].items()}
    torch.testing.assert_close(gqa_forward(attn0, h, cfg.attn_cfg()).float(),
                               gqa_forward(attn0, h, plain.attn_cfg()).float(),
                               atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(logits, plain_logits, atol=0.1, rtol=0.05)

    cache = {f: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 8))
             for f, c in cache.items()}
    other = {f: c.clone() for f, c in cache.items()}
    token, pos = logits.argmax(-1), torch.tensor([700, 650], device=cuda)
    tc, cc = DECODE_ATTENTION_TC_KERNEL.launches, DECODE_ATTENTION_KERNEL.launches
    got, cache = decode_step(params, token, cache, pos, cfg)
    torch.cuda.synchronize()
    assert DECODE_ATTENTION_TC_KERNEL.launches == tc + 1
    assert DECODE_ATTENTION_KERNEL.launches == cc
    want, other = decode_step(params, token, other, pos, plain)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=0.1, rtol=0.05)
    for f in ("k", "v"):
        assert torch.equal(cache[f], other[f])


# ------------------------------------------------------------ training
@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_cuda_td_update_order_is_pinned(cuda, seed):
    """The TD scatter-mean on the card: 2048 transitions into a few dozen
    cells (hundreds a cell), twice bit-equal, a permutation of them
    bit-equal too, and within 1e-6 of the CPU's (both sum each cell in
    float64 and round once; only the float64 sum order may differ)."""
    from repro_torch.core.qlearning import QConfig, td_update

    rng = np.random.default_rng(seed)
    t_max, b, p, n_actions = 8, 256, 8, 8
    tr = {"s": rng.integers(0, p, (t_max, b)).astype(np.int32),
          "a": rng.integers(0, 4, (t_max, b)).astype(np.int32),
          "r": rng.normal(scale=0.05, size=(t_max, b)).astype(np.float32),
          "s2": rng.integers(0, p, (t_max, b)).astype(np.int32),
          "done": rng.random((t_max, b)) < 0.3,
          "valid": rng.random((t_max, b)) < 0.8}
    qcfg = QConfig(p=p, n_actions=n_actions, gamma=1.0)
    q = torch.from_numpy(rng.normal(scale=0.1, size=(p, n_actions))
                         .astype(np.float32))
    on = {k: torch.from_numpy(v).to(cuda) for k, v in tr.items()}
    got = td_update(qcfg, q.to(cuda), on)
    assert torch.equal(td_update(qcfg, q.to(cuda), on), got)
    perm = torch.from_numpy(rng.permutation(t_max * b)).to(cuda)
    shuffled = {k: v.reshape(-1)[perm] for k, v in on.items()}
    assert torch.equal(td_update(qcfg, q.to(cuda), shuffled), got)
    want = td_update(qcfg, q, {k: torch.from_numpy(v) for k, v in tr.items()})
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-6)


@pytest.mark.gpu
def test_cuda_training_step_and_policy(cuda):
    """A small system on the card and on the CPU, the same L1 parameters
    and bins: one ``policy_train_step`` with the same draws gives Q within
    1e-6 (L1 scores from cuBLAS and the CPU differ in the last ulps, and
    rewards are sums of scores) through the chunk kernel; then
    ``train_policy`` on the card is bit-equal run to run and between the
    ``block_scan`` and ``reference`` backends."""
    import copy

    from repro_torch.data.querylog import CAT1, CAT2, QueryLogConfig
    from repro_torch.index.corpus import CorpusConfig
    from repro_torch.system import RetrievalSystem, SystemConfig

    cfg = SystemConfig(corpus=CorpusConfig(n_docs=2048, vocab_size=1024),
                       querylog=QueryLogConfig(n_queries=300), block_docs=256,
                       p_bins=256, u_budget=2048, rule_du_scale=4,
                       rule_dv_scale=20, l1_hidden=64, l1_steps=100)
    host = RetrievalSystem(cfg, device="cpu")
    card = RetrievalSystem(cfg, device=cuda)
    losses = host.fit_l1(n_queries=64, batch=16)
    assert losses[-1] < losses[0]
    card.l1_params = {k: v.to(cuda) for k, v in host.l1_params.items()}
    host.fit_state_bins(n_queries=32, batch=16)
    card.fit_state_bins(n_queries=32, batch=16)
    assert torch.equal(card.bins.v_edges.cpu(), host.bins.v_edges)

    qids = np.where(host.log.category == CAT1)[0][:32]
    g = torch.Generator().manual_seed(3)
    draws = (torch.randint(0, host.env_cfg.n_actions, (cfg.t_max, 32),
                           generator=g, dtype=torch.int32),
             torch.rand((cfg.t_max, 32), generator=g))
    q = torch.from_numpy(np.random.default_rng(4).normal(
        scale=0.05, size=(host.qcfg.p, host.qcfg.n_actions)).astype(np.float32))
    before = BLOCK_SCAN_RULE_KERNEL.launches
    got, m = card.policy_train_step(CAT1, q.to(cuda), tuple(d.to(cuda) for d in draws),
                                    0.3, qids)
    torch.cuda.synchronize()
    assert BLOCK_SCAN_RULE_KERNEL.launches > before
    want, wm = host.policy_train_step(CAT1, q, draws, 0.3, qids)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-6)
    for k in wm:
        torch.testing.assert_close(m[k].cpu(), wm[k], rtol=1e-6, atol=1e-6)

    q1, _ = card.train_policy(CAT2, iters=6, batch=32, seed=2)
    q2, _ = card.train_policy(CAT2, iters=6, batch=32, seed=2)
    ref = copy.copy(card)
    ref.cfg = dataclasses.replace(card.cfg, backend="reference")
    q3, _ = ref.train_policy(CAT2, iters=6, batch=32, seed=2)
    assert q1.device.type == "cuda"
    assert torch.equal(q1, q2) and torch.equal(q1, q3)


@pytest.mark.gpu
def test_cuda_engine_matches_executor_and_holds_compile_count(cuda):
    """A small system on the card served through ``ServeEngine``: each
    category's micro-batch (5 real lanes padded to a bucket of 8) gives
    the real lanes of ``ShardedExecutor.execute`` on the same padded
    batch bit for bit, at FULL and SHALLOW, through the chunk kernel;
    after ``warmup`` a mixed stream prepares no serve step."""
    from repro_torch.data.querylog import CAT1, CAT2, QueryLogConfig
    from repro_torch.index.corpus import CorpusConfig
    from repro_torch.policies import PolicyStore, TabularQPolicy
    from repro_torch.serving import (EngineConfig, ServeEngine, ServiceLevel,
                                     ShardedExecutor)
    from repro_torch.system import RetrievalSystem, SystemConfig

    cfg = SystemConfig(corpus=CorpusConfig(n_docs=2048, vocab_size=1024),
                       querylog=QueryLogConfig(n_queries=300), block_docs=256,
                       p_bins=256, u_budget=2048, rule_du_scale=4,
                       rule_dv_scale=20, l1_hidden=64)
    sys_ = RetrievalSystem(cfg, device=cuda)
    sys_.fit_state_bins(n_queries=32, batch=16)
    q = torch.from_numpy(np.random.default_rng(3).normal(
        size=(sys_.bins.p, sys_.env_cfg.n_actions)).astype(np.float32))
    policies = {CAT1: TabularQPolicy(q.to(cuda)),
                CAT2: TabularQPolicy(q.flip(0).contiguous().to(cuda))}
    store = PolicyStore(staleness_bound=0)
    store.publish(policies, fallbacks=sys_.fallback_policies())
    engine = ServeEngine(sys_, store, EngineConfig(
        min_bucket=8, max_bucket=16, cache_capacity=0))
    n_warm = engine.warmup()
    exe = ShardedExecutor(sys_)
    fallbacks = sys_.fallback_policies()
    for cat in (CAT1, CAT2):
        qids = np.where(sys_.log.category == cat)[0][:5]
        padded = np.concatenate([qids, np.full(3, qids[0])])
        inputs = sys_.batch_inputs(padded)
        for level, policy in ((ServiceLevel.FULL, policies[cat]),
                              (ServiceLevel.SHALLOW, fallbacks[cat])):
            before = BLOCK_SCAN_RULE_KERNEL.launches
            got = engine.serve(qids, level)
            assert BLOCK_SCAN_RULE_KERNEL.launches > before
            ids, sc, u, cnt = exe.execute(policy, *inputs)
            for lane, r in enumerate(got):
                assert r.level == level and not r.cached
                np.testing.assert_array_equal(r.doc_ids, ids[lane])
                np.testing.assert_array_equal(r.scores, sc[lane])
                assert (r.u, r.cand_cnt) == (u[lane], cnt[lane])
    rng = np.random.default_rng(4)
    for _ in range(3):
        engine.serve(rng.integers(0, sys_.log.n_queries, size=21))
        engine.serve(rng.integers(0, sys_.log.n_queries, size=7),
                     ServiceLevel.SHALLOW)
    assert engine.compile_count == n_warm


@pytest.mark.gpu
def test_cuda_cluster_matches_reference_engine(cuda):
    """Two thread replicas on the card (the chunk kernel) serve a stream
    — per ticket and by slab, hot keys repeated — whose every response
    equals a ``reference``-backend ``ServeEngine``'s on the same
    snapshot (ids, scores, u, candidates, version, level); the chunk
    kernel launched from the replica threads, no replica prepared a
    serve step after warmup, and no ticket was shed."""
    from repro_torch.cluster import ClusterConfig, ReplicaSet, Shed
    from repro_torch.data.querylog import CAT1, CAT2, QueryLogConfig
    from repro_torch.index.corpus import CorpusConfig
    from repro_torch.policies import PolicyStore, TabularQPolicy
    from repro_torch.serving import EngineConfig, ServeEngine
    from repro_torch.system import RetrievalSystem, SystemConfig

    cfg = SystemConfig(corpus=CorpusConfig(n_docs=2048, vocab_size=1024),
                       querylog=QueryLogConfig(n_queries=300), block_docs=256,
                       p_bins=256, u_budget=2048, rule_du_scale=4,
                       rule_dv_scale=20, l1_hidden=64)
    sys_ = RetrievalSystem(cfg, device=cuda)
    sys_.fit_state_bins(n_queries=32, batch=16)
    q = torch.from_numpy(np.random.default_rng(5).normal(
        size=(sys_.bins.p, sys_.env_cfg.n_actions)).astype(np.float32))
    store = PolicyStore(staleness_bound=1)
    store.publish({CAT1: TabularQPolicy(q.to(cuda)),
                   CAT2: TabularQPolicy(q.flip(0).contiguous().to(cuda))},
                  fallbacks=sys_.fallback_policies())
    ecfg = dict(min_bucket=8, max_bucket=16, cache_capacity=64)
    cluster = ReplicaSet(sys_, store, ClusterConfig(n_replicas=2),
                         EngineConfig(backend="block_scan", **ecfg))
    n_warm = cluster.warmup()
    rng = np.random.default_rng(6)
    waves = [rng.integers(0, sys_.log.n_queries, size=n) for n in (24, 9, 40)]
    waves.append(waves[0][:12])                      # repeats: cache hits
    before = BLOCK_SCAN_RULE_KERNEL.launches
    got = []
    with cluster:
        for i, wave in enumerate(waves):
            serve = cluster.serve if i % 2 else cluster.serve_many
            got += serve(wave, timeout_s=120.0)
    assert BLOCK_SCAN_RULE_KERNEL.launches > before
    assert sum(r.engine.compile_count for r in cluster.replicas) == n_warm
    assert not any(isinstance(r, Shed) for r in got)
    assert any(r.cached for r in got)
    ref = ServeEngine(sys_, store, EngineConfig(backend="reference", **ecfg))
    want = ref.serve(np.concatenate(waves))
    for g, w in zip(got, want, strict=True):
        assert (g.qid, g.u, g.cand_cnt, g.policy_version, g.level) == \
            (w.qid, w.u, w.cand_cnt, w.policy_version, w.level)
        np.testing.assert_array_equal(g.doc_ids, w.doc_ids)
        np.testing.assert_array_equal(g.scores, w.scores)


def _live_system(cuda, tmp_path):
    from repro_torch.data.querylog import QueryLogConfig
    from repro_torch.index.corpus import CorpusConfig
    from repro_torch.index.live import LiveRetrievalSystem
    from repro_torch.system import SystemConfig

    cfg = SystemConfig(corpus=CorpusConfig(n_docs=2048, vocab_size=1024),
                       querylog=QueryLogConfig(n_queries=300), block_docs=256,
                       p_bins=256, u_budget=2048, rule_du_scale=4,
                       rule_dv_scale=20, l1_hidden=64)
    sys_ = LiveRetrievalSystem(cfg, capacity_docs=4096, storage_dir=tmp_path,
                               device=cuda)
    sys_.fit_state_bins(n_queries=32, batch=16)
    return sys_


def _fresh_doc(rng, vocab=1024):
    return [np.unique(rng.integers(0, vocab, size=k)).astype(np.int32)
            for k in (2, 3, 40, 6)]


@pytest.mark.gpu
def test_cuda_live_system_parity_through_add_update_commit_merge(cuda,
                                                                 tmp_path):
    """A live system on the card through adds, base-doc updates, commits
    and a merge: ``check_epoch_parity`` is green at every epoch on both
    backends (structure, occupancy, and the production plans' final
    state bit-equal between the chunk kernel and ``reference``), the
    chunk kernel launched, the merged base is mmapped, and each epoch's
    scoring planes lie on the card at the capacity span."""
    from repro_torch.index.live import check_epoch_parity

    sys_ = _live_system(cuda, tmp_path)
    rng = np.random.default_rng(8)
    qids = rng.choice(sys_.log.n_queries, size=12, replace=False)
    epochs = []
    sys_.live.store.subscribe(epochs.append)
    for _ in range(2):
        sys_.add_documents([_fresh_doc(rng) for _ in range(40)],
                           static_rank=[0.01] * 40)
        for d in rng.choice(2048, size=8, replace=False):
            sys_.update_document(int(d), _fresh_doc(rng))
        sys_.commit_index()
    sys_.merge_index()
    assert len(epochs) == 4 and epochs[-1].generation == 1
    assert sys_.live.stats()["base_mmapped"]
    before = BLOCK_SCAN_RULE_KERNEL.launches
    for ep in epochs:
        assert check_epoch_parity(sys_, ep, qids)["ok"]
        sr, dl = sys_._epoch_planes(ep)
        assert sr.device.type == dl.device.type == "cuda"
        assert sr.shape == (4096,) and dl.shape[0] == 4096
    assert BLOCK_SCAN_RULE_KERNEL.launches > before
    occ, scores, _ = sys_.batch_inputs(qids, epoch=epochs[1])
    assert occ.device.type == "cuda" and occ.shape[1] == 16
    assert scores.shape == (12, 4096)


@pytest.mark.gpu
def test_cuda_engine_epoch_swap_answers_at_the_new_epoch(cuda, tmp_path):
    """An engine on a live system on the card: a hit at epoch N, then a
    commit; the next answer is at N+1, not from the cache, and equal to
    a ``reference``-backend engine's at N+1 (ids, scores, u, candidates)."""
    from repro_torch.data.querylog import CAT2
    from repro_torch.policies import PolicyStore
    from repro_torch.serving import EngineConfig, ServeEngine

    sys_ = _live_system(cuda, tmp_path)
    store = PolicyStore(staleness_bound=0)
    store.publish(sys_.baseline_policies(), fallbacks=sys_.fallback_policies())
    ecfg = dict(min_bucket=4, max_bucket=8, cache_capacity=64)
    engine = ServeEngine(sys_, store, EngineConfig(backend="block_scan", **ecfg))
    engine.warmup()
    qids = [3, 11, 40]
    first = engine.serve(qids)
    again = engine.serve(qids)
    assert all(r.cached for r in again)
    e0 = first[0].index_epoch
    rng = np.random.default_rng(9)
    docs = [_fresh_doc(rng) for _ in range(4)]
    ids = sys_.add_documents(docs, static_rank=[0.01] * 4)
    [fresh] = sys_.append_queries([docs[0][3][:2]], [CAT2],
                                  judged_ids=[[ids[0]]], judged_gains=[[4]])
    sys_.commit_index()
    before = BLOCK_SCAN_RULE_KERNEL.launches
    after = engine.serve(qids + [int(fresh)])
    assert BLOCK_SCAN_RULE_KERNEL.launches > before
    assert all(r.index_epoch == e0 + 1 and not r.cached for r in after)
    assert engine.summary()["index_epoch_swaps"] == 1
    ref = ServeEngine(sys_, store, EngineConfig(backend="reference", **ecfg))
    for g, w in zip(after, ref.serve(qids + [int(fresh)]), strict=True):
        assert (g.qid, g.u, g.cand_cnt, g.index_epoch) == \
            (w.qid, w.u, w.cand_cnt, w.index_epoch)
        np.testing.assert_array_equal(g.doc_ids, w.doc_ids)
        np.testing.assert_array_equal(g.scores, w.scores)


@pytest.mark.gpu
def test_cuda_process_cell_matches_thread_cell(cuda, tmp_path):
    """Two worker processes on the card (each its own CUDA context) over
    a live system, across a relayed commit: every response equal to a
    thread cell's on the same system and store (every field but
    latency, waves of distinct keys served to completion), and the
    chunk kernel launched inside both workers."""
    import os

    from repro_torch.cluster import ClusterConfig, ReplicaSet, Shed
    from repro_torch.policies import PolicyStore
    from repro_torch.serving import EngineConfig
    from repro_torch.serving.cache import canonical_query_key

    sys_ = _live_system(cuda, tmp_path / "gens")
    store = PolicyStore()
    store.publish(sys_.baseline_policies(), fallbacks=sys_.fallback_policies())
    ecfg = EngineConfig(min_bucket=8, max_bucket=16, cache_capacity=256,
                        backend="block_scan")
    proc = ReplicaSet(sys_, store, ClusterConfig(
        n_replicas=2, backend="process", spill_margin=64,
        proc_storage_dir=str(tmp_path / "cell")), ecfg)
    thread = ReplicaSet(sys_, store, ClusterConfig(n_replicas=2,
                                                   spill_margin=64), ecfg)
    keys, qids = set(), []
    for q in np.random.default_rng(5).permutation(sys_.log.n_queries):
        key = canonical_query_key(sys_.log.terms[q], int(sys_.log.category[q]))
        if key not in keys:
            keys.add(key)
            qids.append(int(q))
    got = {"proc": [], "thread": []}
    with proc, thread:
        proc.kernel_launches(reset=True)
        for wave in (qids[:24], qids[:8] + qids[24:40]):
            for name, c in (("proc", proc), ("thread", thread)):
                got[name] += c.serve(wave, timeout_s=300.0)
        rng = np.random.default_rng(6)
        sys_.add_documents([_fresh_doc(rng) for _ in range(8)],
                           static_rank=[0.01] * 8)
        sys_.commit_index()
        for _ in range(3000):
            if min(r.index_epoch for r in proc.replicas) >= sys_.index_epoch:
                break
            time.sleep(0.01)
        for name, c in (("proc", proc), ("thread", thread)):
            got[name] += c.serve(qids[:24], timeout_s=300.0)
        launches = [r.kernel_launches()["block_scan_pruned_chunk_rule"]
                    for r in proc.replicas]
        summaries = proc.stats()["replicas"]
    assert all(n > 0 for n in launches), launches
    assert {s["device"] for s in summaries} == {"cuda"}
    pids = {s["worker_pid"] for s in summaries}
    assert len(pids) == 2 and os.getpid() not in pids
    assert len(got["proc"]) == len(got["thread"]) == 72
    for a, b in zip(got["proc"], got["thread"], strict=True):
        assert not isinstance(a, Shed) and not isinstance(b, Shed)
        for f in dataclasses.fields(a):
            if f.name != "latency_s":
                np.testing.assert_array_equal(getattr(a, f.name),
                                              getattr(b, f.name), f.name)
    assert {r.index_epoch for r in got["proc"][-24:]} == {sys_.index_epoch}


# ------------------------------------------------------------ train slice
def _tree_to(tree, dev):
    from repro_torch.train.tree import tree_map

    return tree_map(lambda t: t.to(dev), tree)


@pytest.mark.gpu
@pytest.mark.parametrize("b,e", [(64, 1), (150_000, 1), (64, 5)])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_cuda_embedding_bag_gradient_equals_cpu(cuda, b, e, mode, weighted):
    """The bag wrapper's gradient on the card (forward on the kernel: the
    lane route at 64 bags, the column route at 150,000, the warp route at
    E = 5) against the same call on the CPU (the plain version, the same
    backward), table and weights, within 1e-6; ids repeat across bags,
    with -1 padding.  The backward launches no kernel, and a second
    backward gives the same bits."""
    from repro_torch.kernels.embedding_bag import embedding_bag_backward

    rng = np.random.default_rng(b + e)
    v, l = 1000, 40
    table = torch.from_numpy(rng.normal(size=(v, e)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, v, (b, l)).astype(np.int32))
    idx[:, -3:] = -1
    w = (torch.from_numpy(rng.normal(size=(b, l)).astype(np.float32))
         if weighted else None)
    g = torch.from_numpy(rng.normal(size=(b, e)).astype(np.float32))
    grads = {}
    for dev in (torch.device("cpu"), cuda):
        t = table.to(dev).requires_grad_()
        ww = w.to(dev).requires_grad_() if weighted else None
        out = embedding_bag(t, idx.to(dev), ww, mode=mode)
        launches = (EMBEDDING_BAG_KERNEL.launches,
                    EMBEDDING_BAG_LANES_KERNEL.launches)
        grads[dev.type] = torch.autograd.grad(
            out, [t] + ([ww] if weighted else []), grad_outputs=g.to(dev))
        assert (EMBEDDING_BAG_KERNEL.launches,
                EMBEDDING_BAG_LANES_KERNEL.launches) == launches
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert got.grad_fn is None and got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), want, atol=1e-6, rtol=1e-6)
    again = embedding_bag_backward(g.to(cuda), idx.to(cuda),
                                   None if w is None else w.to(cuda), v, mode,
                                   table=table.to(cuda))
    assert torch.equal(again[0], grads["cuda"][0])


@pytest.mark.gpu
def test_cuda_flash_and_decode_refuse_grad(cuda):
    """The attention kernels have no backward: under grad mode with an
    input that requires grad they raise; under no_grad they run."""
    q = torch.randn(1, 4, 16, 64, device=cuda, requires_grad=True)
    k = torch.randn(1, 2, 16, 64, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, k, k)
    with torch.no_grad():
        assert flash_attention(q, k, k).shape == q.shape
    qd = torch.randn(1, 4, 64, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        decode_attention(qd, k, k)
    with torch.no_grad():
        assert decode_attention(qd, k, k)[0].shape == qd.shape


def _lm_step(dev, arch_id, np_seed=3):
    from repro_torch.launch.steps import _lm_opt_cfg, build_cell
    from repro_torch.train.optimizer import adamw_init

    cfg = get_arch(arch_id).model_cfg(True)
    params = _tree_to(init_params(cfg, seed=0, device="cpu"), dev)
    opt = adamw_init(params, _lm_opt_cfg(True))
    cell = build_cell(arch_id, "train_4k", reduced=True)
    toks = torch.from_numpy(np.random.default_rng(np_seed).integers(
        0, cfg.vocab, (4, 65)).astype(np.int32)).to(dev)
    params, opt, m = cell.fn(params, opt, toks[:, :-1], toks[:, 1:])
    return params, opt, m


def _rel_l2(got, want):
    return float((got.double() - want.double()).norm()
                 / want.double().norm().clamp_min(1e-30))


@pytest.mark.gpu
@pytest.mark.parametrize("arch_id", ["starcoder2-3b", "deepseek-v2-lite-16b"])
def test_cuda_lm_train_step_matches_cpu_and_reruns_bit_equal(cuda, arch_id):
    """A reduced LM train step (fp32, the plain attention) on the card
    against the CPU: loss and grad norm within 1e-4, every new parameter
    and moment leaf within 1e-4 relative L2 (float32, summation order
    only; the first Adam step moves elements by about lr); two card steps
    from the same state give the same bits (every backward in a fixed
    order)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.train.tree import tree_leaves

    cpu = _lm_step(torch.device("cpu"), arch_id)
    gpu = _lm_step(cuda, arch_id)
    again = _lm_step(cuda, arch_id)
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(gpu[2][key].cpu(), cpu[2][key],
                                   atol=1e-4, rtol=1e-4)
        assert torch.equal(gpu[2][key], again[2][key])
    for a, b, c in zip(tree_leaves(gpu[:2]), tree_leaves(cpu[:2]),
                       tree_leaves(again[:2])):
        assert _rel_l2(a.cpu().float(), b.float()) <= 1e-4
        assert torch.equal(a, c)


def _wd_step(dev):
    from repro_torch.launch.steps import build_cell
    from repro_torch.train.optimizer import AdamWConfig, adamw_init

    cfg = get_arch("wide-deep").model_cfg(True)
    params = _tree_to(recsys.wide_deep_init(cfg, seed=0, device="cpu"), dev)
    opt = adamw_init(params, AdamWConfig(lr=1e-3))
    rng = np.random.default_rng(4)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_per_field,
                                        (64, cfg.n_sparse)).astype(np.int32))
    labels = torch.from_numpy(rng.integers(0, 2, 64).astype(np.float32))
    cell = build_cell("wide-deep", "train_batch", reduced=True)
    params, opt, loss = cell.fn(params, opt, ids.to(dev),
                                torch.zeros((64, 1), device=dev), labels.to(dev))
    return params, opt, loss


@pytest.mark.gpu
def test_cuda_wide_deep_train_step_matches_cpu_and_reruns_bit_equal(cuda):
    """A reduced Wide&Deep train step on the card (one bag launch, in the
    forward) against the CPU: the loss within 1e-5, every leaf within
    1e-4 relative L2; two card steps give the same bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.train.tree import tree_leaves

    cpu = _wd_step(torch.device("cpu"))
    before = EMBEDDING_BAG_LANES_KERNEL.launches
    gpu = _wd_step(cuda)
    torch.cuda.synchronize()
    assert EMBEDDING_BAG_LANES_KERNEL.launches == before + 1
    again = _wd_step(cuda)
    torch.testing.assert_close(gpu[2].cpu(), cpu[2], atol=1e-5, rtol=1e-5)
    assert torch.equal(gpu[2], again[2])
    for a, b, c in zip(tree_leaves(gpu[:2]), tree_leaves(cpu[:2]),
                       tree_leaves(again[:2])):
        assert _rel_l2(a.cpu(), b) <= 1e-4
        assert torch.equal(a, c)


# ------------------------------------------------- segment gather (GNN)
def _segments(seed, n, d, lengths, offset=0):
    """x (n, d) at a float ``offset`` into its buffer (offset 1: not on a
    16-byte boundary, the scalar path), ids with the dummy row (n) and
    -1 mixed in, segments of the given lengths."""
    rng = np.random.default_rng(seed)
    buf = torch.from_numpy(rng.normal(size=n * d + offset).astype(np.float32))
    x = buf[offset:].view(n, d)
    ptr = torch.from_numpy(np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64))
    idx = rng.integers(0, n, int(ptr[-1])).astype(np.int32)
    idx[::17] = n
    idx[5::23] = -1
    scale = torch.from_numpy((1.0 / np.maximum(lengths, 1)).astype(np.float32))
    return x, torch.from_numpy(idx), ptr, scale


@pytest.mark.gpu
@pytest.mark.parametrize("d,offset", [(128, 0), (100, 0), (16, 0), (1433, 0),
                                      (602, 0), (128, 1)])
@pytest.mark.parametrize("scaled", [False, True])
def test_cuda_segment_gather_equals_plain_bit_for_bit(cuda, d, offset, scaled):
    """The kernel (both load paths: 16-byte where d % 4 == 0 and x is
    aligned, else scalar) against the plain version on the CPU, which
    adds in the kernel's order: the same bits; one launch a call, and
    two launches give the same bits."""
    from repro_torch.kernels.segment_gather import (SEGMENT_GATHER_KERNEL,
                                                    segment_gather_sum,
                                                    segment_gather_sum_ref)

    lengths = np.array([0, 1, 31, 32, 33, 700, 0, 5, 64] * 20)
    x, idx, ptr, scale = _segments(d + offset, 300, d, lengths, offset)
    sc = scale if scaled else None
    want = segment_gather_sum_ref(x, idx, ptr, sc)
    xc = torch.empty(x.numel() + offset, device=cuda)[offset:].view_as(x)
    xc.copy_(x)
    args = (xc, idx.to(cuda), ptr.to(cuda), None if sc is None else sc.to(cuda))
    before = SEGMENT_GATHER_KERNEL.launches
    got = segment_gather_sum(*args)
    again = segment_gather_sum(*args)
    torch.cuda.synchronize()
    assert SEGMENT_GATHER_KERNEL.launches == before + 2
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [100, 128, 7])
def test_cuda_segment_gather_skewed_degrees_bit_for_bit(cuda, d):
    """Lognormal(0, 1.5) in-degrees over 40,000 segments, one of them
    15,000 edges and a quarter of them empty, every id in a segment: the
    kernel gives the plain version's bits (on the CPU, in edge order)
    whichever warp takes the heavy segment's group, two launches give the
    same bits, and the cost it reports on the card equals the one the
    same call reports on meta."""
    from repro_torch.kernels.segment_gather import (SEGMENT_GATHER_KERNEL,
                                                    segment_gather_sum,
                                                    segment_gather_sum_ref)

    rng = np.random.default_rng(d)
    r, n = 40_000, 20_000
    lengths = np.floor(rng.lognormal(0.0, 1.5, r)).astype(np.int64)
    lengths[rng.random(r) < 0.25] = 0
    lengths[r // 3] = 15_000
    x, idx, ptr, scale = _segments(d, n, d, lengths)
    assert int(ptr[-1]) == idx.numel() and (lengths == 0).sum() > r // 5
    want = segment_gather_sum_ref(x, idx, ptr, scale)
    args = tuple(t.to(cuda) for t in (x, idx, ptr, scale))
    before = SEGMENT_GATHER_KERNEL.launches
    (got,), card = count_call(lambda: segment_gather_sum(*args))
    again = segment_gather_sum(*args)
    torch.cuda.synchronize()
    assert SEGMENT_GATHER_KERNEL.launches == before + 2
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, again)
    _, meta = count_call(lambda: segment_gather_sum(
        *(t.to("meta") for t in (x, idx, ptr, scale))))
    k = "segment_gather"
    assert (card[k]["flops"], card[k]["bytes"]) == (meta[k]["flops"], meta[k]["bytes"])


@pytest.mark.gpu
def test_cuda_segment_mean_gradient_equals_cpu(cuda):
    """``segment_mean``'s forward and backward on the card (one launch
    each) give the CPU's bits."""
    from repro_torch.kernels.segment_gather import (SEGMENT_GATHER_KERNEL,
                                                    SegmentCSR, segment_mean)

    rng = np.random.default_rng(3)
    n, e, n_dst, d = 500, 6000, 300, 128
    h = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    src = torch.from_numpy(rng.integers(0, n + 1, e).astype(np.int32))
    dst = torch.from_numpy(rng.integers(0, n_dst + 1, e).astype(np.int32))
    g = torch.from_numpy(rng.normal(size=(n_dst, d)).astype(np.float32))

    def run(dev):
        x = h.to(dev).requires_grad_()
        out = segment_mean(x, SegmentCSR(src.to(dev), dst.to(dev), n, n_dst))
        (grad,) = torch.autograd.grad(out, x, g.to(dev))
        return out.detach().cpu(), grad.cpu()

    want = run(torch.device("cpu"))
    before = SEGMENT_GATHER_KERNEL.launches
    got = run(cuda)
    assert SEGMENT_GATHER_KERNEL.launches == before + 2
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_cuda_segment_gather_rejects_unsupported_inputs(cuda):
    from repro_torch.kernels.segment_gather import segment_gather_sum

    x = torch.zeros((4, 8), device=cuda)
    idx = torch.zeros(2, dtype=torch.int32, device=cuda)
    ptr = torch.tensor([0, 2], device=cuda)
    with pytest.raises(ValueError, match="x dtype"):
        segment_gather_sum(x.double(), idx, ptr)
    with pytest.raises(ValueError, match="contiguous"):
        segment_gather_sum(x[:, ::2], idx, ptr)
    with pytest.raises(ValueError, match="different devices"):
        segment_gather_sum(x, idx.cpu(), ptr)


def _gnn_step(dev, shape):
    """One reduced GraphSAGE cell step from a fixed state and batch."""
    from repro_torch.launch.steps import (REDUCED_SHAPES, build_cell,
                                          minibatch_budgets)
    from repro_torch.models.gnn import sage_init
    from repro_torch.train.optimizer import AdamWConfig, adamw_init

    arch = get_arch("graphsage-reddit")
    kind = arch.shape(shape).kind
    sp = REDUCED_SHAPES[kind]
    cfg = dataclasses.replace(arch.model_cfg(True), d_in=sp["d_feat"],
                              n_classes=sp["n_classes"])
    params = _tree_to(sage_init(cfg, seed=0, device="cpu"), dev)
    rng = np.random.default_rng(5)

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(dev)

    if kind == "train_graph":
        n, e = sp["n_nodes"], sp["n_edges"]
        feats = rng.normal(size=(n, sp["d_feat"])).astype(np.float32)
        batch = (feats, rng.integers(0, n, (2, e)).astype(np.int32),
                 np.argmax(feats[:, :sp["n_classes"]], 1).astype(np.int32),
                 np.ones(n, np.float32))
    else:
        e1, fr1, e0, fr0 = minibatch_budgets(sp["batch_nodes"], sp["fanout"])
        feats = rng.normal(size=(fr0, sp["d_feat"])).astype(np.float32)
        bn = sp["batch_nodes"]
        batch = (feats, rng.integers(0, fr0 + 1, e0).astype(np.int32),
                 rng.integers(0, fr1 + 1, e0).astype(np.int32),
                 rng.integers(0, fr1 + 1, e1).astype(np.int32),
                 rng.integers(0, bn + 1, e1).astype(np.int32),
                 np.argmax(feats[:bn, :sp["n_classes"]], 1).astype(np.int32))
    opt = adamw_init(params, AdamWConfig(lr=1e-3))
    cell = build_cell("graphsage-reddit", shape, reduced=True)
    return cell.fn(params, opt, *[t(b) for b in batch])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["ogb_products", "minibatch_lg"])
def test_cuda_gnn_train_step_matches_cpu_and_reruns_bit_equal(cuda, shape):
    """A reduced GraphSAGE step on the card (3 gather launches: two
    forwards, the hidden layer's backward) against the CPU: the loss and
    every leaf within 1e-4 relative L2 (float32 GEMMs in another order);
    two card steps give the same bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels.segment_gather import SEGMENT_GATHER_KERNEL
    from repro_torch.train.tree import tree_leaves

    cpu = _gnn_step(torch.device("cpu"), shape)
    before = SEGMENT_GATHER_KERNEL.launches
    gpu = _gnn_step(cuda, shape)
    torch.cuda.synchronize()
    assert SEGMENT_GATHER_KERNEL.launches == before + 3
    again = _gnn_step(cuda, shape)
    torch.testing.assert_close(gpu[2].cpu(), cpu[2], atol=1e-4, rtol=1e-4)
    assert torch.equal(gpu[2], again[2])
    for a, b, c in zip(tree_leaves(gpu[:2]), tree_leaves(cpu[:2]),
                       tree_leaves(again[:2])):
        assert _rel_l2(a.cpu(), b) <= 1e-4
        assert torch.equal(a, c)


@pytest.mark.gpu
def test_cuda_websearch_serve_cell_matches_cpu(cuda):
    """The reduced websearch serve cell on the card (block_scan: chunk
    launches) gives the CPU's cand, u and cand_cnt bit for bit."""
    from repro_torch.core.state_bins import StateBins
    from repro_torch.launch.steps import build_cell

    wcfg = get_arch("websearch-rl").model_cfg(True)
    rng = np.random.default_rng(6)
    b, w = 8, wcfg.block_docs // 32
    occ = (rng.integers(0, 2**32, (b, wcfg.n_blocks, T, F, w), dtype=np.uint32)
           & rng.integers(0, 2**32, (b, wcfg.n_blocks, T, F, w), dtype=np.uint32))
    tp = np.arange(T)[None] < rng.integers(2, 5, b)[:, None]
    scores = rng.normal(size=(b, wcfg.n_blocks * wcfg.block_docs)).astype(np.float32)
    q = rng.normal(scale=0.05, size=(wcfg.p_bins, wcfg.k_rules + 2)).astype(np.float32)
    q[:, wcfg.k_rules:] -= 0.1
    pu = int(np.sqrt(wcfg.p_bins))
    ue = np.geomspace(2, wcfg.u_budget, pu - 1).astype(np.float32)
    ve = np.tile(np.geomspace(1, 4096, wcfg.p_bins // pu - 1), (pu, 1)).astype(np.float32)
    cell = build_cell("websearch-rl", "serve_queries", reduced=True)

    def run(dev):
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return [x.cpu() for x in cell.fn(t(q), StateBins(t(ue), t(ve)),
                                         t(occ.view(np.int32)), t(scores), t(tp))]

    want = run(torch.device("cpu"))
    before = BLOCK_SCAN_RULE_KERNEL.launches
    got = run(cuda)
    assert BLOCK_SCAN_RULE_KERNEL.launches > before
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


# ------------------------------------------- one rule execution a launch
_STATE_FIELDS = ("block_ptr", "u", "v", "matched", "cand", "cand_cnt", "topn",
                 "done")


def _rule_cases():
    """The rule kernel's cases: ``tests/test_torch_block_scan_rule.py``'s
    (each stop of §3, per-lane rules, a midway state, K and top-n edges,
    32 and 64 planes) and ``tests/test_torch_scan_backends.py``'s (its
    six rules over B=4, 8 blocks of 64 docs, a midway state, the u
    budget, per-lane rules), built on the CPU."""
    from test_torch_block_scan_rule import CASES, _base, _per_lane

    cases = dict(CASES)
    for w in (2, 8, 33, 256):
        cases[f"w{w}"] = (lambda w=w: _base(20 + w, w=w, du=40, dv=w * 40,
                                            ands=3))
    planes = [(t, f) for t in range(T) for f in range(F)]
    rules = {"shallow_2plane": ([(0, 1), (0, 3)], [0], 1000, 10**6),
             "deep_full": (planes, range(T), 1000, 10**6),
             "mid_chunk_du": (planes, range(T), 40, 10**6),
             "mid_chunk_dv": (planes, range(T), 1000, 150),
             "no_required": (planes[:4], [], 1000, 10**6),
             "zero_active": ([], [0], 1000, 10**6)}
    for name, (pl, req, du, dv) in rules.items():
        cases[f"scan_backends_{name}"] = (
            lambda pl=pl, req=req, du=du, dv=dv: _base(
                7, b=4, nb=8, w=2, k=48, planes=pl, req=req, du=du, dv=dv))
    cases["scan_backends_u_budget"] = lambda: _base(7, b=4, nb=8, w=2, k=48,
                                                    u_budget=40)
    cases["scan_backends_per_lane"] = lambda: _per_lane(7)
    return cases


_RULE_CASES = _rule_cases()


def _on(c, dev):
    """A rule case with every tensor on ``dev``."""
    from repro_torch.core.environment import EnvState

    moved = {f.name: getattr(c, f.name) for f in dataclasses.fields(c)}
    for k, v in moved.items():
        if isinstance(v, torch.Tensor):
            moved[k] = v.to(dev)
    moved["state"] = EnvState(*(getattr(c.state, f).to(dev)
                                for f in _STATE_FIELDS))
    return type(c)(**moved)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(_RULE_CASES))
def test_cuda_run_rule_kernel_matches_cpu_host_loop(cuda, case):
    """``BlockScanBackend.run_rule`` on CUDA tensors (one launch of the
    rule kernel) equals the host loop on CPU tensors, every EnvState
    field bit for bit; exactly one launch of the rule kernel, none of
    the chunk kernel and no host sync; the caller's state is left as it was unless it
    is given up (``inplace``), and then its matched is the result's."""
    from test_torch_block_scan_rule import _host_loop

    from repro_torch.obs import host_syncs

    c = _RULE_CASES[case]()
    want = _host_loop(c)
    g = _on(c, cuda)
    args = (g.cfg, g.occ, g.scores, g.tp, g.state, g.allowed, g.required,
            g.du, g.dv)
    kept = {f: getattr(g.state, f).clone() for f in _STATE_FIELDS}
    torch.cuda.synchronize()
    before = (BLOCK_SCAN_RULE_KERNEL.launches, BLOCK_SCAN_KERNEL.launches,
              host_syncs())
    got = BlockScanBackend().run_rule(*args)
    assert (BLOCK_SCAN_RULE_KERNEL.launches, BLOCK_SCAN_KERNEL.launches,
            host_syncs()) == (before[0] + 1, before[1], before[2])
    torch.cuda.synchronize()
    for f in _STATE_FIELDS:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
        assert torch.equal(getattr(g.state, f), kept[f]), f
    again = BlockScanBackend().run_rule(*args, inplace=True)
    assert again.matched is g.state.matched
    for f in _STATE_FIELDS:
        assert torch.equal(getattr(again, f).cpu(), getattr(want, f)), f


@pytest.mark.gpu
def test_cuda_rule_kernel_scalar_path_and_trace(cuda):
    """The rule kernel on its scalar path (matched one word off 16-byte
    alignment) equals the host loop; under a tracer the rule execution
    is one ``rule`` span with ``route="kernel"`` and no child."""
    from test_torch_block_scan_rule import _host_loop

    from repro_torch.core.environment import EnvState
    from repro_torch.obs import Tracer, tracing

    c = _RULE_CASES["midway_matched_bits_set"]()
    want = _host_loop(c)
    g = _on(c, cuda)
    state = EnvState(*(_at_offset(x, 1) if f == "matched" else x
                       for f, x in zip(_STATE_FIELDS,
                                       (getattr(g.state, f)
                                        for f in _STATE_FIELDS))))
    tracer = Tracer()
    with tracing(tracer):
        got = BlockScanBackend().run_rule(g.cfg, g.occ, g.scores, g.tp, state,
                                          g.allowed, g.required, g.du, g.dv,
                                          inplace=True)
    torch.cuda.synchronize()
    for f in _STATE_FIELDS:
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    spans = tracer.log.snapshot()
    assert [e["name"] for e in spans] == ["rule"]
    assert spans[0]["args"]["route"] == "kernel"


def _rollout_setup(dev):
    """test_torch_scan_backends.py's rollout inputs (B=4, 8 blocks of 64
    docs), its rule library at du x2, dv x8, state bins and a seeded
    random Q, on ``dev``."""
    from repro_torch.core.match_rules import default_rule_library
    from repro_torch.core.state_bins import fit_bins

    b, nb, d = 4, 8, 64
    rng = np.random.default_rng(7)
    occ = (rng.integers(0, 2**32, (b, nb, T, F, d // 32), dtype=np.uint32)
           & rng.integers(0, 2**32, (b, nb, T, F, d // 32), dtype=np.uint32))
    scores = rng.normal(size=(b, nb * d)).astype(np.float32)
    cfg = EnvConfig(n_blocks=nb, block_docs=d, k_rules=6, max_candidates=48,
                    n_top=5, u_budget=4096)
    bins = fit_bins(np.linspace(0, 200, 64), np.linspace(0, 4000, 64), p=16,
                    device=dev)
    q = torch.from_numpy(np.random.default_rng(11).normal(
        size=(16, cfg.n_actions)).astype(np.float32)).to(dev)
    return (cfg, default_rule_library(2, 8, device=dev), bins, q,
            torch.from_numpy(occ.view(np.int32)).to(dev),
            torch.from_numpy(scores).to(dev),
            torch.ones((b, T), dtype=torch.bool, device=dev))


def _assert_trees_equal(got, want):
    """States and integer tensors bit for bit; a float tensor (a reward,
    a top-n sum, Q, a metric) is a sum that the card reduces in another
    order than the CPU, so within test_cuda_training_step_and_policy's
    1e-6."""
    if isinstance(want, dict):
        for k in want:
            _assert_trees_equal(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        for g_, w_ in zip(got, want, strict=True):
            _assert_trees_equal(g_, w_)
    elif isinstance(want, torch.Tensor) and want.is_floating_point():
        torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)
    elif isinstance(want, torch.Tensor):
        assert torch.equal(got.cpu(), want), (got, want)
    else:
        for f in _STATE_FIELDS:
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["greedy_tabular", "epsilon_train_batch",
                                   "static_plan_reset_and_quotas"])
def test_cuda_rollouts_through_the_rule_kernel_equal_cpu(cuda, which):
    """Whole rollouts whose states the rollout owns (matched updated in
    place on the card): a greedy tabular rollout, an ε-greedy
    ``train_batch`` (its new Q and metrics) and a static plan with a
    reset-before entry and per-entry quota overrides, on the card equal
    to the CPU's, with a rule-kernel launch and no chunk-kernel launch
    per rule execution."""
    from repro_torch.core.match_plan import production_plans
    from repro_torch.core.qlearning import QConfig, train_batch
    from repro_torch.core.rollout import unified_rollout
    from repro_torch.policies import StaticPlanPolicy, TabularQPolicy

    def run(dev):
        cfg, rules, bins, q, occ, scores, tp = _rollout_setup(dev)
        if which == "greedy_tabular":
            r = unified_rollout(cfg, rules, bins, TabularQPolicy(q), 6, occ,
                                scores, tp, backend="block_scan")
            return r.final_state, r.transitions, r.trajectory
        if which == "epsilon_train_batch":
            qcfg = QConfig(p=16, n_actions=cfg.n_actions, t_max=6)
            gen = torch.Generator().manual_seed(3)
            draws = (torch.randint(0, cfg.n_actions, (6, 4), generator=gen,
                                   dtype=torch.int32).to(dev),
                     torch.rand((6, 4), generator=gen).to(dev))
            prod = torch.zeros((4, 6), device=dev)
            return train_batch(cfg, qcfg, rules, bins, q, occ, scores, tp,
                               prod, 0.3, draws, backend="block_scan")
        plan = production_plans(rules)["CAT1"]
        plan = dataclasses.replace(
            plan, du_quota=plan.du_quota * 3 // 2,
            dv_quota=torch.where(torch.arange(plan.length, device=dev) % 2 == 0,
                                 plan.dv_quota // 4, plan.dv_quota))
        assert bool(plan.reset_before.any())
        r = unified_rollout(cfg, rules, None,
                            StaticPlanPolicy(plan, cfg.n_actions), plan.length,
                            occ, scores, tp, backend="block_scan")
        return r.final_state, r.transitions, r.trajectory

    want = run(torch.device("cpu"))
    before = (BLOCK_SCAN_RULE_KERNEL.launches, BLOCK_SCAN_KERNEL.launches)
    got = run(cuda)
    torch.cuda.synchronize()
    assert BLOCK_SCAN_RULE_KERNEL.launches > before[0]
    assert BLOCK_SCAN_KERNEL.launches == before[1]
    _assert_trees_equal(got, want)


@pytest.mark.gpu
def test_cuda_execute_rule_and_env_step_leave_the_callers_state(cuda):
    """``execute_rule``, ``env_step`` and ``policy_env_step`` called
    directly keep value semantics on the card: the state they were given
    is unchanged, matched included, and the result is the CPU's."""
    from repro_torch.core import (default_rule_library, env_step,
                                  execute_rule)
    from repro_torch.core.rollout import PolicyAction, policy_env_step

    cfg, rules, _, _, occ, scores, tp = _rollout_setup(cuda)
    first = env_step(cfg, rules, occ[0], scores[0], tp[0],
                     env_reset(cfg, device=cuda), 0)
    assert int(first.cand_cnt) > 0
    kept = {f: getattr(first, f).clone() for f in _STATE_FIELDS}
    outs = [execute_rule(cfg, occ[0], scores[0], tp[0], first,
                         *rules.gather(torch.tensor(2, device=cuda))),
            env_step(cfg, rules, occ[0], scores[0], tp[0], first, 3)]
    batch = env_reset(cfg, 4, cuda)
    batch = policy_env_step(cfg, rules, occ, scores, tp, batch,
                            PolicyAction.plain(torch.zeros(4, dtype=torch.int32,
                                                           device=cuda)),
                            "block_scan")
    kept_b = {f: getattr(batch, f).clone() for f in _STATE_FIELDS}
    outs.append(policy_env_step(cfg, rules, occ, scores, tp, batch,
                                PolicyAction.plain(torch.full(
                                    (4,), 3, dtype=torch.int32, device=cuda)),
                                "block_scan"))
    torch.cuda.synchronize()
    for f in _STATE_FIELDS:
        assert torch.equal(getattr(first, f), kept[f]), f
        assert torch.equal(getattr(batch, f), kept_b[f]), f
    cpu = _rollout_setup(torch.device("cpu"))
    cfg_c, rules_c, _, _, occ_c, scores_c, tp_c = cpu
    first_c = env_step(cfg_c, rules_c, occ_c[0], scores_c[0], tp_c[0],
                       env_reset(cfg_c, device="cpu"), 0)
    batch_c = policy_env_step(
        cfg_c, rules_c, occ_c, scores_c, tp_c, env_reset(cfg_c, 4, "cpu"),
        PolicyAction.plain(torch.zeros(4, dtype=torch.int32)), "block_scan")
    wants = [execute_rule(cfg_c, occ_c[0], scores_c[0], tp_c[0], first_c,
                          *rules_c.gather(torch.tensor(2))),
             env_step(cfg_c, rules_c, occ_c[0], scores_c[0], tp_c[0],
                      first_c, 3),
             policy_env_step(cfg_c, rules_c, occ_c, scores_c, tp_c, batch_c,
                             PolicyAction.plain(torch.full(
                                 (4,), 3, dtype=torch.int32)), "block_scan")]
    for got, want in zip(outs, wants):
        _assert_trees_equal(got, want)


# ------------------------------------------------------------- the mesh
@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A one-rank NCCL world (a ``FileStore`` rendezvous) and its 1 x 1
    ``make_local_mesh`` on the card; at world size 1 every collective is
    an identity."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    store = dist.FileStore(str(tmp_path_factory.mktemp("nccl") / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        yield make_local_mesh(1, 1)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["serve_queries", "rl_rollout"])
def test_cuda_mesh_websearch_equals_unsharded(nccl_mesh, shape):
    """The sharded websearch cells on a one-rank NCCL mesh give the
    unsharded cells' outputs bit for bit, through the chunk kernel."""
    from repro_torch.core.state_bins import StateBins
    from repro_torch.distributed import place_tree
    from repro_torch.launch.steps import build_cell

    wcfg = get_arch("websearch-rl").model_cfg(True)
    rng = np.random.default_rng(7)
    b, w = 8, wcfg.block_docs // 32
    occ = (rng.integers(0, 2**32, (b, wcfg.n_blocks, T, F, w), dtype=np.uint32)
           & rng.integers(0, 2**32, (b, wcfg.n_blocks, T, F, w), dtype=np.uint32))
    tp = np.arange(T)[None] < rng.integers(2, 5, b)[:, None]
    scores = rng.normal(size=(b, wcfg.n_blocks * wcfg.block_docs)).astype(np.float32)
    q = rng.normal(scale=0.05, size=(wcfg.p_bins, wcfg.k_rules + 2)).astype(np.float32)
    q[:, wcfg.k_rules:] -= 0.1
    pu = int(np.sqrt(wcfg.p_bins))
    ue = np.geomspace(2, wcfg.u_budget, pu - 1).astype(np.float32)
    ve = np.tile(np.geomspace(1, 4096, wcfg.p_bins // pu - 1), (pu, 1)).astype(np.float32)
    prod_r = rng.normal(scale=0.1, size=(b, wcfg.t_max)).astype(np.float32)
    draws = (rng.integers(0, wcfg.k_rules + 2, (wcfg.t_max, b)).astype(np.int32),
             rng.random((wcfg.t_max, b)).astype(np.float32))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    args = [t(q), StateBins(t(ue), t(ve)), t(occ.view(np.int32)), t(scores), t(tp)]
    if shape == "rl_rollout":
        args += [t(prod_r), tuple(t(d) for d in draws)]
    want = build_cell("websearch-rl", shape, reduced=True).fn(*args)
    cell = build_cell("websearch-rl", shape, mesh=nccl_mesh, reduced=True)
    placed = args[:2] + [place_tree(a, s) for a, s in
                         zip(args[2:5], cell.in_shardings[2:5])] + args[5:]
    before = BLOCK_SCAN_RULE_KERNEL.launches
    got = cell.fn(*placed)
    assert BLOCK_SCAN_RULE_KERNEL.launches > before
    if shape == "rl_rollout":
        got = [got[0]] + [got[1][k] for k in sorted(got[1])]
        want = [want[0]] + [want[1][k] for k in sorted(want[1])]
    for g, w_ in zip(got, want):
        assert torch.equal(g.full_tensor(), w_)


@pytest.mark.gpu
def test_cuda_mesh_bag_launches_the_kernel(nccl_mesh):
    """The sharded bag sum and the sharded Wide&Deep forward on a
    one-rank NCCL mesh launch the bag kernel (no plain gather-sum) and
    equal the unsharded ones."""
    from repro_torch.distributed import place_tree, sharded_bag_sum
    from repro_torch.launch.steps import build_cell

    rng = np.random.default_rng(8)
    table = torch.from_numpy(rng.normal(size=(4096, 1)).astype(np.float32)).cuda()
    idx = torch.from_numpy(rng.integers(-1, 4096, (64, 40)).astype(np.int32)).cuda()
    kernels = (EMBEDDING_BAG_KERNEL, EMBEDDING_BAG_LANES_KERNEL)
    before = sum(k.launches for k in kernels)
    got = sharded_bag_sum(table, idx, nccl_mesh).full_tensor()
    assert sum(k.launches for k in kernels) == before + 1
    assert torch.equal(got, embedding_bag(table, idx, mode="sum"))

    cfg = get_arch("wide-deep").model_cfg(True)
    params = recsys.wide_deep_init(cfg, seed=2)
    sparse = torch.from_numpy(rng.integers(0, cfg.vocab_per_field, (32, cfg.n_sparse))
                              .astype(np.int32)).cuda()
    dense = torch.from_numpy(rng.normal(size=(32, 1)).astype(np.float32)).cuda()
    want = build_cell("wide-deep", "serve_p99", reduced=True).fn(params, sparse, dense)
    cell = build_cell("wide-deep", "serve_p99", mesh=nccl_mesh, reduced=True)
    before = sum(k.launches for k in kernels)
    got = cell.fn(place_tree(params, cell.in_shardings[0]), sparse, dense)
    assert sum(k.launches for k in kernels) == before + 1
    torch.testing.assert_close(got.full_tensor(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_cuda_mesh_moe_ffn_sharded_equals_moe_ffn(nccl_mesh):
    from repro_torch.models.moe import MoEConfig, moe_ffn, moe_ffn_sharded

    cfg = MoEConfig(n_experts=8, top_k=2, d_model=64, d_ff=128, n_shared=1)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    params = moe_init(gen, cfg)
    x = torch.randn((64, 64), generator=gen, device="cuda")
    want, _ = moe_ffn(params, x, cfg)
    got, _ = moe_ffn_sharded(params, x, cfg, nccl_mesh)
    torch.testing.assert_close(got.full_tensor(), want, rtol=1e-5, atol=1e-5)


# ------------------------------------------- the sequence-sharded decode
DECODE_ROUTES = {       # name -> (dtype, head dim, the kernel its route takes)
    "bf16_d128": (torch.bfloat16, 128, "tc"),
    "fp32_d128": (torch.float32, 128, "core"),
}


def _decode_qkv(seed, dtype, d, b=4, hq=16, hkv=4, s=512):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    q = torch.randn((b, hq, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(dtype)
    return q, k, v


@pytest.mark.gpu
@pytest.mark.parametrize("route", list(DECODE_ROUTES))
def test_cuda_decode_float32_partial(cuda, route):
    """``partial_f32``: the kernel's unnormalised accumulator in float32,
    unrounded: rounded to q's dtype it is the ``return_partial``
    accumulator bit for bit, m and l are the same, and it matches the
    plain version's float32 accumulator."""
    dtype, d, which = DECODE_ROUTES[route]
    q, k, v = _decode_qkv(11, dtype, d)
    lens = torch.tensor([512, 300, 1, 0], dtype=torch.int32, device="cuda")
    kernel = DECODE_ATTENTION_TC_KERNEL if which == "tc" else DECODE_ATTENTION_KERNEL
    before = kernel.launches
    acc32, m32, l32 = decode_attention(q, k, v, kv_len=lens, return_partial=True,
                                       partial_f32=True)
    acc, m, l = decode_attention(q, k, v, kv_len=lens, return_partial=True)
    assert kernel.launches == before + 2
    assert acc32.dtype == torch.float32 and acc.dtype == dtype
    assert torch.equal(acc32.to(dtype), acc)
    assert torch.equal(m32, m) and torch.equal(l32, l)
    want, wm, wl = decode_attention_ref(q.cpu(), k.cpu(), v.cpu(), kv_len=lens.cpu(),
                                        return_partial=True, partial_f32=True)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(acc32.cpu(), want, rtol=tol, atol=tol * float(
        wl.max()))
    assert bool(torch.isneginf(m32[3]).all()) and bool((l32[3] == 0).all())
    assert bool((acc32[3] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("route", list(DECODE_ROUTES))
def test_cuda_sequence_sharded_decode_merge(cuda, route):
    """A cache cut into 4 key slices, as ``kv_cache_specs`` lays it over a
    4-way ``model`` axis: each slice's float32 partial from the kernel,
    with per-row lengths clamp(len - offset, 0, S/4), merged in slice
    order by ``merge_partials``, equals the kernel over the whole cache.
    Rows of length 5 and 0 leave slices with no valid key: those give
    m = -inf and l = 0, and the merge weights them 0."""
    dtype, d, which = DECODE_ROUTES[route]
    q, k, v = _decode_qkv(12, dtype, d)
    s, n = k.shape[2], 4
    s_loc = s // n
    lens = torch.tensor([512, 300, 5, 0], dtype=torch.int64, device="cuda")
    want, _, _ = decode_attention(q, k, v, kv_len=lens)
    parts = []
    for r in range(n):
        kv_len = (lens - r * s_loc).clamp(0, s_loc)
        parts.append(decode_attention(
            q, k[:, :, r * s_loc:(r + 1) * s_loc], v[:, :, r * s_loc:(r + 1) * s_loc],
            kv_len=kv_len, return_partial=True, partial_f32=True))
        empty = kv_len == 0
        assert bool(torch.isneginf(parts[-1][1][empty]).all())
        assert bool((parts[-1][2][empty] == 0).all())
    assert any(bool((lens - r * s_loc <= 0).any()) for r in range(n))
    got = merge_partials(*(list(x) for x in zip(*parts)))
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.to(dtype).float(), want.float(), rtol=tol,
                               atol=tol)
    assert bool((got[3] == 0).all())          # no key anywhere: 0, not NaN


@pytest.mark.gpu
@pytest.mark.parametrize("route", list(DECODE_ROUTES))
def test_cuda_mesh_sequence_sharded_decode(nccl_mesh, route):
    """The sequence-sharded decode on a one-rank NCCL mesh
    (``gqa_decode_tp`` through the decode kernel, its float32 partial
    merged) against ``gqa_decode`` with the kernel on the same cache:
    within the route's tolerance, one decode launch each; the rows
    written alike."""
    from repro_torch.models.attention import (AttnConfig, HeadSplit, gqa_decode,
                                              gqa_decode_tp, gqa_init)

    dtype, d, which = DECODE_ROUTES[route]
    cfg = AttnConfig(d_model=256, n_heads=8, n_kv=2, d_head=d, use_flash=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    params = gqa_init(gen, cfg, dtype=dtype)
    x = torch.randn((3, 256), generator=gen, device="cuda").to(dtype)
    cache = {f: torch.randn((3, 256, 2, d), generator=gen, device="cuda").to(dtype)
             for f in ("k", "v")}
    pos = torch.tensor([0, 100, 255], device="cuda")
    mine = {f: c.clone() for f, c in cache.items()}
    want, _ = gqa_decode(params, x, cache, pos, cfg)
    kernel = DECODE_ATTENTION_TC_KERNEL if which == "tc" else DECODE_ATTENTION_KERNEL
    before = kernel.launches
    split = HeadSplit(nccl_mesh, "model", 1, 0)
    got = gqa_decode_tp(params, x, mine, pos, cfg, split)
    assert kernel.launches == before + 1
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    for f in cache:
        assert torch.equal(mine[f], cache[f])


@pytest.mark.gpu
def test_cuda_mesh_lm_and_gnn_cells_launch_their_kernels(nccl_mesh):
    """The sharded LM prefill and decode cells (reduced mistral-nemo-12b,
    float32 at D 32 with ``use_flash``: the CUDA-core routes) and the
    edge-sharded GNN step on a one-rank NCCL mesh launch the flash,
    decode and segment-gather kernels and equal the unsharded cells."""
    from repro_torch.distributed import place_tree
    from repro_torch.kernels.segment_gather import SEGMENT_GATHER_KERNEL
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.gnn import sage_init
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.tree import tree_leaves

    cfg = dataclasses.replace(get_arch("mistral-nemo-12b").model_cfg(True),
                              use_flash=True)
    params = init_params(cfg, seed=4, device="cuda")
    tokens = torch.randint(0, cfg.vocab, (2, 64), device="cuda")
    want, _ = prefill(params, tokens, cfg)
    cell = build_cell("mistral-nemo-12b", "prefill_32k", mesh=nccl_mesh,
                      reduced=True, cfg_override=cfg)
    s_params = place_tree(params, cell.in_shardings[0])
    before = FLASH_ATTENTION_KERNEL.launches
    logits, cache = cell.fn(s_params, tokens)
    assert FLASH_ATTENTION_KERNEL.launches == before + cfg.n_layers
    torch.testing.assert_close(logits.full_tensor(), want, rtol=2e-5, atol=2e-5)
    dec = build_cell("mistral-nemo-12b", "decode_32k", mesh=nccl_mesh,
                     reduced=True, cfg_override=cfg)
    before = DECODE_ATTENTION_KERNEL.launches
    pos = torch.full((2,), 63, device="cuda")
    out, _ = dec.fn(s_params, tokens[:, -1], cache, pos)
    assert DECODE_ATTENTION_KERNEL.launches == before + cfg.n_layers
    assert out.full_tensor().shape == (2, cfg.vocab)

    gcfg = get_arch("graphsage-reddit").model_cfg(True)
    cell = build_cell("graphsage-reddit", "full_graph_sm", reduced=True)
    s_cell = build_cell("graphsage-reddit", "full_graph_sm", mesh=nccl_mesh,
                        reduced=True)
    rng = np.random.default_rng(9)
    batch = [torch.from_numpy(a).cuda() for a in (
        rng.normal(size=(128, 16)).astype(np.float32),
        rng.integers(0, 128, (2, 512)).astype(np.int32),
        rng.integers(0, 7, 128).astype(np.int32), np.ones(128, np.float32))]
    p = sage_init(dataclasses.replace(gcfg, d_in=16), seed=1, device="cuda")
    opt = adamw_init(p, AdamWConfig(lr=1e-3))
    s_p, s_o = (place_tree(t, s) for t, s in zip((p, opt), s_cell.in_shardings))
    want = cell.fn(p, opt, *batch)
    before = SEGMENT_GATHER_KERNEL.launches
    got = s_cell.fn(s_p, s_o, *batch)
    assert SEGMENT_GATHER_KERNEL.launches == before + 3
    for a, b in zip(tree_leaves(got[:2]), tree_leaves(want[:2])):
        torch.testing.assert_close(a.full_tensor(), b, rtol=1e-4, atol=1e-5)


# --------------------------------------------- the dry run's costs
from test_torch_dryrun import count_call, native_kernel, wrapper_cases  # noqa: E402


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(wrapper_cases()))
def test_cuda_wrapper_cost_equals_meta_cost(cuda, case):
    """One launch of each kernel route on the card, under the dry run's
    counters: the cost it reports equals the one the same call reports
    on meta (shapes chosen so that a data-dependent cost meets its worst
    case), its launch count rises by one (on meta it does not move), and
    the outputs have the meta call's shapes and dtypes."""
    name, make = wrapper_cases()[case]
    kernel = native_kernel(name)
    before = kernel.launches
    meta_out, meta_k = count_call(make("meta"))
    assert kernel.launches == before
    out, got = count_call(make(cuda))
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert [(t.shape, t.dtype) for t in out] == [(t.shape, t.dtype)
                                                 for t in meta_out]
    assert list(got) == [name] and got[name]["launches"] == 1
    assert (got[name]["flops"], got[name]["bytes"]) == (
        meta_k[name]["flops"], meta_k[name]["bytes"])
    assert not got[name]["worst_case"]


@pytest.mark.gpu
def test_cuda_calibration_matmul_counts(cuda):
    """A bf16 8192^3 matmul counts 2 x 8192^3 FLOPs and 3 x 8192^2 x 2
    bytes on the card and on meta alike."""
    from repro_torch.launch.dryrun import counting

    n = 8192
    a = torch.randn((n, n), device=cuda, dtype=torch.bfloat16)
    b = torch.randn((n, n), device=cuda, dtype=torch.bfloat16)
    for x, y in ((a, b), (a.to("meta"), b.to("meta"))):
        with counting((x, y)) as c:
            torch.matmul(x, y)
        assert (c.flops, c.bytes) == (2 * n ** 3, 3 * n * n * 2), x.device
