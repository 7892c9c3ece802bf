"""One rule execution in one launch: the ``"block_scan"`` backend's route
on the card.

``block_scan_rule`` takes every lane of a batch from its entry state to
the state at which its stopping condition (paper §3) fails, as the
backend's host loop over ``block_scan_pruned_chunk`` does, bit for bit.
On CUDA tensors it launches the hand-written kernel
``csrc/block_scan_rule.cu`` (a CTA a lane, a round of 8 blocks a warp
each on the block scans' warp core, the lane's loop on the card: no
value goes to the host); on ``meta`` tensors it returns the outputs'
shapes and computes nothing.  Its plain version, the backend's host
loop (``BlockScanBackend.host_loop``), is the CPU's route.  Every call
reports ``rule_cost`` to an active dry-run counter
(``kernels/cost.py``), at its worst case: how far Δv lets a lane scan,
and how many documents are new, are known only once it has run.

The kernel ORs the scanned blocks' new bits into ``matched`` where it
lies: with ``inplace`` the caller's ``state.matched`` (a state the
caller owns), else a copy made once per call.  The other fields are new
tensors.  Words are int32 tensors with the bits of the reference's
uint32.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.environment import EnvConfig, EnvState
from repro_torch.kernels.cost import KernelCost, run
from repro_torch.kernels.native import NativeKernel, csrc_define

from .block_scan import MAX_TERMS, MAX_WORDS

__all__ = ["BLOCK_SCAN_RULE_KERNEL", "block_scan_rule", "rule_cost",
           "RULE_MAX_PLANES"]

RULE_MAX_PLANES = csrc_define("block_scan_rule.cuh", "BS_RULE_MAX_PLANES")

_P, _I = ctypes.c_void_p, ctypes.c_int
BLOCK_SCAN_RULE_KERNEL = NativeKernel(
    name="block_scan_pruned_chunk_rule",
    source="block_scan_rule.cu",
    headers=("block_scan.cuh", "block_scan_warp.cuh", "block_scan_rule.cuh"),
    symbol="block_scan_pruned_chunk_rule_launch",
    argtypes=[_P] * 18 + [_I] * 6 + [ctypes.c_longlong] + [_I] * 3 + [_P],
)


def _check(cfg: EnvConfig, occ, scores, term_present, state: EnvState,
           allowed, required, du_quota, dv_quota):
    if occ.dim() != 5 or occ.dtype != torch.int32:
        raise ValueError(f"occ must be (B, nb, T, F, W) int32, got "
                         f"{tuple(occ.shape)} {occ.dtype}")
    b, nb, t, f, w = occ.shape
    if w != cfg.words_per_block or cfg.block_docs != 32 * w:
        raise ValueError(f"occ has W={w}; block_docs={cfg.block_docs} "
                         f"needs {cfg.block_docs // 32} words of 32 docs")
    if not (1 <= t <= MAX_TERMS) or t * f > RULE_MAX_PLANES \
            or not (1 <= w <= MAX_WORDS) or nb < 1 or b < 1:
        raise ValueError(f"unsupported shape B={b} nb={nb} T={t} F={f} W={w} "
                         f"(T <= {MAX_TERMS}, T*F <= {RULE_MAX_PLANES}, "
                         f"W <= {MAX_WORDS})")
    if cfg.n_top < 1:
        raise ValueError(f"n_top={cfg.n_top}: the kernel keeps at least 1")
    if scores.dtype != torch.float32 or scores.dim() != 2 \
            or scores.shape[0] != b or scores.shape[1] < 1 \
            or scores.device != occ.device:
        raise ValueError(f"scores must be (B, n_pad) float32 on {occ.device}, "
                         f"got {tuple(scores.shape)} {scores.dtype} on "
                         f"{scores.device}")
    want = {"term_present": (term_present, torch.bool, (b, t)),
            "allowed": (allowed, torch.bool, (b, t, f)),
            "required": (required, torch.bool, (b, t)),
            "du_quota": (du_quota, torch.int32, (b,)),
            "dv_quota": (dv_quota, torch.int32, (b,)),
            "block_ptr": (state.block_ptr, torch.int32, (b,)),
            "u": (state.u, torch.int32, (b,)),
            "v": (state.v, torch.int32, (b,)),
            "matched": (state.matched, torch.int32, (b, nb * w)),
            "cand": (state.cand, torch.int32, (b, cfg.max_candidates)),
            "cand_cnt": (state.cand_cnt, torch.int32, (b,)),
            "topn": (state.topn, torch.float32, (b, cfg.n_top)),
            "done": (state.done, torch.bool, (b,))}
    for name, (x, dtype, shape) in want.items():
        if x.dtype != dtype or tuple(x.shape) != shape or x.device != occ.device:
            raise ValueError(f"{name} must be {shape} {dtype} on {occ.device}, "
                             f"got {tuple(x.shape)} {x.dtype} on {x.device}")


def block_scan_rule(cfg: EnvConfig, occ, scores, term_present,
                    state: EnvState, allowed, required, du_quota, dv_quota,
                    *, inplace: bool = False) -> EnvState:
    """Run each lane's rule until its stopping condition fails.

    The arguments are ``ScanBackend.run_rule``'s: occ (B, nb, T, F, W)
    int32, scores (B, n_pad) float32, term_present (B, T) bool, a
    batched state, allowed (B, T, F) and required (B, T) bool, du_quota
    and dv_quota (B,) int32, on CUDA or ``meta``.  With ``inplace`` the
    returned state's matched is ``state.matched``, updated."""
    dev = occ.device
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {dev}: the rule kernel runs "
                         f"on CUDA or meta tensors")
    _check(cfg, occ, scores, term_present, state, allowed, required,
           du_quota, dv_quota)
    b, nb, t, f, w = occ.shape

    def call_cost():
        if dev.type == "meta":
            return rule_cost(np.full(b, t * f), np.full(b, nb), nb, t, f, w,
                             cfg.max_candidates, cfg.n_top)
        n_active = (allowed & term_present[:, :, None]).sum((1, 2)).cpu().numpy()
        return rule_cost(n_active, _u_bound_blocks(cfg, nb, state, n_active,
                                                   du_quota, dv_quota),
                         nb, t, f, w, cfg.max_candidates, cfg.n_top)

    return run(BLOCK_SCAN_RULE_KERNEL.name, call_cost, _launch, cfg, occ,
               scores, term_present, state, allowed, required, du_quota,
               dv_quota, inplace)


def _u_bound_blocks(cfg, nb, state, n_active, du_quota, dv_quota):
    """Each lane's blocks as far as Δu, the budget and the index let it
    scan (Δv may stop it sooner): none for a lane whose condition fails
    at entry or that reads no plane."""
    u, bp = state.u.cpu().numpy(), state.block_ptr.cpu().numpy()
    done = state.done.cpu().numpy()
    du, dv = du_quota.cpu().numpy(), dv_quota.cpu().numpy()
    planes = np.maximum(n_active, 1)
    blocks = np.minimum(np.minimum(-(-du // planes),
                                   -(-(cfg.u_budget - u) // planes)), nb - bp)
    live = (du > 0) & (dv > 0) & (bp < nb) & (u < cfg.u_budget) & ~done \
        & (n_active > 0)
    return np.where(live, np.maximum(blocks, 0), 0)


def _launch(cfg, occ, scores, term_present, state, allowed, required,
            du_quota, dv_quota, inplace):
    b, nb, t, f, w = occ.shape
    dev = occ.device
    k, n_top = cfg.max_candidates, cfg.n_top
    matched = state.matched if inplace else state.matched.clone()
    small = torch.empty((4, b), dtype=torch.int32, device=dev)
    cand = torch.empty((b, k), dtype=torch.int32, device=dev)
    topn = torch.empty((b, n_top), dtype=torch.float32, device=dev)
    if dev.type == "cuda":
        ins = [x.contiguous() for x in (
            occ, allowed, required, term_present, scores, du_quota, dv_quota,
            state.block_ptr, state.u, state.v, state.cand_cnt, state.done,
            state.cand, state.topn)]
        if not matched.is_contiguous():
            raise ValueError("matched must be contiguous")
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            BLOCK_SCAN_RULE_KERNEL.launch(
                *(x.data_ptr() for x in ins), matched.data_ptr(),
                small.data_ptr(), cand.data_ptr(), topn.data_ptr(), b, nb,
                t * f, f, w, t, scores.shape[1], k, n_top, cfg.u_budget,
                stream)
    bp, u, v, cnt = small.unbind(0)
    return EnvState(block_ptr=bp, u=u, v=v, matched=matched, cand=cand,
                    cand_cnt=cnt, topn=topn, done=state.done)


def rule_cost(n_active, blocks, nb: int, t: int, f: int, w: int, k: int,
              n_top: int) -> KernelCost:
    """One launch's cost from each lane's active planes and the blocks it
    scans: the rule's bool tensors, the lane's scalars, cand and topn
    read and written once; per block the active planes' words and the
    old matched words read, the matched words written, and every
    document's score read (each new, the worst case); one OR per plane
    word read, per word and term a popcount, an AND and an add, and per
    word the dedup's AND-NOT and OR.  Always the worst case: how far Δv
    lets a lane scan and which documents are new are known only after
    the launch.  The dry run on meta takes every lane at all T·F planes
    over the whole index."""
    n_active = np.asarray(n_active, dtype=np.int64)
    blocks = np.asarray(blocks, dtype=np.int64)
    b = len(blocks)
    plane_words = int((n_active * blocks).sum()) * w
    block_words = int(blocks.sum()) * w
    bytes_moved = (4 * (plane_words + 2 * block_words + block_words * 32
                        + 2 * b * (k + n_top) + b * 10)
                   + b * (t * f + 2 * t + 1))
    ops = plane_words + block_words * (3 * t + 2)
    return KernelCost(flops=ops, bytes=bytes_moved, worst_case=True)
