"""Pluggable index-scan backends: HOW a match rule streams the index.

The rule EXECUTION semantics (paper §3: scan blocks until Δu ≥ du_quota,
Δv ≥ dv_quota, end of index, or episode budget) are fixed; the scan
strategy underneath is a backend.  Names, against the JAX reference
(``repro.core.scan_backends``):

==============  ======================  ==================================
port            reference               how a rule scans
==============  ======================  ==================================
``reference``   ``xla``                 one block per step, each on the
                                        full (T·F, W) tile (``scan_block``)
``block_scan``  ``pallas_block_scan``   on the card, one launch of the
                                        hand-written rule kernel
                                        (``kernels/block_scan``
                                        ``block_scan_rule``); on the CPU
                                        chunks of C blocks a round of a
                                        host loop; only the rule's active
                                        planes read
==============  ======================  ==================================

``block_scan`` splits by device.  On CUDA tensors each lane's whole chunk
loop runs inside one kernel launch: no value goes to the host, and only
the scanned blocks' words of ``matched`` are touched (the launches are
counted by ``BLOCK_SCAN_RULE_KERNEL.launches``); on ``meta`` (a dry run)
the same wrapper reports the launch's worst-case cost.  On the CPU (the
plain version, the tests' bridge to the JAX reference) the loop runs
on the host: each round SPECULATIVELY evaluates C consecutive blocks per
lane through ``block_scan_pruned_chunk``, locates the quota-crossing
block by cumulative sums of the per-block (u_inc, v_inc) increments and
masks every update past it; before each round, and once more after the
last, one device-to-host read tests whether any lane still scans
(``_again``; counted by ``obs.trace.host_sync``).  Both end at the
``reference`` loop's final :class:`EnvState`, bit for bit.

Under an active tracer (``obs.trace.tracing``) a rule execution is a
``rule`` span: on the card with the arg ``route="kernel"`` and no
child; on the host loop with args ``chunk``, ``rounds``, holding a
``chunk`` span per round and a ``sync`` span per read.

A backend's ``run_rule`` is BATCHED: every tensor argument carries a
leading query-batch axis, and lanes never couple (a lane whose stopping
condition fired is masked to a no-op).  With ``inplace`` the caller owns
``state`` (``unified_rollout``'s own states): the rule execution may
write its ``matched`` in place.  Every other field is a new tensor.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.index.blocks import unpack_words
from repro_torch.kernels.block_scan import (META_BP_COL,
                                            block_scan_pruned_chunk,
                                            block_scan_rule, build_rule_meta)
from repro_torch.kernels.cost import note
from repro_torch.obs.trace import host_sync, scope

from .environment import EnvConfig, EnvState
from .match_rules import block_cost, scan_block

__all__ = [
    "ScanBackend", "ReferenceScanBackend", "BlockScanBackend",
    "register_scan_backend", "get_scan_backend", "available_backends",
    "adaptive_chunk_blocks", "DEFAULT_CHUNK_BLOCKS", "MAX_ADAPTIVE_CHUNK",
]

DEFAULT_CHUNK_BLOCKS = 4
MAX_ADAPTIVE_CHUNK = 32


class ScanBackend:
    """Protocol: one rule execution over a BATCH of queries.

    ``run_rule(cfg, occ, scores, term_present, state, allowed, required,
    du_quota, dv_quota, *, inplace=False) -> EnvState`` with occ (B,
    n_blocks, T, F, W) int32, scores (B, n_docs_padded) float32,
    term_present (B, T) bool, a batched :class:`EnvState`, allowed (B, T,
    F) bool, required (B, T) bool, du_quota / dv_quota (B,) int32;
    ``inplace``: the caller owns ``state``, whose ``matched`` the
    backend may then update in place.

    Scan block j iff, with the state BEFORE block j,
    ``u - u0 < du_quota`` ∧ ``v - v0 < dv_quota`` ∧
    ``block_ptr < n_blocks`` ∧ ``u < u_budget`` ∧ ``¬done``.
    """

    name: str = ""

    def run_rule(self, cfg: EnvConfig, occ, scores, term_present, state,
                 allowed, required, du_quota, dv_quota, *,
                 inplace: bool = False) -> EnvState:
        raise NotImplementedError


_SCAN_BACKENDS: Dict[str, ScanBackend] = {}


def register_scan_backend(backend: ScanBackend) -> ScanBackend:
    """Register (or replace) a backend under ``backend.name``."""
    if not backend.name:
        raise ValueError(f"{type(backend).__name__} has no name")
    _SCAN_BACKENDS[backend.name] = backend
    return backend


def get_scan_backend(name: str) -> ScanBackend:
    try:
        return _SCAN_BACKENDS[name]
    except KeyError:
        raise KeyError(f"unknown scan backend {name!r}; available: "
                       f"{available_backends()}") from None


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_SCAN_BACKENDS))


def _apply_chunk(
    cfg: EnvConfig,
    state: EnvState,
    match: torch.Tensor,       # (B, C, W) int32 — per-block match words
    v_inc: torch.Tensor,       # (B, C) int32
    scan_mask: torch.Tensor,   # (B, C) bool — block actually scanned (a prefix)
    u_inc: torch.Tensor,       # (B,) int32 — planes read per block
    scores: torch.Tensor,      # (B, n_docs_padded) float32
) -> EnvState:
    """Fold C blocks from each lane's block_ptr into the state, masking
    every update past the scanned prefix.  Block-for-block identical to
    scanning the prefix one block at a time: the blocks are disjoint
    word ranges, so dedup only looks at ``state.matched``; the candidate
    cumsum spans the chunk in scan order; top-n over the union equals
    iterated top-n."""
    W, D, K = cfg.words_per_block, cfg.block_docs, cfg.max_candidates
    b, chunk = scan_mask.shape
    dev = match.device
    bp = state.block_ptr.long()
    n = scan_mask.sum(dim=1, dtype=torch.int32)

    word_mask = scan_mask.repeat_interleave(W, dim=1)                # (B, C*W)
    mwords = torch.where(word_mask, match.reshape(b, chunk * W), 0)

    # Words and docs of blocks past the end of the index are never
    # scanned (masked to 0 above), so their indices are clamped rather
    # than padding the (B, n_docs) arrays on every chunk.
    total = state.matched.shape[1]
    widx = torch.clamp(
        bp[:, None] * W + torch.arange(chunk * W, device=dev)[None, :],
        max=total - 1)
    old = torch.gather(state.matched, 1, widx)
    new_words = mwords & ~old
    # In-range positions are distinct and clamped ones add 0; new_words
    # holds only bits that matched lacks, so adding them is the OR.
    matched = state.matched.scatter_add(1, widx, new_words)

    new_bits = unpack_words(new_words)                               # (B, C*D)
    didx = bp[:, None] * D + torch.arange(chunk * D, device=dev)[None, :]
    doc_ids = didx.to(torch.int32)
    pos = state.cand_cnt[:, None] + torch.cumsum(
        new_bits, dim=1, dtype=torch.int32) - 1
    # Writes past K go to a spare slot K that is then dropped.
    write_pos = torch.where(new_bits & (pos < K), pos, K).long()
    cand = torch.cat([state.cand, torch.full(
        (b, 1), -1, dtype=torch.int32, device=dev)], dim=1)
    cand = cand.scatter(1, write_pos, doc_ids)[:, :K]
    n_new = new_bits.sum(dim=1, dtype=torch.int32)
    cand_cnt = torch.clamp(state.cand_cnt + n_new, max=K)

    block_scores = torch.gather(
        scores, 1, torch.clamp(didx, max=scores.shape[1] - 1))
    masked = torch.where(new_bits, block_scores, float("-inf"))
    topn = torch.topk(torch.cat([state.topn, masked], dim=1), cfg.n_top,
                      dim=1).values

    return EnvState(
        block_ptr=state.block_ptr + n,
        u=state.u + n * u_inc,
        v=state.v + (v_inc * scan_mask).sum(dim=1, dtype=torch.int32),
        matched=matched,
        cand=cand,
        cand_cnt=cand_cnt,
        topn=topn,
        done=state.done,
    )


def _lane_cond(cfg: EnvConfig, n_blocks: int, s: EnvState, u0, v0,
               du_quota, dv_quota) -> torch.Tensor:
    return ((s.u - u0 < du_quota) & (s.v - v0 < dv_quota)
            & (s.block_ptr < n_blocks) & (s.u < cfg.u_budget) & ~s.done)


def _again(cond: torch.Tensor, rounds: int, loop: str) -> bool:
    """Whether a rule loop runs its body once more: while any lane's
    condition holds.  On ``meta`` (a dry run, where no value can be
    read) exactly once, as XLA's cost analysis counts a while body once;
    the dry run's record names the loop (``kernels/cost.py`` ``note``)."""
    if cond.device.type == "meta":
        if rounds == 0:
            note(f"{loop}: data-dependent loop, body counted once")
        return rounds == 0
    with host_sync("cond_any"):
        return bool(cond.any())


# ------------------------------------------------------------ "reference"
class ReferenceScanBackend(ScanBackend):
    """Block-at-a-time scanning on the full (T·F, W) tile: the semantics
    of the reference's ``xla_run_rule``, batched."""

    name = "reference"

    def run_rule(self, cfg, occ, scores, term_present, state,
                 allowed, required, du_quota, dv_quota, *,
                 inplace: bool = False) -> EnvState:
        b, nb = occ.shape[:2]
        with scope("rule") as span:
            lanes = torch.arange(b, device=occ.device)
            u_inc = block_cost(allowed, term_present)
            u0, v0 = state.u, state.v
            rounds = 0
            while True:
                cond = _lane_cond(cfg, nb, state, u0, v0, du_quota, dv_quota)
                if not _again(cond, rounds, "ReferenceScanBackend.run_rule"):
                    span.end(chunk=1, rounds=rounds)
                    return state
                rounds += 1
                with scope("chunk"):
                    bp = torch.clamp(state.block_ptr, max=nb - 1).long()
                    match, v_inc = scan_block(occ[lanes, bp], allowed,
                                              required, term_present)
                    state = _apply_chunk(cfg, state, match[:, None],
                                         v_inc[:, None], cond[:, None], u_inc,
                                         scores)


# ----------------------------------------------------------- "block_scan"
def adaptive_chunk_blocks(n_blocks: int, du_quota, u_inc,
                          u_budget: int) -> int:
    """Pick a speculation depth C from the rule's quota and plane count.

    A rule's expected scan length is ``du_quota / planes_read`` blocks;
    C is sized for the longest-running lane of the batch, clamped to
    [1, min(n_blocks, MAX_ADAPTIVE_CHUNK)].  Zero-plane rules cost
    nothing and sweep to the end."""
    with host_sync("chunk_quota"):
        du = np.asarray(torch.as_tensor(du_quota).cpu(), dtype=np.float64)
    with host_sync("chunk_planes"):
        planes = np.asarray(torch.as_tensor(u_inc).cpu(), dtype=np.float64)
    blocks = np.where(planes > 0,
                      np.minimum(du, u_budget) / np.maximum(planes, 1.0),
                      n_blocks)
    c = int(np.ceil(np.max(blocks, initial=1.0)))
    return int(np.clip(c, 1, min(n_blocks, MAX_ADAPTIVE_CHUNK)))


class BlockScanBackend(ScanBackend):
    """Plane-pruned rule execution (bytes read ∝ u): on CPU tensors the
    host loop over chunks of C blocks (``host_loop``); on CUDA and meta
    tensors one launch of ``block_scan_rule``.  ``chunk`` is the host loop's
    speculation depth C (blocks per round); ``chunk=None`` picks C per
    rule execution with :func:`adaptive_chunk_blocks`; ``last_chunk`` is
    the C of its last rule execution.  The final state is C-invariant."""

    name = "block_scan"

    def __init__(self, chunk: int | None = DEFAULT_CHUNK_BLOCKS):
        self.chunk = chunk
        self.last_chunk: int | None = None   # the C of the last host loop

    def run_rule(self, cfg, occ, scores, term_present, state,
                 allowed, required, du_quota, dv_quota, *,
                 inplace: bool = False) -> EnvState:
        if occ.device.type == "cpu":
            return self.host_loop(cfg, occ, scores, term_present, state,
                                  allowed, required, du_quota, dv_quota)
        with scope("rule", route="kernel"):
            return block_scan_rule(cfg, occ, scores, term_present, state,
                                   allowed, required, du_quota, dv_quota,
                                   inplace=inplace)

    def host_loop(self, cfg, occ, scores, term_present, state,
                  allowed, required, du_quota, dv_quota) -> EnvState:
        """The rule execution as a loop of chunk rounds on the host (the
        CPU's route; ``block_scan_rule``'s plain version)."""
        with scope("rule") as span:
            return self._host_loop(span, cfg, occ, scores, term_present,
                                   state, allowed, required, du_quota,
                                   dv_quota)

    def _host_loop(self, span, cfg, occ, scores, term_present, state,
                   allowed, required, du_quota, dv_quota) -> EnvState:
        b, nb, t, f, w = occ.shape
        dev = occ.device
        u_inc = block_cost(allowed, term_present)                  # (B,)
        if self.chunk is None:
            chunk = adaptive_chunk_blocks(nb, du_quota, u_inc, cfg.u_budget)
        else:
            chunk = self.chunk
        chunk = max(1, min(chunk, nb))
        self.last_chunk = chunk
        occ2 = occ.reshape(b, nb, t * f, w)
        u0, v0 = state.u, state.v
        # The rule is loop-invariant: build the meta once and refresh
        # only the block-start column per chunk.
        meta = build_rule_meta(allowed, required, term_present,
                               torch.zeros(b, dtype=torch.int32, device=dev))
        j = torch.arange(chunk, dtype=torch.int32, device=dev)[None, :]
        rounds = 0
        while True:
            s = state
            if not _again(_lane_cond(cfg, nb, s, u0, v0, du_quota, dv_quota),
                          rounds, "BlockScanBackend.run_rule"):
                span.end(chunk=chunk, rounds=rounds)
                return s
            rounds += 1
            with scope("chunk"):
                meta[:, 0, META_BP_COL] = s.block_ptr
                match, v_inc, _ = block_scan_pruned_chunk(
                    occ2, meta, chunk=chunk, n_terms=t)
                # Block j is scanned iff the §3 condition holds at the
                # state BEFORE block j.  Every term is monotone in j, so
                # the scanned set is a prefix.
                u_before = s.u[:, None] + j * u_inc[:, None]
                v_prefix = torch.cat([
                    torch.zeros((b, 1), dtype=torch.int32, device=dev),
                    torch.cumsum(v_inc[:, :-1], dim=1).to(torch.int32)],
                    dim=1)
                v_before = s.v[:, None] + v_prefix
                ok = ((u_before - u0[:, None] < du_quota[:, None])
                      & (v_before - v0[:, None] < dv_quota[:, None])
                      & (s.block_ptr[:, None] + j < nb)
                      & (u_before < cfg.u_budget)
                      & ~s.done[:, None])
                scan_mask = torch.cumprod(ok.to(torch.int32), dim=1) > 0
                state = _apply_chunk(cfg, s, match, v_inc, scan_mask, u_inc,
                                     scores)


register_scan_backend(ReferenceScanBackend())
register_scan_backend(BlockScanBackend())
