"""Plain PyTorch versions of the three block scans.

``block_scan_ref`` is the plain version of the whole-index scans
(``csrc/block_scan_tile.cu`` and ``csrc/block_scan_static.cu``): every
block through the port's ``scan_block``, as the JAX ``ref.py`` vmaps
the reference's, plus ``n_match``.  ``block_scan_pruned_ref`` computes
the same function from a static plane list and reads only the listed
planes, as the static kernel does.

``block_scan_pruned_chunk_ref`` is the same function as the chunk
kernel (``csrc/block_scan.cu``): for each lane, evaluate the lane's rule
(from its meta rows) over ``chunk`` consecutive blocks from the lane's
block start, clamped to the last block.  Like the kernel it reads only
the active planes: step ``p`` gathers one W-word row per (lane, chunk
position) for the lanes whose step ``p`` is valid, and the loop ends at
the first step no lane has.

The CPU tests and ``chip_smoke.py``'s comparisons use these; each
wrapper takes its plain version only for CPU tensors.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.match_rules import scan_block
from repro_torch.index.blocks import popcount

__all__ = ["block_scan_ref", "block_scan_pruned_ref",
           "block_scan_pruned_chunk_ref"]


def block_scan_ref(occ: torch.Tensor, allowed: torch.Tensor,
                   required: torch.Tensor, term_present: torch.Tensor):
    """occ (nb, T, F, W) int32, allowed (T, F), required (T,) and
    term_present (T,) bool → (match (nb, W) int32, v_inc (nb,) int32,
    n_match (nb,) int32).  The batched form adds a leading Q axis to
    every input and output: one rule per query."""
    lead = occ.shape[:-4]                       # () or (Q,)
    nb, t, f, w = occ.shape[-4:]

    def per_block(x):                           # (*lead, ...) -> (Q*nb, ...)
        x = x.unsqueeze(len(lead))
        x = x.expand(*lead, nb, *x.shape[len(lead) + 1:])
        return x.reshape(-1, *x.shape[len(lead) + 1:])

    match, v_inc = scan_block(occ.reshape(-1, t, f, w), per_block(allowed),
                              per_block(required), per_block(term_present))
    n_match = popcount(match).sum(dim=1, dtype=torch.int32)
    return (match.reshape(*lead, nb, w), v_inc.reshape(*lead, nb),
            n_match.reshape(*lead, nb))


def block_scan_pruned_ref(occ: torch.Tensor, plane_ids: Sequence[int],
                          term_ids: Sequence[int], req: Sequence[int]):
    """occ (nb, T, F, W) int32 and a static plane list (the active plane
    ids t*F + f, each plane's term, one required flag per term) →
    (match (nb, W), v_inc (nb,), n_match (nb,)) int32.  Reads exactly
    the listed planes: n_active W-word rows per block."""
    nb, t, f, w = occ.shape
    tf = torch.zeros((nb, t, w), dtype=torch.int32, device=occ.device)
    for p, term in zip(plane_ids, term_ids):
        tf[:, term] |= occ[:, p // f, p % f]
    match = torch.zeros((nb, w), dtype=torch.int32, device=occ.device)
    required = [k for k in range(t) if req[k]]
    if required:
        match = tf[:, required[0]].clone()
        for k in required[1:]:
            match &= tf[:, k]
    v_inc = popcount(tf).sum(dim=(1, 2), dtype=torch.int32)
    n_match = popcount(match).sum(dim=1, dtype=torch.int32)
    return match, v_inc, n_match


def block_scan_pruned_chunk_ref(occ: torch.Tensor, meta: torch.Tensor, *,
                                chunk: int, n_terms: int):
    """occ (B, nb, T*F, W) int32, meta (B, 4, ncols) int32 →
    (match (B, chunk, W) int32, v_inc (B, chunk) int32,
    n_match (B, chunk) int32)."""
    b, nb, tf_planes, w = occ.shape
    dev = occ.device
    bp = meta[:, 0, -1]
    blocks = torch.clamp(
        bp[:, None] + torch.arange(chunk, dtype=torch.int32, device=dev),
        max=nb - 1).long()                                         # (B, C)
    plane_ids = meta[:, 0, :tf_planes].long()
    term_ids = meta[:, 1, :tf_planes].long()
    valid = meta[:, 2, :tf_planes] != 0
    req = meta[:, 3, :n_terms] != 0                                # (B, T)

    tf = torch.zeros((b, chunk, n_terms, w), dtype=torch.int32, device=dev)
    for p in range(tf_planes):
        lanes = valid[:, p].nonzero().squeeze(1)
        if lanes.numel() == 0:      # active steps come first: none later
            break
        rows = occ[lanes[:, None], blocks[lanes], plane_ids[lanes, p][:, None]]
        terms = term_ids[lanes, p]
        tf[lanes, :, terms] = tf[lanes, :, terms] | rows           # (n, C, W)

    conj = torch.where(req[:, None, :, None], tf, -1)
    match = conj[:, :, 0]
    for t in range(1, n_terms):
        match = match & conj[:, :, t]
    match = torch.where(req.any(dim=1)[:, None, None], match, 0)
    v_inc = popcount(tf).sum(dim=(2, 3), dtype=torch.int32)
    n_match = popcount(match).sum(dim=2, dtype=torch.int32)
    return match, v_inc, n_match
