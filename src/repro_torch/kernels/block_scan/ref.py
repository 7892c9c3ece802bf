"""Plain PyTorch version of the chunked plane-pruned block scan.

The same function as the CUDA kernel (``csrc/block_scan.cu``): for each
lane, evaluate the lane's rule (from its meta rows) over ``chunk``
consecutive blocks from the lane's block start, clamped to the last
block.  Like the kernel it reads only the active planes: step ``p``
gathers one W-word row per (lane, chunk position) for the lanes whose
step ``p`` is valid, and the loop ends at the first step no lane has.
The CPU tests and ``chip_smoke.py``'s comparison use it; the wrapper
takes it only for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.index.blocks import popcount

__all__ = ["block_scan_pruned_chunk_ref"]


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
