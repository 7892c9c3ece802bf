"""Public entry points of the block scans: the port's counterpart of the
JAX package's ``kernels/block_scan/ops.py``.

``block_scan`` (one query) and ``block_scan_batched`` (Q queries, one
rule each) run ``csrc/block_scan_tile.cu`` on CUDA tensors, the port of
``block_scan_pallas``; ``block_scan_pruned`` (one query, a static rule
on the host) runs ``csrc/block_scan_static.cu``, the port of
``block_scan_pruned_pallas``; ``block_scan_reference`` is the plain
version.  CPU tensors take the plain versions; there is no fallback
between a kernel and its plain version.

The JAX functions' ``block_bb`` (the TPU kernel's tile of blocks) and
``interpret`` (Pallas interpret mode) arguments are left out: the CUDA
wrapper picks its own tile (``block_scan.tile_blocks``) and there is no
interpret mode.  Words are int32 tensors with the bits of the
reference's uint32.
"""
from __future__ import annotations

import torch

from .block_scan import block_scan_tile
from .block_scan_pruned import block_scan_pruned
from .ref import block_scan_ref

__all__ = ["block_scan", "block_scan_batched", "block_scan_pruned",
           "block_scan_reference"]

block_scan_reference = block_scan_ref


def block_scan(occ: torch.Tensor, allowed: torch.Tensor,
               required: torch.Tensor, term_present: torch.Tensor):
    """One query: occ (nb, T, F, W) int32, allowed (T, F), required (T,)
    and term_present (T,) bool → (match (nb, W), v_inc (nb,),
    n_match (nb,)) int32."""
    match, v_inc, n_match = block_scan_tile(
        occ[None], allowed[None], required[None], term_present[None])
    return match[0], v_inc[0], n_match[0]


def block_scan_batched(occ: torch.Tensor, allowed: torch.Tensor,
                       required: torch.Tensor, term_present: torch.Tensor):
    """Q queries, one rule each: occ (Q, nb, T, F, W) int32, allowed
    (Q, T, F), required (Q, T), term_present (Q, T) bool →
    (match (Q, nb, W), v_inc (Q, nb), n_match (Q, nb)) int32."""
    return block_scan_tile(occ, allowed, required, term_present)
