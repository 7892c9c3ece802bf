"""Plane-pruned block scans: the wrappers and their rule lists.

``block_scan_pruned_chunk`` replaces the Pallas TPU kernel of the same
name (``repro/kernels/block_scan/block_scan_pruned.py``), the kernel
behind the ``"block_scan"`` scan backend.  On CUDA tensors it launches
the hand-written kernel ``csrc/block_scan.cu`` (a warp per lane-block,
two dependent round trips: meta, then occupancy; it reads only the
rule's active planes, n_active * W * 4 bytes per lane-block), on its
16-byte or scalar path as its launch entry chooses (``bs_vector_path``);
on CPU tensors it runs the plain version ``ref.py``; on ``meta`` tensors
it returns the outputs' shapes and computes nothing, and every meta or
CUDA call reports ``chunk_cost`` to an active dry-run counter
(``kernels/cost.py``).

``block_scan_pruned`` replaces ``block_scan_pruned_pallas``: one query,
every block, a static rule given on the host.  The host turns the rule
into its active-plane list (``static_plane_list``) and the kernel
``csrc/block_scan_static.cu`` (a warp per block on the three kernels'
core ``csrc/block_scan_warp.cuh``, at the rule's slot width and tile,
``static_tile``) gets it by value, as a kernel parameter; on CPU
tensors the plain ``ref.block_scan_pruned_ref`` reads the same planes.

There is no fallback from a kernel to its plain version.

Words are int32 tensors with the bits of the reference's uint32.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels.cost import KernelCost, run
from repro_torch.kernels.native import NativeKernel, csrc_define

from .block_scan import MAX_PLANES, MAX_TERMS, MAX_WORDS, tile_blocks
from .ref import block_scan_pruned_chunk_ref, block_scan_pruned_ref

__all__ = ["block_scan_pruned_chunk", "chunk_cost", "build_rule_meta", "META_ROWS",
           "META_BP_COL",
           "BLOCK_SCAN_KERNEL", "MAX_TERMS", "MAX_WORDS",
           "block_scan_pruned", "static_plane_list", "static_tile",
           "BLOCK_SCAN_STATIC_KERNEL"]

META_ROWS = 4          # plane id / term id / step valid / required per term
META_BP_COL = -1       # meta[:, 0, -1] holds the lane's block start
# The static kernel's tile (block_scan_static.cu on the warp core
# block_scan_warp.cuh), for tile_blocks: one round of a warp's BS_SLOTS
# plane rows per warp (BS_SLOTS / slot width blocks at W <= 128), halved
# while one query's grid would hold fewer than STATIC_MIN_CTAS CTAs of
# BS_STATIC_WARPS warps (~4 on each of 132 SMs).
STATIC_WARPS = csrc_define("block_scan_static.cu", "BS_STATIC_WARPS")
STATIC_MAX_TILE = csrc_define("block_scan_static.cu", "BS_STATIC_MAX_BLOCKS")
SLOTS = csrc_define("block_scan_warp.cuh", "BS_SLOTS")
STATIC_MIN_CTAS = 512

_P, _I = ctypes.c_void_p, ctypes.c_int
BLOCK_SCAN_KERNEL = NativeKernel(
    name="block_scan_pruned_chunk",
    source="block_scan.cu",
    headers=("block_scan.cuh", "block_scan_warp.cuh"),
    symbol="block_scan_pruned_chunk_launch",
    argtypes=[_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
)
BLOCK_SCAN_STATIC_KERNEL = NativeKernel(
    name="block_scan_static",
    source="block_scan_static.cu",
    headers=("block_scan.cuh", "block_scan_warp.cuh"),
    symbol="block_scan_static_launch",
    argtypes=[_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P],
)


def build_rule_meta(
    allowed: torch.Tensor,       # (B, T, F) bool
    required: torch.Tensor,      # (B, T) bool
    term_present: torch.Tensor,  # (B, T) bool
    block_start: torch.Tensor,   # (B,) int32
) -> torch.Tensor:
    """Per-lane meta for ``block_scan_pruned_chunk``; equal to the
    reference's ``build_rule_meta`` bit for bit.

    Active planes (allowed ∧ present, flattened t*F+f) are listed first
    in a stable order; the padding steps repeat the LAST active plane
    with valid = 0.  Column ncols-1 of row 0 holds the block start."""
    b, t, f = allowed.shape
    p_steps = t * f
    act = (allowed & term_present[:, :, None]).reshape(b, p_steps)
    order = torch.argsort((~act).to(torch.int32), dim=1,
                          stable=True).to(torch.int32)
    n_active = act.sum(dim=1, dtype=torch.int32)
    last = torch.gather(order, 1,
                        torch.clamp(n_active - 1, min=0)[:, None].long())
    steps = torch.arange(p_steps, dtype=torch.int32, device=allowed.device)
    valid = (steps[None, :] < n_active[:, None]).to(torch.int32)
    plane_ids = torch.where(valid == 1, order, last)

    ncols = max(p_steps + 1, t + 1, 8)
    meta = torch.zeros((b, META_ROWS, ncols), dtype=torch.int32,
                       device=allowed.device)
    meta[:, 0, :p_steps] = plane_ids
    meta[:, 0, ncols - 1] = block_start.to(torch.int32)
    meta[:, 1, :p_steps] = torch.div(plane_ids, f, rounding_mode="floor")
    meta[:, 2, :p_steps] = valid
    meta[:, 3, :t] = (required & term_present).to(torch.int32)
    return meta


def _check(occ: torch.Tensor, meta: torch.Tensor, chunk: int, n_terms: int):
    if occ.dim() != 4 or occ.dtype != torch.int32:
        raise ValueError(f"occ must be (B, nb, T*F, W) int32, got "
                         f"{tuple(occ.shape)} {occ.dtype}")
    b, nb, tf_planes, w = occ.shape
    if meta.dtype != torch.int32 or meta.dim() != 3 or \
            meta.shape[0] != b or meta.shape[1] != META_ROWS:
        raise ValueError(f"meta must be (B, {META_ROWS}, ncols) int32, got "
                         f"{tuple(meta.shape)} {meta.dtype}")
    if meta.shape[2] < max(tf_planes + 1, n_terms + 1, 8):
        raise ValueError(f"meta has {meta.shape[2]} columns, too few")
    if meta.device != occ.device:
        raise ValueError("occ and meta lie on different devices")
    if not (1 <= n_terms <= MAX_TERMS) or tf_planes % n_terms:
        raise ValueError(f"n_terms={n_terms} does not fit {tf_planes} planes "
                         f"(at most {MAX_TERMS} terms)")
    if chunk < 1 or b < 1 or nb < 1 or not (1 <= w <= MAX_WORDS) \
            or b * chunk >= 2**31:
        raise ValueError(f"unsupported shape B={b} nb={nb} W={w} chunk={chunk}")


def block_scan_pruned_chunk(occ: torch.Tensor, meta: torch.Tensor, *,
                            chunk: int, n_terms: int):
    """Evaluate each lane's rule over ``chunk`` consecutive blocks from
    the lane's block start (meta[:, 0, -1]); blocks past nb-1 are clamped
    to the last block and masked by the caller.

    occ (B, nb, T*F, W) int32, meta from :func:`build_rule_meta` →
    (match (B, chunk, W) int32, v_inc (B, chunk) int32,
    n_match (B, chunk) int32)."""
    _check(occ, meta, chunk, n_terms)
    if occ.device.type == "cpu":
        return block_scan_pruned_chunk_ref(occ, meta, chunk=chunk,
                                           n_terms=n_terms)
    if occ.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {occ.device}")
    if not (occ.is_contiguous() and meta.is_contiguous()):
        raise ValueError("occ and meta must be contiguous")
    b, nb, tf_planes, w = occ.shape

    def call_cost():
        if occ.device.type == "meta":
            return chunk_cost(np.full(b, tf_planes), np.zeros(b), nb, chunk, w,
                              meta.shape[2], n_terms, worst_case=True)
        n_active = meta[:, 2, :tf_planes].sum(1).cpu().numpy()
        return chunk_cost(n_active, meta[:, 0, META_BP_COL].cpu().numpy(), nb,
                          chunk, w, meta.shape[2], n_terms)

    return run(BLOCK_SCAN_KERNEL.name, call_cost, _launch_chunk, occ, meta,
               chunk, n_terms)


def _launch_chunk(occ, meta, chunk, n_terms):
    b, nb, tf_planes, w = occ.shape
    match = torch.empty((b, chunk, w), dtype=torch.int32, device=occ.device)
    v_inc = torch.empty((b, chunk), dtype=torch.int32, device=occ.device)
    n_match = torch.empty((b, chunk), dtype=torch.int32, device=occ.device)
    if occ.device.type == "meta":
        return match, v_inc, n_match
    with torch.cuda.device(occ.device):
        stream = torch.cuda.current_stream().cuda_stream
        BLOCK_SCAN_KERNEL.launch(
            occ.data_ptr(), meta.data_ptr(), match.data_ptr(),
            v_inc.data_ptr(), n_match.data_ptr(), b, nb, tf_planes, w,
            meta.shape[2], n_terms, chunk, stream)
    return match, v_inc, n_match


def chunk_cost(n_active, block_start, nb: int, chunk: int, w: int,
               meta_cols: int, n_terms: int, worst_case: bool = False
               ) -> KernelCost:
    """One chunk launch's cost, from each lane's active planes and block
    start: the active planes' words of the lane's DISTINCT blocks read
    once (chunk positions clamped to block nb - 1 reread that block),
    the meta read once, match, v_inc and n_match written once; one OR
    per word read, and per output word and term a popcount, an AND and
    an add.  The dry run on meta takes every lane at all T·F planes and
    a whole chunk of blocks (``worst_case``)."""
    n_active = np.asarray(n_active, dtype=np.int64)
    bp = np.asarray(block_start, dtype=np.int64)
    b = len(bp)
    blocks = np.clip(nb - bp, 1, chunk)
    words_read = int((n_active * blocks).sum()) * w
    bytes_moved = 4 * (words_read + b * 4 * meta_cols + b * chunk * w
                       + 2 * b * chunk)
    ops = words_read + b * chunk * w * n_terms * 3
    return KernelCost(flops=ops, bytes=bytes_moved, worst_case=worst_case)


# ------------------------------------------------- static whole-index scan
def static_plane_list(allowed, required, term_present):
    """A static rule's plane list, on the host, as the reference's
    ``block_scan_pruned_pallas`` computes it: the active plane ids
    (allowed ∧ present, flattened t*F + f, ascending), each plane's
    term, and required ∧ present per term; int32 numpy arrays."""
    allowed = np.asarray(allowed, dtype=bool)
    present = np.asarray(term_present, dtype=bool)
    f = allowed.shape[1]
    planes = np.argwhere((allowed & present[:, None]).reshape(-1)).ravel()
    req = np.asarray(required, dtype=bool) & present
    return (planes.astype(np.int32), (planes // f).astype(np.int32),
            req.astype(np.int32))


def slot_width(n_active: int) -> int:
    """Plane rows a block takes of a warp's ``SLOTS``: the smallest power
    of two >= n_active, at least 1 (``bs_slot_width``)."""
    return 1 << max(n_active - 1, 0).bit_length()


def static_tile(nb: int, n_active: int) -> int:
    """Blocks per CTA of the static kernel: a round of ``SLOTS`` plane
    rows a warp (one block at the deepest rule, 8 at a two-plane rule),
    halved while one query's grid would hold fewer than
    ``STATIC_MIN_CTAS`` CTAs.  At 4096 blocks: 4 (1,024 CTAs, a block a
    warp) at 16 planes, 8 (512 CTAs, a round of two blocks a warp) at 2
    to 8 planes.  ``chip_smoke.py`` times it against twice the tile."""
    return tile_blocks(1, nb, STATIC_WARPS * (SLOTS // slot_width(n_active)),
                       STATIC_MIN_CTAS)


def block_scan_pruned(occ: torch.Tensor, allowed, required, term_present):
    """Evaluate one static rule over every block of one query's index;
    only the rule's active planes are read.

    occ (nb, T, F, W) int32; allowed (T, F), required (T,) and
    term_present (T,) bool on the host (numpy arrays, or anything
    ``np.asarray`` takes) → (match (nb, W) int32, v_inc (nb,) int32,
    n_match (nb,) int32)."""
    if occ.dim() != 4 or occ.dtype != torch.int32:
        raise ValueError(f"occ must be (nb, T, F, W) int32, got "
                         f"{tuple(occ.shape)} {occ.dtype}")
    nb, t, f, w = occ.shape
    shapes = {"allowed": (t, f), "required": (t,), "term_present": (t,)}
    for name, x in zip(shapes, (allowed, required, term_present)):
        if np.shape(x) != shapes[name]:
            raise ValueError(f"{name} must be {shapes[name]}, got "
                             f"{np.shape(x)}")
    if t > MAX_TERMS or t * f > MAX_PLANES:
        raise ValueError(f"T={t}, F={f}: at most {MAX_TERMS} terms and "
                         f"{MAX_PLANES} planes")
    if nb < 1 or not (1 <= w <= MAX_WORDS):
        raise ValueError(f"unsupported shape nb={nb} W={w}")
    planes, terms, req = static_plane_list(allowed, required, term_present)
    if occ.device.type == "cpu":
        return block_scan_pruned_ref(occ, planes.tolist(), terms.tolist(),
                                     req.tolist())
    if occ.device.type != "cuda":
        raise ValueError(f"unsupported device {occ.device}")
    if not occ.is_contiguous():
        raise ValueError("occ must be contiguous")
    match = torch.empty((nb, w), dtype=torch.int32, device=occ.device)
    v_inc = torch.empty((nb,), dtype=torch.int32, device=occ.device)
    n_match = torch.empty((nb,), dtype=torch.int32, device=occ.device)
    with torch.cuda.device(occ.device):
        stream = torch.cuda.current_stream().cuda_stream
        BLOCK_SCAN_STATIC_KERNEL.launch(
            occ.data_ptr(), match.data_ptr(), v_inc.data_ptr(),
            n_match.data_ptr(), planes.ctypes.data, terms.ctypes.data,
            len(planes), req.ctypes.data, nb, t * f, w, t,
            static_tile(nb, len(planes)), stream)
    return match, v_inc, n_match
