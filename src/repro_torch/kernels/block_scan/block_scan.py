"""Whole-index block scan under a runtime rule per query: the wrapper.

``block_scan_tile`` replaces the Pallas TPU kernel ``block_scan_pallas``
(``repro/kernels/block_scan/block_scan.py``).  On CUDA tensors it
launches the hand-written kernel ``csrc/block_scan_tile.cu``
(memory-bound: it reads only the rule's active planes, n_active * W * 4
bytes per block; a warp per block, 16 bytes a lane); on CPU tensors it
runs the plain version ``ref.block_scan_ref``.  There is no fallback
from one to the other.

The kernel has a 16-byte path and a scalar path; its launch entry
chooses by contract (``bs_vector_path`` in ``csrc/block_scan_warp.cuh``:
W % 4 == 0 and 16-byte aligned pointers, which a view at an offset need
not have).  Both are the hand-written kernel.

The rules stay on the device: the kernel reads the caller's bool
tensors and each CTA ANDs them itself, so a launch needs no host sync
and no tensor op before it.  Words are int32 tensors with the bits of
the reference's uint32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.native import NativeKernel, csrc_define

from .ref import block_scan_ref

__all__ = ["block_scan_tile", "tile_blocks", "BLOCK_SCAN_TILE_KERNEL"]

MAX_TERMS = csrc_define("block_scan.cuh", "BS_MAX_TERMS")
MAX_PLANES = csrc_define("block_scan.cuh", "BS_MAX_PLANES")
# Blocks per CTA (the TPU's block_bb): 16 a warp, one full round of a
# one-plane rule (block_scan_warp.cuh).
MAX_TILE = csrc_define("block_scan_tile.cu", "BS_TILE_MAX_BLOCKS")
MAX_WORDS = 1024       # a warp walks a block in 128-word strips
MIN_CTAS = 512         # ~4 CTAs of 4 warps on each of 132 SMs

_P, _I = ctypes.c_void_p, ctypes.c_int
BLOCK_SCAN_TILE_KERNEL = NativeKernel(
    name="block_scan_tile",
    source="block_scan_tile.cu",
    headers=("block_scan.cuh", "block_scan_warp.cuh"),
    symbol="block_scan_tile_launch",
    argtypes=[_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
)


def tile_blocks(n_queries: int, nb: int, cap: int = MAX_TILE,
                min_ctas: int = MIN_CTAS) -> int:
    """Blocks per CTA: ``cap``, halved while the grid would hold fewer
    than ``min_ctas`` CTAs, so that a small scan still spreads over
    every SM.  The tile kernel's defaults give one query over a few
    thousand blocks 8 blocks, 2 a warp (512 CTAs at 4096 blocks)."""
    bb = cap
    while bb > 1 and n_queries * -(-nb // bb) < min_ctas:
        bb //= 2
    return bb


def _check(occ, allowed, required, term_present):
    if occ.dim() != 5 or occ.dtype != torch.int32:
        raise ValueError(f"occ must be (Q, nb, T, F, W) int32, got "
                         f"{tuple(occ.shape)} {occ.dtype}")
    q, nb, t, f, w = occ.shape
    want = {"allowed": (allowed, (q, t, f)), "required": (required, (q, t)),
            "term_present": (term_present, (q, t))}
    for name, (x, shape) in want.items():
        if x.dtype != torch.bool or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape} bool, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.device != occ.device:
            raise ValueError(f"occ and {name} lie on different devices")
    if t > MAX_TERMS or t * f > MAX_PLANES:
        raise ValueError(f"T={t}, F={f}: at most {MAX_TERMS} terms and "
                         f"{MAX_PLANES} planes")
    if q < 1 or nb < 1 or not (1 <= w <= MAX_WORDS):
        raise ValueError(f"unsupported shape Q={q} nb={nb} W={w}")


def block_scan_tile(occ: torch.Tensor, allowed: torch.Tensor,
                    required: torch.Tensor, term_present: torch.Tensor):
    """Evaluate each query's rule over every block of its occupancy.

    occ (Q, nb, T, F, W) int32, allowed (Q, T, F), required (Q, T),
    term_present (Q, T) bool → (match (Q, nb, W) int32, v_inc (Q, nb)
    int32, n_match (Q, nb) int32)."""
    _check(occ, allowed, required, term_present)
    if occ.device.type == "cpu":
        return block_scan_ref(occ, allowed, required, term_present)
    if occ.device.type != "cuda":
        raise ValueError(f"unsupported device {occ.device}")
    if not occ.is_contiguous():
        raise ValueError("occ must be contiguous")
    q, nb, t, f, w = occ.shape
    bb = tile_blocks(q, nb)
    if q * -(-nb // bb) >= 2**31:
        raise ValueError(f"Q={q} x nb={nb} is past the kernel's grid")
    rule = [x.contiguous() for x in (allowed, required, term_present)]
    match = torch.empty((q, nb, w), dtype=torch.int32, device=occ.device)
    v_inc = torch.empty((q, nb), dtype=torch.int32, device=occ.device)
    n_match = torch.empty((q, nb), dtype=torch.int32, device=occ.device)
    with torch.cuda.device(occ.device):
        stream = torch.cuda.current_stream().cuda_stream
        BLOCK_SCAN_TILE_KERNEL.launch(
            occ.data_ptr(), *(x.data_ptr() for x in rule), match.data_ptr(),
            v_inc.data_ptr(), n_match.data_ptr(), q, nb, t * f, f, w, t, bb,
            stream)
    return match, v_inc, n_match
