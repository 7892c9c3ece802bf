"""Bitpacked block store for query-time index scanning.

The inverted index is consumed at query time as a *bitpacked occupancy
tensor*::

    occ[block, term, field, word]

bit ``j`` of ``occ[b, t, f, w]`` says whether document ``b*BLOCK_DOCS +
w*32 + j`` contains query term ``t`` in field ``f``.  Documents are laid
out in static-rank order, so scanning blocks in order scans the index
best-first.

Host side (numpy) the words are ``uint32``, as in ``repro.index.blocks``.
On the torch side they are held as ``int32`` with the same bits:
``torch.uint32`` lacks ``~``, ``>>``, ``<<``, ``max`` and ``index_put``
on the CPU.  ``>>`` on a negative ``int32`` shifts arithmetically, so
every shift here is followed by a mask.
"""
from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32

__all__ = [
    "WORD_BITS", "pack_bits", "unpack_bits", "words_per_block",
    "popcount", "unpack_words", "words_to_tensor", "doc_bit",
]


def words_per_block(block_docs: int) -> int:
    if block_docs % WORD_BITS != 0:
        raise ValueError(f"block_docs must be a multiple of {WORD_BITS}")
    return block_docs // WORD_BITS


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """Pack a boolean array (..., n_docs) into uint32 words (..., n_docs/32).

    Bit ``j`` of word ``w`` corresponds to doc ``w*32 + j`` (LSB-first).
    """
    bits = np.asarray(bits, dtype=bool)
    n = bits.shape[-1]
    if n % WORD_BITS != 0:
        raise ValueError(f"trailing dim must be a multiple of {WORD_BITS}")
    packed = np.packbits(bits, axis=-1, bitorder="little")   # (..., n/8) u8
    return np.ascontiguousarray(packed).view("<u4").astype(np.uint32)


def unpack_bits(words: np.ndarray) -> np.ndarray:
    """Inverse of :func:`pack_bits` (host-side)."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    as_bytes = words.astype("<u4").view(np.uint8)
    return np.unpackbits(as_bytes, axis=-1, bitorder="little").astype(bool)


def words_to_tensor(words: np.ndarray, device) -> torch.Tensor:
    """uint32 numpy words -> int32 tensor with the same bits."""
    arr = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(arr).to(device)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Per-word population count of int32 words (SWAR on int64).

    torch has no popcount op.  Returns int32 of x's shape."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def unpack_words(words: torch.Tensor) -> torch.Tensor:
    """(..., W) int32 -> (..., W*32) bool, LSB-first (matches pack_bits)."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    bits = (words.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1).to(torch.bool)


def doc_bit(words: torch.Tensor, doc_in_block) -> torch.Tensor:
    """The bit of a document offset inside a block of words: ``words``
    (..., W) int32, ``doc_in_block`` a scalar or a vector of offsets;
    int32 0 or 1, of shape (...,) or (..., n)."""
    d = torch.as_tensor(doc_in_block, device=words.device).long()
    return (words[..., d // WORD_BITS] >> (d % WORD_BITS).to(words.dtype)) & 1
