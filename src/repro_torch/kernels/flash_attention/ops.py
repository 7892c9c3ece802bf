"""Flash attention: the public wrapper of the hand-written CUDA kernel.

``flash_attention`` replaces the reference's ``ops.flash_attention``
and its Pallas TPU kernel ``flash_attention_pallas``.  On CUDA tensors
it launches ``csrc/flash_attention.cu`` (bound by operations: see the
note there); on CPU tensors it runs the plain version ``ref.py``.
There is no fallback from one to the other.

The reference pads Sq and Skv up to its blocks and masks the padded
keys by ``kv_len``; the kernel masks the ragged edge itself, so nothing
is padded or copied here, and the result is the same: causal rows see
keys up to their position + Skv - Sq, and a row that sees no key is 0.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import cdiv
from repro_torch.kernels.native import NativeKernel

from .ref import attention_ref

__all__ = ["flash_attention", "FLASH_ATTENTION_KERNEL", "MAX_BLOCK",
           "MAX_HEAD_DIM"]

MAX_BLOCK = 64         # FA_BQ / FA_BK in csrc/flash_attention.cuh
MAX_HEAD_DIM = 128     # FA_MAX_D
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
FLASH_ATTENTION_KERNEL = NativeKernel(
    name="flash_attention",
    source="flash_attention.cu",
    headers=("flash_attention.cuh",),
    symbol="flash_attention_launch",
    argtypes=[_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
              ctypes.c_float, _P],
)


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, sq, d = q.shape
    bk_, hkv, skv, dk = k.shape
    if bk_ != b or dk != d or hkv < 1 or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)} (GQA needs Hq % Hkv == 0)")
    if not (1 <= d <= MAX_HEAD_DIM):
        raise ValueError(f"head dim {d} unsupported (at most {MAX_HEAD_DIM})")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype} unsupported "
                         f"(fp32 or bf16, all alike)")
    if min(b, sq, skv) < 1:
        raise ValueError(f"empty input: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v lie on different devices")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: int = MAX_BLOCK,
                    block_k: int = MAX_BLOCK) -> torch.Tensor:
    """q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), fp32 or bf16 →
    (B, Hq, Sq, D) in q's dtype; fp32 accumulation.

    The blocks are chosen as the reference chooses them: ``block_q``
    (``block_k``) shrunk to the next power of two >= 8 above Sq (Skv).
    On CUDA a CTA takes one query block and loops over key blocks; at
    most ``MAX_BLOCK`` each (the kernel's tile).  The result does not
    depend on the blocks."""
    _check(q, k, v)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    bq = min(block_q, max(8, 1 << (sq - 1).bit_length()))
    bk = min(block_k, max(8, 1 << (skv - 1).bit_length()))
    if not (1 <= bq <= MAX_BLOCK and 1 <= bk <= MAX_BLOCK):
        raise ValueError(f"blocks {block_q}x{block_k} unsupported (at most "
                         f"{MAX_BLOCK} each)")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if cdiv(sq, bq) > 65535:
        raise ValueError(f"Sq={sq} needs more than 65535 query blocks")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        FLASH_ATTENTION_KERNEL.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, hq, hkv, sq, skv, d, bq, bk, int(causal),
            d ** -0.5, stream)
    return out
