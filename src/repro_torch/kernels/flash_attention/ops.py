"""Flash attention: the public wrapper of the hand-written CUDA kernels.

``flash_attention`` replaces the reference's ``ops.flash_attention``
and its Pallas TPU kernel ``flash_attention_pallas``.  On CUDA tensors
it launches one of two kernels, chosen by dtype and head dim alone (see
``tensor_core_route``; both are bound by operations, see the notes in
their sources); on CPU tensors it runs the plain version ``ref.py``; on
``meta`` tensors it returns the output's shape and computes nothing.
There is no fallback from one to another.  Every meta or CUDA call
reports ``cost`` to an active dry-run counter (``kernels/cost.py``).

The reference pads Sq and Skv up to its blocks and masks the padded
keys by ``kv_len``; the kernel masks the ragged edge itself, so nothing
is padded or copied here, and the result is the same: causal rows see
keys up to their position + Skv - Sq, and a row that sees no key is 0.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels.common import cdiv, refuse_grad
from repro_torch.kernels.cost import KernelCost, run
from repro_torch.kernels.native import NativeKernel, csrc_define

from .ref import attention_ref

__all__ = ["flash_attention", "cost", "FLASH_ATTENTION_KERNEL",
           "FLASH_ATTENTION_TC_KERNEL", "MAX_BLOCK", "MAX_HEAD_DIM",
           "TC_HEAD_DIMS", "tensor_core_route"]

MAX_BLOCK = 64         # the largest block_q / block_k the wrapper takes
MAX_HEAD_DIM = 128     # FA_MAX_D
CC_BLOCK = csrc_define("flash_attention.cuh", "FA_BQ_SHORT")   # fewest CUDA-
                                                               # core tile rows
TC_HEAD_DIMS = (64, 128)   # the head dims flash_attention_tc.cu is built for
TC_BLOCK = csrc_define("flash_attention_tc.cuh", "FATC_BQ")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
FLASH_ATTENTION_KERNEL = NativeKernel(
    name="flash_attention",
    source="flash_attention.cu",
    headers=("flash_attention.cuh", "flash_attention_tc.cuh"),
    symbol="flash_attention_launch",
    argtypes=[_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
              ctypes.c_float, _P],
)
FLASH_ATTENTION_TC_KERNEL = NativeKernel(
    name="flash_attention_tc",
    source="flash_attention_tc.cu",
    headers=("flash_attention_tc.cuh", "flash_attention.cuh"),
    symbol="flash_attention_tc_launch",
    argtypes=[_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P],
)


def tensor_core_route(dtype: torch.dtype, head_dim: int) -> bool:
    """True where a CUDA call goes to the tensor-core kernel
    ``csrc/flash_attention_tc.cu``: bf16 with head dim 64 or 128.  fp32
    (no tensor-core type keeps its 2e-5 tolerance) and bf16 at other
    head dims go to ``csrc/flash_attention.cu``."""
    return dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS


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

    On CUDA the kernel is chosen by contract, from dtype and D alone
    (``tensor_core_route``): bf16 with D in ``TC_HEAD_DIMS`` launches
    ``FLASH_ATTENTION_TC_KERNEL`` (wgmma on 128 x 128 tiles fed by TMA;
    P is rounded to bf16 before P V), everything else
    ``FLASH_ATTENTION_KERNEL`` (CUDA cores, 128 x 64 tiles, or 64 x 64
    where 128-row tiles would leave SMs idle, through a cp.async ring on
    fp32 rows of 16-byte multiples, register loads otherwise).  If the
    chosen kernel fails to build or to launch, the call raises; nothing
    tries the other kernel.  On CUDA it raises under grad mode when an
    input requires grad (``refuse_grad``): the kernels have no backward.

    The blocks are validated as the reference chooses them: ``block_q``
    (``block_k``) shrunk to the next power of two >= 8 above Sq (Skv),
    at most ``MAX_BLOCK`` each.  Neither kernel's tiles follow them, and
    the result does not depend on them."""
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
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")
    refuse_grad("flash_attention", q, k, v)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    tc = tensor_core_route(q.dtype, d)
    if tc:
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("the tensor maps need 16-byte aligned q, k, v")
        if cdiv(sq, TC_BLOCK) > 65535:
            raise ValueError(f"Sq={sq} needs more than 65535 query tiles")
    elif cdiv(sq, CC_BLOCK) > 65535:
        raise ValueError(f"Sq={sq} needs more than 65535 query tiles")
    kernel = FLASH_ATTENTION_TC_KERNEL if tc else FLASH_ATTENTION_KERNEL
    return run(kernel.name,
               lambda: cost(b, hq, hkv, sq, skv, d, causal, q.dtype),
               _launch, kernel, q, k, v, causal)


def _launch(kernel, q, k, v, causal):
    """The output: on meta its shape alone, on CUDA one launch."""
    out = torch.empty_like(q)
    if q.device.type == "meta":
        return out
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if kernel is FLASH_ATTENTION_TC_KERNEL:
            kernel.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), b, hq, hkv, sq, skv, d, int(causal),
                          d ** -0.5, stream)
        else:
            kernel.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), _DTYPES[q.dtype], b, hq, hkv, sq,
                          skv, d, int(causal), d ** -0.5, stream)
    return out


def cost(b: int, hq: int, hkv: int, sq: int, skv: int, d: int, causal: bool,
         dtype) -> KernelCost:
    """One call's cost: QK^T and PV over the (query, key) pairs the mask
    leaves visible (2 FLOPs a multiply-add), and q, k, v read once and o
    written once.  Shapes only."""
    if causal:
        pairs = int(np.clip(np.arange(sq) + (skv - sq) + 1, 0, skv).sum())
    else:
        pairs = sq * skv
    elt = dtype.itemsize
    return KernelCost(flops=4 * d * pairs * b * hq,
                      bytes=elt * d * (2 * b * hq * sq + 2 * b * hkv * skv))
