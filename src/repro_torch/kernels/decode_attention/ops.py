"""Decode attention: the public wrapper of the hand-written CUDA kernel.

``decode_attention`` replaces the reference's ``ops.decode_attention``
and its Pallas TPU kernel ``decode_attention_pallas``.  On CUDA tensors
it launches ``csrc/decode_attention.cu`` (bound by bytes: see the note
there); on CPU tensors it runs the plain version ``ref.py``.  There is
no fallback from one to the other.

The reference pads S up to its KV block and masks the padded keys by
``kv_len``; the kernel masks keys at or past ``kv_len`` itself, so
nothing is padded or copied here.  k and v may be strided views (D
contiguous), such as the transposed (B, S, Hkv, D) cache of the LM
decode path.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import cdiv
from repro_torch.kernels.native import NativeKernel

from .ref import decode_attention_ref, merge_partials_ref

__all__ = ["decode_attention", "merge_partials", "split_plan",
           "DECODE_ATTENTION_KERNEL", "MAX_HEAD_DIM", "MAX_GROUP", "BLOCK_K"]

BLOCK_K = 64           # DA_BK in csrc/decode_attention.cuh
MAX_HEAD_DIM = 128     # DA_MAX_D
MAX_GROUP = 16         # DA_MAX_GROUP
CTAS_PER_SM = 2        # pass 1's CTAs resident per SM (~83 KB of smem each)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
DECODE_ATTENTION_KERNEL = NativeKernel(
    name="decode_attention",
    source="decode_attention.cu",
    headers=("decode_attention.cuh", "flash_attention.cuh"),
    symbol="decode_attention_launch",
    argtypes=[_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P,
              _I, _I, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L,
              _I, _I, _I, ctypes.c_float, _P],
)

merge_partials = merge_partials_ref


def _check(q, k, v):
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B, Hq, D) and k, v (B, Hkv, S, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, d = q.shape
    bk_, hkv, s, dk = k.shape
    if bk_ != b or dk != d or hkv < 1 or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit k/v "
                         f"{tuple(k.shape)} (GQA needs Hq % Hkv == 0)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype} unsupported "
                         f"(fp32 or bf16, all alike)")
    if min(b, s, d) < 1:
        raise ValueError(f"empty input: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v lie on different devices")


def _check_cuda(q, k, v, kv_len):
    b, hq, d = q.shape
    hkv = k.shape[1]
    if d > MAX_HEAD_DIM or d % 8:
        raise ValueError(f"head dim {d} unsupported on CUDA (a multiple of 8, "
                         f"at most {MAX_HEAD_DIM})")
    if hq // hkv > MAX_GROUP:
        raise ValueError(f"GQA group {hq // hkv} unsupported (at most "
                         f"{MAX_GROUP})")
    if b * hkv > 65535:
        raise ValueError(f"B * Hkv = {b * hkv} exceeds the grid")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    for name, t in (("k", k), ("v", v)):
        # 16-byte loads: D contiguous, every row start 16-byte aligned
        if (t.stride(3) != 1 or t.data_ptr() % 16
                or any(st % 8 for st in t.stride()[:3])):
            raise ValueError(f"{name} needs a contiguous last dim, strides "
                             f"that are multiples of 8 and 16-byte alignment")
    if isinstance(kv_len, torch.Tensor) and (
            kv_len.shape != (b,) or kv_len.device != q.device
            or kv_len.dtype.is_floating_point):
        raise ValueError(f"kv_len must be an int or a ({b},) integer tensor "
                         f"on {q.device}")


def split_plan(b: int, hkv: int, s: int, sms: int) -> tuple[int, int]:
    """(n_split, split_keys): the slices of the key axis for pass 1 and
    the keys of each.  As many slices as keep the b * hkv (sequence, KV
    head) pairs' CTAs within one wave of ``CTAS_PER_SM`` per SM (at least
    one), each slice whole tiles of ``BLOCK_K`` keys, no slice wholly
    past S.  The kernel takes both numbers as they are."""
    want = min(max(CTAS_PER_SM * sms // (b * hkv), 1), cdiv(s, BLOCK_K))
    per = cdiv(cdiv(s, want), BLOCK_K) * BLOCK_K
    return cdiv(s, per), per


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     scale: float | None = None, kv_len=None,
                     return_partial: bool = False):
    """q (B, Hq, D), k and v (B, Hkv, S, D), fp32 or bf16 → (out (B, Hq,
    D) in q's dtype, m (B, Hq, 1) f32, l (B, Hq, 1) f32).

    ``kv_len``: None (all S keys), an int, or a (B,) integer tensor on
    q's device (one length per sequence; read on the device, no host
    sync).  Lengths are clamped to [0, S]; a row with no valid key gives
    out 0, m = -inf, l = 0.  With ``return_partial``, ``out`` is the
    unnormalised accumulator for an LSE merge (``merge_partials``)."""
    _check(q, k, v)
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    scale = (d ** -0.5) if scale is None else scale
    if q.device.type == "cpu":
        if isinstance(kv_len, torch.Tensor):
            kv_len = kv_len.clamp(0, s)
        elif kv_len is not None:
            kv_len = min(max(int(kv_len), 0), s)
        return decode_attention_ref(q, k, v, scale=scale, kv_len=kv_len,
                                    return_partial=return_partial)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda(q, k, v, kv_len)
    lens, kv_all = None, s
    if isinstance(kv_len, torch.Tensor):
        lens = kv_len.to(torch.int32).contiguous()
    elif kv_len is not None:
        kv_all = min(max(int(kv_len), 0), s)

    group = hq // hkv
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    n_split, split_keys = split_plan(b, hkv, s, sms)
    dev = q.device
    acc_part = torch.empty((b * hkv * n_split * group * d,), dtype=torch.float32,
                           device=dev)
    m_part = torch.empty((b * hkv * n_split * group,), dtype=torch.float32,
                         device=dev)
    l_part = torch.empty_like(m_part)
    out = torch.empty_like(q)
    m = torch.empty((b, hq, 1), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        DECODE_ATTENTION_KERNEL.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if lens is None else lens.data_ptr(), kv_all,
            acc_part.data_ptr(), m_part.data_ptr(), l_part.data_ptr(),
            out.data_ptr(), m.data_ptr(), l.data_ptr(), _DTYPES[q.dtype],
            b, hq, hkv, s, d, *k.stride()[:3], *v.stride()[:3], n_split,
            split_keys, int(return_partial), scale, stream)
    return out, m, l
