"""Decode attention: the public wrapper of the hand-written CUDA kernel.

``decode_attention`` replaces the reference's ``ops.decode_attention``
and its Pallas TPU kernel ``decode_attention_pallas``.  On CUDA tensors
it launches one of two kernels, chosen by dtype, head dim and GQA group
alone (``tensor_core_route``): ``csrc/decode_attention_tc.cu`` (bf16 on
the tensor cores) or ``csrc/decode_attention.cu`` (fp32, and bf16 at
other head dims, on the CUDA cores).  Both are bound by bytes (see the
notes there) and both are one launch a call: the key axis is cut into
slices (``split_plan_tc``, ``split_plan``), one CTA a slice of one
(sequence, KV head), and the last CTA of each pair to finish merges the
slices, counted on zeroed counters the wrapper keeps per device and
stream.  On CPU tensors it runs the plain version ``ref.py``; on
``meta`` tensors it returns the outputs' shapes and computes nothing.
There is no fallback from one to another.  Every meta or CUDA call
reports ``cost`` to an active dry-run counter (``kernels/cost.py``).

The reference pads S up to its KV block and masks the padded keys by
``kv_len``; the kernel masks keys at or past ``kv_len`` itself, so
nothing is padded or copied here.  k and v may be strided views (D
contiguous), such as the transposed (B, S, Hkv, D) cache of the LM
decode path.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.common import cdiv, refuse_grad
from repro_torch.kernels.cost import KernelCost, run
from repro_torch.kernels.native import NativeKernel, csrc_define

from .ref import decode_attention_ref, merge_partials_ref

__all__ = ["decode_attention", "cost", "merge_partials", "split_plan",
           "split_plan_tc", "tensor_core_route", "DECODE_ATTENTION_KERNEL",
           "DECODE_ATTENTION_TC_KERNEL", "MAX_HEAD_DIM", "MAX_GROUP",
           "BLOCK_K", "TC_BLOCK_K", "TC_HEAD_DIMS"]

BLOCK_K = csrc_define("decode_attention.cuh", "DA_BK")   # a slice's unit
MAX_HEAD_DIM = csrc_define("decode_attention.cuh", "DA_MAX_D")
MAX_GROUP = csrc_define("decode_attention.cuh", "DA_MAX_GROUP")
# CTAs resident per SM (96 KB of shared memory each at fp32 D = 128)
CTAS_PER_SM = csrc_define("decode_attention.cuh", "DA_CTAS_PER_SM")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
DECODE_ATTENTION_KERNEL = NativeKernel(
    name="decode_attention",
    source="decode_attention.cu",
    headers=("decode_attention.cuh", "flash_attention.cuh"),
    symbol="decode_attention_launch",
    argtypes=[_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
              _I, _I, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L,
              _I, _I, _I, ctypes.c_float, _P],
)

DECODE_ATTENTION_TC_KERNEL = NativeKernel(
    name="decode_attention_tc",
    source="decode_attention_tc.cu",
    headers=("decode_attention_tc.cuh", "decode_attention.cuh",
             "flash_attention.cuh"),
    symbol="decode_attention_tc_launch",
    argtypes=[_P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
              _I, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L,
              _I, _I, _I, ctypes.c_float, _P],
)
TC_HEAD_DIMS = (64, 128)   # the head dims decode_attention_tc.cu is built for
TC_BLOCK_K = csrc_define("decode_attention_tc.cuh", "DATC_BK")
TC_MAX_GROUP = csrc_define("decode_attention_tc.cuh", "DATC_MAX_GROUP")
TC_MAX_SPLIT = csrc_define("decode_attention_tc.cuh", "DATC_MAX_SPLIT")

merge_partials = merge_partials_ref

# Per (device, stream): B * Hkv int32 counters of the kernels' last-CTA
# merge, zero between launches (the kernels leave them zero).
_COUNTERS: dict = {}


def tensor_core_route(dtype: torch.dtype, head_dim: int, group: int) -> bool:
    """True where a CUDA call goes to the tensor-core kernel
    ``csrc/decode_attention_tc.cu``: bf16 with head dim 64 or 128 and a
    GQA group of at most 16.  fp32 (no tensor-core type keeps its 2e-5
    tolerance) and every other shape go to ``csrc/decode_attention.cu``."""
    return (dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS
            and group <= TC_MAX_GROUP)


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
    """(n_split, split_keys) for the CUDA-core kernel: the slices of the
    key axis and the keys of each.  As many slices as keep the b * hkv
    (sequence, KV head) pairs' CTAs within one wave of ``CTAS_PER_SM``
    per SM (at least one), each slice whole rounds of ``BLOCK_K`` keys,
    no slice wholly past S.  At phase 4's fp32 route (b=2, hkv=8,
    s=1026, 132 SMs) that is 11 slices of 96 keys: three tiles a warp,
    all in its ring at once.  The kernel takes both numbers as they
    are; ``chip_smoke.py`` times the plan against two others."""
    want = min(max(CTAS_PER_SM * sms // (b * hkv), 1), cdiv(s, BLOCK_K))
    per = cdiv(cdiv(s, want), BLOCK_K) * BLOCK_K
    return cdiv(s, per), per


@functools.lru_cache(maxsize=None)
def split_plan_tc(b: int, hkv: int, s: int, sms: int) -> tuple[int, int]:
    """(n_split, split_keys) for the tensor-core kernel: one wave of one
    CTA per SM.  The key axis is cut into as many slices as keep the
    b * hkv * n CTAs within ``sms`` (at least one slice, at most
    ``TC_MAX_SPLIT``), each slice whole tiles of ``TC_BLOCK_K`` keys, no
    slice wholly past S.  Longer slices beat more CTAs: at the LM path's
    decode (b=2, hkv=8, s=8208, 132 SMs) 8 slices of 17 tiles (128 CTAs)
    ran faster on the H100 than 15 slices (two CTAs on most SMs) or 33
    (two waves); ``chip_smoke.py`` times all three (PERF.md)."""
    tiles = cdiv(s, TC_BLOCK_K)
    want = min(max(sms // (b * hkv), 1), tiles, TC_MAX_SPLIT)
    per = cdiv(tiles, want)
    return cdiv(tiles, per), per * TC_BLOCK_K


def _counters(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (dev.index, stream)
    have = _COUNTERS.get(key)
    if have is None or have.numel() < n:
        have = torch.zeros((max(n, 1024),), dtype=torch.int32, device=dev)
        _COUNTERS[key] = have
    return have


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     scale: float | None = None, kv_len=None,
                     return_partial: bool = False, partial_f32: bool = False):
    """q (B, Hq, D), k and v (B, Hkv, S, D), fp32 or bf16 → (out (B, Hq,
    D) in q's dtype, m (B, Hq, 1) f32, l (B, Hq, 1) f32).

    ``kv_len``: None (all S keys), an int, or a (B,) integer tensor on
    q's device (one length per sequence; read on the device, no host
    sync).  Lengths are clamped to [0, S]; a row with no valid key gives
    out 0, m = -inf, l = 0.  With ``return_partial``, ``out`` is the
    unnormalised accumulator for an LSE merge (``merge_partials``);
    with ``partial_f32`` too, that accumulator is float32 whatever q's
    dtype (the kernel writes its fp32 sums unrounded), so that a merge
    across ranks adds no rounding to it.

    On CUDA the kernel is chosen by contract (``tensor_core_route``):
    bf16 at D 64 or 128 with a group of at most 16 launches
    ``DECODE_ATTENTION_TC_KERNEL`` (mma.sync on bf16 tiles; P is rounded
    to bf16 before P.V), everything else ``DECODE_ATTENTION_KERNEL``
    (fp32 FMAs on the CUDA cores).  Either is one launch, whose last CTA
    per (sequence, KV head) merges the slices.  If the chosen kernel
    fails to build or to launch, the call raises; nothing tries the
    other.  On CUDA it raises under grad mode when an input requires
    grad (``refuse_grad``): the kernels have no backward."""
    _check(q, k, v)
    if partial_f32 and not return_partial:
        raise ValueError("partial_f32 needs return_partial")
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    scale = (d ** -0.5) if scale is None else scale
    if q.device.type == "cpu":
        if isinstance(kv_len, torch.Tensor):
            kv_len = kv_len.clamp(0, s)
        elif kv_len is not None:
            kv_len = min(max(int(kv_len), 0), s)
        return decode_attention_ref(q, k, v, scale=scale, kv_len=kv_len,
                                    return_partial=return_partial,
                                    partial_f32=partial_f32)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")
    refuse_grad("decode_attention", q, k, v)
    _check_cuda(q, k, v, kv_len)
    group = hq // hkv
    tc = tensor_core_route(q.dtype, d, group)
    kernel = DECODE_ATTENTION_TC_KERNEL if tc else DECODE_ATTENTION_KERNEL

    def call_cost():
        if isinstance(kv_len, torch.Tensor):
            if q.device.type == "meta":
                return cost(b, hq, hkv, d, b * s, q.dtype, worst_case=True)
            keys = int(kv_len.clamp(0, s).sum())
        else:
            keys = b * (s if kv_len is None else min(max(int(kv_len), 0), s))
        return cost(b, hq, hkv, d, keys, q.dtype)

    return run(kernel.name, call_cost, _launch, kernel, q, k, v, kv_len,
               return_partial, partial_f32, scale)


def _launch(kernel, q, k, v, kv_len, return_partial, partial_f32, scale):
    """(out, m, l): on meta their shapes alone, on CUDA one launch."""
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    dev = q.device
    out = torch.empty_like(q, dtype=torch.float32 if partial_f32 else q.dtype)
    m = torch.empty((b, hq, 1), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    if dev.type == "meta":
        return out, m, l
    lens, kv_all = None, s
    if isinstance(kv_len, torch.Tensor):
        lens = kv_len.to(torch.int32).contiguous()
    elif kv_len is not None:
        kv_all = min(max(int(kv_len), 0), s)

    group = hq // hkv
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tc = kernel is DECODE_ATTENTION_TC_KERNEL
    n_split, split_keys = (split_plan_tc if tc else split_plan)(b, hkv, s, sms)
    acc_part = torch.empty((b * hkv * n_split * group * d,), dtype=torch.float32,
                           device=dev)
    m_part = torch.empty((b * hkv * n_split * group,), dtype=torch.float32,
                         device=dev)
    l_part = torch.empty_like(m_part)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        kv = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
              None if lens is None else lens.data_ptr(), kv_all,
              acc_part.data_ptr(), m_part.data_ptr(), l_part.data_ptr())
        outs = (_counters(dev, stream, b * hkv).data_ptr(), out.data_ptr(),
                m.data_ptr(), l.data_ptr())
        # return_partial: 0 normalised, 1 the accumulator in q's dtype,
        # 2 the accumulator in fp32
        mode = 2 if partial_f32 else int(return_partial)
        shape = (b, hq, hkv, s, d, *k.stride()[:3], *v.stride()[:3], n_split,
                 split_keys, mode, scale, stream)
        if tc:
            kernel.launch(*kv, *outs, *shape)
        else:
            kernel.launch(*kv, *outs, _DTYPES[q.dtype], *shape)
    return out, m, l


def cost(b: int, hq: int, hkv: int, d: int, keys: int, dtype,
         worst_case: bool = False) -> KernelCost:
    """One call's cost over ``keys`` valid keys summed over the B
    sequences: q read, those K and V rows read once, out, m and l
    written once; QK^T and PV over them (2 FLOPs a multiply-add)."""
    elt = dtype.itemsize
    return KernelCost(flops=4 * d * hq * keys,
                      bytes=elt * (2 * b * hq * d + 2 * hkv * keys * d)
                      + 8 * b * hq, worst_case=worst_case)
