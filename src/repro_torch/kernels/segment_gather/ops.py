"""Segment gather-sum: the public wrapper of the hand-written CUDA kernel
``csrc/segment_gather.cu``, the CSR it runs over, and the GNN's mean
aggregation as an autograd function over it.

The kernel replaces no TPU kernel: the reference's aggregation is
``jnp.take`` then ``jax.ops.segment_sum`` (``models/gnn.py``
``_aggregate``), which XLA fuses.  Here one kernel computes it without
the (E, d) messages, in a fixed order (see the source's note), and its
backward is the same kernel over the transposed CSR.  On CUDA tensors
``segment_gather_sum`` launches the kernel; on CPU tensors it runs the
plain version ``ref.py``; on ``meta`` tensors it returns the output's
shape and computes nothing.  There is no fallback from one to the
other.  Every meta or CUDA call reports ``cost`` to an active dry-run
counter (``kernels/cost.py``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.cost import KernelCost, run
from repro_torch.kernels.native import NativeKernel

from .ref import segment_gather_sum_ref

__all__ = ["SEGMENT_GATHER_KERNEL", "SegmentCSR", "cost", "segment_gather_sum",
           "segment_mean", "segment_sum"]

_P, _L = ctypes.c_void_p, ctypes.c_int64
SEGMENT_GATHER_KERNEL = NativeKernel(
    name="segment_gather",
    source="segment_gather.cu",
    headers=("segment_gather.cuh",),
    symbol="segment_gather_launch",
    argtypes=[_P, _P, _P, _P, _P, _L, _L, _L, _P, _P],
)


def _check(x, idx, ptr, scale):
    if x.dim() != 2 or idx.dim() != 1 or ptr.dim() != 1 or ptr.numel() < 1:
        raise ValueError(f"want x (N, d), idx (E,), ptr (R + 1,); got "
                         f"{tuple(x.shape)}, {tuple(idx.shape)}, "
                         f"{tuple(ptr.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"x dtype {x.dtype} unsupported (float32)")
    if idx.dtype != torch.int32 or ptr.dtype != torch.int64:
        raise ValueError(f"want idx int32 and ptr int64; got {idx.dtype}, "
                         f"{ptr.dtype}")
    if scale is not None and (scale.dtype != torch.float32
                              or scale.shape != (ptr.numel() - 1,)):
        raise ValueError(f"want scale ({ptr.numel() - 1},) float32; got "
                         f"{tuple(scale.shape)} {scale.dtype}")
    devices = {x.device, idx.device, ptr.device}
    if scale is not None:
        devices.add(scale.device)
    if len(devices) != 1:
        raise ValueError("x, idx, ptr and scale lie on different devices")


def segment_gather_sum(x: torch.Tensor, idx: torch.Tensor, ptr: torch.Tensor,
                       scale: torch.Tensor | None = None) -> torch.Tensor:
    """x (N, d) fp32, idx (E,) int32 grouped by segment, ptr (R + 1,)
    int64, scale (R,) fp32 or None → (R, d) fp32:
    ``out[r] = scale[r] * sum_{e in [ptr[r], ptr[r+1])} x[idx[e]]``,
    summed in e's order in fp32; an id outside [0, N) adds nothing (the
    GNN's zero dummy row).  ptr must rise from 0 to at most E.  On CUDA
    every tensor must be contiguous.  Not differentiable itself:
    ``segment_mean`` is."""
    _check(x, idx, ptr, scale)
    if x.device.type == "cpu":
        return segment_gather_sum_ref(x, idx, ptr, scale)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {x.device}")
    if not all(t is None or t.is_contiguous() for t in (x, idx, ptr, scale)):
        raise ValueError("x, idx, ptr and scale must be contiguous")
    return run(SEGMENT_GATHER_KERNEL.name, lambda: cost(x, idx, ptr, scale),
               _launch, x, idx, ptr, scale)


def _launch(x, idx, ptr, scale):
    (n, d), r = x.shape, ptr.numel() - 1
    out = torch.empty((r, d), dtype=torch.float32, device=x.device)
    if r == 0 or d == 0 or x.device.type == "meta":
        return out
    # the kernel's work ticket, zeroed by the launch on the stream
    ticket = torch.empty(1, dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        SEGMENT_GATHER_KERNEL.launch(
            x.data_ptr(), idx.data_ptr(), ptr.data_ptr(),
            None if scale is None else scale.data_ptr(), out.data_ptr(),
            n, d, r, ticket.data_ptr(), torch.cuda.current_stream().cuda_stream)
    return out


def cost(x: torch.Tensor, idx: torch.Tensor, ptr: torch.Tensor,
         scale: torch.Tensor | None) -> KernelCost:
    """One call's cost over the E = ptr[R] edges in a segment: x read
    once, their ids, ptr and scale read once, the (R, d) output written
    once, the 4-byte work ticket written once; one add per (edge,
    column).  On meta, where ptr cannot be read, E is every id of
    ``idx`` (the worst case)."""
    (n, d), r = x.shape, ptr.numel() - 1
    worst = ptr.device.type == "meta"
    e = idx.numel() if worst else int(ptr[-1])
    return KernelCost(flops=e * d,
                      bytes=4 * n * d + 4 * e + 8 * (r + 1)
                      + (0 if scale is None else 4 * r) + 4 * r * d + 4,
                      worst_case=worst)


def _group(keys: torch.Tensor, vals: torch.Tensor, n_seg: int):
    """(idx int32, ptr int64): ``vals`` grouped by ``keys`` in [0,
    n_seg), in their order within a group (a stable sort); a key outside
    that range goes past ptr[n_seg], so its value is in no segment."""
    keys = keys.long()
    keys = torch.where((keys >= 0) & (keys < n_seg), keys, n_seg)
    sorted_keys, order = torch.sort(keys, stable=True)
    idx = vals[order].to(torch.int32)
    ptr = torch.searchsorted(
        sorted_keys, torch.arange(n_seg + 1, device=keys.device))
    return idx, ptr


class SegmentCSR:
    """The edges src → dst of a bipartite layer (``n_src`` source rows,
    ``n_dst`` segments), grouped for the gather-sum: ``idx``/``ptr`` by
    dst (each segment's srcs in edge order) and ``scale`` = 1 / max(deg,
    1), where deg counts every edge whose dst lies in [0, n_dst), a
    dummy src (== n_src, a zero row) included; an edge with another dst
    (the dummy n_dst) is in no segment.  ``transposed()`` groups the same
    edges by src for the backward (built once, on first use).  Only ids,
    permutations and scale are kept, never an (E, d) tensor."""

    def __init__(self, src: torch.Tensor, dst: torch.Tensor, n_src: int,
                 n_dst: int):
        self.n_src, self.n_dst = n_src, n_dst
        dst = dst.long()
        self._src = src
        self._dst = torch.where((dst >= 0) & (dst < n_dst), dst, n_dst)
        self.idx, self.ptr = _group(self._dst, src, n_dst)
        deg = self.ptr.diff()
        self.scale = 1.0 / deg.clamp_min(1).to(torch.float32)
        self._transposed = None

    def transposed(self):
        """(idx, ptr) over the n_src sources: each source's dsts in edge
        order; a dummy src is in no segment, a dropped edge's dst is
        n_dst (outside the gradient's rows, so it adds nothing)."""
        if self._transposed is None:
            self._transposed = _group(self._src, self._dst, self.n_src)
        return self._transposed


class _SegmentGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, csr, mean):
        ctx.csr, ctx.mean = csr, mean
        return segment_gather_sum(x.contiguous(), csr.idx, csr.ptr,
                                  csr.scale if mean else None)

    @staticmethod
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        csr = ctx.csr
        idx, ptr = csr.transposed()
        g = (grad * csr.scale[:, None]) if ctx.mean else grad
        return segment_gather_sum(g.contiguous(), idx, ptr), None, None


def segment_mean(x: torch.Tensor, csr: SegmentCSR) -> torch.Tensor:
    """The mean over each dst segment of x's src rows (n_dst, d): one
    gather-sum launch on CUDA; its gradient is one launch over the
    transposed CSR, on grad * scale."""
    return _SegmentGather.apply(x, csr, True)


def segment_sum(x: torch.Tensor, csr: SegmentCSR) -> torch.Tensor:
    """The sum over each dst segment of x's src rows (n_dst, d), with
    the gradient of ``segment_mean``'s form (one launch each way): the
    partial that an edge-sharded mean adds up over the ranks before it
    divides by the degrees."""
    return _SegmentGather.apply(x, csr, False)
