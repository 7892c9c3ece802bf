"""EmbeddingBag: the public wrapper of the hand-written CUDA kernel.

``embedding_bag`` replaces both of the reference's entry points: its
jnp ``embedding_bag``, which the recsys models call, and
``embedding_bag_kernel`` over the Pallas TPU kernel
``embedding_bag_pallas``; ``embedding_bag_kernel`` is kept as a second
name.  On CUDA tensors it launches one of the routes of
``csrc/embedding_bag.cu``, chosen by ``bag_route`` (bound by the bytes of
the random row reads, or at few bags by their latency: see the note
there); on CPU tensors it runs the plain version ``ref.py``; on ``meta``
tensors it returns the output's shape and computes nothing.  There is no
fallback from one to another.  Every meta or CUDA call reports ``cost``
to an active dry-run counter (``kernels/cost.py``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import cdiv
from repro_torch.kernels.cost import H100_SMS, KernelCost, run
from repro_torch.kernels.native import NativeKernel, csrc_define

from .backward import embedding_bag_backward
from .ref import embedding_bag_ref

__all__ = ["embedding_bag", "embedding_bag_kernel", "bag_route", "cost",
           "table_sectors",
           "EMBEDDING_BAG_KERNEL", "EMBEDDING_BAG_LANES_KERNEL"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MODES = {"sum": 0, "mean": 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
EMBEDDING_BAG_KERNEL = NativeKernel(
    name="embedding_bag",
    source="embedding_bag.cu",
    headers=("embedding_bag.cuh",),
    symbol="embedding_bag_launch",
    argtypes=[_P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _P, _P],
)
# The E = 1 column route adds this many ids of every bag a launch, the
# running sums waiting in a scratch tensor between launches.
PASS_IDS = csrc_define("embedding_bag.cuh", "EB_PASS_IDS")
# The E = 1 lane route: the same source, its own entry point and count.
EMBEDDING_BAG_LANES_KERNEL = NativeKernel(
    name="embedding_bag_lanes",
    source="embedding_bag.cu",
    headers=("embedding_bag.cuh",),
    symbol="embedding_bag_lanes_launch",
    argtypes=[_P, _P, _P, _P, _I, _L, _I, _I, _I, _P],
)
# The E = 1 lane route takes batches of up to this many bags per SM: at
# L = 40 on the H100 it is the faster route up to about here, the column
# route past it (chip_smoke.py phase 2 times both at 512 bags, at half,
# once and twice this edge and at 262,144; PERF.md).
LANE_BAGS_PER_SM = 192


def bag_route(b: int, e: int, sms: int) -> str:
    """The CUDA route for B bags of width E on a card with ``sms`` SMs:
    "warp" for E > 1 (``EMBEDDING_BAG_KERNEL``); for E = 1, "lanes" (a
    group of lanes per bag, ``EMBEDDING_BAG_LANES_KERNEL``) up to
    ``LANE_BAGS_PER_SM`` bags per SM, where one thread per bag would
    leave most SMs with few bags and each thread with ~L/8 dependent
    rounds of loads, and "column" (one thread per bag, ``PASS_IDS`` ids
    of every bag a launch, ``EMBEDDING_BAG_KERNEL``) past it, where every
    SM holds many bags in flight."""
    if e != 1:
        return "warp"
    return "lanes" if b <= LANE_BAGS_PER_SM * sms else "column"


def _check(table, indices, weights, mode):
    if mode not in _MODES:
        raise ValueError(f"mode {mode!r} unsupported (sum or mean)")
    if table.dim() != 2 or indices.dim() != 2:
        raise ValueError(f"want table (V, E) and indices (B, L); got "
                         f"{tuple(table.shape)}, {tuple(indices.shape)}")
    if table.dtype not in _DTYPES:
        raise ValueError(f"table dtype {table.dtype} unsupported (fp32 or bf16)")
    if indices.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"indices dtype {indices.dtype} unsupported")
    if weights is not None and weights.shape != indices.shape:
        raise ValueError(f"weights {tuple(weights.shape)} do not match "
                         f"indices {tuple(indices.shape)}")
    devices = {table.device, indices.device}
    if weights is not None:
        devices.add(weights.device)
    if len(devices) != 1:
        raise ValueError("table, indices and weights lie on different devices")


class _Bag(torch.autograd.Function):
    """The bag's forward (``_bag_forward``) and its fixed-order backward
    (``embedding_bag_backward``), which launches nothing."""

    @staticmethod
    def forward(ctx, table, indices, weights, mode):
        ctx.mode, ctx.n_rows = mode, table.shape[0]
        need_w = weights is not None and ctx.needs_input_grad[2]
        ctx.save_for_backward(indices, weights, table if need_w else None)
        return _bag_forward(table, indices, weights, mode)

    @staticmethod
    def backward(ctx, grad):
        indices, weights, table = ctx.saved_tensors
        grad_table, grad_w = embedding_bag_backward(
            grad, indices, weights, ctx.n_rows, ctx.mode, table=table)
        return grad_table, None, grad_w, None


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  weights: torch.Tensor | None = None, mode: str = "sum"
                  ) -> torch.Tensor:
    """table (V, E) fp32 or bf16, indices (B, L) int (-1 = padding),
    weights (B, L) fp32 or None → (B, E) in the table's dtype; fp32
    accumulation.  ``mode``: "sum", or "mean" (divided by the number of
    indices >= 0, at least 1).  An index at or past V makes its bag's row
    NaN, as in the reference (whose ``jnp.take`` fills NaN), and counts
    in the mean's divisor; the kernels never read outside the table.  On
    CUDA the indices must be int32 and every tensor contiguous; the route
    is ``bag_route``'s.  Differentiable in the table and the weights
    (``embedding_bag_backward``)."""
    _check(table, indices, weights, mode)
    return _Bag.apply(table, indices, weights, mode)


def _bag_forward(table, indices, weights, mode):
    """The plain version on the CPU, one kernel route on CUDA, the
    output's shape alone on meta."""
    if table.device.type == "cpu":
        return embedding_bag_ref(table, indices, weights, mode=mode)
    if table.device.type not in ("cuda", "meta"):
        raise ValueError(f"unsupported device {table.device}")
    if indices.dtype != torch.int32:
        raise ValueError("indices must be int32 on CUDA")
    if weights is not None and weights.dtype != torch.float32:
        raise ValueError("weights must be float32")
    if not (table.is_contiguous() and indices.is_contiguous()
            and (weights is None or weights.is_contiguous())):
        raise ValueError("table, indices and weights must be contiguous")
    (v, e), (b, l) = table.shape, indices.shape
    sms = (H100_SMS if table.device.type == "meta" else
           torch.cuda.get_device_properties(table.device).multi_processor_count)
    route = bag_route(b, e, sms)
    kernel = EMBEDDING_BAG_LANES_KERNEL if route == "lanes" else EMBEDDING_BAG_KERNEL
    return run(kernel.name, lambda: cost(table, indices, weights is not None),
               _launch, kernel, table, indices, weights, mode)


def _launch(kernel, table, indices, weights, mode):
    (v, e), (b, l) = table.shape, indices.shape
    out = torch.empty((b, e), dtype=table.dtype, device=table.device)
    if b == 0 or e == 0 or table.device.type == "meta":
        return out
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        if kernel is EMBEDDING_BAG_LANES_KERNEL:
            kernel.launch(
                table.data_ptr(), indices.data_ptr(),
                None if weights is None else weights.data_ptr(),
                out.data_ptr(), _DTYPES[table.dtype], v, b, l, _MODES[mode],
                stream)
            return out
        # the column route's running sums, counts and ids past the table
        run_sums = (torch.empty(3 * b, dtype=torch.int32, device=table.device)
                    if e == 1 and cdiv(l, PASS_IDS) > 1 else None)
        kernel.launch(
            table.data_ptr(), indices.data_ptr(),
            None if weights is None else weights.data_ptr(), out.data_ptr(),
            _DTYPES[table.dtype], v, b, l, e, _MODES[mode],
            None if run_sums is None else run_sums.data_ptr(), stream)
    return out


def table_sectors(table: torch.Tensor, indices: torch.Tensor) -> tuple[int, bool]:
    """(the 32-byte sectors of the table that the indices inside it touch,
    each once: rows that share a sector share its read; whether that is
    the worst case).  From the ids on a real device; on meta, where they
    cannot be read, every id a row of its own that touches as many
    sectors as a row can, at most the whole table."""
    v, e = table.shape
    row_bytes = e * table.element_size()
    if indices.device.type == "meta":
        span = cdiv(row_bytes, 32)
        if row_bytes and 32 % row_bytes and row_bytes % 32:
            span += 1                      # a row can straddle a boundary
        return min(indices.numel() * span, cdiv(v * row_bytes, 32)), True
    rows = torch.unique(indices[(indices >= 0) & (indices < v)].long())
    first = rows * row_bytes // 32
    last = ((rows + 1) * row_bytes - 1) // 32
    span = int((last - first).max()) + 1 if rows.numel() else 0
    sectors = (first[:, None] + torch.arange(span, device=indices.device)[None])
    return int(torch.unique(sectors[sectors <= last[:, None]]).numel()), False


def cost(table: torch.Tensor, indices: torch.Tensor, weighted: bool) -> KernelCost:
    """One call's cost: every sector of ``table_sectors`` read once, the
    indices (and weights) read once, the output written once; one
    multiply-add per (index, column)."""
    v, e = table.shape
    b, l = indices.shape
    sectors, worst = table_sectors(table, indices)
    return KernelCost(flops=2 * b * l * e,
                      bytes=32 * sectors + 4 * b * l * (2 if weighted else 1)
                      + b * e * table.element_size(), worst_case=worst)


embedding_bag_kernel = embedding_bag
