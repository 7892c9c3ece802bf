"""Plain PyTorch version of the segment gather-sum.

The same function as ``csrc/segment_gather.cu``: for each segment r of
the CSR (``idx`` grouped by segment, ``ptr`` its bounds),
``scale[r] * sum of x[idx[e]]`` over e in [ptr[r], ptr[r+1]), an id
outside [0, N) adding nothing.  It materialises the (E, d) rows and adds
them with ``index_add_``: on the CPU, one row after another in e's
order, as the kernel adds them, so the two give the same bits.  The CPU
path of the GNN, the CPU tests and ``chip_smoke.py``'s check use it; the
wrapper takes it only for CPU tensors.
"""
from __future__ import annotations

import torch

__all__ = ["segment_gather_sum_ref"]


def segment_gather_sum_ref(x: torch.Tensor, idx: torch.Tensor,
                           ptr: torch.Tensor, scale=None) -> torch.Tensor:
    """x (N, d) fp32, idx (E,) int, ptr (R + 1,) int64, scale (R,) fp32 or
    None → (R, d) fp32."""
    n, d = x.shape
    r = ptr.numel() - 1
    e = int(ptr[-1])
    out = torch.zeros((r, d), dtype=torch.float32, device=x.device)
    if e and n:
        ids = idx[:e].long()
        seg = torch.repeat_interleave(torch.arange(r, device=x.device),
                                      ptr.diff(), output_size=e)
        valid = (ids >= 0) & (ids < n)
        rows = torch.where(valid[:, None], x[ids.clamp(0, n - 1)].float(), 0.0)
        out.index_add_(0, seg, rows)
    if scale is not None:
        out = out * scale[:, None]
    return out
