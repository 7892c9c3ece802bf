"""Plain PyTorch version of flash attention (GQA + causal).

The same function as the CUDA kernel (``csrc/flash_attention.cu``),
written as the reference's oracle ``attention_ref`` is: the whole
(Sq, Skv) score matrix in float32, a masked softmax, one product with V.
The CPU tests and ``chip_smoke.py``'s comparison use it; the wrapper
takes it only for CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import NEG_INF

__all__ = ["attention_ref"]


def attention_ref(q, k, v, *, causal: bool = True, scale: float | None = None):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D) → (B, Hq, Sq, D), fp32
    math.  Causal rows see keys up to their own position plus Skv - Sq;
    a row that sees no key gives 0."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    group = hq // hkv
    scale = (d ** -0.5) if scale is None else scale

    kx = k.repeat_interleave(group, dim=1).float()
    vx = v.repeat_interleave(group, dim=1).float()
    # In place on the one (B, Hq, Sq, Skv) buffer: at the LM path's shape
    # it is 17 GB.
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kx).mul_(scale)
    if causal:
        mask = torch.ones((sq, skv), dtype=torch.bool,
                          device=q.device).tril(diagonal=skv - sq)
        s.masked_fill_(~mask, NEG_INF)
    masked = ~torch.isfinite(s)
    s.sub_(s.amax(dim=-1, keepdim=True)).exp_().masked_fill_(masked, 0.0)
    s.div_(s.sum(dim=-1, keepdim=True).clamp_min(1e-30))
    o = torch.einsum("bhqk,bhkd->bhqd", s, vx)
    return o.to(q.dtype)
