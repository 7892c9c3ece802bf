"""Plain PyTorch version of decode attention, and the partials merge.

The same functions as the reference's oracle (``decode_attention_ref``
and ``merge_partials_ref``), in float32.  One difference in reach, not
in result: ``kv_len`` may also be a (B,) integer tensor, one length per
sequence, which the LM decode path needs; an int or None means the same
length for every row, as in the reference.  The CPU tests and
``chip_smoke.py``'s comparison use it; the wrapper takes it only for
CPU tensors.
"""
from __future__ import annotations

import torch

__all__ = ["decode_attention_ref", "merge_partials_ref"]


def _finite_or_zero(m: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def decode_attention_ref(q, k, v, *, scale=None, kv_len=None,
                         return_partial: bool = False,
                         partial_f32: bool = False):
    """q: (B, Hq, D); k, v: (B, Hkv, S, D) → (out (B, Hq, D) in q's
    dtype, m (B, Hq, 1) f32, l (B, Hq, 1) f32).  Keys at or past
    ``kv_len`` are masked; a row with no valid key gives out 0,
    m = -inf, l = 0.  With ``return_partial`` ``out`` is the
    unnormalised accumulator, float32 with ``partial_f32``."""
    b, hq, d = q.shape
    _, hkv, s, _ = k.shape
    group = hq // hkv
    scale = (d ** -0.5) if scale is None else scale
    kv_len = s if kv_len is None else kv_len

    kx = k.repeat_interleave(group, dim=1).float()
    vx = v.repeat_interleave(group, dim=1).float()
    sc = torch.einsum("bhd,bhkd->bhk", q.float(), kx) * scale
    keys = torch.arange(s, device=q.device)
    if isinstance(kv_len, torch.Tensor):
        mask = keys[None, None] < kv_len.to(q.device).reshape(b, 1, 1)
    else:
        mask = (keys < kv_len)[None, None]
    sc = sc.masked_fill(~mask, float("-inf"))

    m = sc.amax(dim=-1, keepdim=True)
    p = torch.where(torch.isfinite(sc), torch.exp(sc - _finite_or_zero(m)),
                    torch.zeros_like(sc))
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhk,bhkd->bhd", p, vx)
    if return_partial:
        return (acc if partial_f32 else acc.to(q.dtype)), m, l
    return (acc / l.clamp_min(1e-30)).to(q.dtype), m, l


def merge_partials_ref(accs, ms, ls):
    """Merge per-shard partials: lists of (B, H, D), (B, H, 1), (B, H, 1)
    → (B, H, D) in the accumulators' dtype."""
    m_all = torch.stack(ms).amax(dim=0)
    m_safe = _finite_or_zero(m_all)

    def weight(m):
        return torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                           torch.zeros_like(m))

    l_tot = sum(l * weight(m) for m, l in zip(ms, ls))
    acc_tot = sum(a.float() * weight(m) for a, m in zip(accs, ms))
    return (acc_tot / l_tot.clamp_min(1e-30)).to(accs[0].dtype)
