"""Mixture-of-Experts FFN with capacity dispatch (the single-device half
of the reference's ``models/moe.py``).

Routing: softmax top-k in float32 (grok-1: 8 experts top-2;
DeepSeek-V2-Lite: 64 experts top-6 + 2 shared experts).  Dispatch ranks
every (token, slot) assignment within its expert by a cumulative one-hot
count in flat (token, slot) order, as the reference does, so the same
assignments are dropped past capacity.

The combine is deterministic: kept rows are scattered into an
``(E, C, d)`` buffer at unique indices (no atomics), the expert SwiGLU
runs as batched matmuls, and each token's k weighted outputs are summed
in slot order over a ``(T, k, d)`` view (no ``index_add_``), so two runs
give the same bits.  So is the backward: a token's k copies are an
``expand``, whose gradient sums the k slots in order, and the expert
rows are read back through ``take_rows``, whose gradient sums the rows
that several assignments read (a dropped assignment reads its expert's
last row) in a fixed order.

The reference's ``moe_ffn_sharded`` (expert and tensor parallelism over
a mesh) is not ported: the model entry points raise for a ``mesh``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.embedding_bag import take_rows

from .layers import dense_init, mlp_apply, mlp_init

__all__ = ["MoEConfig", "moe_init", "moe_ffn", "moe_ffn_dense", "router_topk",
           "build_dispatch", "moe_capacity", "no_drop"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int                   # per-expert hidden
    n_shared: int = 0           # always-on shared experts (DeepSeek)
    capacity_factor: float = 1.25
    mlp_kind: str = "swiglu"


def moe_init(gen: torch.Generator, cfg: MoEConfig,
             dtype=torch.float32) -> Dict:
    """The router is float32 whatever ``dtype`` is, as the reference
    draws it; the experts are stacked ``(E, d, f)`` / ``(E, f, d)``."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    params = {
        "router": dense_init(gen, (d, e), dtype=torch.float32),
        "experts": {
            "w_gate": dense_init(gen, (e, d, f), dtype=dtype),
            "w_up": dense_init(gen, (e, d, f), dtype=dtype),
            "w_down": dense_init(gen, (e, f, d), dtype=dtype),
        },
    }
    if cfg.n_shared:
        params["shared"] = mlp_init(gen, d, f * cfg.n_shared, cfg.mlp_kind,
                                    dtype=dtype)
    return params


def moe_capacity(cfg: MoEConfig, n_tokens: int) -> int:
    """Rows per expert: max(8, int(capacity_factor * T * k / E))."""
    return max(8, int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts))


def no_drop(cfg: MoEConfig) -> MoEConfig:
    """``cfg`` with a capacity of at least T (capacity_factor (E + 1) / k):
    nothing drops, so a token's output does not depend on the other
    tokens of its call, and two calls that route different token counts
    (a prefill of S + 1 tokens, a decode step of B) compute the same
    function per token."""
    return dataclasses.replace(
        cfg, capacity_factor=(cfg.n_experts + 1) / cfg.top_k)


def router_topk(router_w: torch.Tensor, x: torch.Tensor, top_k: int):
    """x: (T, d) -> (weights (T, k) f32, experts (T, k) int64, aux ()).

    Ties go to the lower expert index first, as ``jax.lax.top_k`` puts
    them (a stable descending sort over the E gates); the k weights are
    renormalised with the reference's 1e-9 floor; aux is the Switch
    load-balance loss E * sum_e f_e * p_e."""
    logits = x.float() @ router_w.float()
    gates = torch.softmax(logits, dim=-1)                        # (T, E)
    w, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    w, idx = w[:, :top_k], idx[:, :top_k]
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    e = router_w.shape[1]
    f = _one_hot(idx.reshape(-1), e).sum(0).float() / idx.numel()
    aux = e * torch.sum(f * gates.mean(0))
    return w, idx, aux


def _one_hot(flat: torch.Tensor, n: int) -> torch.Tensor:
    """(N,) -> (N, n) int64.  ``F.one_hot`` and ``torch.bincount`` check
    their input's range on the host, a device sync each on CUDA; this
    compares instead, with no sync."""
    return (flat[:, None] == torch.arange(n, device=flat.device)).long()


def build_dispatch(idx: torch.Tensor, n_experts: int, capacity: int):
    """Rank each (token, slot) assignment within its expert, in flat
    (token, slot) order: (positions (T, k), keep = positions < capacity
    (T, k), counts (E,)), the reference's integers exactly."""
    t, k = idx.shape
    flat = idx.reshape(-1)
    onehot = _one_hot(flat, n_experts)                           # (T*k, E)
    ranks = torch.cumsum(onehot, dim=0) - onehot                 # rank before self
    pos = ranks.gather(1, flat[:, None])[:, 0]
    keep = pos < capacity
    return pos.reshape(t, k), keep.reshape(t, k), onehot.sum(0)


def moe_ffn(params: Dict, x: torch.Tensor, cfg: MoEConfig,
            capacity: Optional[int] = None):
    """x: (T, d) -> (out (T, d) in x's dtype, aux loss () f32)."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity or moe_capacity(cfg, t)

    w, idx, aux = router_topk(params["router"], x, k)
    pos, keep, _ = build_dispatch(idx, e, cap)

    # Kept rows go to row e * cap + pos of a flat buffer; dropped ones to
    # its spare last row, which is never read.  No host sync.
    flat_e, flat_pos, flat_keep = idx.reshape(-1), pos.reshape(-1), keep.reshape(-1)
    rows = torch.where(flat_keep, flat_e * cap + flat_pos, e * cap)
    buf = x.new_zeros((e * cap + 1, d))
    buf[rows] = x[:, None].expand(t, k, d).reshape(t * k, d)    # x[tok]
    buf = buf[:e * cap].view(e, cap, d)

    ex = params["experts"]
    h = F.silu(torch.bmm(buf, ex["w_gate"])) * torch.bmm(buf, ex["w_up"])
    y = torch.bmm(h, ex["w_down"]).view(e * cap, d)

    # A dropped assignment reads its expert's last row, weighted by 0.
    out_rows = take_rows(y, flat_e * cap + flat_pos.clamp(max=cap - 1))
    wflat = (w.reshape(-1) * flat_keep).to(x.dtype)
    out = (out_rows * wflat[:, None]).view(t, k, d).sum(1)

    if cfg.n_shared:
        out = out + mlp_apply(params["shared"], x, cfg.mlp_kind)
    return out, aux


def moe_ffn_dense(params: Dict, x: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """The same FFN written densely, to check ``moe_ffn`` by: every
    expert on every token, each token's gates zeroed outside its k
    largest (no sort, no dispatch, no capacity), renormalised, and the
    E outputs summed.  Equals ``moe_ffn`` where nothing drops."""
    t, d = x.shape
    gates = torch.softmax(x.float() @ params["router"].float(), dim=-1)
    kth = torch.topk(gates, cfg.top_k, dim=-1).values[:, -1:]
    g = torch.where(gates >= kth, gates, 0.0)
    g = g / g.sum(-1, keepdim=True).clamp_min(1e-9)
    ex = params["experts"]
    xe = x.expand(cfg.n_experts, t, d)
    h = F.silu(torch.bmm(xe, ex["w_gate"])) * torch.bmm(xe, ex["w_up"])
    y = torch.bmm(h, ex["w_down"])                               # (E, T, d)
    out = torch.einsum("te,etd->td", g.to(x.dtype), y)
    if cfg.n_shared:
        out = out + mlp_apply(params["shared"], x, cfg.mlp_kind)
    return out
