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

``moe_ffn_sharded`` is the reference's FFN over a mesh, expert or
tensor parallel over ``model`` with explicit ``torch.distributed``
collectives (``distributed/collectives.py``); ``moe_ffn_local`` is its
body on one rank's blocks, which the transformer's mesh path calls
inside its Megatron blocks (``models/transformer.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.embedding_bag import take_rows
from repro_torch.train.tree import tree_map

from .layers import dense_init, mlp_apply, mlp_init

__all__ = ["MoEConfig", "moe_init", "moe_ffn", "moe_ffn_sharded",
           "moe_ffn_local", "expert_specs",
           "moe_ffn_dense", "router_topk", "build_dispatch", "moe_capacity",
           "no_drop"]


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
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity or moe_capacity(cfg, x.shape[0])

    w, idx, aux = router_topk(params["router"], x, k)
    pos, keep, _ = build_dispatch(idx, e, cap)
    out = _experts_combine(params["experts"], x, w, idx, pos, keep, e, cap)
    if cfg.n_shared:
        out = out + mlp_apply(params["shared"], x, cfg.mlp_kind)
    return out, aux


def _experts_combine(ex: Dict, x: torch.Tensor, w, idx, pos, keep, n_e: int,
                     cap: int) -> torch.Tensor:
    """The routed FFN of (T, d) tokens over ``n_e`` stacked experts: each
    kept (token, slot) assignment's row into an (n_e, cap, d) buffer, the
    SwiGLU as batched matmuls, and each token's k weighted outputs summed
    in slot order.  An assignment routed to ``n_e`` (the sharded FFN's
    drop bucket) is never kept."""
    t, d = x.shape
    k = idx.shape[1]
    # Kept rows go to row e * cap + pos of a flat buffer; dropped ones to
    # its spare last row, which is never read.  No host sync.
    flat_e, flat_pos, flat_keep = idx.reshape(-1), pos.reshape(-1), keep.reshape(-1)
    rows = torch.where(flat_keep, flat_e * cap + flat_pos, n_e * cap)
    buf = x.new_zeros((n_e * cap + 1, d))
    buf[rows] = x[:, None].expand(t, k, d).reshape(t * k, d)    # x[tok]
    buf = buf[:n_e * cap].view(n_e, cap, d)

    h = F.silu(torch.bmm(buf, ex["w_gate"])) * torch.bmm(buf, ex["w_up"])
    y = torch.bmm(h, ex["w_down"]).view(n_e * cap, d)

    # A dropped assignment reads its expert's (or the last expert's) last
    # row, weighted by 0.
    out_rows = take_rows(y, flat_e.clamp(max=n_e - 1) * cap
                         + flat_pos.clamp(max=cap - 1))
    wflat = (w.reshape(-1) * flat_keep).to(x.dtype)
    return (out_rows * wflat[:, None]).view(t, k, d).sum(1)


def moe_ffn_sharded(params: Dict, x, cfg: MoEConfig, mesh,
                    model_axis: str = "model", data_axes=("data",),
                    fsdp: bool = False):
    """The MoE FFN over a mesh: tokens sharded over the data axes and
    replicated along ``model`` (they are, between Megatron blocks); one
    ``psum`` over ``model`` combines the expert outputs, no all-to-all.
    ``params`` and ``x`` are DTensors or global tensors; returns (out, a
    DTensor sharded like x; aux, this data shard's mean over ``model``,
    as a replicated DTensor: the reference's out spec ``P()``).

    Two regimes on the ``model`` axis:
      EP (E % M == 0): each rank owns E/M whole experts; routing is
          global (the router replicated), and the assignments to other
          ranks' experts go to a drop bucket;
      TP (otherwise, d_ff % M == 0; grok-1's 8 experts on a 16-way
          axis): every rank holds a 1/M slice of every expert's d_ff and
          dispatches alike; the psum also joins the ff partial sums.
    With ``fsdp`` (and a ``data`` axis) the expert bulk is also sharded
    over ``data`` on d_model and all-gathered inside (ZeRO-3)."""
    from repro_torch.distributed.collectives import (pmean, psum, shard_in,
                                                     shard_out)
    from repro_torch.distributed.sharding_rules import P

    ex_specs = expert_specs(cfg, mesh, model_axis, fsdp)
    p = {name: (tree_map(lambda a, s: shard_in(a, mesh, s), sub, ex_specs)
                if name == "experts"
                else tree_map(lambda a: shard_in(a, mesh, P()), sub))
         for name, sub in params.items()}
    xspec = P(data_axes) if data_axes else P()
    x_l = shard_in(x, mesh, xspec)
    out, aux = moe_ffn_local(p, x_l, cfg, mesh, model_axis, fsdp)
    out = psum(out, mesh, model_axis)
    if cfg.n_shared:
        out = out + mlp_apply(p["shared"], x_l, cfg.mlp_kind)
    return (shard_out(out, mesh, xspec),
            shard_out(pmean(aux, mesh, model_axis), mesh, P()))


def expert_specs(cfg: MoEConfig, mesh, model_axis: str = "model",
                 fsdp: bool = False) -> Dict:
    """The per-layer specs of the stacked experts on ``mesh``: EP where E
    divides the ``model`` axis, else TP over d_ff (which must divide);
    with ``fsdp`` (and a ``data`` axis) d_model also over ``data``."""
    from repro_torch.distributed.sharding_rules import P, mesh_shape

    shape = mesh_shape(mesh)
    n_shards = shape[model_axis]
    d_ax = "data" if fsdp and "data" in shape else None
    if cfg.n_experts % n_shards == 0:
        return {"w_gate": P(model_axis, d_ax, None),
                "w_up": P(model_axis, d_ax, None),
                "w_down": P(model_axis, None, d_ax)}
    if cfg.d_ff % n_shards:
        raise ValueError(f"need E % M == 0 or d_ff % M == 0; E = "
                         f"{cfg.n_experts}, d_ff = {cfg.d_ff}, M = {n_shards}")
    return {"w_gate": P(None, d_ax, model_axis),
            "w_up": P(None, d_ax, model_axis),
            "w_down": P(None, model_axis, d_ax)}


def moe_ffn_local(p: Dict, x_l: torch.Tensor, cfg: MoEConfig, mesh,
                  model_axis: str = "model", fsdp: bool = False):
    """One rank's routed FFN on its (T, d) tokens, the body of
    ``moe_ffn_sharded``: ``p`` holds this rank's expert blocks (laid
    out by ``expert_specs``) and the whole router.  Returns (this rank's
    partial output, which a sum over ``model`` completes; the aux loss
    of these tokens).  The capacity is that of the T tokens here."""
    from repro_torch.distributed.collectives import all_gather, axis_index
    from repro_torch.distributed.sharding_rules import mesh_shape

    n_shards = mesh_shape(mesh)[model_axis]
    ep = cfg.n_experts % n_shards == 0
    ex = p["experts"]
    if fsdp and "data" in mesh_shape(mesh):
        # ZeRO-3 for the expert bulk: gather the `data`-sharded slice
        # here; its gradient reduce-scatters back
        ex = {"w_gate": all_gather(ex["w_gate"], mesh, "data", 1),
              "w_up": all_gather(ex["w_up"], mesh, "data", 1),
              "w_down": all_gather(ex["w_down"], mesh, "data", 2)}
    cap = moe_capacity(cfg, x_l.shape[0])
    w, idx, aux = router_topk(p["router"], x_l, cfg.top_k)
    if ep:
        e_local = cfg.n_experts // n_shards
        lo = axis_index(mesh, model_axis) * e_local
        local = (idx >= lo) & (idx < lo + e_local)
        idx = torch.where(local, idx - lo, e_local)   # e_local = drop bucket
        pos, keep, _ = build_dispatch(idx, e_local + 1, cap)
        out = _experts_combine(ex, x_l, w, idx, pos, keep & local, e_local, cap)
    else:
        pos, keep, _ = build_dispatch(idx, cfg.n_experts, cap)
        out = _experts_combine(ex, x_l, w, idx, pos, keep, cfg.n_experts, cap)
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
