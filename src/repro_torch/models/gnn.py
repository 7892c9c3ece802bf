"""GraphSAGE (mean aggregator): full-graph, sampled-minibatch and
batched-small-graph execution (the reference's ``models/gnn.py``).

Message passing over an edge index:
    agg[dst] = Σ_{(src,dst)∈E} h[src] / deg[dst]
    h'       = ReLU(h · W_self + agg · W_neigh + b)

The mean aggregation runs through the segment gather-sum kernel
(``kernels/segment_gather``): the edges are grouped by dst inside the
step (edges are step arguments), the kernel sums each segment's rows in
edge order without materialising the (E, d) messages, and its gradient
is the same kernel over the edges grouped by src.  On the CPU the kernel
is its plain version.  The max aggregator, which no config uses, is
plain torch on both devices.

On a ``mesh`` (``mesh=`` of the forwards) the edges passed are this
rank's share (the reference's ``P(None, all axes)``) and the node states
are whole on every rank.  The mean's partial sums (``segment_sum``,
the kernel) and degrees over the rank's edges are added over every
axis, the sums in rank order (``collectives.psum_ordered``), and the
sum is scaled once by 1 / degree: a mean of sums, never a mean of
means.  The
backward is the kernel over the rank's edges grouped by src, its
partials added in rank order where the states enter the aggregation
(``copy_to(ordered=True)``).  The max takes the all-reduce MAX of the
ranks' segment maxima, its gradient split evenly over the tied
messages of every rank, as ``jax.ops.segment_max`` splits it.  The
forwards take whole parameters: a train step on a mesh gathers the
column blocks of ``gnn_param_specs`` first (``launch/steps.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import seeded_generator
from repro_torch.kernels.segment_gather import (SegmentCSR, segment_mean,
                                                segment_sum)

from .layers import dense_init

__all__ = ["SAGEConfig", "sage_init", "sage_full_forward", "sage_block_forward",
           "sage_graph_forward", "sample_blocks", "Block"]


@dataclasses.dataclass(frozen=True)
class SAGEConfig:
    d_in: int
    d_hidden: int
    n_classes: int
    n_layers: int = 2
    aggregator: str = "mean"
    normalize: bool = True        # L2-normalize layer outputs (paper §3.1)


def sage_init(cfg: SAGEConfig, seed: int = 0, device=None,
              dtype=torch.float32, gen: torch.Generator | None = None) -> Dict:
    """Random parameters drawn from ``gen`` (default: one seeded with
    ``seed`` on ``device``), layer by layer: w_self, w_neigh, then a zero
    b."""
    gen = seeded_generator(seed, device) if gen is None else gen
    params = {}
    dims = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    for l in range(cfg.n_layers):
        params[f"layer_{l}"] = {
            "w_self": dense_init(gen, (dims[l], dims[l + 1]), dtype=dtype),
            "w_neigh": dense_init(gen, (dims[l], dims[l + 1]), dtype=dtype),
            "b": torch.zeros((dims[l + 1],), dtype=dtype, device=gen.device),
        }
    return params


def _aggregate(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
               n_dst: int, aggregator: str, csr: SegmentCSR | None = None,
               mesh=None) -> torch.Tensor:
    """Padding convention: src == h.shape[0] is a zero dummy row; dst ==
    n_dst is a dummy segment — both let edge arrays pad to fixed lengths
    without distorting the mean.  ``csr``: the edges already grouped
    (``SegmentCSR(src, dst, h.shape[0], n_dst)``), shared by layers over
    the same edges.  On a ``mesh``: this rank's edges of a sharded
    aggregation (the module's note)."""
    if mesh is not None:
        return _aggregate_sharded(h, src, dst, n_dst, aggregator, csr, mesh)
    if aggregator == "mean":
        if csr is None:
            csr = SegmentCSR(src, dst, h.shape[0], n_dst)
        return segment_mean(h, csr)
    if aggregator == "max":
        hd = torch.cat([h, h.new_zeros((1, h.shape[1]))], dim=0)
        msgs = hd[src.long()]
        seg = dst.long().clamp(0, n_dst)
        out = torch.full((n_dst + 1, h.shape[1]), float("-inf"), dtype=h.dtype,
                         device=h.device)
        out = out.scatter_reduce(0, seg[:, None].expand_as(msgs), msgs, "amax",
                                 include_self=True)
        return out[:n_dst]
    raise ValueError(aggregator)


def _aggregate_sharded(h, src, dst, n_dst: int, aggregator: str,
                       csr: SegmentCSR | None, mesh) -> torch.Tensor:
    import torch.distributed as dist

    from repro_torch.distributed.collectives import copy_to, psum_ordered

    axes = tuple(mesh.mesh_dim_names)
    h_in = copy_to(h, mesh, axes, ordered=True)
    if aggregator == "max":
        return _SegmentMaxSharded.apply(h_in, src, dst, n_dst, mesh)
    if aggregator != "mean":
        raise ValueError(aggregator)
    if csr is None:
        csr = SegmentCSR(src, dst, h.shape[0], n_dst)
    total = psum_ordered(segment_sum(h_in, csr), mesh, axes)
    deg = csr.ptr.diff()
    for a in axes:                             # integers: exact in any order
        dist.all_reduce(deg, group=mesh.get_group(a))
    # SegmentCSR's scale, 1 / max(deg, 1), as the unsharded kernel applies
    # it: one rank gives segment_mean's bits
    return total * (1.0 / deg.clamp_min(1).to(torch.float32))[:, None]


class _SegmentMaxSharded(torch.autograd.Function):
    """The segment max over every rank's edges: this rank's maxima of its
    messages (-inf where it has none), the all-reduce MAX over the mesh;
    the gradient of a segment's maximum split evenly over the messages
    equal to it, on every rank (their count summed over the mesh)."""

    @staticmethod
    def forward(ctx, h, src, dst, n_dst, mesh):
        import torch.distributed as dist

        hd = torch.cat([h, h.new_zeros((1, h.shape[1]))], dim=0)
        msgs = hd[src.long()]
        seg = dst.long().clamp(0, n_dst)[:, None].expand_as(msgs)
        out = torch.full((n_dst + 1, h.shape[1]), float("-inf"), dtype=h.dtype,
                         device=h.device)
        out = out.scatter_reduce(0, seg, msgs, "amax", include_self=True)
        groups = [mesh.get_group(a) for a in mesh.mesh_dim_names]
        for g in groups:
            dist.all_reduce(out, op=dist.ReduceOp.MAX, group=g)
        hit = (msgs == out.gather(0, seg)) & (seg < n_dst)
        count = torch.zeros_like(out).scatter_add_(0, seg, hit.to(out.dtype))
        for g in groups:                       # small integers: exact
            dist.all_reduce(count, group=g)
        ctx.save_for_backward(src, seg, hit, count)
        ctx.n_src = h.shape[0]
        return out[:n_dst]

    @staticmethod
    def backward(ctx, grad):
        src, seg, hit, count = ctx.saved_tensors
        g = torch.cat([grad, grad.new_zeros((1, grad.shape[1]))], dim=0)
        share = (g / count.clamp_min(1)).gather(0, seg) * hit
        out = grad.new_zeros((ctx.n_src + 1, grad.shape[1]))
        out.index_add_(0, src.long(), share)
        return out[:ctx.n_src], None, None, None, None


def _layer(lp: Dict, h_self: torch.Tensor, agg: torch.Tensor, last: bool,
           normalize: bool) -> torch.Tensor:
    out = h_self @ lp["w_self"] + agg @ lp["w_neigh"] + lp["b"]
    if not last:
        out = torch.relu(out)
        if normalize:
            norm = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
            out = out / torch.clamp(norm, min=1e-6)
    return out


def sage_full_forward(params: Dict, cfg: SAGEConfig, feats: torch.Tensor,
                      edges: torch.Tensor, mesh=None) -> torch.Tensor:
    """Full-batch: feats (N, d_in), edges (2, E) src→dst (on a ``mesh``,
    this rank's share). Returns logits (N, C).  The edges are grouped
    once for every layer."""
    h = feats
    n = feats.shape[0]
    csr = (SegmentCSR(edges[0], edges[1], n, n)
           if cfg.aggregator == "mean" else None)
    for l in range(cfg.n_layers):
        agg = _aggregate(h, edges[0], edges[1], n, cfg.aggregator, csr=csr,
                         mesh=mesh)
        h = _layer(params[f"layer_{l}"], h, agg, last=(l == cfg.n_layers - 1),
                   normalize=cfg.normalize)
    return h


# -------------------------------------------------------- sampled minibatch
@dataclasses.dataclass
class Block:
    """One bipartite sampled layer: frontier srcs → the first n_dst
    nodes of the frontier (standard DGL-style layout)."""
    src: np.ndarray   # (E,) indices into the current frontier
    dst: np.ndarray   # (E,) in [0, n_dst)
    n_dst: int


def sample_blocks(indptr: np.ndarray, nbrs: np.ndarray, seeds: np.ndarray,
                  fanouts: Sequence[int], rng: np.random.Generator
                  ) -> Tuple[np.ndarray, List[Block]]:
    """Neighbor sampler (host-side, CSR graph), the reference's own: the
    same ``rng`` gives the same frontier and blocks.

    Returns (input_node_ids, blocks ordered for forward: blocks[l]
    consumed by layer l).  Frontier layout: frontier of layer l = [dst
    nodes (=next frontier)] ++ [sampled neighbors].
    """
    blocks: List[Block] = []
    frontier = np.asarray(seeds, np.int64)
    for fanout in reversed(fanouts):
        srcs, dsts = [], []
        extra: List[int] = []
        seen = {int(n): i for i, n in enumerate(frontier)}
        for di, node in enumerate(frontier):
            lo, hi = indptr[node], indptr[node + 1]
            if hi == lo:
                continue
            cand = nbrs[lo:hi]
            pick = cand if len(cand) <= fanout else rng.choice(cand, fanout, replace=False)
            for p in pick:
                p = int(p)
                if p not in seen:
                    seen[p] = len(frontier) + len(extra)
                    extra.append(p)
                srcs.append(seen[p])
                dsts.append(di)
        blocks.append(Block(np.array(srcs, np.int32), np.array(dsts, np.int32),
                            n_dst=len(frontier)))
        frontier = np.concatenate([frontier, np.array(extra, np.int64)]) if extra else frontier
    blocks.reverse()  # now blocks[0] is the innermost (first layer applied)
    return frontier, blocks


def sage_block_forward(params: Dict, cfg: SAGEConfig,
                       feats_frontier: torch.Tensor, blocks_arrays,
                       mesh=None) -> torch.Tensor:
    """Minibatch forward. feats_frontier: features of the full sampled
    frontier (layer-0 input); blocks_arrays: (src, dst, n_dst) triples,
    innermost first (on a ``mesh``, this rank's share of each block's
    edges)."""
    h = feats_frontier
    for l in range(cfg.n_layers):
        src, dst, n_dst = blocks_arrays[l]
        agg = _aggregate(h, src, dst, n_dst, cfg.aggregator, mesh=mesh)
        h_self = h[:n_dst]
        h = _layer(params[f"layer_{l}"], h_self, agg, last=(l == cfg.n_layers - 1),
                   normalize=cfg.normalize)
    return h


# ------------------------------------------------------ batched small graphs
def sage_graph_forward(params: Dict, cfg: SAGEConfig, feats: torch.Tensor,
                       edges: torch.Tensor, graph_id: torch.Tensor,
                       n_graphs: int, readout: Dict, mesh=None) -> torch.Tensor:
    """Molecule-style: many small graphs block-diagonally batched.  Node
    logits → mean per graph (the gather-sum over the nodes grouped by
    graph_id) → linear readout.  On a ``mesh`` the edges are this rank's
    share; the nodes, and so the readout, are whole."""
    h = sage_full_forward(params, cfg, feats, edges, mesh=mesh)
    nodes = torch.arange(h.shape[0], dtype=torch.int32, device=h.device)
    pooled = segment_mean(h, SegmentCSR(nodes, graph_id, h.shape[0], n_graphs))
    return pooled @ readout["w"] + readout["b"]
