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

The reference shards edges over devices and psums the partial
aggregates; the port runs on one device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import seeded_generator
from repro_torch.kernels.segment_gather import SegmentCSR, segment_mean

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
               n_dst: int, aggregator: str, csr: SegmentCSR | None = None
               ) -> torch.Tensor:
    """Padding convention: src == h.shape[0] is a zero dummy row; dst ==
    n_dst is a dummy segment — both let edge arrays pad to fixed lengths
    without distorting the mean.  ``csr``: the edges already grouped
    (``SegmentCSR(src, dst, h.shape[0], n_dst)``), shared by layers over
    the same edges."""
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
                      edges: torch.Tensor) -> torch.Tensor:
    """Full-batch: feats (N, d_in), edges (2, E) src→dst. Returns logits
    (N, C).  The edges are grouped once for every layer."""
    h = feats
    n = feats.shape[0]
    csr = (SegmentCSR(edges[0], edges[1], n, n)
           if cfg.aggregator == "mean" else None)
    for l in range(cfg.n_layers):
        agg = _aggregate(h, edges[0], edges[1], n, cfg.aggregator, csr=csr)
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
                       feats_frontier: torch.Tensor, blocks_arrays) -> torch.Tensor:
    """Minibatch forward. feats_frontier: features of the full sampled
    frontier (layer-0 input); blocks_arrays: (src, dst, n_dst) triples,
    innermost first."""
    h = feats_frontier
    for l in range(cfg.n_layers):
        src, dst, n_dst = blocks_arrays[l]
        agg = _aggregate(h, src, dst, n_dst, cfg.aggregator)
        h_self = h[:n_dst]
        h = _layer(params[f"layer_{l}"], h_self, agg, last=(l == cfg.n_layers - 1),
                   normalize=cfg.normalize)
    return h


# ------------------------------------------------------ batched small graphs
def sage_graph_forward(params: Dict, cfg: SAGEConfig, feats: torch.Tensor,
                       edges: torch.Tensor, graph_id: torch.Tensor,
                       n_graphs: int, readout: Dict) -> torch.Tensor:
    """Molecule-style: many small graphs block-diagonally batched.  Node
    logits → mean per graph (the gather-sum over the nodes grouped by
    graph_id) → linear readout."""
    h = sage_full_forward(params, cfg, feats, edges)
    nodes = torch.arange(h.shape[0], dtype=torch.int32, device=h.device)
    pooled = segment_mean(h, SegmentCSR(nodes, graph_id, h.shape[0], n_graphs))
    return pooled @ readout["w"] + readout["b"]
