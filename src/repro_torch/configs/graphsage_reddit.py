"""graphsage-reddit [arXiv:1706.02216; paper] — 2 layers, d_hidden=128,
mean aggregator, sample sizes 25-10.  Four graph regimes as shape cells
(copied from the reference's ``configs/graphsage_reddit.py``).
"""
from __future__ import annotations

from repro_torch.models.gnn import SAGEConfig
from .base import ArchDef, ShapeSpec, register


def model_cfg(reduced: bool) -> SAGEConfig:
    if reduced:
        return SAGEConfig(d_in=16, d_hidden=32, n_classes=7, n_layers=2)
    # d_in is shape-dependent (per-cell d_feat); launch/steps resolves it.
    return SAGEConfig(d_in=-1, d_hidden=128, n_classes=41, n_layers=2)


ARCH = register(ArchDef(
    arch_id="graphsage-reddit",
    family="gnn",
    source="[arXiv:1706.02216; paper]",
    model_cfg=model_cfg,
    shapes={
        "full_graph_sm": ShapeSpec(
            "full_graph_sm", "train_graph",
            dict(n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7),
            note="cora-scale full-batch",
        ),
        "minibatch_lg": ShapeSpec(
            "minibatch_lg", "train_minibatch",
            dict(n_nodes=232965, n_edges=114615892, batch_nodes=1024,
                 fanout=(15, 10), d_feat=602, n_classes=41),
            note="reddit; real neighbor sampler feeds fixed-shape blocks",
        ),
        "ogb_products": ShapeSpec(
            "ogb_products", "train_graph",
            dict(n_nodes=2449029, n_edges=61859140, d_feat=100, n_classes=47),
            note="full-batch-large; edges sharded over data axes, "
                 "node states replicated + psum",
        ),
        "molecule": ShapeSpec(
            "molecule", "train_batched_graphs",
            dict(n_nodes=30, n_edges=64, batch=128, d_feat=16, n_classes=2),
            note="block-diagonal batching + segment-mean readout",
        ),
    },
    notes="Arch spec says sample_sizes=25-10; the minibatch_lg CELL "
          "specifies fanout 15-10 — the cell wins for that shape.",
))
