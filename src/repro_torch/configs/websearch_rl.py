"""websearch-rl — the paper's own system as a selectable arch (copied
from the reference's ``configs/websearch_rl.py``).

Two shapes: ``serve_queries`` (a batch of queries scanned against the
block index under the greedy learned policy) and ``rl_rollout`` (the
policy training step: ε-greedy rollout + batched TD update).  The port
runs one index shard on one device.
"""
from __future__ import annotations

import dataclasses

from .base import ArchDef, ShapeSpec, register


@dataclasses.dataclass(frozen=True)
class WebSearchCfg:
    n_blocks: int          # global index blocks (docs = n_blocks * block_docs)
    block_docs: int
    k_rules: int = 6
    max_candidates: int = 512
    n_top: int = 5
    p_bins: int = 10_000   # paper's p
    t_max: int = 8
    u_budget: int = 65536
    # Index-scan backend for the serve/train shapes (core/scan_backends.py):
    # "reference" one block a step on full tiles, "block_scan" the chunked
    # plane-pruned CUDA kernel (bytes streamed ∝ u).
    backend: str = "block_scan"


def model_cfg(reduced: bool) -> WebSearchCfg:
    if reduced:
        return WebSearchCfg(n_blocks=16, block_docs=256, p_bins=256, u_budget=512)
    # 4096 blocks × 4096 docs = 16.7M docs per index slice
    return WebSearchCfg(n_blocks=4096, block_docs=4096)


ARCH = register(ArchDef(
    arch_id="websearch-rl", family="websearch",
    source="[SIGIR'18 Rosset et al.; the paper]",
    model_cfg=model_cfg,
    shapes={
        "serve_queries": ShapeSpec(
            "serve_queries", "serve_websearch",
            dict(query_batch=256),
            note="L0 candidate generation under the greedy learned policy",
        ),
        "rl_rollout": ShapeSpec(
            "rl_rollout", "train_websearch",
            dict(query_batch=256),
            note="ε-greedy rollout + batched TD update (policy training step)",
        ),
    },
))
