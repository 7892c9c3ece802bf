"""Shared shape set for the 4 recsys archs (copied from the reference's
``configs/recsys_family.py``)."""
from __future__ import annotations

from typing import Dict

from .base import ShapeSpec

__all__ = ["recsys_shapes"]


def recsys_shapes() -> Dict[str, ShapeSpec]:
    return {
        "train_batch": ShapeSpec("train_batch", "train", dict(batch=65536)),
        "serve_p99": ShapeSpec("serve_p99", "serve", dict(batch=512),
                               note="online-inference latency shape"),
        "serve_bulk": ShapeSpec("serve_bulk", "serve", dict(batch=262144),
                                note="offline scoring"),
        "retrieval_cand": ShapeSpec(
            "retrieval_cand", "retrieval", dict(batch=1, n_candidates=1_000_000),
            note="one query scored against 1M candidates: batched dot / "
                 "full forward over candidate rows + sharded top-k",
        ),
    }
