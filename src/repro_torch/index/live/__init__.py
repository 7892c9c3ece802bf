"""Tiered live index: mmap base + delta segments, epoch-versioned
hot-swap, background merge (the port's copy of the reference's
``index/live`` package).

`LiveRetrievalSystem` is exported lazily (PEP 562): it pulls in
`repro_torch.system` — which itself imports `repro_torch.index` — so an
eager import here would be circular.
"""
from .live_index import (IndexEpoch, IndexEpochStore, IndexView, LiveIndex,
                         StaleIndexEpochError)
from .merge import MergeConfig, MergeDaemon
from .parity import ParityError, check_epoch_parity, rebuild_index
from .segments import BaseSegment, DeltaOp, DeltaSegment

__all__ = ["BaseSegment", "DeltaOp", "DeltaSegment", "IndexEpoch",
           "IndexEpochStore", "IndexView", "LiveIndex",
           "LiveRetrievalSystem", "MergeConfig", "MergeDaemon",
           "ParityError", "StaleIndexEpochError", "check_epoch_parity",
           "rebuild_index"]


def __getattr__(name):
    if name == "LiveRetrievalSystem":
        from .system import LiveRetrievalSystem
        return LiveRetrievalSystem
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
