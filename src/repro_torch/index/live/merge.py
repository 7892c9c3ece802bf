"""Background merge: compact delta segments while serving continues.

The port's copy of the reference's ``index/live/merge.py``.
`MergeDaemon` watches a
:class:`~repro_torch.index.live.live_index.LiveIndex` and runs
``merge()`` on its own thread whenever the committed delta grows past
``min_delta_docs`` (or on an explicit :meth:`trigger`).  The heavy
compaction happens outside the writer lock, so queries keep
flowing against the pinned epochs the whole time; the new generation
appears to readers as just another epoch publish.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass

__all__ = ["MergeConfig", "MergeDaemon"]


@dataclass(frozen=True)
class MergeConfig:
    min_delta_docs: int = 256     # compact once the delta owns this many
    poll_interval_s: float = 0.05
    max_merges: int = 0           # 0 = unbounded; >0 = stop after N (tests)


class MergeDaemon:
    """One background thread compacting a LiveIndex.

    ``start``/``stop`` bracket the thread; ``trigger`` forces a merge
    check immediately (used by load generators between ticks).  Every
    merge is counted on the LiveIndex's own registry
    (``index.merges`` / ``index.merge_ms``), so the daemon carries no
    metric state of its own.
    """

    def __init__(self, live, config: MergeConfig = MergeConfig()):
        self.live = live
        self.config = config
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.merges_run = 0
        self.last_error: Exception | None = None

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "MergeDaemon":
        if self._thread is not None:
            raise RuntimeError("MergeDaemon already started")
        self._thread = threading.Thread(target=self._run,
                                        name="index-merge", daemon=True)
        self._thread.start()
        return self

    def stop(self, final_merge: bool = False) -> None:
        """Stop the thread; with ``final_merge`` run one last compaction
        inline so shutdown leaves an empty delta."""
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        if final_merge and self.live.delta_docs:
            self.live.merge()
            self.merges_run += 1

    def __enter__(self) -> "MergeDaemon":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def trigger(self) -> None:
        """Ask the daemon to check (and merge) now, ignoring the poll
        interval — still subject to ``min_delta_docs``."""
        self._wake.set()

    # --------------------------------------------------------------- loop
    def _due(self) -> bool:
        return self.live.delta_docs >= self.config.min_delta_docs

    def _run(self) -> None:
        cfg = self.config
        while not self._stop.is_set():
            self._wake.wait(timeout=cfg.poll_interval_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            if not self._due():
                continue
            try:
                self.live.merge()
                self.merges_run += 1
            except Exception as e:          # keep serving; the owner reads it
                self.last_error = e
                return
            if cfg.max_merges and self.merges_run >= cfg.max_merges:
                return
