"""Served-traffic tap: the trainer's window onto what the fleet serves
(the port's copy of the reference's ``cluster/tap.py``).

The paper's policies were trained from production query streams, not
from a synthetic log sample — the MDP should spend its capacity on the
queries users actually issue, weighted by how often they issue them.
:class:`ServedTrafficTap` closes that loop: the cluster records every
completed ticket (responses AND sheds) into a bounded per-category
recency window, and the :class:`~repro_torch.cluster.trainer.TrainerLoop`
draws its training batches from it instead of sampling the query log.

Two properties fall out of the representation:

- **Popularity weighting is free**: hot queries appear in the window
  once per serve, so sampling the window with replacement reproduces
  the served popularity distribution (including the result-cache's
  view of it — cache hits are served traffic too).
- **Shed awareness**: degraded and shed tickets are recorded with a
  configurable weight boost.  The queries the fleet could NOT afford
  to serve fully are exactly where a better match policy pays —
  upweighting them points the trainer at the pressure.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Dict, Optional

import numpy as np

from repro_torch.serving.levels import ServiceLevel

__all__ = ["ServedTrafficTap"]


class ServedTrafficTap:
    """Thread-safe bounded window of served (qid, weight) per category.

    ``record`` is called from replica completion callbacks (and the
    cluster's submit path for immediate sheds); ``sample`` from the
    trainer thread.  The window is a recency ring (deque maxlen), so
    the trainer always learns from the *current* traffic mix, not from
    the whole history.
    """

    def __init__(self, capacity: int = 8192, degraded_boost: float = 2.0,
                 holdout_every: int = 0, holdout_capacity: int = 1024):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if degraded_boost <= 0:
            raise ValueError("degraded_boost must be > 0")
        if holdout_every < 0:
            raise ValueError("holdout_every must be >= 0 (0 disables)")
        self.capacity = int(capacity)
        self.degraded_boost = float(degraded_boost)
        # Every ``holdout_every``-th record per category is diverted to
        # a held-out eval window the trainer's promotion gate probes —
        # evaluation traffic the training sampler never sees (0 = off,
        # the standalone default; the cluster turns it on via
        # ClusterConfig.tap_holdout_every).
        self.holdout_every = int(holdout_every)
        self.holdout_capacity = int(holdout_capacity)
        self._lock = threading.Lock()
        self._window: Dict[int, deque] = {}       # category -> (qid, w, epoch)
        self._holdout: Dict[int, deque] = {}      # category -> qid
        self._seen: Dict[int, int] = {}           # category -> record count
        self.n_recorded = 0
        self.n_held_out = 0
        self.level_counts: Dict[int, int] = {int(l): 0 for l in ServiceLevel}
        # Index-epoch span of the recorded traffic: the trainer trains
        # against the head index, so a wide span warns that the window
        # still carries pre-swap traffic (freshness lag, not an error).
        self.min_epoch_seen: Optional[int] = None
        self.max_epoch_seen: Optional[int] = None

    # -------------------------------------------------------------- feed
    def record(self, qid: int, category: int,
               level: ServiceLevel = ServiceLevel.FULL,
               index_epoch: int = 0) -> None:
        level = ServiceLevel(level)
        w = self.degraded_boost if level.degraded else 1.0
        index_epoch = int(index_epoch)
        with self._lock:
            cat = int(category)
            self.n_recorded += 1
            self.level_counts[int(level)] += 1
            if self.min_epoch_seen is None or index_epoch < self.min_epoch_seen:
                self.min_epoch_seen = index_epoch
            if self.max_epoch_seen is None or index_epoch > self.max_epoch_seen:
                self.max_epoch_seen = index_epoch
            if self.holdout_every:
                n = self._seen[cat] = self._seen.get(cat, 0) + 1
                if n % self.holdout_every == 0:
                    hq = self._holdout.get(cat)
                    if hq is None:
                        hq = self._holdout[cat] = deque(
                            maxlen=self.holdout_capacity)
                    hq.append(int(qid))
                    self.n_held_out += 1
                    return
            dq = self._window.get(cat)
            if dq is None:
                dq = self._window[cat] = deque(maxlen=self.capacity)
            dq.append((int(qid), w, index_epoch))

    # ------------------------------------------------------------ sample
    def size(self, category: Optional[int] = None) -> int:
        with self._lock:
            if category is not None:
                return len(self._window.get(int(category), ()))
            return sum(len(dq) for dq in self._window.values())

    def sample(self, category: int, batch: int,
               rng: np.random.Generator) -> Optional[np.ndarray]:
        """A weighted with-replacement training batch of qids from the
        category's served window, or None while the window is empty
        (the trainer waits or skips — it never falls back to the log)."""
        with self._lock:
            dq = self._window.get(int(category))
            if not dq:
                return None
            qids = np.fromiter((q for q, _, _ in dq), dtype=np.int64,
                               count=len(dq))
            weights = np.fromiter((w for _, w, _ in dq), dtype=np.float64,
                                  count=len(dq))
        return rng.choice(qids, size=int(batch), replace=True,
                          p=weights / weights.sum())

    # ----------------------------------------------------------- holdout
    def holdout_size(self, category: Optional[int] = None) -> int:
        with self._lock:
            if category is not None:
                return len(self._holdout.get(int(category), ()))
            return sum(len(dq) for dq in self._holdout.values())

    def holdout_sample(self, category: int, n: int,
                       rng: np.random.Generator) -> Optional[np.ndarray]:
        """Up to ``n`` *distinct* held-out qids for the category — the
        promotion gate's probe set — or None while the holdout window
        is empty.  Distinct because the gate scores recall per query;
        popularity weighting belongs to training, not evaluation."""
        with self._lock:
            dq = self._holdout.get(int(category))
            if not dq:
                return None
            qids = np.unique(np.fromiter(dq, dtype=np.int64, count=len(dq)))
        if len(qids) <= n:
            return qids
        return rng.choice(qids, size=int(n), replace=False)

    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "degraded_boost": self.degraded_boost,
                "n_recorded": self.n_recorded,
                "n_held_out": self.n_held_out,
                "holdout_every": self.holdout_every,
                "window_sizes": {c: len(dq)
                                 for c, dq in sorted(self._window.items())},
                "holdout_sizes": {c: len(dq)
                                  for c, dq in sorted(self._holdout.items())},
                "levels": {ServiceLevel(k).name: v
                           for k, v in sorted(self.level_counts.items())},
                "index_epoch_min": self.min_epoch_seen,
                "index_epoch_max": self.max_epoch_seen,
            }
