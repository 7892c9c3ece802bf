"""Worker-side read replica of the live index.

The port's copy of the reference's ``cluster/proc/follower.py``.  A
process-backed replica cannot reach into the parent's `LiveIndex` — it
follows it instead.  The parent relays every published
:class:`~repro_torch.index.live.live_index.IndexEpoch` over the control
channel as a compact payload: ``(version, generation, gen_dir, ops)``.
The worker mmaps the base generation from ``gen_dir`` (zero-copy —
every worker in the cell maps the SAME physical pages the parent
wrote) and rebuilds the cheap in-memory :class:`DeltaSegment` from the
committed op log, then republishes the epoch into a local
`IndexEpochStore` **under the producer's version numbering**, so
staleness bounds and epoch-lag accounting mean the same thing on both
sides of the process boundary.  Gaps are legal (a respawned worker
jumps straight to the head epoch it is sent); duplicates — e.g. the
subscribe-time replay of an epoch the spawn spec already carried — are
skipped.

The serving read path (`EpochReadMixin`) is the exact code the
in-process `LiveRetrievalSystem` serves with; only the epoch *source*
differs.

Unlike the reference, the follower also follows query-log appends
(``append_queries``, which freshness workloads make before each
commit): the parent relays the rows appended since its last relay with
each epoch (:func:`log_tail`), their IDF rows as the parent computed
them, and :meth:`FollowerSystem.extend_log` appends them.  The
reference serves the seed log only and leaves such workloads to the
thread backend.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from contextlib import nullcontext
from typing import Sequence, Tuple

import numpy as np

from repro_torch.data.querylog import QueryLog
from repro_torch.index.live.live_index import IndexEpochStore, IndexView
from repro_torch.index.live.segments import BaseSegment, DeltaOp, DeltaSegment
from repro_torch.index.live.system import EpochReadMixin
from repro_torch.system import RetrievalSystem, SystemConfig

__all__ = ["FollowerSystem", "LOG_FIELDS", "load_log", "log_tail",
           "save_log"]

#: Base generations kept mapped — the head epoch's plus the previous
#: one, so a pinned view keeps working across one merge relay.
_BASES_KEPT = 2

#: The query log's per-query arrays (``QueryLog`` fields but popularity,
#: which is renormalized over the whole log on every append).
LOG_FIELDS = ("terms", "n_terms", "category", "judged_ids", "judged_gains",
              "seed_doc")


def save_log(system, path) -> int:
    """Write ``system``'s query log and IDF rows to ``path`` (one
    ``.npz``, read back by :func:`load_log`); returns the rows saved."""
    with getattr(system, "_log_mu", None) or nullcontext():
        log, idf = system.log, system.idf_all
        arrays = {k: getattr(log, k) for k in LOG_FIELDS}
        arrays["popularity"] = log.popularity
        arrays["idf"] = idf
    np.savez(path, **arrays)
    return int(arrays["terms"].shape[0])


def load_log(path) -> Tuple[QueryLog, np.ndarray]:
    """(QueryLog, idf rows) saved by :func:`save_log`."""
    with np.load(path) as z:
        log = QueryLog(**{k: z[k] for k in LOG_FIELDS},
                       popularity=z["popularity"])
        return log, z["idf"]


def log_tail(system, q0: int):
    """``(q0, rows)``: the query-log rows of ``system`` from ``q0`` on,
    with their IDF rows and the whole popularity column, as host
    arrays; None when the log holds no row past ``q0``."""
    with getattr(system, "_log_mu", None) or nullcontext():
        log, idf = system.log, system.idf_all
        n = int(log.terms.shape[0])
        if n <= q0:
            return None
        rows = {k: np.array(getattr(log, k)[q0:n]) for k in LOG_FIELDS}
        rows["idf"] = np.array(idf[q0:n])
        rows["popularity"] = np.array(log.popularity[:n])
    return q0, rows


class FollowerSystem(EpochReadMixin, RetrievalSystem):
    """`RetrievalSystem` whose index epochs arrive over IPC.

    ``base_dir`` is the PRISTINE corpus-built generation the parent
    saved once for the whole cell: the env shapes are derived from it,
    so they are the parent's regardless of how many merges have happened
    by the time this worker (re)spawns.  ``init_epoch`` is the head epoch at
    spawn time, applied before the first query is served.  ``log``, with
    its ``idf`` rows, is the parent's saved query log (:func:`load_log`):
    the follower neither generates a corpus nor builds a log.  Runs on
    ``device`` (``cuda`` unless the caller passes ``"cpu"``).
    """

    def __init__(self, cfg: SystemConfig, base_dir, *,
                 capacity_docs: int,
                 init_epoch: Tuple[int, int, str, Sequence[DeltaOp]],
                 log: QueryLog, idf: np.ndarray,
                 staleness_bound: int = 64, device=None):
        pristine = BaseSegment.load(base_dir)
        super().__init__(cfg, index=pristine.index, device=device, log=log)
        self.idf_all = np.array(idf)
        bd = pristine.index.block_docs
        if capacity_docs % bd != 0:
            raise ValueError(f"capacity_docs {capacity_docs} not a "
                             f"multiple of block_docs {bd}")
        self.capacity_docs = capacity_docs
        self.capacity_blocks = capacity_docs // bd
        # Fixed shapes across epochs, same as LiveRetrievalSystem.
        self.env_cfg = dataclasses.replace(self.env_cfg,
                                           n_blocks=self.capacity_blocks)
        self._bases: "OrderedDict[str, BaseSegment]" = OrderedDict()
        self._store = IndexEpochStore(staleness_bound=staleness_bound)
        self._init_epoch_reader()
        version, generation, gen_dir, ops = init_epoch
        base = self._load_base(gen_dir)
        delta = DeltaSegment(base, list(ops))
        view = IndexView(base, delta, capacity_docs)
        self._store.publish(view, generation, ops=ops, version=version)
        self.static_rank, self.doc_len = self._epoch_planes(
            self._store.snapshot())

    # ----------------------------------------------------------- epoching
    @property
    def index_epoch_store(self) -> IndexEpochStore:
        return self._store

    @property
    def index_epoch(self) -> int:
        return self._store.version

    def apply_epoch(self, version: int, generation: int, gen_dir,
                    ops: Sequence[DeltaOp]) -> int:
        """Install one relayed epoch; returns the local head version.
        Out-of-order or duplicate relays (≤ the local head) are skipped
        — the relay stream is monotone per producer, but a respawn's
        spec and the subscribe replay can both carry the same head."""
        if version <= self._store.version:
            return self._store.version
        base = self._load_base(gen_dir)
        delta = DeltaSegment(base, list(ops))
        view = IndexView(base, delta, self.capacity_docs)
        return self._store.publish(view, generation, ops=ops,
                                   version=version)

    def extend_log(self, q0: int, rows: dict) -> int:
        """Append the relayed query-log rows ``q0..`` (a
        :func:`log_tail` payload) that this log does not hold yet;
        returns the log's length.  Rows it holds are skipped, as a
        respawn's spec and the next relay may both carry them; a gap is
        an error."""
        log = self.log
        n = log.n_queries
        if q0 > n:
            raise ValueError(f"relayed query rows start at {q0}, past the "
                             f"log's {n} rows")
        skip = n - q0
        if skip >= rows["terms"].shape[0]:
            return n
        for k in LOG_FIELDS:
            setattr(log, k, np.concatenate([getattr(log, k), rows[k][skip:]]))
        log.popularity = rows["popularity"]
        self.idf_all = np.concatenate([self.idf_all, rows["idf"][skip:]])
        return log.n_queries

    def _load_base(self, gen_dir) -> BaseSegment:
        key = str(gen_dir)
        base = self._bases.get(key)
        if base is None:
            base = BaseSegment.load(gen_dir)      # np.memmap, mode="r"
            self._bases[key] = base
            while len(self._bases) > _BASES_KEPT:
                self._bases.popitem(last=False)
        else:
            self._bases.move_to_end(key)
        return base
