"""`LiveIndex`: epoch-versioned tiered index that serves while it mutates.

The port's copy of the reference's ``index/live/live_index.py`` (host
numpy; metrics and spans on the port's ``obs``).  One writer mutates (buffered adds/updates → ``commit`` → merge), many
readers serve: every visible mutation is published as an immutable
:class:`IndexEpoch` — (version, base generation, :class:`IndexView`) —
through :class:`IndexEpochStore`, the same version/staleness/subscribe
machinery policy snapshots use
(`repro_torch.core.versioned.VersionedStore`).
Readers pin an epoch and periodically refresh; they never see torn
state, and a pinned view keeps working after any number of later
commits or merges (old base generations stay mapped).

Capacity is FIXED at construction: the occupancy tensor always spans
``capacity_blocks`` blocks, so every prepared serve step keeps its
shapes across epochs — an epoch swap prepares no new step.
Blocks past the current doc count are all-zero planes; both scan
backends treat them identically, which is what makes live-vs-rebuild
parity exact *at equal capacity*.
"""
from __future__ import annotations

import pickle
import threading
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.versioned import StaleVersionError, VersionedStore
from repro_torch.index.blocks import pack_bits, words_per_block
from repro_torch.index.builder import (MAX_QUERY_TERMS, InvertedIndex,
                                       build_index_from_pairs)
from repro_torch.index.corpus import N_FIELDS
from repro_torch.obs import NULL_TRACER, MetricsRegistry, Tracer

from .segments import BaseSegment, DeltaOp, DeltaSegment, _canon_fields

__all__ = ["IndexEpoch", "IndexEpochStore", "IndexView", "LiveIndex",
           "StaleIndexEpochError", "MERGE_MS_EDGES", "OPLOG_NAME"]

#: Op-log checkpoint file, written next to the generation dirs.
OPLOG_NAME = "oplog.ckpt"

# Merge wall-time histogram buckets (ms): spans tiny test merges to
# multi-second 1M-doc compactions.
MERGE_MS_EDGES = (5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                  1000.0, 2500.0, 5000.0, 15000.0, 60000.0)


class StaleIndexEpochError(StaleVersionError):
    """A consumer's pinned index epoch is older than the staleness bound."""


class IndexView:
    """Immutable read view over (base generation + delta) at one epoch.

    Doc ids are positions in the *logical corpus* (base order, then
    appends), identical to what a from-scratch ``build_index`` of the
    same docs would assign — the invariant the parity harness pins.
    """

    def __init__(self, base: BaseSegment, delta: DeltaSegment,
                 capacity_docs: int,
                 account: Optional[Callable[[int, int], None]] = None):
        bd = base.index.block_docs
        if capacity_docs % bd != 0:
            raise ValueError(
                f"capacity_docs {capacity_docs} not a multiple of "
                f"block_docs {bd}")
        self.base = base
        self.delta = delta
        self.block_docs = bd
        self.capacity_docs = capacity_docs
        self.capacity_blocks = capacity_docs // bd
        self.words = words_per_block(bd)
        self.n_docs = base.n_docs + delta.n_new_docs
        if self.n_docs > capacity_docs:
            raise ValueError(f"{self.n_docs} docs exceed capacity "
                             f"{capacity_docs}")
        self.vocab_size = base.index.vocab_size
        self._account = account

    # ---------------------------------------------------------- postings
    def postings(self, term: int, field: int) -> np.ndarray:
        """Merged (base minus tombstones, plus delta) doc ids,
        ascending — bit-identical to a rebuilt index's posting list."""
        ids = self.base.index.postings(int(term), field)
        if self.delta.tombstones.size:
            ids = ids[~self.delta.tomb_mask[ids]]
        d_ids = self.delta.postings(int(term), field)
        if not d_ids.size:
            return np.asarray(ids, dtype=np.int32)
        return np.sort(np.concatenate(
            [np.asarray(ids, dtype=np.int32), d_ids]))

    @property
    def df(self) -> np.ndarray:
        """Live document frequencies (vocab, n_fields)."""
        return self.delta.df

    def static_rank(self) -> np.ndarray:
        return np.concatenate([np.asarray(self.base.index.static_rank),
                               self.delta.static_rank_new])

    def doc_len(self) -> np.ndarray:
        dl = np.array(self.base.index.doc_len, dtype=np.int32, copy=True)
        for d, row in self.delta.updated_doc_len.items():
            dl[d] = row
        if self.delta.n_new_docs:
            dl = np.concatenate([dl, self.delta.doc_len_new])
        return dl

    def doc_terms(self, doc_id: int, field: int) -> np.ndarray:
        cur = self.delta.doc_fields.get(int(doc_id))
        if cur is not None:
            return cur[field]
        return np.asarray(self.base.doc_terms(doc_id, field))

    def logical_field_terms(self) -> List[List[np.ndarray]]:
        """Per-field per-doc term arrays of the logical corpus — the
        input a from-scratch parity rebuild feeds ``build_index``."""
        return [[self.doc_terms(d, f) for d in range(self.n_docs)]
                for f in range(N_FIELDS)]

    # --------------------------------------------------------- occupancy
    def query_occupancy(self, terms: Sequence[int]) -> np.ndarray:
        """``occ[block, term, field, word]`` uint32 over the FIXED
        capacity: base planes (tombstones masked) unioned with delta
        planes.  Both scan backends consume the union unchanged, so
        candidates from either segment merge inside the ordinary
        block scan."""
        occ_bits = np.zeros((MAX_QUERY_TERMS, N_FIELDS, self.capacity_docs),
                            dtype=bool)
        base_bytes = delta_bytes = 0
        tomb = self.delta.tombstones.size > 0
        for t, term in enumerate(terms[:MAX_QUERY_TERMS]):
            for f in range(N_FIELDS):
                ids = self.base.index.postings(int(term), f)
                base_bytes += ids.nbytes
                if tomb:
                    ids = ids[~self.delta.tomb_mask[ids]]
                occ_bits[t, f, ids] = True
                d_ids = self.delta.postings(int(term), f)
                if d_ids.size:
                    delta_bytes += d_ids.nbytes
                    occ_bits[t, f, d_ids] = True
        if self._account is not None:
            self._account(base_bytes, delta_bytes)
        packed = pack_bits(occ_bits)          # (T, F, capacity/32)
        packed = packed.reshape(MAX_QUERY_TERMS, N_FIELDS,
                                self.capacity_blocks, self.words)
        return np.ascontiguousarray(packed.transpose(2, 0, 1, 3))

    def batch_query_occupancy(self,
                              term_lists: Sequence[Sequence[int]]) -> np.ndarray:
        return np.stack([self.query_occupancy(ts) for ts in term_lists])

    def describe(self) -> dict:
        return {"n_docs": self.n_docs, "capacity_docs": self.capacity_docs,
                "capacity_blocks": self.capacity_blocks,
                "base_generation": self.base.generation,
                "base_n_docs": self.base.n_docs,
                "delta": self.delta.describe()}


class IndexEpoch:
    """One published index version: readers pin it like a policy
    snapshot (immutable; ``version`` is the epoch id the result cache
    keys on, ``generation`` counts merges).

    ``ops`` is the committed delta op log the epoch's view was built
    from — the compact payload the process cell relays to worker
    processes, which mmap the base generation themselves and rebuild
    the (cheap, in-memory) delta from these ops."""

    __slots__ = ("version", "generation", "view", "ops")

    def __init__(self, version: int, generation: int, view: IndexView,
                 ops: Tuple[DeltaOp, ...] = ()):
        self.version = version
        self.generation = generation
        self.view = view
        self.ops = tuple(ops)

    def describe(self) -> dict:
        return {"version": self.version, "generation": self.generation,
                **self.view.describe()}


class IndexEpochStore(VersionedStore):
    """`VersionedStore` over :class:`IndexEpoch` — EVERY visible index
    mutation (delta commit or merge) bumps the epoch.

    ``version`` pins an explicit epoch id, so that a follower's store
    republishes relayed epochs under the producer's numbering (gaps are
    legal — a late follower jumps straight to the head epoch it is
    sent)."""

    stale_error = StaleIndexEpochError
    artifact = "index epoch"

    def publish(self, view: IndexView, generation: int,
                ops: Sequence[DeltaOp] = (),
                version: Optional[int] = None) -> int:
        return self._publish_snapshot(
            lambda prev, ver: IndexEpoch(ver, generation, view, ops),
            version=version)


class LiveIndex:
    """Single-writer live index: buffered mutations, epoch publishes,
    background-mergeable compaction.

    ``add_document``/``update_document`` buffer ops (invisible to
    readers); ``commit`` publishes them as a new epoch; ``merge``
    compacts every committed delta op into a new base generation
    (written to ``storage_dir`` and memmapped back when given) and
    publishes that as the next epoch with an empty-or-residual delta.
    ``merge`` computes outside the writer lock, so adds keep landing —
    and serving never pauses — while a compaction runs.
    """

    def __init__(self, base, *, capacity_docs: Optional[int] = None,
                 staleness_bound: int = 64,
                 storage_dir=None, keep_generations: int = 2,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Tracer = NULL_TRACER):
        if isinstance(base, InvertedIndex):
            base = BaseSegment.from_index(base)
        bd = base.index.block_docs
        if capacity_docs is None:
            capacity_docs = 2 * max(base.index.padded_docs, bd)
        capacity_docs = ((capacity_docs + bd - 1) // bd) * bd
        if capacity_docs < base.index.padded_docs:
            raise ValueError("capacity_docs below the base segment")
        self.capacity_docs = capacity_docs
        self.capacity_blocks = capacity_docs // bd
        self.block_docs = bd
        self.storage_dir = Path(storage_dir) if storage_dir else None
        self.keep_generations = keep_generations
        self.tracer = tracer
        self.registry = registry if registry is not None else MetricsRegistry()
        r = self.registry
        self._c_added = r.counter("index.docs_added")
        self._c_updated = r.counter("index.docs_updated")
        self._c_commits = r.counter("index.commits")
        self._c_merges = r.counter("index.merges")
        self._c_bytes_base = r.counter("index.bytes", segment="base")
        self._c_bytes_delta = r.counter("index.bytes", segment="delta")
        self._c_queries = r.counter("index.plane_queries")
        self._g_delta = r.gauge("index.delta_docs")
        self._g_epoch = r.gauge("index.epoch")
        self._g_generation = r.gauge("index.generation")
        self._h_merge = r.histogram("index.merge_ms", MERGE_MS_EDGES)

        self._mu = threading.Lock()          # writer lock (ops + cutover)
        self._base = base
        self._ops: List[DeltaOp] = []        # committed-but-unmerged + pending
        self._n_committed = 0                # prefix of _ops already published
        self._next_doc = base.n_docs
        self.store = IndexEpochStore(staleness_bound=staleness_bound)
        if self.storage_dir and not base.path:
            self._base = base.save(self.storage_dir / "gen-00000")
        self._publish_locked(self._base, list(self._ops))

    # ------------------------------------------------------------ gauges
    @property
    def epoch(self) -> int:
        return self.store.version

    @property
    def generation(self) -> int:
        return self._base.generation

    @property
    def n_docs(self) -> int:
        """Docs visible at the head epoch (committed)."""
        return self.store.snapshot().view.n_docs

    @property
    def delta_docs(self) -> int:
        """Committed-but-unmerged docs owned by the delta tier."""
        return self.store.snapshot().view.delta.n_docs_owned

    @property
    def pending_ops(self) -> int:
        with self._mu:
            return len(self._ops) - self._n_committed

    def _account(self, base_bytes: int, delta_bytes: int) -> None:
        self._c_bytes_base.inc(base_bytes)
        self._c_bytes_delta.inc(delta_bytes)
        self._c_queries.inc()

    # ------------------------------------------------------------ writes
    def add_document(self, fields: Sequence[np.ndarray],
                     static_rank: float = 0.0) -> int:
        """Buffer one appended doc (next logical id — append-only ids
        keep rebuild parity); visible after ``commit``.  Fresh docs
        default to the bottom of the static-rank order, which is where
        news-like docs start out."""
        canon = _canon_fields(fields)
        with self._mu:
            if self._next_doc >= self.capacity_docs:
                raise ValueError(
                    f"capacity_docs={self.capacity_docs} exhausted; "
                    "merge into a larger generation or raise capacity")
            doc_id = self._next_doc
            self._next_doc += 1
            self._ops.append(DeltaOp("add", doc_id, canon,
                                     float(static_rank)))
        self._c_added.inc()
        return doc_id

    def add_documents(self, docs: Sequence[Sequence[np.ndarray]],
                      static_rank: Optional[Sequence[float]] = None) -> List[int]:
        ranks = (list(static_rank) if static_rank is not None
                 else [0.0] * len(docs))
        return [self.add_document(d, r) for d, r in zip(docs, ranks)]

    def update_document(self, doc_id: int,
                        fields: Sequence[np.ndarray]) -> None:
        """Buffer a full-document replacement (same id, new terms): the
        doc's old postings are tombstoned, the new ones served from the
        delta until the next merge folds them into the base."""
        canon = _canon_fields(fields)
        with self._mu:
            if not (0 <= doc_id < self._next_doc):
                raise IndexError(f"unknown doc {doc_id}")
            self._ops.append(DeltaOp("update", int(doc_id), canon))
        self._c_updated.inc()

    # ----------------------------------------------------------- publish
    def _publish_locked(self, base: BaseSegment,
                        ops: List[DeltaOp]) -> int:
        delta = DeltaSegment(base, ops)
        view = IndexView(base, delta, self.capacity_docs,
                         account=self._account)
        version = self.store.publish(view, base.generation, ops=ops)
        self._g_delta.set(delta.n_docs_owned)
        self._g_epoch.set(version)
        self._g_generation.set(base.generation)
        return version

    def commit(self) -> int:
        """Publish every buffered op as a new epoch (new delta segment,
        same base generation); returns the epoch version."""
        with self.tracer.span("index_commit") as span:
            with self._mu:
                ops = list(self._ops)
                self._n_committed = len(ops)
                version = self._publish_locked(self._base, ops)
            self._c_commits.inc()
            span.end(epoch=version, delta_ops=len(ops))
        return version

    # ------------------------------------------------------------- merge
    def merge(self) -> int:
        """Compact committed delta ops into a new base generation and
        publish it as the next epoch.  The heavy rebuild runs OUTSIDE
        the writer lock against immutable inputs; only the cutover
        (swap base, trim the op log, publish) takes the lock, so
        concurrent adds/updates are never blocked for long and land in
        the next generation's residual delta."""
        t0 = time.perf_counter()
        with self.tracer.span("index_merge") as span:
            with self._mu:
                base = self._base
                ops_at = list(self._ops[:self._n_committed])
                n_merged = len(ops_at)
            merged = self._compact(base, ops_at)          # heavy, unlocked
            if self.storage_dir:
                gen_dir = self.storage_dir / f"gen-{merged.generation:05d}"
                merged = merged.save(gen_dir)
            with self._mu:
                residual = self._ops[n_merged:]
                self._base = merged
                self._ops = residual
                self._n_committed = max(0, self._n_committed - n_merged)
                committed_residual = residual[:self._n_committed]
                version = self._publish_locked(merged, committed_residual)
            self._c_merges.inc()
            dt_ms = (time.perf_counter() - t0) * 1e3
            self._h_merge.record(dt_ms)
            self._gc_generations()
            # A merge changes which generation the op log is relative
            # to: an existing checkpoint must follow, or a crash after
            # the merge would leave a stale checkpoint whose residual
            # ops restore() has to discard.
            if (self.storage_dir
                    and (self.storage_dir / OPLOG_NAME).exists()):
                self.checkpoint()
            span.end(epoch=version, generation=merged.generation,
                     merged_ops=n_merged, ms=round(dt_ms, 2))
        return version

    # ----------------------------------------------------- checkpointing
    def checkpoint(self) -> Path:
        """Persist the op log (committed-but-unmerged AND pending ops —
        neither tier lives in any on-disk generation) next to the
        generation manifests; :meth:`restore` replays it after a
        restart.  Atomic: written to a temp file and renamed, so a crash
        mid-write leaves the previous checkpoint intact."""
        if not self.storage_dir:
            raise RuntimeError("checkpoint() needs a storage_dir")
        with self._mu:
            payload = pickle.dumps({
                "generation": self._base.generation,
                "n_committed": self._n_committed,
                "next_doc": self._next_doc,
                "ops": list(self._ops),
            }, protocol=4)
        path = self.storage_dir / OPLOG_NAME
        tmp = path.with_suffix(".tmp")
        tmp.write_bytes(payload)
        tmp.replace(path)
        return path

    @classmethod
    def restore(cls, storage_dir, **kwargs) -> "LiveIndex":
        """Reopen a live index from ``storage_dir``: load the newest
        base generation (mmapped) and replay the op-log checkpoint —
        committed ops are republished as an epoch (bit-parity with the
        never-crashed index's head view), pending ops wait for the next
        ``commit``.  A checkpoint written against an older generation
        than the newest on disk is stale (the crash hit between a merge
        and its checkpoint refresh) and is discarded."""
        storage_dir = Path(storage_dir)
        gens = sorted(storage_dir.glob("gen-*"))
        if not gens:
            raise FileNotFoundError(f"no gen-* under {storage_dir}")
        base = BaseSegment.load(gens[-1])
        li = cls(base, storage_dir=storage_dir, **kwargs)
        ckpt = storage_dir / OPLOG_NAME
        if not ckpt.exists():
            return li
        data = pickle.loads(ckpt.read_bytes())
        if data["generation"] != base.generation:
            return li                    # stale: ops already merged
        with li._mu:
            li._ops = list(data["ops"])
            li._n_committed = int(data["n_committed"])
            li._next_doc = int(data["next_doc"])
            if li._n_committed:
                li._publish_locked(li._base,
                                   li._ops[: li._n_committed])
        return li

    @staticmethod
    def _compact(base: BaseSegment, ops: List[DeltaOp]) -> BaseSegment:
        """Vectorized postings merge: (base pairs minus tombstones) +
        delta pairs, re-sorted into canonical CSR — bit-identical to a
        from-scratch build of the logical corpus (parity harness)."""
        delta = DeltaSegment(base, ops)
        vocab = base.index.vocab_size
        n_docs = base.n_docs + delta.n_new_docs
        pair_docs, pair_terms = [], []
        own = sorted(delta.doc_fields)
        for f in range(N_FIELDS):
            b_docs = np.asarray(base.index.doc_ids[f], dtype=np.int64)
            b_terms = np.repeat(np.arange(vocab, dtype=np.int64),
                                np.diff(base.index.indptr[f]))
            if delta.tombstones.size:
                keep = ~delta.tomb_mask[b_docs]
                b_docs, b_terms = b_docs[keep], b_terms[keep]
            d_docs = [np.full(len(delta.doc_fields[d][f]), d, np.int64)
                      for d in own]
            d_terms = [np.asarray(delta.doc_fields[d][f], np.int64)
                       for d in own]
            pair_docs.append(np.concatenate([b_docs] + d_docs)
                             if d_docs else b_docs)
            pair_terms.append(np.concatenate([b_terms] + d_terms)
                              if d_terms else b_terms)
        static_rank = np.concatenate(
            [np.asarray(base.index.static_rank), delta.static_rank_new])
        idx = build_index_from_pairs(
            pair_docs, pair_terms, n_docs=n_docs, vocab_size=vocab,
            static_rank=static_rank, block_docs=base.index.block_docs,
            dedup=True)
        return BaseSegment.from_index(idx, generation=base.generation + 1)

    def _gc_generations(self) -> None:
        """Drop generation dirs beyond ``keep_generations`` (open
        memmaps of pinned views keep working — the inode outlives the
        directory entry)."""
        if not self.storage_dir:
            return
        gens = sorted(self.storage_dir.glob("gen-*"))
        for d in gens[:-self.keep_generations]:
            for p in d.iterdir():
                p.unlink(missing_ok=True)
            d.rmdir()

    # -------------------------------------------------------------- info
    def stats(self) -> dict:
        head = self.store.snapshot()
        q = max(1, self._c_queries.value)
        return {
            "epoch": head.version,
            "generation": head.generation,
            "n_docs": head.view.n_docs,
            "capacity_docs": self.capacity_docs,
            "capacity_blocks": self.capacity_blocks,
            "delta_docs": head.view.delta.n_docs_owned,
            "pending_ops": self.pending_ops,
            "docs_added": self._c_added.value,
            "docs_updated": self._c_updated.value,
            "commits": self._c_commits.value,
            "merges": self._c_merges.value,
            "base_mmapped": self._base.mmapped,
            "base_nbytes": self._base.nbytes,
            "bytes_per_query_base": self._c_bytes_base.value / q,
            "bytes_per_query_delta": self._c_bytes_delta.value / q,
        }
