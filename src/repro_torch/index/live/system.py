"""`LiveRetrievalSystem`: the full retrieval system over a live index.

The port's copy of the reference's ``index/live/system.py``.  It
extends `repro_torch.system.RetrievalSystem` with the tiered live
index: the corpus-built inverted index becomes generation 0 of a
:class:`~repro_torch.index.live.live_index.LiveIndex`, and every batch
of query inputs is served from a pinned :class:`IndexEpoch` — callers
(the serve engine) thread the epoch they pinned through
``batch_inputs(qids, epoch=...)`` so a hot swap mid-batch can never
mix two indexes in one execution.

Shapes are FIXED at the live index's capacity: ``env_cfg.n_blocks`` is
``capacity_blocks`` from construction, so every prepared serve step
survives any number of epoch swaps.  Per-epoch device planes (static
rank, doc lengths, zero-padded to capacity) are memoized in a small
LRU keyed by epoch version.

The query log grows too (``append_queries``): freshness workloads
append queries targeting just-added docs, and the trainer/tap see them
like any logged query.  Appends are lock-serialized and strictly
append-only, so concurrent readers indexing by qid stay safe.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.index.blocks import words_to_tensor
from repro_torch.index.builder import MAX_QUERY_TERMS
from repro_torch.obs import NULL_TRACER, MetricsRegistry, Tracer
from repro_torch.ranking.l1_ranker import idf_for_terms
from repro_torch.system import RetrievalSystem, SystemConfig

from .live_index import IndexEpoch, LiveIndex

__all__ = ["EpochReadMixin", "LiveRetrievalSystem"]

_PLANES_LRU = 4   # epochs worth of device planes kept warm


class EpochReadMixin:
    """Read side of an epoch-versioned system: epoch-pinned batch
    inputs plus capacity-padded per-epoch device planes.

    Hosts must provide ``index_epoch_store`` (an `IndexEpochStore`) and
    the `RetrievalSystem` attributes the batch path reads (``log``,
    ``idf_all``, ``l1_params``, ``device``), and call
    :meth:`_init_epoch_reader` before the first batch.  It overrides
    the system's two batch hooks, so every caller of ``batch_inputs``
    (serving, training, evaluation, the L1 fit) reads one epoch's view:
    occupancy from the view, scores against that epoch's planes."""

    def _init_epoch_reader(self) -> None:
        self._planes: "OrderedDict[int, Tuple[torch.Tensor, torch.Tensor]]" = \
            OrderedDict()
        self._planes_mu = threading.Lock()

    # ------------------------------------------------------------- planes
    def _epoch_planes(self, epoch: IndexEpoch):
        """(static_rank, doc_len) device tensors padded to capacity for
        one epoch, LRU-memoized (a swap only rebuilds two small
        planes, never the occupancy path)."""
        with self._planes_mu:
            hit = self._planes.get(epoch.version)
            if hit is not None:
                self._planes.move_to_end(epoch.version)
                return hit
        view = epoch.view
        cap = view.capacity_docs
        sr = np.zeros(cap, np.float32)
        sr[: view.n_docs] = view.static_rank()
        dl_raw = view.doc_len()
        dl = np.zeros((cap, dl_raw.shape[1]), np.float32)
        dl[: view.n_docs] = np.log1p(dl_raw) / np.log(256.0)
        planes = (torch.from_numpy(sr).to(self.device),
                  torch.from_numpy(dl).to(self.device))
        with self._planes_mu:
            self._planes[epoch.version] = planes
            while len(self._planes) > _PLANES_LRU:
                self._planes.popitem(last=False)
        return planes

    # ------------------------------------------------------------ batches
    def _pin(self, epoch: Optional[IndexEpoch]) -> IndexEpoch:
        """The given epoch, or the head epoch (single-threaded callers)."""
        return epoch if epoch is not None else self.index_epoch_store.snapshot()

    def _query_tensors(self, qids: np.ndarray, epoch=None):
        view = self._pin(epoch).view
        log = self.log                      # capture refs: appends swap
        idf_all = self.idf_all              # whole arrays, never resize
        term_lists = [log.terms[q, : log.n_terms[q]] for q in qids]
        occ = words_to_tensor(view.batch_query_occupancy(term_lists),
                              self.device)
        term_present = torch.from_numpy(log.terms[qids] >= 0).to(self.device)
        idf = torch.from_numpy(idf_all[qids]).to(self.device)
        return occ, term_present, idf

    def _scoring_planes(self, epoch=None):
        return self._epoch_planes(self._pin(epoch))

    def batch_inputs(self, query_ids: Sequence[int],
                     epoch: Optional[IndexEpoch] = None):
        """Occupancy + L1 scores + masks at one pinned index epoch
        (head epoch when omitted), pinned once for the whole batch."""
        return super().batch_inputs(query_ids, epoch=self._pin(epoch))


class LiveRetrievalSystem(EpochReadMixin, RetrievalSystem):
    """`RetrievalSystem` over a `LiveIndex`.  Runs on ``device``
    (``cuda`` unless the caller passes ``"cpu"``; it raises without
    CUDA)."""

    def __init__(self, cfg: SystemConfig, *,
                 capacity_docs: Optional[int] = None,
                 storage_dir=None,
                 staleness_bound: int = 64,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Tracer = NULL_TRACER,
                 device=None):
        super().__init__(cfg, device=device)
        self.live = LiveIndex(self.index, capacity_docs=capacity_docs,
                              staleness_bound=staleness_bound,
                              storage_dir=storage_dir,
                              registry=registry, tracer=tracer)
        # Fixed shapes across epochs: rollouts always span capacity.
        self.env_cfg = dataclasses.replace(
            self.env_cfg, n_blocks=self.live.capacity_blocks)
        self._init_epoch_reader()
        self._log_mu = threading.Lock()
        # Paths that read self.static_rank / self.doc_len directly (the
        # L1 fit's features, the scoring sub-batch size): re-point them
        # at the capacity-padded first epoch's planes so their shapes
        # match the capacity-spanning occupancy every live batch has.
        self.static_rank, self.doc_len = self._epoch_planes(
            self.live.store.snapshot())

    # ----------------------------------------------------------- epoching
    @property
    def index_epoch_store(self):
        return self.live.store

    @property
    def index_epoch(self) -> int:
        return self.live.epoch

    # ------------------------------------------------------------- writes
    def add_documents(self, docs, static_rank=None) -> List[int]:
        return self.live.add_documents(docs, static_rank)

    def add_document(self, fields, static_rank: float = 0.0) -> int:
        return self.live.add_document(fields, static_rank)

    def update_document(self, doc_id: int, fields) -> None:
        self.live.update_document(doc_id, fields)

    def commit_index(self) -> int:
        return self.live.commit()

    def merge_index(self) -> int:
        return self.live.merge()

    # ---------------------------------------------------------- query log
    def append_queries(self, term_lists: Sequence[Sequence[int]],
                       categories: Sequence[int],
                       judged_ids: Optional[Sequence[Sequence[int]]] = None,
                       judged_gains: Optional[Sequence[Sequence[int]]] = None,
                       popularity: Optional[Sequence[float]] = None
                       ) -> np.ndarray:
        """Append fresh queries to the log; returns their new qids.

        IDF for the new rows is computed against the live df at append
        time (body field), matching how the base log's idf was built.
        Appends replace whole arrays under a lock — existing rows keep
        their positions, so concurrent readers holding old references
        stay consistent.
        """
        n = len(term_lists)
        if n == 0:
            return np.empty(0, dtype=np.int64)
        with self._log_mu:
            log = self.log
            q0 = log.n_queries
            j_width = log.judged_ids.shape[1]

            terms = np.full((n, MAX_QUERY_TERMS), -1, np.int32)
            n_terms = np.zeros(n, np.int32)
            for i, ts in enumerate(term_lists):
                ts = np.asarray(ts, dtype=np.int32)[:MAX_QUERY_TERMS]
                terms[i, : len(ts)] = ts
                n_terms[i] = len(ts)
            cat = np.asarray(categories, dtype=np.int8)

            j_ids = np.full((n, j_width), -1, np.int32)
            j_gains = np.zeros((n, j_width), np.int8)
            if judged_ids is not None:
                for i, (ids, gains) in enumerate(zip(judged_ids,
                                                     judged_gains)):
                    ids = np.asarray(ids, np.int32)[:j_width]
                    j_ids[i, : len(ids)] = ids
                    j_gains[i, : len(ids)] = np.asarray(gains,
                                                        np.int8)[:len(ids)]
            seed_doc = np.where(j_ids[:, 0] >= 0, j_ids[:, 0],
                                0).astype(np.int32)

            pop_new = (np.asarray(popularity, np.float64)
                       if popularity is not None
                       else np.full(n, log.popularity.mean()))
            pop = np.concatenate([log.popularity, pop_new])
            pop = pop / pop.sum()

            head = self.live.store.snapshot().view
            idf_new = idf_for_terms(
                np.asarray(head.df[:, 2], dtype=np.float64),
                head.n_docs, terms)

            log.terms = np.concatenate([log.terms, terms])
            log.n_terms = np.concatenate([log.n_terms, n_terms])
            log.category = np.concatenate([log.category, cat])
            log.judged_ids = np.concatenate([log.judged_ids, j_ids])
            log.judged_gains = np.concatenate([log.judged_gains, j_gains])
            log.seed_doc = np.concatenate([log.seed_doc, seed_doc])
            log.popularity = pop
            self.idf_all = np.concatenate([self.idf_all, idf_new])
            return np.arange(q0, q0 + n, dtype=np.int64)
