"""Freshness workload: new documents arrive, queries chase them.

The port's copy of the reference's ``data/freshness.py``: the same
numpy ``default_rng`` draws in the same order, so one seed gives the
reference's documents, chase queries, judged ids and waves.  Drives a
`repro_torch.index.live.LiveRetrievalSystem` the way breaking-news
traffic drives a web index: every ``tick`` synthesizes a batch of fresh
documents (topic-pocketed like the corpus generator's, but born at the
BOTTOM of the static-rank order — fresh pages have no link equity yet),
appends queries targeting them (title/topical terms, CAT2-shaped, the
new doc judged relevant), commits an index epoch, and emits a query
wave mixing hot fresh queries with background log traffic.

The wave is what ``launch/live_index.py`` and ``chip_smoke.py``
replay through a ServeEngine/ReplicaSet while the MergeDaemon compacts
underneath — the end-to-end freshness story: a query for a doc added
two ticks ago must hit it (epoch-keyed caches can't serve the pre-add
answer), and bit-parity with a from-scratch rebuild must hold at every
epoch along the way.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.data.querylog import CAT2
from repro_torch.index.corpus import A, B, N_FIELDS, T, U

__all__ = ["FreshnessConfig", "FreshnessWorkload"]


@dataclasses.dataclass(frozen=True)
class FreshnessConfig:
    docs_per_tick: int = 16
    queries_per_doc: int = 1      # fresh queries appended per new doc
    wave_queries: int = 64        # total submissions emitted per tick
    frac_fresh: float = 0.7       # share of the wave aimed at fresh docs
    recency_zipf: float = 1.3     # newer fresh queries repeat more
    body_terms: int = 24
    title_terms: int = 4
    static_rank_fresh: float = 0.01   # no link equity yet
    seed: int = 0


class FreshnessWorkload:
    """Stateful generator: each ``tick`` mutates the system (docs +
    queries + commit) and returns the qid wave to replay."""

    def __init__(self, system, cfg: FreshnessConfig = FreshnessConfig()):
        self.system = system
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.fresh_qids: List[int] = []      # appended queries, oldest first
        self.added_docs: List[int] = []
        self.ticks = 0

    # ---------------------------------------------------------- synthesis
    def _synth_doc(self) -> Tuple[List[np.ndarray], int]:
        """One fresh doc in the corpus generator's shape: Zipf body +
        topical pocket, topical title, url ⊂ title, thin anchor."""
        corpus = self.system.corpus
        cfg = self.cfg
        rng = self.rng
        vocab = corpus.config.vocab_size
        topic = int(rng.integers(0, corpus.topic_terms.shape[0]))
        pocket = corpus.topic_terms[topic]

        n_body = max(4, rng.poisson(cfg.body_terms))
        n_topical = max(2, n_body // 4)
        body = np.union1d(
            rng.integers(0, vocab, size=max(1, n_body - n_topical)),
            rng.choice(pocket, size=n_topical),
        ).astype(np.int32)
        n_title = min(len(body), max(2, rng.poisson(cfg.title_terms)))
        topical_in_body = np.intersect1d(body, pocket)
        title = np.union1d(
            topical_in_body[: max(1, n_title // 2)],
            rng.choice(body, size=max(1, n_title // 2)),
        ).astype(np.int32)
        url = np.unique(rng.choice(title, size=min(len(title), 2),
                                   replace=False)).astype(np.int32)
        anchor = np.unique(rng.choice(title, size=1)).astype(np.int32)

        fields: List[np.ndarray] = [None] * N_FIELDS  # type: ignore
        fields[A], fields[U], fields[B], fields[T] = (anchor, url,
                                                      np.unique(body), title)
        return fields, topic

    def _fresh_query_terms(self, fields: Sequence[np.ndarray],
                           topic: int) -> np.ndarray:
        """2–3 terms a user chasing this doc would type: title-led,
        topical — the navigational (CAT2) shape."""
        pool = np.union1d(fields[T], fields[U])
        n = int(self.rng.integers(2, 4))
        n = min(n, len(pool)) or 1
        return np.sort(self.rng.choice(pool, size=n,
                                       replace=False)).astype(np.int32)

    # --------------------------------------------------------------- tick
    def tick(self) -> np.ndarray:
        """Add docs, append their chase queries, commit an epoch, and
        return this tick's submission wave (qids, hot-fresh-heavy)."""
        cfg = self.cfg
        sys_ = self.system
        docs, queries = [], []
        for _ in range(cfg.docs_per_tick):
            fields, topic = self._synth_doc()
            docs.append(fields)
            for _ in range(cfg.queries_per_doc):
                queries.append((fields, topic))
        doc_ids = sys_.add_documents(
            docs, static_rank=[cfg.static_rank_fresh] * len(docs))
        self.added_docs.extend(doc_ids)

        term_lists = [self._fresh_query_terms(f, t) for f, t in queries]
        judged = [[doc_ids[i // max(1, cfg.queries_per_doc)]]
                  for i in range(len(queries))]
        gains = [[4]] * len(queries)       # the fresh doc is the answer
        qids = sys_.append_queries(term_lists, [CAT2] * len(term_lists),
                                   judged_ids=judged, judged_gains=gains)
        self.fresh_qids.extend(int(q) for q in qids)
        sys_.commit_index()                # the mutation becomes an epoch
        self.ticks += 1
        return self.wave()

    def wave(self) -> np.ndarray:
        """One tick's submissions: fresh queries (recency-Zipf repeats
        of the chase queries, newest hottest) mixed with background
        traffic drawn from the base log's popularity."""
        cfg = self.cfg
        rng = self.rng
        n_fresh = int(round(cfg.wave_queries * cfg.frac_fresh))
        n_fresh = min(n_fresh, cfg.wave_queries) if self.fresh_qids else 0
        out = []
        if n_fresh:
            pool = np.asarray(self.fresh_qids[::-1])   # newest first
            ranks = np.arange(1, len(pool) + 1, dtype=np.float64)
            p = ranks ** (-cfg.recency_zipf)
            out.append(rng.choice(pool, size=n_fresh, p=p / p.sum()))
        n_bg = cfg.wave_queries - n_fresh
        if n_bg:
            log = self.system.log
            base = len(log.popularity) - len(self.fresh_qids)
            p = np.asarray(log.popularity[:base], dtype=np.float64)
            out.append(rng.choice(base, size=n_bg, p=p / p.sum()))
        wave = np.concatenate(out).astype(np.int64)
        rng.shuffle(wave)
        return wave

    def stats(self) -> dict:
        return {"ticks": self.ticks, "docs_added": len(self.added_docs),
                "fresh_queries": len(self.fresh_qids)}
