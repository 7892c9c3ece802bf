"""Synthetic query log with categories, popularity, and graded judgments.

Queries are generated *from* documents so that graded relevance exists
by construction:

- CAT2-style ("moderate-df multi-term"): 2–3 terms from a popular
  document's title/url — navigational-ish, head-of-distribution terms,
  high historical popularity.
- CAT1-style ("short multi-term, few occurrences over 6 months"):
  3–4 terms from a document's topic pocket ∩ body — rare topical
  queries with low popularity.

Each query carries a judged set: documents rated on a five-point scale
(0–4), exactly the evaluation substrate Table 1 needs (NCG@100 uses the
gains; the weighted eval set samples ∝ popularity, the unweighted set
uniformly over distinct queries).

A numpy copy of ``repro.data.querylog`` (same RNG call order, so the
same config gives the same log), kept here so that the port never
imports the JAX package, with the query classifier and the
evaluation-set sampler (Table 1's two test samples).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.index.builder import MAX_QUERY_TERMS, InvertedIndex
from repro_torch.index.corpus import B, Corpus, T, U

__all__ = ["CAT1", "CAT2", "QueryLogConfig", "QueryLog", "generate_querylog",
           "classify_query", "sample_eval_sets"]

CAT1, CAT2 = 0, 1


@dataclasses.dataclass(frozen=True)
class QueryLogConfig:
    n_queries: int = 2000
    n_judged: int = 64
    frac_cat2: float = 0.5
    zipf_a: float = 1.2          # popularity skew over distinct queries
    seed: int = 0


@dataclasses.dataclass
class QueryLog:
    terms: np.ndarray          # (Q, MAX_QUERY_TERMS) int32, -1 pad
    n_terms: np.ndarray        # (Q,) int32
    popularity: np.ndarray     # (Q,) float64, sums to 1
    category: np.ndarray       # (Q,) int8  (0=CAT1, 1=CAT2)
    judged_ids: np.ndarray     # (Q, J) int32, -1 pad
    judged_gains: np.ndarray   # (Q, J) int8, 0..4
    seed_doc: np.ndarray       # (Q,) int32

    @property
    def n_queries(self) -> int:
        return self.terms.shape[0]

    def term_present(self) -> np.ndarray:
        return self.terms >= 0


def _doc_coverage(index: InvertedIndex, terms: np.ndarray, field: int) -> np.ndarray:
    cov = np.zeros(index.n_docs, dtype=np.float32)
    for t in terms:
        ids = index.postings(int(t), field)
        cov[ids] += 1.0
    return cov / max(len(terms), 1)


def _judge(
    rng: np.random.Generator,
    corpus: Corpus,
    index: InvertedIndex,
    terms: np.ndarray,
    topic: int,
    n_judged: int,
) -> Tuple[np.ndarray, np.ndarray]:
    title_cov = _doc_coverage(index, terms, T)
    body_cov = _doc_coverage(index, terms, B)
    topic_match = (corpus.doc_topic == topic).astype(np.float32)
    rel = (
        (0.6 * title_cov + 0.4 * body_cov) * (1.0 + 0.75 * topic_match)
        + 0.25 * corpus.static_rank
        + rng.normal(0, 0.04, size=index.n_docs).astype(np.float32)
    )
    n_top = (3 * n_judged) // 4
    top = np.argpartition(-rel, n_top)[:n_top]
    rand = rng.integers(0, index.n_docs, size=n_judged - n_top)
    judged = np.unique(np.concatenate([top, rand]))[:n_judged]
    pad = n_judged - len(judged)
    gains_f = rel[judged]
    # Five-point scale: thresholds relative to this query's top relevance.
    hi = max(gains_f.max(), 1e-6)
    edges = hi * np.array([0.35, 0.55, 0.7, 0.85])
    gains = np.digitize(gains_f, edges).astype(np.int8)
    judged_ids = np.concatenate([judged.astype(np.int32), np.full(pad, -1, np.int32)])
    gains = np.concatenate([gains, np.zeros(pad, np.int8)])
    return judged_ids, gains


def generate_querylog(
    corpus: Corpus, index: InvertedIndex, config: QueryLogConfig = QueryLogConfig()
) -> QueryLog:
    rng = np.random.default_rng(config.seed)
    Q = config.n_queries

    terms = np.full((Q, MAX_QUERY_TERMS), -1, dtype=np.int32)
    n_terms = np.zeros(Q, dtype=np.int32)
    category = np.zeros(Q, dtype=np.int8)
    seed_doc = np.zeros(Q, dtype=np.int32)
    judged_ids = np.full((Q, config.n_judged), -1, dtype=np.int32)
    judged_gains = np.zeros((Q, config.n_judged), dtype=np.int8)

    # Popular docs attract navigational (CAT2) queries.
    top_pool = max(64, corpus.n_docs // 16)

    for qi in range(Q):
        is_cat2 = rng.random() < config.frac_cat2
        if is_cat2:
            d = int(rng.integers(0, top_pool))
            pool = np.union1d(corpus.field_terms[T][d], corpus.field_terms[U][d])
            nt = int(rng.integers(2, 4))
        else:
            d = int(rng.integers(0, corpus.n_docs))
            topic = corpus.doc_topic[d]
            pool = np.intersect1d(corpus.field_terms[B][d], corpus.topic_terms[topic])
            if len(pool) < 2:
                pool = corpus.field_terms[B][d]
            nt = int(rng.integers(3, MAX_QUERY_TERMS + 1))
        nt = min(nt, len(pool))
        qt = rng.choice(pool, size=max(nt, 1), replace=False).astype(np.int32)
        terms[qi, : len(qt)] = qt
        n_terms[qi] = len(qt)
        category[qi] = CAT2 if is_cat2 else CAT1
        seed_doc[qi] = d
        judged_ids[qi], judged_gains[qi] = _judge(
            rng, corpus, index, qt, int(corpus.doc_topic[d]), config.n_judged
        )

    # Popularity: Zipf over distinct queries, biased so CAT2 (navigational)
    # occupies most of the head — matches the paper's segment-size pattern
    # (CAT2 big in the weighted set, <1% in the unweighted set).
    ranks = np.empty(Q, dtype=np.int64)
    order = np.argsort(category)[::-1]  # CAT2 first
    ranks[order] = np.arange(Q)
    pop = (1.0 + ranks.astype(np.float64)) ** (-config.zipf_a)
    pop /= pop.sum()

    return QueryLog(
        terms=terms,
        n_terms=n_terms,
        popularity=pop,
        category=category,
        judged_ids=judged_ids,
        judged_gains=judged_gains,
        seed_doc=seed_doc,
    )


def classify_query(log: QueryLog, index: InvertedIndex) -> np.ndarray:
    """The paper's query categorizer: historical popularity, number of
    terms, and term document frequencies → category."""
    df_body = index.df[:, B].astype(np.float64)
    mean_df = np.zeros(log.n_queries)
    for qi in range(log.n_queries):
        ts = log.terms[qi, : log.n_terms[qi]]
        mean_df[qi] = df_body[ts].mean() if len(ts) else 0.0
    df_frac = mean_df / index.n_docs
    pop_med = np.median(log.popularity)
    # CAT2: moderately-high df terms and head popularity; CAT1: rare terms.
    return np.where((df_frac > 0.02) & (log.popularity > pop_med),
                    CAT2, CAT1).astype(np.int8)


def sample_eval_sets(log: QueryLog, n_eval: int,
                     seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(weighted_ids, unweighted_ids): the paper's two test samples."""
    rng = np.random.default_rng(seed)
    weighted = rng.choice(log.n_queries, size=n_eval, replace=True,
                          p=log.popularity)
    unweighted = rng.choice(log.n_queries, size=min(n_eval, log.n_queries),
                            replace=False)
    return weighted.astype(np.int64), unweighted.astype(np.int64)
