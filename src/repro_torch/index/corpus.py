"""Synthetic web corpus with multi-field documents and static rank.

Documents carry four fields — Anchor (A), Url (U), Body (B), Title (T) —
mirroring the paper's example match rules.  Terms follow a Zipf
distribution; titles/urls/anchors are correlated subsets of the body so
that field-restricted match rules (e.g. ``term ∈ U|T``) behave the way
they do in a real web index: much sparser, but biased toward documents
for which the term is *topical*.

Documents are generated directly in static-rank order (doc id 0 = best
static rank).  High-rank documents receive more anchor text (popular
pages attract links), which is what makes shallow U|T|A scans effective
for navigational queries — the structural fact the paper's match plans
exploit.

Everything here is host-side numpy: this is the data-preparation layer
that feeds the PyTorch query-evaluation runtime.  It is a copy of
``repro.index.corpus`` (same RNG call order, so the same
``CorpusConfig`` gives the same arrays), kept here so that the port
never imports the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

FIELDS = ("anchor", "url", "body", "title")
N_FIELDS = len(FIELDS)
A, U, B, T = range(N_FIELDS)

__all__ = ["FIELDS", "N_FIELDS", "A", "U", "B", "T", "CorpusConfig", "Corpus", "generate_corpus"]


@dataclasses.dataclass(frozen=True)
class CorpusConfig:
    n_docs: int = 8192
    vocab_size: int = 2048
    zipf_a: float = 1.15          # Zipf exponent for term frequencies
    body_terms: int = 48          # unique body terms per doc (mean)
    title_terms: int = 6
    url_terms: int = 3
    anchor_terms_base: int = 2    # anchors grow with static rank
    anchor_terms_top: int = 12
    n_topics: int = 64            # latent topics tying docs and queries together
    seed: int = 0


@dataclasses.dataclass
class Corpus:
    config: CorpusConfig
    # field_terms[f] : list of np.int32 arrays, one per doc (sorted unique term ids)
    field_terms: List[List[np.ndarray]]
    static_rank: np.ndarray       # (n_docs,) float32, descending in doc-id order
    doc_topic: np.ndarray         # (n_docs,) int32 latent topic per doc
    topic_terms: np.ndarray       # (n_topics, topic_vocab) int32 term ids per topic

    @property
    def n_docs(self) -> int:
        return self.config.n_docs


def _zipf_probs(vocab: int, a: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-a)
    return p / p.sum()


def generate_corpus(config: CorpusConfig = CorpusConfig()) -> Corpus:
    rng = np.random.default_rng(config.seed)
    vocab = config.vocab_size

    probs = _zipf_probs(vocab, config.zipf_a)

    # Latent topics: each topic owns a pocket of moderately rare terms.
    topic_vocab = max(8, vocab // config.n_topics)
    topic_terms = np.zeros((config.n_topics, topic_vocab), dtype=np.int32)
    # Topic terms drawn from the rarer half of the vocabulary so topical
    # queries are CAT1-like (rare multi-term).
    rare_pool = np.arange(vocab // 4, vocab, dtype=np.int32)
    for k in range(config.n_topics):
        topic_terms[k] = rng.choice(rare_pool, size=topic_vocab, replace=False)

    # Static rank: exponential-ish decay, already sorted descending.
    static_rank = np.sort(rng.exponential(scale=1.0, size=config.n_docs))[::-1]
    static_rank = (static_rank / static_rank.max()).astype(np.float32)

    doc_topic = rng.integers(0, config.n_topics, size=config.n_docs).astype(np.int32)

    field_terms: List[List[np.ndarray]] = [[] for _ in range(N_FIELDS)]
    for d in range(config.n_docs):
        topic = doc_topic[d]
        n_body = max(4, rng.poisson(config.body_terms))
        # Body = Zipf background + topical pocket.
        n_topical = max(2, n_body // 4)
        body = np.union1d(
            rng.choice(vocab, size=n_body - n_topical, p=probs),
            rng.choice(topic_terms[topic], size=n_topical),
        ).astype(np.int32)

        # Title: topical subset of the body plus a couple of head terms.
        n_title = min(len(body), max(2, rng.poisson(config.title_terms)))
        topical_in_body = np.intersect1d(body, topic_terms[topic])
        title_pick = topical_in_body[: max(1, n_title // 2)]
        title = np.union1d(
            title_pick, rng.choice(body, size=max(1, n_title - len(title_pick)))
        ).astype(np.int32)

        # URL: small subset of title.
        n_url = min(len(title), max(1, rng.poisson(config.url_terms)))
        url = rng.choice(title, size=n_url, replace=False).astype(np.int32)
        url = np.unique(url)

        # Anchor: grows with static rank (popular pages get more links);
        # drawn from title+topic so navigational scans work.
        frac = static_rank[d]
        n_anchor = int(round(config.anchor_terms_base + frac * (config.anchor_terms_top - config.anchor_terms_base)))
        anchor_pool = np.union1d(title, topic_terms[topic][: topic_vocab // 2])
        n_anchor = min(len(anchor_pool), max(1, n_anchor))
        anchor = np.unique(rng.choice(anchor_pool, size=n_anchor, replace=False)).astype(np.int32)

        field_terms[A].append(anchor)
        field_terms[U].append(url)
        field_terms[B].append(np.unique(body))
        field_terms[T].append(np.unique(title))

    return Corpus(
        config=config,
        field_terms=field_terms,
        static_rank=static_rank,
        doc_topic=doc_topic,
        topic_terms=topic_terms,
    )
