"""Inverted index builder + query-time occupancy tensor construction.

Build side (host, numpy): one CSR-style posting structure per field,
postings implicitly sorted by static rank because doc ids are assigned
in static-rank order.

Query side: for a (padded) set of query terms, gather the posting lists
and scatter them into the bitpacked occupancy tensor
``occ[block, term, field, word]`` consumed by the match-plan executor
and the ``block_scan`` CUDA kernel.  This mirrors what the production
system does when it streams posting blocks from disk; the occupancy
tensor *is* the byte stream whose consumption the RL agent learns to
minimize.

A numpy copy of ``repro.index.builder`` (same arrays for the same
corpus), kept here so that the port never imports the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from .blocks import pack_bits, words_per_block
from .corpus import Corpus, N_FIELDS

__all__ = ["InvertedIndex", "build_index", "build_index_from_pairs",
           "query_occupancy", "batch_query_occupancy", "MAX_QUERY_TERMS"]

MAX_QUERY_TERMS = 4  # queries are padded to this many terms


@dataclasses.dataclass
class InvertedIndex:
    """CSR postings per field + doc metadata."""

    n_docs: int
    vocab_size: int
    block_docs: int
    # per field: indptr (vocab+1,) int64 and doc ids (nnz,) int32
    indptr: List[np.ndarray]
    doc_ids: List[np.ndarray]
    static_rank: np.ndarray           # (n_docs,) float32
    doc_len: np.ndarray               # (n_docs, n_fields) int32 unique-term counts
    df: np.ndarray                    # (vocab, n_fields) int32 document frequencies

    @property
    def n_blocks(self) -> int:
        return self.padded_docs // self.block_docs

    @property
    def padded_docs(self) -> int:
        bd = self.block_docs
        return ((self.n_docs + bd - 1) // bd) * bd

    def postings(self, term: int, field: int) -> np.ndarray:
        lo, hi = self.indptr[field][term], self.indptr[field][term + 1]
        return self.doc_ids[field][lo:hi]


def _field_csr(docs: np.ndarray, terms: np.ndarray, n_docs: int,
               vocab: int, dedup: bool):
    """CSR postings for one field from flat (doc, term) pairs.

    Returns ``(indptr, doc_ids, df_col, doc_len_col)`` in the canonical
    order: postings per term sorted by ascending doc id (= static-rank
    order, the layout the paper's best-first block scan assumes).  With
    ``dedup`` the pairs are first canonicalized (sorted, duplicates
    collapsed); without it the caller promises doc-major pairs with
    unique terms per doc — the fast path for corpus lists, which store
    sorted-unique term arrays already.
    """
    docs = np.asarray(docs, dtype=np.int64).ravel()
    terms = np.asarray(terms, dtype=np.int64).ravel()
    if dedup and len(docs):
        key = np.unique(docs * vocab + terms)          # doc-major sorted
        docs, terms = key // vocab, key % vocab
    counts = np.bincount(terms, minlength=vocab) if len(terms) else \
        np.zeros(vocab, dtype=np.int64)
    indptr = np.zeros(vocab + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    # Stable sort by term: within a term, pairs keep their doc-major
    # (ascending doc id) order — identical to the old cursor fill.
    order = np.argsort(terms, kind="stable")
    ids = docs[order].astype(np.int32)
    df_col = counts.astype(np.int32)
    dl_col = (np.bincount(docs, minlength=n_docs) if len(docs) else
              np.zeros(n_docs, dtype=np.int64)).astype(np.int32)
    return indptr, ids, df_col, dl_col


def build_index_from_pairs(pair_docs: Sequence[np.ndarray],
                           pair_terms: Sequence[np.ndarray], *,
                           n_docs: int, vocab_size: int,
                           static_rank: np.ndarray,
                           block_docs: int = 512,
                           dedup: bool = True) -> InvertedIndex:
    """Build an index directly from flat per-field (doc, term) pair
    arrays — the vectorized core shared by :func:`build_index`, the
    live index's merge compaction, and the ≥1M-doc benchmark generator
    (which synthesizes pairs without ever materializing per-doc lists).

    ``pair_docs[f]``/``pair_terms[f]`` are parallel 1-D arrays for
    field ``f``.  With ``dedup`` (default) duplicate (doc, term) pairs
    are collapsed, so any pair soup produces canonical postings.
    """
    indptrs, doc_id_arrays = [], []
    df = np.zeros((vocab_size, N_FIELDS), dtype=np.int32)
    doc_len = np.zeros((n_docs, N_FIELDS), dtype=np.int32)
    for f in range(N_FIELDS):
        indptr, ids, df[:, f], doc_len[:, f] = _field_csr(
            pair_docs[f], pair_terms[f], n_docs, vocab_size, dedup)
        indptrs.append(indptr)
        doc_id_arrays.append(ids)
    return InvertedIndex(
        n_docs=n_docs,
        vocab_size=vocab_size,
        block_docs=block_docs,
        indptr=indptrs,
        doc_ids=doc_id_arrays,
        static_rank=np.asarray(static_rank, dtype=np.float32),
        doc_len=doc_len,
        df=df,
    )


def build_index(corpus: Corpus, block_docs: int = 512) -> InvertedIndex:
    n_docs = corpus.n_docs
    pair_docs, pair_terms = [], []
    for f in range(N_FIELDS):
        lists = corpus.field_terms[f]
        lens = np.fromiter((len(t) for t in lists), dtype=np.int64,
                           count=n_docs)
        pair_docs.append(np.repeat(np.arange(n_docs, dtype=np.int64), lens))
        pair_terms.append(np.concatenate(lists) if lens.sum() else
                          np.empty(0, dtype=np.int64))
    # Corpus lists are sorted-unique per doc, so the pairs are already
    # canonical — skip the dedup sort.
    return build_index_from_pairs(
        pair_docs, pair_terms, n_docs=n_docs,
        vocab_size=corpus.config.vocab_size,
        static_rank=corpus.static_rank, block_docs=block_docs, dedup=False)


def query_occupancy(index: InvertedIndex, terms: Sequence[int]) -> np.ndarray:
    """Build ``occ[block, term, field, word]`` uint32 for one query.

    ``terms`` may be shorter than MAX_QUERY_TERMS; missing slots are
    all-zero planes (the match engine masks them out via the query's
    term-count).
    """
    n_pad = index.padded_docs
    occ_bits = np.zeros((MAX_QUERY_TERMS, N_FIELDS, n_pad), dtype=bool)
    for t, term in enumerate(terms[:MAX_QUERY_TERMS]):
        for f in range(N_FIELDS):
            ids = index.postings(int(term), f)
            occ_bits[t, f, ids] = True
    packed = pack_bits(occ_bits)                      # (T, F, n_pad/32)
    W = words_per_block(index.block_docs)
    n_blocks = index.n_blocks
    packed = packed.reshape(MAX_QUERY_TERMS, N_FIELDS, n_blocks, W)
    return np.ascontiguousarray(packed.transpose(2, 0, 1, 3))  # (block, T, F, W)


def batch_query_occupancy(index: InvertedIndex, term_lists: Sequence[Sequence[int]]) -> np.ndarray:
    """Stack per-query occupancy tensors: (Q, block, T, F, W) uint32."""
    return np.stack([query_occupancy(index, ts) for ts in term_lists])
