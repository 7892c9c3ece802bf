"""Tiered live-index segments: mmap base + in-memory delta.

The port's copy of the reference's ``index/live/segments.py`` (host
numpy; the on-disk layout is the reference's byte for byte, so a
generation written by either package loads in the other).  The live
index serves from two tiers:

- :class:`BaseSegment` — a read-only generation of the index in a flat
  on-disk layout (one raw binary file per array + ``manifest.json``),
  ``np.memmap``-backed so future multi-process replicas map one copy.
  Alongside the CSR postings it stores the *forward* CSR (doc → terms)
  sidecar, which is what lets document updates subtract their old
  terms (tombstones, df maintenance) without scanning postings.
- :class:`DeltaSegment` — an immutable in-memory snapshot of every
  mutation since the base generation, rebuilt from the writer's
  operation log at each commit.  Appended docs take the next doc ids
  after the base (so a from-scratch rebuild of the logical corpus
  assigns identical ids — the bit-parity invariant); updated base docs
  are *tombstoned* in the base (all their base postings masked) and
  carried in the delta's postings under their original id.

Both tiers are immutable once constructed: readers hold a view
(`repro_torch.index.live.live_index.IndexView`) pinned by an epoch and
never see torn state.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.index.builder import InvertedIndex, forward_csr
from repro_torch.index.corpus import N_FIELDS

__all__ = ["BaseSegment", "DeltaOp", "DeltaSegment", "MANIFEST_NAME"]

MANIFEST_NAME = "manifest.json"


def _canon_fields(fields: Sequence[np.ndarray]) -> Tuple[np.ndarray, ...]:
    if len(fields) != N_FIELDS:
        raise ValueError(f"expected {N_FIELDS} field term arrays, "
                         f"got {len(fields)}")
    return tuple(np.unique(np.asarray(f, dtype=np.int32).ravel())
                 for f in fields)


@dataclasses.dataclass(frozen=True)
class DeltaOp:
    """One document mutation in the writer's op log."""
    kind: str                       # "add" | "update"
    doc_id: int
    fields: Tuple[np.ndarray, ...]  # per-field sorted unique term ids
    static_rank: float = 0.0        # adds only; updates keep their rank


class BaseSegment:
    """One read-only index generation + forward CSR sidecar."""

    # (name template, dtype) for every per-field array in the layout
    _FIELD_ARRAYS = (("indptr{f}.i64", np.int64),
                     ("docids{f}.i32", np.int32),
                     ("fwd_indptr{f}.i64", np.int64),
                     ("fwd_terms{f}.i32", np.int32))

    def __init__(self, index: InvertedIndex,
                 fwd_indptr: List[np.ndarray], fwd_terms: List[np.ndarray],
                 generation: int = 0, path: Optional[Path] = None):
        self.index = index
        self.fwd_indptr = fwd_indptr
        self.fwd_terms = fwd_terms
        self.generation = generation
        self.path = path

    # ----------------------------------------------------------- factory
    @classmethod
    def from_index(cls, index: InvertedIndex,
                   generation: int = 0) -> "BaseSegment":
        fi, ft = forward_csr(index)
        return cls(index, fi, ft, generation=generation)

    # ------------------------------------------------------------ access
    @property
    def n_docs(self) -> int:
        return self.index.n_docs

    @property
    def nbytes(self) -> int:
        arrays = (self.index.indptr + self.index.doc_ids
                  + self.fwd_indptr + self.fwd_terms
                  + [self.index.static_rank, self.index.doc_len,
                     self.index.df])
        return int(sum(a.nbytes for a in arrays))

    @property
    def mmapped(self) -> bool:
        return isinstance(self.index.doc_ids[0], np.memmap)

    def doc_terms(self, doc_id: int, field: int) -> np.ndarray:
        """Doc's sorted term ids in one field (forward CSR row)."""
        lo = self.fwd_indptr[field][doc_id]
        hi = self.fwd_indptr[field][doc_id + 1]
        return self.fwd_terms[field][lo:hi]

    def doc_fields(self, doc_id: int) -> Tuple[np.ndarray, ...]:
        return tuple(self.doc_terms(doc_id, f) for f in range(N_FIELDS))

    # --------------------------------------------------------- flat disk
    def _arrays(self) -> Dict[str, np.ndarray]:
        out = {"static_rank.f32": self.index.static_rank,
               "doc_len.i32": self.index.doc_len,
               "df.i32": self.index.df}
        for f in range(N_FIELDS):
            per = (self.index.indptr[f], self.index.doc_ids[f],
                   self.fwd_indptr[f], self.fwd_terms[f])
            for (tmpl, _), arr in zip(self._FIELD_ARRAYS, per):
                out[tmpl.format(f=f)] = arr
        return out

    def save(self, dir_path) -> "BaseSegment":
        """Write the flat layout (raw binaries + manifest) and return a
        fresh segment memmapping the files read-only."""
        dir_path = Path(dir_path)
        dir_path.mkdir(parents=True, exist_ok=True)
        arrays = self._arrays()
        manifest = {
            "generation": self.generation,
            "n_docs": self.index.n_docs,
            "vocab_size": self.index.vocab_size,
            "block_docs": self.index.block_docs,
            "n_fields": N_FIELDS,
            "arrays": {name: {"dtype": str(arr.dtype),
                              "shape": list(arr.shape)}
                       for name, arr in arrays.items()},
        }
        for name, arr in arrays.items():
            np.ascontiguousarray(arr).tofile(dir_path / name)
        (dir_path / MANIFEST_NAME).write_text(json.dumps(manifest, indent=1))
        return self.load(dir_path)

    @classmethod
    def load(cls, dir_path, mmap: bool = True) -> "BaseSegment":
        """Open a saved generation; with ``mmap`` (default) every array
        is a read-only ``np.memmap`` — N processes map one copy."""
        dir_path = Path(dir_path)
        manifest = json.loads((dir_path / MANIFEST_NAME).read_text())

        def arr(name: str) -> np.ndarray:
            spec = manifest["arrays"][name]
            shape = tuple(spec["shape"])
            if mmap:
                return np.memmap(dir_path / name, dtype=spec["dtype"],
                                 mode="r", shape=shape)
            return np.fromfile(dir_path / name,
                               dtype=spec["dtype"]).reshape(shape)

        indptr, doc_ids, fwd_indptr, fwd_terms = [], [], [], []
        for f in range(manifest["n_fields"]):
            indptr.append(arr(f"indptr{f}.i64"))
            doc_ids.append(arr(f"docids{f}.i32"))
            fwd_indptr.append(arr(f"fwd_indptr{f}.i64"))
            fwd_terms.append(arr(f"fwd_terms{f}.i32"))
        index = InvertedIndex(
            n_docs=manifest["n_docs"], vocab_size=manifest["vocab_size"],
            block_docs=manifest["block_docs"], indptr=indptr,
            doc_ids=doc_ids, static_rank=arr("static_rank.f32"),
            doc_len=arr("doc_len.i32"), df=arr("df.i32"))
        return cls(index, fwd_indptr, fwd_terms,
                   generation=manifest["generation"], path=dir_path)


class DeltaSegment:
    """Immutable view of the op log on top of one base generation.

    Last-writer-wins per doc id: re-updating a doc (or updating a doc
    added earlier in the same delta) replaces its field terms.  The
    segment precomputes per-field postings for its docs, the tombstone
    mask over base doc ids, and the *live* df (base df with tombstoned
    contributions subtracted and delta contributions added) — so a view
    answers df/doc_len/occupancy questions without touching the op log.
    """

    def __init__(self, base: BaseSegment, ops: Sequence[DeltaOp] = ()):
        self.base = base
        n_base = base.n_docs
        current: Dict[int, Tuple[np.ndarray, ...]] = {}
        ranks: Dict[int, float] = {}
        next_id = n_base
        for op in ops:
            if op.kind == "add":
                if op.doc_id != next_id:
                    raise ValueError(
                        f"append-only ids: expected doc {next_id}, "
                        f"got {op.doc_id}")
                next_id += 1
                ranks[op.doc_id] = float(op.static_rank)
            elif op.kind != "update":
                raise ValueError(f"unknown op kind {op.kind!r}")
            elif not (0 <= op.doc_id < next_id):
                raise IndexError(f"update of unknown doc {op.doc_id}")
            current[op.doc_id] = op.fields

        self.n_new_docs = next_id - n_base
        self.first_new_doc = n_base
        # doc id -> current per-field terms, for every doc the delta
        # owns — the forward view merge/parity rebuilds read.
        self.doc_fields: Dict[int, Tuple[np.ndarray, ...]] = current
        new_ids = np.arange(n_base, next_id, dtype=np.int64)
        self.static_rank_new = np.asarray(
            [ranks[d] for d in new_ids], dtype=np.float32)
        self.tombstones = np.asarray(
            sorted(d for d in current if d < n_base), dtype=np.int64)
        # O(n_base) bool lookup: vectorized postings filtering.
        self.tomb_mask = np.zeros(n_base, dtype=bool)
        self.tomb_mask[self.tombstones] = True

        # Per-field postings over every doc the delta owns (adds AND
        # updated base docs), plus live df / doc_len deltas.
        self.doc_len_new = np.zeros((self.n_new_docs, N_FIELDS), np.int32)
        self.updated_doc_len: Dict[int, np.ndarray] = {
            int(d): np.zeros(N_FIELDS, np.int32) for d in self.tombstones}
        df = np.asarray(base.index.df, dtype=np.int64).copy()
        self._postings: List[Dict[int, np.ndarray]] = []
        self.nbytes = 0
        own = sorted(current)
        for f in range(N_FIELDS):
            per_term: Dict[int, np.ndarray] = {}
            if own:
                docs_l, terms_l = [], []
                for d in own:
                    t = current[d][f]
                    docs_l.append(np.full(len(t), d, dtype=np.int64))
                    terms_l.append(np.asarray(t, dtype=np.int64))
                    if d >= n_base:
                        self.doc_len_new[d - n_base, f] = len(t)
                    else:
                        self.updated_doc_len[d][f] = len(t)
                        # the doc's base contribution leaves the index
                        df[base.doc_terms(d, f).astype(np.int64), f] -= 1
                docs = np.concatenate(docs_l)
                terms = np.concatenate(terms_l)
                if len(terms):
                    df[:, f] += np.bincount(terms, minlength=df.shape[0])
                order = np.argsort(terms, kind="stable")  # docs asc per term
                t_sorted, d_sorted = terms[order], docs[order].astype(np.int32)
                uniq, starts = np.unique(t_sorted, return_index=True)
                bounds = np.append(starts, len(t_sorted))
                for i, term in enumerate(uniq):
                    ids = d_sorted[bounds[i]:bounds[i + 1]]
                    per_term[int(term)] = ids
                    self.nbytes += ids.nbytes
            self._postings.append(per_term)
        self.df = df.astype(np.int32)

    # ------------------------------------------------------------ access
    _EMPTY = np.empty(0, dtype=np.int32)

    def postings(self, term: int, field: int) -> np.ndarray:
        """Delta doc ids for (term, field), ascending; adds and updated
        base docs alike (an updated doc's base postings are masked via
        :attr:`tomb_mask`, its current terms live here)."""
        return self._postings[field].get(int(term), self._EMPTY)

    def terms_present(self) -> frozenset:
        """Terms with at least one delta posting in any field — the
        admission plane's "does this query touch the delta" probe."""
        out = set()
        for per_term in self._postings:
            out.update(per_term)
        return frozenset(out)

    @property
    def n_docs_owned(self) -> int:
        """Docs whose current truth lives in the delta."""
        return self.n_new_docs + len(self.tombstones)

    def describe(self) -> dict:
        return {"base_generation": self.base.generation,
                "n_new_docs": self.n_new_docs,
                "n_tombstones": int(len(self.tombstones)),
                "nbytes": int(self.nbytes)}
