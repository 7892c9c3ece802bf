"""Live-vs-rebuild parity harness.

The port's copy of the reference's ``index/live/parity.py``.  The live
index's one correctness contract: at EVERY epoch, serving from (base
generation + delta) is bit-identical to serving from a from-scratch
build of the logical corpus at that epoch — same df / doc_len /
static_rank, same occupancy planes, and the same rollout outcome on
every scan backend.  ``check_epoch_parity`` pins all of it; the
``launch/live_index.py --smoke`` gate and the tests run it at each
recorded epoch.

Parity holds *at equal capacity*: the live view always spans
``capacity_blocks`` blocks (fixed serve-step shapes), so the rebuilt
index's occupancy is zero-padded up to the same block count before
comparison — all-zero planes are no-ops for both backends.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.core.match_plan import plan_rollout
from repro_torch.index.builder import (InvertedIndex, batch_query_occupancy,
                                       build_index_from_pairs)
from repro_torch.index.corpus import N_FIELDS

__all__ = ["ParityError", "rebuild_index", "check_epoch_parity",
           "DEFAULT_BACKENDS"]

DEFAULT_BACKENDS = ("reference", "block_scan")


class ParityError(AssertionError):
    """The live view diverged from the from-scratch rebuild."""


def rebuild_index(view) -> InvertedIndex:
    """From-scratch index over the view's logical corpus — the oracle
    the live tiers must match bit-for-bit.

    The logical corpus is each doc's current terms: the base's forward
    CSR for the docs the delta does not own, the delta's op log for the
    rest.  The (doc, term) pairs are gathered vectorised and ordered
    doc-major by a stable sort (each doc's terms stay ascending, as the
    op log canonicalizes them), which is what a per-doc loop over
    ``view.logical_field_terms()`` would feed the builder."""
    base, delta = view.base, view.delta
    n_base = base.n_docs
    own = np.asarray(sorted(delta.doc_fields), dtype=np.int64)
    pair_docs, pair_terms = [], []
    for f in range(N_FIELDS):
        docs = np.repeat(np.arange(n_base, dtype=np.int64),
                         np.diff(np.asarray(base.fwd_indptr[f])))
        terms = np.asarray(base.fwd_terms[f], dtype=np.int64)
        if delta.tombstones.size:
            keep = ~delta.tomb_mask[docs]
            docs, terms = docs[keep], terms[keep]
        lists = [delta.doc_fields[int(d)][f] for d in own]
        lens = np.fromiter((len(t) for t in lists), dtype=np.int64,
                           count=len(own))
        docs = np.concatenate([docs, np.repeat(own, lens)])
        terms = np.concatenate([terms] + [np.asarray(t, np.int64)
                                          for t in lists])
        order = np.argsort(docs, kind="stable")
        pair_docs.append(docs[order])
        pair_terms.append(terms[order])
    return build_index_from_pairs(
        pair_docs, pair_terms, n_docs=view.n_docs,
        vocab_size=view.vocab_size, static_rank=view.static_rank(),
        block_docs=view.block_docs, dedup=False)


def _pad_occ(occ: np.ndarray, capacity_blocks: int) -> np.ndarray:
    """Zero-pad a (Q, blocks, T, F, W) occupancy up to the live view's
    fixed capacity."""
    pad = capacity_blocks - occ.shape[1]
    if pad < 0:
        raise ParityError(f"rebuild spans {occ.shape[1]} blocks, more "
                          f"than capacity {capacity_blocks}")
    if pad == 0:
        return occ
    return np.pad(occ, ((0, 0), (0, pad), (0, 0), (0, 0), (0, 0)))


def _final_fields(final) -> Dict[str, np.ndarray]:
    return {k: getattr(final, k).cpu().numpy()
            for k in ("u", "v", "cand", "cand_cnt", "topn")}


def check_epoch_parity(system, epoch, query_ids: Sequence[int],
                       backends: Sequence[str] = DEFAULT_BACKENDS) -> dict:
    """Assert live == rebuild at one epoch; returns a report dict.

    Three layers, each raising :class:`ParityError` on divergence:

    1. **structure** — df, doc_len, static_rank of the live view equal
       the from-scratch rebuild's.
    2. **occupancy** — for the sampled queries, the live view's packed
       planes (base ∪ delta, tombstones masked) are bit-identical to
       the rebuilt index's, zero-padded to capacity.
    3. **rollout** — the production plan's final state (u, v, cand,
       cand_cnt, topn) matches across every requested scan backend on
       the live occupancy, as ``system.batch_inputs`` pins it to the
       epoch on the system's device.  Combined with (2), any backend's
       rollout against a rebuilt index is covered transitively.
    """
    view = epoch.view
    rebuilt = rebuild_index(view)

    # 1. structural parity ------------------------------------------------
    pairs = (("static_rank", view.static_rank(), rebuilt.static_rank),
             ("doc_len", view.doc_len(), rebuilt.doc_len),
             ("df", np.asarray(view.df), rebuilt.df))
    for name, live_a, reb_a in pairs:
        if not np.array_equal(np.asarray(live_a), np.asarray(reb_a)):
            raise ParityError(
                f"epoch v{epoch.version} (gen {epoch.generation}): "
                f"{name} diverged from from-scratch rebuild")

    # 2. occupancy parity -------------------------------------------------
    qids = np.asarray(query_ids)
    log = system.log
    term_lists = [log.terms[q, : log.n_terms[q]] for q in qids]
    occ_live = view.batch_query_occupancy(term_lists)
    occ_reb = _pad_occ(batch_query_occupancy(rebuilt, term_lists),
                       view.capacity_blocks)
    if not np.array_equal(occ_live, occ_reb):
        bad = [int(q) for i, q in enumerate(qids)
               if not np.array_equal(occ_live[i], occ_reb[i])]
        raise ParityError(
            f"epoch v{epoch.version} (gen {epoch.generation}): occupancy "
            f"diverged from rebuild for queries {bad[:8]}"
            f"{'…' if len(bad) > 8 else ''}")

    # 3. backend rollout parity ------------------------------------------
    occ, scores, term_present = system.batch_inputs(qids, epoch=epoch)
    if not np.array_equal(occ.cpu().numpy().view(np.uint32), occ_live):
        raise ParityError(
            f"epoch v{epoch.version}: system.batch_inputs occupancy "
            "disagrees with the pinned view (epoch threading bug)")
    finals: Dict[str, Dict[int, Dict[str, np.ndarray]]] = {}
    cats = np.asarray(log.category)[qids]
    for backend in backends:
        finals[backend] = {}
        for cat in np.unique(cats):
            rows = torch.from_numpy(np.where(cats == cat)[0]).to(occ.device)
            plan = system.plan_for_category(int(cat))
            final, _ = plan_rollout(
                system.env_cfg, system.ruleset, plan,
                occ[rows], scores[rows], term_present[rows],
                backend=backend)
            finals[backend][int(cat)] = _final_fields(final)
    ref_backend = backends[0]
    for backend in backends[1:]:
        for cat, ref in finals[ref_backend].items():
            got = finals[backend][cat]
            for k, ref_a in ref.items():
                if not np.array_equal(ref_a, got[k]):
                    raise ParityError(
                        f"epoch v{epoch.version}: backend {backend!r} "
                        f"final.{k} diverged from {ref_backend!r} "
                        f"(cat {cat})")

    return {"epoch": epoch.version, "generation": epoch.generation,
            "n_docs": view.n_docs, "n_queries": int(len(qids)),
            "backends": list(backends), "ok": True}
