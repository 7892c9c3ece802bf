"""Top-level orchestrator, serving half: the retrieval system of the paper.

Wires corpus → inverted index → query log → L1 ranker → state bins →
production plans, and exposes the serving entry points: batch inputs,
baselines, state-bin fitting and policy evaluation.  Training (L1 fit,
Q-learning) is not ported yet; trained parameters from the JAX
reference are installed with :meth:`RetrievalSystem.load_reference`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.environment import EnvConfig
from repro_torch.core.match_plan import MatchPlan, plan_rollout, production_plans
from repro_torch.core.match_rules import RuleSet, default_rule_library
from repro_torch.core.rollout import unified_rollout
from repro_torch.core.state_bins import StateBins, fit_bins
from repro_torch.data.querylog import (CAT1, CAT2, QueryLog, QueryLogConfig,
                                       generate_querylog)
from repro_torch.device import resolve_device
from repro_torch.index.blocks import words_to_tensor
from repro_torch.index.builder import (InvertedIndex, batch_query_occupancy,
                                       build_index)
from repro_torch.index.corpus import (N_FIELDS, Corpus, CorpusConfig,
                                     generate_corpus)
from repro_torch.policies import StaticPlanPolicy, TabularQPolicy
from repro_torch.ranking.features import FEATURE_DIM
from repro_torch.ranking.l1_ranker import idf_for_terms, init_l1, score_all_docs
from repro_torch.ranking.metrics import batched_ncg

__all__ = ["SystemConfig", "RetrievalSystem"]

# Of the free device memory, the share that L1 scoring may fill with its
# per-query (D, T, F) hits and (D, hidden) activations.
_SCORING_MEMORY_SHARE = 0.25
_CPU_SCORING_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    corpus: CorpusConfig = CorpusConfig()
    querylog: QueryLogConfig = QueryLogConfig()
    block_docs: int = 512
    max_candidates: int = 512
    n_top: int = 5                      # paper: n = 5
    p_bins: int = 1024                  # paper: 10K (scaled to corpus size)
    u_budget: int = 2048
    t_max: int = 8
    rule_du_scale: int = 1
    rule_dv_scale: int = 1
    l1_hidden: int = 32
    seed: int = 0
    # Index-scan strategy for every rollout this system runs: a
    # core/scan_backends.py registry name.
    backend: str = "block_scan"


class RetrievalSystem:
    def __init__(self, cfg: SystemConfig, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.corpus: Corpus = generate_corpus(cfg.corpus)
        self.index: InvertedIndex = build_index(self.corpus,
                                                block_docs=cfg.block_docs)
        self.log: QueryLog = generate_querylog(self.corpus, self.index,
                                               cfg.querylog)
        self.ruleset: RuleSet = default_rule_library(
            cfg.rule_du_scale, cfg.rule_dv_scale, device=self.device)
        self.plans: Dict[str, MatchPlan] = production_plans(self.ruleset)
        self.env_cfg = EnvConfig(
            n_blocks=self.index.n_blocks,
            block_docs=cfg.block_docs,
            k_rules=self.ruleset.k,
            max_candidates=cfg.max_candidates,
            n_top=cfg.n_top,
            u_budget=cfg.u_budget,
        )

        # Per-document side data, padded to the block boundary.
        n_pad = self.index.padded_docs
        sr = np.zeros(n_pad, np.float32)
        sr[: self.index.n_docs] = self.index.static_rank
        dl = np.zeros((n_pad, self.index.doc_len.shape[1]), np.float32)
        dl[: self.index.n_docs] = np.log1p(self.index.doc_len) / np.log(256.0)
        self.static_rank = torch.from_numpy(sr).to(self.device)
        self.doc_len = torch.from_numpy(dl).to(self.device)
        self.idf_all = idf_for_terms(
            self.index.df[:, 2].astype(np.float64), self.index.n_docs,
            self.log.terms)  # body-field df

        self.l1_params = init_l1(torch.Generator().manual_seed(cfg.seed),
                                 hidden=cfg.l1_hidden, device=self.device)
        self.bins: Optional[StateBins] = None

    # ------------------------------------------------------ reference weights
    def load_reference(self, **arrays):
        """Install parameters of the JAX reference given as numpy arrays
        (``l1_params``, ``bins``, ``ruleset``, ``plans``; see
        :func:`repro_torch.weights.from_reference`).  Returns the
        converted :class:`~repro_torch.weights.ReferenceWeights`, whose
        ``q`` (if given) is for the caller's policies."""
        from repro_torch.weights import from_reference

        w = from_reference(device=self.device, **arrays)
        if w.l1_params is not None:
            self.l1_params = w.l1_params
        if w.bins is not None:
            self.bins = w.bins
        if w.ruleset is not None:
            self.ruleset = w.ruleset
        if w.plans is not None:
            self.plans = w.plans
        return w

    # ---------------------------------------------------------------- batches
    def scoring_batch_size(self) -> int:
        """Queries scored at once: sized so that the per-query scoring
        intermediates fill at most a share of free device memory."""
        d = self.index.padded_docs
        planes = self.log.terms.shape[1] * N_FIELDS
        # float32 per doc: the (T, F) hits and ~3 temporaries of them, the
        # features twice (parts and concat), ~3 (hidden,) activations.
        per_query = d * 4 * (4 * planes + 2 * FEATURE_DIM
                             + 3 * self.cfg.l1_hidden)
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            budget = free * _SCORING_MEMORY_SHARE
        else:
            budget = _CPU_SCORING_BYTES
        return max(1, int(budget // per_query))

    def batch_inputs(self, query_ids: Sequence[int]):
        """Occupancy (B, nb, T, F, W) int32, L1 scores (B, n_pad) float32
        and term-present masks (B, T) bool for a set of query ids."""
        qids = np.asarray(query_ids)
        term_lists = [self.log.terms[q, : self.log.n_terms[q]] for q in qids]
        occ = words_to_tensor(batch_query_occupancy(self.index, term_lists),
                              self.device)
        term_present = torch.from_numpy(self.log.terms[qids] >= 0).to(self.device)
        idf = torch.from_numpy(self.idf_all[qids]).to(self.device)
        step = self.scoring_batch_size()
        scores = torch.cat([
            score_all_docs(self.l1_params, occ[i:i + step], idf[i:i + step],
                           term_present[i:i + step], self.static_rank,
                           self.doc_len)
            for i in range(0, len(qids), step)])
        return occ, scores, term_present

    def judged(self, query_ids: Sequence[int]):
        qids = np.asarray(query_ids)
        return (torch.from_numpy(self.log.judged_ids[qids]).to(self.device),
                torch.from_numpy(self.log.judged_gains[qids]).to(self.device))

    # ------------------------------------------------------------- baselines
    def plan_for_category(self, cat: int) -> MatchPlan:
        return self.plans["CAT2" if cat == CAT2 else "CAT1"]

    def plan_policy(self, cat: int) -> StaticPlanPolicy:
        """The hand-tuned production plan as a first-class Policy."""
        return StaticPlanPolicy(self.plan_for_category(cat),
                                self.env_cfg.n_actions)

    def _run_plan_batch(self, plan: MatchPlan, occ, scores, term_present):
        return plan_rollout(self.env_cfg, self.ruleset, plan, occ, scores,
                            term_present, backend=self.cfg.backend)

    def run_baseline(self, query_ids: Sequence[int], cat: int):
        occ, scores, term_present = self.batch_inputs(query_ids)
        final, traj = self._run_plan_batch(self.plan_for_category(cat),
                                           occ, scores, term_present)
        return final, traj, (occ, scores, term_present)

    # ------------------------------------------------------------------ bins
    def fit_state_bins(self, n_queries: int = 256, batch: int = 64):
        """Harvest (u, v) from baseline runs; fit equal-mass bins."""
        rng = np.random.default_rng(self.cfg.seed + 2)
        us, vs = [], []
        for cat in (CAT1, CAT2):
            qids_all = np.where(self.log.category == cat)[0]
            qids = rng.choice(qids_all, size=min(n_queries, len(qids_all)),
                              replace=False)
            for i in range(0, len(qids), batch):
                _, traj, _ = self.run_baseline(qids[i: i + batch], cat)
                us.append(traj["u"].cpu().numpy().ravel())
                vs.append(traj["v"].cpu().numpy().ravel())
        self.bins = fit_bins(np.concatenate(us), np.concatenate(vs),
                             p=self.cfg.p_bins, device=self.device)
        return self.bins

    # ------------------------------------------------------------ evaluation
    def evaluate(self, q: torch.Tensor, query_ids: Sequence[int], cat: int):
        """Greedy Q policy vs production plan on the same queries.
        Returns per-query arrays for NCG@100 and blocks accessed u."""
        if self.bins is None:
            raise ValueError("fit_state_bins() first")
        occ, scores, term_present = self.batch_inputs(query_ids)
        judged_ids, judged_gains = self.judged(query_ids)

        base_final, _ = self._run_plan_batch(self.plan_for_category(cat),
                                             occ, scores, term_present)
        pol_res = unified_rollout(
            self.env_cfg, self.ruleset, self.bins,
            TabularQPolicy(q.to(self.device)), self.cfg.t_max, occ, scores,
            term_present, backend=self.cfg.backend)

        out = {}
        for name, fin in (("baseline", base_final),
                          ("policy", pol_res.final_state)):
            out[f"{name}_ncg"] = batched_ncg(fin.cand, judged_ids,
                                             judged_gains).cpu().numpy()
            out[f"{name}_u"] = fin.u.cpu().numpy()
            out[f"{name}_cand"] = fin.cand_cnt.cpu().numpy()
        out["actions"] = pol_res.transitions["a"].cpu().numpy()
        return out
