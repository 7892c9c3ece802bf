"""Top-level orchestrator: the retrieval system of the paper.

Wires corpus → inverted index → query log → L1 ranker → state bins →
production plans → Q-learning, and exposes the entry points: batch
inputs, baselines, the L1 fit, state-bin fitting, ε-greedy Q-learning
per query category (``train_policy``; one ``policy_train_step`` a
batch) and policy evaluation.  Parameters of the JAX reference can also
be installed with :meth:`RetrievalSystem.load_reference`.

Random draws: the query ids of a training batch come from numpy, as in
the reference (``sample_train_qids``), so the port trains on the same
queries; the ε-greedy draws come from a ``torch.Generator`` on the
system's device, or are passed in (``policy_train_step``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.environment import EnvConfig
from repro_torch.core.match_plan import MatchPlan, plan_rollout, production_plans
from repro_torch.core.match_rules import RuleSet, default_rule_library
from repro_torch.core.qlearning import (QConfig, init_q, linear_epsilon,
                                        train_batch)
from repro_torch.core.rollout import unified_rollout
from repro_torch.core.state_bins import StateBins, fit_bins
from repro_torch.data.querylog import (CAT1, CAT2, QueryLog, QueryLogConfig,
                                       generate_querylog)
from repro_torch.device import resolve_device
from repro_torch.index.blocks import words_to_tensor
from repro_torch.index.builder import (MAX_QUERY_TERMS, InvertedIndex,
                                       batch_query_occupancy, build_index)
from repro_torch.index.corpus import (N_FIELDS, Corpus, CorpusConfig,
                                     generate_corpus)
from repro_torch.policies import PolicyStore, StaticPlanPolicy, TabularQPolicy
from repro_torch.ranking.features import FEATURE_DIM, doc_features
from repro_torch.ranking.l1_ranker import (idf_for_terms, init_l1,
                                           score_all_docs, train_l1)
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
    l1_steps: int = 300
    gamma: float = 1.0              # paper: 0 < γ ≤ 1 (undiscounted default)
    seed: int = 0
    # Index-scan strategy for every rollout this system runs: a
    # core/scan_backends.py registry name.
    backend: str = "block_scan"


class RetrievalSystem:
    # The static system has no live index: one immutable "epoch 0"
    # forever.  `repro_torch.index.live.LiveRetrievalSystem` overrides
    # both with its epoch store; the serving layers probe them with
    # getattr, so they work against either system.
    index_epoch_store = None

    @property
    def index_epoch(self) -> int:
        return 0

    def __init__(self, cfg: SystemConfig, index: Optional[InvertedIndex] = None,
                 device=None, log: Optional[QueryLog] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        # ``index`` injects a pre-built index instead of building one:
        # the process cell hands each worker the parent's saved base
        # generation (np.memmap'd read-only), so N worker processes map
        # ONE physical copy of the postings and skip the build.  ``log``
        # injects the parent's query log (saved once in the cell dir);
        # with both given, the corpus is not generated at all (None).
        # Every path below copies what it reads of the index before it
        # reaches torch.from_numpy, so a memmap is never aliased.
        self.corpus: Optional[Corpus] = (
            generate_corpus(cfg.corpus)
            if index is None or log is None else None)
        self.index: InvertedIndex = (
            index if index is not None
            else build_index(self.corpus, block_docs=cfg.block_docs))
        self.log: QueryLog = (
            log if log is not None
            else generate_querylog(self.corpus, self.index, cfg.querylog))
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
        self.qcfg: Optional[QConfig] = None

    def _set_bins(self, bins: StateBins) -> None:
        self.bins = bins
        self.qcfg = QConfig(p=bins.p, n_actions=self.env_cfg.n_actions,
                            t_max=self.cfg.t_max, gamma=self.cfg.gamma)

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
            self._set_bins(w.bins)
        if w.ruleset is not None:
            self.ruleset = w.ruleset
        if w.plans is not None:
            self.plans = w.plans
        return w

    # ---------------------------------------------------------------- batches
    def scoring_batch_size(self) -> int:
        """Queries scored at once: sized so that the per-query scoring
        intermediates fill at most a share of free device memory."""
        d = self.static_rank.shape[0]     # the docs a query is scored over
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

    def _query_tensors(self, qids: np.ndarray, epoch=None):
        """Occupancy (B, nb, T, F, W) int32, term-present masks (B, T)
        bool and per-slot IDF (B, T) float32, on the device.  ``epoch``:
        the pinned index epoch, which the static index does not have."""
        term_lists = [self.log.terms[q, : self.log.n_terms[q]] for q in qids]
        occ = words_to_tensor(batch_query_occupancy(self.index, term_lists),
                              self.device)
        term_present = torch.from_numpy(self.log.terms[qids] >= 0).to(self.device)
        idf = torch.from_numpy(self.idf_all[qids]).to(self.device)
        return occ, term_present, idf

    def _scoring_planes(self, epoch=None):
        """(static_rank, doc_len) device planes the L1 scores read."""
        return self.static_rank, self.doc_len

    def batch_inputs(self, query_ids: Sequence[int], epoch=None):
        """Occupancy (B, nb, T, F, W) int32, L1 scores (B, n_pad) float32
        and term-present masks (B, T) bool for a set of query ids.

        ``epoch`` is the serving engine's pinned index epoch; the static
        index ignores it."""
        qids = np.asarray(query_ids)
        occ, term_present, idf = self._query_tensors(qids, epoch)
        static_rank, doc_len = self._scoring_planes(epoch)
        step = self.scoring_batch_size()
        scores = torch.cat([
            score_all_docs(self.l1_params, occ[i:i + step], idf[i:i + step],
                           term_present[i:i + step], static_rank, doc_len)
            for i in range(0, len(qids), step)])
        return occ, scores, term_present

    def judged(self, query_ids: Sequence[int]):
        qids = np.asarray(query_ids)
        return (torch.from_numpy(self.log.judged_ids[qids]).to(self.device),
                torch.from_numpy(self.log.judged_gains[qids]).to(self.device))

    # ------------------------------------------------------------------- L1
    def l1_training_set(self, n_queries: int = 256, batch: int = 32):
        """The judged (query, doc) pairs the L1 fit regresses on: features
        (N, FEATURE_DIM) float32, gains (N,) int8 and weights (N,) float32,
        numpy, in the reference's order.  The judged rows are gathered on
        the device; only they are copied to the host."""
        rng = np.random.default_rng(self.cfg.seed + 1)
        qids = rng.choice(self.log.n_queries,
                          size=min(n_queries, self.log.n_queries),
                          replace=False)
        step = self.scoring_batch_size()
        feats_l, gains_l = [], []
        for i in range(0, len(qids), batch):
            chunk = qids[i: i + batch]
            occ, term_present, idf = self._query_tensors(chunk)
            jids = self.log.judged_ids[chunk]
            ids = torch.from_numpy(np.clip(jids, 0, None)).to(self.device).long()
            rows = []
            for j in range(0, len(chunk), step):
                feats = doc_features(occ[j:j + step], idf[j:j + step],
                                     term_present[j:j + step],
                                     self.static_rank, self.doc_len)
                rows.append(torch.gather(
                    feats, 1,
                    ids[j:j + step, :, None].expand(-1, -1, FEATURE_DIM)))
            rows = torch.cat(rows).cpu().numpy()          # (chunk, J, FD)
            for row, q in enumerate(chunk):
                mask = jids[row] >= 0
                feats_l.append(rows[row][mask])
                gains_l.append(self.log.judged_gains[q][mask])
        gains = np.concatenate(gains_l)
        weights = 1.0 + gains.astype(np.float32)  # emphasize relevant docs
        return np.concatenate(feats_l), gains, weights

    def fit_l1(self, n_queries: int = 256, batch: int = 32):
        """Train the L1 ranker on judged (query, doc) pairs; returns the
        per-step losses."""
        feats, gains, weights = self.l1_training_set(n_queries, batch)
        self.l1_params, losses = train_l1(
            self.l1_params, feats, gains, weights, steps=self.cfg.l1_steps,
            seed=self.cfg.seed)
        return losses

    # ------------------------------------------------------------- baselines
    def plan_for_category(self, cat: int) -> MatchPlan:
        return self.plans["CAT2" if cat == CAT2 else "CAT1"]

    def plan_policy(self, cat: int) -> StaticPlanPolicy:
        """The hand-tuned production plan as a first-class Policy."""
        return StaticPlanPolicy(self.plan_for_category(cat),
                                self.env_cfg.n_actions)

    def shallow_plan(self, cat: int, length: int = 2) -> MatchPlan:
        """Truncated production plan served at the shallow service level:
        u bounded by the prefix's summed Δu quotas."""
        return self.plan_for_category(cat).prefix(length)

    def shallow_u_cap(self, cat: int, length: int = 2) -> int:
        """Worst-case u of ONE single-shard shallow-plan execution:
        summed Δu quotas plus one block's planes of quota overshoot per
        entry."""
        return self.shallow_plan(cat, length).u_cap(
            per_entry_overshoot=MAX_QUERY_TERMS * N_FIELDS)

    def fallback_policies(self, cats: Sequence[int] = (CAT1, CAT2),
                          length: int = 2) -> Dict[int, StaticPlanPolicy]:
        """Degraded-service fallbacks published alongside live snapshots
        (``PolicyStore.publish(policies, fallbacks=...)``)."""
        return {cat: StaticPlanPolicy(self.shallow_plan(cat, length),
                                      self.env_cfg.n_actions)
                for cat in cats}

    def _run_plan_batch(self, plan: MatchPlan, occ, scores, term_present):
        return plan_rollout(self.env_cfg, self.ruleset, plan, occ, scores,
                            term_present, backend=self.cfg.backend)

    def run_baseline(self, query_ids: Sequence[int], cat: int):
        occ, scores, term_present = self.batch_inputs(query_ids)
        final, traj = self._run_plan_batch(self.plan_for_category(cat),
                                           occ, scores, term_present)
        return final, traj, (occ, scores, term_present)

    def production_step_rewards(self, traj) -> torch.Tensor:
        """Per-step r_agent of the production plan (Eq. 4's subtrahend),
        (B, L) from ``plan_rollout``'s (B, L) trajectory."""
        u = torch.clamp(traj["u"], min=1).to(torch.float32)
        v = traj["v"].to(torch.float32)
        n_top = self.env_cfg.n_top
        m = torch.clamp(torch.clamp(v, max=n_top), 1, n_top)
        return traj["topn_sum"] / (m * u)

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
        self._set_bins(fit_bins(np.concatenate(us), np.concatenate(vs),
                                p=self.cfg.p_bins, device=self.device))
        return self.bins

    # -------------------------------------------------------------- training
    def sample_train_qids(self, cat: int, batch: int,
                          rng: np.random.Generator) -> np.ndarray:
        """One training batch of query ids for a category (with
        replacement), drawn as the reference draws it."""
        qids_all = np.where(self.log.category == cat)[0]
        return rng.choice(qids_all, size=min(batch, len(qids_all)),
                          replace=True)

    def policy_train_step(self, cat: int, q: torch.Tensor, draws, eps: float,
                          qids: Sequence[int]):
        """One ε-greedy Q-learning iteration on a batch of query ids:
        production-plan rollout for Eq. 4's reward baseline, then
        ``train_batch``.  ``draws``: a ``torch.Generator`` on the
        system's device, or the (explore, uniform) (t_max, B) tensors.
        Returns (q, metrics)."""
        if self.bins is None:
            raise ValueError("fit_state_bins() first")
        occ, scores, term_present = self.batch_inputs(qids)
        _, traj = self._run_plan_batch(self.plan_for_category(cat), occ,
                                       scores, term_present)
        prod_r = self.production_step_rewards(traj)
        return train_batch(self.env_cfg, self.qcfg, self.ruleset, self.bins,
                           q, occ, scores, term_present, prod_r, eps, draws,
                           backend=self.cfg.backend)

    def train_policy(self, cat: int, iters: int = 150, batch: int = 64,
                     eps_start: float = 0.5, eps_end: float = 0.05,
                     seed: int = 0, log_every: int = 0):
        """Tabular Q-learning for one query category (the paper trains
        separate policies per category).  Query ids come from
        ``np.random.default_rng(seed)``, the ε-greedy draws from a
        ``torch.Generator`` seeded with ``seed`` on the system's device.
        Returns (q, history of per-iteration metrics)."""
        if self.bins is None:
            raise ValueError("fit_state_bins() first")
        rng_np = np.random.default_rng(seed)
        q = init_q(self.qcfg, self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        history = []
        for it in range(iters):
            qids = self.sample_train_qids(cat, batch, rng_np)
            eps = linear_epsilon(it, iters, eps_start, eps_end)
            q, metrics = self.policy_train_step(cat, q, gen, eps, qids)
            values = torch.stack(list(metrics.values())).tolist()
            history.append(dict(zip(metrics, values)))
            if log_every and it % log_every == 0:
                print(f"[cat{cat}] iter {it:4d} eps {eps:.2f} " +
                      " ".join(f"{k}={v:.4f}" for k, v in history[-1].items()))
        return q, history

    # ------------------------------------------------------------ policies
    def train_policy_store(self, cats: Sequence[int] = (CAT1, CAT2),
                           store: Optional[PolicyStore] = None,
                           staleness_bound: int = 1,
                           **train_kwargs) -> PolicyStore:
        """Train per-category tabular policies and publish one snapshot.
        Pass an existing ``store`` to publish a fresh version into it."""
        policies = {cat: TabularQPolicy(self.train_policy(cat, **train_kwargs)[0])
                    for cat in cats}
        if store is None:
            store = PolicyStore(staleness_bound=staleness_bound)
        store.publish(policies)
        return store

    def baseline_policies(self, cats: Sequence[int] = (CAT1, CAT2)):
        """The hand-tuned production plans as a {category: Policy} dict."""
        return {cat: self.plan_policy(cat) for cat in cats}

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
