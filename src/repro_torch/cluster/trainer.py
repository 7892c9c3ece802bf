"""Background trainer feeding a `PolicyStore` while replicas serve (the
port's copy of the reference's ``cluster/trainer.py``).

The paper's planner is trained *online*: Bing keeps learning the MDP
policy against live traffic while the index serves it.  This loop is
that trainer: per-category tabular Q-learning epochs
(`RetrievalSystem.policy_train_step`, the same `train_batch` unit as
offline training) run on a background thread, and every
``publish_every`` epochs a fresh `{category: TabularQPolicy}` snapshot
is published into the shared store — the replicas hot-swap to it at
their next drain.  Each publish carries the degraded-service
**fallback policies** in the same snapshot (live policy and its
SHALLOW fallback hot-swap atomically; see docs/cluster.md).

Training batches come from a **served-traffic tap** when one is wired
(`source=cluster.tap`): the trainer samples the queries the fleet
actually served — popularity-weighted by construction, with degraded
and shed tickets boosted — instead of drawing synthetic samples from
the query log.  That closes the paper's train-on-live-traffic loop:
the MDP spends its capacity exactly where serving pressure is.  With
no tap, the loop falls back to direct query-log sampling (the offline
shape used by tests and the standalone trainer CLI).

Publishes are **eval-gated** by default (the standard online-promotion
pattern): each candidate Q-table is scored on a fixed probe set with
the serving-path recall proxy (`probe_recall` — rollout + L1 prune,
bit-identical to what a 1-shard engine serves), and the snapshot always
carries the best scorer so far.  A version bump therefore never
regresses candidate quality on the probe set — the monotonicity the
online-learning demo asserts — while the cadence stays fixed (a
rejected candidate re-publishes the incumbent).

Random draws: training batches' query ids come from numpy
(``default_rng(seed)``), as in the reference; the ε-greedy draws from
one ``torch.Generator`` on the system's device seeded with ``seed``,
passed to every ``policy_train_step`` (the reference splits a
``jax.random`` key per step).  The generator is touched by the trainer
thread alone.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.qlearning import init_q, linear_epsilon
from repro_torch.core.rollout import unified_rollout
from repro_torch.core.telescope import l1_prune
from repro_torch.data.querylog import CAT1, CAT2
from repro_torch.obs import NULL_TRACER, Tracer
from repro_torch.policies import Policy, PolicyStore, TabularQPolicy

from .tap import ServedTrafficTap

__all__ = ["TrainerConfig", "TrainerLoop", "candidate_recall", "probe_recall"]


def candidate_recall(doc_ids: np.ndarray, judged_ids: np.ndarray,
                     judged_gains: np.ndarray) -> np.ndarray:
    """Per-query recall proxy: fraction of positively judged docs
    (gain > 0) present in the returned candidate ids.  ``doc_ids`` is
    (B, keep) with -1 padding; judged arrays are the query log's."""
    out = np.zeros(doc_ids.shape[0])
    keep = doc_ids.shape[1]
    for i in range(doc_ids.shape[0]):
        pos = judged_ids[i][(judged_ids[i] >= 0) & (judged_gains[i] > 0)]
        if len(pos) == 0:
            out[i] = 1.0
            continue
        got = np.intersect1d(doc_ids[i][doc_ids[i] >= 0], pos).size
        out[i] = got / min(len(pos), keep)
    return out


def probe_recall(system, policy: Policy, qids: Sequence[int],
                 keep: int = 100) -> float:
    """Mean candidate recall of ``policy`` on fixed probe queries via
    the serving path (rollout → L1 prune) — for a 1-shard engine with
    the same ``keep`` this is bit-identical to served responses
    (``tests/test_torch_serving.py`` holds the engine to the direct
    rollout), so a gate decision here is exactly a statement about
    serving quality."""
    qids = np.asarray(qids)
    occ, scores, tp = system.batch_inputs(qids)
    t_max = policy.horizon or system.qcfg.t_max
    fin = unified_rollout(system.env_cfg, system.ruleset, system.bins,
                          policy, t_max, occ, scores, tp,
                          backend=system.cfg.backend).final_state
    ids, _ = l1_prune(scores, fin.cand, keep=keep)
    return float(candidate_recall(ids.cpu().numpy(),
                                  system.log.judged_ids[qids],
                                  system.log.judged_gains[qids]).mean())


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    iters: int = 60               # total training epochs
    publish_every: int = 20       # epochs between publishes
    batch: int = 32               # queries per training batch
    eps_start: float = 0.5
    eps_end: float = 0.05
    seed: int = 0
    gate: bool = True             # eval-gated promotion (monotone probe score)
    probe_queries: int = 32       # probe-set size per category
    keep: int = 100               # L1 prune depth for probe scoring
    # Gate on a held-out slice of the served-traffic tap instead of the
    # fixed query-log probe set (needs a source with tap holdout
    # enabled; falls back to the fixed set while the holdout is empty).
    # The probe set is then fresh per gate, so the incumbent is
    # re-scored on the same queries — promotion compares both policies
    # on live traffic, but scores are no longer monotone in version
    # (each gate is a new sample), hence opt-in.
    probe_from_tap: bool = False
    publish_initial: bool = True  # publish v1 before any training
    fallback_plan_len: int = 2    # SHALLOW fallback = plan prefix of this many entries
    # With a served-traffic source, how long one epoch may wait for the
    # tap to fill before skipping a category's update (the fleet serves
    # concurrently, so early epochs briefly race the first responses).
    wait_for_source_s: float = 30.0


class TrainerLoop:
    """Runs ``cfg.iters`` epochs on a daemon thread, publishing every
    ``publish_every`` epochs (plus the initial snapshot), so a full run
    publishes ``publish_initial + iters // publish_every`` versions.

    ``source`` (a :class:`ServedTrafficTap`, typically
    ``cluster.tap``) switches training batches from query-log sampling
    to the cluster's served-traffic stream; it may also be assigned
    after construction but before :meth:`start` (the cluster is
    usually built after the trainer's first publish).
    """

    def __init__(self, system, store: PolicyStore,
                 cats: Sequence[int] = (CAT1, CAT2),
                 cfg: TrainerConfig = TrainerConfig(),
                 source: Optional[ServedTrafficTap] = None,
                 tracer: Tracer = NULL_TRACER):
        if system.bins is None:
            raise ValueError("fit_state_bins() first")
        self.system = system
        self.store = store
        self.cats = tuple(cats)
        self.cfg = cfg
        self.source = source
        self.tracer = tracer
        rng = np.random.default_rng(cfg.seed)
        self._rng = rng
        self._gen = torch.Generator(device=system.device).manual_seed(cfg.seed)
        self._qids_all = {c: np.where(system.log.category == c)[0]
                          for c in self.cats}
        self._q = {c: init_q(system.qcfg, system.device) for c in self.cats}
        self._best_q = dict(self._q)
        self._best_score: Dict[int, float] = {c: -np.inf for c in self.cats}
        # Degraded-service fallbacks ride along with every publish so a
        # snapshot is always (live policy, its fallback) as one unit.
        self._fallbacks = system.fallback_policies(
            self.cats, length=cfg.fallback_plan_len)
        self.probe_qids = {c: self._qids_all[c][: cfg.probe_queries]
                           for c in self.cats}
        self.history: List[dict] = []     # one row per publish
        self.epochs_done = 0
        self.tap_batches = 0              # batches drawn from the tap
        self.log_batches = 0              # batches drawn from the query log
        self.starved_batches = 0          # tap dry past the wait: skipped
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None

    # ------------------------------------------------------------ publish
    def _probe_set(self, cat: int) -> Tuple[np.ndarray, str]:
        """The gate's probe queries for one category: a fresh held-out
        sample of served traffic when tap gating is on and the holdout
        has filled, else the fixed query-log slice."""
        if self.cfg.probe_from_tap and self.source is not None:
            qids = self.source.holdout_sample(cat, self.cfg.probe_queries,
                                              self._rng)
            if qids is not None and len(qids):
                return qids, "tap"
        return self.probe_qids[cat], "log"

    def _gate(self) -> Tuple[Dict[int, Policy], Dict[int, float], Dict[int, str]]:
        """Score current Q-tables on the probe sets; promote improvers."""
        scores: Dict[int, float] = {}
        sources: Dict[int, str] = {}
        for c in self.cats:
            if not self.cfg.gate:
                self._best_q[c] = self._q[c]
                scores[c], sources[c] = float("nan"), "none"
                continue
            probe, sources[c] = self._probe_set(c)
            s = probe_recall(self.system, TabularQPolicy(self._q[c]),
                             probe, keep=self.cfg.keep)
            if sources[c] == "tap":
                # The probe set is a fresh traffic sample each gate, so
                # the incumbent's remembered score is for *different*
                # queries — re-score it on the same probe so promotion
                # compares the two policies apples-to-apples.
                incumbent = (s if self._best_q[c] is self._q[c]
                             else probe_recall(
                                 self.system, TabularQPolicy(self._best_q[c]),
                                 probe, keep=self.cfg.keep))
                promoted = s >= incumbent
                if promoted:
                    self._best_q[c] = self._q[c]
                scores[c] = self._best_score[c] = s if promoted else incumbent
            else:
                promoted = s >= self._best_score[c]
                if promoted:
                    self._best_score[c] = s
                    self._best_q[c] = self._q[c]
                scores[c] = self._best_score[c]
            self.tracer.instant("gate_decision", category=c,
                                probe_recall=s, promoted=promoted,
                                probe_source=sources[c])
        return ({c: TabularQPolicy(self._best_q[c]) for c in self.cats},
                scores, sources)

    def publish_now(self) -> int:
        """Gate + publish the current tables immediately (e.g. to get
        v1 up before replicas construct); returns the version."""
        with self.tracer.span("eval_gate") as gate_span:
            policies, scores, sources = self._gate()
            gate_span.end(probe_recall={str(c): scores[c]
                                        for c in self.cats})
        with self.tracer.span("publish") as pub_span:
            version = self.store.publish(policies,
                                         fallbacks=dict(self._fallbacks))
            pub_span.end(version=version)
        self.history.append({
            "version": version,
            "epoch": self.epochs_done,
            # Index epoch at publish time: correlates policy versions
            # with the corpus state they were trained against (0 on a
            # static index).
            "index_epoch": getattr(self.system, "index_epoch", 0),
            "probe_recall": {c: scores[c] for c in self.cats},
            "probe_source": sources,
            "tap_batches": self.tap_batches,
            "log_batches": self.log_batches,
        })
        return version

    # -------------------------------------------------------------- train
    def _sample(self, cat: int) -> Optional[np.ndarray]:
        """One training batch of qids: from the served-traffic tap when
        wired (waiting briefly while the fleet's first responses land),
        else from the query log.  None = starved (skip the update)."""
        if self.source is None:
            self.log_batches += 1
            return self.system.sample_train_qids(cat, self.cfg.batch,
                                                 self._rng)
        deadline = time.monotonic() + self.cfg.wait_for_source_s
        while not self._stop.is_set():
            qids = self.source.sample(cat, self.cfg.batch, self._rng)
            if qids is not None:
                self.tap_batches += 1
                self.tracer.instant("tap_draw", category=cat, n=len(qids))
                return qids
            if time.monotonic() >= deadline:
                break
            time.sleep(0.005)
        self.starved_batches += 1
        return None

    def _epoch(self, it: int) -> None:
        eps = linear_epsilon(it, self.cfg.iters, self.cfg.eps_start,
                             self.cfg.eps_end)
        with self.tracer.span("epoch", it=it):
            for c in self.cats:
                qids = self._sample(c)
                if qids is None:
                    continue              # tap starved: epoch still counts
                self._q[c], _ = self.system.policy_train_step(
                    c, self._q[c], self._gen, eps, qids)
        self.epochs_done += 1

    def _run(self) -> None:
        try:
            if self.cfg.publish_initial:
                self.publish_now()
            for it in range(self.cfg.iters):
                if self._stop.is_set():
                    return
                self._epoch(it)
                if (it + 1) % self.cfg.publish_every == 0:
                    self.publish_now()
        except BaseException as e:          # noqa: BLE001 — surfaced in join()
            self.error = e

    # ------------------------------------------------------------ control
    @property
    def versions_published(self) -> List[int]:
        return [row["version"] for row in self.history]

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "TrainerLoop":
        if self._thread is not None:
            raise RuntimeError("trainer already started")
        self._thread = threading.Thread(target=self._run, name="trainer",
                                        daemon=True)
        self._thread.start()
        return self

    def run_to_completion(self) -> "TrainerLoop":
        """Synchronous variant (tests, CLI without --serve)."""
        self._run()
        if self.error is not None:
            raise self.error
        return self

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)
        if self.error is not None:
            raise self.error
