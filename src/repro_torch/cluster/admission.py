"""Pressure-tiered admission: price queries in u, degrade before shedding
(the port's copy of the reference's ``cluster/admission.py``; host
numpy, float64 estimates).

The paper prices query evaluation in u — posting-plane block reads —
and shows it linear in machine time, so u is the honest unit for load
control too: a fleet saturates when the *sum of u being evaluated*
exceeds what the index machines stream, not when some request counter
does.  The :class:`AdmissionController` keeps a reservation ledger in
u, and instead of the binary admit/shed hammer it walks a **service
ladder** priced from the ledger's headroom (docs/cluster.md):

    FULL         while reservations stay under ``full_watermark`` of
                 the budget — normal serving, live policy.
    SHALLOW      while the (much smaller) shallow estimate still fits
                 the full budget — the snapshot's truncated static
                 plan, u bounded by its summed Δu quotas.
    CACHED_ONLY  when not even a shallow rollout fits but some
                 replica's result cache already holds the key (~zero u).
    SHED         explicit non-response, the valve of last resort.

Estimates come from the query's *pre-execution* features — the same
ones the paper's query categorizer uses (category, term document
frequencies): rare-term CAT1 queries force deep scans, head-df CAT2
queries satisfy their quotas early.  :class:`UCostEstimator` buckets
queries by (category, df-decile) and tracks an EMA of observed u per
bucket **per executed service level and per policy snapshot version**:
every served response feeds its realized u back, so the table is
learned online from the traffic the fleet actually serves — a new
policy version starts from the previous version's estimates as its
prior and re-learns its own costs (a deeper-scanning v7 must not be
priced with v6's numbers).

Live indexes add a second axis: a query whose terms have postings in
the head epoch's **delta segment** scans more (or different) blocks
than the mmapped base alone, so its realized u drifts away from the
base-learned table between merges.  The estimator keeps a per-(level,
category) *delta correction* — an EMA of the realized-u / table-value
ratio learned ONLY from epoch-stamped outcomes observed at the current
head epoch (a stale stamp describes a delta that no longer exists) —
and multiplies it into the estimate whenever the query's terms hit the
head delta.  Base buckets stay base-only; a merge empties the delta,
the hit probe goes false, and pricing falls back to the clean table.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.obs import MetricsRegistry
from repro_torch.serving.levels import EXECUTED_LEVELS, ServiceLevel

__all__ = ["Admission", "Shed", "UCostEstimator", "AdmissionController"]


@dataclasses.dataclass(frozen=True)
class Shed:
    """Explicit load-shed result (the non-response a caller can act on)."""
    qid: int
    category: int
    est_u: float
    reason: str


@dataclasses.dataclass(frozen=True)
class Admission:
    """One ladder decision: the granted level and what it reserved."""
    level: ServiceLevel
    est_u: float          # FULL-level estimate at decision time
    reserved_u: float     # what the ledger now holds for this query


class UCostEstimator:
    """(level, category, df-decile) -> EMA of observed u, versioned per
    policy snapshot.

    The df feature is the mean body-field document frequency of the
    query's terms as a fraction of the corpus (exactly the signal
    ``data.querylog.classify_query`` categorizes on); bucket edges are
    quantiles of that feature over the whole query log, so buckets are
    equal-mass.

    Version semantics: tables are keyed by the policy snapshot version
    that produced the observation.  A version's table is lazily seeded
    from the latest earlier version's *values* (so cold buckets inherit
    a sensible estimate) with its sample counts reset — the first
    observation under the new policy replaces the inherited value, the
    way the first observation replaces the configured prior at version
    0.  ``estimate`` reads the latest version by default, i.e. the
    policy the fleet is converging onto.  Only the last
    ``max_versions`` tables are retained.
    """

    def __init__(self, system, n_df_bins: int = 8, ema: float = 0.25,
                 prior_u: Optional[float] = None,
                 prior_shallow_u: Optional[float] = None,
                 max_versions: int = 4):
        log, index = system.log, system.index
        self._system = system
        self._df_body = index.df[:, 2].astype(np.float64)  # body field
        self._n_docs = int(index.n_docs)
        mean_df = np.zeros(log.n_queries)
        for qi in range(log.n_queries):
            ts = log.terms[qi, : log.n_terms[qi]]
            mean_df[qi] = self._df_body[ts].mean() if len(ts) else 0.0
        self._df_frac = mean_df / max(self._n_docs, 1)
        qs = np.linspace(0, 1, n_df_bins + 1)[1:-1]
        self._edges = np.quantile(self._df_frac, qs)
        self._category = log.category
        n_cats = int(self._category.max()) + 1
        if prior_u is None:
            # Half the episode budget: pessimistic enough that a cold
            # fleet degrades under a thundering herd, cheap to correct.
            prior_u = system.cfg.u_budget / 2
        if prior_shallow_u is None:
            # The shallow fallback has a hard cap (summed Δu quotas of
            # the truncated plan); without one configured, assume a
            # quarter of the full prior.
            prior_shallow_u = prior_u / 4
        self.prior_u = float(prior_u)
        self.prior_shallow_u = float(prior_shallow_u)
        self.ema = float(ema)
        self.max_versions = int(max_versions)
        self._shape = (len(EXECUTED_LEVELS), n_cats, n_df_bins)
        self._tables: Dict[int, np.ndarray] = {}
        self._seen: Dict[int, np.ndarray] = {}
        # Delta-aware pricing (live indexes): multiplicative correction
        # per (level, category) applied when the query's terms have
        # postings in the head epoch's delta; 1.0 = base pricing.
        self._delta_corr = np.ones((len(EXECUTED_LEVELS), n_cats))
        self._delta_seen = np.zeros((len(EXECUTED_LEVELS), n_cats),
                                    dtype=np.int64)
        self._delta_terms: frozenset = frozenset()
        self._delta_terms_version = -1
        self._lock = threading.Lock()
        self._init_version(0)

    # ---------------------------------------------------------- versions
    def _init_version(self, version: int) -> None:
        """Create the table for ``version`` (caller holds no lock for
        version 0; otherwise the estimator lock)."""
        if self._tables:
            base = max((v for v in self._tables if v <= version),
                       default=max(self._tables))
            table = self._tables[base].copy()
        else:
            table = np.empty(self._shape)
            table[int(ServiceLevel.FULL)] = self.prior_u
            table[int(ServiceLevel.SHALLOW)] = self.prior_shallow_u
        self._tables[version] = table
        self._seen[version] = np.zeros(self._shape, dtype=np.int64)
        while len(self._tables) > self.max_versions:
            oldest = min(self._tables)
            del self._tables[oldest], self._seen[oldest]

    @property
    def latest_version(self) -> int:
        return max(self._tables)

    def _resolve(self, version: Optional[int]) -> int:
        if version is None:
            return max(self._tables)
        if version in self._tables:
            return version
        # an evicted (or never-observed) version reads its nearest
        # retained predecessor, falling back to the oldest retained
        older = [v for v in self._tables if v <= version]
        return max(older) if older else min(self._tables)

    # ---------------------------------------------------------- features
    def _extend_features(self, qid: int) -> None:
        """A live query log grows (``append_queries``): price appended
        queries by lazily extending the per-query feature arrays from
        the current log.  Bucket edges stay fixed from the seed log —
        buckets are a stable coordinate system, not a moving target."""
        with self._lock:
            if qid < len(self._df_frac):
                return                   # another thread got here first
            log = self._system.log
            terms, n_terms = log.terms, log.n_terms
            category = log.category
            n = min(len(category), terms.shape[0], len(n_terms))
            old = len(self._df_frac)
            mean_df = np.zeros(max(0, n - old))
            for i, qi in enumerate(range(old, n)):
                ts = terms[qi, : n_terms[qi]]
                mean_df[i] = self._df_body[ts].mean() if len(ts) else 0.0
            self._df_frac = np.concatenate(
                [self._df_frac, mean_df / max(self._n_docs, 1)])
            self._category = category[:n]

    def features(self, qid: int) -> Tuple[int, int]:
        qid = int(qid)
        df_frac, category = self._df_frac, self._category
        if qid >= len(df_frac) or qid >= len(category):
            self._extend_features(qid)
            df_frac, category = self._df_frac, self._category
        cat = int(category[qid])
        df_bin = int(np.searchsorted(self._edges, df_frac[qid]))
        return cat, df_bin

    def features_many(self, qids) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized :meth:`features`: (categories, df-bins) for a
        whole slab in two gathers and one ``searchsorted``."""
        qids = np.asarray(qids, np.int64).ravel()
        if qids.size:
            top = int(qids.max())
            if (top >= len(self._df_frac) or top >= len(self._category)):
                self._extend_features(top)
        cats = np.asarray(self._category)[qids].astype(np.int64)
        bins = np.searchsorted(self._edges, self._df_frac[qids])
        return cats, bins

    # ------------------------------------------------------- delta pricing
    def _head_delta(self) -> Tuple[int, frozenset]:
        """(head epoch version, delta term set) — cached per epoch; a
        static system answers (-1, ∅) and never prices a correction."""
        store = getattr(self._system, "index_epoch_store", None)
        if store is None:
            return -1, frozenset()
        epoch = store.snapshot()
        with self._lock:
            if epoch.version != self._delta_terms_version:
                self._delta_terms = epoch.view.delta.terms_present()
                self._delta_terms_version = epoch.version
            return self._delta_terms_version, self._delta_terms

    def delta_hit(self, qid: int) -> bool:
        """True when any of the query's terms has postings in the HEAD
        epoch's delta segment — i.e. serving it scans delta blocks the
        base-learned table never saw."""
        _, terms = self._head_delta()
        if not terms:
            return False
        log = self._system.log
        qid = int(qid)
        ts = log.terms[qid, : log.n_terms[qid]]
        return any(int(t) in terms for t in ts)

    def delta_hits_many(self, qids) -> np.ndarray:
        """Vectorized :meth:`delta_hit`: one ``np.isin`` over the
        slab's term matrix against the head delta's term set."""
        qids = np.asarray(qids, np.int64).ravel()
        _, terms = self._head_delta()
        if not terms or qids.size == 0:
            return np.zeros(qids.size, bool)
        log = self._system.log
        tm = np.asarray(log.terms)[qids]
        nt = np.asarray(log.n_terms)[qids]
        present = np.isin(tm, np.fromiter(terms, np.int64, len(terms)))
        valid = np.arange(tm.shape[1])[None, :] < nt[:, None]
        return (present & valid).any(axis=1)

    def estimate(self, qid: int,
                 level: ServiceLevel = ServiceLevel.FULL,
                 version: Optional[int] = None) -> float:
        if level not in EXECUTED_LEVELS:
            raise ValueError(f"no u estimate for non-executed level {level!r}")
        cat, df_bin = self.features(qid)
        hit = self.delta_hit(qid)
        with self._lock:
            est = float(self._tables[self._resolve(version)][
                int(level), cat, df_bin])
            if hit:
                est *= float(self._delta_corr[int(level), cat])
            return est

    def estimates(self, qid: int,
                  version: Optional[int] = None) -> Tuple[float, float]:
        """(FULL, SHALLOW) estimates in one feature lookup and one lock
        acquisition — the admission hot path prices both rungs."""
        cat, df_bin = self.features(qid)
        hit = self.delta_hit(qid)
        with self._lock:
            col = self._tables[self._resolve(version)][:, cat, df_bin]
            corr = self._delta_corr[:, cat] if hit else None
            full = float(col[int(ServiceLevel.FULL)])
            shallow = float(col[int(ServiceLevel.SHALLOW)])
            if corr is not None:
                full *= float(corr[int(ServiceLevel.FULL)])
                shallow *= float(corr[int(ServiceLevel.SHALLOW)])
            return full, shallow

    def estimates_many(self, qids, version: Optional[int] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized :meth:`estimates`: (FULL, SHALLOW) estimate
        arrays for a whole slab priced under ONE lock acquisition —
        features and delta probes vectorize outside it, the table read
        is a fancy-index gather inside it.  Elementwise identical to a
        loop of scalar ``estimates`` calls (float64 throughout)."""
        cats, bins = self.features_many(qids)
        hits = self.delta_hits_many(qids)
        with self._lock:
            table = self._tables[self._resolve(version)]
            full = table[int(ServiceLevel.FULL), cats, bins].astype(
                np.float64, copy=True)
            shallow = table[int(ServiceLevel.SHALLOW), cats, bins].astype(
                np.float64, copy=True)
            if hits.any():
                hcats = cats[hits]
                full[hits] *= self._delta_corr[int(ServiceLevel.FULL), hcats]
                shallow[hits] *= self._delta_corr[
                    int(ServiceLevel.SHALLOW), hcats]
        return full, shallow

    def observe(self, qid: int, u: float,
                level: ServiceLevel = ServiceLevel.FULL,
                version: Optional[int] = None,
                index_epoch: Optional[int] = None) -> None:
        """Feed one served response's realized u back (online learning
        from the traffic the fleet actually serves).  ``index_epoch``
        is the epoch stamp the response carries; delta-touching
        outcomes train the per-category correction instead of the base
        table, and only when stamped at the current head (a stale
        stamp priced a delta that has since merged or grown)."""
        if level not in EXECUTED_LEVELS:
            return                       # cached/shed responses cost no u
        cat, df_bin = self.features(qid)
        head_epoch, _terms = self._head_delta()
        hit = self.delta_hit(qid)
        with self._lock:
            if version is None:
                version = max(self._tables)
            elif version not in self._tables:
                if version < min(self._tables):
                    return               # older than anything retained
                self._init_version(version)
            idx = (int(level), cat, df_bin)
            table, seen = self._tables[version], self._seen[version]
            if hit:
                # Keep the base table base-only: this outcome includes
                # delta scanning, so it trains the correction ratio —
                # and only when observed AT the head epoch.
                if index_epoch is None or index_epoch != head_epoch:
                    return
                ratio = float(u) / max(float(table[idx]), 1e-9)
                cidx = (int(level), cat)
                if self._delta_seen[cidx] == 0:
                    self._delta_corr[cidx] = ratio
                else:
                    self._delta_corr[cidx] += self.ema * (
                        ratio - self._delta_corr[cidx])
                self._delta_seen[cidx] += 1
                return
            if seen[idx] == 0:
                table[idx] = float(u)    # drop the (inherited) prior
            else:
                table[idx] += self.ema * (float(u) - table[idx])
            seen[idx] += 1

    def describe(self) -> dict:
        with self._lock:
            latest = max(self._tables)
            return {
                "n_df_bins": self._shape[2],
                "prior_u": self.prior_u,
                "prior_shallow_u": self.prior_shallow_u,
                "versions": sorted(self._tables),
                "buckets_seen": int((self._seen[latest] > 0).sum()),
                "table": self._tables[latest].round(1).tolist(),
                "delta_corr": self._delta_corr.round(3).tolist(),
                "delta_obs": int(self._delta_seen.sum()),
                "delta_terms_epoch": self._delta_terms_version,
            }


class AdmissionController:
    """Fleet-wide u reservation ledger pricing the service ladder.

    ``decide`` walks the ladder against the ledger's headroom and
    reserves what the granted level will cost; ``release`` returns the
    reservation and, given the realized u, improves the estimator for
    the (level, snapshot-version) that produced it.  Two shapes:

    - **ladder** (default): FULL while reservations stay under
      ``full_watermark * budget`` (so FULL traffic can never starve the
      degraded tiers of headroom), SHALLOW while the shallow estimate
      fits the whole budget, CACHED_ONLY when the caller reports a
      cache entry exists, SHED last.  An idle fleet always grants FULL
      (otherwise an oversized query could never run at all).
    - **binary** (``ladder=False``): the pre-ladder behaviour — FULL if
      the estimate fits, SHED otherwise — kept as the benchmark
      baseline the degradation sweep compares against.
    """

    def __init__(self, estimator: UCostEstimator,
                 u_inflight_budget: float = float("inf"),
                 ladder: bool = True,
                 full_watermark: float = 0.5,
                 registry: Optional[MetricsRegistry] = None):
        if u_inflight_budget <= 0:
            raise ValueError("u_inflight_budget must be > 0")
        if not 0.0 < full_watermark <= 1.0:
            raise ValueError("full_watermark must be in (0, 1]")
        self.estimator = estimator
        self.u_inflight_budget = float(u_inflight_budget)
        self.ladder = bool(ladder)
        self.full_watermark = float(full_watermark)
        self._lock = threading.Lock()
        self.reserved_u = 0.0
        self.admitted = 0
        self.shed = 0
        self.level_counts: Dict[int, int] = {int(l): 0 for l in ServiceLevel}
        # Mirror the ladder mix and the ledger level into the shared
        # metrics plane (the SLO control loop watches reserved_u's peak
        # against the budget); a standalone controller gets a private
        # registry so the recording code has one shape.
        reg = registry if registry is not None else MetricsRegistry()
        self._decision_counters = {
            int(l): reg.counter("admission.decisions", level=l.name)
            for l in ServiceLevel}
        self._g_reserved = reg.gauge("admission.reserved_u")

    # -------------------------------------------------------------- decide
    def decide(self, qid: int, cache_available: bool = False,
               shallow_available: bool = True) -> Admission:
        """Price one query against the ledger; reserves the granted
        level's estimated u and returns the :class:`Admission`.  The
        caller reports whether some replica's result cache holds the
        query's key (the CACHED_ONLY rung is only real if it does) and
        whether the serving snapshot carries a fallback policy for the
        query's category (no fallback — no SHALLOW rung)."""
        est_full, est_shallow = self.estimator.estimates(qid)
        budget = self.u_inflight_budget
        with self._lock:
            if not self.ladder:
                # binary baseline: PR-4 semantics, verbatim
                if (self.reserved_u > 0
                        and self.reserved_u + est_full > budget):
                    level, reserve = ServiceLevel.SHED, 0.0
                else:
                    level, reserve = ServiceLevel.FULL, est_full
            else:
                # The watermark exists to keep reservation headroom for
                # the SHALLOW rung; with no fallback for this query the
                # FULL rung may use the whole budget (capping it there
                # would make the ladder serve strictly LESS than the
                # binary controller it replaced).  CACHED_ONLY reserves
                # nothing, so it needs no protected headroom.
                full_cap = (self.full_watermark * budget
                            if shallow_available else budget)
                if (self.reserved_u == 0
                        or self.reserved_u + est_full <= full_cap):
                    # idle fleets always serve FULL; busy fleets only
                    # while FULL traffic leaves the degraded tiers
                    # their headroom
                    level, reserve = ServiceLevel.FULL, est_full
                elif (shallow_available
                        and self.reserved_u + est_shallow <= budget):
                    level, reserve = ServiceLevel.SHALLOW, est_shallow
                elif cache_available:
                    level, reserve = ServiceLevel.CACHED_ONLY, 0.0
                else:
                    level, reserve = ServiceLevel.SHED, 0.0
            self.reserved_u += reserve
            self.level_counts[int(level)] += 1
            if level == ServiceLevel.SHED:
                self.shed += 1
            else:
                self.admitted += 1
            self._decision_counters[int(level)].inc()
            self._g_reserved.set(self.reserved_u)
            return Admission(level=level, est_u=est_full, reserved_u=reserve)

    def decide_many(self, qids, cache_available=None,
                    shallow_available=None):
        """Price a whole arrival slab against the ledger under ONE lock
        acquisition; returns ``(levels, reserves, est_full)`` arrays.

        Estimation — the expensive part — vectorizes fully outside the
        lock via :meth:`UCostEstimator.estimates_many`.  The ladder
        walk itself stays a scalar sweep *inside* the lock because each
        decision's headroom depends on every earlier reservation in the
        slab; that sweep is a handful of float compares per query, and
        running it under one acquisition is exactly what makes the
        result bit-identical to a loop of :meth:`decide` calls (the
        B=1 oracle) while paying one lock, one gauge store, and one
        counter pass per slab."""
        qids = np.asarray(qids, np.int64).ravel()
        n = qids.size
        cache_av = (np.zeros(n, bool) if cache_available is None
                    else np.asarray(cache_available, bool).ravel())
        shallow_av = (np.ones(n, bool) if shallow_available is None
                      else np.asarray(shallow_available, bool).ravel())
        est_full, est_shallow = self.estimator.estimates_many(qids)
        budget = self.u_inflight_budget
        levels = np.empty(n, np.int8)
        reserves = np.zeros(n, np.float64)
        with self._lock:
            for i in range(n):
                ef = float(est_full[i])
                if not self.ladder:
                    if (self.reserved_u > 0
                            and self.reserved_u + ef > budget):
                        level, reserve = ServiceLevel.SHED, 0.0
                    else:
                        level, reserve = ServiceLevel.FULL, ef
                else:
                    full_cap = (self.full_watermark * budget
                                if shallow_av[i] else budget)
                    if (self.reserved_u == 0
                            or self.reserved_u + ef <= full_cap):
                        level, reserve = ServiceLevel.FULL, ef
                    elif (shallow_av[i] and self.reserved_u
                          + float(est_shallow[i]) <= budget):
                        level, reserve = (ServiceLevel.SHALLOW,
                                          float(est_shallow[i]))
                    elif cache_av[i]:
                        level, reserve = ServiceLevel.CACHED_ONLY, 0.0
                    else:
                        level, reserve = ServiceLevel.SHED, 0.0
                self.reserved_u += reserve
                self.level_counts[int(level)] += 1
                levels[i] = int(level)
                reserves[i] = reserve
            n_shed = int((levels == int(ServiceLevel.SHED)).sum())
            self.shed += n_shed
            self.admitted += n - n_shed
            self._g_reserved.set(self.reserved_u)
        vals, counts = np.unique(levels, return_counts=True)
        for v, c in zip(vals, counts):
            self._decision_counters[int(v)].inc(int(c))
        return levels, reserves, est_full

    def release(self, reserved_u: float, actual_u: Optional[float] = None,
                qid: Optional[int] = None,
                level: ServiceLevel = ServiceLevel.FULL,
                version: Optional[int] = None,
                index_epoch: Optional[int] = None) -> None:
        """Return a reservation; with the realized u (non-cached
        responses only), feed the estimator for the (level, snapshot
        version) that served it — ``index_epoch`` stamps the outcome
        for the estimator's delta-aware correction."""
        with self._lock:
            self.reserved_u = max(0.0, self.reserved_u - reserved_u)
            self._g_reserved.set(self.reserved_u)
        if actual_u is not None and qid is not None:
            self.estimator.observe(qid, actual_u, level=level,
                                   version=version,
                                   index_epoch=index_epoch)

    def stats(self) -> dict:
        with self._lock:
            return {
                "u_inflight_budget": self.u_inflight_budget,
                "ladder": self.ladder,
                "full_watermark": self.full_watermark,
                "reserved_u": self.reserved_u,
                "admitted": self.admitted,
                "shed": self.shed,
                "levels": {ServiceLevel(k).name: v
                           for k, v in sorted(self.level_counts.items())},
            }
