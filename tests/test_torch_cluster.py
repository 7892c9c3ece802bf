"""The port's thread-backed cluster (``repro_torch.cluster``) and the rest
of its observability plane (``obs.events``, ``obs.health``, ``obs.slo``)
on ``tiny_system``: every case of ``tests/test_cluster.py`` and the cases
of ``tests/test_obs.py`` that need no process cell, ported case for
case, plus three gates against the JAX package.

C1 holds the host-side decision code bit for bit: on the same inputs
the router's picks, the u estimator's features and float64 estimates
and the admission controller's decisions (ladder and binary, scalar and
slab) equal the reference classes'.

C2 holds the fleet: a 2-replica ``ReplicaSet`` over the port system that
answers ``batch_inputs`` with the reference's arrays
(``test_torch_serving.ReferenceInputs``) gives ``ServeResponse``s equal
to the reference ``ReplicaSet``'s over one stream, in every field but
latency, and equal ``stats()`` counts.  Routing is timing-free there:
waves of distinct keys, each served to completion before the next, and
a spill margin wider than any wave, so a first-seen key goes to its
hash-preferred replica and a repeat to its cache owner in both fleets.

C3 holds the trainer: ``TrainerLoop.run_to_completion`` on the same
reference inputs, with the reference key's split sequence replayed as
ε-greedy draws (``policy_train_step`` wrapped here; the port takes a
generator or draws and has no knob for this), publishes the same
versions with equal gate scores.  Its Q-tables agree within
``1e-6 × (1 + |q|)``: Gate 2's TD-update tolerance
(``tests/test_torch_train_system.py``), the sums of each cell in
another order, once a step.

Every wait has a timeout.
"""
import json
import sys
import threading
import time

import jax
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.cluster import AdmissionController as JAdmissionController
from repro.cluster import ClusterConfig as JClusterConfig
from repro.cluster import QueueAwareRouter as JQueueAwareRouter
from repro.cluster import ReplicaSet as JReplicaSet
from repro.cluster import RoundRobinRouter as JRoundRobinRouter
from repro.cluster import TrainerConfig as JTrainerConfig
from repro.cluster import TrainerLoop as JTrainerLoop
from repro.cluster import UCostEstimator as JUCostEstimator
from repro.cluster import stable_query_hash as jstable_query_hash
from repro.policies import PolicyStore as JPolicyStore
from repro.serving import EngineConfig as JEngineConfig
from repro_torch.cluster import (
    AdmissionController, ClusterConfig, QueueAwareRouter, Replica,
    ReplicaSet, RoundRobinRouter, ServedTrafficTap, ServiceLevel, Shed,
    TrainerConfig, TrainerLoop, UCostEstimator, candidate_recall,
    make_router, stable_query_hash,
)
from repro_torch.cluster.replica import ClusterTicket
from repro_torch.data.querylog import CAT1, CAT2
from repro_torch.kernels.native import NativeKernel
from repro_torch.obs import (EventLog, FlightRecorder, HeartbeatWatchdog,
                             MetricsRegistry, SLOConfig, SLOMonitor, Tracer,
                             fold_snapshot)
from repro_torch.policies import PolicyStore
from repro_torch.serving import EngineConfig
from repro_torch.serving.cache import canonical_query_key
from repro_torch.serving.telemetry import LATENCY_MS_EDGES
from test_obs import _load_checker
from test_torch_serving import (ReferenceInputs, _direct, port_system,  # noqa: F401
                                reference, trained)
from test_torch_train_system import jax_draws

TIMEOUT_S = 120.0
Q_TOL = 1e-6                    # × (1 + |q|): Gate 2's TD tolerance


def _store(policies, staleness_bound=2, fallbacks=None):
    store = PolicyStore(staleness_bound=staleness_bound)
    store.publish(dict(policies), fallbacks=fallbacks)
    return store


# ------------------------------------------------------------------ router
def test_queue_aware_router_affinity_and_spill():
    r = QueueAwareRouter(spill_margin=4, owner_spill_depth=None)
    depths = [0, 0, 0, 0]
    h = stable_query_hash((1, (3, 5, 9)))
    pref = h % 4
    assert r.pick(h, depths) == pref                  # balanced: affinity
    depths = [10, 10, 10, 10]
    depths[pref] = 14
    assert r.pick(h, depths) == pref                  # gap == margin: stay
    depths[pref] = 15                                 # gap > margin: spill
    spilled = r.pick(h, depths)
    assert spilled != pref and depths[spilled] == 10
    assert r.stats()["spills"] == 1
    assert r.stats()["affinity_picks"] == 2
    # owner_spill_depth=None: a known cache owner wins regardless of
    # depth (a hit is ~free)
    assert r.pick(h, [100, 0, 0, 0], owner=0) == 0
    assert r.stats()["sticky_picks"] == 1


def test_queue_aware_router_owner_saturation_spill():
    """A likely-hit key spills off its saturated cache owner to the
    depth-balanced path instead of queueing behind the hot replica —
    even when the owner is also the hash-preferred replica."""
    r = QueueAwareRouter(spill_margin=2, owner_spill_depth=8)
    depths = [8, 1, 1, 1]
    assert r.pick(0, depths, owner=0) == 0
    assert r.stats()["sticky_picks"] == 1
    depths = [9, 1, 1, 1]
    assert r.pick(0, depths, owner=0) == 1
    assert r.stats()["owner_spills"] == 1
    assert r.pick(2, depths, owner=0) == 2
    st_ = r.stats()
    assert st_["owner_spills"] == 2 and st_["affinity_picks"] == 1
    assert r.pick(0, [9, 30, 30, 30], owner=0) == 0
    with pytest.raises(ValueError):
        QueueAwareRouter(owner_spill_depth=-1)


def test_round_robin_router_cycles():
    r = RoundRobinRouter()
    picks = [r.pick(123, [0, 0, 0]) for _ in range(6)]
    assert picks == [0, 1, 2, 0, 1, 2]


def test_stable_query_hash_deterministic():
    key = (1, (3, 5, 9))
    assert stable_query_hash(key) == stable_query_hash((1, (3, 5, 9)))
    assert stable_query_hash(key) != stable_query_hash((0, (3, 5, 9)))


def test_make_router_errors():
    assert make_router("round_robin").name == "round_robin"
    with pytest.raises(ValueError, match="routing"):
        make_router("no_such_routing")


# --------------------------------------------------------------- admission
def test_ucost_estimator_prior_then_observation(port_system):
    est = UCostEstimator(port_system, prior_u=100.0)
    assert est.estimate(0) == 100.0                   # cold: prior
    est.observe(0, 40.0)
    assert est.estimate(0) == 40.0                    # first sample replaces
    est.observe(0, 80.0)
    assert 40.0 < est.estimate(0) < 80.0              # EMA thereafter
    cat, df_bin = est.features(0)
    assert cat == int(port_system.log.category[0])
    assert 0 <= df_bin < 8
    assert est.estimate(0, ServiceLevel.SHALLOW) == 25.0
    est.observe(0, 7.0, level=ServiceLevel.SHALLOW)
    assert est.estimate(0, ServiceLevel.SHALLOW) == 7.0
    assert 40.0 < est.estimate(0) < 80.0              # FULL row untouched


def test_admission_binary_mode_budget_and_shed(port_system):
    """ladder=False: FULL if the estimate fits the budget, explicit SHED
    otherwise."""
    est = UCostEstimator(port_system, prior_u=100.0)
    adm = AdmissionController(est, u_inflight_budget=250.0, ladder=False)
    a1 = adm.decide(0)
    a2 = adm.decide(1)
    assert a1.level == a2.level == ServiceLevel.FULL
    assert a1.reserved_u == a2.reserved_u == 100.0
    a3 = adm.decide(2)                                # 300 > 250: shed
    assert a3.level == ServiceLevel.SHED and a3.reserved_u == 0.0
    assert adm.stats()["shed"] == 1
    adm.release(a1.reserved_u)
    assert adm.decide(2).level == ServiceLevel.FULL   # freed: admit again
    adm.release(a2.reserved_u, actual_u=20.0, qid=1)
    assert est.estimate(1) == 20.0


def test_admission_ladder_walks_every_rung(port_system):
    """As the ledger fills, decisions walk FULL → SHALLOW →
    CACHED_ONLY → SHED, each rung reserving what it will cost."""
    est = UCostEstimator(port_system, prior_u=100.0, prior_shallow_u=10.0)
    adm = AdmissionController(est, u_inflight_budget=200.0,
                              full_watermark=0.5)
    a1 = adm.decide(0)
    assert a1.level == ServiceLevel.FULL and a1.reserved_u == 100.0
    a2 = adm.decide(1)
    assert a2.level == ServiceLevel.SHALLOW and a2.reserved_u == 10.0
    fills = [adm.decide(q) for q in range(2, 11)]
    assert all(f.level == ServiceLevel.SHALLOW for f in fills)
    hot = adm.decide(12)
    assert hot.level == ServiceLevel.SHED             # no cache: last rung
    cached = adm.decide(13, cache_available=True)
    assert cached.level == ServiceLevel.CACHED_ONLY
    assert cached.reserved_u == 0.0
    st_ = adm.stats()
    assert st_["levels"]["SHED"] == 1 and st_["levels"]["CACHED_ONLY"] == 1
    assert st_["levels"]["FULL"] == 1 and st_["levels"]["SHALLOW"] >= 10


def test_admission_ladder_without_degraded_tiers_matches_binary(port_system):
    """With no fallback and no cache for a query, the FULL rung may use
    the WHOLE budget."""
    est = UCostEstimator(port_system, prior_u=100.0)
    ladder = AdmissionController(est, u_inflight_budget=250.0,
                                 full_watermark=0.5)
    decisions = [ladder.decide(q, shallow_available=False)
                 for q in range(3)]
    assert [d.level for d in decisions] == \
        [ServiceLevel.FULL, ServiceLevel.FULL, ServiceLevel.SHED]
    assert ladder.decide(3, cache_available=True,
                         shallow_available=False).level == \
        ServiceLevel.CACHED_ONLY


def test_admission_oversized_query_admitted_when_idle(port_system):
    adm = AdmissionController(UCostEstimator(port_system, prior_u=500.0,
                                             prior_shallow_u=400.0),
                              u_inflight_budget=250.0)
    a1 = adm.decide(0)
    assert a1.level == ServiceLevel.FULL              # idle fleet: let it run
    assert a1.reserved_u == 500.0
    assert adm.decide(1).level == ServiceLevel.SHED   # but only alone


# ----------------------------------------------- estimator online learning
def test_ucost_estimator_versioned_per_snapshot(port_system):
    est = UCostEstimator(port_system, prior_u=100.0)
    est.observe(0, 40.0, version=1)
    est.observe(0, 50.0, version=1)
    v1 = est.estimate(0, version=1)
    assert 40.0 < v1 <= 50.0
    assert est.estimate(0, version=2) == v1
    est.observe(0, 400.0, version=2)
    assert est.estimate(0, version=2) == 400.0
    assert est.estimate(0, version=1) == v1
    assert est.estimate(0) == 400.0
    assert est.describe()["versions"] == [0, 1, 2]


def test_ucost_estimator_version_retention(port_system):
    est = UCostEstimator(port_system, prior_u=100.0, max_versions=2)
    for v in (1, 2, 3, 4):
        est.observe(0, 10.0 * v, version=v)
    assert est.describe()["versions"] == [3, 4]
    assert est.estimate(0, version=1) == est.estimate(0, version=3)
    est.observe(0, 999.0, version=1)
    assert est.describe()["versions"] == [3, 4]
    assert est.estimate(0, version=4) == 40.0


def test_ucost_estimator_ema_converges_to_served_u(trained):
    """Realized u from actually-served responses: the estimate
    converges to the (stationary) served cost."""
    sys_, policies = trained
    cluster = ReplicaSet(sys_, _store(policies), ClusterConfig(n_replicas=1),
                         EngineConfig(min_bucket=8, max_bucket=8,
                                      cache_capacity=0))
    qid = int(np.where(sys_.log.category == CAT1)[0][0])
    with cluster:
        results = cluster.serve([qid] * 12, timeout_s=TIMEOUT_S)
    assert not any(isinstance(r, Shed) for r in results)
    true_u = results[0].u
    assert all(r.u == true_u for r in results)
    est = cluster.admission.estimator
    assert est.estimate(qid, version=1) == true_u
    assert est.describe()["buckets_seen"] >= 1


@settings(deadline=None, max_examples=8)
@given(st.integers(0, 2**31 - 1), st.integers(1, 2000))
def test_ucost_estimator_error_monotone_on_stationary_stream(
        port_system, seed, true_u):
    rng = np.random.default_rng(seed)
    est = UCostEstimator(port_system, prior_u=997.0)
    qid = int(rng.integers(0, port_system.log.n_queries))
    errors = [abs(est.estimate(qid) - true_u)]
    for _ in range(6):
        est.observe(qid, float(true_u))
        errors.append(abs(est.estimate(qid) - true_u))
    assert all(b <= a + 1e-9 for a, b in zip(errors, errors[1:])), errors
    assert errors[-1] < 1e-9


# ------------------------------------------------------- served-traffic tap
def test_tap_popularity_weighting_and_shed_boost():
    tap = ServedTrafficTap(capacity=64, degraded_boost=3.0)
    rng = np.random.default_rng(0)
    assert tap.sample(0, 8, rng) is None
    for _ in range(9):
        tap.record(7, 0, ServiceLevel.FULL)
    tap.record(3, 0, ServiceLevel.FULL)
    tap.record(5, 0, ServiceLevel.SHED)
    tap.record(11, 1, ServiceLevel.FULL)
    qids = tap.sample(0, 4096, rng)
    counts = {q: int((qids == q).sum()) for q in (7, 3, 5, 11)}
    assert counts[11] == 0
    assert counts[7] > 4 * counts[3]
    assert counts[5] > 1.5 * counts[3]
    st_ = tap.stats()
    assert st_["n_recorded"] == 12
    assert st_["levels"]["SHED"] == 1
    assert tap.size(0) == 11 and tap.size() == 12


def test_tap_recency_window():
    tap = ServedTrafficTap(capacity=4)
    for q in range(10):
        tap.record(q, 0)
    qids = tap.sample(0, 256, np.random.default_rng(1))
    assert set(qids) <= {6, 7, 8, 9}


def test_trainer_consumes_tap_not_query_log(port_system, monkeypatch):
    """With a served-traffic source the trainer NEVER samples the query
    log: every batch is drawn from the tap."""
    tap = ServedTrafficTap(capacity=512)
    rng = np.random.default_rng(2)
    for cat in (CAT1, CAT2):
        for qid in np.where(port_system.log.category == cat)[0][:16]:
            for _ in range(int(rng.integers(1, 4))):
                tap.record(int(qid), cat)
    monkeypatch.setattr(
        port_system, "sample_train_qids",
        lambda *a, **k: pytest.fail("trainer sampled the query log"))
    store = PolicyStore(staleness_bound=2)
    trainer = TrainerLoop(port_system, store, cfg=TrainerConfig(
        iters=4, publish_every=2, batch=8, probe_queries=8), source=tap)
    trainer.run_to_completion()
    assert trainer.versions_published == [1, 2, 3]
    assert trainer.tap_batches == 4 * 2
    assert trainer.log_batches == 0
    assert trainer.starved_batches == 0
    snap = store.snapshot()
    assert set(snap.fallbacks) == {CAT1, CAT2}
    for cat in (CAT1, CAT2):
        assert snap.fallbacks[cat].horizon == 2


# ------------------------------------------------------------- replica set
def test_replica_set_matches_direct_rollout(trained):
    """Non-shed responses through N replicas equal the single-host path,
    whatever replica served them."""
    sys_, policies = trained
    cluster = ReplicaSet(sys_, _store(policies), ClusterConfig(n_replicas=2),
                         EngineConfig(min_bucket=8, max_bucket=8,
                                      cache_capacity=0))
    rng = np.random.default_rng(4)
    qids = rng.integers(0, sys_.log.n_queries, size=24)
    with cluster:
        results = cluster.serve(qids, timeout_s=TIMEOUT_S)
    ids, sc, u = _direct(sys_, policies, qids)
    assert not any(isinstance(r, Shed) for r in results)
    for lane, r in enumerate(results):
        assert r.qid == qids[lane]
        np.testing.assert_array_equal(r.doc_ids, ids[lane])
        np.testing.assert_allclose(r.scores, sc[lane], rtol=1e-6)
        assert r.u == u[lane]
        assert r.policy_version == 1
    stats = cluster.stats()
    assert stats["n_submitted"] == stats["n_responses"] == len(qids)
    assert stats["shed_rate"] == 0.0
    assert stats["version_lag_observed_max"] == 0


def test_cluster_sheds_explicitly_under_tight_budget(trained):
    sys_, policies = trained
    cluster = ReplicaSet(
        sys_, _store(policies),
        ClusterConfig(n_replicas=2, u_inflight_budget=1.0, prior_u=50.0),
        EngineConfig(min_bucket=8, max_bucket=8, cache_capacity=0))
    with cluster:
        results = cluster.serve(np.arange(16), timeout_s=TIMEOUT_S)
    sheds = [r for r in results if isinstance(r, Shed)]
    served = [r for r in results if not isinstance(r, Shed)]
    assert sheds and served
    assert all(s.reason == "u_budget_hot" for s in sheds)
    assert all(s.est_u > 0 for s in sheds)
    stats = cluster.stats()
    assert stats["n_shed"] == len(sheds)
    assert stats["n_submitted"] == stats["n_responses"] + stats["n_shed"]


def test_cluster_ladder_degrades_instead_of_shedding(trained):
    """Under pressure the ladder answers with bounded-u SHALLOW rollouts
    instead of shedding; the binary controller sheds the same stream."""
    sys_, policies = trained
    shallow_cap = max(sys_.shallow_u_cap(c) for c in (CAT1, CAT2))
    budget = 64 * shallow_cap + 2 * 1000.0
    qids = np.arange(24)
    results = {}
    for ladder in (True, False):
        cluster = ReplicaSet(
            sys_, _store(policies, fallbacks=sys_.fallback_policies()),
            ClusterConfig(n_replicas=2, ladder=ladder,
                          u_inflight_budget=budget, prior_u=1000.0,
                          prior_shallow_u=float(shallow_cap)),
            EngineConfig(min_bucket=8, max_bucket=8, cache_capacity=0))
        with cluster:
            tickets = [cluster.submit(int(q)) for q in qids]
            results[ladder] = ([t.result(timeout=TIMEOUT_S) for t in tickets],
                               tickets, cluster.stats())
    res, tickets, stats = results[True]
    served = [r for r in res if not isinstance(r, Shed)]
    shallow = [r for r in served if r.level == ServiceLevel.SHALLOW]
    assert not any(isinstance(r, Shed) for r in res)
    assert shallow, "expected degraded service under pressure"
    for r in shallow:
        assert (r.doc_ids >= 0).any()
        assert 0 < r.u <= shallow_cap
    assert stats["admission"]["levels"]["SHALLOW"] >= len(shallow)
    bin_res, _, bin_stats = results[False]
    assert sum(isinstance(r, Shed) for r in bin_res) > 0
    assert stats["served_fraction"] > bin_stats["served_fraction"]
    full = [r for r in served if r.level == ServiceLevel.FULL]
    ids, sc, u = _direct(sys_, policies, [r.qid for r in full])
    for lane, r in enumerate(full):
        np.testing.assert_array_equal(r.doc_ids, ids[lane])
        assert r.u == u[lane]


def test_cache_affinity_routes_repeats_to_one_replica(trained):
    """Repeats of one hot query stay on its preferred replica and hit
    its result cache; the fleet pays exactly one rollout for them."""
    sys_, policies = trained
    cluster = ReplicaSet(sys_, _store(policies),
                         ClusterConfig(n_replicas=2, routing="queue_aware",
                                       spill_margin=64),
                         EngineConfig(min_bucket=8, max_bucket=8,
                                      cache_capacity=64))
    qid = int(np.where(sys_.log.category == CAT1)[0][0])
    with cluster:
        (first,) = cluster.serve([qid], timeout_s=TIMEOUT_S)
        results = cluster.serve([qid] * 11, timeout_s=TIMEOUT_S)
    assert not first.cached
    assert not any(isinstance(r, Shed) for r in results)
    assert all(r.cached for r in results)
    np.testing.assert_array_equal(results[0].doc_ids, first.doc_ids)
    summaries = cluster.stats()["replicas"]
    assert sorted(s["n_requests"] for s in summaries) == [0, 12]


def test_replica_shutdown_sheds_pending_tickets(trained):
    sys_, policies = trained
    replica = Replica(0, sys_, _store(policies),
                      EngineConfig(min_bucket=8, max_bucket=8))
    t1 = ClusterTicket(0, int(sys_.log.category[0]))
    replica.enqueue(t1)                    # never started: stays in inbox
    replica.stop(drain=False)
    assert t1.done() and t1.shed
    assert t1.result().reason == "replica_shutdown"
    t2 = ClusterTicket(1, int(sys_.log.category[1]))
    replica.enqueue(t2)                    # post-stop enqueue: immediate shed
    assert t2.done() and t2.shed


def test_process_backend_raises(trained):
    """The process cell is not ported yet."""
    sys_, policies = trained
    with pytest.raises(NotImplementedError, match="process cell"):
        ReplicaSet(sys_, _store(policies), ClusterConfig(backend="process"))
    with pytest.raises(ValueError, match="backend"):
        ReplicaSet(sys_, _store(policies), ClusterConfig(backend="nope"))


def test_replica_error_becomes_an_explicit_shed(trained, monkeypatch):
    """A failing serve step (a kernel that raises) sheds the replica's
    tickets with ``replica_error:<type>`` — the reference's semantics,
    which is why the chip phase asserts that no such shed occurred."""
    sys_, policies = trained
    cluster = ReplicaSet(sys_, _store(policies), ClusterConfig(n_replicas=1),
                         EngineConfig(min_bucket=8, max_bucket=8,
                                      cache_capacity=0))

    def broken(*a, **k):
        raise RuntimeError("block_scan_pruned_chunk: CUDA error 700 at launch")

    monkeypatch.setattr(cluster.replicas[0].engine.executor, "execute", broken)
    with cluster:
        results = cluster.serve(np.arange(4), timeout_s=TIMEOUT_S)
    assert all(isinstance(r, Shed) for r in results)
    assert {r.reason for r in results} == {"replica_error:RuntimeError"}


# ----------------------------------------------------------------- trainer
def test_trainer_loop_publishes_gated_versions(port_system):
    store = PolicyStore(staleness_bound=2)
    trainer = TrainerLoop(port_system, store, cfg=TrainerConfig(
        iters=4, publish_every=2, batch=8, probe_queries=8, seed=3))
    trainer.run_to_completion()
    assert trainer.versions_published == [1, 2, 3]
    assert store.version == 3
    for cat in (CAT1, CAT2):
        scores = [row["probe_recall"][cat] for row in trainer.history]
        assert all(b >= a for a, b in zip(scores, scores[1:])), scores
    snap = store.snapshot()
    assert set(snap.policies) == {CAT1, CAT2}


def test_candidate_recall_proxy():
    doc_ids = np.array([[3, 7, -1], [1, 2, 9]])
    judged = np.array([[3, 5, -1], [4, 6, -1]])
    gains = np.array([[2, 1, 0], [0, 3, 0]])
    rec = candidate_recall(doc_ids, judged, gains)
    assert rec[0] == 0.5
    assert rec[1] == 0.0


def test_serve_while_training(trained):
    """The full loop: the trainer consumes the cluster's served-traffic
    tap and publishes while the fleet serves; nothing drops, every
    response's version is within the staleness bound."""
    sys_, _ = trained
    bound = 2
    store = PolicyStore(staleness_bound=bound)
    trainer = TrainerLoop(sys_, store, cfg=TrainerConfig(
        iters=4, publish_every=2, batch=8, probe_queries=8,
        publish_initial=False))
    trainer.publish_now()
    cluster = ReplicaSet(sys_, store, ClusterConfig(n_replicas=2),
                         EngineConfig(min_bucket=8, max_bucket=8,
                                      cache_capacity=128))
    trainer.source = cluster.tap
    rng = np.random.default_rng(0)
    results = []
    deadline = time.monotonic() + TIMEOUT_S
    with cluster:
        trainer.start()
        while trainer.alive and time.monotonic() < deadline:
            results.extend(cluster.serve(
                rng.integers(0, sys_.log.n_queries, size=8),
                timeout_s=TIMEOUT_S))
        trainer.join(timeout=TIMEOUT_S)
        assert not trainer.alive
        results.extend(cluster.serve(
            rng.integers(0, sys_.log.n_queries, size=8), timeout_s=TIMEOUT_S))
    assert len(trainer.versions_published) == 3
    served = [r for r in results if not isinstance(r, Shed)]
    assert served and not any(isinstance(r, Shed) for r in results)
    stats = cluster.stats()
    assert stats["n_submitted"] == stats["n_responses"] + stats["n_shed"]
    assert stats["n_submitted"] == len(results)
    assert stats["version_lag_observed_max"] <= bound
    assert {r.policy_version for r in served} <= {1, 2, 3}
    assert max(r.policy_version for r in served) == 3
    assert trainer.tap_batches > 0 and trainer.log_batches == 0
    assert stats["tap"]["n_recorded"] == stats["n_responses"] + stats["n_shed"]


# ------------------------------------------------------------ tap holdout
def test_tap_holdout_diverts_eval_slice():
    tap = ServedTrafficTap(capacity=64, holdout_every=3)
    for q in range(12):
        tap.record(q, category=5)
    assert tap.holdout_size(5) == 4 and tap.size(5) == 8
    assert tap.n_recorded == 12 and tap.n_held_out == 4
    rng = np.random.default_rng(0)
    probe = tap.holdout_sample(5, 10, rng)
    assert sorted(probe) == [2, 5, 8, 11]
    train = tap.sample(5, 512, rng)
    assert set(train.tolist()).isdisjoint({2, 5, 8, 11})
    s = tap.stats()
    assert s["n_held_out"] == 4 and s["holdout_sizes"] == {5: 4}
    assert tap.holdout_sample(6, 4, rng) is None


def test_tap_holdout_default_off():
    tap = ServedTrafficTap(capacity=16)
    for q in range(8):
        tap.record(q, category=1)
    assert tap.holdout_size() == 0 and tap.size(1) == 8


def test_trainer_gate_probes_tap_holdout(port_system):
    tap = ServedTrafficTap(capacity=256, holdout_every=1)  # all held out
    for cat in (CAT1, CAT2):
        for q in np.where(port_system.log.category == cat)[0][:12]:
            tap.record(int(q), category=cat)
    tracer = Tracer()
    trainer = TrainerLoop(
        port_system, PolicyStore(staleness_bound=2),
        cfg=TrainerConfig(iters=0, probe_queries=6, probe_from_tap=True,
                          publish_initial=False),
        source=tap, tracer=tracer)
    trainer.publish_now()
    row = trainer.history[-1]
    assert row["probe_source"] == {CAT1: "tap", CAT2: "tap"}
    assert all(0.0 <= s <= 1.0 for s in row["probe_recall"].values())
    names = [e["name"] for e in tracer.log.snapshot()]
    assert names.count("gate_decision") == 2
    assert "eval_gate" in names and "publish" in names

    trainer2 = TrainerLoop(
        port_system, PolicyStore(staleness_bound=2),
        cfg=TrainerConfig(iters=0, probe_from_tap=True,
                          publish_initial=False),
        source=ServedTrafficTap(capacity=16, holdout_every=4))
    trainer2.publish_now()
    assert trainer2.history[-1]["probe_source"] == {CAT1: "log",
                                                    CAT2: "log"}


# ------------------------------------------- cross-thread span integrity
def test_cluster_trace_spans_cross_threads(tmp_path, trained):
    """A traced ReplicaSet run: ticket spans are created on the submit
    thread and their queue → batch → execute → respond children on a
    replica thread (through ``submit_slab(spans=)`` for a drained group,
    ``submit(span=)`` for a lone ticket); the trace nests per track and
    some ticket carries the full admit → queue → batch → execute →
    respond chain."""
    sys_, policies = trained
    tracer = Tracer()
    cluster = ReplicaSet(sys_, _store(policies), ClusterConfig(n_replicas=2),
                         EngineConfig(min_bucket=8, max_bucket=8,
                                      cache_capacity=64),
                         tracer=tracer)
    rng = np.random.default_rng(3)
    with cluster:
        results = cluster.serve(rng.integers(0, sys_.log.n_queries, size=24),
                                timeout_s=TIMEOUT_S)
    assert len(results) == 24

    snap = tracer.log.snapshot()
    roots = [e for e in snap if e["name"] == "ticket"]
    assert len(roots) == 24
    by_parent = {}
    for e in snap:
        by_parent.setdefault(e["parent"], []).append(e)
    full = 0
    for r in roots:
        names = {e["name"] for e in by_parent.get(r["id"], ())}
        assert "admit" in names
        if {"queue", "batch", "execute", "respond"} <= names:
            full += 1
        for e in by_parent.get(r["id"], ()):
            assert e["track"] == r["track"]
            assert e["t1"] <= r["t1"] + 1e-9
    assert full > 0

    checker = _load_checker()
    path = tmp_path / "cluster_trace.json"
    cluster.write_trace(path)
    out = checker.check_trace(str(path), require_chain=False)
    assert out["n_spans"] >= len(snap) // 2

    merged = cluster.metrics_snapshot()
    lat = [k for k in merged if k.startswith("serve.latency_ms{")]
    assert lat and sum(merged[k]["count"] for k in lat) == 24


# ------------------------------------------------------ health / watchdog
def test_watchdog_state_machine():
    wd = HeartbeatWatchdog(stale_after_s=1.0, wedge_after_s=10.0)
    assert wd.assess(alive=False, heartbeat_age_s=0.0, pending=5) == "dead"
    assert wd.assess(alive=True, heartbeat_age_s=0.2, pending=9) == "healthy"
    assert wd.assess(alive=True, heartbeat_age_s=None, pending=0) == "healthy"
    assert wd.assess(alive=True, heartbeat_age_s=300.0,
                     pending=0) == "parked_idle"
    assert wd.assess(alive=True, heartbeat_age_s=5.0, pending=3) == "busy"
    assert wd.assess(alive=True, heartbeat_age_s=11.0, pending=3) == "wedged"


def test_watchdog_no_false_positive_on_idle_parked_ring():
    """A consumer that stopped stamping with nothing pending classifies
    parked_idle however old its stamp — never wedged; the same silence
    with queued work is a wedge.  The reference stamps a shared-memory
    ring (process cell, not ported); here a monotonic stamp and a
    pending count stand in for the ring header."""
    wd = HeartbeatWatchdog(stale_after_s=0.01, wedge_after_s=0.05)
    last_stamp = time.monotonic()              # last sign of life
    pending = 0
    time.sleep(0.08)                           # way past wedge_after_s
    age = time.monotonic() - last_stamp
    assert wd.assess(alive=True, heartbeat_age_s=age,
                     pending=pending) == "parked_idle"
    pending += 1                               # one request queued
    assert wd.assess(alive=True, heartbeat_age_s=age,
                     pending=pending) == "wedged"


def test_statusz_shape_on_thread_backend(trained):
    sys_, policies = trained
    store = _store(policies)
    cluster = ReplicaSet(sys_, store, ClusterConfig(n_replicas=2))
    with cluster:
        cluster.serve(list(range(8)), timeout_s=TIMEOUT_S)
        doc = cluster.statusz()
        assert doc["backend"] == "thread" and doc["n_replicas"] == 2
        assert doc["state"] == "healthy"
        assert doc["head_policy_version"] == store.version
        for r in doc["replicas"]:
            assert r["state"] == "healthy" and r["alive"]
            assert r["policy_lag"] == 0
        json.dumps(doc, default=str)
    assert cluster.statusz()["state"] == "dead"


# ------------------------------------------------------------------- SLO
def _mk_snapshot(latencies_ms, n_shed=0):
    reg = MetricsRegistry()
    h = reg.histogram("serve.latency_ms", LATENCY_MS_EDGES,
                      category=1, level=0)
    for v in latencies_ms:
        h.record(v)
    if n_shed:
        reg.counter("cluster.shed", where="admission").inc(n_shed)
    return reg.snapshot()


def test_slo_fold_snapshot_threshold_snapping():
    snap = _mk_snapshot([1.0, 4.0, 30.0, 70.0, 2000.0], n_shed=2)
    fold = fold_snapshot(snap, latency_slo_ms=50.0)
    assert fold["effective_latency_slo_ms"] == 50.0
    assert fold["served"] == 5 and fold["slow"] == 2 and fold["shed"] == 2
    assert fold["total"] == 7 and fold["good"] == 3 and fold["bad"] == 4
    fold = fold_snapshot(snap, latency_slo_ms=60.0)
    assert fold["effective_latency_slo_ms"] == 100.0
    assert fold["slow"] == 1


def test_slo_monitor_burn_and_multiwindow_verdict():
    clock = iter(np.arange(0.0, 10000.0, 10.0)).__next__
    reg = MetricsRegistry()
    mon = SLOMonitor(SLOConfig(target=0.9, latency_slo_ms=50.0,
                               fast_window_s=30.0, slow_window_s=300.0),
                     registry=reg, clock=clock)
    lats = []
    for _ in range(4):
        lats.extend([5.0] * 25)
        mon.observe(_mk_snapshot(lats))
    v = mon.check()
    assert v["verdict"] == "ok"
    assert v["burn_fast"] == 0.0 and v["burn_slow"] == 0.0
    for _ in range(40):
        lats.extend([500.0] * 25)
        mon.observe(_mk_snapshot(lats))
    v = mon.check()
    assert v["error_rate_fast"] == pytest.approx(1.0)
    assert v["burn_fast"] == pytest.approx(10.0)
    assert v["verdict"] == "page"
    snap = reg.snapshot()
    assert snap["slo.burn_rate{window=fast}"]["value"] == \
        pytest.approx(v["burn_fast"])
    for _ in range(3):
        lats.extend([5.0] * 25)
        mon.observe(_mk_snapshot(lats))
    v = mon.check()
    assert v["burn_fast"] < mon.cfg.page_burn
    assert v["burn_fast"] < v["burn_slow"]
    assert v["verdict"] == "warn"


def test_slo_config_validation():
    with pytest.raises(ValueError):
        SLOConfig(target=1.0)
    with pytest.raises(ValueError):
        SLOConfig(fast_window_s=600.0, slow_window_s=60.0)


# -------------------------------------------------------- flight recorder
def test_event_log_bounded_ring_and_counters():
    reg = MetricsRegistry()
    log = EventLog(capacity=4, registry=reg)
    for i in range(10):
        log.record("publish", version=i)
    log.record("shed", reason="queue_full")
    assert len(log) == 4 and log.n_recorded == 11 and log.n_evicted == 7
    tail = log.tail(2)
    assert [e["kind"] for e in tail] == ["publish", "shed"]
    assert tail[0]["version"] == 9
    assert all("t" in e and "t_wall" in e for e in tail)
    snap = reg.snapshot()
    assert snap["events.recorded{kind=publish}"]["value"] == 10
    assert snap["events.recorded{kind=shed}"]["value"] == 1


def test_flight_recorder_bundles(tmp_path):
    rec = FlightRecorder(config={"backend": "thread"})
    rec.record("restart", replica=0)
    assert rec.dump("postmortem", {"x": 1}) is None

    rec = FlightRecorder(EventLog(capacity=8),
                         bundle_dir=tmp_path / "pm",
                         config={"backend": "process", "n_replicas": 2})
    for i in range(12):
        rec.record("publish", version=i)
    trace_tail = [{"name": f"s{i}"} for i in range(1000)]
    p1 = rec.dump("postmortem-r0", {"reason": "worker_dead",
                                    "trace_tail": trace_tail,
                                    "metrics": {"serve.requests": 8}})
    p2 = rec.dump("postmortem-r0", {"reason": "worker_dead"})
    assert p1 != p2 and rec.last_bundle_path == p2
    doc = json.loads(p1.read_text())
    assert doc["config"]["n_replicas"] == 2
    assert doc["events_recorded"] == 12
    assert len(doc["events_tail"]) == 8
    assert len(doc["trace_tail"]) == FlightRecorder.TRACE_TAIL
    assert doc["trace_tail"][-1] == {"name": "s999"}
    assert doc["metrics"] == {"serve.requests": 8}


# ------------------------------------------------ native loader (hazard 2)
def test_native_kernel_builds_once_and_counts_every_launch(monkeypatch):
    """8 threads × 1,000 launches of one kernel through its first use:
    one build, one load, exactly 8,000 counted.  ``build`` and the
    library are stubs (no nvcc here); a shortened switch interval makes
    a lost update or a second build likely if the lock were missing."""
    from repro_torch.kernels import native

    builds = []

    def stub(*args):
        return 0

    class Lib:
        def __getattr__(self, name):
            return stub

    k = NativeKernel("stub_kernel", "block_scan.cu", ("block_scan.cuh",),
                     "stub_launch", [])
    monkeypatch.setattr(k, "build",
                        lambda: builds.append(1) or time.sleep(0.01) or "")
    monkeypatch.setattr(native.ctypes, "CDLL", lambda path: Lib())
    start = threading.Barrier(8)

    def worker():
        start.wait(timeout=TIMEOUT_S)
        for _ in range(1000):
            k.launch()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT_S)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1
    assert k.launches == 8000


# ------------------------------------------------------------------ gate C1
def test_gate_c1_router_estimator_controller_equal_reference(tiny_system,
                                                             port_system):
    """The same inputs through the port's and the reference's router,
    u estimator and admission controller give the same picks, float64
    estimates and decisions (ladder and binary; scalar and slab)."""
    rng = np.random.default_rng(21)
    for n in (2, 3, 4):
        pr, jr = (QueueAwareRouter(spill_margin=2, owner_spill_depth=6),
                  JQueueAwareRouter(spill_margin=2, owner_spill_depth=6))
        prr, jrr = RoundRobinRouter(), JRoundRobinRouter()
        for _ in range(300):
            key = (int(rng.integers(0, 2)),
                   tuple(sorted(rng.integers(0, 1024, 3).tolist())))
            h = stable_query_hash(key)
            assert h == jstable_query_hash(key)
            depths = rng.integers(0, 12, n).tolist()
            owner = None if rng.random() < 0.5 else int(rng.integers(0, n))
            assert pr.pick(h, depths, owner) == jr.pick(h, depths, owner)
            assert prr.pick(h, depths, owner) == jrr.pick(h, depths, owner)
        assert pr.stats() == jr.stats()

    qids = rng.integers(0, port_system.log.n_queries, 400)
    pe = UCostEstimator(port_system, prior_u=300.0)
    je = JUCostEstimator(tiny_system, prior_u=300.0)
    pc, pb = pe.features_many(qids)
    jc, jb = je.features_many(qids)
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_array_equal(pb, jb)
    for qid, u, level, version in zip(
            qids[:200], rng.integers(1, 900, 200),
            rng.integers(0, 2, 200), rng.integers(0, 6, 200)):
        for e in (pe, je):
            e.observe(int(qid), float(u), level=ServiceLevel(int(level)),
                      version=int(version))
    for version in (None, 0, 2, 5):
        pf, ps = pe.estimates_many(qids, version=version)
        jf, js = je.estimates_many(qids, version=version)
        assert pf.dtype == np.float64
        np.testing.assert_array_equal(pf, jf)
        np.testing.assert_array_equal(ps, js)
    assert pe.describe() == je.describe()

    cache_av = rng.random(qids.size) < 0.3
    shallow_av = rng.random(qids.size) < 0.8
    for ladder in (True, False):
        pa = AdmissionController(pe, u_inflight_budget=5000.0, ladder=ladder,
                                 full_watermark=0.4)
        ja = JAdmissionController(je, u_inflight_budget=5000.0, ladder=ladder,
                                  full_watermark=0.4)
        got = [pa.decide(int(q), bool(c), bool(s))
               for q, c, s in zip(qids[:100], cache_av, shallow_av)]
        want = [ja.decide(int(q), bool(c), bool(s))
                for q, c, s in zip(qids[:100], cache_av, shallow_av)]
        assert [(int(a.level), a.est_u, a.reserved_u) for a in got] == \
            [(int(a.level), a.est_u, a.reserved_u) for a in want]
        for a, b in zip(got[::3], want[::3]):
            pa.release(a.reserved_u)
            ja.release(b.reserved_u)
        p_out = pa.decide_many(qids[100:], cache_av[100:], shallow_av[100:])
        j_out = ja.decide_many(qids[100:], cache_av[100:], shallow_av[100:])
        for g, w in zip(p_out, j_out):
            np.testing.assert_array_equal(g, w)
        assert pa.stats() == ja.stats()
        assert len(set(p_out[0].tolist())) >= 2          # the ladder moved


# ------------------------------------------------------------------ gate C2
C2_WAVES = 5
C2_WAVE = 16


def _c2_stream(log):
    """Waves of distinct keys; each wave after the first repeats half of
    the keys served before (hits at their owner) and adds new ones."""
    rng = np.random.default_rng(33)
    order = rng.permutation(log.n_queries)
    key_of = {}
    firsts = []
    for q in order:
        k = canonical_query_key(log.terms[q], int(log.category[q]))
        if k not in key_of:
            key_of[k] = int(q)
            firsts.append(int(q))
    waves, seen, nxt = [], [], 0
    for w in range(C2_WAVES):
        repeats = (list(rng.choice(seen, C2_WAVE // 2, replace=False))
                   if w else [])
        fresh = firsts[nxt:nxt + C2_WAVE - len(repeats)]
        nxt += len(fresh)
        wave = [int(q) for q in repeats] + fresh
        rng.shuffle(wave)
        waves.append(wave)
        seen += fresh
    return waves


def _c2_drive(cluster, waves):
    out = []
    with cluster:
        for i, wave in enumerate(waves):
            serve = cluster.serve if i % 2 == 0 else cluster.serve_many
            out += serve(wave, timeout_s=TIMEOUT_S)
    return out


def _c2_counts(stats):
    keep = ("n_requests", "n_cached", "cache_hits", "cache_misses",
            "cache_size", "policy_version", "index_epoch", "n_enqueued",
            "n_completed", "level_counts", "mean_u")
    router = {k: stats["router"][k] for k in (
        "affinity_picks", "sticky_picks", "spills", "owner_spills")}
    return {
        "fleet": {k: stats[k] for k in ("n_submitted", "n_responses",
                                        "n_shed", "version_lag_observed_max",
                                        "head_version")},
        "router": router,
        "admission": stats["admission"]["levels"],
        "tap": stats["tap"]["n_recorded"],
        "replicas": [{k: r[k] for k in keep} for r in stats["replicas"]],
    }


def test_gate_c2_replica_set_equals_reference(reference, trained):
    ref, jpolicies = reference
    port_sys, policies = trained
    waves = _c2_stream(port_sys.log)
    ccfg = dict(n_replicas=2, spill_margin=64)
    ecfg = dict(min_bucket=8, max_bucket=16, cache_capacity=256)

    jstore = JPolicyStore(staleness_bound=2)
    jstore.publish(dict(jpolicies), fallbacks=ref.fallback_policies())
    jcluster = JReplicaSet(ref, jstore, JClusterConfig(**ccfg),
                           JEngineConfig(**ecfg))
    want = _c2_drive(jcluster, waves)

    sys_ = ReferenceInputs(port_sys, ref)
    store = _store(policies, fallbacks=sys_.fallback_policies())
    cluster = ReplicaSet(sys_, store, ClusterConfig(**ccfg),
                         EngineConfig(**ecfg))
    got = _c2_drive(cluster, waves)

    assert len(got) == len(want) == C2_WAVES * C2_WAVE
    assert sum(r.cached for r in want) >= C2_WAVE     # repeats hit
    assert {r.category for r in want} == {CAT1, CAT2}
    for g, w in zip(got, want):
        assert not isinstance(g, Shed) and not isinstance(w, Shed)
        for f in ("request_id", "qid", "category", "u", "cand_cnt", "cached",
                  "policy_version", "index_epoch"):
            assert getattr(g, f) == getattr(w, f), f
        assert int(g.level) == int(w.level)
        np.testing.assert_array_equal(g.doc_ids, np.asarray(w.doc_ids))
        np.testing.assert_array_equal(g.scores, np.asarray(w.scores))
    assert _c2_counts(cluster.stats()) == _c2_counts(jcluster.stats())


# ------------------------------------------------------------------ gate C3
def test_gate_c3_trainer_publishes_reference_versions(reference, trained):
    ref, _ = reference
    port_sys, _ = trained
    cfg = dict(iters=4, publish_every=2, batch=8, probe_queries=8, seed=3)
    jtrainer = JTrainerLoop(ref, JPolicyStore(staleness_bound=2),
                            cfg=JTrainerConfig(**cfg))
    jtrainer.run_to_completion()

    sys_ = ReferenceInputs(port_sys, ref)
    step = sys_.policy_train_step
    key = [jax.random.key(cfg["seed"])]

    def replayed(cat, q, gen, eps, qids):
        """The reference trainer's draws: one split of its key a step."""
        key[0], sub = jax.random.split(key[0])
        draws = jax_draws(sub, sys_.qcfg.t_max, len(qids),
                          sys_.qcfg.n_actions)
        return step(cat, q, draws, eps, qids)

    sys_.policy_train_step = replayed
    trainer = TrainerLoop(sys_, PolicyStore(staleness_bound=2),
                          cfg=TrainerConfig(**cfg))
    trainer.run_to_completion()

    assert trainer.versions_published == jtrainer.versions_published == [1, 2, 3]
    for g, w in zip(trainer.history, jtrainer.history):
        assert g["probe_recall"] == w["probe_recall"]
        assert g["probe_source"] == w["probe_source"]
        assert g["log_batches"] == w["log_batches"]
    assert max(v for row in trainer.history
               for v in row["probe_recall"].values()) > 0
    for cat in (CAT1, CAT2):
        for got, want in ((trainer._q[cat], jtrainer._q[cat]),
                          (trainer._best_q[cat], jtrainer._best_q[cat])):
            want = np.asarray(want)
            assert np.abs(want).max() > 0                   # it trained
            np.testing.assert_array_less(
                np.abs(got.numpy() - want), Q_TOL * (1 + np.abs(want)) + 1e-30)
        np.testing.assert_array_equal(
            trainer.store.snapshot().policies[cat].q.numpy(),
            trainer._best_q[cat].numpy())
