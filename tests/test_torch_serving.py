"""The port's serving engine (``repro_torch.serving``) against the JAX
reference engine on ``tiny_system``, and the reference's serving and
hot-path cases ported case for case.

Policies: the reference trains per-category tabular policies (10
iterations of 16 queries, as ``tests/test_serving.py`` does); their Q
tables, the L1 parameters, state bins, rules and plans cross to the port
through ``repro_torch.weights``, so both engines serve one snapshot.

Gate A holds the engine's logic bit for bit: a test-only subclass of the
port system answers ``batch_inputs`` with the reference's arrays, and
every ``ServeResponse`` field and the summary's counters must equal the
reference engine's over one arrival stream (CAT1 and CAT2 mixed, qids
repeated so that hits occur), per ticket and by slab, at FULL and
SHALLOW, on one and two shards, on both port backends.

Gate B runs the port on its own inputs.  Its L1 scores agree with the
reference's within rtol 1e-5, atol 1e-6 (``tests/test_torch_slice.py``:
the same float32 MLP, only the summation order inside the matmuls and
the ≤4-term feature sums differ).  Candidates, u and actions do not
depend on the scores, so u, cand_cnt, cached, level and policy_version
must be equal; served scores within that tolerance; and doc ids equal
at every rank whose score stands more than twice the tolerance from
both neighbours' — closer ranks may swap, as a near-tie can order
either way.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro.data.querylog import CAT1, CAT2
from repro.policies import PolicyStore as JPolicyStore
from repro.policies import TabularQPolicy as JTabularQPolicy
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import ServeEngine as JServeEngine
from repro.serving import ServiceLevel as JServiceLevel
from repro_torch.core.rollout import unified_rollout
from repro_torch.core.telescope import l1_prune
from repro_torch.data.querylog import QueryLogConfig
from repro_torch.index.corpus import CorpusConfig
from repro_torch.policies import (EpsilonGreedy, PolicyStore,
                                  TabularQPolicy, structure_key)
from repro_torch.serving import (
    SLAB_ADMISSION_REJECT, SLAB_CACHED_ONLY_MISS, AdmissionError,
    ArrayResultCache, BucketConfig, CacheOnlyMiss, EngineConfig,
    LRUResultCache, ServeEngine, ServiceLevel, ShardedExecutor, TicketSlab,
    bucket_size_for,
)
from repro_torch.serving.array_cache import CacheEntry
from repro_torch.serving.cache import canonical_query_key
from repro_torch.system import RetrievalSystem, SystemConfig
from repro_torch.weights import from_reference

PORT_BACKENDS = ("reference", "block_scan")
L1_RTOL, L1_ATOL = 1e-5, 1e-6          # tests/test_torch_slice.py
STREAM_SEED = 11
WAVES = (0, 20, 36, 48)                # the stream is served in three waves


# ---------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def reference(tiny_system):
    """tiny_system + its quickly-trained per-category policies (quality
    is irrelevant here; parity and shape behaviour are under test)."""
    policies = {cat: JTabularQPolicy(tiny_system.train_policy(
        cat, iters=10, batch=16)[0]) for cat in (CAT1, CAT2)}
    return tiny_system, policies


@pytest.fixture(scope="module")
def port_system(tiny_system):
    c = tiny_system.cfg
    cfg = SystemConfig(
        corpus=CorpusConfig(n_docs=c.corpus.n_docs,
                            vocab_size=c.corpus.vocab_size,
                            seed=c.corpus.seed),
        querylog=QueryLogConfig(n_queries=c.querylog.n_queries,
                                seed=c.querylog.seed),
        block_docs=c.block_docs, p_bins=c.p_bins, u_budget=c.u_budget,
        rule_du_scale=c.rule_du_scale, rule_dv_scale=c.rule_dv_scale,
        l1_hidden=c.l1_hidden, seed=c.seed)
    sys_ = RetrievalSystem(cfg, device="cpu")
    rs = tiny_system.ruleset
    sys_.load_reference(
        l1_params={k: np.asarray(v) for k, v in tiny_system.l1_params.items()},
        bins={"u_edges": np.asarray(tiny_system.bins.u_edges),
              "v_edges": np.asarray(tiny_system.bins.v_edges)},
        ruleset={k: np.asarray(getattr(rs, k))
                 for k in ("allowed", "required", "du_quota", "dv_quota")},
        plans={name: {k: np.asarray(getattr(p, k)) for k in
                      ("rule_idx", "reset_before", "du_quota", "dv_quota")}
               for name, p in tiny_system.plans.items()})
    return sys_


@pytest.fixture(scope="module")
def trained(reference, port_system):
    """The port system and the reference's trained policies, converted."""
    _, jpolicies = reference
    policies = {cat: TabularQPolicy(from_reference(
        q=np.asarray(p.q), device="cpu").q) for cat, p in jpolicies.items()}
    return port_system, policies


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


class ReferenceInputs(RetrievalSystem):
    """Test only: the port system, answering ``batch_inputs`` with the
    reference system's arrays for the same query ids."""

    def __init__(self, port, ref):
        self.__dict__.update(port.__dict__)
        self._ref = ref

    def batch_inputs(self, query_ids, epoch=None):
        occ, scores, tp = self._ref.batch_inputs(np.asarray(query_ids))
        return _t(occ), _t(scores), _t(tp)


def _direct(sys_, policies, qids):
    """Reference path: unified_rollout + l1_prune, one category at a time."""
    qids = np.asarray(qids)
    ids = np.zeros((len(qids), 100), np.int32)
    sc = np.zeros((len(qids), 100), np.float32)
    u = np.zeros(len(qids), np.int64)
    for cat in (CAT1, CAT2):
        m = sys_.log.category[qids] == cat
        if not m.any():
            continue
        occ, scores, tp = sys_.batch_inputs(qids[m])
        fin = unified_rollout(sys_.env_cfg, sys_.ruleset, sys_.bins,
                              policies[cat], sys_.cfg.t_max,
                              occ, scores, tp).final_state
        i_, s_ = l1_prune(scores, fin.cand, keep=100)
        ids[m], sc[m], u[m] = i_.numpy(), s_.numpy(), fin.u.numpy()
    return ids, sc, u


# ------------------------------------------------------- gates A and B
def _stream(n_queries):
    rng = np.random.default_rng(STREAM_SEED)
    head = rng.integers(0, n_queries, size=28)
    return np.concatenate([head, head[rng.permutation(28)[:12]],
                           rng.integers(0, n_queries, size=8)])


def _drive(engine, stream, mode, level):
    out = []
    for a, b in zip(WAVES, WAVES[1:]):
        qids = stream[a:b]
        out += (engine.serve(qids, level) if mode == "ticket"
                else engine.serve_many(qids, level))
    return out


def _gate_cfg(cls, n_shards, **kw):
    return cls(min_bucket=8, max_bucket=16, cache_capacity=64,
               n_shards=n_shards, **kw)


@pytest.fixture(scope="module")
def reference_runs(reference):
    """The reference engine's responses and summary per (mode, level,
    n_shards), run on first use."""
    ref, policies = reference
    runs = {}

    def run(mode, level, n_shards):
        key = (mode, level, n_shards)
        if key not in runs:
            store = JPolicyStore(staleness_bound=0)
            store.publish(dict(policies), fallbacks=ref.fallback_policies())
            engine = JServeEngine(ref, store, _gate_cfg(JEngineConfig, n_shards))
            resp = _drive(engine, _stream(ref.log.n_queries), mode,
                          JServiceLevel(level))
            runs[key] = (resp, engine.summary())
        return runs[key]
    return run


def _port_engine(sys_, policies, n_shards, backend):
    store = PolicyStore(staleness_bound=0)
    store.publish(dict(policies), fallbacks=sys_.fallback_policies())
    return ServeEngine(sys_, store, _gate_cfg(EngineConfig, n_shards,
                                              backend=backend))


SUMMARY_COUNTERS = ("n_requests", "n_rejected", "n_batches", "n_cached",
                    "cache_hits", "cache_misses", "cache_size",
                    "cache_evictions", "level_counts", "compile_count",
                    "padding_overhead", "mean_u", "p99_u", "policy_version",
                    "index_epoch", "peak_queue_depth", "peak_inflight")

GATE_CASES = [(mode, level, n_shards)
              for mode in ("ticket", "slab")
              for level in (ServiceLevel.FULL, ServiceLevel.SHALLOW)
              for n_shards in (1, 2)]


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("mode,level,n_shards", GATE_CASES)
def test_gate_a_engine_bit_equal_on_reference_inputs(
        reference, trained, reference_runs, mode, level, n_shards, backend):
    ref, _ = reference
    port_sys, policies = trained
    want, want_summary = reference_runs(mode, int(level), n_shards)
    engine = _port_engine(ReferenceInputs(port_sys, ref), policies, n_shards,
                          backend)
    got = _drive(engine, _stream(ref.log.n_queries), mode, level)
    assert len(got) == len(want) == WAVES[-1]
    assert any(r.cached for r in want)                 # hits occurred
    assert {r.category for r in want} == {CAT1, CAT2}
    for g, w in zip(got, want):
        assert (g.request_id, g.qid, g.category, g.u, g.cand_cnt, g.cached,
                int(g.level), g.policy_version, g.index_epoch) == \
               (w.request_id, w.qid, w.category, w.u, w.cand_cnt, w.cached,
                int(w.level), w.policy_version, w.index_epoch)
        assert g.doc_ids.dtype == w.doc_ids.dtype
        assert g.scores.dtype == w.scores.dtype
        np.testing.assert_array_equal(g.doc_ids, w.doc_ids)
        np.testing.assert_array_equal(g.scores, w.scores)
    got_summary = engine.summary()
    for k in SUMMARY_COUNTERS:
        assert got_summary[k] == want_summary[k], k


def _stable_ranks(scores, n_valid, cand_cnt, keep):
    """Ranks whose score stands more than twice the L1 tolerance from
    both neighbours' (the last kept rank's lower neighbour is unseen
    when more candidates than ``keep`` competed)."""
    s = scores[:n_valid].astype(np.float64)
    tol = L1_ATOL + L1_RTOL * np.abs(s)
    gap = s[:-1] - s[1:]
    sep = gap > 2 * np.maximum(tol[:-1], tol[1:])
    above = np.concatenate([[True], sep])
    below = np.concatenate([sep, [cand_cnt <= keep]])
    return np.where(above & below)[0]


@pytest.mark.parametrize("mode,level,n_shards", GATE_CASES)
def test_gate_b_engine_on_port_inputs(reference, trained, reference_runs,
                                      mode, level, n_shards):
    ref, _ = reference
    port_sys, policies = trained
    want, _ = reference_runs(mode, int(level), n_shards)
    engine = _port_engine(port_sys, policies, n_shards, None)
    got = _drive(engine, _stream(ref.log.n_queries), mode, level)
    checked = 0
    for g, w in zip(got, want):
        assert (g.request_id, g.qid, g.u, g.cand_cnt, g.cached, int(g.level),
                g.policy_version) == \
               (w.request_id, w.qid, w.u, w.cand_cnt, w.cached, int(w.level),
                w.policy_version)
        n_valid = int((w.doc_ids >= 0).sum())
        assert int((g.doc_ids >= 0).sum()) == n_valid
        np.testing.assert_allclose(g.scores[:n_valid], w.scores[:n_valid],
                                   rtol=L1_RTOL, atol=L1_ATOL)
        assert np.isneginf(g.scores[n_valid:]).all()
        ranks = _stable_ranks(w.scores, n_valid, w.cand_cnt, len(w.doc_ids))
        np.testing.assert_array_equal(g.doc_ids[ranks], w.doc_ids[ranks])
        if w.cand_cnt <= len(w.doc_ids):      # every candidate was kept
            np.testing.assert_array_equal(np.sort(g.doc_ids[:n_valid]),
                                          np.sort(w.doc_ids[:n_valid]))
        checked += len(ranks)
    assert checked > len(got)          # most ranks are far from a tie


# ------------------------------------------------------- structure keys
def test_structure_key_separates_as_the_reference_treedef(port_system):
    sys_ = port_system
    p, a = sys_.bins.p, sys_.env_cfg.n_actions
    q1 = TabularQPolicy(torch.zeros(p, a))
    q2 = TabularQPolicy(torch.ones(p, a))
    assert structure_key(q1) == structure_key(q2)        # values don't key
    assert structure_key(q1) != structure_key(TabularQPolicy(torch.zeros(p + 1, a)))
    assert structure_key(q1) != structure_key(
        TabularQPolicy(torch.zeros(p, a, dtype=torch.float64)))
    plan1, plan2 = sys_.plan_policy(CAT1), sys_.plan_policy(CAT2)
    assert structure_key(plan1) != structure_key(q1)
    short = sys_.fallback_policies(length=2)
    longer = sys_.fallback_policies(length=3)
    assert structure_key(short[CAT1]) == structure_key(short[CAT2])
    assert structure_key(short[CAT1]) != structure_key(longer[CAT1])
    assert (structure_key(plan1) == structure_key(plan2)) == \
        (plan1.plan.length == plan2.plan.length)
    eg = EpsilonGreedy(q1, 0.1, torch.zeros(8, 4, dtype=torch.int32),
                       torch.zeros(8, 4))
    assert structure_key(eg) != structure_key(q1)
    with pytest.raises(TypeError):
        structure_key(np.zeros((p, a)))


def test_executor_prepares_once_per_key(trained):
    sys_, policies = trained
    exe = ShardedExecutor(sys_, n_shards=1)
    key = exe.compiled_for(8, policies[CAT1])
    assert exe.compile_count == 1
    assert key == (8, exe.backend, 0, structure_key(policies[CAT1]))
    assert exe.compiled_for(8, policies[CAT2]) == key   # same structure
    fb = sys_.fallback_policies()[CAT1]
    k2 = exe.compiled_for(8, fb, level=int(ServiceLevel.SHALLOW))
    assert k2 == (8, exe.backend, int(ServiceLevel.SHALLOW), structure_key(fb))
    assert exe.compile_count == 2
    occ, scores, tp = sys_.batch_inputs(np.arange(8))
    exe.execute(policies[CAT1], occ, scores, tp)
    assert exe.compile_count == 2 and exe.execute_count == 1
    exe.execute(policies[CAT1], occ[:4], scores[:4], tp[:4])   # new bucket
    assert exe.compile_count == 3
    with pytest.raises(TypeError):
        exe.compiled_for(8, policies[CAT1].q)
    with pytest.raises(ValueError, match="unknown rollout backend"):
        ShardedExecutor(sys_, backend="no_such_backend")
    with pytest.raises(ValueError, match="unknown rollout backend"):
        ServeEngine(sys_, policies, EngineConfig(backend="no_such_backend"))
    assert ServeEngine(sys_, policies).executor.backend == sys_.cfg.backend


# ------------------------------------------- the rollout-backend registry
def _reference_rollout(calls):
    """A serving-level rollout backend: the ``reference`` scan backend's
    rollout, counting its calls (lanes per call)."""
    def rollout(cfg, ruleset, bins, policy, t_max, occ, scores, tp):
        calls.append(occ.shape[0])
        return unified_rollout(cfg, ruleset, bins, policy, t_max, occ, scores,
                               tp, backend="reference").final_state
    return rollout


@pytest.fixture
def registry():
    """The registry's entries, restored after the case."""
    from repro_torch.serving import ROLLOUT_BACKENDS

    saved = dict(ROLLOUT_BACKENDS)
    yield ROLLOUT_BACKENDS
    ROLLOUT_BACKENDS.clear()
    ROLLOUT_BACKENDS.update(saved)


def test_rollout_backend_registry_lists_resolves_and_raises(registry):
    from repro_torch.core.scan_backends import available_backends as scan
    from repro_torch.serving import (available_backends,
                                     register_rollout_backend,
                                     resolve_rollout_backend)

    assert available_backends() == scan() == ("block_scan", "reference")
    fn = register_rollout_backend("test_rollout")(_reference_rollout([]))
    assert registry["test_rollout"] is fn
    assert resolve_rollout_backend("test_rollout") is fn
    assert available_backends() == ("block_scan", "reference", "test_rollout")
    assert resolve_rollout_backend("block_scan").args[0].name == "block_scan"
    with pytest.raises(ValueError, match=r"unknown rollout backend 'nope'; "
                       r"available: \('block_scan', 'reference', 'test_rollout'\)"):
        resolve_rollout_backend("nope")


@pytest.mark.parametrize("n_shards", [1, 2])
def test_registered_rollout_backend_serves_like_reference(trained, registry,
                                                          n_shards):
    """An engine on a registered backend serves every response bit-equal
    to an engine on the ``reference`` scan backend; the backend's name is
    in the executor's key."""
    from repro_torch.serving import register_rollout_backend

    sys_, policies = trained
    calls = []
    register_rollout_backend("test_rollout")(_reference_rollout(calls))
    stream = _stream(sys_.log.n_queries)
    out = {}
    for backend in ("test_rollout", "reference"):
        engine = _port_engine(sys_, policies, n_shards, backend)
        engine.warmup()
        out[backend] = engine.serve(stream)
        assert all(k[1] == backend for k in engine.executor._steps)
    assert calls and all(n % n_shards == 0 for n in calls)
    for got, want in zip(out["test_rollout"], out["reference"]):
        assert (got.qid, got.u, got.cand_cnt) == (want.qid, want.u, want.cand_cnt)
        np.testing.assert_array_equal(got.doc_ids, want.doc_ids)
        np.testing.assert_array_equal(got.scores, want.scores)


def test_registered_rollout_backend_wins_over_scan_backend(trained, registry):
    from repro_torch.serving import (available_backends,
                                     register_rollout_backend,
                                     resolve_rollout_backend)

    sys_, policies = trained
    calls = []
    fn = register_rollout_backend("block_scan")(_reference_rollout(calls))
    assert resolve_rollout_backend("block_scan") is fn
    assert available_backends() == ("block_scan", "reference")
    exe = ShardedExecutor(sys_, backend="block_scan")
    exe.execute(policies[CAT1], *sys_.batch_inputs(np.arange(8)))
    assert calls == [8, 8]           # the prepared zero batch, then traffic


# -------------------------------------------------------------- bucketing
def test_bucket_size_for():
    cfg = BucketConfig(min_bucket=8, max_bucket=64)
    assert bucket_size_for(1, cfg) == 8
    assert bucket_size_for(8, cfg) == 8
    assert bucket_size_for(9, cfg) == 16
    assert bucket_size_for(33, cfg) == 64
    assert bucket_size_for(500, cfg) == 64          # clamped to max
    assert cfg.buckets() == [8, 16, 32, 64]
    with pytest.raises(ValueError):
        BucketConfig(min_bucket=6, max_bucket=64)   # not a power of two
    with pytest.raises(ValueError):
        BucketConfig(min_bucket=32, max_bucket=8)


# ------------------------------------------------------ padding invariants
def test_padding_lanes_never_contribute(trained):
    """3 real queries padded up to a bucket of 8: responses exist only
    for the real lanes and are identical to an unpadded direct rollout."""
    sys_, policies = trained
    engine = ServeEngine(sys_, policies, EngineConfig(
        min_bucket=8, max_bucket=8, cache_capacity=0))
    qids = np.where(sys_.log.category == CAT1)[0][:3]
    responses = engine.serve(qids)
    assert len(responses) == 3
    assert engine.take_response(999) is None         # nothing extra completed
    ids, sc, u = _direct(sys_, policies, qids)
    for lane, r in enumerate(responses):
        assert not r.cached
        np.testing.assert_array_equal(r.doc_ids, ids[lane])
        np.testing.assert_allclose(r.scores, sc[lane], rtol=1e-6)
        assert r.u == u[lane]
    # the batch really was padded
    assert engine.telemetry.batches[0]["bucket"] == 8
    assert engine.telemetry.batches[0]["n_padded"] == 5


# ---------------------------------------------------------- cache behaviour
def test_cache_hit_parity(trained):
    sys_, policies = trained
    engine = ServeEngine(sys_, policies, EngineConfig(
        min_bucket=8, max_bucket=16, cache_capacity=64))
    qid = int(np.where(sys_.log.category == CAT2)[0][0])
    (fresh,) = engine.serve([qid])
    (hit,) = engine.serve([qid])
    assert not fresh.cached and hit.cached
    np.testing.assert_array_equal(fresh.doc_ids, hit.doc_ids)
    np.testing.assert_allclose(fresh.scores, hit.scores, rtol=0)
    assert fresh.u == hit.u
    assert engine.cache.hits >= 1
    # a cache hit never runs a new micro-batch
    assert len(engine.telemetry.batches) == 1


def test_cache_canonicalization(trained):
    """Two distinct qids with the same term set share one cache entry."""
    sys_, policies = trained
    log = sys_.log
    dup = None
    seen = {}
    for q in range(log.n_queries):
        key = (int(log.category[q]),
               tuple(sorted(t for t in log.terms[q] if t >= 0)))
        if key in seen:
            dup = (seen[key], q)
            break
        seen[key] = q
    if dup is None:
        pytest.skip("query log has no duplicate term sets")
    engine = ServeEngine(sys_, policies, EngineConfig(
        min_bucket=8, max_bucket=16, cache_capacity=64))
    engine.serve([dup[0]])
    (second,) = engine.serve([dup[1]])
    assert second.cached


# ------------------------------------------------------- end-to-end parity
def test_engine_matches_direct_rollout(trained):
    sys_, policies = trained
    engine = ServeEngine(sys_, policies, EngineConfig(
        min_bucket=8, max_bucket=16, cache_capacity=0, n_shards=1))
    rng = np.random.default_rng(3)
    qids = rng.integers(0, sys_.log.n_queries, size=24)
    responses = engine.serve(qids)
    ids, sc, u = _direct(sys_, policies, qids)
    for lane, r in enumerate(responses):
        assert r.qid == qids[lane]
        np.testing.assert_array_equal(r.doc_ids, ids[lane])
        np.testing.assert_allclose(r.scores, sc[lane], rtol=1e-6)
        assert r.u == u[lane]


# ------------------------------------------------------------------ shards
def test_multishard_candidates_valid(trained):
    sys_, policies = trained
    engine = ServeEngine(sys_, policies, EngineConfig(
        min_bucket=8, max_bucket=8, cache_capacity=0, n_shards=2))
    qids = np.arange(8)
    responses = engine.serve(qids)
    n_docs_total = sys_.env_cfg.n_blocks * sys_.env_cfg.block_docs
    for r in responses:
        valid = r.doc_ids[r.doc_ids >= 0]
        assert len(np.unique(valid)) == len(valid)      # no dup across shards
        assert (valid < n_docs_total).all()
        assert r.u > 0


def test_bad_shard_count_rejected(trained):
    sys_, policies = trained
    with pytest.raises(ValueError):
        ServeEngine(sys_, policies, EngineConfig(n_shards=3))  # 8 blocks % 3


# -------------------------------------------------------- service levels
def _ladder_engine(sys_, policies, **cfg_kw):
    store = PolicyStore(staleness_bound=0)
    store.publish(dict(policies), fallbacks=sys_.fallback_policies())
    return ServeEngine(sys_, store, EngineConfig(**cfg_kw))


def test_shallow_level_serves_fallback_plan(trained):
    """SHALLOW responses are bit-identical to a direct rollout of the
    snapshot's truncated-plan fallback, with the promised u bound."""
    sys_, policies = trained
    engine = _ladder_engine(sys_, policies, min_bucket=8, max_bucket=8,
                            cache_capacity=0)
    qids = np.where(sys_.log.category == CAT1)[0][:5]
    responses = engine.serve(qids, level=ServiceLevel.SHALLOW)
    ids, sc, u = _direct(sys_, sys_.fallback_policies(), qids)
    cap = sys_.shallow_u_cap(CAT1)
    for lane, r in enumerate(responses):
        assert r.level == ServiceLevel.SHALLOW and not r.cached
        np.testing.assert_array_equal(r.doc_ids, ids[lane])
        np.testing.assert_allclose(r.scores, sc[lane], rtol=1e-6)
        assert r.u == u[lane]
        assert 0 < r.u <= cap
    assert engine.summary()["level_counts"] == {int(ServiceLevel.SHALLOW): 5}


def test_full_and_shallow_never_share_a_micro_batch(trained):
    """Interleaved FULL/SHALLOW submissions of one category drain into
    separate micro-batches (different policies, different serve steps),
    and each response is identical to its unmixed reference."""
    sys_, policies = trained
    engine = _ladder_engine(sys_, policies, min_bucket=8, max_bucket=8,
                            cache_capacity=0)
    qids = np.where(sys_.log.category == CAT2)[0][:6]
    rids = {}
    for i, q in enumerate(qids):
        level = ServiceLevel.SHALLOW if i % 2 else ServiceLevel.FULL
        rids[engine.submit(int(q), level)] = (int(q), level)
    engine.flush()
    full_ids, _, full_u = _direct(sys_, policies, qids)
    sh_ids, _, sh_u = _direct(sys_, sys_.fallback_policies(), qids)
    for rid, (q, level) in rids.items():
        r = engine.take_response(rid)
        lane = int(np.where(qids == q)[0][0])
        assert r.level == level
        if level == ServiceLevel.FULL:
            np.testing.assert_array_equal(r.doc_ids, full_ids[lane])
            assert r.u == full_u[lane]
        else:
            np.testing.assert_array_equal(r.doc_ids, sh_ids[lane])
            assert r.u == sh_u[lane]


def test_shallow_fill_never_answers_full_request(trained):
    """Cache-level compatibility: a SHALLOW fill answers SHALLOW and
    CACHED_ONLY requests but never a FULL one; a FULL fill answers
    everyone and upgrades the entry."""
    sys_, policies = trained
    engine = _ladder_engine(sys_, policies, min_bucket=8, max_bucket=8,
                            cache_capacity=64)
    qid = int(np.where(sys_.log.category == CAT1)[0][0])
    (sh,) = engine.serve([qid], level=ServiceLevel.SHALLOW)
    assert not sh.cached and sh.level == ServiceLevel.SHALLOW
    (sh2,) = engine.serve([qid], level=ServiceLevel.SHALLOW)
    assert sh2.cached and sh2.level == ServiceLevel.SHALLOW
    (full,) = engine.serve([qid])                  # degraded entry: miss
    assert not full.cached and full.level == ServiceLevel.FULL
    (full2,) = engine.serve([qid])                 # FULL fill won the entry
    assert full2.cached and full2.level == ServiceLevel.FULL
    np.testing.assert_array_equal(full2.doc_ids, full.doc_ids)
    # ...and now answers degraded requests too (quality upgrade is fine)
    (sh3,) = engine.serve([qid], level=ServiceLevel.SHALLOW)
    assert sh3.cached and sh3.level == ServiceLevel.FULL
    # accounting: the level-incompatible lookup counted as a MISS and
    # did not promote the rejected entry
    assert engine.cache.hits == 3 and engine.cache.misses == 2


def test_cached_only_level(trained):
    sys_, policies = trained
    engine = _ladder_engine(sys_, policies, min_bucket=8, max_bucket=8,
                            cache_capacity=64)
    qid = int(np.where(sys_.log.category == CAT2)[0][0])
    with pytest.raises(CacheOnlyMiss):
        engine.submit(qid, ServiceLevel.CACHED_ONLY)
    (full,) = engine.serve([qid])
    (hit,) = engine.serve([qid], level=ServiceLevel.CACHED_ONLY)
    assert hit.cached and hit.level == ServiceLevel.FULL
    np.testing.assert_array_equal(hit.doc_ids, full.doc_ids)
    with pytest.raises(ValueError):
        engine.submit(qid, ServiceLevel.SHED)


def test_shallow_batch_upgrades_to_full_when_fallbacks_cleared(trained):
    """A publish that clears the fallbacks while SHALLOW requests sit
    queued must not poison the batch: it executes at FULL instead."""
    sys_, policies = trained
    store = PolicyStore(staleness_bound=2)
    store.publish(dict(policies), fallbacks=sys_.fallback_policies())
    engine = ServeEngine(sys_, store, EngineConfig(
        min_bucket=8, max_bucket=8, cache_capacity=0))
    qids = np.where(sys_.log.category == CAT1)[0][:3]
    rids = [engine.submit(int(q), ServiceLevel.SHALLOW) for q in qids]
    store.publish(dict(policies), fallbacks={})      # fallbacks gone
    engine.flush()
    ids, _, u = _direct(sys_, policies, qids)
    for lane, rid in enumerate(rids):
        r = engine.take_response(rid)
        assert r is not None and r.level == ServiceLevel.FULL
        np.testing.assert_array_equal(r.doc_ids, ids[lane])
        assert r.u == u[lane]


def test_cache_hit_served_when_queue_full(trained):
    """admission_limit caps the PENDING queue only: a cache hit
    completes inline and must be served even at the cap (the ladder's
    CACHED_ONLY rung depends on exactly this under saturation)."""
    sys_, policies = trained
    engine = _ladder_engine(sys_, policies, min_bucket=8, max_bucket=8,
                            cache_capacity=64, admission_limit=1)
    cat1 = np.where(sys_.log.category == CAT1)[0]
    # three qids with pairwise-distinct canonical keys (the log can
    # contain duplicate term sets, which would hit instead of queueing)
    key_of = lambda q: canonical_query_key(sys_.log.terms[q], CAT1)
    hot, miss1, miss2 = None, None, None
    seen = {}
    for q in cat1:
        k = key_of(int(q))
        if k not in seen:
            seen[k] = int(q)
            if len(seen) == 3:
                hot, miss1, miss2 = seen.values()
                break
    (filled,) = engine.serve([hot])                   # fill the cache
    assert not filled.cached
    engine.submit(miss1)                              # miss: queue at cap
    rid = engine.submit(hot)                          # hit: inline, no queue
    hit = engine.take_response(rid)
    assert hit is not None and hit.cached
    with pytest.raises(AdmissionError):
        engine.submit(miss2)                          # miss at cap: shed
    engine.flush()                                    # queued work completes


def test_warmup_covers_fallbacks_and_level_splits_compile_key(trained):
    sys_, policies = trained
    engine = _ladder_engine(sys_, policies, min_bucket=8, max_bucket=16,
                            cache_capacity=0)
    buckets = engine.bucket_cfg.buckets()
    # one tabular structure at FULL + one static-plan structure per
    # distinct fallback plan length at SHALLOW
    n_fallback_structs = len({p.plan.length
                              for p in sys_.fallback_policies().values()})
    assert engine.warmup() == len(buckets) * (1 + n_fallback_structs)
    # an identical policy structure still prepares separately per level
    before = engine.executor.compile_count
    engine.executor.compiled_for(8, policies[CAT1],
                                 level=int(ServiceLevel.SHALLOW))
    assert engine.executor.compile_count == before + 1


# ------------------------------------------------- steady-state compilation
def test_zero_steady_state_retraces(trained):
    sys_, policies = trained
    engine = ServeEngine(sys_, policies, EngineConfig(
        min_bucket=8, max_bucket=16, cache_capacity=0))
    assert engine.warmup() == len(engine.bucket_cfg.buckets())
    rng = np.random.default_rng(5)
    for _ in range(4):                      # mixed CAT1/CAT2 stream
        engine.serve(rng.integers(0, sys_.log.n_queries, size=13))
    assert engine.compile_count == len(engine.bucket_cfg.buckets())


# -------------------------------------------------------------- admission
def test_admission_load_shedding(trained):
    sys_, policies = trained
    engine = ServeEngine(sys_, policies, EngineConfig(
        min_bucket=8, max_bucket=8, cache_capacity=0, admission_limit=2))
    engine.submit(0)
    engine.submit(1)
    with pytest.raises(AdmissionError):
        engine.submit(2)
    assert engine.telemetry.rejected == 1
    engine.flush()                           # queued work still completes
    assert engine.take_response(0) is not None


def test_failed_batch_is_requeued_and_raised(trained):
    """A micro-batch whose serve step raises puts its requests back at
    the front of their queue, FIFO kept, and the error propagates; once
    the fault is gone the same requests complete."""
    sys_, policies = trained
    engine = ServeEngine(sys_, policies, EngineConfig(
        min_bucket=8, max_bucket=8, cache_capacity=0))
    qids = np.where(sys_.log.category == CAT1)[0][:3]
    rids = [engine.submit(int(q)) for q in qids]
    real = engine.executor.execute

    def failing(*args, **kwargs):
        raise RuntimeError("device fault")

    engine.executor.execute = failing
    with pytest.raises(RuntimeError, match="device fault"):
        engine.flush()
    assert engine.queue_depth == 3 and engine.inflight == 0
    assert all(engine.take_response(r) is None for r in rids)
    engine.executor.execute = real
    engine.flush()
    ids, _, u = _direct(sys_, policies, qids)
    for lane, rid in enumerate(rids):
        r = engine.take_response(rid)
        np.testing.assert_array_equal(r.doc_ids, ids[lane])
        assert r.u == u[lane]
    assert engine.cancel([rids[0]]) == 0     # nothing left queued


# -------------------------------------------------------------- telemetry
def test_summary_shape(trained):
    sys_, policies = trained
    engine = ServeEngine(sys_, policies, EngineConfig(
        min_bucket=8, max_bucket=8, cache_capacity=16))
    engine.serve([0, 1, 2, 0])
    s = engine.summary()
    for k in ("n_requests", "qps", "latency_p50_ms", "latency_p99_ms",
              "mean_u", "p99_u", "cache_hit_rate", "compile_count",
              "padding_overhead", "queue_depth", "inflight",
              "peak_queue_depth", "peak_inflight"):
        assert k in s
    assert s["n_requests"] == 4
    assert s["mean_u"] > 0


def test_queue_depth_and_inflight_gauges(trained):
    """The router's load signals: queue_depth counts admitted-not-yet-
    drained requests, inflight the executing micro-batch's real lanes;
    peaks survive in the summary."""
    sys_, policies = trained
    engine = ServeEngine(sys_, policies, EngineConfig(
        min_bucket=8, max_bucket=8, cache_capacity=0))
    qids = np.where(sys_.log.category == CAT1)[0][:5]
    for q in qids:
        engine.submit(int(q))
    assert engine.queue_depth == 5 and engine.inflight == 0
    engine.flush()
    assert engine.queue_depth == 0 and engine.inflight == 0
    s = engine.summary()
    assert s["peak_queue_depth"] == 5
    assert s["peak_inflight"] == 5          # observed mid-execution
    assert s["queue_depth"] == 0 and s["inflight"] == 0


def test_ticket_trace_chain(trained):
    """With tracing on, a served ticket's track carries submit, queue,
    batch, execute and respond, the first micro-batch's preparation a
    compile span, and the Chrome export nests."""
    from repro_torch.obs import Tracer

    sys_, policies = trained
    tracer = Tracer()
    engine = ServeEngine(sys_, policies, EngineConfig(
        min_bucket=8, max_bucket=8, cache_capacity=16), tracer=tracer)
    qid = int(np.where(sys_.log.category == CAT1)[0][0])
    engine.serve([qid])
    engine.serve([qid])                      # a hit: instant, no queue
    snap = tracer.log.snapshot()
    tickets = {}
    for e in snap:
        if e["track"].startswith("ticket #"):
            tickets.setdefault(e["track"], []).append(e["name"])
    first, second = sorted(tickets.values(), key=len, reverse=True)
    assert {"ticket", "submit", "queue", "cache_miss", "batch", "execute",
            "respond"} <= set(first)
    assert "cache_hit" in second and "queue" not in second
    names = {e["name"] for e in snap}
    assert {"compile", "microbatch", "batch_inputs"} <= names
    doc = tracer.log.export_chrome(process_name="unit")
    stacks = {}
    for ev in doc["traceEvents"]:
        if ev["ph"] == "B":
            stacks.setdefault((ev["pid"], ev["tid"]), []).append(ev["name"])
        elif ev["ph"] == "E":
            assert stacks[(ev["pid"], ev["tid"])].pop() == ev["name"]
    assert all(not s for s in stacks.values())


def test_engine_trace_nests_the_rule_loop_in_execute(trained):
    """A traced engine runs its rollouts under its tracer: on the
    micro-batch's thread track, inside its execute span, a rollout whose
    steps hold rules and chunks, and the preparation's own rollout
    inside the compile span."""
    from repro_torch.obs import Tracer

    sys_, policies = trained
    tracer = Tracer()
    engine = ServeEngine(sys_, policies, EngineConfig(
        min_bucket=8, max_bucket=8, cache_capacity=16), tracer=tracer)
    engine.serve([int(np.where(sys_.log.category == CAT1)[0][0])])
    snap = tracer.log.snapshot()
    by_id = {e["id"]: e for e in snap}

    def path(e):
        up = path(by_id[e["parent"]]) + "/" if e["parent"] else ""
        return up + e["name"]

    def inside(e, outer):
        return (e["track"] == outer["track"]
                and outer["t0"] <= e["t0"] <= e["t1"] <= outer["t1"])

    (mb,) = [e for e in snap if e["name"] == "microbatch"]
    (execute,) = [e for e in snap
                  if e["name"] == "execute" and e["parent"] == mb["id"]]
    (compile_,) = [e for e in snap if e["name"] == "compile"]
    rollouts = [e for e in snap if e["name"] == "rollout"]
    assert len(rollouts) == 2 and all(inside(r, execute) for r in rollouts)
    assert sum(inside(r, compile_) for r in rollouts) == 1
    paths = {path(e) for e in snap if e["name"] == "chunk"}
    assert paths == {"rollout/step/rule/chunk"}
    assert all(e["track"] == mb["track"] for e in snap
               if path(e).startswith("rollout"))


# ------------------------------------------------ concurrent hot swap
def test_cache_flush_on_hot_swap_under_concurrent_submit(trained):
    """A publisher thread hot-swaps snapshots while the engine thread
    keeps serving a hot query set.  Every cached response must have
    been produced by a fill at the SAME policy version — a stale entry
    surviving a version change would surface as a hit at a version
    with no prior fill, or with different doc ids."""
    sys_, policies = trained
    store = PolicyStore(staleness_bound=10**9)
    store.publish(dict(policies))
    engine = ServeEngine(sys_, store, EngineConfig(
        min_bucket=8, max_bucket=8, cache_capacity=256))
    hot = np.where(sys_.log.category == CAT2)[0][:8]
    stop = threading.Event()
    published = [1]

    def publisher():
        for _ in range(5):
            time.sleep(0.05)
            published.append(store.publish(dict(policies)))
        stop.set()

    fills = {}                       # (cache_key, version) -> doc_ids
    hit_versions = set()

    def record_wave():
        for r in engine.serve(hot):
            key = (canonical_query_key(sys_.log.terms[r.qid],
                                       r.category), r.policy_version)
            if r.cached:
                assert key in fills, \
                    f"cache hit at v{r.policy_version} without a fill"
                np.testing.assert_array_equal(r.doc_ids, fills[key])
                hit_versions.add(r.policy_version)
            else:
                fills[key] = r.doc_ids

    thread = threading.Thread(target=publisher)
    thread.start()
    try:
        while not stop.is_set():
            record_wave()
    finally:
        thread.join()
    record_wave()                    # fill (or hit) at the final version
    record_wave()                    # guaranteed hits at the final version
    assert published[-1] == 6
    # the loop really exercised post-swap cache hits, not just v1
    assert len({v for _, v in fills}) >= 2
    assert max(hit_versions, default=1) >= 2


# ============================================== tests/test_hotpath.py cases
def _entry(seed: int, keep: int = 8) -> CacheEntry:
    rng = np.random.default_rng(seed)
    return CacheEntry(doc_ids=rng.integers(0, 1000, keep).astype(np.int32),
                      scores=rng.random(keep).astype(np.float32),
                      u=int(seed) * 3 + 1, cand_cnt=int(seed) + 10,
                      level=ServiceLevel.FULL)


class TestArrayResultCache:
    def test_get_put_peek_touch(self):
        c = ArrayResultCache(capacity=16, keep=8)
        e = _entry(1)
        c.put(("k", 1, 0), e)
        assert c.contains(("k", 1, 0))
        got = c.peek(("k", 1, 0))            # no side effects
        assert c.hits == 0 and c.misses == 0
        np.testing.assert_array_equal(got.doc_ids, e.doc_ids)
        np.testing.assert_array_equal(got.scores, e.scores)
        assert (got.u, got.cand_cnt, got.level) == (e.u, e.cand_cnt, e.level)
        assert isinstance(got.level, ServiceLevel)
        got2 = c.get(("k", 1, 0))
        assert c.hits == 1
        np.testing.assert_array_equal(got2.doc_ids, e.doc_ids)
        assert c.get(("absent", 1, 0)) is None
        assert c.misses == 1
        c.touch(("k", 1, 0))                  # ref bit only, no counters
        assert c.hits == 1 and c.misses == 1
        assert len(c) == 1

    def test_returned_arrays_are_copies(self):
        c = ArrayResultCache(capacity=4, keep=4)
        c.put("a", _entry(2, keep=4))
        got = c.get("a")
        got.doc_ids[:] = -7
        np.testing.assert_array_equal(
            c.get("a").doc_ids, _entry(2, keep=4).doc_ids)

    def test_update_in_place(self):
        c = ArrayResultCache(capacity=4, keep=4)
        c.put("a", _entry(3, keep=4))
        c.put("a", _entry(4, keep=4))
        assert len(c) == 1
        assert c.peek("a").u == _entry(4).u

    def test_clock_eviction_bounded(self):
        c = ArrayResultCache(capacity=8, keep=4)
        for i in range(50):
            c.put(("k", i), _entry(i, keep=4))
        assert len(c) == 8
        assert c.evictions == 42
        # recently-referenced entries get a second chance
        c2 = ArrayResultCache(capacity=4, keep=4)
        for i in range(4):
            c2.put(("k", i), _entry(i, keep=4))
        assert c2.get(("k", 3)) is not None   # ref bit set
        c2.put(("k", 99), _entry(99, keep=4))
        assert c2.contains(("k", 99))
        assert len(c2) == 4

    def test_tombstone_rebuild_keeps_serving(self):
        c = ArrayResultCache(capacity=8, keep=4)
        for wave in range(40):                # forces rebuilds via churn
            for i in range(8):
                c.put(("w", wave, i), _entry(i, keep=4))
        live = [k for k in [("w", 39, i) for i in range(8)]
                if c.contains(k)]
        assert len(live) == 8                 # the newest wave survived
        for k in live:
            assert c.peek(k) is not None

    def test_keep_growth(self):
        c = ArrayResultCache(capacity=4, keep=2)
        c.put("small", _entry(1, keep=2))
        c.put("big", _entry(2, keep=16))      # wider than allocated
        np.testing.assert_array_equal(
            c.peek("big").doc_ids, _entry(2, keep=16).doc_ids)
        np.testing.assert_array_equal(
            c.peek("small").doc_ids, _entry(1, keep=2).doc_ids)

    def test_clear_keeps_counters(self):
        c = ArrayResultCache(capacity=4, keep=4)
        c.put("a", _entry(1, keep=4))
        c.get("a")
        c.get("b")
        c.clear()
        assert len(c) == 0 and not c.contains("a")
        assert c.hits == 1 and c.misses == 1
        c.put("a", _entry(5, keep=4))         # still usable
        assert c.peek("a").u == _entry(5).u

    def test_stats_protocol_matches_lru(self):
        a = ArrayResultCache(capacity=8, keep=4)
        l = LRUResultCache(capacity=8)
        for cache in (a, l):
            cache.put("x", _entry(1, keep=4))
            cache.get("x")
            cache.get("missing")
            cache.record_miss()
            cache.add_stats(hits=3, misses=2)
        assert a.stats() == l.stats()
        assert a.hit_rate == l.hit_rate

    def test_lru_vs_array_trace_parity(self):
        """Same access trace, capacity large enough that no eviction
        happens: hit/miss accounting and every returned entry match."""
        rng = np.random.default_rng(0)
        a = ArrayResultCache(capacity=256, keep=4)
        l = LRUResultCache(capacity=256)
        keys = [("k", int(i)) for i in range(64)]
        for op in rng.integers(0, 3, size=800):
            k = keys[int(rng.integers(0, len(keys)))]
            if op == 0:
                ea, el = a.get(k), l.get(k)
            elif op == 1:
                ea, el = a.peek(k), l.peek(k)
            else:
                e = _entry(int(rng.integers(0, 100)), keep=4)
                a.put(k, e)
                l.put(k, e)
                continue
            assert (ea is None) == (el is None)
            if ea is not None:
                np.testing.assert_array_equal(ea.doc_ids, el.doc_ids)
                assert ea.u == el.u
        assert a.stats()["hits"] == l.stats()["hits"]
        assert a.stats()["misses"] == l.stats()["misses"]


def test_ticket_slab_build(port_system):
    log = port_system.log
    slab = TicketSlab.build(log, [3, 5, 8], level=1, epoch=2)
    assert len(slab) == 3
    np.testing.assert_array_equal(slab.qids, [3, 5, 8])
    np.testing.assert_array_equal(
        slab.categories, np.asarray(log.category)[[3, 5, 8]])
    assert (slab.levels == 1).all() and slab.epoch == 2
    with pytest.raises(ValueError):
        TicketSlab.build(log, [1, 2], levels=[0])      # size mismatch


def test_ticket_slab_carries_trace_roots(port_system):
    """``trace_roots`` as the reference's slab carries them: (n,) uint64,
    None when tracing is off."""
    from repro.serving import TicketSlab as JTicketSlab

    log = port_system.log
    roots = [7, 2 ** 63 + 1, 0]
    slab = TicketSlab.build(log, [3, 5, 8], epoch=1, trace_roots=roots)
    want = JTicketSlab.build(log, [3, 5, 8], epoch=1, trace_roots=roots)
    assert slab.trace_roots.dtype == want.trace_roots.dtype == np.uint64
    np.testing.assert_array_equal(slab.trace_roots, want.trace_roots)
    assert TicketSlab.build(log, [3]).trace_roots is None
    assert TicketSlab(slab.qids, slab.categories, slab.levels).trace_roots is None


def test_query_key_cache(port_system):
    from repro_torch.serving.slab import QueryKeyCache

    kc = QueryKeyCache(port_system.log, capacity=4)
    for qid in (0, 1, 2, 0, 1):
        cat = int(port_system.log.category[qid])
        assert kc.key(qid) == canonical_query_key(
            port_system.log.terms[qid], cat)
    for qid in range(10):                     # overflow wholesale-clears
        kc.key(qid)
    assert kc.key(0) == canonical_query_key(
        port_system.log.terms[0], int(port_system.log.category[0]))


def test_engine_slab_vs_loop_bit_parity(trained):
    """submit_slab == a loop of submit() on identical fresh engines:
    every response field, both cold (miss) and hot (hit) rounds."""
    sys_, policies = trained
    cfg = EngineConfig(min_bucket=8, max_bucket=16, cache_capacity=64)
    e_slab = ServeEngine(sys_, policies, cfg)
    e_loop = ServeEngine(sys_, policies,
                         EngineConfig(min_bucket=8, max_bucket=16,
                                      cache_capacity=64, cache_impl="lru"))
    qids = list(range(24)) + list(range(12))  # repeats inside one slab
    for _round in range(2):
        rs = e_slab.serve_many(qids)
        rl = e_loop.serve(qids)
        for a, b in zip(rs, rl):
            assert a.qid == b.qid and a.cached == b.cached
            assert a.level == b.level and a.u == b.u
            assert a.cand_cnt == b.cand_cnt
            assert a.policy_version == b.policy_version
            assert a.index_epoch == b.index_epoch
            np.testing.assert_array_equal(a.doc_ids, b.doc_ids)
            np.testing.assert_array_equal(a.scores, b.scores)
    assert e_slab.cache.stats()["hits"] == e_loop.cache.stats()["hits"]
    assert e_slab.cache.stats()["misses"] == e_loop.cache.stats()["misses"]
    s, l = e_slab.summary(), e_loop.summary()
    for k in ("n_requests", "cache_hit_rate", "mean_u", "p99_u"):
        assert s[k] == pytest.approx(l[k]), k


def test_engine_slab_statuses(trained):
    sys_, policies = trained
    engine = ServeEngine(sys_, policies, EngineConfig(
        min_bucket=8, max_bucket=8, cache_capacity=64, admission_limit=4))
    rids, statuses = engine.submit_slab(list(range(10)))
    assert (statuses[:4] == 0).all()
    assert (statuses[4:] == SLAB_ADMISSION_REJECT).all()
    engine.flush()
    for r in rids[:4]:
        assert engine.take_response(int(r)) is not None
    for r in rids[4:]:
        assert engine.take_response(int(r)) is None
    # CACHED_ONLY misses report, hits serve
    rids2, st2 = engine.submit_slab([0, 1, 8, 9],
                                    level=ServiceLevel.CACHED_ONLY)
    assert (st2[:2] == 0).all()               # served above, still cached
    assert (st2[2:] == SLAB_CACHED_ONLY_MISS).all()
    for r in rids2[:2]:
        assert engine.take_response(int(r)).cached
    with pytest.raises(AdmissionError):
        engine.submit_many(list(range(10, 22)))
    with pytest.raises(CacheOnlyMiss):
        engine.submit_many([8, 9], level=ServiceLevel.CACHED_ONLY)


def test_engine_cache_impl_validation(trained):
    sys_, policies = trained
    assert isinstance(
        ServeEngine(sys_, policies, EngineConfig()).cache, ArrayResultCache)
    assert isinstance(
        ServeEngine(sys_, policies, EngineConfig(cache_impl="lru")).cache,
        LRUResultCache)
    with pytest.raises(ValueError):
        ServeEngine(sys_, policies, EngineConfig(cache_impl="nope"))
    with pytest.raises(TypeError):
        ServeEngine(sys_, {CAT1: policies[CAT1].q})     # raw tensor


def test_histogram_record_many_parity():
    from repro_torch.obs.metrics import MetricsRegistry

    reg = MetricsRegistry()
    h1 = reg.histogram("a", (1.0, 5.0, 25.0))
    h2 = reg.histogram("b", (1.0, 5.0, 25.0))
    rng = np.random.default_rng(0)
    vals = rng.random(500) * 50.0
    for v in vals:
        h1.record(float(v))
    h2.record_many(vals)
    s1, s2 = h1.snapshot(), h2.snapshot()
    assert s1["counts"] == s2["counts"]
    assert (s1["min"], s1["max"]) == (s2["min"], s2["max"])
    assert s1["count"] == s2["count"]
    assert s1["sum"] == pytest.approx(s2["sum"])


def test_summary_memoized(trained):
    sys_, policies = trained
    engine = ServeEngine(sys_, policies, EngineConfig(
        min_bucket=8, max_bucket=8, cache_capacity=16))
    calls = []
    orig = engine.telemetry._compute_summary

    def counting(compile_count=0):
        calls.append(1)
        return orig(compile_count)

    engine.telemetry._compute_summary = counting
    engine.serve(list(range(4)))
    engine.summary()
    n = len(calls)
    assert n >= 1
    engine.summary()                          # clean → cached
    engine.summary()
    assert len(calls) == n
    engine.serve([50])                        # dirty → recompute
    engine.summary()
    assert len(calls) == n + 1
    # a different compile_count must not serve the stale row
    s = engine.telemetry.summary(compile_count=123)
    assert s["compile_count"] == 123


def test_telemetry_record_many_matches_scalar_records():
    """``record_requests`` (the slab path) leaves the same window rows,
    counters and histograms as a loop of ``record_request``."""
    from repro_torch.serving import Telemetry

    a, b = Telemetry(), Telemetry()
    lat = np.array([0.0011, 0.004, 0.02, 0.0007])
    us = np.array([64, 8, 300, 12])
    for x, u in zip(lat, us):
        a.record_request(category=2, latency_s=float(x), u=int(u),
                         cached=True, t_done=1.5, level=1)
    b.record_requests(category=2, level=1, latencies_s=lat, us=us,
                      cached=True, t_done=1.5)
    assert list(a.requests) == list(b.requests)
    assert a.registry.snapshot() == b.registry.snapshot()
    assert a.summary() == b.summary()


def test_launch_serve_cli_on_cpu(tmp_path, reference_runs):
    """``python -m repro_torch.launch.serve`` at a tiny size on the CPU:
    the reference's row and summary schema under the port's own file
    names, a well-formed Chrome trace and a metrics snapshot."""
    import importlib.util
    import json
    from pathlib import Path

    from repro_torch.launch.serve import main

    out = tmp_path / "serve_torch.json"
    main(["--n-docs", "512", "--n-queries", "64", "--iters", "2",
          "--batches", "2", "--batch", "8", "--device", "cpu",
          "--out", str(out), "--trace-out", str(tmp_path / "trace.json"),
          "--metrics-json", str(tmp_path / "metrics.json")])
    rows = json.loads(out.read_text())
    assert [r["batch"] for r in rows] == [0, 1]
    assert set(rows[0]) == {
        "batch", "t_inputs_s", "t_serve_s", "mean_u", "p99_u", "qps_host",
        "n_cached", "latency_p50_ms", "latency_p99_ms", "compiles_cum"}
    assert rows[-1]["compiles_cum"] == rows[0]["compiles_cum"]
    summary = json.loads((tmp_path / "serve_torch_summary.json").read_text())
    _, ref_summary = reference_runs("ticket", int(ServiceLevel.FULL), 1)
    assert set(summary) == set(ref_summary)
    assert summary["n_requests"] == 16
    metrics = json.loads((tmp_path / "metrics.json").read_text())
    assert any(k.startswith("serve.latency_ms{") for k in metrics)
    spec = importlib.util.spec_from_file_location(
        "check_trace", Path(__file__).resolve().parents[1] / "tools"
        / "check_trace.py")
    checker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(checker)
    checker.check_trace(str(tmp_path / "trace.json"), require_chain=False)
