"""The port's tiered live index (``repro_torch.index.live``, the
freshness workload and ``launch/live_index.py``) against the JAX
package: every case of ``tests/test_live_index.py`` and the two
live-system cases of ``tests/test_proc_cell.py``, ported case for case,
plus four gates.

L1 holds the on-disk state: for one index, the two packages'
``BaseSegment``s carry equal arrays and forward CSR, and a generation
written by either loads in the other, its files byte-identical and its
manifest equal.

L2 holds the writer: one op sequence (adds, updates of base docs, a
re-update of an added doc, commits, a merge with ops landing during its
compaction, a checkpoint and a restore) applied to a JAX and a port
``LiveIndex`` gives, at every epoch, equal versions and generations,
tombstones, df, doc_len, static_rank, every term's postings in every
field, packed occupancy bit for bit, op logs, rebuilt indexes and
``stats()`` (which holds no timings).

L3 holds the system: ``LiveRetrievalSystem`` in both packages from one
``SystemConfig``, the port given the reference's L1 weights, rules and
plans through ``load_reference``.  One ``FreshnessWorkload`` seed gives
equal documents, qids, logs, IDF rows and waves; ``batch_inputs(epoch=)``
equal occupancy and term masks, and L1 scores within Gate B's rtol 1e-5,
atol 1e-6 (``tests/test_torch_serving.py``: the same float32 MLP, only
the summation order inside the matmuls and the ≤ 4-term feature sums
differ); the L1 training set over the capacity planes within the same
tolerance (``tests/test_torch_train_system.py``).

L4 holds serving across epoch swaps, Gate A style: a port ``ServeEngine``
over a port live system answering ``batch_inputs`` with the reference's
arrays at the same epoch gives ``ServeResponse``s equal to the JAX
engine's in every field but latency, ``index_epoch`` included, and an
equal ``index.epoch_swaps`` count; the cluster's epoch events, epoch lag
and delta pricing equal the JAX ``ReplicaSet``'s.

Every integer comparison is exact; the one float tolerance is stated
where it is used.  Every wait has a timeout.
"""
import json
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster import ClusterConfig as JClusterConfig
from repro.cluster import ReplicaSet as JReplicaSet
from repro.cluster import UCostEstimator as JUCostEstimator
from repro.core.versioned import VersionedStore as JVersionedStore
from repro.data.freshness import FreshnessConfig as JFreshnessConfig
from repro.data.freshness import FreshnessWorkload as JFreshnessWorkload
from repro.data.querylog import QueryLogConfig as JQueryLogConfig
from repro.index.builder import forward_csr as jforward_csr
from repro.index.corpus import CorpusConfig as JCorpusConfig
from repro.index.live import BaseSegment as JBaseSegment
from repro.index.live import LiveIndex as JLiveIndex
from repro.index.live import LiveRetrievalSystem as JLiveRetrievalSystem
from repro.index.live import rebuild_index as jrebuild_index
from repro.index.live.live_index import \
    StaleIndexEpochError as JStaleIndexEpochError
from repro.policies import PolicyStore as JPolicyStore
from repro.ranking.features import doc_features as jdoc_features
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import ServeEngine as JServeEngine
from repro.system import SystemConfig as JSystemConfig
from repro_torch.cluster import (ClusterConfig, ReplicaSet, Shed,
                                 UCostEstimator)
from repro_torch.core.versioned import StaleVersionError, VersionedStore
from repro_torch.data.freshness import FreshnessConfig, FreshnessWorkload
from repro_torch.data.querylog import CAT2, QueryLogConfig
from repro_torch.index.builder import build_index_from_pairs, forward_csr
from repro_torch.index.corpus import N_FIELDS, CorpusConfig
from repro_torch.index.live import (BaseSegment, DeltaOp, DeltaSegment,
                                    IndexEpochStore, LiveIndex,
                                    LiveRetrievalSystem, MergeConfig,
                                    MergeDaemon, StaleIndexEpochError,
                                    check_epoch_parity, rebuild_index)
from repro_torch.index.live.segments import MANIFEST_NAME
from repro_torch.policies.store import PolicyStore, StalePolicyError
from repro_torch.serving import EngineConfig, ServeEngine
from repro_torch.system import SystemConfig

from test_live_index import tiny_index as jtiny_index

L1_RTOL, L1_ATOL = 1e-5, 1e-6          # Gate B's (tests/test_torch_serving.py)
WAIT_S = 60.0


# ----------------------------------------------------------- tiny builders
def tiny_index(n_docs=96, vocab=64, block_docs=32, seed=0):
    """The reference test's ``tiny_index`` through the port's builder:
    the same draws, so the same index."""
    rng = np.random.default_rng(seed)
    pair_docs, pair_terms = [], []
    for k in (1, 2, 8, 3):                    # anchor/url/body/title-ish
        pair_docs.append(np.repeat(np.arange(n_docs, dtype=np.int64), k))
        pair_terms.append(rng.integers(0, vocab, size=n_docs * k))
    return build_index_from_pairs(
        pair_docs, pair_terms, n_docs=n_docs, vocab_size=vocab,
        static_rank=np.linspace(1, 0, n_docs, dtype=np.float32),
        block_docs=block_docs, dedup=True)


def rand_doc(rng, vocab=64):
    fields = [np.unique(rng.integers(0, vocab, size=k))
              for k in (1, 2, 8, 3)]
    return [f.astype(np.int32) for f in fields]


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def live_sys():
    """One port live retrieval system shared by the ported cases (the
    reference's fixture at the same config, on the CPU); tests only
    rely on RELATIVE epoch/doc-count movement."""
    sys_ = LiveRetrievalSystem(SystemConfig(
        corpus=CorpusConfig(n_docs=512, vocab_size=256, seed=5),
        querylog=QueryLogConfig(n_queries=96, seed=5),
        block_docs=128, p_bins=128, u_budget=512, l1_steps=60,
    ), capacity_docs=1536, device="cpu")
    sys_.fit_l1(n_queries=48, batch=16)
    sys_.fit_state_bins(n_queries=32, batch=16)
    return sys_


# ------------------------------------------------------- versioned core
def test_stale_errors_share_base():
    assert issubclass(StalePolicyError, StaleVersionError)
    assert issubclass(StaleIndexEpochError, StaleVersionError)
    assert issubclass(StaleVersionError, RuntimeError)


def test_policy_store_is_versioned_store():
    assert issubclass(PolicyStore, VersionedStore)
    assert issubclass(IndexEpochStore, VersionedStore)


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_publish_snapshot_explicit_version(pkg):
    """``_publish_snapshot(version=)``: gaps are legal, a version not
    above the head is refused, the default stays head + 1 — the
    reference's semantics in both packages."""
    cls = JVersionedStore if pkg == "reference" else VersionedStore

    class Snap:
        def __init__(self, version):
            self.version = version

    store = cls(staleness_bound=1)
    seen = []
    store.subscribe(lambda s: seen.append(s.version))
    assert store._publish_snapshot(lambda prev, v: Snap(v)) == 1
    assert store._publish_snapshot(lambda prev, v: Snap(v), version=5) == 5
    for bad in (5, 4):
        with pytest.raises(ValueError, match="must exceed head 5"):
            store._publish_snapshot(lambda prev, v: Snap(v), version=bad)
    assert store._publish_snapshot(lambda prev, v: Snap(v)) == 6
    assert seen == [1, 5, 6] and store.version == 6
    if pkg == "port":
        live = LiveIndex(tiny_index())
        v = live.store.version
        epoch = live.store.snapshot()
        assert live.store.publish(epoch.view, epoch.generation,
                                  version=v + 3) == v + 3
        assert live.store.snapshot().version == v + 3


def test_index_epoch_store_staleness_and_subscribe():
    live = LiveIndex(tiny_index(), staleness_bound=1)
    store = live.store
    v0 = store.version
    seen = []
    unsub = store.subscribe(lambda e: seen.append(e.version))
    live.add_document(rand_doc(np.random.default_rng(0)))
    live.commit()
    live.add_document(rand_doc(np.random.default_rng(1)))
    live.commit()
    assert seen == [v0, v0 + 1, v0 + 2]
    assert store.staleness(v0 + 2) == 0
    with pytest.raises(StaleIndexEpochError):
        store.validate(v0)                  # 2 behind, bound is 1
    unsub()
    live.add_document(rand_doc(np.random.default_rng(2)))
    live.commit()
    assert seen == [v0, v0 + 1, v0 + 2]     # unsubscribed — no delivery


# ----------------------------------------------------------- base segment
def test_base_segment_mmap_roundtrip(tmp_path):
    seg = BaseSegment.from_index(tiny_index(), generation=3)
    assert not seg.mmapped
    seg.save(tmp_path / "gen")
    loaded = BaseSegment.load(tmp_path / "gen")
    assert loaded.mmapped and loaded.generation == 3
    a, b = seg.index, loaded.index
    assert a.n_docs == b.n_docs and a.block_docs == b.block_docs
    np.testing.assert_array_equal(a.static_rank, b.static_rank)
    np.testing.assert_array_equal(a.doc_len, b.doc_len)
    np.testing.assert_array_equal(a.df, b.df)
    for f in range(N_FIELDS):
        np.testing.assert_array_equal(a.indptr[f], b.indptr[f])
        np.testing.assert_array_equal(a.doc_ids[f], b.doc_ids[f])
        for d in (0, 17, a.n_docs - 1):
            np.testing.assert_array_equal(seg.doc_terms(d, f),
                                          loaded.doc_terms(d, f))


def _segment_arrays(seg):
    idx = seg.index
    out = {"static_rank": idx.static_rank, "doc_len": idx.doc_len,
           "df": idx.df}
    for f in range(N_FIELDS):
        out.update({f"indptr{f}": idx.indptr[f], f"doc_ids{f}": idx.doc_ids[f],
                    f"fwd_indptr{f}": seg.fwd_indptr[f],
                    f"fwd_terms{f}": seg.fwd_terms[f]})
    return out


def _assert_arrays_equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_gate_l1_base_segment_matches_reference():
    """Gate L1: for one index, equal arrays (dtype included), forward
    CSR (``forward_csr`` itself too) and ``nbytes``."""
    jseg = JBaseSegment.from_index(jtiny_index(), generation=2)
    seg = BaseSegment.from_index(tiny_index(), generation=2)
    _assert_arrays_equal(_segment_arrays(seg), _segment_arrays(jseg))
    assert (seg.n_docs, seg.nbytes, seg.generation) == \
        (jseg.n_docs, jseg.nbytes, jseg.generation)
    (fi, ft), (jfi, jft) = forward_csr(seg.index), jforward_csr(jseg.index)
    for f in range(N_FIELDS):
        np.testing.assert_array_equal(fi[f], jfi[f])
        np.testing.assert_array_equal(ft[f], jft[f])
        assert (fi[f].dtype, ft[f].dtype) == (jfi[f].dtype, jft[f].dtype)
    for d in (0, 5, seg.n_docs - 1):
        for a, b in zip(seg.doc_fields(d), jseg.doc_fields(d)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_gate_l1_generation_loads_across_packages(tmp_path, writer):
    """Gate L1: a generation saved by either package loads (mmapped) in
    the other; both packages write byte-identical files and equal
    manifests."""
    jseg = JBaseSegment.from_index(jtiny_index(), generation=4)
    seg = BaseSegment.from_index(tiny_index(), generation=4)
    jseg.save(tmp_path / "jax")
    seg.save(tmp_path / "port")
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert MANIFEST_NAME in files and len(files) == 3 + 4 * N_FIELDS + 1
    for name in files:
        a = (tmp_path / "jax" / name).read_bytes()
        b = (tmp_path / "port" / name).read_bytes()
        if name == MANIFEST_NAME:
            assert json.loads(a) == json.loads(b)
        assert a == b, name
    if writer == "reference":
        loaded, own = BaseSegment.load(tmp_path / "jax"), seg
    else:
        loaded, own = JBaseSegment.load(tmp_path / "port"), jseg
    assert loaded.mmapped and loaded.generation == 4
    _assert_arrays_equal(_segment_arrays(loaded), _segment_arrays(own))


# ---------------------------------------------------------- delta segment
def test_delta_append_only_ids():
    base = BaseSegment.from_index(tiny_index(n_docs=64))
    rng = np.random.default_rng(7)
    ops = [DeltaOp("add", 64, rand_doc(rng)),
           DeltaOp("add", 66, rand_doc(rng))]   # gap: 65 missing
    with pytest.raises(ValueError, match="append-only"):
        DeltaSegment(base, ops)


def test_delta_update_tombstones_and_df():
    base = BaseSegment.from_index(tiny_index(n_docs=64))
    rng = np.random.default_rng(8)
    doc = 5
    new_fields = rand_doc(rng)
    delta = DeltaSegment(base, [DeltaOp("update", doc, new_fields)])
    assert delta.tombstones.tolist() == [doc]
    for f in range(N_FIELDS):
        expect = base.index.df[:, f].copy()
        expect[base.doc_terms(doc, f)] -= 1
        expect[new_fields[f]] += 1
        np.testing.assert_array_equal(expect, delta.df[:, f])
        for t in new_fields[f]:
            assert doc in delta.postings(int(t), f)


# ------------------------------------------------------- live index + epochs
def test_live_index_commit_merge_epochs(tmp_path):
    live = LiveIndex(tiny_index(), storage_dir=tmp_path)
    rng = np.random.default_rng(9)
    v0, g0, n0 = live.epoch, live.generation, live.n_docs
    ids = live.add_documents([rand_doc(rng) for _ in range(5)])
    assert ids == list(range(n0, n0 + 5))
    assert live.n_docs == n0             # invisible until commit
    live.commit()
    assert live.epoch == v0 + 1 and live.n_docs == n0 + 5
    assert live.delta_docs == 5
    live.merge()
    assert live.epoch == v0 + 2          # every visible publish bumps
    assert live.generation == g0 + 1     # merge also bumps generation
    assert live.delta_docs == 0 and live.n_docs == n0 + 5
    assert live.stats()["base_mmapped"]


def test_live_index_capacity_overflow():
    live = LiveIndex(tiny_index(n_docs=96, block_docs=32),
                     capacity_docs=128)
    rng = np.random.default_rng(10)
    for _ in range(128 - 96):
        live.add_document(rand_doc(rng))
    with pytest.raises(ValueError, match="capacity"):
        live.add_document(rand_doc(rng))


def test_occupancy_shape_fixed_across_epochs():
    live = LiveIndex(tiny_index(), capacity_docs=256)
    view0 = live.store.snapshot().view
    shape0 = view0.query_occupancy([1, 2]).shape
    rng = np.random.default_rng(11)
    live.add_documents([rand_doc(rng) for _ in range(3)])
    live.commit()
    live.merge()
    view1 = live.store.snapshot().view
    assert view1.query_occupancy([1, 2]).shape == shape0


def test_merge_daemon_compacts():
    live = LiveIndex(tiny_index())
    rng = np.random.default_rng(12)
    g0 = live.generation
    with MergeDaemon(live, MergeConfig(min_delta_docs=4,
                                       poll_interval_s=0.01)) as daemon:
        live.add_documents([rand_doc(rng) for _ in range(6)])
        live.commit()
        daemon.trigger()
        deadline = 50
        while live.delta_docs and deadline:
            time.sleep(0.05)
            deadline -= 1
    assert daemon.last_error is None
    assert live.generation > g0 and live.delta_docs == 0
    assert daemon.merges_run >= 1


def test_merge_daemon_surfaces_its_error():
    """A failed merge is kept in ``last_error`` (the daemon thread ends)
    and never swallowed: the index is left at its pre-merge epoch."""
    live = LiveIndex(tiny_index())
    rng = np.random.default_rng(16)

    def broken(base, ops):
        raise OSError("disk full")

    live._compact = broken
    daemon = MergeDaemon(live, MergeConfig(min_delta_docs=1,
                                           poll_interval_s=0.01)).start()
    live.add_documents([rand_doc(rng)])
    v = live.commit()
    daemon.trigger()
    deadline = time.monotonic() + WAIT_S
    while daemon.last_error is None and time.monotonic() < deadline:
        time.sleep(0.01)
    daemon.stop()
    assert isinstance(daemon.last_error, OSError)
    assert daemon.merges_run == 0 and live.epoch == v


def test_pinned_view_serves_after_two_merges_unlink_its_generation(tmp_path):
    """A view pinned on generation 1 keeps serving after two later
    merges, the second of which unlinks generation 1's files (the
    memmaps keep the inodes): the same postings and occupancy, and its
    packed words reach a tensor with no warning about non-writable
    arrays."""
    from repro_torch.index.blocks import words_to_tensor

    live = LiveIndex(tiny_index(), storage_dir=tmp_path, capacity_docs=256)
    rng = np.random.default_rng(17)
    live.add_documents([rand_doc(rng) for _ in range(4)])
    live.commit()
    live.merge()                                  # generation 1, mmapped
    pinned = live.store.snapshot()
    assert pinned.generation == 1 and pinned.view.base.mmapped
    terms = [1, 2, 3]
    occ0 = pinned.view.query_occupancy(terms)
    post0 = [pinned.view.postings(t, f).copy() for t in range(64)
             for f in range(N_FIELDS)]
    for _ in range(2):
        live.add_documents([rand_doc(rng) for _ in range(3)])
        live.update_document(int(rng.integers(0, 96)), rand_doc(rng))
        live.commit()
        live.merge()
    assert live.generation == 3
    assert not (tmp_path / "gen-00001").exists()   # unlinked under the pin
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        np.testing.assert_array_equal(pinned.view.query_occupancy(terms), occ0)
        t = words_to_tensor(pinned.view.batch_query_occupancy([terms]), "cpu")
    assert t.shape == (1,) + occ0.shape
    post1 = [pinned.view.postings(t, f) for t in range(64)
             for f in range(N_FIELDS)]
    for a, b in zip(post0, post1):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ gate L2
def _drive_writer(cls, base, storage_dir):
    """The gate's op sequence on one package's ``LiveIndex``; returns
    (every epoch published, in order, across the index and its restored
    copy; the two indexes; the occupancy-probe term lists)."""
    rng = np.random.default_rng(21)
    live = cls(base, capacity_docs=256, storage_dir=storage_dir)
    epochs = []
    live.store.subscribe(epochs.append)
    n0 = live.n_docs
    live.add_documents([rand_doc(rng) for _ in range(5)],
                       static_rank=[0.01 * i for i in range(5)])
    live.commit()
    live.update_document(3, rand_doc(rng))          # base docs
    live.update_document(17, rand_doc(rng))
    live.update_document(n0 + 1, rand_doc(rng))     # an added doc
    live.commit()
    live.update_document(n0 + 1, rand_doc(rng))     # re-update it
    live.add_documents([rand_doc(rng) for _ in range(2)])
    live.commit()

    compact = live._compact

    def compact_while_writing(b, ops):
        # Ops land while the compaction runs outside the writer lock:
        # they must survive as the next generation's residual delta.
        live.add_documents([rand_doc(rng) for _ in range(2)])
        live.update_document(5, rand_doc(rng))
        return compact(b, ops)

    live._compact = compact_while_writing
    live.merge()
    live._compact = compact
    live.commit()                                   # the residual
    live.update_document(n0 + 6, rand_doc(rng))
    live.add_documents([rand_doc(rng) for _ in range(3)])
    live.commit()
    live.add_documents([rand_doc(rng) for _ in range(2)])   # pending
    live.update_document(40, rand_doc(rng))                 # pending
    live.checkpoint()
    restored = cls.restore(storage_dir, capacity_docs=256)
    restored.store.subscribe(epochs.append)
    live.commit()
    restored.commit()
    terms = [[int(t) for t in rng.choice(64, size=k, replace=False)]
             for k in (1, 2, 3, 4, 4)]
    return epochs, live, restored, terms


def _ops(epoch):
    return [(op.kind, op.doc_id, op.static_rank,
             [f.tolist() for f in op.fields]) for op in epoch.ops]


def test_gate_l2_live_index_matches_reference_at_every_epoch(tmp_path):
    jepochs, jlive, jrest, terms = _drive_writer(
        JLiveIndex, jtiny_index(), tmp_path / "jax")
    epochs, live, rest, terms2 = _drive_writer(
        LiveIndex, tiny_index(), tmp_path / "port")
    assert terms == terms2
    assert len(epochs) == len(jepochs) >= 8
    assert {e.generation for e in epochs} == {0, 1}
    for je, pe in zip(jepochs, epochs):
        jv, pv = je.view, pe.view
        tag = f"epoch v{pe.version} gen {pe.generation}"
        assert (pe.version, pe.generation, pv.n_docs, pv.capacity_docs) == \
            (je.version, je.generation, jv.n_docs, jv.capacity_docs), tag
        assert _ops(pe) == _ops(je), tag
        assert pv.describe() == jv.describe(), tag
        np.testing.assert_array_equal(pv.delta.tombstones, jv.delta.tombstones)
        for name in ("df", "doc_len", "static_rank"):
            g = getattr(pv, name)
            w = getattr(jv, name)
            g, w = (g, w) if name == "df" else (g(), w())
            assert g.dtype == w.dtype, (tag, name)
            np.testing.assert_array_equal(g, w, err_msg=f"{tag} {name}")
        for f in range(N_FIELDS):
            for t in range(pv.vocab_size):
                np.testing.assert_array_equal(
                    pv.postings(t, f), jv.postings(t, f),
                    err_msg=f"{tag} term {t} field {f}")
        occ = pv.batch_query_occupancy(terms)
        assert occ.dtype == np.uint32
        np.testing.assert_array_equal(occ, jv.batch_query_occupancy(terms))
        _assert_arrays_equal(
            _segment_arrays(BaseSegment.from_index(rebuild_index(pv))),
            _segment_arrays(JBaseSegment.from_index(jrebuild_index(jv))))
    for a, b in ((live, jlive), (rest, jrest)):
        assert a.stats() == b.stats()
    for gen in ("gen-00000", "gen-00001"):
        for p in sorted((tmp_path / "jax" / gen).iterdir()):
            assert p.read_bytes() == (tmp_path / "port" / gen / p.name
                                      ).read_bytes(), (gen, p.name)


# ------------------------------------------------------------ parity sweep
def test_parity_across_add_commit_merge(live_sys):
    sys_ = live_sys
    rng = np.random.default_rng(13)
    qids = rng.choice(sys_.log.n_queries, size=6, replace=False)
    store = sys_.index_epoch_store
    out = check_epoch_parity(sys_, store.snapshot(), qids)
    assert out["ok"]
    sys_.add_documents([rand_doc(rng, vocab=256) for _ in range(4)])
    sys_.commit_index()
    out = check_epoch_parity(sys_, store.snapshot(), qids)
    assert out["ok"] and out["n_docs"] >= 516
    sys_.merge_index()
    out = check_epoch_parity(sys_, store.snapshot(), qids)
    assert out["ok"] and out["generation"] >= 1


def test_append_queries_served(live_sys):
    sys_ = live_sys
    rng = np.random.default_rng(14)
    doc = rand_doc(rng, vocab=256)
    [did] = sys_.add_documents([doc])
    terms = np.sort(doc[3][:2]).astype(np.int32)       # title terms
    [qid] = sys_.append_queries([terms], [CAT2],
                                judged_ids=[[did]], judged_gains=[[4]])
    sys_.commit_index()
    assert qid == sys_.log.n_queries - 1
    occ, scores, tp = sys_.batch_inputs([qid])
    assert int(tp.sum()) == len(terms)
    view = sys_.index_epoch_store.snapshot().view
    assert did in view.postings(int(terms[0]), 3)


# ---------------------------------------- epoch-keyed serving (regression)
def test_cache_hit_never_survives_epoch_swap(live_sys):
    """A result filled at epoch N must NEVER answer at epoch N+1."""
    sys_ = live_sys
    store = PolicyStore(staleness_bound=4)
    store.publish(sys_.baseline_policies(),
                  fallbacks=sys_.fallback_policies())
    engine = ServeEngine(sys_, store, EngineConfig(
        min_bucket=4, max_bucket=8, cache_capacity=256))
    engine.warmup()

    qid = 3
    [r1] = engine.serve([qid])
    e1 = r1.index_epoch
    assert not r1.cached and e1 == sys_.index_epoch
    [r2] = engine.serve([qid])
    assert r2.cached and r2.index_epoch == e1

    rng = np.random.default_rng(15)
    sys_.add_documents([rand_doc(rng, vocab=256)])
    sys_.commit_index()                    # epoch N+1
    [r3] = engine.serve([qid])
    assert r3.index_epoch == e1 + 1
    assert not r3.cached, "epoch-N fill answered at epoch N+1"
    [r4] = engine.serve([qid])             # refilled under the new key
    assert r4.cached and r4.index_epoch == e1 + 1
    assert engine.summary()["index_epoch_swaps"] >= 1


# -------------------------------------------------------------- freshness
def test_freshness_workload(live_sys):
    sys_ = live_sys
    n_docs0, n_q0, e0 = sys_.live.n_docs, sys_.log.n_queries, sys_.index_epoch
    w = FreshnessWorkload(sys_, FreshnessConfig(
        docs_per_tick=4, wave_queries=16, seed=3))
    wave = w.tick()
    assert sys_.live.n_docs == n_docs0 + 4
    assert sys_.log.n_queries == n_q0 + 4
    assert sys_.index_epoch == e0 + 1      # tick commits an epoch
    assert wave.shape == (16,)
    fresh = wave[wave >= n_q0]
    assert fresh.size > 0                  # the wave chases fresh docs
    q = int(fresh[0])
    assert sys_.log.judged_ids[q, 0] >= n_docs0


def test_live_system_scores_over_capacity(live_sys):
    """The batch path's every caller reads the capacity span: the
    scoring sub-batch is sized by it, occupancy and scores span it, and
    the planes the L1 fit reads are the capacity planes."""
    sys_ = live_sys
    cap = sys_.live.capacity_docs
    assert sys_.env_cfg.n_blocks == sys_.live.capacity_blocks == 12
    assert sys_.static_rank.shape == (cap,) and sys_.doc_len.shape[0] == cap
    occ, scores, tp = sys_.batch_inputs([0, 1, 2])
    assert occ.shape[1] == sys_.live.capacity_blocks
    assert scores.shape == (3, cap)
    feats, gains, weights = sys_.l1_training_set(n_queries=8, batch=4)
    assert np.isfinite(feats).all() and len(feats) == len(gains) > 0


# ------------------------------------------------- gates L3, L4 (a pair)
PAIR = dict(n_docs=512, vocab=256, seed=5, n_queries=96, block_docs=128,
            p_bins=128, u_budget=512, l1_steps=60, capacity=1536)


@pytest.fixture(scope="module")
def live_pair(tmp_path_factory):
    """A JAX and a port ``LiveRetrievalSystem`` from one config, each
    with a storage dir (memmapped bases), the port given the reference's
    L1 weights, state bins, rules and plans; the JAX epochs by version.  Tests
    mutate both identically, so their states stay aligned."""
    p = PAIR
    root = tmp_path_factory.mktemp("live_pair")
    jsys = JLiveRetrievalSystem(JSystemConfig(
        corpus=JCorpusConfig(n_docs=p["n_docs"], vocab_size=p["vocab"],
                             seed=p["seed"]),
        querylog=JQueryLogConfig(n_queries=p["n_queries"], seed=p["seed"]),
        block_docs=p["block_docs"], p_bins=p["p_bins"],
        u_budget=p["u_budget"], l1_steps=p["l1_steps"]),
        capacity_docs=p["capacity"], storage_dir=root / "jax")
    psys = LiveRetrievalSystem(SystemConfig(
        corpus=CorpusConfig(n_docs=p["n_docs"], vocab_size=p["vocab"],
                            seed=p["seed"]),
        querylog=QueryLogConfig(n_queries=p["n_queries"], seed=p["seed"]),
        block_docs=p["block_docs"], p_bins=p["p_bins"],
        u_budget=p["u_budget"], l1_steps=p["l1_steps"]),
        capacity_docs=p["capacity"], storage_dir=root / "port", device="cpu")
    jsys.fit_state_bins(n_queries=16, batch=16)    # the engines need bins
    rs = jsys.ruleset
    psys.load_reference(
        l1_params={k: np.asarray(v) for k, v in jsys.l1_params.items()},
        bins={"u_edges": np.asarray(jsys.bins.u_edges),
              "v_edges": np.asarray(jsys.bins.v_edges)},
        ruleset={k: np.asarray(getattr(rs, k))
                 for k in ("allowed", "required", "du_quota", "dv_quota")},
        plans={name: {k: np.asarray(getattr(pl, k)) for k in
                      ("rule_idx", "reset_before", "du_quota", "dv_quota")}
               for name, pl in jsys.plans.items()})
    jepochs = {}
    jsys.live.store.subscribe(lambda e: jepochs.__setitem__(e.version, e))
    return jsys, psys, jepochs


def _assert_logs_equal(jsys, psys):
    for k in ("terms", "n_terms", "category", "judged_ids", "judged_gains",
              "seed_doc", "popularity"):
        g, w = getattr(psys.log, k), getattr(jsys.log, k)
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert psys.idf_all.dtype == jsys.idf_all.dtype
    np.testing.assert_array_equal(psys.idf_all, jsys.idf_all)


def _assert_inputs_equal(jsys, psys, qids, jepoch, pepoch):
    with warnings.catch_warnings():
        warnings.simplefilter("error")          # no non-writable arrays
        occ, scores, tp = psys.batch_inputs(qids, epoch=pepoch)
    jocc, jscores, jtp = jsys.batch_inputs(qids, epoch=jepoch)
    np.testing.assert_array_equal(occ.numpy().view(np.uint32),
                                  np.asarray(jocc))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jtp))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               rtol=L1_RTOL, atol=L1_ATOL)


def test_gate_l3_live_system_matches_reference(live_pair):
    """Gate L3 over two freshness ticks with base-doc updates, a merge,
    and a batch pinned to a pre-merge epoch."""
    jsys, psys, jepochs = live_pair
    assert psys.env_cfg.n_blocks == jsys.env_cfg.n_blocks
    assert psys.live.capacity_docs == jsys.live.capacity_docs
    assert psys.live.stats()["base_mmapped"]
    cfg = dict(docs_per_tick=6, wave_queries=24, frac_fresh=0.7, seed=4)
    jw = JFreshnessWorkload(jsys, JFreshnessConfig(**cfg))
    pw = FreshnessWorkload(psys, FreshnessConfig(**cfg))
    urng = np.random.default_rng(31)
    pinned = None
    for tick in range(2):
        for d in urng.choice(PAIR["n_docs"], size=3, replace=False):
            fields = rand_doc(urng, vocab=PAIR["vocab"])
            jsys.update_document(int(d), fields)
            psys.update_document(int(d), fields)
        jwave, pwave = jw.tick(), pw.tick()
        np.testing.assert_array_equal(pwave, jwave)
        assert pw.added_docs == jw.added_docs
        assert pw.fresh_qids == jw.fresh_qids and pw.stats() == jw.stats()
        _assert_logs_equal(jsys, psys)
        je, pe = jsys.live.store.snapshot(), psys.live.store.snapshot()
        assert pe.version == je.version and _ops(pe) == _ops(je)
        _assert_inputs_equal(jsys, psys, pwave, je, pe)   # one shape: one jit
        pinned = (je, pe)
    jsys.merge_index()
    psys.merge_index()
    je, pe = jsys.live.store.snapshot(), psys.live.store.snapshot()
    assert (pe.version, pe.generation) == (je.version, je.generation)
    assert pe.view.base.mmapped
    qids = pw.wave()
    np.testing.assert_array_equal(qids, jw.wave())
    _assert_inputs_equal(jsys, psys, qids, je, pe)
    _assert_inputs_equal(jsys, psys, qids, *pinned)       # pre-merge epoch
    assert jepochs[pe.version] is je


def test_gate_l3_l1_training_set_over_capacity(live_pair):
    """``fit_l1``'s rows on the live system (head epoch, capacity
    planes) equal the reference's own loop over its live
    ``batch_inputs`` within rtol 1e-5 / atol 1e-6; the fit runs."""
    jsys, psys, _ = live_pair
    rng = np.random.default_rng(jsys.cfg.seed + 1)
    qids = rng.choice(jsys.log.n_queries, size=24, replace=False)
    feats_l, gains_l = [], []
    for i in range(0, len(qids), 8):
        chunk = qids[i:i + 8]
        occ, _, tp = jsys.batch_inputs(chunk)
        feats = jax.vmap(lambda o, i_, t: jdoc_features(
            o, i_, t, jsys.static_rank, jsys.doc_len))(
                occ, jnp.asarray(jsys.idf_all[chunk]), tp)
        jids = jsys.log.judged_ids[chunk]
        for row, q in enumerate(chunk):
            mask = jids[row] >= 0
            feats_l.append(np.asarray(feats[row])[np.clip(jids[row], 0, None)][mask])
            gains_l.append(jsys.log.judged_gains[q][mask])
    feats, gains, _ = psys.l1_training_set(n_queries=24, batch=8)
    np.testing.assert_allclose(feats, np.concatenate(feats_l),
                               rtol=L1_RTOL, atol=L1_ATOL)
    np.testing.assert_array_equal(gains, np.concatenate(gains_l))
    before = {k: v.clone() for k, v in psys.l1_params.items()}
    losses = psys.fit_l1(n_queries=16, batch=8)
    assert np.isfinite(np.asarray(losses)).all()
    assert any(not torch.equal(before[k], v) for k, v in psys.l1_params.items())


class ReferenceLiveInputs(LiveRetrievalSystem):
    """Test only: the port live system, answering ``batch_inputs`` with
    the JAX live system's arrays at the epoch of the same version."""

    def __init__(self, port, ref, jepochs):
        self.__dict__.update(port.__dict__)
        self._ref, self._jepochs = ref, jepochs

    def batch_inputs(self, query_ids, epoch=None):
        epoch = self._pin(epoch)
        occ, scores, tp = JLiveRetrievalSystem.batch_inputs(
            self._ref, np.asarray(query_ids),
            epoch=self._jepochs[epoch.version])
        return _t(occ), _t(scores), _t(tp)


def _mutate_both(jsys, psys, rng, n_docs=2):
    """One identical mutation on both systems: docs, chase queries, a
    base-doc update, a commit; returns the new qids."""
    docs = [rand_doc(rng, vocab=PAIR["vocab"]) for _ in range(n_docs)]
    upd = int(rng.integers(0, PAIR["n_docs"]))
    qids = []
    for s in (jsys, psys):
        ids = s.add_documents(docs, static_rank=[0.01] * n_docs)
        s.update_document(upd, docs[0])
        qids.append(s.append_queries([d[3][:2] for d in docs],
                                     [CAT2] * n_docs,
                                     judged_ids=[[i] for i in ids],
                                     judged_gains=[[4]] * n_docs))
        s.commit_index()
    np.testing.assert_array_equal(qids[0], qids[1])
    return qids[1]


RESPONSE_FIELDS = ("request_id", "qid", "category", "u", "cand_cnt",
                   "cached", "policy_version", "index_epoch")


def _assert_responses_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(getattr(g, k) for k in RESPONSE_FIELDS) + (int(g.level),) \
            == tuple(getattr(w, k) for k in RESPONSE_FIELDS) + (int(w.level),)
        assert g.doc_ids.dtype == w.doc_ids.dtype
        assert g.scores.dtype == w.scores.dtype
        np.testing.assert_array_equal(g.doc_ids, w.doc_ids)
        np.testing.assert_array_equal(g.scores, w.scores)


@pytest.mark.parametrize("backend", ["reference", "block_scan"])
def test_gate_l4_engine_across_epoch_swaps(live_pair, backend):
    """Gate L4: serve, mutate (commit), serve, merge, serve — through the
    JAX engine and the port engine on the reference's arrays; every
    response field but latency and the summary's epoch counters equal,
    pre-swap fills never answering after a swap."""
    jsys, psys, jepochs = live_pair
    ref_inputs = ReferenceLiveInputs(psys, jsys, jepochs)
    cfg = dict(min_bucket=4, max_bucket=8, cache_capacity=64)
    jstore = JPolicyStore(staleness_bound=0)
    jstore.publish(jsys.baseline_policies(), fallbacks=jsys.fallback_policies())
    store = PolicyStore(staleness_bound=0)
    store.publish(psys.baseline_policies(), fallbacks=psys.fallback_policies())
    jeng = JServeEngine(jsys, jstore, JEngineConfig(**cfg))
    eng = ServeEngine(ref_inputs, store, EngineConfig(backend=backend, **cfg))
    rng = np.random.default_rng(41 if backend == "reference" else 42)
    head = rng.choice(PAIR["n_queries"], size=6, replace=False)
    got, want = [], []

    def serve(qids):
        want.extend(jeng.serve(qids))
        got.extend(eng.serve(qids))

    serve(head)
    serve(head[:4])                                  # hits
    fresh = _mutate_both(jsys, psys, rng)            # epoch swap
    serve(np.concatenate([head[:4], fresh]))
    serve(head[:2])
    jsys.merge_index()
    psys.merge_index()                               # a merge: another swap
    serve(np.concatenate([head[:3], fresh]))
    _assert_responses_equal(got, want)
    epochs = [r.index_epoch for r in got]
    assert len(set(epochs)) == 3
    assert any(r.cached for r in got)
    swap = len(head) + 4                             # first post-swap wave
    assert not any(r.cached for r in got[swap:swap + 4])
    js, ps = jeng.summary(), eng.summary()
    for k in ("index_epoch", "index_epoch_swaps", "n_requests", "n_cached",
              "cache_hits", "cache_misses", "n_batches"):
        assert ps[k] == js[k], k
    assert ps["index_epoch_swaps"] == 2
    assert eng.telemetry.registry.snapshot()["index.epoch_swaps"] == \
        {"type": "counter", "value": 2}


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_engine_refuses_a_stale_epoch_until_refreshed(live_pair, pkg):
    """``validate`` on the drain path: with auto-refresh off, an engine
    pinned two epochs behind a bound-1 store refuses to execute
    (``StaleIndexEpochError``, the request requeued), serves once
    ``refresh_index`` adopts the head, and answers at the head epoch."""
    jsys, psys, _ = live_pair
    rng = np.random.default_rng(51)
    if pkg == "reference":
        sys_, store = jsys, JPolicyStore(staleness_bound=0)
        stale, make = JStaleIndexEpochError, (
            lambda st: JServeEngine(jsys, st, JEngineConfig(
                min_bucket=4, max_bucket=8, cache_capacity=16,
                auto_refresh=False)))
    else:
        sys_, store = psys, PolicyStore(staleness_bound=0)
        stale, make = StaleIndexEpochError, (
            lambda st: ServeEngine(psys, st, EngineConfig(
                min_bucket=4, max_bucket=8, cache_capacity=16,
                auto_refresh=False)))
    store.publish(sys_.baseline_policies(), fallbacks=sys_.fallback_policies())
    engine = make(store)
    pinned = engine.index_epoch
    istore = sys_.index_epoch_store
    bound, istore.staleness_bound = istore.staleness_bound, 1
    try:
        rid = engine.submit(7)
        for _ in range(2):
            sys_.add_documents([rand_doc(rng, vocab=PAIR["vocab"])])
            sys_.commit_index()
        with pytest.raises(stale):
            engine.flush()
        assert engine.queue_depth == 1               # requeued, not lost
        assert engine.refresh_index()
        engine.flush()
        resp = engine.take_response(rid)
    finally:
        istore.staleness_bound = bound
        # keep the pair aligned: the other package gets the same commits
        other = psys if pkg == "reference" else jsys
        orng = np.random.default_rng(51)
        for _ in range(2):
            other.add_documents([rand_doc(orng, vocab=PAIR["vocab"])])
            other.commit_index()
    assert resp is not None and resp.index_epoch == pinned + 2
    assert engine.summary()["index_epoch_swaps"] == 1


def test_gate_l4_cluster_epoch_events_lag_and_delta_pricing(live_pair):
    """The cluster's epoch branches on a live system, held to the JAX
    ``ReplicaSet``: the flight recorder's epoch-swap and merge events,
    the epoch lag of a response whose batch raced a commit, the heads
    and replica epochs in ``stats()``, the estimator's delta probes and
    its delta correction, and every response."""
    jsys, psys, jepochs = live_pair
    ref_inputs = ReferenceLiveInputs(psys, jsys, jepochs)
    cfg = dict(min_bucket=4, max_bucket=8, cache_capacity=64)
    jstore = JPolicyStore(staleness_bound=2)
    jstore.publish(jsys.baseline_policies(), fallbacks=jsys.fallback_policies())
    store = PolicyStore(staleness_bound=2)
    store.publish(psys.baseline_policies(), fallbacks=psys.fallback_policies())
    jcl = JReplicaSet(jsys, jstore, JClusterConfig(n_replicas=1),
                      JEngineConfig(**cfg))
    cl = ReplicaSet(ref_inputs, store, ClusterConfig(n_replicas=1),
                    EngineConfig(backend="block_scan", **cfg))
    rng = np.random.default_rng(61)
    race_doc = rand_doc(rng, vocab=PAIR["vocab"])
    armed = {}

    def racing(sys_, inner):
        def batch_inputs(qids, epoch=None):
            out = inner(qids, epoch=epoch)
            if armed.pop(id(sys_), False):
                # A commit lands while this batch executes: its
                # responses are one epoch behind the head.
                sys_.add_documents([race_doc])
                sys_.commit_index()
            return out
        return batch_inputs

    jsys_inputs = jsys.batch_inputs
    jsys.batch_inputs = racing(jsys, jsys_inputs)
    ref_inputs.batch_inputs = racing(psys, ref_inputs.batch_inputs)
    got, want = [], []
    try:
        with jcl, cl:
            def wave(qids):
                want.extend(jcl.serve(qids, timeout_s=WAIT_S))
                got.extend(cl.serve(qids, timeout_s=WAIT_S))
                # A ticket's waiter wakes before its completion is
                # accounted (epoch lag, estimator): wait for every
                # ticket's accounting before the index moves on.
                deadline = time.monotonic() + WAIT_S
                while (min(c.stats()["n_responses"] for c in (jcl, cl))
                       < len(got) and time.monotonic() < deadline):
                    time.sleep(0.005)

            wave(rng.choice(PAIR["n_queries"], size=4, replace=False))
            fresh = _mutate_both(jsys, psys, rng)          # epoch_swap
            wave(fresh)
            jsys.merge_index()
            psys.merge_index()                             # index_merge
            fresh2 = _mutate_both(jsys, psys, rng)         # delta again
            armed[id(jsys)] = armed[id(psys)] = True
            wave(fresh2[:1])                               # races a commit
            js, ps = jcl.stats(), cl.stats()
            jest, est = jcl.admission.estimator, cl.admission.estimator
            probe = np.concatenate([np.arange(8), fresh, fresh2])
            np.testing.assert_array_equal(est.delta_hits_many(probe),
                                          jest.delta_hits_many(probe))
            assert [est.delta_hit(int(q)) for q in probe] == \
                [jest.delta_hit(int(q)) for q in probe]
            assert any(est.delta_hit(int(q)) for q in fresh2)
            assert [est.estimate(int(q)) for q in probe] == \
                [jest.estimate(int(q)) for q in probe]
            assert est.describe() == jest.describe()
            jev = [e for e in jcl.events.snapshot()
                   if e["kind"] in ("epoch_swap", "index_merge")]
            pev = [e for e in cl.events.snapshot()
                   if e["kind"] in ("epoch_swap", "index_merge")]
    finally:
        jsys.batch_inputs = jsys_inputs
    _assert_responses_equal(got, want)
    assert not any(isinstance(r, Shed) for r in got)
    for k in ("index_epoch_head", "epoch_lag_observed_max",
              "epoch_lag_observed_mean", "n_submitted", "n_responses",
              "n_shed"):
        assert ps[k] == js[k], k
    assert ps["epoch_lag_observed_max"] == 1
    head = ps["index_epoch_head"]
    assert head == got[-1].index_epoch + 1
    # A replica adopts the head at its next drain, whose timing the
    # test does not fix: its pinned epoch is the response's or the head.
    for stats in (ps, js):
        assert set(stats["replica_index_epochs"]) <= {head - 1, head}
    keys = ("kind", "version", "generation", "n_ops")
    assert [tuple(e[k] for k in keys) for e in pev] == \
        [tuple(e[k] for k in keys) for e in jev]
    assert [e["kind"] for e in pev].count("index_merge") == 1
    assert [e["kind"] for e in pev].count("epoch_swap") >= 3


def test_epoch_reads_stay_consistent_under_concurrent_writes(small_live_sys):
    """Readers on 8 threads pin epochs and build batches while a writer
    adds docs, appends queries, commits and merges, with a short switch
    interval: every batch's occupancy equals its pinned view's, its
    scoring planes are that epoch's, and the planes LRU stays bounded."""
    import sys
    import threading

    sys_ = small_live_sys
    store = sys_.index_epoch_store
    stop = threading.Event()
    errors, checked = [], []
    published = [sys_.log.n_queries]   # qids exist once append returns

    def reader(seed):
        rng = np.random.default_rng(seed)
        try:
            while not stop.is_set():
                epoch = store.snapshot()
                log = sys_.log
                qids = rng.integers(0, published[0], size=3)
                occ, scores, _ = sys_.batch_inputs(qids, epoch=epoch)
                lists = [log.terms[q, : log.n_terms[q]] for q in qids]
                want = epoch.view.batch_query_occupancy(lists)
                assert np.array_equal(occ.numpy().view(np.uint32), want)
                assert scores.shape == (3, sys_.live.capacity_docs)
                sr, _ = sys_._epoch_planes(epoch)
                n = epoch.view.n_docs
                assert np.array_equal(sr[:n].numpy(), epoch.view.static_rank())
                assert len(sys_._planes) <= 4
                checked.append(1)
        except Exception as e:          # noqa: BLE001 — asserted below
            errors.append(e)

    rng = np.random.default_rng(81)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    threads = [threading.Thread(target=reader, args=(i,)) for i in range(8)]
    try:
        for t in threads:
            t.start()
        for i in range(6):
            docs = [rand_doc(rng, vocab=128) for _ in range(3)]
            ids = sys_.add_documents(docs)
            new = sys_.append_queries([d[3][:2] for d in docs], [CAT2] * 3,
                                      judged_ids=[[d] for d in ids],
                                      judged_gains=[[4]] * 3)
            published[0] = int(new[-1]) + 1
            sys_.commit_index()
            if i % 3 == 2:
                sys_.merge_index()
            time.sleep(0.05)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=WAIT_S)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert len(checked) >= 8


# ------------------------------------- delta-aware pricing, op-log restore
@pytest.fixture(scope="module")
def small_live_sys():
    """The reference's ``tests/test_proc_cell.py`` live system, ported."""
    return LiveRetrievalSystem(SystemConfig(
        corpus=CorpusConfig(n_docs=256, vocab_size=128, seed=7),
        querylog=QueryLogConfig(n_queries=64, seed=7),
        block_docs=64, p_bins=64, u_budget=256, l1_steps=40,
    ), capacity_docs=768, device="cpu")


def _doc_with_terms(terms, vocab=128):
    body = np.unique(np.asarray(terms, np.int32))
    other = np.array([int(body[0])], np.int32)
    return [other, other, body, other]


def test_ucost_delta_correction_converges(small_live_sys):
    """A query whose terms land in the head delta is priced with a
    learned per-category correction; base buckets stay base-only and
    non-hit queries are unaffected."""
    live_sys = small_live_sys
    est = UCostEstimator(live_sys, prior_u=100.0)
    log = live_sys.log
    qid = 0
    hit_terms = log.terms[qid, : log.n_terms[qid]]
    other = next(q for q in range(log.n_queries)
                 if not set(log.terms[q, : log.n_terms[q]].tolist())
                 & set(hit_terms.tolist())
                 and (int(log.category[q]), est.features(q)[1])
                 == (int(log.category[qid]), est.features(qid)[1]))

    est.observe(qid, 100.0)                    # base-only: table = 100
    assert est.estimate(qid) == 100.0
    assert not est.delta_hit(qid)

    live_sys.add_documents([_doc_with_terms(hit_terms)])
    head = live_sys.commit_index()
    assert est.delta_hit(qid)
    assert not est.delta_hit(other)
    assert est.estimate(qid) == 100.0          # correction starts at 1.0

    est.observe(qid, 500.0, index_epoch=head - 1)
    assert est.estimate(qid) == 100.0

    for _ in range(12):
        est.observe(qid, 160.0, index_epoch=head)
    assert abs(est.estimate(qid) - 160.0) < 1.0
    assert est.estimate(other) == 100.0
    d = est.describe()
    assert d["delta_obs"] == 12 and d["delta_terms_epoch"] == head

    live_sys.merge_index()
    assert not est.delta_hit(qid)
    assert est.estimate(qid) == 100.0


def test_ucost_delta_pricing_matches_reference(live_pair):
    """The estimator's delta pricing on the live pair: the same probes,
    stale and head observations give the same floats."""
    jsys, psys, _ = live_pair
    est, jest = (UCostEstimator(psys, prior_u=80.0),
                 JUCostEstimator(jsys, prior_u=80.0))
    rng = np.random.default_rng(71)
    fresh = _mutate_both(jsys, psys, rng, n_docs=3)
    head = psys.index_epoch
    for q, u, ep in ((int(fresh[0]), 120.0, head), (int(fresh[1]), 90.0, head),
                     (int(fresh[0]), 400.0, head - 1), (3, 70.0, head)):
        est.observe(q, u, index_epoch=ep)
        jest.observe(q, u, index_epoch=ep)
    probe = np.concatenate([np.arange(12), fresh])
    assert [est.estimate(int(q)) for q in probe] == \
        [jest.estimate(int(q)) for q in probe]
    for g, w in zip(est.estimates_many(probe), jest.estimates_many(probe)):
        np.testing.assert_array_equal(g, w)
    assert est.describe() == jest.describe()


def test_oplog_checkpoint_restore_bit_parity(tmp_path):
    """Crash-restart: restore() replays the committed op-log prefix and
    the head view is bit-identical to the never-crashed index's;
    pending (uncommitted) ops survive to the next commit."""
    rng = np.random.default_rng(3)
    live = LiveIndex(tiny_index(n_docs=96), storage_dir=tmp_path / "cell")
    live.add_documents([rand_doc(rng) for _ in range(5)])
    live.commit()
    live.update_document(7, rand_doc(rng))
    live.commit()
    live.add_documents([rand_doc(rng) for _ in range(2)])  # pending
    live.checkpoint()

    restored = LiveIndex.restore(tmp_path / "cell")
    a = live.store.snapshot().view
    b = restored.store.snapshot().view
    assert a.n_docs == b.n_docs
    np.testing.assert_array_equal(a.df, b.df)
    np.testing.assert_array_equal(a.static_rank(), b.static_rank())
    np.testing.assert_array_equal(a.doc_len(), b.doc_len())
    vocab = a.base.index.vocab_size
    for f in range(N_FIELDS):
        for term in range(vocab):
            np.testing.assert_array_equal(a.postings(term, f),
                                          b.postings(term, f))
    assert live.commit() > 0 and restored.commit() > 0
    av = live.store.snapshot().view
    bv = restored.store.snapshot().view
    assert av.n_docs == bv.n_docs
    for f in range(N_FIELDS):
        for term in range(vocab):
            np.testing.assert_array_equal(av.postings(term, f),
                                          bv.postings(term, f))


def test_restore_discards_a_stale_checkpoint(tmp_path):
    """A checkpoint written before a merge that did not refresh it
    (a crash between the two) is discarded on restore: the newest
    generation holds those ops already."""
    rng = np.random.default_rng(4)
    live = LiveIndex(tiny_index(), storage_dir=tmp_path)
    live.add_documents([rand_doc(rng) for _ in range(3)])
    live.commit()
    live.checkpoint()
    stale = (tmp_path / "oplog.ckpt").read_bytes()
    live.merge()                                  # refreshes the checkpoint
    (tmp_path / "oplog.ckpt").write_bytes(stale)  # as if it had crashed
    restored = LiveIndex.restore(tmp_path)
    assert restored.generation == 1 and restored.delta_docs == 0
    assert restored.n_docs == live.n_docs and restored.pending_ops == 0


# -------------------------------------------------------------------- CLI
def test_live_index_cli_smoke_on_cpu(tmp_path):
    """``launch/live_index.py --smoke --device cpu`` (the port's index
    smoke at its tiny sizes): it asserts zero dropped and shed, >= 2
    merges and generations, >= 2 epochs served, fresh responses, parity
    at every recorded epoch on both backends and an mmapped base."""
    from repro_torch.launch.live_index import main

    out = tmp_path / "li.json"
    main(["--smoke", "--device", "cpu", "--out", str(out),
          "--storage-dir", str(tmp_path / "gens"),
          "--metrics-json", str(tmp_path / "m.json")])
    res = json.loads(out.read_text())
    assert res["device"] == "cpu" and res["n_shed"] == 0
    assert res["merges"] >= 2 and len(res["response_epochs"]) >= 2
    assert res["parity"] and all(p["ok"] for p in res["parity"])
    assert all(p["backends"] == ["reference", "block_scan"]
               for p in res["parity"])
    metrics = json.loads((tmp_path / "m.json").read_text())
    assert metrics["index.merges"]["value"] == res["merges"]
    assert sorted(p.name for p in (tmp_path / "gens").glob("gen-*"))[-1] \
        == f"gen-{res['generation']:05d}"
