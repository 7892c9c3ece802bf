"""The port's observability plane (``repro_torch.obs``) and serving
telemetry: the metrics registry's semantics (merge fold, bucket
layout), ticket-scoped tracing (span lifecycle, ring eviction and
re-rooting, Chrome export with matched B/E at equal timestamps) and
telemetry QPS windowing — the cases of ``tests/test_obs.py`` that need
no cluster, ported case for case — and the active tracer's spans and
the host-sync count inside the rule loop and the TD update, on the
websearch-rl cells at their reduced sizes.  JAX-free."""
import contextlib
import dataclasses
import importlib.util
import json
import threading
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import torch

from repro_torch.obs import (Counter, Gauge, Histogram, MetricsRegistry,
                             NULL_SPAN, NULL_TRACER, TraceLog, Tracer, active,
                             host_sync, host_syncs, merge_snapshots,
                             metric_key, scope, tracing)

ROOT = Path(__file__).resolve().parents[1]


def _load_checker():
    """tools/check_trace.py is a script, not a package module — load it
    by path so the tests exercise the exact tool CI runs."""
    spec = importlib.util.spec_from_file_location(
        "check_trace", ROOT / "tools" / "check_trace.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------- metrics
def test_metric_key_sorts_labels():
    assert metric_key("m", {}) == "m"
    assert metric_key("m", {"b": 2, "a": 1}) == "m{a=1,b=2}"
    assert metric_key("m", {"a": 1, "b": 2}) == metric_key("m", {"b": 2,
                                                                 "a": 1})


def test_counter_and_gauge():
    c = Counter()
    c.inc()
    c.inc(3)
    assert c.value == 4
    assert c.snapshot() == {"type": "counter", "value": 4}
    g = Gauge()
    g.set(5.0)
    g.set(2.0)
    assert g.value == 2.0 and g.max == 5.0


def test_histogram_buckets_overflow_and_quantile():
    h = Histogram(edges=(1.0, 2.0, 5.0))
    for v in (0.5, 1.0, 1.5, 4.0, 100.0):
        h.record(v)
    # bisect_left: v == edge lands in that edge's bucket (<= semantics)
    assert h.counts == [2, 1, 1, 1]          # last = +inf overflow
    assert h.count == 5 and h.sum == pytest.approx(107.0)
    assert h.min == 0.5 and h.max == 100.0
    assert h.quantile(0.0) == 1.0            # first non-empty bucket edge
    assert h.quantile(0.5) == 2.0
    assert h.quantile(1.0) == 100.0          # overflow bucket -> true max
    with pytest.raises(ValueError):
        Histogram(edges=(2.0, 1.0))          # unsorted


def test_registry_get_or_create_and_mismatches():
    reg = MetricsRegistry()
    assert reg.counter("hits") is reg.counter("hits")
    assert reg.counter("hits", level=1) is not reg.counter("hits", level=2)
    with pytest.raises(TypeError):
        reg.gauge("hits")                    # same key, different type
    reg.histogram("lat", (1.0, 2.0), level=0)
    with pytest.raises(ValueError):
        reg.histogram("lat", (1.0, 3.0), level=0)   # edge mismatch
    keys = set(reg.collect("hits"))
    assert keys == {"hits", "hits{level=1}", "hits{level=2}"}


def _snap(rng, n_keys: int = 4):
    """A random registry snapshot over a small shared key space.
    Values are integral so float addition in the merge is exact and
    associativity can be checked with ==."""
    reg = MetricsRegistry()
    for k in range(n_keys):
        kind = k % 3
        if kind == 0:
            reg.counter("c", k=k).inc(int(rng.integers(0, 100)))
        elif kind == 1:
            reg.gauge("g", k=k).set(float(rng.integers(0, 100)))
        else:
            h = reg.histogram("h", (1.0, 10.0, 100.0), k=k)
            for _ in range(int(rng.integers(0, 8))):
                h.record(float(rng.integers(0, 200)))
    return reg.snapshot()


@settings(deadline=None, max_examples=10)
@given(st.integers(0, 2**31 - 1))
def test_merge_snapshots_associative_commutative(seed):
    rng = np.random.default_rng(seed)
    a, b, c = _snap(rng), _snap(rng), _snap(rng)
    left = merge_snapshots([merge_snapshots([a, b]), c])
    right = merge_snapshots([a, merge_snapshots([b, c])])
    flat = merge_snapshots([a, b, c])
    assert left == right == flat
    assert merge_snapshots([b, a]) == merge_snapshots([a, b])
    # identity: merging with an empty snapshot changes nothing
    assert merge_snapshots([a, {}]) == merge_snapshots([a])


def test_merge_semantics():
    r1, r2 = MetricsRegistry(), MetricsRegistry()
    r1.counter("n").inc(2)
    r2.counter("n").inc(3)
    r1.gauge("depth").set(7.0)
    r2.gauge("depth").set(4.0)
    r1.histogram("lat", (1.0, 2.0)).record(0.5)
    r2.histogram("lat", (1.0, 2.0)).record(9.0)
    m = merge_snapshots([r1.snapshot(), r2.snapshot()])
    assert m["n"]["value"] == 5              # counters add
    assert m["depth"]["value"] == 7.0        # gauges take the max
    assert m["lat"]["counts"] == [1, 0, 1]   # histograms add elementwise
    assert m["lat"]["min"] == 0.5 and m["lat"]["max"] == 9.0
    r3 = MetricsRegistry()
    r3.histogram("lat", (1.0, 5.0)).record(0.5)
    with pytest.raises(ValueError):
        merge_snapshots([r1.snapshot(), r3.snapshot()])


# ---------------------------------------------------------------- tracing
def test_disabled_tracer_is_inert():
    assert not NULL_TRACER.enabled
    s = NULL_TRACER.span("x")
    assert s is NULL_SPAN and not s
    assert s.child("y") is NULL_SPAN
    s.instant("z")
    s.end()
    assert len(NULL_TRACER.log) == 0
    with NULL_TRACER.span("w"):
        pass
    assert NULL_TRACER.log.n_recorded == 0


def test_span_lifecycle_parents_and_double_end():
    tr = Tracer(clock=iter(np.arange(100.0)).__next__)
    root = tr.root_span("ticket", qid=7)
    assert root and root.track == f"ticket #{root.span_id}"
    child = root.child("queue")
    child.end()
    child.end(extra="ignored")               # double end: first wins
    root.instant("cache_miss")
    root.end(level="FULL")
    snap = tr.log.snapshot()
    assert [e["name"] for e in snap] == ["queue", "cache_miss", "ticket"]
    by_name = {e["name"]: e for e in snap}
    assert by_name["queue"]["parent"] == root.span_id
    assert by_name["cache_miss"]["parent"] == root.span_id
    assert by_name["ticket"]["args"] == {"qid": 7, "level": "FULL"}
    assert "extra" not in (by_name["queue"]["args"] or {})
    assert by_name["queue"]["t1"] >= by_name["queue"]["t0"]


def test_span_context_manager_records_error():
    tr = Tracer()
    with pytest.raises(RuntimeError):
        with tr.span("risky"):
            raise RuntimeError("boom")
    (entry,) = tr.log.snapshot()
    assert entry["args"]["error"] == "RuntimeError"


def test_ring_eviction_reroots_dangling_parents():
    tr = Tracer(log=TraceLog(capacity=3))
    # Pathological end order (parent ends before its child) so the
    # parent is appended -- and evicted -- first.
    p = tr.span("p")
    c = p.child("c")
    p.end()
    for _ in range(3):                       # push p out of the ring
        tr.span("filler").end()
    c.end()
    snap = tr.log.snapshot()
    live = {e["id"] for e in snap}
    assert all(e["parent"] is None or e["parent"] in live for e in snap)
    child = next(e for e in snap if e["name"] == "c")
    assert child["parent"] is None           # re-rooted, not dangling
    assert tr.log.n_evicted == 2             # p + first filler


def test_chrome_export_wellformed(tmp_path):
    checker = _load_checker()
    tr = Tracer()
    with tr.span("epoch", track="trainer", it=0):
        tr.instant("tap_draw", track="trainer", n=4)
    t = tr.root_span("ticket", qid=1)
    q = t.child("queue")
    q.end()
    t.end()
    doc = tr.log.export_chrome(process_name="unit")
    assert doc["displayTimeUnit"] == "ms"
    names = {e["args"]["name"] for e in doc["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert "trainer" in names and f"ticket #{t.span_id}" in names
    path = tmp_path / "trace.json"
    tr.log.write_chrome(path, process_name="unit")
    out = checker.check_trace(str(path), require_chain=False)
    assert out["n_spans"] == 3 and out["n_tracks"] >= 2

    # Tampered nesting (E closing the wrong B) must fail the checker.
    bad = json.loads(path.read_text())
    es = [e for e in bad["traceEvents"] if e["ph"] == "E"]
    es[0]["name"] = "not-the-open-span"
    (tmp_path / "bad.json").write_text(json.dumps(bad))
    with pytest.raises(SystemExit):
        checker.check_trace(str(tmp_path / "bad.json"), require_chain=False)


def test_export_nests_at_equal_timestamps():
    """Adjacent spans sharing a boundary timestamp: the close must sort
    before the next open on the same track, or Perfetto mis-nests."""
    tr = Tracer(clock=lambda: 0.0)
    a = tr.span("a", track="t")
    a.end(t1=1.0)
    b = tr.span("b", track="t")
    b.t0 = 1.0
    b.end(t1=2.0)
    evs = [e for e in tr.log.export_chrome()["traceEvents"]
           if e["ph"] in "BE"]
    assert [(e["name"], e["ph"]) for e in evs] == \
        [("a", "B"), ("a", "E"), ("b", "B"), ("b", "E")]


# ----------------------------------------------------- telemetry windowing
def test_qps_uses_window_span_not_lifetime():
    """Regression: once the request window wraps, QPS must be the
    window count over the window's own t_done span — dividing by the
    lifetime span shrinks QPS as the process ages."""
    from repro_torch.serving.telemetry import Telemetry

    t = Telemetry(window=4)
    for i in range(10):                      # one request per second
        t.record_request(category=0, latency_s=1e-3, u=8, cached=False,
                         t_done=float(i))
    assert t.total_requests == 10            # lifetime counter intact
    assert len(t.requests) == 4              # window wrapped
    s = t.summary()
    assert s["qps"] == pytest.approx(4 / 3)  # 4 requests over t in [6, 9]
    # the old bug divided by the lifetime span: 4 / 9
    assert s["qps"] != pytest.approx(4 / 9)


def test_telemetry_registry_histograms_and_summary_shape():
    from repro_torch.serving.telemetry import Telemetry

    t = Telemetry()
    t.record_request(category=1, latency_s=0.003, u=64, cached=False,
                     t_done=0.0, level=0)
    t.record_request(category=2, latency_s=0.004, u=32, cached=True,
                     t_done=1.0, level=1)
    t.record_queue_wait(category=1, level=0, wait_s=0.001)
    snap = t.registry.snapshot()
    assert snap["serve.latency_ms{category=1,level=0}"]["count"] == 1
    assert snap["serve.u{category=2,level=1}"]["count"] == 1
    assert snap["serve.queue_wait_ms{category=1,level=0}"]["count"] == 1
    assert snap["serve.requests"]["value"] == 2
    assert t.level_counts == {0: 1, 1: 1}
    assert {"n_requests", "qps", "latency_p50_ms", "latency_p99_ms",
            "mean_u", "p99_u", "level_counts", "cache_hit_rate",
            "peak_queue_depth", "peak_inflight"} <= set(t.summary())
    json.dumps(snap)                         # snapshot is JSON-clean


def test_gauge_sum_aggregation_and_mismatch():
    """Depth-style gauges declare agg="sum" and merge by adding;
    mixing aggregations for one key must fail loudly, at registration
    and at merge."""
    r1, r2 = MetricsRegistry(), MetricsRegistry()
    r1.gauge("depth", agg="sum").set(3.0)
    r2.gauge("depth", agg="sum").set(4.0)
    snap1 = r1.snapshot()
    assert snap1["depth"]["agg"] == "sum"
    m = merge_snapshots([snap1, r2.snapshot()])
    assert m["depth"]["value"] == 7.0          # sums, not max
    assert m["depth"]["max"] == 7.0
    assert m["depth"]["agg"] == "sum"          # survives the fold
    # default stays max-aggregated (peaks must not add across replicas)
    r1.gauge("peak").set(5.0)
    r2.gauge("peak").set(2.0)
    assert merge_snapshots([r1.snapshot(),
                            r2.snapshot()])["peak"]["value"] == 5.0
    with pytest.raises(ValueError):
        r1.gauge("depth")                      # agg mismatch at re-get
    with pytest.raises(ValueError):
        Gauge(agg="median")                    # unknown aggregation
    r3 = MetricsRegistry()
    r3.gauge("depth").set(1.0)                 # max-agg under the same key
    with pytest.raises(ValueError):
        merge_snapshots([snap1, r3.snapshot()])


def test_fleet_depth_gauges_sum_across_replicas():
    """The two serving depth gauges ride snapshots as sum-aggregated —
    fleet queue depth is the SUM of per-replica depths, not the max."""
    from repro_torch.serving.telemetry import Telemetry

    snaps = []
    for depth in (3, 4):
        t = Telemetry()
        t.observe_gauges(queue_depth=depth, inflight=1)
        snaps.append(t.registry.snapshot())
    m = merge_snapshots(snaps)
    assert m["serve.queue_depth"]["agg"] == "sum"
    assert m["serve.queue_depth"]["value"] == 7.0
    assert m["serve.inflight"]["value"] == 2.0


# ------------------------------------------------------- export nesting
def _assert_trace_doc_wellformed(doc):
    """Inline version of tools/check_trace.py's core checks: monotone
    timestamps and per-(pid, tid) matched B/E nesting."""
    last = None
    stacks = {}
    for ev in doc["traceEvents"]:
        if ev["ph"] == "M":
            continue
        assert last is None or ev["ts"] >= last, "ts went backwards"
        last = ev["ts"]
        key = (ev["pid"], ev["tid"])
        if ev["ph"] == "B":
            stacks.setdefault(key, []).append(ev["name"])
        elif ev["ph"] == "E":
            assert stacks.get(key), f"E without B on {key}"
            assert stacks[key].pop() == ev["name"], "bad nesting"
    assert all(not s for s in stacks.values()), "unclosed B at EOF"


def test_clamped_shared_boundary_closes_inner_span_first():
    """A span recorded by another tracer on a ticket's track that ends
    past its enclosing span is clamped to that span's close; the two E
    events then tie on timestamp and the export must close the INNER
    span first (depth tie-break)."""
    from repro_torch.obs import export_chrome_entries

    parent = Tracer(clock=lambda: 0.0)
    t = parent.root_span("ticket")
    t.t0 = 0.0
    ring = t.child("ring")
    ring.t0 = 1.0
    ring.end(t1=5.0)
    t.end(t1=6.0)
    wtr = Tracer(clock=lambda: 0.0)
    sub = wtr.span("submit", track=t.track)
    sub.t0 = 2.0
    sub.end(t1=5.5)              # past the ring's close
    entries = parent.log.snapshot() + [
        dict(e, id=e["id"] + (9 << 32)) for e in wtr.log.snapshot()]
    doc = export_chrome_entries(entries)
    _assert_trace_doc_wellformed(doc)
    ends = [e["name"] for e in doc["traceEvents"] if e["ph"] == "E"]
    assert ends == ["submit", "ring", "ticket"]


def test_export_namespaces_tids_by_pid(tmp_path):
    """Entries stamped with a ``pid`` get their own (pid, tid) rows and
    ``process_name`` metadata; unstamped ones are pid 1."""
    from repro_torch.obs import write_chrome_entries

    tr = Tracer(clock=iter(np.arange(0.0, 10.0, 0.5)).__next__)
    with tr.span("step", track="worker"):
        pass
    local = tr.log.snapshot()
    stamped = [dict(e, pid=101, id=e["id"] + (1 << 32)) for e in local]
    path = tmp_path / "trace.json"
    write_chrome_entries(path, local + stamped, process_name="unit",
                         pid_names={101: "worker proc"})
    doc = json.loads(path.read_text())
    _assert_trace_doc_wellformed(doc)
    rows = {(e["pid"], e["tid"]) for e in doc["traceEvents"]
            if e["ph"] == "M" and e["name"] == "thread_name"}
    assert len(rows) == 2 and {p for p, _ in rows} == {1, 101}
    pnames = {e["pid"]: e["args"]["name"] for e in doc["traceEvents"]
              if e["ph"] == "M" and e["name"] == "process_name"}
    assert pnames == {1: "unit", 101: "worker proc"}


# ------------------------------------- the active tracer in the rule loop
BACKENDS = ("reference", "block_scan")
TD_READS = 4            # td_update: two valid selections, unique, widest cell


def test_active_tracer_is_per_thread_and_off_by_default():
    assert active() is NULL_TRACER and scope("x") is NULL_SPAN
    tracer, seen = Tracer(), {}
    with tracing(tracer):
        assert active() is tracer
        other = threading.Thread(target=lambda: seen.update(t=active()))
        other.start()
        other.join()
        with scope("outer", k=1) as outer:
            with scope("inner"):
                pass
            outer.end(more=2)
    assert seen["t"] is NULL_TRACER and active() is NULL_TRACER
    by = {e["name"]: e for e in tracer.log.snapshot()}
    assert by["inner"]["parent"] == by["outer"]["id"]
    assert by["outer"]["parent"] is None
    assert by["outer"]["args"] == {"k": 1, "more": 2}


def test_host_sync_counts_always_and_times_only_under_a_tracer():
    n = host_syncs()
    with host_sync("a") as span:
        pass
    assert host_syncs() == n + 1 and span is NULL_SPAN
    tracer = Tracer()
    with tracing(tracer), host_sync("b"):
        pass
    assert host_syncs() == n + 2
    (entry,) = tracer.log.snapshot()
    assert entry["name"] == "sync" and entry["args"] == {"site": "b"}


def test_host_sync_count_loses_no_update_across_threads():
    """Eight threads, more than the cores, count at once with a short
    switch interval: the count rises by every call."""
    import sys

    threads, each = 8, 5000
    n, interval = host_syncs(), sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def count():
            for _ in range(each):
                with host_sync("stress"):
                    pass

        workers = [threading.Thread(target=count) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert host_syncs() - n == threads * each


def _ws_fns(backend):
    """The serve and learner cells of websearch-rl at their reduced
    sizes on ``backend``, and their reduced config."""
    from repro_torch.configs.websearch_rl import model_cfg
    from repro_torch.launch.steps import build_cell

    cfg = dataclasses.replace(model_cfg(True), backend=backend)
    serve, learn = (build_cell("websearch-rl", shape, reduced=True,
                               cfg_override=cfg).fn
                    for shape in ("serve_queries", "rl_rollout"))
    return serve, learn, cfg


def _ws_inputs(cfg, seed=0, batch=8):
    """Seeded inputs of both cells: (q, bins, occ, scores, tp) and the
    learner's production rewards and ε-greedy draws."""
    from repro_torch.core.state_bins import StateBins
    from repro_torch.index.builder import MAX_QUERY_TERMS
    from repro_torch.index.corpus import N_FIELDS

    g = torch.Generator().manual_seed(seed)
    w, n_act = cfg.block_docs // 32, cfg.k_rules + 2
    shape = (batch, cfg.n_blocks, MAX_QUERY_TERMS, N_FIELDS, w)
    words = [torch.randint(0, 2**31 - 1, shape, generator=g, dtype=torch.int32)
             for _ in range(3)]
    occ = words[0] & words[1] & words[2]            # an eighth of the bits
    scores = torch.rand((batch, cfg.n_blocks * cfg.block_docs), generator=g)
    terms = torch.randint(2, MAX_QUERY_TERMS + 1, (batch, 1), generator=g)
    tp = torch.arange(MAX_QUERY_TERMS)[None, :] < terms
    q = torch.rand((cfg.p_bins, n_act), generator=g)
    pu = int(cfg.p_bins ** 0.5)
    bins = StateBins(torch.linspace(1.0, cfg.u_budget, pu - 1),
                     torch.linspace(1.0, 400.0, pu - 1).repeat(pu, 1))
    prod = 0.01 * torch.rand((batch, cfg.t_max), generator=g)
    draws = (torch.randint(0, n_act, (cfg.t_max, batch), generator=g,
                           dtype=torch.int32),
             torch.rand((cfg.t_max, batch), generator=g))
    return (q, bins, occ, scores, tp), prod, draws


@pytest.mark.parametrize("backend", BACKENDS)
def test_tracing_changes_no_output(backend):
    """A serve call's (cand, u, cand_cnt) and a learner step's Q and
    metrics are bit-equal with tracing off and on."""
    serve, learn, cfg = _ws_fns(backend)
    args, prod, draws = _ws_inputs(cfg)
    plain = serve(*args), learn(*args, prod, draws)
    with tracing(Tracer()):
        traced = serve(*args), learn(*args, prod, draws)
    for got, want in zip(traced[0], plain[0]):
        assert torch.equal(got, want)
    assert torch.equal(traced[1][0], plain[1][0])
    for k, want in plain[1][1].items():
        assert torch.equal(traced[1][1][k], want), k


@pytest.mark.parametrize("traced", (False, True), ids=("off", "on"))
@pytest.mark.parametrize("backend", BACKENDS)
def test_host_syncs_of_a_call_are_t_max_plus_its_chunk_rounds(
        backend, traced, monkeypatch):
    """Every rule execution reads its condition once more than it runs
    chunk rounds, an agent step one rule execution: a serve call makes
    t_max + rounds reads, a learner step TD_READS more."""
    from repro_torch.core import scan_backends

    rounds, apply_chunk = [0], scan_backends._apply_chunk

    def counted(*args):
        rounds[0] += 1
        return apply_chunk(*args)

    monkeypatch.setattr(scan_backends, "_apply_chunk", counted)
    serve, learn, cfg = _ws_fns(backend)
    args, prod, draws = _ws_inputs(cfg, seed=1)
    for fn, extra, reads in ((serve, (), 0), (learn, (prod, draws), TD_READS)):
        rounds[0], n = 0, host_syncs()
        with tracing(Tracer()) if traced else contextlib.nullcontext():
            fn(*args, *extra)
        assert rounds[0] > 0
        assert host_syncs() - n == cfg.t_max + rounds[0] + reads


def _children(entries, parent, name=None):
    return [e for e in entries if e["parent"] == parent["id"]
            and (name is None or e["name"] == name)]


@pytest.mark.parametrize("backend", BACKENDS)
def test_span_tree_of_a_serve_call(backend):
    """One rollout of t_max steps, each an act, a rule and a reward; a
    chunk span a round under its rule, the rounds on the rule's args;
    a sync span for every counted read, each under a rule."""
    serve, _, cfg = _ws_fns(backend)
    args, _, _ = _ws_inputs(cfg, seed=2)
    tracer, n = Tracer(), host_syncs()
    with tracing(tracer):
        serve(*args)
    n = host_syncs() - n
    entries = tracer.log.snapshot()
    by_id = {e["id"]: e for e in entries}
    (rollout,) = [e for e in entries if e["name"] == "rollout"]
    assert rollout["parent"] is None
    assert rollout["args"] == {"batch": 8, "t_max": cfg.t_max,
                               "backend": backend}
    steps = _children(entries, rollout, "step")
    assert [s["args"]["t"] for s in steps] == list(range(cfg.t_max))
    assert [e["name"] for e in _children(entries, rollout)].count("stack") == 1
    rules = []
    for step in steps:
        kids = sorted(e["name"] for e in _children(entries, step))
        assert kids == ["act", "reward", "rule"]
        rules += _children(entries, step, "rule")
    chunks = [e for e in entries if e["name"] == "chunk"]
    assert all(by_id[c["parent"]]["name"] == "rule" for c in chunks)
    assert len(chunks) == sum(r["args"]["rounds"] for r in rules)
    assert {r["args"]["chunk"] for r in rules} == {
        1 if backend == "reference" else 4}
    syncs = [e for e in entries if e["name"] == "sync"]
    assert len(syncs) == n == cfg.t_max + len(chunks)
    assert all(by_id[s["parent"]]["name"] == "rule" for s in syncs)
    assert {s["args"]["site"] for s in syncs} == {"cond_any"}
    for e in entries:                       # children lie inside parents
        if e["parent"] is not None:
            p = by_id[e["parent"]]
            assert p["t0"] <= e["t0"] <= e["t1"] <= p["t1"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_span_tree_of_a_learner_step(backend):
    """A train_batch holding the rollout, the td_update with its four
    reads and the metrics."""
    _, learn, cfg = _ws_fns(backend)
    args, prod, draws = _ws_inputs(cfg, seed=3)
    tracer = Tracer()
    with tracing(tracer):
        learn(*args, prod, draws)
    entries = tracer.log.snapshot()
    (step,) = [e for e in entries if e["name"] == "train_batch"]
    assert step["parent"] is None and step["args"] == {"batch": 8}
    assert [e["name"] for e in _children(entries, step)] == [
        "rollout", "td_update", "metrics"]
    (td,) = _children(entries, step, "td_update")
    assert [e["args"]["site"] for e in _children(entries, td, "sync")] == [
        "valid_cells", "valid_td", "unique_cells", "cell_width"]


def test_adaptive_chunk_reads_are_counted():
    from repro_torch.core.scan_backends import adaptive_chunk_blocks

    n = host_syncs()
    assert adaptive_chunk_blocks(16, torch.tensor([8, 4]), torch.tensor(
        [2, 1]), 512) == 4
    assert host_syncs() - n == 2
