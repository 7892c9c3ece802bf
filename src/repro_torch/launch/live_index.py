"""Live-index serving CLI: serve, mutate, merge — all at once (the
port of the reference's ``launch/live_index.py``).

Builds a `LiveRetrievalSystem` (tiered live index: mmap base + delta
segments), serves a freshness workload through a `ReplicaSet` (thread
backend) while a `MergeDaemon` compacts delta segments into new base
generations in the background, and checks the subsystem's contracts
along the way.  Runs on ``--device`` (``cuda`` unless asked; it raises
without CUDA)::

    PYTHONPATH=src python -m repro_torch.launch.live_index --replicas 2 \\
        --ticks 6 --backend reference

``--smoke`` is the gate: tiny sizes, and hard assertions that across
>= 2 epoch swaps under load (a) every submitted query completed with a
response — zero dropped, zero sheds of any kind, (b) >= 2 merges ran
(new base generations) while serving, (c) responses span >= 2 distinct
index epochs, (d) the parity harness is green — the live (base +
delta) view is bit-identical to a from-scratch rebuild at every
recorded epoch, on both scan backends — and (e) the merged base is
mmapped.  A replica turns any exception into a Shed with the reason
``replica_error:<type>`` and keeps serving, and the merge daemon keeps
its exception in ``last_error``, so a fault could read as load or pass
unseen: the smoke also fails on any ``replica_error`` shed, on a
``MergeDaemon.last_error``, and, on CUDA, if the rule kernel (a rule
execution a launch) did not launch.  Output goes to ``results/live_index_torch.json`` by default,
so that it never overwrites the reference's.
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--ticks", type=int, default=6,
                    help="freshness ticks (each adds docs + an epoch)")
    ap.add_argument("--docs-per-tick", type=int, default=16)
    ap.add_argument("--wave", type=int, default=48,
                    help="queries submitted per tick")
    ap.add_argument("--backend", default="block_scan",
                    help="index-scan backend for serving rollouts")
    ap.add_argument("--n-docs", type=int, default=4096)
    ap.add_argument("--n-queries", type=int, default=400)
    ap.add_argument("--capacity-mult", type=float, default=2.0,
                    help="index capacity as a multiple of the seed corpus")
    ap.add_argument("--merge-min-docs", type=int, default=24,
                    help="delta docs before the daemon compacts")
    ap.add_argument("--storage-dir", default=None,
                    help="base-generation directory (default: a tempdir; "
                         "generations are mmapped from here)")
    ap.add_argument("--staleness-bound", type=int, default=64)
    ap.add_argument("--parity-queries", type=int, default=6,
                    help="queries sampled per epoch for the parity check")
    ap.add_argument("--min-bucket", type=int, default=8)
    ap.add_argument("--max-bucket", type=int, default=32)
    ap.add_argument("--cache", type=int, default=512)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default="results/live_index_torch.json")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace-event JSON of the run")
    ap.add_argument("--metrics-json", default=None,
                    help="write the merged fleet+index metrics snapshot")
    ap.add_argument("--smoke", action="store_true",
                    help="gate: tiny sizes + zero-dropped + parity "
                         "assertions across >= 2 epoch swaps")
    args = ap.parse_args(argv)

    if args.smoke:
        args.replicas = 2
        args.n_docs, args.n_queries = 2048, 200
        args.ticks, args.docs_per_tick, args.wave = 4, 16, 32
        args.merge_min_docs = 24

    from repro_torch.cluster import ClusterConfig, ReplicaSet, Shed
    from repro_torch.data.freshness import FreshnessConfig, FreshnessWorkload
    from repro_torch.data.querylog import QueryLogConfig
    from repro_torch.index.corpus import CorpusConfig
    from repro_torch.index.live import (LiveRetrievalSystem, MergeConfig,
                                        MergeDaemon, check_epoch_parity)
    from repro_torch.index.live.live_index import MERGE_MS_EDGES
    from repro_torch.kernels.block_scan import BLOCK_SCAN_RULE_KERNEL
    from repro_torch.obs import NULL_TRACER, Tracer, merge_snapshots
    from repro_torch.policies import PolicyStore
    from repro_torch.serving import EngineConfig
    from repro_torch.system import SystemConfig

    tracer = Tracer() if args.trace_out else NULL_TRACER
    tmp = None
    if args.storage_dir is None:
        tmp = tempfile.TemporaryDirectory(prefix="live-index-")
        args.storage_dir = tmp.name

    t_build = time.time()
    sys_ = LiveRetrievalSystem(SystemConfig(
        corpus=CorpusConfig(n_docs=args.n_docs, vocab_size=1024, seed=0),
        querylog=QueryLogConfig(n_queries=args.n_queries, seed=0),
        block_docs=256, p_bins=512, u_budget=1024,
        l1_steps=80 if args.smoke else 150,
        backend=args.backend,
    ), capacity_docs=int(args.capacity_mult * args.n_docs),
       storage_dir=args.storage_dir,
       staleness_bound=args.staleness_bound, tracer=tracer,
       device=args.device)
    sys_.fit_l1(n_queries=96)
    sys_.fit_state_bins(n_queries=64)
    live = sys_.live
    print(f"[build] {args.n_docs} docs / {sys_.log.n_queries} queries, "
          f"capacity {live.capacity_docs} docs "
          f"({live.capacity_blocks} blocks), base gen 0 "
          f"{'mmapped' if live.stats()['base_mmapped'] else 'in-memory'} "
          f"on {sys_.device} ({time.time() - t_build:.1f}s)")

    # Baseline production-plan policies: this CLI exercises the
    # index plane, not training — the plans are fixed, the INDEX moves.
    store = PolicyStore(staleness_bound=1)
    store.publish(sys_.baseline_policies(), fallbacks=sys_.fallback_policies())

    # Record every epoch publish for the post-run parity sweep.
    epochs_seen = []
    unsubscribe = live.store.subscribe(epochs_seen.append)

    workload = FreshnessWorkload(sys_, FreshnessConfig(
        docs_per_tick=args.docs_per_tick, wave_queries=args.wave, seed=0))
    cluster = ReplicaSet(sys_, store,
                         ClusterConfig(n_replicas=args.replicas),
                         EngineConfig(min_bucket=args.min_bucket,
                                      max_bucket=args.max_bucket,
                                      cache_capacity=args.cache,
                                      backend=args.backend),
                         tracer=tracer)
    cluster.warmup()
    BLOCK_SCAN_RULE_KERNEL.launches = 0   # count the run, not the warmup

    results, t0 = [], time.time()
    daemon = MergeDaemon(live, MergeConfig(
        min_delta_docs=args.merge_min_docs, poll_interval_s=0.02))
    with cluster, daemon:
        for tick in range(args.ticks):
            wave = workload.tick()          # docs + queries + epoch commit
            daemon.trigger()
            results.extend(cluster.serve(wave))
        # settle: let the daemon compact the final delta, then serve a
        # last wave against the merged head
        t_settle = time.time()
        while (live.delta_docs >= args.merge_min_docs
               and daemon.last_error is None
               and time.time() - t_settle < 30):
            time.sleep(0.02)
        results.extend(cluster.serve(workload.wave()))
    if daemon.last_error is not None:
        raise daemon.last_error
    wall = time.time() - t0
    chunk_launches = BLOCK_SCAN_RULE_KERNEL.launches
    unsubscribe()

    stats = cluster.stats()
    istats = live.stats()
    n_shed = sum(isinstance(r, Shed) for r in results)
    error_sheds = [r for r in results if isinstance(r, Shed)
                   and r.reason.startswith("replica_error")]
    resp_epochs = sorted({r.index_epoch for r in results
                          if not isinstance(r, Shed)})
    fresh_hits = [r for r in results if not isinstance(r, Shed)
                  and r.qid >= args.n_queries]

    # Parity sweep: live view vs from-scratch rebuild at every recorded
    # epoch, on both scan backends.
    rng = np.random.default_rng(1)
    parity = []
    for ep in epochs_seen:
        qids = rng.choice(sys_.log.n_queries, size=args.parity_queries,
                          replace=False)
        parity.append(check_epoch_parity(sys_, ep, qids))
    print(f"[parity] {len(parity)} epochs green "
          f"(v{epochs_seen[0].version}..v{epochs_seen[-1].version}, "
          f"both backends)")

    out = {
        "device": str(sys_.device),
        "wall_s": wall,
        "qps": len(results) / wall,
        "ticks": workload.ticks,
        "docs_added": istats["docs_added"],
        "commits": istats["commits"],
        "merges": istats["merges"],
        "generation": istats["generation"],
        "epoch_head": istats["epoch"],
        "response_epochs": resp_epochs,
        "epoch_swaps_total": sum(r.engine.summary()["index_epoch_swaps"]
                                 for r in cluster.replicas),
        "n_results": len(results),
        "n_shed": n_shed,
        "n_replica_error_sheds": len(error_sheds),
        "n_fresh_responses": len(fresh_hits),
        "block_scan_launches": chunk_launches,
        "merge_ms": live.registry.histogram(
            "index.merge_ms", MERGE_MS_EDGES).snapshot(),
        "bytes_per_query_base": istats["bytes_per_query_base"],
        "bytes_per_query_delta": istats["bytes_per_query_delta"],
        "parity": parity,
        "cluster": stats,
    }
    print(f"[serve] {len(results)} results ({out['qps']:.1f} qps), "
          f"{n_shed} shed, {istats['merges']} merges -> gen "
          f"{istats['generation']}, epochs served {resp_epochs}, "
          f"epoch_lag_max={stats['epoch_lag_observed_max']}, "
          f"block_scan launches {chunk_launches}")

    if args.smoke:
        # Hazards first: a fault must not read as load.
        if error_sheds:
            raise AssertionError(f"replicas shed for errors: {error_sheds[:3]}")
        if sys_.device.type == "cuda" and chunk_launches <= 0:
            raise AssertionError("the fleet launched no block_scan kernel")
        if stats["n_submitted"] != stats["n_responses"] + stats["n_shed"]:
            raise AssertionError("dropped queries: submitted != responses + shed")
        if n_shed or stats["n_shed"]:
            raise AssertionError(f"{n_shed} queries shed while the index "
                                 "mutated (must be zero)")
        if istats["merges"] < 2:
            raise AssertionError(f"expected >= 2 background merges, got "
                                 f"{istats['merges']}")
        if istats["generation"] < 2:
            raise AssertionError(f"expected >= 2 base generations, got "
                                 f"{istats['generation']}")
        if len(resp_epochs) < 2:
            raise AssertionError(f"responses must span >= 2 index epochs, "
                                 f"saw {resp_epochs}")
        if not fresh_hits:
            raise AssertionError("no fresh-query responses: appended "
                                 "queries never served")
        if not all(p["ok"] for p in parity):
            raise AssertionError("parity sweep failed")
        if not istats["base_mmapped"]:
            raise AssertionError("merged base generations must mmap")
        print(f"[smoke] OK: zero dropped/shed across "
              f"{len(resp_epochs)} epochs, {istats['merges']} merges, "
              f"parity green at {len(parity)} epochs on both backends, "
              f"no replica_error shed, no merge error")

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1, default=str))

    if args.trace_out:
        tracer.log.write_chrome(args.trace_out,
                                process_name="repro_torch-live-index")
        print(f"[trace] {len(tracer.log)} events -> {args.trace_out}")
    if args.metrics_json:
        p = Path(args.metrics_json)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(merge_snapshots(
            [cluster.metrics_snapshot(), live.registry.snapshot()]),
            indent=1))
        print(f"[metrics] fleet+index snapshot -> {args.metrics_json}")
    if tmp is not None:
        tmp.cleanup()


if __name__ == "__main__":
    main()
