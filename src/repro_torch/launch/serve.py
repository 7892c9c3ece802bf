"""Serving driver: a thin CLI over `repro_torch.serving.ServeEngine`
(the port of the reference's ``launch/serve.py``).

Trains the L0 policies + L1 ranker inline, then streams query batches
through the online engine — admission → result cache → shape-bucketed
micro-batching → prepared per-shard serve step → L1 prune — with
latency accounting both in wall time and in index blocks (u), the unit
the paper shows is linear in machine time.  Runs on ``--device``
(``cuda`` unless asked; it raises without CUDA)::

    PYTHONPATH=src python -m repro_torch.launch.serve --batches 4 --batch 64

Output has the reference's schema (one JSON row per batch with
t_inputs_s / t_serve_s / mean_u / p99_u / qps_host and the engine
fields, and the engine summary beside it) under its own names,
``results/serve_torch.json`` and ``results/serve_torch_summary.json``,
so that it never overwrites the reference's outputs.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-docs", type=int, default=8192)
    ap.add_argument("--n-queries", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--iters", type=int, default=120)
    ap.add_argument("--out", default="results/serve_torch.json")
    ap.add_argument("--min-bucket", type=int, default=8)
    ap.add_argument("--max-bucket", type=int, default=64)
    ap.add_argument("--cache", type=int, default=4096,
                    help="result-cache capacity (0 disables)")
    ap.add_argument("--shards", type=int, default=1,
                    help="logical index shards for scatter-gather serving")
    ap.add_argument("--backend", default="block_scan",
                    help="index-scan backend of every rollout "
                         "(repro_torch.core.scan_backends.available_backends)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace-event JSON (Perfetto-"
                         "loadable) of the serving run to this path")
    ap.add_argument("--metrics-json", default=None,
                    help="write the engine's metrics-registry snapshot "
                         "to this path")
    args = ap.parse_args(argv)

    from repro_torch.data.querylog import CAT1, CAT2, QueryLogConfig
    from repro_torch.index.corpus import CorpusConfig
    from repro_torch.obs import NULL_TRACER, Tracer
    from repro_torch.serving import EngineConfig, ServeEngine
    from repro_torch.system import RetrievalSystem, SystemConfig

    tracer = Tracer() if args.trace_out else NULL_TRACER

    sys_ = RetrievalSystem(SystemConfig(
        corpus=CorpusConfig(n_docs=args.n_docs, vocab_size=2048, seed=0),
        querylog=QueryLogConfig(n_queries=args.n_queries, seed=0),
        block_docs=256, p_bins=1024, u_budget=1024, l1_steps=250,
        backend=args.backend,
    ), device=args.device)
    sys_.fit_l1(n_queries=128)
    sys_.fit_state_bins(n_queries=96)
    # Trained tabular policies published as snapshot v1 of a PolicyStore;
    # the engine pins the snapshot and would pick up any later publish.
    store = sys_.train_policy_store(cats=(CAT1, CAT2),
                                    iters=args.iters, batch=48)

    engine = ServeEngine(sys_, store, EngineConfig(
        min_bucket=args.min_bucket, max_bucket=args.max_bucket,
        cache_capacity=args.cache, n_shards=args.shards), tracer=tracer)
    n_compiles_warm = engine.warmup()
    print(f"warmup: {n_compiles_warm} bucket serve steps prepared on "
          f"{sys_.device} (policy snapshot v{engine.policy_version})")

    stats = []
    rng = np.random.default_rng(0)
    for bi in range(args.batches):
        qids = rng.integers(0, sys_.log.n_queries, size=args.batch)
        t0 = time.time()
        rids = [engine.submit(int(q)) for q in qids]
        t_inputs = time.time() - t0          # admission + cache lookups
        t0 = time.time()
        engine.flush()
        t_serve = time.time() - t0
        res = [engine.take_response(r) for r in rids]

        u_all = np.array([r.u for r in res], np.float64)
        lat = np.array([r.latency_s for r in res], np.float64)
        stats.append({
            "batch": bi, "t_inputs_s": t_inputs, "t_serve_s": t_serve,
            "mean_u": float(u_all.mean()),
            "p99_u": float(np.quantile(u_all, 0.99)),
            "qps_host": args.batch / (t_inputs + t_serve),
            "n_cached": sum(r.cached for r in res),
            "latency_p50_ms": float(np.quantile(lat, 0.50)) * 1e3,
            "latency_p99_ms": float(np.quantile(lat, 0.99)) * 1e3,
            "compiles_cum": engine.compile_count,
        })
        print(stats[-1])

    summary = engine.summary()
    print("engine summary:", json.dumps(summary, indent=1))

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(stats, indent=1))
    out.with_name(out.stem + "_summary.json").write_text(
        json.dumps(summary, indent=1))
    if args.trace_out:
        tracer.log.write_chrome(args.trace_out,
                                process_name="repro_torch-serve")
        print(f"trace: {len(tracer.log)} events -> {args.trace_out} "
              f"(open at ui.perfetto.dev)")
    if args.metrics_json:
        p = Path(args.metrics_json)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(engine.telemetry.registry.snapshot(),
                                indent=1))
        print(f"metrics: registry snapshot -> {args.metrics_json}")


if __name__ == "__main__":
    main()
