"""Online-learning cluster driver: trainer-fed replica set CLI (the port
of the reference's ``launch/cluster.py``).

Builds the retrieval system, starts a `TrainerLoop` that trains from
the cluster's served-traffic tap and publishes policy snapshots (live
+ SHALLOW fallbacks) into a shared `PolicyStore`, and serves a random
query stream through a `ReplicaSet` (queue-aware routing + the
pressure-tiered admission ladder) while training runs — the paper's
serve-while-training deployment in one process.  Runs on ``--device``
(``cuda`` unless asked; it raises without CUDA)::

    PYTHONPATH=src python -m repro_torch.launch.cluster --replicas 2 \\
        --publish-every 10

``--smoke`` is the gate: tiny corpus, 2 replicas, 2 publish cycles,
a hard assertion that every submitted query completed with either a
response or an explicit Shed (zero dropped), that the trainer consumed
ONLY the served-traffic tap, and — under a moderate burst against a
finite u budget — that the ladder degraded (some SHALLOW) without a
single hard SHED.  A replica turns any exception into a Shed with the
reason ``replica_error:<type>`` and keeps serving, so a failing kernel
would pass those checks as load; the smoke therefore also asserts that
no such shed occurred, that no wave at the infinite budget shed at
all, that the trainer raised nothing, and, on CUDA, that the chunk
kernel launched.

``--replica-backend process --smoke`` is the process-cell gate: a LIVE
system serves through worker processes (each builds on ``--device``)
while documents commit (two index epochs) and the trainer publishes
(three policy versions) mid-stream; asserts zero dropped tickets, that
every worker applied >= 3 policy versions and >= 2 index epochs (via
its control-channel acks), that no worker restarted, on CUDA that the
chunk kernel launched inside the workers, and — from
/proc/<pid>/smaps — that the workers' mappings of the cell's files
hold ZERO private-dirty pages and, where the host's smaps divides
shared pages among their mappers (a probe tells), that their summed Pss
is at most 0.75 of their summed Rss: the fleet shares ONE physical copy
of the base generation.  The cell dir is a temporary directory,
removed at the end.  Output goes to ``results/cluster_torch.json`` by
default, so that it never overwrites the reference's.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np


def _cell_mapping_stats(pids, cell_roots) -> dict:
    """Per-worker Rss/Pss/Private_Dirty (kB) of every mapping under the
    process cell's storage dirs (a path or a sequence of them), straight
    from /proc/<pid>/smaps."""
    roots = ((cell_roots,) if isinstance(cell_roots, (str, Path))
             else tuple(cell_roots))
    roots = tuple(str(r) for r in roots)
    per_worker = []
    for pid in pids:
        rss = pss = private = 0
        n_maps = 0
        in_cell = False
        try:
            with open(f"/proc/{pid}/smaps") as fh:
                for line in fh:
                    fields = line.split()
                    if line[0] != ' ' and '-' in fields[0]:  # mapping header
                        in_cell = len(fields) >= 6 and \
                            fields[-1].startswith(roots)
                        n_maps += in_cell
                    elif in_cell and fields[0] in ("Rss:", "Pss:",
                                                   "Private_Dirty:"):
                        kb = int(fields[1])
                        if fields[0] == "Rss:":
                            rss += kb
                        elif fields[0] == "Pss:":
                            pss += kb
                        else:
                            private += kb
        except OSError:
            continue
        per_worker.append({"pid": pid, "n_mappings": n_maps,
                           "rss_kb": rss, "pss_kb": pss,
                           "private_dirty_kb": private})
    return {"workers": per_worker,
            "rss_kb_total": sum(w["rss_kb"] for w in per_worker),
            "pss_kb_total": sum(w["pss_kb"] for w in per_worker),
            "private_dirty_kb_total": sum(w["private_dirty_kb"]
                                          for w in per_worker)}


_SMAPS_PROBE = ("import mmap, sys\n"
                "f = open(sys.argv[1], 'rb')\n"
                "m = mmap.mmap(f.fileno(), 0, prot=mmap.PROT_READ)\n"
                "m[0]\n"
                "print(1, flush=True)\n"
                "sys.stdin.read()\n")


def _smaps_counts_sharing(dir_path) -> bool:
    """Whether this host's /proc/<pid>/smaps shows a page that two
    processes map as shared (their Pss below their Rss): two probe
    processes map one page of a file in ``dir_path``.  A Linux kernel's
    does; a user-space kernel (as some container runtimes use) may
    report Pss = Rss for every mapping, and then the Pss test of
    physical sharing cannot be made there."""
    path = Path(dir_path) / "smaps-probe.bin"
    path.write_bytes(b"\0" * 4096)
    procs = [subprocess.Popen([sys.executable, "-c", _SMAPS_PROBE, str(path)],
                              stdin=subprocess.PIPE, stdout=subprocess.PIPE)
             for _ in range(2)]
    try:
        for p in procs:
            p.stdout.readline()
        stats = _cell_mapping_stats([p.pid for p in procs], str(path))
        return 0 < stats["pss_kb_total"] < stats["rss_kb_total"]
    finally:
        for p in procs:
            p.stdin.close()
            p.wait(timeout=30)
        path.unlink()


def _rand_doc(rng, vocab: int):
    return [np.unique(rng.integers(0, vocab, size=k)).astype(np.int32)
            for k in (1, 2, 8, 3)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--publish-every", type=int, default=10,
                    help="training epochs between snapshot publishes")
    ap.add_argument("--iters", type=int, default=30,
                    help="total training epochs")
    ap.add_argument("--train-batch", type=int, default=32)
    ap.add_argument("--backend", default="block_scan",
                    help="index-scan backend (training AND serving)")
    ap.add_argument("--replica-backend", default="thread",
                    choices=["thread", "process"],
                    help="replica execution: in-process threads (default) "
                         "or worker processes over shm rings + one mmap-"
                         "shared index")
    ap.add_argument("--routing", default="queue_aware",
                    choices=["queue_aware", "round_robin"])
    ap.add_argument("--staleness-bound", type=int, default=2)
    ap.add_argument("--u-budget-inflight", type=float, default=float("inf"),
                    help="fleet admission budget in u (inf disables "
                         "degradation/shedding)")
    ap.add_argument("--no-ladder", action="store_true",
                    help="binary admit/shed instead of the FULL/SHALLOW/"
                         "CACHED_ONLY/SHED service ladder")
    ap.add_argument("--n-docs", type=int, default=4096)
    ap.add_argument("--n-queries", type=int, default=400)
    ap.add_argument("--batch", type=int, default=24,
                    help="queries per serving wave")
    ap.add_argument("--min-bucket", type=int, default=8)
    ap.add_argument("--max-bucket", type=int, default=32)
    ap.add_argument("--cache", type=int, default=512)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default="results/cluster_torch.json")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace-event JSON (Perfetto-"
                         "loadable) of the whole run to this path")
    ap.add_argument("--metrics-json", default=None,
                    help="write the merged fleet metrics snapshot "
                         "(counters/gauges/per-(level,category) "
                         "histograms) to this path")
    ap.add_argument("--statusz-out", default=None,
                    help="write the cell's statusz introspection JSON "
                         "(head versions, per-worker health/watchdog "
                         "verdicts, ring stats) to this path")
    ap.add_argument("--slo-target", type=float, default=None,
                    help="enable the read-only SLO burn-rate monitor at "
                         "this availability target (e.g. 0.999); the "
                         "verdict lands in the output JSON under 'slo'")
    ap.add_argument("--slo-latency-ms", type=float, default=50.0,
                    help="latency threshold for the SLO's goodness "
                         "criterion (snapped up to a histogram edge)")
    ap.add_argument("--smoke", action="store_true",
                    help="gate: tiny sizes + zero-dropped assertion")
    args = ap.parse_args(argv)

    proc = args.replica_backend == "process"
    if args.smoke:
        args.replicas = 2
        args.n_docs, args.n_queries = 2048, 200
        args.iters, args.publish_every = 8, 4      # exactly 2 publish cycles
        args.train_batch, args.batch = 16, 16
        if proc:
            # the process gate also exercises index-epoch relays, so it
            # trims sizes further — worker spawn dominates
            args.n_docs, args.n_queries = 1024, 128

    from repro_torch.device import resolve_device

    # Raises without CUDA, before anything is built or spawned.
    device = resolve_device(args.device)
    cell_tmp = (tempfile.TemporaryDirectory(prefix="repro_torch-proc-cell-")
                if proc else None)

    from repro_torch.cluster import (ClusterConfig, ReplicaSet, ServiceLevel,
                                     Shed, TrainerConfig, TrainerLoop)
    from repro_torch.data.querylog import CAT1, CAT2, QueryLogConfig
    from repro_torch.index.corpus import CorpusConfig
    from repro_torch.kernels.block_scan import BLOCK_SCAN_KERNEL
    from repro_torch.obs import NULL_TRACER, SLOConfig, SLOMonitor, Tracer
    from repro_torch.policies import PolicyStore
    from repro_torch.serving import EngineConfig
    from repro_torch.system import RetrievalSystem, SystemConfig

    tracer = Tracer() if args.trace_out else NULL_TRACER

    t_build = time.time()
    sys_cfg = SystemConfig(
        corpus=CorpusConfig(n_docs=args.n_docs, vocab_size=1024, seed=0),
        querylog=QueryLogConfig(n_queries=args.n_queries, seed=0),
        block_docs=256, p_bins=512, u_budget=1024,
        l1_steps=150 if not args.smoke else 80,
        backend=args.backend,
    )
    if proc:
        # live system so the smoke can commit documents mid-stream and
        # prove epoch relays land inside the worker processes
        from repro_torch.index.live import LiveRetrievalSystem
        sys_ = LiveRetrievalSystem(sys_cfg, capacity_docs=args.n_docs + 512,
                                   device=device)
    else:
        sys_ = RetrievalSystem(sys_cfg, device=device)
    sys_.fit_l1(n_queries=96)
    sys_.fit_state_bins(n_queries=64)
    print(f"[build] {sys_.index.n_docs} docs / {sys_.log.n_queries} queries "
          f"/ {sys_.index.n_blocks} blocks on {sys_.device} "
          f"({time.time() - t_build:.1f}s)")

    shallow_caps = {cat: sys_.shallow_u_cap(cat) for cat in (CAT1, CAT2)}
    store = PolicyStore(staleness_bound=args.staleness_bound)
    trainer = TrainerLoop(sys_, store, cfg=TrainerConfig(
        iters=args.iters, publish_every=args.publish_every,
        batch=args.train_batch, publish_initial=False,
        # promotion gate probes a held-out slice of served traffic once
        # the tap holdout fills (falls back to the log slice before)
        probe_from_tap=True), tracer=tracer)
    trainer.publish_now()                 # v1 up before replicas construct
    cluster = ReplicaSet(sys_, store, ClusterConfig(
        n_replicas=args.replicas, routing=args.routing,
        backend=args.replica_backend,
        proc_storage_dir=cell_tmp.name if proc else None,
        u_inflight_budget=args.u_budget_inflight,
        ladder=not args.no_ladder,
        tap_holdout_every=4,              # eval holdout for the gate
        # keep the cold SHALLOW estimate inside its provable cap, so a
        # degraded admission can never be priced above what it can cost
        prior_shallow_u=float(min(shallow_caps.values()))),
        EngineConfig(min_bucket=args.min_bucket, max_bucket=args.max_bucket,
                     cache_capacity=args.cache, backend=args.backend),
        tracer=tracer)
    trainer.source = cluster.tap          # train on served traffic only
    cluster.warmup()
    BLOCK_SCAN_KERNEL.launches = 0        # count the run, not the warmup

    slo_mon = None
    if args.slo_target is not None:
        # Read-only: observes fleet snapshots between waves, publishes
        # slo.* gauges into the cluster registry, never touches admission.
        slo_mon = SLOMonitor(
            SLOConfig(target=args.slo_target,
                      latency_slo_ms=args.slo_latency_ms),
            registry=cluster.registry)

    rng = np.random.default_rng(0)
    results, t0 = [], time.time()
    burst_results, burst_tickets = [], []
    trainer_error = None
    with cluster:
        if proc:
            # the workers warm up right after their spawn; their counts
            # start here (the reset is answered after the warmup)
            cluster.kernel_launches(reset=True)
        trainer.start()
        waves = 0
        while trainer.alive or waves < (3 if proc else 1):
            qids = rng.integers(0, sys_.log.n_queries, size=args.batch)
            results.extend(cluster.serve(qids))
            waves += 1
            if slo_mon is not None:
                slo_mon.observe(cluster.metrics_snapshot())
            if proc and waves in (1, 2):
                # two commits mid-stream -> two index epochs the cell
                # must relay into every worker over its control pipe
                sys_.add_documents([_rand_doc(rng, 1024) for _ in range(4)])
                sys_.commit_index()
        try:
            trainer.join()
        except Exception as e:            # noqa: BLE001 — asserted below
            trainer_error = e
            if not args.smoke:
                raise
        # final wave on the last published version (and, on the process
        # backend, the last committed epoch)
        results.extend(cluster.serve(
            rng.integers(0, sys_.log.n_queries, size=args.batch)))
        waves += 1
        if slo_mon is not None:
            slo_mon.observe(cluster.metrics_snapshot())

        if args.statusz_out:
            # Written while the replicas are alive: statusz reads
            # ring-header heartbeats and process liveness.
            p = Path(args.statusz_out)
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(json.dumps(cluster.statusz(), indent=1,
                                    default=str))
            print(f"[statusz] cell status -> {args.statusz_out}")

        proc_stats = None
        if proc:
            # relays are async — wait for every worker to ack the head
            # epoch and policy version before asserting on them
            head_epoch = sys_.index_epoch
            head_version = store.version
            deadline = time.time() + 60.0
            while time.time() < deadline:
                st = cluster.stats()
                lag = cluster.version_lag()
                if (min(st["replica_index_epochs"]) >= head_epoch
                        and min(lag["replica_versions"]) >= head_version):
                    break
                time.sleep(0.1)
            summaries = cluster.stats()["replicas"]
            worker_pids = [s["worker_pid"] for s in summaries]
            proc_stats = {
                "n_cpus": os.cpu_count(),
                "worker_pids": worker_pids,
                "worker_devices": [s.get("device") for s in summaries],
                "worker_restarts": [s["n_restarts"] for s in summaries],
                "spawn_seconds": [r.spawn_seconds for r in cluster.replicas],
                "worker_kernel_launches": cluster.kernel_launches(),
                "head_index_epoch": head_epoch,
                "replica_index_epochs":
                    cluster.stats()["replica_index_epochs"],
                "head_policy_version": head_version,
                "replica_policy_versions":
                    cluster.version_lag()["replica_versions"],
                "cell_dir": cluster.proc_cell_dir,
                "mappings": _cell_mapping_stats(worker_pids,
                                                cluster.proc_cell_dir),
                "smaps_counts_sharing": _smaps_counts_sharing(
                    cluster.proc_cell_dir),
            }

        if args.smoke and not args.no_ladder and not proc:
            # Moderate burst against a finite budget: size the ledger
            # so the FULL rung saturates after a few queries while the
            # SHALLOW rung provably fits the whole burst — the ladder
            # must absorb the pressure with degraded service, zero
            # hard SHEDs.
            burst = 48
            cap = max(shallow_caps.values())
            burst_qids = rng.integers(0, sys_.log.n_queries, size=burst)
            est = cluster.admission.estimator
            est_med = float(np.median([est.estimate(int(q))
                                       for q in burst_qids]))
            budget = max(3 * est_med, sys_.cfg.u_budget) + (burst + 1) * cap
            cluster.admission.u_inflight_budget = budget
            cluster.admission.full_watermark = \
                min(0.5, max(3 * est_med, sys_.cfg.u_budget) / budget)
            burst_tickets = [cluster.submit(int(q)) for q in burst_qids]
            burst_results = [t.result(timeout=120.0) for t in burst_tickets]
    wall = time.time() - t0
    # The serving kernels launch in the workers on the process backend
    # (the parent's count is the trainer's alone there).
    chunk_launches = (proc_stats["worker_kernel_launches"].get(
        BLOCK_SCAN_KERNEL.name, 0) if proc else BLOCK_SCAN_KERNEL.launches)

    stats = cluster.stats()
    n_shed = sum(isinstance(r, Shed) for r in results)
    error_sheds = [r for r in results + burst_results
                   if isinstance(r, Shed) and r.reason.startswith("replica_error")]
    out = {
        "device": str(sys_.device),
        "waves": waves,
        "wall_s": wall,
        "qps": len(results) / wall,
        "versions_published": trainer.versions_published,
        "probe_recall_per_version": [row["probe_recall"]
                                     for row in trainer.history],
        "probe_source_per_version": [row["probe_source"]
                                     for row in trainer.history],
        "n_results": len(results),
        "n_shed": n_shed,
        "n_replica_error_sheds": len(error_sheds),
        "trainer_error": None if trainer_error is None else repr(trainer_error),
        "trainer_tap_batches": trainer.tap_batches,
        "trainer_log_batches": trainer.log_batches,
        "block_scan_launches": chunk_launches,
        "cluster": stats,
    }
    if proc_stats is not None:
        out["proc"] = proc_stats
    if slo_mon is not None:
        out["slo"] = slo_mon.check()
        print(f"[slo] verdict={out['slo']['verdict']} "
              f"burn_fast={out['slo']['burn_fast']:.2f} "
              f"burn_slow={out['slo']['burn_slow']:.2f} "
              f"(target {args.slo_target}, latency <= "
              f"{out['slo']['effective_latency_slo_ms']:g} ms)")
    print(f"[serve] {len(results)} results over {waves} waves "
          f"({out['qps']:.1f} qps), {n_shed} shed, "
          f"versions {trainer.versions_published}, "
          f"version_lag_max={stats['version_lag_observed_max']}, "
          f"tap_batches={trainer.tap_batches}, "
          f"block_scan launches {chunk_launches}")

    if args.smoke:
        # Hazards first: a fault must not read as load.
        if error_sheds:
            raise AssertionError(f"replicas shed for errors: {error_sheds[:3]}")
        if trainer_error is not None:
            raise AssertionError(f"the trainer raised {trainer_error!r}")
        if math.isinf(args.u_budget_inflight) and n_shed:
            raise AssertionError(f"{n_shed} sheds at an infinite budget")
        if sys_.device.type == "cuda" and chunk_launches <= 0:
            raise AssertionError("the cluster launched no block_scan kernel"
                                 + (" in its workers" if proc else ""))
        if len(trainer.versions_published) < 3:
            raise AssertionError(f"expected >= 3 publishes (v1 + 2 cycles), "
                                 f"got {trainer.versions_published}")
        if stats["n_submitted"] != stats["n_responses"] + stats["n_shed"]:
            raise AssertionError("dropped queries: submitted != responses + shed")
        if len(results) + len(burst_results) != stats["n_submitted"]:
            raise AssertionError("lost tickets")
        if stats["version_lag_observed_max"] > args.staleness_bound:
            raise AssertionError("served a snapshot beyond the staleness bound")
        # the trainer consumed the served-traffic tap, never the log
        if not (trainer.tap_batches > 0 and trainer.log_batches == 0):
            raise AssertionError(
                f"trainer must train from served traffic only "
                f"(tap={trainer.tap_batches}, log={trainer.log_batches})")
        if not args.no_ladder and not proc:
            # graceful degradation under the burst: zero hard SHEDs,
            # pressure visibly absorbed by the SHALLOW rung
            hard_sheds = [r for r in burst_results if isinstance(r, Shed)]
            if hard_sheds:
                raise AssertionError(f"ladder hard-shed under a moderate "
                                     f"burst: {hard_sheds[:3]}")
            mix = {l.name: sum(t.level == l for t in burst_tickets)
                   for l in ServiceLevel}
            out["burst_mix"] = mix
            if mix["SHALLOW"] <= 0:
                raise AssertionError(f"expected SHALLOW under burst: {mix}")
            print(f"[smoke] burst mix {mix} (zero hard sheds)")
        if proc:
            ps = out["proc"]
            # >= 3 policy versions applied IN the workers (relayed over
            # the control pipe, acked back)
            if min(ps["replica_policy_versions"]) < 3:
                raise AssertionError(f"workers behind on policy: "
                                     f"{ps['replica_policy_versions']}")
            # >= 2 index epochs beyond the initial one (two mid-stream
            # commits), every worker at the head
            if ps["head_index_epoch"] < 3:
                raise AssertionError(f"head epoch {ps['head_index_epoch']}")
            if min(ps["replica_index_epochs"]) < ps["head_index_epoch"]:
                raise AssertionError(f"workers behind on epochs: "
                                     f"{ps['replica_index_epochs']}")
            if not (len(set(ps["worker_pids"])) == args.replicas
                    and os.getpid() not in ps["worker_pids"]):
                raise AssertionError(f"expected {args.replicas} distinct "
                                     f"worker processes: {ps['worker_pids']}")
            if set(ps["worker_devices"]) != {str(sys_.device)}:
                raise AssertionError(f"workers on {ps['worker_devices']}, "
                                     f"not on {sys_.device}")
            # a crash+respawn mid-run is recovery working, but the gate
            # demands a clean run — worker deaths here are real bugs
            if sum(ps["worker_restarts"]) != 0:
                raise AssertionError(f"workers died during smoke: "
                                     f"{ps['worker_restarts']}")
            # single-mapping proof: every worker mmaps the cell's base
            # generation, and across the fleet those mappings hold ZERO
            # private-dirty pages — nobody copied the index, the page
            # cache holds one physical copy (sum Pss << sum Rss)
            maps = ps["mappings"]
            if not all(w["n_mappings"] > 0 and w["rss_kb"] > 0
                       for w in maps["workers"]):
                raise AssertionError(f"a worker maps no cell file: {maps}")
            if maps["private_dirty_kb_total"] != 0:
                raise AssertionError(
                    f"workers hold private copies of the index: "
                    f"{maps['private_dirty_kb_total']} kB private-dirty")
            # Pss divides each page by its mapper count, so N workers
            # over one physical copy show sum(Pss) ~ sum(Rss)/N — where
            # the host's smaps divides shared pages at all (a probe pair
            # of processes mapping one page tells)
            if (ps["smaps_counts_sharing"]
                    and maps["pss_kb_total"] > 0.75 * maps["rss_kb_total"]):
                raise AssertionError(f"index pages not physically shared: "
                                     f"{maps}")
            print(f"[smoke] proc cell OK: versions "
                  f"{ps['replica_policy_versions']}, epochs "
                  f"{ps['replica_index_epochs']} (head "
                  f"{ps['head_index_epoch']}), workers on "
                  f"{ps['worker_devices']}, spawn s {ps['spawn_seconds']}, "
                  f"index mappings rss={maps['rss_kb_total']}kB "
                  f"pss={maps['pss_kb_total']}kB private_dirty=0 "
                  f"across {len(maps['workers'])} workers "
                  f"({ps['n_cpus']} cpus; "
                  + ("Pss shows the sharing" if ps["smaps_counts_sharing"]
                     else "this host's smaps reports Pss = Rss for every "
                          "shared page, so the Pss test is not made")
                  + ")")
        print("[smoke] OK: zero dropped queries, no replica_error shed, "
              f"{len(trainer.versions_published)} versions trained from "
              f"the served tap, lag <= {args.staleness_bound}")

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1, default=str))

    if args.trace_out:
        n_entries = cluster.write_trace(args.trace_out,
                                        process_name="repro_torch-cluster")
        print(f"[trace] {n_entries} entries -> {args.trace_out} "
              f"(open at ui.perfetto.dev)")
    if args.metrics_json:
        p = Path(args.metrics_json)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(cluster.metrics_snapshot(), indent=1))
        print(f"[metrics] fleet snapshot -> {args.metrics_json}")
    if cell_tmp is not None:
        cell_tmp.cleanup()


if __name__ == "__main__":
    main()
