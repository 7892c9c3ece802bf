"""Online learning on the PyTorch port: candidate quality improves across
policy snapshot versions while a replica set serves without
interruption, on the GPU.

A `TrainerLoop` Q-learns per-category match policies on a background
thread and publishes eval-gated snapshots into a `PolicyStore`; a
2-replica `ReplicaSet` keeps serving throughout, hot-swapping each new
version at its next drain.  The demo tracks a recall proxy (fraction of
positively judged docs retrieved, `cluster.candidate_recall`) per
served policy version and checks the three properties the subsystem
promises:

  1. >= 3 snapshot versions published while serving never stops,
  2. every non-shed response comes from a version within the store's
     staleness bound,
  3. per-version candidate quality is monotone non-decreasing (the
     trainer's eval gate never promotes a regression).

    PYTHONPATH=src python examples/online_learning_torch.py
    PYTHONPATH=src python examples/online_learning_torch.py --device cpu

The same sizes, seeds, checks and printed lines as
``examples/online_learning.py``; the last line is one JSON object with
the numbers printed before it.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.cluster import (ClusterConfig, ReplicaSet, Shed,
                                 TrainerConfig, TrainerLoop, candidate_recall)
from repro_torch.data.querylog import QueryLogConfig
from repro_torch.index.corpus import CorpusConfig
from repro_torch.policies import PolicyStore
from repro_torch.serving import EngineConfig
from repro_torch.system import RetrievalSystem, SystemConfig

STALENESS_BOUND = 2
TRAINER = TrainerConfig(iters=45, publish_every=15, batch=32,
                        probe_queries=24, publish_initial=False)


def probe_pass(cluster, probe_qids, log):
    """Serve the probe set once; returns (version, mean recall) if every
    response came from one snapshot version, else None (a publish landed
    mid-pass — the caller just retries; the cache makes retries cheap)."""
    responses = cluster.serve(probe_qids)
    served = [r for r in responses if not isinstance(r, Shed)]
    versions = {r.policy_version for r in served}
    if len(versions) != 1:
        return None
    ids = np.stack([r.doc_ids for r in served])
    qids = np.asarray([r.qid for r in served])
    recall = candidate_recall(ids, log.judged_ids[qids],
                              log.judged_gains[qids]).mean()
    return versions.pop(), float(recall)


def build_system(device: str = "cuda") -> RetrievalSystem:
    """The example's system: L1 ranker and state bins fitted."""
    sys_ = RetrievalSystem(SystemConfig(
        corpus=CorpusConfig(n_docs=4096, vocab_size=1024, seed=0),
        querylog=QueryLogConfig(n_queries=400, seed=0),
        block_docs=256, p_bins=256, u_budget=1024, l1_steps=150,
    ), device=device)
    sys_.fit_l1(n_queries=96)
    sys_.fit_state_bins(n_queries=64)
    return sys_


def run(sys_: RetrievalSystem, trainer_cfg: TrainerConfig = TRAINER) -> dict:
    """Serve while training from the served traffic; prints the report,
    checks the three properties (and that the trainer read only the
    tap) and returns the numbers printed."""
    store = PolicyStore(staleness_bound=STALENESS_BOUND)
    trainer = TrainerLoop(sys_, store, cfg=trainer_cfg)
    trainer.publish_now()                       # v1: untrained tables
    probe_qids = np.concatenate(list(trainer.probe_qids.values()))

    cluster = ReplicaSet(
        sys_, store, ClusterConfig(n_replicas=2, routing="queue_aware"),
        EngineConfig(min_bucket=8, max_bucket=32, cache_capacity=512))
    trainer.source = cluster.tap      # train from served traffic, not the log
    cluster.warmup()

    rng = np.random.default_rng(0)
    quality = {}                                # version -> mean recall
    n_background = 0
    t0 = time.time()
    with cluster:
        trainer.start()
        while True:
            head = store.version
            if head not in quality:
                got = probe_pass(cluster, probe_qids, sys_.log)
                if got is not None and got[0] not in quality:
                    quality[got[0]] = got[1]
                    print(f"[v{got[0]}] probe recall {got[1]:.4f} "
                          f"(t={time.time() - t0:.0f}s, "
                          f"background={n_background})")
            if not trainer.alive and store.version in quality:
                break
            # serving never stops: background traffic between probes
            cluster.serve(rng.integers(0, sys_.log.n_queries, size=16))
            n_background += 16
        trainer.join()
    stats = cluster.stats()

    versions = sorted(quality)
    recalls = [quality[v] for v in versions]
    report = {
        "versions": versions,
        "recall_per_version": recalls,
        "gate_history": trainer.history,
        "background_queries": n_background,
        "shed_rate": stats["shed_rate"],
        "version_lag_observed_max": stats["version_lag_observed_max"],
        "latency_p99_ms": round(stats["latency_p99_ms"], 2),
    }
    print(json.dumps(report, indent=1))

    assert len(versions) >= 3, f"expected >= 3 versions, saw {versions}"
    assert stats["n_submitted"] == stats["n_responses"] + stats["n_shed"], \
        "dropped queries"
    assert trainer.tap_batches > 0 and trainer.log_batches == 0, \
        "trainer must train from served traffic only"
    assert stats["version_lag_observed_max"] <= STALENESS_BOUND, \
        "served beyond the staleness bound"
    for a, b in zip(recalls, recalls[1:]):
        assert b >= a - 1e-9, f"quality regressed across versions: {recalls}"
    print(f"OK: {len(versions)} versions, recall "
          f"{recalls[0]:.4f} -> {recalls[-1]:.4f}, serving never stopped")
    return dict(report, example="online_learning",
                tap_batches=trainer.tap_batches,
                log_batches=trainer.log_batches)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    full = run(build_system(args.device))
    out = {k: full[k] for k in (
        "example", "versions", "recall_per_version", "background_queries",
        "shed_rate", "version_lag_observed_max", "latency_p99_ms",
        "tap_batches", "log_batches")}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
