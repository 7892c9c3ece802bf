"""Health/introspection plane: per-cell statusz + heartbeat watchdog.

The port's copy of the reference's ``obs/health.py``.
``statusz(cluster)`` is the cell's one-page answer to "what state is
the fleet in RIGHT NOW": head policy version and index epoch, per
replica the versions it has actually applied (and the lag against the
head), queue depths, ring occupancy/park counters straight from the
shm ring headers, restart counts, and a watchdog verdict per worker.
It reads only parent-side state (ring headers, cached acks, process
liveness) — no control-pipe round trips — so it is safe to dump from a
monitoring loop.  `tools/obsctl.py` renders the JSON;
``repro_torch.launch.cluster --statusz-out`` writes it.

The :class:`HeartbeatWatchdog` reads the worker heartbeat each worker
stamps into its request ring header (``time.monotonic``, comparable
across processes — CLOCK_MONOTONIC is system-wide).  The subtlety is
that a stale heartbeat alone is NOT a hang: a parked idle consumer
blocks in ``conn.poll`` with an empty ring and may legitimately stop
stamping.  The watchdog therefore folds in the pending-work signal
(ring occupancy + the worker's published engine depth) and only calls
"wedged" when the heartbeat is stale *while work is waiting*:

    dead         process gone (or restarts exhausted)
    healthy      heartbeat fresh (< stale_after_s)
    parked_idle  heartbeat stale, but nothing pending — parked, fine
    busy         heartbeat stale with work pending, but within the
                 wedge grace (a long rollout pauses stamping)
    wedged       heartbeat stale past wedge_after_s with work pending

A thread replica shares its process, so its heartbeat age is zero
while its thread runs.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

__all__ = ["HeartbeatWatchdog", "statusz"]

#: Watchdog verdicts, worst-last (statusz reports the fleet's worst).
WORKER_STATES = ("healthy", "parked_idle", "busy", "wedged", "dead")


@dataclasses.dataclass(frozen=True)
class HeartbeatWatchdog:
    """Stateless classifier over (alive, heartbeat age, pending work).

    ``stale_after_s`` is the stamping cadence budget (workers stamp
    every loop iteration — ~ms when serving, so 1 s of silence means
    the loop is not spinning).  ``wedge_after_s`` is the grace a busy
    worker gets before stale + pending work is declared a hang — it
    must comfortably exceed the longest legitimate single rollout.
    """

    stale_after_s: float = 1.0
    wedge_after_s: float = 10.0

    def assess(self, *, alive: bool,
               heartbeat_age_s: Optional[float],
               pending: int) -> str:
        if not alive:
            return "dead"
        if heartbeat_age_s is None or heartbeat_age_s < self.stale_after_s:
            return "healthy"
        if pending <= 0:
            # The no-false-positive case: an idle parked consumer
            # (empty ring, blocked on its control pipe) is healthy
            # no matter how old its last stamp is.
            return "parked_idle"
        if heartbeat_age_s < self.wedge_after_s:
            return "busy"
        return "wedged"


def _worst(states) -> str:
    states = list(states)
    if not states:
        return "healthy"
    return max(states, key=WORKER_STATES.index)


def statusz(cluster, watchdog: Optional[HeartbeatWatchdog] = None) -> dict:
    """One-page cell status JSON for a ``ReplicaSet`` (either backend).

    Field reference lives in the reference's docs/observability.md;
    everything here is parent-side state only — calling this never
    blocks on a worker.
    """
    wd = watchdog or HeartbeatWatchdog()
    head_version = cluster.store.version
    head_epoch = getattr(cluster.system, "index_epoch", 0)
    replicas = []
    for r in cluster.replicas:
        h = r.health()
        h["state"] = wd.assess(alive=h.get("alive", False),
                               heartbeat_age_s=h.get("heartbeat_age_s"),
                               pending=h.get("pending", 0))
        h["policy_version"] = r.policy_version
        h["index_epoch"] = r.index_epoch
        h["policy_lag"] = max(0, head_version - r.policy_version)
        h["epoch_lag"] = max(0, head_epoch - r.index_epoch)
        replicas.append(h)
    doc = {
        "t_wall": time.time(),
        "backend": cluster.cfg.backend,
        "n_replicas": len(cluster.replicas),
        "head_policy_version": head_version,
        "head_index_epoch": head_epoch,
        "state": _worst(h["state"] for h in replicas),
        "watchdog": {"stale_after_s": wd.stale_after_s,
                     "wedge_after_s": wd.wedge_after_s},
        "replicas": replicas,
        "admission": cluster.admission.stats(),
        "events_recorded": cluster.events.n_recorded,
        "events_tail_kinds": [e["kind"] for e in cluster.events.tail(16)],
    }
    cell_dir = getattr(cluster, "proc_cell_dir", None)
    if cell_dir:
        doc["cell_dir"] = cell_dir
    return doc
