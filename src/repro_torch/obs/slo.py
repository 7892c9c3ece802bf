"""SLO burn-rate monitor (the port's copy of the reference's
``obs/slo.py``): multi-window error-budget burn as a pure
fold over merged metrics snapshots.

The SLI is ticket-level goodness: a ticket is **good** when it was
served at or under the latency threshold, **bad** when it was served
slower or shed.  Both signals already live in every fleet snapshot —
the per-(level, category) ``serve.latency_ms`` histograms and the
``cluster.shed{where=...}`` counters — so the monitor never touches
the serving path: feed it ``ReplicaSet.metrics_snapshot()`` outputs
and it differences them over time.

Window math (the standard multi-window burn-rate alert, Google
SRE-workbook shape): with error budget ``1 - target``,

    burn(w) = error_rate_over_last_w / (1 - target)

burn 1.0 spends the budget exactly over the SLO period; a **fast**
window (minutes) catches cliffs, a **slow** window (the fast one ×10
by default) suppresses blips.  ``check()`` pages only when BOTH
windows burn past ``page_burn`` — a cliff sustained long enough to
matter — and warns when either exceeds ``warn_burn``.

The latency threshold is snapped UP to the nearest histogram edge
(fixed 1-2-5 decade edges, ``LATENCY_MS_EDGES``), because bucket
counts can only answer "how many were ≤ this edge"; the snapped value
is reported back as ``effective_latency_slo_ms``.

Verdicts ride the registry as ``slo.*`` gauges so they merge/export
like everything else; the future admission controller subscribes to
``check()`` — this PR wires it read-only into
``repro_torch.launch.cluster --slo-target``.
"""
from __future__ import annotations

import bisect
import dataclasses
import time
from collections import deque
from typing import Deque, Optional, Tuple

__all__ = ["SLOConfig", "SLOMonitor", "fold_snapshot"]


def fold_snapshot(snap: dict, latency_slo_ms: float) -> dict:
    """Fold one merged metrics snapshot into SLI totals.

    Returns ``{"total", "good", "bad", "served", "slow", "shed",
    "effective_latency_slo_ms"}`` — cumulative since the fleet
    started, monotone between snapshots of a live registry (which is
    what lets the monitor difference them into windows).
    """
    served = slow = 0
    eff = float(latency_slo_ms)
    for key, m in snap.items():
        if not key.startswith("serve.latency_ms"):
            continue
        if m.get("type") != "histogram":
            continue
        edges = m["edges"]
        counts = m["counts"]
        served += m["count"]
        # Buckets hold (edges[i-1], edges[i]]: snapping the threshold
        # up to edges[k] makes "good" exactly counts[:k+1].
        k = bisect.bisect_left(edges, float(latency_slo_ms))
        if k < len(edges):
            eff = float(edges[k])
            slow += sum(counts[k + 1:])
        # threshold above every finite edge: even overflow counts good
    shed = sum(m["value"] for key, m in snap.items()
               if key.startswith("cluster.shed")
               and m.get("type") == "counter")
    return {"total": served + shed, "good": served - slow,
            "bad": slow + shed, "served": served, "slow": slow,
            "shed": shed, "effective_latency_slo_ms": eff}


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    target: float = 0.999              # fraction of tickets that must be good
    latency_slo_ms: float = 50.0       # served slower than this = bad
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0
    warn_burn: float = 2.0             # either window past this -> warn
    page_burn: float = 10.0            # BOTH windows past this -> page
    max_samples: int = 4096            # bounded sample ring

    def __post_init__(self):
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"target must be in (0, 1), got {self.target}")
        if self.fast_window_s >= self.slow_window_s:
            raise ValueError("fast window must be shorter than slow")


class SLOMonitor:
    """Rolling burn-rate monitor over snapshot observations.

    Not thread-safe by design — one monitoring loop owns it (the
    registry gauges it publishes ARE safe to read concurrently).
    """

    def __init__(self, cfg: SLOConfig = SLOConfig(), registry=None,
                 clock=time.monotonic):
        self.cfg = cfg
        self.clock = clock
        # (t, total, bad) samples, oldest first, spanning >= slow window
        self._samples: Deque[Tuple[float, int, int]] = deque(
            maxlen=cfg.max_samples)
        self._last_fold: dict = {}
        self._gauges = {}
        if registry is not None:
            self._gauges = {
                ("burn", "fast"): registry.gauge("slo.burn_rate",
                                                 window="fast"),
                ("burn", "slow"): registry.gauge("slo.burn_rate",
                                                 window="slow"),
                ("err", "fast"): registry.gauge("slo.error_rate",
                                                window="fast"),
                ("err", "slow"): registry.gauge("slo.error_rate",
                                                window="slow"),
            }

    @property
    def budget(self) -> float:
        return 1.0 - self.cfg.target

    def observe(self, snap: dict, t: Optional[float] = None) -> dict:
        """Fold one fleet snapshot in; returns the cumulative fold."""
        fold = fold_snapshot(snap, self.cfg.latency_slo_ms)
        self._last_fold = fold
        self._samples.append((self.clock() if t is None else float(t),
                              fold["total"], fold["bad"]))
        if self._gauges:
            v = self.check()
            self._gauges["burn", "fast"].set(v["burn_fast"])
            self._gauges["burn", "slow"].set(v["burn_slow"])
            self._gauges["err", "fast"].set(v["error_rate_fast"])
            self._gauges["err", "slow"].set(v["error_rate_slow"])
        return fold

    def _window_rate(self, window_s: float) -> float:
        """Error rate over the last ``window_s``: difference the newest
        sample against the oldest one still inside the window (or the
        oldest we have — early in a run every window sees the whole
        history, which is the honest answer)."""
        if len(self._samples) < 1:
            return 0.0
        t_now, total_now, bad_now = self._samples[-1]
        base = self._samples[0]
        for s in self._samples:
            if s[0] >= t_now - window_s:
                break
            base = s
        d_total = total_now - base[1]
        d_bad = bad_now - base[2]
        if d_total <= 0:
            return 0.0
        return d_bad / d_total

    def burn_rate(self, window_s: float) -> float:
        return self._window_rate(window_s) / self.budget

    def check(self) -> dict:
        """Multi-window verdict: ``ok`` / ``warn`` / ``page``."""
        cfg = self.cfg
        err_fast = self._window_rate(cfg.fast_window_s)
        err_slow = self._window_rate(cfg.slow_window_s)
        burn_fast = err_fast / self.budget
        burn_slow = err_slow / self.budget
        if burn_fast >= cfg.page_burn and burn_slow >= cfg.page_burn:
            verdict = "page"
        elif burn_fast >= cfg.warn_burn or burn_slow >= cfg.warn_burn:
            verdict = "warn"
        else:
            verdict = "ok"
        return {
            "verdict": verdict,
            "target": cfg.target,
            "latency_slo_ms": cfg.latency_slo_ms,
            "effective_latency_slo_ms": self._last_fold.get(
                "effective_latency_slo_ms", cfg.latency_slo_ms),
            "budget": self.budget,
            "burn_fast": burn_fast,
            "burn_slow": burn_slow,
            "error_rate_fast": err_fast,
            "error_rate_slow": err_slow,
            "warn_burn": cfg.warn_burn,
            "page_burn": cfg.page_burn,
            **{k: self._last_fold.get(k, 0)
               for k in ("total", "good", "bad", "served", "slow", "shed")},
        }
