"""A profiled slice of a run's window: the device's busy time as the
union of its operations' intervals, the device time by operation, the
host's kernel-launch calls, and the longest idle gaps with what the host
was doing in each (the busy/idle arithmetic of ``chip_smoke.py``'s
``profile_device``, copied).

On the card only the device's activity is traced (its operations and
the CUDA API calls that issue them): recording every host op as well
makes a launch-bound call 1.4-1.9 times slower under the profiler and
the device's idle share read high.  A gap is named by the CUDA call
that covers its middle, or by the call that ended it."""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Tuple

LAUNCH_API = "LaunchKernel"     # cudaLaunchKernel, cudaLaunchKernelExC, cuLaunchKernel
TOP = 10                        # entries of each list in the breakdown
NAME_CHARS = 120                # a kernel's name, cut to this length


@dataclasses.dataclass
class TraceSummary:
    window_s: float                     # host clock from the slice's start to its end
    busy_s: float                       # union of the device's operation intervals
    device_s: Dict[str, float]          # device seconds by operation name
    device_n: Dict[str, int]            # device operations by name
    launches: int                       # the host's kernel-launch API calls
    runtime_events: int                 # CUDA API calls recorded at all
    idle_gaps: List[Tuple[str, float]]  # the longest gaps, by host activity

    def device_seconds(self, part: str) -> float:
        """Device seconds of the operations whose names hold ``part``."""
        return sum(s for k, s in self.device_s.items() if part in k)

    def breakdown(self) -> dict:
        ops = sorted(self.device_s.items(), key=lambda kv: kv[1], reverse=True)
        return {"device_ops": [[k[:NAME_CHARS], s] for k, s in ops[:TOP]],
                "idle_gaps": [[k[:NAME_CHARS], s] for k, s in self.idle_gaps]}


def _raw_events(prof):
    """(name, on_device, start_us, end_us, is_runtime) of every event; a
    host event is a CUDA API call where its name says so."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        out.append((e.name(), e.device_type() == DeviceType.CUDA, start,
                    start + e.duration_ns() / 1e3,
                    e.name().startswith(("cuda", "cu"))))
    return out


def union_busy(spans: List[Tuple[float, float]]):
    """The merged intervals of ``spans`` and their total length."""
    merged: List[List[float]] = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged, sum(e - s for s, e in merged)


def idle_gaps(merged, host, start: float, end: float, top: int = TOP):
    """The ``top`` longest gaps between the device's merged intervals
    inside [start, end], each named by the shortest host event that
    covers its middle (the innermost), or else by the first host event
    that starts after its middle ("host, then <event>")."""
    gaps, prev = [], start
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if end > prev:
        gaps.append((prev, end))
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    out = []
    for s, e in gaps[:top]:
        mid = 0.5 * (s + e)
        inner = [h for h in host if h[1] <= mid <= h[2]]
        after = [h for h in host if h[1] > mid]
        if inner:
            name = min(inner, key=lambda h: h[2] - h[1])[0]
        elif after:
            name = "host, then " + min(after, key=lambda h: h[1])[0]
        else:
            name = "host"
        out.append((name, (e - s) / 1e6))
    return out


def summarise(prof, window_s: float) -> TraceSummary:
    events = _raw_events(prof)
    dev = [(n, s, e) for n, on_dev, s, e, _ in events if on_dev]
    host = [(n, s, e) for n, on_dev, s, e, _ in events if not on_dev]
    merged, busy_us = union_busy([(s, e) for _, s, e in dev])
    device_s: Dict[str, float] = {}
    device_n: Dict[str, int] = {}
    for n, s, e in dev:
        device_s[n] = device_s.get(n, 0.0) + (e - s) / 1e6
        device_n[n] = device_n.get(n, 0) + 1
    runtime = [n for n, on_dev, _, _, is_rt in events if is_rt and not on_dev]
    launches = sum(LAUNCH_API in n for n in runtime)
    stamps = [s for _, s, _ in host] + [s for _, s, _ in dev]
    ends = [e for _, _, e in host] + [e for _, _, e in dev]
    gaps = (idle_gaps(merged, host, min(stamps), max(ends)) if dev else [])
    return TraceSummary(window_s, busy_us / 1e6, device_s, device_n, launches,
                        len(runtime), gaps)


class TraceSlice:
    """Profiles the host and the device over a run of consecutive calls:
    ``start`` and ``stop`` each synchronise the card, so that the slice's
    window holds all of its calls' device work."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.t0 = 0.0
        self.window_s = 0.0

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _profiler(self):
        from torch.profiler import ProfilerActivity, profile

        on_card = self.device.type == "cuda"
        return profile(activities=[ProfilerActivity.CUDA if on_card
                                   else ProfilerActivity.CPU])

    def warm(self):
        """Start and stop the profiler once in set-up, so that its first
        start (CUPTI's) does not fall into the window."""
        import torch

        with self._profiler():
            torch.zeros(1, device=self.device).add_(1)
            self._sync()

    def start(self):
        self._sync()
        self.prof = self._profiler()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        """End the slice; its events are read by ``summary``, after the
        window, so that reading them takes none of the window's time."""
        self._sync()
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()

    def summary(self) -> TraceSummary:
        summary = summarise(self.prof, self.window_s)
        self.prof = None
        return summary
