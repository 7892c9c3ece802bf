"""What the websearch runners share: the program's cell built from the
configuration file, the window's loop with its traced slice, and the
compulsory bytes of the rooflines."""
from __future__ import annotations

import dataclasses
import statistics
import time
from types import SimpleNamespace
from typing import Callable, List, Optional

import torch

from perfbench import harness
from perfbench.trace import TraceSlice, TraceSummary


def program_cfg(cfg: dict):
    """The program's own configuration object, with every size from the
    configuration file (``reduced`` is empty: these are the published
    ones)."""
    from repro_torch.configs.websearch_rl import WebSearchCfg

    return WebSearchCfg(n_blocks=cfg["n_blocks"], block_docs=cfg["block_docs"],
                        k_rules=cfg["k_rules"],
                        max_candidates=cfg["max_candidates"],
                        n_top=cfg["n_top"], p_bins=cfg["p_bins"],
                        t_max=cfg["t_max"], u_budget=cfg["u_budget"],
                        backend=cfg["program"]["backend"])


def make_program(cfg: dict) -> Callable:
    """The system under test: the port's cell function at the
    configuration's sizes."""
    from repro_torch.launch.steps import build_cell

    return build_cell(cfg["program"]["arch"], cfg["program"]["shape"],
                      cfg_override=program_cfg(cfg),
                      shape_params={"query_batch": cfg["query_batch"]}).fn


def program_bins(inp):
    from repro_torch.core.state_bins import StateBins

    return StateBins(inp.u_edges, inp.v_edges)


def chunk_launches() -> int:
    """The program's own count of chunk-kernel launches
    (``NativeKernel.launches``), for the run's log."""
    from repro_torch.kernels.block_scan import BLOCK_SCAN_KERNEL

    return BLOCK_SCAN_KERNEL.launches


def plane_bytes(cfg: dict) -> int:
    """Bytes of one plane of one block: W words of 4 bytes."""
    return cfg["block_docs"] // 8


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Window:
    """The calls of a measured window: each call's host-clock seconds
    and what it returned, and the traced slice (``trace_calls`` calls
    from the window's middle on, with ``--trace 1``)."""

    seconds_each: List[float]
    results: list
    traced: List[bool]
    seconds: float            # from the first call's dispatch to the last one's end
    trace: Optional[TraceSummary]
    chunk_launches: int       # the program's count over the window


def run_window(call: Callable[[int], object], seconds: float, device,
               tracer: Optional[TraceSlice], trace_calls: int) -> Window:
    """Calls ``call(i)`` back to back, each ending on the host, until
    ``seconds`` have passed (closed loop, one in flight)."""
    times, results, traced = [], [], []
    launches = chunk_launches()
    left, trace_at = 0, (seconds / 2 if tracer is not None else None)
    begin = time.perf_counter()
    while True:
        if trace_at is not None and time.perf_counter() - begin >= trace_at:
            tracer.start()
            left, trace_at = trace_calls, None
        t0 = time.perf_counter()
        results.append(call(len(results)))
        t1 = time.perf_counter()
        times.append(t1 - t0)
        traced.append(left > 0)
        if left > 0:
            left -= 1
            if left == 0:
                tracer.stop()
        if t1 - begin >= seconds and left == 0:
            break
    end = time.perf_counter()
    launches = chunk_launches() - launches
    summary = tracer.summary() if tracer is not None and any(traced) else None
    return Window(times, results, traced, end - begin, summary, launches)


class Marks:
    """Seconds from the process's start to each named point of set-up."""

    def __init__(self, start: float):
        self.start, self.points = start, []

    def __call__(self, name: str):
        self.points.append((name, time.perf_counter() - self.start))

    def text(self) -> str:
        return "set-up: " + ", ".join(f"{n} at {t:.3f} s" for n, t in self.points)


def window_note(window: "Window") -> str:
    """The spread of the window's calls, for the run's log: quartiles of
    a call's seconds and the calls of each quarter of the window."""
    q = statistics.quantiles(window.seconds_each, n=4) \
        if len(window.seconds_each) > 1 else window.seconds_each * 3
    t, quarters = 0.0, [0, 0, 0, 0]
    for s in window.seconds_each:
        t += s
        quarters[min(3, int(4 * t / window.seconds))] += 1
    return (f"call seconds quartiles {q[0]:.6f} {q[1]:.6f} {q[2]:.6f}, max "
            f"{max(window.seconds_each):.6f}; calls a quarter {quarters}; "
            f"chunk launches a call "
            f"{window.chunk_launches / len(window.seconds_each):.3f}")


def trace_note(window: "Window", plane_bytes_each: List[float]) -> str:
    """What the traced slice holds, for the run's log."""
    if window.trace is None:
        return "no traced slice"
    tr = window.trace
    hot = [i for i, t in enumerate(window.traced) if t]
    kern = {k: (tr.device_n[k], s) for k, s in tr.device_s.items()
            if "block_scan" in k}
    return (f"traced calls {hot[0]}..{hot[-1]} ({len(hot)}): window "
            f"{tr.window_s:.6f} s, busy {tr.busy_s:.6f} s, "
            f"{sum(tr.device_n.values())} device ops, {tr.launches} launch "
            f"calls of {tr.runtime_events} CUDA API calls; block-scan kernels "
            f"(launches, s) {kern}; u's plane bytes "
            f"{sum(plane_bytes_each[i] for i in hot):.0f}")


def layer_context(kind: str, window: Window, queries: int,
                  step_bytes: List[float], plane_bytes_each: List[float],
                  device_kind: str) -> SimpleNamespace:
    """What the per-layer readers read: the untraced calls' mean time,
    95th percentile and compulsory bytes, and the traced slice with its
    calls' scanned plane bytes and queries."""
    plain = [i for i, t in enumerate(window.traced) if not t]
    hot = [i for i, t in enumerate(window.traced) if t]
    mean = lambda xs: sum(xs) / len(xs) if xs else None  # noqa: E731
    return SimpleNamespace(
        kind=kind,
        mean_call_s=mean([window.seconds_each[i] for i in plain]),
        p95_call_s=(harness.p95([window.seconds_each[i] for i in plain])
                    if plain else None),
        step_bytes=mean([step_bytes[i] for i in plain]),
        trace=window.trace,
        traced_calls=len(hot),
        traced_queries=len(hot) * queries,
        traced_plane_bytes=sum(plane_bytes_each[i] for i in hot),
        hbm_bytes_per_s=harness.peak(device_kind, "hbm_bytes_per_s"),
    )
