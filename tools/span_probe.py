#!/usr/bin/env python3
"""Lay the port's own spans over a profiled slice of a websearch cell of
``BENCHMARK.json`` on the card, and count its host syncs.

    PYTHONPATH=src python3 tools/span_probe.py --workload ws16m-serve-cat1 \\
        --seed 5100000001 --pairs 60 --out chiprun_out/spans.json

The cell at its published sizes, its inputs made from ``--seed`` as the
benchmark makes them (``perfbench.generate``), its warm calls, then:

1. the sync check: one call of the program (the cell's function, not the
   runner's reads of its answers) under
   ``torch.cuda.set_sync_debug_mode("warn")``: the synchronising calls
   that torch reports, by source line, against the increase of the
   program's host-sync count (``repro_torch.obs.host_syncs``), beside
   the rule executions that ran as one kernel (the launches of
   ``BLOCK_SCAN_RULE_KERNEL``);
2. two profiled slices of the traffic's ``trace_calls`` calls, made as
   the benchmark's traced slice is (``perfbench.trace.TraceSlice``), the
   first under no tracer, the second under ``tracing(Tracer(clock=
   perfbench.spans.profiler_clock))``.  Of each: launches a query, the
   device's idle share, host syncs and one-kernel rule executions a
   call.  Of the traced one: the
   kernel-launch API calls inside a program span, the chunk kernel's
   launches inside a ``chunk`` span (by the profiler's correlation ids),
   the ``sync`` spans over a device-to-host copy or a synchronise call;
   ``sync_wait_share``, ``loop_idle_share``; the device's idle time by
   innermost span; the longest idle gaps named by span path;
3. the cost of tracing: ``--pairs`` pairs of calls on one pool variant,
   one traced and one not, in turns (traced first in even pairs): the
   median of the pairs' differences and the spans a traced call
   records; and a site's cost with no tracer and under one (``scope``
   and ``host_sync``, each 10^6 times, beside an empty ``with``).

Writes one JSON object to ``--out`` and prints it as the last line.  On
the CPU (``--device cpu``, with a reduced cell) it runs every step but
the sync check; the device numbers are then empty.
"""
import argparse
import contextlib
import json
import statistics
import sys
import time
import warnings
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from perfbench import generate, harness, spans, trace  # noqa: E402
from perfbench.runners import websearch as ws  # noqa: E402
from repro_torch.kernels.block_scan import (  # noqa: E402
    BLOCK_SCAN_RULE_KERNEL)
from repro_torch.obs import (NULL_SPAN, Tracer, host_sync,  # noqa: E402
                             host_syncs, scope, tracing)

CHUNK_KERNEL = "block_scan_pruned_chunk"
HOST_WAITS = ("Memcpy", "Synchronize")      # a D2H copy, a synchronise call
BUFFER_REQUEST = "Activity Buffer Request"  # the profiler's own host event
SITE_CALLS = 10**6


def program(cell, seed: int, device):
    """(step, call, queries a call): ``step(k)`` runs the program on the
    call's pool variant; ``call(k)`` is the runner's call, the step with
    its answers (serve) or its metrics (learner) read on the host."""
    cfg, traffic = cell.config, cell.traffic
    learner = cell.runner.KIND == "learn"
    draw_steps = cfg["learner"]["draw_steps"] if learner else None
    inp = generate.websearch_inputs(cfg, traffic, seed, device,
                                    draw_steps=draw_steps)
    fn, bins = ws.make_program(cfg), ws.program_bins(inp)
    if learner:
        restart, state = cfg["learner"]["restart_every"], {"q": inp.q}

        def step(k):
            occ, tp = inp.batch(k)
            q = inp.q if k % restart == 0 else state["q"]
            state["q"], metrics = fn(q, bins, occ, inp.scores, tp,
                                     inp.prod_rewards, inp.draws(k))
            return metrics

        def call(k):
            return float(step(k)["mean_u"])
    else:
        def step(k):
            occ, tp = inp.batch(k)
            return fn(inp.q, bins, occ, inp.scores, tp)

        def call(k):
            return tuple(x.cpu() for x in step(k))
    return step, call, cfg["query_batch"]


def sync_check(step, k: int, device) -> dict:
    """The synchronising calls that torch reports for one step, by
    source line, against the program's count."""
    ws.sync(device)
    n0, r0 = host_syncs(), BLOCK_SCAN_RULE_KERNEL.launches
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(k)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    counted = host_syncs() - n0
    rules = BLOCK_SCAN_RULE_KERNEL.launches - r0
    ws.sync(device)
    synced = [w for w in caught
              if "called a synchronizing" in str(w.message)]
    sites = Counter(f"{Path(w.filename).name}:{w.lineno}" for w in synced)
    return {"torch_reports": len(synced), "program_counts": counted,
            "equal": len(synced) == counted, "kernel_rules": rules,
            "sites": dict(sites),
            "messages": sorted({str(w.message)[:200] for w in caught})}


def correlated(prof):
    """Each device op's name and the host API call (start, end µs) that
    issued it, matched by correlation id (None where none matches)."""
    from torch.autograd import DeviceType

    host, ops = {}, []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        if e.device_type() == DeviceType.CUDA:
            ops.append((e.name(), e.correlation_id()))
        elif e.name().startswith(("cuda", "cu")):
            host[e.correlation_id()] = (start, start + e.duration_ns() / 1e3)
    return [(name, host.get(c)) for name, c in ops]


def inside(ivs, s: float, e: float, name=None) -> bool:
    return any(i.start <= s and e <= i.end for i in ivs
               if name is None or i.name == name)


def profiled(call, ks, device, tracer=None) -> dict:
    """One profiled slice of the calls ``ks``; its events read, under
    ``tracer`` if given."""
    tslice = trace.TraceSlice(device)
    tslice.start()
    n0, r0 = host_syncs(), BLOCK_SCAN_RULE_KERNEL.launches
    with tracing(tracer) if tracer else contextlib.nullcontext():
        for k in ks:
            call(k)
    tslice.stop()
    syncs = host_syncs() - n0
    rules = BLOCK_SCAN_RULE_KERNEL.launches - r0
    events = trace._raw_events(tslice.prof)
    ops = correlated(tslice.prof)
    summary = tslice.summary()
    return {"events": events, "summary": summary, "syncs": syncs,
            "rules": rules, "ops": ops}


def slice_numbers(got: dict, calls: int, queries: int) -> dict:
    tr = got["summary"]
    return {"window_s": tr.window_s, "busy_s": tr.busy_s,
            "launches_per_query": tr.launches / (calls * queries),
            "device_idle_share": (100.0 * (1.0 - tr.busy_s / tr.window_s)
                                  if tr.busy_s > 0 else None),
            "host_syncs_per_call": got["syncs"] / calls,
            "kernel_rules_per_call": got["rules"] / calls,
            "chunk_kernel_s": tr.device_seconds(CHUNK_KERNEL),
            "idle_gaps": tr.idle_gaps}


def span_numbers(got: dict, tracer, calls: int) -> dict:
    """What the traced slice's spans read beside its events."""
    events = got["events"]
    dev = [(s, e) for _, on_dev, s, e, _ in events if on_dev]
    host = [(n, s, e) for n, on_dev, s, e, _ in events if not on_dev]
    ivs = spans.intervals(tracer.log.snapshot())
    merged, _ = trace.union_busy(dev)
    stamps = [s for _, _, s, _, _ in events]
    ends = [e for _, _, _, e, _ in events]
    start, end = (min(stamps), max(ends)) if events else (0.0, 0.0)
    roots = [i for i in ivs if i.depth == 0]
    launches = [(s, e) for n, s, e in host if trace.LAUNCH_API in n]
    chunks = [h for n, h in got["ops"] if CHUNK_KERNEL in n]
    stray = Counter(n[:80] for n, h in got["ops"]
                    if h is not None and not inside(roots, *h))
    waits = [(s, e) for n, s, e in host if any(w in n for w in HOST_WAITS)]
    syncs = [i for i in ivs if i.name == spans.SYNC]
    window_s = got["summary"].window_s
    over = [(n, s, e) for n, s, e in host if n == BUFFER_REQUEST]
    by_span = spans.idle_by_span(merged, ivs, start, end, over)
    return {
        "spans": len(ivs),
        "spans_per_call": len(ivs) / calls,
        "launch_calls": len(launches),
        "launch_calls_in_a_span": sum(inside(roots, s, e)
                                      for s, e in launches),
        "device_ops_issued_outside_spans": dict(stray),
        "chunk_launches": len(chunks),
        "chunk_launches_unmatched": sum(h is None for h in chunks),
        "chunk_launches_in_a_chunk_span": sum(
            inside(ivs, *h, "chunk") for h in chunks if h is not None),
        "sync_spans": len(syncs),
        "sync_spans_over_a_wait": sum(
            any(i.start <= s and e <= i.end for s, e in waits) for i in syncs),
        "sync_spans_over_a_wait_mid": sum(
            any(i.start <= 0.5 * (s + e) <= i.end for s, e in waits)
            for i in syncs),
        "sync_wait_share": spans.sync_wait_share(ivs, window_s),
        "loop_idle_share": spans.loop_idle_share(ivs, merged, window_s),
        "idle_ms_per_call_by_span": {k: 1e3 * v / calls
                                     for k, v in sorted(by_span.items())},
        "idle_gaps_by_span": spans.idle_gaps(merged, host, start, end,
                                             spans=ivs) if dev else [],
    }


def tracing_cost(call, k: int, pairs: int) -> dict:
    """Pairs of calls of variant ``k``, one traced and one not."""
    diffs, recorded = [], []
    for p in range(pairs):
        took = {}
        for traced in ((True, False) if p % 2 == 0 else (False, True)):
            tracer = Tracer(clock=spans.profiler_clock) if traced else None
            t0 = time.perf_counter()
            with tracing(tracer) if tracer else contextlib.nullcontext():
                call(k)
            took[traced] = time.perf_counter() - t0
            if tracer:
                recorded.append(tracer.log.n_recorded)
        diffs.append(took[True] - took[False])
    per_call = statistics.median(diffs)
    n_spans = statistics.median(recorded)
    return {"pairs": pairs, "median_diff_ms": 1e3 * per_call,
            "diff_quartiles_ms": [1e3 * q for q in statistics.quantiles(
                diffs, n=4)],
            "spans_per_call": n_spans,
            "on_cost_us_per_span": 1e6 * per_call / n_spans}


def site_cost() -> dict:
    """ns a site costs: ``with scope(..)`` and ``with host_sync(..)``
    with no tracer and under one (``_on``), beside an empty ``with`` of
    ``NULL_SPAN``."""
    out = {}
    for name, site in (("scope", lambda: scope("x")),
                       ("host_sync", lambda: host_sync("x")),
                       ("null_with", lambda: NULL_SPAN)):
        for on in (False, True):
            tracer = Tracer(clock=spans.profiler_clock) if on else None
            with tracing(tracer) if on else contextlib.nullcontext():
                t0 = time.perf_counter()
                for _ in range(SITE_CALLS):
                    with site():
                        pass
                took = time.perf_counter() - t0
            out[name + ("_on" if on else "")] = 1e9 * took / SITE_CALLS
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the CPU tests' reduced cell (perfbench.conftest)")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)

    torch.set_num_threads(1)
    harness.import_program()
    from repro_torch.kernels import native

    native.BUILD_ROOT = ROOT / "build" / "repro_torch"
    device = torch.device(args.device)
    cell = harness.resolve(args.workload)
    if args.reduced:
        from perfbench.conftest import shrink

        shrink(cell)
    step, call, queries = program(cell, args.seed, device)
    calls = cell.traffic["trace_calls"]
    for k in range(3):                      # warm: every shape it will use
        call(k)
    trace.TraceSlice(device).warm()
    out = {"workload": args.workload, "seed": args.seed,
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu")}
    if device.type == "cuda":
        out["sync_check"] = [sync_check(step, k, device) for k in (3, 4)]
    ks = list(range(5, 5 + calls))
    plain = profiled(call, ks, device)
    tracer = Tracer(clock=spans.profiler_clock)
    traced = profiled(call, ks, device, tracer)
    out["untraced_slice"] = slice_numbers(plain, calls, queries)
    out["traced_slice"] = slice_numbers(traced, calls, queries)
    out["traced_spans"] = span_numbers(traced, tracer, calls)
    out["cost"] = tracing_cost(call, 1, args.pairs)
    out["site_ns_off"] = site_cost()
    line = json.dumps(out)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
