"""The runner of a row of index slices: ``slices`` index slices on as many
cards, one rank a card, answering each batch of queries together through
the program's mesh path (``build_cell(..., mesh=make_local_mesh(1,
slices))``): every rank runs the rules over its own slice, then the
ranks all-gather their candidates, merge them by static rank and sum u
and cand_cnt.

The harness's process is rank 0 on card 0.  It spawns ranks 1.. on cards
1.., with one process group over a TCP store on localhost.  Every rank
makes its own slice's inputs on its own card (``slice_inputs``) and
hands the program its blocks as DTensors (``DTensor.from_local``), so
that the row's occupancy and scores never lie on one card.  Every rank
runs the same closed loop, one batch in flight across the row: call i
serves the pool's variant i.  Rank 0's clock defines the window and
``serve_qps``, each query counted once.  When it passes the window's
middle (with ``--trace 1``) or its end, rank 0 writes into the store the
call at which the traced calls start (``trace``) or the loop stops
(``stop``), ``LEAD`` calls ahead; the workers look for them every
``CHECK_EVERY`` calls, so the signal adds no collective to a call and no
wait to most calls.

With ``--trace 1`` every rank records the program's spans over 2 x
``trace_calls`` calls on the profiler's clock (the wall clock every
process of the host shares) and ships them to rank 0, which merges them
(``adjust_remote_entries``, a pid a rank); rank 0 profiles card 0 over
the second half of those calls only, since the profiler slows rank 0's
host and would make it the slowest slice.

After the window each rank computes its slice's answers with the plain
reference (``reference/websearch_rl_x4.py``) on its own card; rank 0
merges them and counts the rows of every call that differ, as
``websearch_serve`` does (limit ``limits.rows_wrong``).

A rank that fails ends the run with no result: rank 0's watchdog ends its
process when a worker exits with an error or the run outlives its
deadline, each worker ends itself when rank 0's process is gone, and a
collective that waits longer than ``NCCL_TIMEOUT_S`` ends its rank."""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import gc
import importlib
import os
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import generate, harness, spans, trace
from perfbench.runners import websearch as ws
from perfbench.runners import websearch_serve as one_slice
from perfbench.trace import TraceSlice

KIND = "serve_x4"
WARM_CALLS = 2
CHECK_EVERY = 4             # a worker looks for rank 0's signals every k calls
LEAD = 2 * CHECK_EVERY      # calls between a signal and the call it names
NCCL_TIMEOUT_S = 90         # a collective that waits longer ends its rank
SETUP_LIMIT_S = 600         # the slowest rank's set-up, and every store wait
CHECK_LIMIT_S = 600         # after the window: the reference, the results
WATCH_S = 0.2               # how often rank 0's watchdog looks at the workers
ID_STRIDE = 1 << 40         # a rank's span ids, moved into a range of its own
SEED_MIX = 0x9E3779B97F4A7C15


def slice_seed(seed: int, index: int) -> int:
    """The seed of slice ``index``'s own draws."""
    return ((seed % 2**64) ^ (SEED_MIX * (index + 1))) % 2**64


def slice_inputs(cfg: dict, traffic: dict, seed: int, index: int,
                 device) -> generate.Inputs:
    """Slice ``index``'s inputs, as ``generate.websearch_inputs`` makes a
    slice's: the queries (terms, plane densities, planted counts), the Q
    table and the bins drawn from ``seed`` alone, so that every slice
    has them; its occupancy words, planted documents and scores from
    (seed, index)."""
    shared = torch.Generator(device=device)
    shared.manual_seed(seed % 2**64)
    own = torch.Generator(device=device)
    own.manual_seed(slice_seed(seed, index))
    b, nb = cfg["query_batch"], cfg["n_blocks"]
    pool = max(b, traffic.get("query_pool", b))
    t, f, w = cfg["query_terms_max"], cfg["fields"], cfg["block_docs"] // 32
    lo, hi = traffic["plane_density_log2"]
    k = generate.spread(lo, hi, pool * t * f, shared, device).reshape(
        pool, 1, t, f, 1)
    n_terms = generate.spread(*traffic["query_terms"], pool, shared, device)
    tp = torch.arange(t, device=device)[None] < n_terms[:, None]
    planted = traffic.get("planted")
    if planted:
        n_planted = generate.spread(*planted["docs_per_block"], pool, shared,
                                    device)
    u_edges, v_edges = generate.bin_edges(cfg, device)
    q = generate.served_table(cfg, u_edges, shared, device)
    occ = torch.empty((pool, nb, t, f, w), dtype=torch.int32, device=device)
    for q0 in range(0, pool, generate.OCC_SLICE):
        part = occ[q0:q0 + generate.OCC_SLICE]
        part.fill_(-1)
        kk = k[q0:q0 + generate.OCC_SLICE]
        for i in range(1, hi + 1):
            words = torch.randint(-2**31, 2**31, part.shape, generator=own,
                                  device=device, dtype=torch.int32)
            part &= torch.where(kk >= i, words, -1)
        if planted:
            generate.plant(part, n_planted[q0:q0 + generate.OCC_SLICE],
                           planted, own, cfg["block_docs"])
        part &= torch.where(tp[q0:q0 + generate.OCC_SLICE, None, :, None, None],
                            -1, 0)
    scores = torch.randn((b, nb * cfg["block_docs"]), generator=own,
                         device=device)
    return generate.Inputs(q, u_edges, v_edges, occ, scores, tp, None, None,
                           None, b, traffic.get("pool_stride", b))


def make_program(cfg: dict, mesh):
    """The port's serve cell over the whole row (``slices`` x ``n_blocks``
    blocks, which the mesh path divides by the ``model`` axis)."""
    from repro_torch.launch.steps import build_cell

    row = {**cfg, "n_blocks": cfg["slices"] * cfg["n_blocks"]}
    return build_cell(cfg["program"]["arch"], cfg["program"]["shape"],
                      mesh=mesh, cfg_override=ws.program_cfg(row),
                      shape_params={"query_batch": cfg["query_batch"]})


def program_call(cfg: dict, inp: generate.Inputs, mesh):
    """Call i on this rank: the program over the pool's variant i, this
    rank's occupancy and scores handed over as the DTensors whose local
    blocks they are (placed by the cell's ``in_shardings``); the merged
    (cand, u, cand_cnt) on the host."""
    from torch.distributed.tensor import DTensor

    cell = make_program(cfg, mesh)
    place = [s.placements for s in cell.in_shardings]
    bins = ws.program_bins(inp)
    scores = DTensor.from_local(inp.scores, mesh, place[3], run_check=False)

    def call(i):
        occ, tp = inp.batch(i)
        occ = DTensor.from_local(occ, mesh, place[2], run_check=False)
        out = cell.fn(inp.q, bins, occ, scores, tp)
        # out_shardings split the rows over ``data``, of size 1: the local
        # block is the whole answer
        return tuple(x.to_local().cpu().numpy() for x in out)
    return call


def drop_last_slice(rank: int, world: int):
    """The fault the check has to catch (``calibrate_x4.py``): the last
    slice's candidates dropped before the gather (its rank sends -1s), as
    a row that lost one machine's answers would return.  Applied before
    the program is built, on the rank it names only."""
    from repro_torch.distributed import collectives

    if rank != world - 1:
        return
    gather = collectives.all_gather

    def dropped(x, mesh, axis, dim):
        return gather(torch.full_like(x, -1), mesh, axis, dim)
    collectives.all_gather = dropped


def collectives_now() -> Optional[int]:
    """The program's count of collectives, where the program has one."""
    from repro_torch.obs import trace as obs_trace

    count = getattr(obs_trace, "collectives", None)
    return count() if count is not None else None


def span_tracer():
    from repro_torch.obs import Tracer

    return Tracer(clock=spans.profiler_clock)


def traced(tracer, on: bool):
    from repro_torch.obs import tracing

    return tracing(tracer) if on else contextlib.nullcontext()


def barrier(store, name: str, rank: int, world: int):
    """Every rank at ``name``, over the store: no collective, so a slow
    rank's set-up waits here and not inside NCCL."""
    store.set(f"{name}{rank}", b"1")
    store.wait([f"{name}{r}" for r in range(world)],
               datetime.timedelta(seconds=SETUP_LIMIT_S))


def join_world(rank: int, world: int, store, device):
    """The process group and the 1 x ``world`` mesh, one rank a card."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=NCCL_TIMEOUT_S))
    return make_local_mesh(1, world, device=device.type)


def slice_reference(cell_cfg: dict, reference, inp, dtype) -> list:
    """This slice's plain answers for each of the pool's variants."""
    out = []
    for i in range(inp.variants):
        occ, tp = inp.batch(i)
        out.append(reference.serve(cell_cfg, inp.q, inp.u_edges, inp.v_edges,
                                   occ, inp.scores, tp, dtype=dtype))
    return out


def free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


class Rank:
    """What every rank does, rank 0 included: its slice's inputs and the
    program over them, then its slice's reference answers."""

    def __init__(self, rank: int, world: int, store, cfg: dict, traffic: dict,
                 seed: int, device, drop_slice: bool):
        self.rank, self.world, self.store, self.cfg = rank, world, store, cfg
        self.device = device
        self.mesh = join_world(rank, world, store, device)
        self.inp = slice_inputs(cfg, traffic, seed, rank, device)
        ws.sync(device)
        if drop_slice:
            drop_last_slice(rank, world)
        self.call = program_call(cfg, self.inp, self.mesh)
        self.spans = span_tracer()

    def warm(self):
        barrier(self.store, "ready", self.rank, self.world)
        for i in range(WARM_CALLS):
            self.call(i)

    def peak(self) -> int:
        return (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)

    def reference(self, reference, control: bool) -> dict:
        """This slice's reference answers (and, with ``control``, the
        same in bfloat16), with the program freed first."""
        del self.call
        free(self.device)
        out = {"refs": slice_reference(self.cfg, reference, self.inp,
                                       torch.float32)}
        if control:
            out["control"] = slice_reference(self.cfg, reference, self.inp,
                                             torch.bfloat16)
        return out

    def close(self):
        import torch.distributed as dist

        barrier(self.store, "closed", self.rank, self.world)
        dist.destroy_process_group()


def _watch_parent():
    """End this worker when rank 0's process is gone."""
    import multiprocessing as mp

    parent = mp.parent_process()

    def watch():
        while parent.is_alive():
            time.sleep(WATCH_S)
        os._exit(1)
    threading.Thread(target=watch, daemon=True).start()


def _worker(rank: int, world: int, port: int, cfg: dict, traffic: dict,
            reference_name: str, seed: int, device_type: str,
            drop_slice: bool, control: bool, results):
    """Ranks 1..: the same closed loop as rank 0's, up to the call that
    rank 0's ``stop`` names; after the window, the slice's reference
    answers, peak memory and spans sent to rank 0."""
    import torch.distributed as dist

    try:
        _watch_parent()
        torch.set_num_threads(1)
        harness.import_program()
        from repro_torch.kernels import native

        native.BUILD_ROOT = harness.ROOT / "build" / "repro_torch"
        device = torch.device(device_type, rank if device_type == "cuda" else 0)
        if device.type == "cuda":
            torch.cuda.set_device(device)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        store = dist.TCPStore("127.0.0.1", port, world, is_master=False,
                              timeout=datetime.timedelta(seconds=SETUP_LIMIT_S))
        me = Rank(rank, world, store, cfg, traffic, seed, device, drop_slice)
        me.warm()
        seconds_each, signals = [], Signals(store, traffic["trace_calls"])
        while True:
            i = len(seconds_each)
            if i % CHECK_EVERY == 0:
                signals.look()
            if signals.stop is not None and i >= signals.stop:
                break
            t0 = time.perf_counter()
            with traced(me.spans, signals.traced(i)):
                me.call(i)
            seconds_each.append(time.perf_counter() - t0)
        peak = me.peak()
        out = me.reference(importlib.import_module(reference_name), control)
        found = harness.forbidden_modules()
        if found:
            raise RuntimeError(f"rank {rank} loaded {found}")
        results.put((rank, {"calls": len(seconds_each), "peak": peak,
                            "call_ms": 1e3 * float(np.median(seconds_each)),
                            "spans": me.spans.log.drain_since(0)[0], **out}))
        me.close()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


class Signals:
    """The calls that rank 0 names in the store: the first of the 2 x
    ``trace_calls`` span-traced calls, and the window's end."""

    def __init__(self, store, trace_calls: int):
        self.store, self.span = store, 2 * trace_calls
        self.trace = self.stop = None

    def look(self):
        for key in ("trace", "stop"):
            if getattr(self, key) is None and self.store.check([key]):
                setattr(self, key, int(self.store.get(key)))

    def traced(self, i: int) -> bool:
        return self.trace is not None and self.trace <= i < self.trace + self.span


def _abort(procs, why: str):
    print(f"perfbench: {why}; no result", file=sys.stderr, flush=True)
    for p in procs:
        if p.is_alive():
            p.kill()
    os._exit(1)


class Watchdog(threading.Thread):
    """Ends rank 0's process, with no result, as soon as a worker exits
    with an error or the run outlives ``limit_s`` (rank 0 may be waiting
    inside a collective that the lost rank will never join)."""

    def __init__(self, procs, limit_s: float):
        super().__init__(daemon=True)
        self.procs, self.deadline = procs, time.monotonic() + limit_s
        self.done = threading.Event()

    def run(self):
        while not self.done.wait(WATCH_S):
            for rank, p in enumerate(self.procs, 1):
                if p.exitcode not in (None, 0):
                    _abort(self.procs, f"rank {rank} exited with code "
                                       f"{p.exitcode}")
            if time.monotonic() > self.deadline:
                _abort(self.procs, "the run outlived its deadline")


def lead_window(me: Rank, seconds: float, tracer: Optional[TraceSlice],
                trace_calls: int):
    """Rank 0's window: ``run_window``'s closed loop.  Past the window's
    middle (with a tracer) it names the first span-traced call in the
    store, past its end the call that ends the loop, each ``LEAD`` calls
    ahead.  Every rank records spans over 2 x ``trace_calls`` calls, of
    which card 0 is profiled over the second half only (the profiler
    slows rank 0's host, so the first half shows the slices' skew as it
    is untraced).  Returns the window with ``traced`` marking the
    profiled calls, which calls were span-traced, the collectives those
    made on rank 0, and the union of card 0's NCCL kernels in the
    profiled calls."""
    store = me.store
    times, results, profiled, spanned = [], [], [], []
    launches = ws.chunk_launches()
    plan = Signals(store, trace_calls)
    count = {"start": None, "end": None}
    nccl_s = None
    begin = time.perf_counter()
    while plan.stop is None or len(results) < plan.stop:
        i = len(results)
        on = plan.traced(i)
        if on and i == plan.trace:
            count["start"] = collectives_now()
        if on and i == plan.trace + trace_calls:
            tracer.start()
        t0 = time.perf_counter()
        with traced(me.spans, on):
            results.append(me.call(i))
        t1 = time.perf_counter()
        times.append(t1 - t0)
        spanned.append(on)
        profiled.append(on and i >= plan.trace + trace_calls)
        if on and i == plan.trace + 2 * trace_calls - 1:
            tracer.stop()
            count["end"] = collectives_now()
            nccl_s = nccl_busy_s(tracer.prof)
        if tracer is not None and plan.trace is None \
                and t1 - begin >= seconds / 2:
            plan.trace = i + 1 + LEAD
            store.set("trace", str(plan.trace))
        if plan.stop is None and t1 - begin >= seconds:
            plan.stop = i + 1 + LEAD
            if plan.trace is not None:
                plan.stop = max(plan.stop, plan.trace + 2 * trace_calls)
            store.set("stop", str(plan.stop))
    end = time.perf_counter()
    summary = tracer.summary() if tracer is not None and any(profiled) else None
    window = ws.Window(times, results, profiled, end - begin, summary,
                       ws.chunk_launches() - launches)
    per_call = (None if None in count.values()
                else count["end"] - count["start"])
    return window, spanned, per_call, nccl_s


def nccl_busy_s(prof) -> Optional[float]:
    """The union of card 0's NCCL kernels' intervals in the traced slice
    (s), or None where none ran."""
    busy = [(s, e) for name, on_dev, s, e, _ in trace._raw_events(prof)
            if on_dev and "nccl" in name.lower()]
    return trace.union_busy(busy)[1] / 1e6 if busy else None


def rollouts(entries: List[dict], rank: int) -> List[tuple]:
    """Rank ``rank``'s ``rollout`` spans (start, end), one a span-traced
    call, in call order."""
    pid = rank or None          # rank 0's own entries carry no pid
    return sorted((e["t0"], e["t1"]) for e in entries
                  if e["kind"] == "span" and e["name"] == "rollout"
                  and e.get("pid") == pid)


def skew_shares(runs: List[List[tuple]], call_s: List[float]) -> List[float]:
    """Per call of ``call_s`` (the first span-traced ones), 100 x the
    spread of the ranks' ``rollout`` durations (``runs``, a list a rank;
    each from its own rank's start, so that a rank that starts late does
    not count) over the call's wall time (rank 0's host clock)."""
    if any(len(r) < len(call_s) for r in runs):
        return []
    return [100.0 * (max(r[k][1] - r[k][0] for r in runs)
                     - min(r[k][1] - r[k][0] for r in runs)) / s
            for k, s in enumerate(call_s)]


def lags_ms(runs: List[List[tuple]]) -> List[List[float]]:
    """Per rank, the median over the calls of ``runs`` of how far its
    ``rollout`` started and ended after the first rank's (ms), for the
    run's log: which slice the row waits for, and whether it started
    late or ran long."""
    n = min(map(len, runs))
    out = []
    for r in runs if n else []:
        lag = [[1e3 * (r[k][j] - min(x[k][j] for x in runs)) for k in range(n)]
               for j in (0, 1)]
        out.append([round(float(np.median(x)), 3) for x in lag])
    return out


def merged_spans(own: List[dict], shipped: Dict[int, List[dict]]) -> List[dict]:
    """Every rank's spans on one time line (one clock, so no shift), each
    worker's ids moved into a range of its own and its entries marked
    with its rank as pid."""
    from repro_torch.obs import adjust_remote_entries

    out = list(own)
    for rank, entries in sorted(shipped.items()):
        out += adjust_remote_entries(entries, id_offset=rank * ID_STRIDE,
                                     pid=rank)
    return out


def run(cell, *, seed: int, seconds: float, trace: bool, device,
        setup_start: float, drop_slice: bool = False,
        control: bool = False) -> dict:
    """One run of the row (see the module's text).  ``drop_slice``
    (``drop_last_slice``) and ``control`` (the reference in bfloat16 as
    well) are for the check's readings (``calibrate_x4.py``), never a
    benchmark run."""
    import multiprocessing as mp

    import torch.distributed as dist

    cfg, traffic = cell.config, cell.traffic
    world = cfg["slices"]
    if cfg["mesh"] != {"data": 1, "model": world}:
        raise ValueError(f"the row's mesh is 1 x {world}: {cfg['mesh']}")
    marks = ws.Marks(setup_start)
    torch.set_num_threads(1)            # as every worker
    store = dist.TCPStore("127.0.0.1", 0, world, is_master=True,
                          timeout=datetime.timedelta(seconds=SETUP_LIMIT_S),
                          wait_for_workers=False)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_worker, daemon=True,
                         args=(rank, world, store.port, cfg, traffic,
                               cell.reference.__name__, seed, device.type,
                               drop_slice, control, results))
             for rank in range(1, world)]
    for p in procs:
        p.start()
    watchdog = Watchdog(procs, SETUP_LIMIT_S + seconds + CHECK_LIMIT_S)
    watchdog.start()
    try:
        out = _lead(cell, seed, seconds, trace, device, marks, store, results,
                    drop_slice, control)
        for p in procs:
            p.join(timeout=CHECK_LIMIT_S)
        watchdog.done.set()
        return out
    except BaseException:
        traceback.print_exc()
        _abort(procs, "rank 0 failed")


def _lead(cell, seed, seconds, trace, device, marks, store, results,
          drop_slice, control) -> dict:
    cfg, traffic = cell.config, cell.traffic
    world, b, k = cfg["slices"], cfg["query_batch"], cfg["max_candidates"]
    me = Rank(0, world, store, cfg, traffic, seed, device, drop_slice)
    marks("inputs and program")
    tracer = TraceSlice(device) if trace else None
    if tracer is not None:
        tracer.warm()
    me.warm()
    marks("warm calls")
    setup_s = time.perf_counter() - marks.start
    window, spanned, coll_traced, nccl_s = lead_window(
        me, seconds, tracer, traffic["trace_calls"])
    peak = me.peak()
    t0 = time.perf_counter()
    own = me.reference(cell.reference, control)
    shipped = {}
    while len(shipped) < world - 1:
        rank, payload = results.get(timeout=CHECK_LIMIT_S)
        shipped[rank] = payload
    me.close()
    n = len(window.results)
    for rank, payload in shipped.items():
        if payload["calls"] != n:
            raise RuntimeError(f"rank {rank} made {payload['calls']} calls of "
                               f"the window's {n}")
    slice_docs = cfg["n_blocks"] * cfg["block_docs"]

    def row_answers(key):
        by_rank = [own[key]] + [shipped[r][key] for r in range(1, world)]
        return [cell.reference.merge([x[v] for x in by_rank], slice_docs, k)
                for v in range(me.inp.variants)]

    refs = row_answers("refs")
    wrong = one_slice.rows_wrong(window.results, refs)
    limit = cfg["limits"]["rows_wrong"]
    plane = [float(np.asarray(r[1], dtype=np.int64).sum()) * ws.plane_bytes(cfg)
             for r in window.results]
    out_bytes = b * k * 4 + 2 * b * 4
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    steps = [p + out_bytes for p in plane]
    # the untraced calls are those without spans; the traced slice's
    # counts are the profiled calls'
    layer = ws.layer_context(KIND, dataclasses.replace(window, traced=spanned),
                             b, steps, plane, kind)
    profiled = ws.layer_context(KIND, window, b, steps, plane, kind)
    for key in ("traced_calls", "traced_queries", "traced_plane_bytes"):
        setattr(layer, key, getattr(profiled, key))
    hot = [s for s, on in zip(window.seconds_each, spanned) if on]
    entries = merged_spans(me.spans.log.drain_since(0)[0],
                           {r: p["spans"] for r, p in shipped.items()})
    runs = [rollouts(entries, r) for r in range(world)]
    first = len(hot[:traffic["trace_calls"]])     # the unprofiled ones
    layer.cards = world
    layer.collective_busy_s = nccl_s
    layer.skew_shares = skew_shares(runs, hot[:first])
    layer.spanned_calls = len(hot)
    layer.collectives_traced = coll_traced
    layer.spans = entries
    counts = {x: sum(e["name"] == x for e in entries)
              for x in sorted({e["name"] for e in entries})}
    peaks = [peak] + [shipped[r]["peak"] for r in range(1, world)]
    call_ms = [round(1e3 * float(np.median(window.seconds_each)), 3)] + [
        round(shipped[r]["call_ms"], 3) for r in range(1, world)]
    out = {
        "end_to_end": {"serve_qps": n * b / window.seconds,
                       "serve_p95_ms": 1e3 * harness.p95(window.seconds_each),
                       "setup_s": setup_s},
        "attempted": n * b,
        "failed": wrong,
        "checks": {"rows_wrong": {"value": wrong, "limit": limit,
                                  "ok": wrong <= limit}},
        "memory_peak_bytes": max(peaks),
        "layer": layer,
        "notes": [f"{n} calls of {b} queries ({me.inp.variants} variants) "
                  f"over {world} slices in {window.seconds:.3f} s; mean u "
                  f"{np.mean([r[1].mean() for r in window.results]):.2f} "
                  f"plane-blocks, mean cand_cnt "
                  f"{np.mean([r[2].mean() for r in window.results]):.2f}; "
                  f"reference {time.perf_counter() - t0:.2f} s", marks.text(),
                  ws.window_note(window), ws.trace_note(window, plane),
                  f"peak bytes by rank {peaks}",
                  f"rollout start and end lags by rank (ms, medians of the "
                  f"unprofiled span-traced calls) "
                  f"{lags_ms([r[:first] for r in runs])}, profiled "
                  f"{lags_ms([r[first:] for r in runs])}",
                  f"median call ms by rank {call_ms}",
                  f"merged spans: {len(entries)} of {counts}"],
    }
    if control:
        out["control"] = {"rows_wrong": one_slice.rows_wrong(
            row_answers("control"), refs), "rows": len(refs) * b}
    return out
