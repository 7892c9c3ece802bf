"""The serve configuration's runner: one index slice answering batches of
queries under the greedy tabular policy, closed loop, one batch in
flight, the next dispatched when the last one's candidates are on the
host.

Call i serves the pool's variant i (``generate.Inputs.batch``), so
successive calls read different planes and no call can be answered from
the last.  Every answer of the window (each call's candidates, u and
candidate counts, per query) is compared with the plain reference's for
its variant, which the reference works out once from the inputs made
here; the number compared is the count of query rows that differ in any
call (limit ``limits.rows_wrong`` of the configuration file)."""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from perfbench import generate, harness
from perfbench.runners import websearch as ws
from perfbench.trace import TraceSlice

KIND = "serve"
WARM_CALLS = 2


def answers(out):
    """A call's (cand, u, cand_cnt) on the host."""
    return tuple(x.cpu().numpy() for x in out)


def rows_wrong(results, refs) -> int:
    """Rows of every call whose candidates, u or count differ from the
    reference's for the call's variant, ``refs[i % len(refs)]`` (a call
    that returned another shape counts every row)."""
    wrong = 0
    for i, (cand, u, cnt) in enumerate(results):
        want_cand, want_u, want_cnt = refs[i % len(refs)]
        if cand.shape != want_cand.shape or u.shape != want_u.shape \
                or cnt.shape != want_cnt.shape:
            wrong += len(want_u)
            continue
        bad = (cand != want_cand).any(1) | (u != want_u) | (cnt != want_cnt)
        wrong += int(bad.sum())
    return wrong


def program_call(cfg, inp, wrap=None):
    fn = ws.make_program(cfg)
    fn = wrap(fn) if wrap is not None else fn
    bins = ws.program_bins(inp)

    def call(i):
        occ, tp = inp.batch(i)
        return answers(fn(inp.q, bins, occ, inp.scores, tp))
    return call


def reference_answers(cell, inp, dtype=torch.float32):
    """The plain reference's answers for each of the pool's variants."""
    out = []
    for i in range(inp.variants):
        occ, tp = inp.batch(i)
        out.append(cell.reference.serve(cell.config, inp.q, inp.u_edges,
                                        inp.v_edges, occ, inp.scores, tp,
                                        dtype=dtype))
    return out


def run(cell, *, seed: int, seconds: float, trace: bool, device,
        setup_start: float, wrap=None) -> dict:
    cfg, traffic = cell.config, cell.traffic
    b, k = cfg["query_batch"], cfg["max_candidates"]
    marks = ws.Marks(setup_start)
    inp = generate.websearch_inputs(cfg, traffic, seed, device)
    ws.sync(device)
    marks("inputs")
    call = program_call(cfg, inp, wrap)
    tracer = TraceSlice(device) if trace else None
    if tracer is not None:
        tracer.warm()
    for i in range(WARM_CALLS):
        call(i)
    marks("warm calls")
    setup_s = time.perf_counter() - setup_start
    window = ws.run_window(call, seconds, device, tracer, traffic["trace_calls"])
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del call
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    wrong = rows_wrong(window.results, reference_answers(cell, inp))
    limit = cfg["limits"]["rows_wrong"]
    n = len(window.results)
    plane = [float(np.asarray(r[1], dtype=np.int64).sum()) * ws.plane_bytes(cfg)
             for r in window.results]
    out_bytes = b * k * 4 + 2 * b * 4       # cand, u, cand_cnt written once
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {
        "end_to_end": {"serve_qps": n * b / window.seconds,
                       "serve_p95_ms": 1e3 * harness.p95(window.seconds_each),
                       "setup_s": setup_s},
        "attempted": n * b,
        "failed": wrong,
        "checks": {"rows_wrong": {"value": wrong, "limit": limit,
                                  "ok": wrong <= limit}},
        "memory_peak_bytes": peak,
        "layer": ws.layer_context(KIND, window, b,
                                  [p + out_bytes for p in plane], plane, kind),
        "notes": [f"{n} calls of {b} queries ({inp.variants} variants) in "
                  f"{window.seconds:.3f} s; mean u "
                  f"{np.mean([r[1].mean() for r in window.results]):.2f} "
                  f"plane-blocks, mean cand_cnt "
                  f"{np.mean([r[2].mean() for r in window.results]):.2f}; reference "
                  f"{time.perf_counter() - t0:.2f} s", marks.text(),
                  ws.window_note(window), ws.trace_note(window, plane)],
    }
