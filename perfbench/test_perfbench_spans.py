"""The program's spans over a profiled slice (``spans.py``) on the CPU:
the clock that lays them on the profiler's events, their paths, the
idle time and gaps they name, and the shares read from them."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from perfbench import generate, spans, trace
from perfbench.runners import websearch as ws

TOL_US = 5.0


def iv(name, path, start, end):
    return spans.Interval(name, path, float(start), float(end))


def marker_events(prof, name):
    return sorted((e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3)
                  for e in prof.profiler.kineto_results.events()
                  if e.name() == name)


def test_the_profiler_clock_holds_a_marker():
    """A span stamped on ``profiler_clock`` around a ``record_function``
    marker holds the marker's profiler event to within 5 µs."""
    from repro_torch.obs import Tracer, scope, tracing

    tracer = Tracer(clock=spans.profiler_clock)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(20):
            with tracing(tracer), scope("probe", i=i):
                with record_function("marker"):
                    torch.ones(64).add_(1)
    marks = marker_events(prof, "marker")
    got = [i for i in spans.intervals(tracer.log.snapshot())
           if i.name == "probe"]
    assert len(marks) == len(got) == 20
    for span, (start, end) in zip(got, marks):
        assert span.start <= start + TOL_US and span.end >= end - TOL_US


def test_a_program_call_holds_its_host_ops(small, cpu):
    """Under a tracer on the profiler's clock, the host ops of a reduced
    serve call lie inside its program spans, each ``aten::`` op in the
    innermost span that holds it."""
    from repro_torch.obs import Tracer, tracing

    cell = small("ws16m-serve-cat1")
    inp = generate.websearch_inputs(cell.config, cell.traffic, 2**31 + 5, cpu)
    fn, bins = ws.make_program(cell.config), ws.program_bins(inp)
    occ, tp = inp.batch(0)
    fn(inp.q, bins, occ, inp.scores, tp)
    tracer = Tracer(clock=spans.profiler_clock)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing(tracer):
            fn(inp.q, bins, occ, inp.scores, tp)
    got = spans.intervals(tracer.log.snapshot())
    ops = [(s, e) for name, on_dev, s, e, _ in trace._raw_events(prof)
           if name.startswith("aten::") and not on_dev]
    held = [spans.covering(got, 0.5 * (s + e)) for s, e in ops]
    assert ops and sum(h is not None for h in held) >= 0.99 * len(ops)
    paths = {h.path for h in held if h is not None}
    assert "rollout/step/rule/chunk" in paths and "rollout/step/act" in paths


def test_intervals_carry_paths_and_the_innermost_covers():
    entries = [
        {"kind": "span", "name": "rule", "id": 3, "parent": 2, "t0": 2e-6,
         "t1": 8e-6, "track": "t", "args": None},
        {"kind": "span", "name": "rollout", "id": 1, "parent": None,
         "t0": 0.0, "t1": 1e-5, "track": "t", "args": None},
        {"kind": "span", "name": "step", "id": 2, "parent": 1, "t0": 1e-6,
         "t1": 9e-6, "track": "t", "args": None},
        {"kind": "instant", "name": "x", "id": None, "parent": 1, "t0": 0.0,
         "t1": 0.0, "track": "t", "args": None},
    ]
    got = spans.intervals(entries)
    assert [(i.path, i.start, i.end) for i in got] == [
        ("rollout", 0.0, 10.0), ("rollout/step", 1.0, 9.0),
        ("rollout/step/rule", 2.0, 8.0)]
    assert spans.covering(got, 5.0).path == "rollout/step/rule"
    assert spans.covering(got, 0.5).name == "rollout"
    assert spans.covering(got, 11.0) is None


MERGED = [[0.0, 10.0], [20.0, 30.0], [50.0, 60.0]]
HOST = [("cudaLaunchKernel", 18.0, 19.0),
        ("cudaStreamSynchronize", 31.0, 49.0)]
SPANS = [iv("rollout", "rollout", 5.0, 55.0),
         iv("step", "rollout/step", 6.0, 54.0),
         iv("act", "rollout/step/act", 11.0, 15.0),
         iv("sync", "rollout/step/rule/sync", 32.0, 48.0),
         iv("rule", "rollout/step/rule", 25.0, 53.0)]


def test_idle_gaps_without_spans_are_the_trace_s():
    want = trace.idle_gaps(MERGED, HOST, 0.0, 70.0)
    assert spans.idle_gaps(MERGED, HOST, 0.0, 70.0) == want
    assert spans.idle_gaps(MERGED, HOST, 0.0, 70.0, spans=[]) == want
    far = [iv("rollout", "rollout", 100.0, 200.0)]
    assert spans.idle_gaps(MERGED, HOST, 0.0, 70.0, spans=far) == want


def test_idle_gaps_are_named_by_their_innermost_span():
    got = spans.idle_gaps(MERGED, HOST, 0.0, 70.0, spans=SPANS)
    want = trace.idle_gaps(MERGED, HOST, 0.0, 70.0)
    assert [s for _, s in got] == [s for _, s in want]
    assert [n for n, _ in got] == [
        "rollout/step/rule/sync · cudaStreamSynchronize",
        "rollout/step/act · host, then cudaLaunchKernel",
        "host"]


def test_idle_time_by_innermost_span_sums_to_the_idle_time():
    over = [("Activity_Buffer_Request", 40.0, 42.0)]
    got = spans.idle_by_span(MERGED, SPANS, 0.0, 70.0, over)
    assert got == pytest.approx({
        "act": 4e-6, "step": 6e-6, "sync": 14e-6,
        "Activity_Buffer_Request": 2e-6, "rule": 4e-6, "outside": 10e-6})
    idle = sum(e - s for s, e in spans.idle(MERGED, 0.0, 70.0))
    assert sum(got.values()) == pytest.approx(idle / 1e6)


def test_the_shares_read_from_spans():
    assert spans.sync_wait_share(SPANS, 1e-4) == pytest.approx(16.0)
    # idle inside rollout [5, 55]: 10-20 and 30-50
    assert spans.loop_idle_share(SPANS, MERGED, 1e-4) == pytest.approx(30.0)
    train = [iv("train_batch", "train_batch", 0.0, 70.0)] + SPANS
    assert spans.loop_idle_share(train, MERGED, 1e-4) == pytest.approx(40.0)


def test_the_shares_are_none_with_nothing_to_read():
    no_sync = [i for i in SPANS if i.name != "sync"]
    assert spans.sync_wait_share([], 1.0) is None
    assert spans.sync_wait_share(no_sync, 1.0) is None
    assert spans.sync_wait_share(SPANS, 0.0) is None
    assert spans.loop_idle_share([], MERGED, 1.0) is None
    assert spans.loop_idle_share(SPANS[1:], MERGED, 1.0) is None
    assert spans.loop_idle_share(SPANS, MERGED, 0.0) is None
