"""The row cell's runner and reference on the CPU at the reduced width: a
gloo world of four ranks that the runner spawns itself, as on the cards.
A sound traced run is correct and reads its layers; the check catches a
dropped slice; a rank that dies ends the run at once, with no result.
Each run is its own process, with a hard timeout."""
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest

from perfbench import harness
from perfbench.reference import websearch_rl_x4 as reference

CELL = "ws67m-serve-cat1-x4"
TIMEOUT_S = 240
RUN = """
import json, sys, threading, time
import torch
from perfbench import harness
from perfbench.conftest import shrink

def main(seconds, trace, drop_slice, kill_at):
    torch.set_num_threads(1)
    harness.import_program()
    cell = shrink(harness.resolve({cell!r}))
    if kill_at:
        def kill():
            time.sleep(kill_at)
            import multiprocessing
            workers = multiprocessing.active_children()
            print("workers", *[w.pid for w in workers], file=sys.stderr, flush=True)
            workers[-1].kill()
        threading.Thread(target=kill, daemon=True).start()
    out = cell.runner.run(cell, seed=2**31 + 707, seconds=seconds, trace=trace,
                          device=torch.device("cpu"), setup_start=time.perf_counter(),
                          drop_slice=drop_slice)
    layer = out["layer"]
    print(json.dumps({{"checks": out["checks"], "attempted": out["attempted"],
                      "metrics": harness.read_per_layer(cell, layer),
                      "calls": [layer.traced_calls, layer.spanned_calls,
                                cell.traffic["trace_calls"]],
                      "spans": sorted({{(e["name"], e.get("pid") or 0)
                                       for e in layer.spans}})}}))

if __name__ == "__main__":
    main(*json.loads(sys.argv[1]))
""".format(cell=CELL)


def run_row(tmp_path, seconds, trace=False, drop_slice=False, kill_at=None):
    script = tmp_path / "row.py"
    script.write_text(RUN)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(script), json.dumps([seconds, trace, drop_slice, kill_at])],
        capture_output=True, text=True, timeout=TIMEOUT_S, cwd=harness.ROOT,
        env={**os.environ, "PYTHONPATH": f"{harness.ROOT}:{harness.SRC_DIR}",
             "OMP_NUM_THREADS": "1"})
    return proc, time.perf_counter() - t0


def test_a_traced_run_of_the_row_is_correct_and_reads_its_layers(tmp_path):
    proc, _ = run_row(tmp_path, 1.0, trace=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["checks"]["rows_wrong"] == {"value": 0, "limit": 0, "ok": True}
    metrics = out["metrics"]
    # the traced slice's counts are the profiled calls', half the span-traced
    profiled, spanned, trace_calls = out["calls"]
    assert profiled == trace_calls and spanned == 2 * trace_calls
    assert metrics["collectives_per_call.serve"]["value"] == 3.0
    assert 0.0 <= metrics["slice_skew_share.serve"]["value"] < 100.0
    # no card: no roofline and no NCCL kernel to read
    assert "mesh_step_roofline.serve" not in metrics
    assert "collective_share.serve" not in metrics
    spans = {tuple(s) for s in out["spans"]}
    for rank in range(4):
        for name in ("rollout", "shard_serve", "gather", "merge", "reduce",
                     "collective"):
            assert (name, rank) in spans


def test_the_check_catches_a_dropped_slice(tmp_path):
    proc, _ = run_row(tmp_path, 0.5, drop_slice=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    check = out["checks"]["rows_wrong"]
    assert not check["ok"] and check["value"] > out["attempted"] // 2


def test_a_lost_rank_ends_the_run_at_once_with_no_result(tmp_path):
    """A worker killed in the middle of a 60 s window: rank 0 is waiting
    in a collective that the lost rank will never join; its watchdog ends
    the run long before the window would have."""
    proc, took = run_row(tmp_path, 60.0, kill_at=12.0)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "no result" in proc.stderr
    assert took < 45.0
    pids = [int(p) for line in proc.stderr.splitlines()
            if line.startswith("workers ") for p in line.split()[1:]]
    assert len(pids) == 3
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and any(map(alive, pids)):
        time.sleep(0.2)
    assert not any(map(alive, pids))     # no worker outlives the run


def alive(pid: int) -> bool:
    """Whether ``pid`` runs (a zombie has ended)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_the_skew_is_the_spread_of_the_ranks_rollout_durations():
    """A rank that starts a call late but runs its rules as long as the
    others adds no skew; one that runs 2 ms longer adds 2 ms."""
    from perfbench.runners import websearch_serve_x4 as row

    runs = [[(0.0, 0.010), (1.0, 1.010)], [(0.003, 0.013), (1.0, 1.012)]]
    assert row.skew_shares(runs, [0.02, 0.02]) == pytest.approx([0.0, 10.0])
    assert row.skew_shares(runs, [0.02, 0.02, 0.02]) == []


def test_the_reference_merges_by_static_rank():
    """Ids offset by slice, the pads dropped, the K smallest kept in order
    and padded; u and counts summed."""
    a = (np.array([[3, 1, -1], [-1, -1, -1]]), np.array([5, 1]), np.array([2, 0]))
    b = (np.array([[0, 2, -1], [4, -1, -1]]), np.array([7, 2]), np.array([2, 1]))
    cand, u, cnt = reference.merge([a, b], 10, 3)
    np.testing.assert_array_equal(cand, [[1, 3, 10], [14, -1, -1]])
    np.testing.assert_array_equal(u, [12, 3])
    np.testing.assert_array_equal(cnt, [4, 1])
    cand, _, _ = reference.merge([a, b], 10, 8)
    np.testing.assert_array_equal(cand[0], [1, 3, 10, 12, -1, -1, -1, -1])


@pytest.mark.parametrize("name", ["mesh_step_roofline.serve",
                                  "collective_share.serve",
                                  "slice_skew_share.serve",
                                  "collectives_per_call.serve"])
def test_the_row_readers_read_nothing_outside_the_row(name):
    reader = harness.metric_reader(name)
    one_card = SimpleNamespace(kind="serve", mean_call_s=0.02, step_bytes=1e6,
                               hbm_bytes_per_s=3.35e12, trace=None,
                               traced_calls=4)
    assert reader.read(one_card) is None
    row = SimpleNamespace(kind="serve_x4", mean_call_s=0.02, step_bytes=1e6,
                          hbm_bytes_per_s=3.35e12, cards=4, trace=None,
                          traced_calls=4, collective_busy_s=None,
                          skew_shares=[], collectives_traced=None,
                          spanned_calls=8)
    value = reader.read(row)
    if name == "mesh_step_roofline.serve":
        assert value == pytest.approx(100.0 * 1e6 / (0.02 * 4 * 3.35e12))
    else:
        assert value is None
