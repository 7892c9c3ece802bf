"""The yardstick on the CPU at the reduced width: the inputs, the plain
reference against the port, the check that decides ``correct`` against
the control and the planted faults, the trace arithmetic and the readers,
and a run that loads no JAX."""
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from perfbench import faults, generate, harness, readers, trace

SERVE = ("ws16m-serve-cat1", "ws16m-serve-cat2")
LEARN = "ws16m-learn-cat1"


def run(cell, cpu, wrap=None, seconds=0.2, seed=2**31 + 11):
    return cell.runner.run(cell, seed=seed, seconds=seconds, trace=False,
                           device=cpu, setup_start=0.0, wrap=wrap)


@pytest.mark.parametrize("name", SERVE + (LEARN,))
def test_inputs_are_the_seeds_bytes(small, cpu, name):
    cell = small(name)
    cfg, traffic = cell.config, cell.traffic
    a = generate.websearch_inputs(cfg, traffic, 2**31 + 3, cpu, draw_steps=4)
    b = generate.websearch_inputs(cfg, traffic, 2**31 + 3, cpu, draw_steps=4)
    c = generate.websearch_inputs(cfg, traffic, 2**31 + 4, cpu, draw_steps=4)
    for field in ("q", "u_edges", "v_edges", "occ", "scores", "term_present",
                  "prod_rewards", "explore", "uniform"):
        assert torch.equal(getattr(a, field), getattr(b, field)), field
    assert not torch.equal(a.occ, c.occ)
    # every seed the same set of sizes: the term counts agree as a multiset
    assert torch.equal(a.term_present.sum(1).sort().values,
                       c.term_present.sum(1).sort().values)
    # successive calls take other queries of the pool, as views
    assert a.variants == 3
    occ0, tp0 = a.batch(0)
    occ1, _ = a.batch(1)
    assert occ0.shape[0] == cfg["query_batch"] and occ0.data_ptr() == a.occ.data_ptr()
    assert occ1.data_ptr() != occ0.data_ptr() and torch.equal(a.batch(3)[0], occ0)


def test_cat1_plants_documents_that_hold_every_term(small, cpu):
    """Every CAT1 query has, in every block, at least the fewest planted
    documents that hold all its present terms in the body."""
    cell = small("ws16m-serve-cat1")
    inp = generate.websearch_inputs(cell.config, cell.traffic, 2**31 + 9, cpu)
    body = generate.FIELDS.index("body")
    both = torch.full(inp.occ.shape[:2] + inp.occ.shape[-1:], -1,
                      dtype=torch.int32)
    for t in range(inp.occ.shape[2]):
        present = inp.term_present[:, t, None, None]
        both &= torch.where(present, inp.occ[:, :, t, body], -1)
    bits = sum(((both >> i) & 1).sum(-1) for i in range(32))
    assert int(bits.min()) >= cell.traffic["planted"]["docs_per_block"][0]
    assert int(inp.term_present.sum(1).min()) == cell.traffic["query_terms"][0]


def test_the_served_table_stops_late_and_resets_in_its_states(small, cpu):
    """Stop wins from the stated u stratum on, reset in every stated v bin
    below it, neither at the start state; the same states every seed."""
    cell = small("ws16m-serve-cat2")
    cfg, k = cell.config, cell.config["k_rules"]
    tables = [generate.websearch_inputs(cfg, cell.traffic, s, cpu).q
              for s in (2**31 + 1, 2**31 + 2)]
    best = [q.argmax(1) for q in tables]
    assert torch.equal(best[0] >= k, best[1] >= k)
    assert int(best[0][0]) < k
    assert (best[0] == k).any() and (best[0] == k + 1).any()
    assert not torch.equal(tables[0], tables[1])


def test_every_seed_serves_the_same_rule_in_each_state(small, cpu):
    """The seed draws the table's values, not its order: each state's best
    rule, and so the work a query does, is the same for every seed, while
    the gaps between the rules differ."""
    cell = small("ws16m-serve-cat1")
    cfg, k = cell.config, cell.config["k_rules"]
    tables = [generate.websearch_inputs(cfg, cell.traffic, s, cpu).q[:, :k]
              for s in (2**31 + 3, 2**31 + 4)]
    assert torch.equal(tables[0].argsort(1), tables[1].argsort(1))
    assert not torch.equal(tables[0], tables[1])
    assert len(set(tables[0].argmax(1).tolist())) == k


def test_spread_takes_each_value_equally_often(cpu):
    gen = torch.Generator().manual_seed(1)
    values = generate.spread(10, 13, 4096, gen, cpu)
    assert torch.bincount(values)[10:].tolist() == [1024] * 4


@pytest.mark.parametrize("name", SERVE)
def test_reference_equals_the_ports_reference_backend(small, cpu, name):
    """The plain reference's answers equal those of the port's
    ``reference`` scan backend (one block a step) and of its chunked
    ``block_scan`` backend, bit for bit."""
    cell = small(name, batch=32)
    inp = generate.websearch_inputs(cell.config, cell.traffic, 2**31 + 21, cpu)
    want = cell.runner.reference_answers(cell, inp)
    for backend in ("reference", "block_scan"):
        cell.config["program"]["backend"] = backend
        call = cell.runner.program_call(cell.config, inp)
        got = [call(i) for i in range(inp.variants)]
        assert cell.runner.rows_wrong(got, want) == 0, backend
    assert min(int(w[1].min()) for w in want) > 0
    assert min(float(w[2].mean()) for w in want) > 1.0     # candidates found


def test_reference_follows_the_ports_train_batch(small, cpu):
    """Three learner steps of the port's ``train_batch`` from the init and
    a late one from the port's own Q, against the plain reference's:
    every compared number well inside its limit."""
    cell = small(LEARN, batch=32)
    drv = cell.runner
    inp = generate.websearch_inputs(cell.config, cell.traffic, 2**31 + 31, cpu,
                                    draw_steps=8)
    step = drv.program_step(cell.config, inp)
    got_q, got_m = drv.check_steps(step, inp.q)
    q = got_q[-1]
    for k in range(drv.CHECK_STEPS, 6):
        q, _ = step(q, k)
    late = drv.Late(6, q.clone(), *drv.late_step(step, drv.Late(6, q, q, {})))
    want = drv.reference_steps(cell, inp, late)
    found = drv.gaps(inp.q, late, drv.Steps(got_q, got_m, late.q_out,
                                            late.metrics), want)
    assert set(found) == set(cell.config["limits"])
    for name, value in found.items():
        assert value <= cell.config["limits"][name] / 2, (name, value)
    for g, w in zip(got_m + [late.metrics], want.metrics + [want.late_metrics]):
        assert g["mean_u"] == w["mean_u"] and g["mean_v"] == w["mean_v"]
    assert any(w["mean_cand"] > 0 for w in want.metrics)


@pytest.mark.parametrize("name", SERVE + (LEARN,))
def test_a_sound_run_is_correct(small, cpu, name):
    out = run(small(name), cpu)
    assert all(c["ok"] for c in out["checks"].values()), out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


@pytest.mark.parametrize("seed", [2**31 + 41, 2**31 + 42, 2**31 + 43])
def test_the_bf16_control_fails_the_serve_check(small, cpu, seed):
    """The plain reference in bfloat16 in the program's place: the Q
    table's argmax and the state bins move, and so do answers (of the
    pool's 256 queries: the cell's 1,280)."""
    cell = small("ws16m-serve-cat2", batch=128)
    out = run(cell, cpu, faults.serve_control(cell.reference, cell.config),
              seed=seed)
    assert not out["checks"]["rows_wrong"]["ok"]


def test_the_bf16_control_fails_the_learner_check(small, cpu):
    cell = small(LEARN, batch=32)
    out = run(cell, cpu, faults.learn_control(cell.reference, cell.config))
    assert not all(c["ok"] for c in out["checks"].values())
    assert out["failed"] > 0


@pytest.mark.parametrize("fault", sorted(faults.SERVE))
@pytest.mark.parametrize("name", SERVE)
def test_a_planted_serve_fault_fails_the_check(small, cpu, name, fault):
    out = run(small(name), cpu, faults.SERVE[fault])
    assert not out["checks"]["rows_wrong"]["ok"]
    assert out["failed"] > 0


@pytest.mark.parametrize("fault", sorted(faults.LEARN))
def test_a_planted_learner_fault_fails_the_check(small, cpu, fault):
    out = run(small(LEARN, batch=16), cpu, faults.LEARN[fault])
    assert not all(c["ok"] for c in out["checks"].values()), out["checks"]


def test_leaf_gap_reads_one_for_an_unchanged_step():
    from perfbench.runners import websearch_learn as drv

    dq = torch.randn(50, 8)

    assert drv.leaf_gap(torch.zeros_like(dq), dq) == pytest.approx(1.0)
    assert drv.leaf_gap(dq, dq) == 0.0


def test_union_and_gaps_of_device_intervals():
    merged, busy = trace.union_busy([(0, 10), (5, 12), (20, 30), (29, 31)])
    assert merged == [[0, 12], [20, 31]] and busy == 23
    host = [("aten::add", 12, 18), ("cudaLaunchKernel", 14, 16),
            ("aten::sum", 36, 40)]
    gaps = trace.idle_gaps(merged, host, 0, 40)
    assert gaps == [("host, then aten::sum", 9e-6), ("cudaLaunchKernel", 8e-6)]


def test_a_traced_slice_reads_the_profilers_events(cpu):
    """The profiler's own events, read as the card's are: on the CPU no
    device operation, and a window of the slice's length."""
    tracer = trace.TraceSlice(cpu)
    tracer.warm()
    tracer.start()
    torch.ones(1000).add_(1).sum()
    tracer.stop()
    got = tracer.summary()
    assert got.window_s > 0 and got.busy_s == 0.0 and got.device_s == {}


def summary(**kw):
    base = dict(window_s=1.0, busy_s=0.25, device_s={
        "void block_scan_pruned_chunk_kernel<true, false>": 0.01, "fill": 0.2},
        device_n={}, launches=5120, runtime_events=6000, idle_gaps=[])
    base.update(kw)
    return trace.TraceSummary(**base)


def context(kind="serve", tr=None, hbm=3.35e12):
    return SimpleNamespace(kind=kind, mean_call_s=0.05, p95_call_s=0.06,
                           step_bytes=1e7,
                           trace=tr, traced_calls=2, traced_queries=512,
                           traced_plane_bytes=2e7, hbm_bytes_per_s=hbm)


def test_readers_read_their_kind_and_nothing_else():
    ctx = context(tr=summary())
    assert readers.step_roofline(ctx, "serve") == pytest.approx(
        100 * 1e7 / (0.05 * 3.35e12))
    assert readers.kernel_roofline(ctx, "serve", "block_scan_pruned_chunk") == \
        pytest.approx(100 * 2e7 / (0.01 * 3.35e12))
    assert readers.launches_per_query(ctx, "serve") == 10.0
    assert readers.idle_share(ctx, "serve") == pytest.approx(75.0)
    assert readers.call_p95_ms(ctx, "serve") == pytest.approx(60.0)
    for read in (readers.step_roofline, readers.launches_per_query,
                 readers.idle_share, readers.call_p95_ms):
        assert read(ctx, "learn") is None


def test_readers_return_nothing_where_there_is_nothing_to_read():
    assert readers.kernel_roofline(context(), "serve", "x") is None
    assert readers.kernel_roofline(context(tr=summary()), "serve", "absent") is None
    assert readers.step_roofline(context(hbm=None), "serve") is None
    assert readers.idle_share(context(tr=summary(busy_s=0.0)), "serve") is None
    assert readers.launches_per_query(
        context(tr=summary(runtime_events=0)), "serve") is None


@pytest.mark.parametrize("name", ["step_roofline.serve", "device_idle_share.learn",
                                  "call_p95_ms.serve"])
def test_metric_files_read_through_the_readers(name):
    kind = name.rsplit(".", 1)[1]
    value = harness.metric_reader(name).read(context(kind, summary()))
    assert value is not None and 0 < value <= 100


def test_p95_is_by_nearest_rank():
    assert harness.p95(list(range(1, 101))) == 95
    assert harness.p95([3.0]) == 3.0


def test_a_run_loads_no_jax():
    """The harness, the reference, the readers and a run of the program's
    cell at the reduced width load no module whose top-level name is
    jax, jaxlib, flax or repro (compared whole: repro_torch is not repro)."""
    code = """
import sys
sys.path.insert(0, sys.argv[1])
import torch
from perfbench import harness, faults, calibrate, readers, trace
from perfbench.conftest import shrink
harness.import_program()
for m in harness.load_benchmark()["per_layer"]:
    harness.metric_reader(m["name"])
for name in ("ws16m-serve-cat1", "ws16m-learn-cat1"):
    cell = shrink(harness.resolve(name))
    cell.runner.run(cell, seed=5, seconds=0.1, trace=False,
                    device=torch.device("cpu"), setup_start=0.0)
print(harness.forbidden_modules())
"""
    proc = subprocess.run([sys.executable, "-c", code, str(harness.ROOT)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["repro_torch.core", "jaxtyping",
                                      "jaxlib_extra", "numpy"]) == []
    assert harness.forbidden_modules(["repro.core.rollout", "jax.numpy", "flax",
                                      "jaxlib"]) == ["flax", "jax", "jaxlib",
                                                     "repro"]
