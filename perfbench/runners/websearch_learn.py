"""The learner configuration's runner: train steps of the tabular policy
back to back (an ε-greedy episode per query on the step's own draws and
the production plan's step rewards, then the batched TD update), step k
on the pool's variant k, the Q table carried from step to step through a
training run of ``learner.restart_every`` steps from the trainer's init,
and the next run started from it again.  A run's later steps are cheaper
(the policy learns to stop early), so a window that carried Q on for
ever would do cheaper work the faster it ran; runs of fixed length keep
the work of a window the same.

Set-up drives the one program object through its first ``CHECK_STEPS``
steps, through the window's own call, and the window carries on from
their Q.  In the window, the first step at position ``learner.replay_at``
of a training run keeps its input Q, its output Q and its metrics (a
window too short to reach one runs on, untimed, until it has).  After
the window the plain reference follows the first steps from the same
start on the same draws, and takes the late step from the program's own
input Q (it can only follow the program's training that far step by
step).  Four numbers are compared, each against its limit in the
configuration file: ``metrics_gap``, the worst of those steps' five
metrics (counts and the mean |Q| against their size, the mean reward
against the mean |r| of the valid transitions); ``dq1_gap``, ``dq3_gap``
and ``dq_late_gap``, the worst leaf's gap between the norms of the
program's and the reference's change of Q after step 1, after step 3 and
over the late step, a leaf being one action's column of the table,
against the larger of that leaf's reference norm and the median leaf's
(the largest leaf's where the median is 0; leaves whose reference change
is under a thousandth of that are left out)."""
from __future__ import annotations

import dataclasses
import gc
import statistics
import time
from typing import Dict, List, Optional

import torch

from perfbench import generate
from perfbench.runners import websearch as ws
from perfbench.trace import TraceSlice

KIND = "learn"
CHECK_STEPS = 3
COUNTS = ("mean_u", "mean_v", "mean_cand")
LEAF_FLOOR = 1e-3


@dataclasses.dataclass
class Steps:
    """One side's compared steps: the Qs and metrics of the first
    ``CHECK_STEPS`` from the init, and the late step's output Q and
    metrics (its input Q is the program's, ``Late.q_in``)."""

    qs: List[torch.Tensor]
    metrics: List[Dict[str, float]]
    late_q: torch.Tensor
    late_metrics: Dict[str, float]
    scales: Optional[List[float]] = None     # the reference's mean |r|, each step


@dataclasses.dataclass
class Late:
    k: int                  # the step's number (its draws and pool variant)
    q_in: torch.Tensor
    q_out: torch.Tensor
    metrics: Dict[str, float]


def leaf_gap(dq_prog: torch.Tensor, dq_ref: torch.Tensor) -> float:
    got = torch.linalg.vector_norm(dq_prog.double().cpu(), dim=0).tolist()
    want = torch.linalg.vector_norm(dq_ref.double().cpu(), dim=0).tolist()
    # the median leaf's norm, or the largest where most leaves are unmoved
    scale = statistics.median(want) or max(want)
    if scale == 0.0:            # the reference moved nothing: any move is a gap of 1
        return 0.0 if max(got) == 0.0 else 1.0
    return max(abs(g - w) / max(w, scale)
               for g, w in zip(got, want) if w >= LEAF_FLOOR * scale)


def metrics_gap(got: List[Dict[str, float]], want: List[Dict[str, float]],
                scales: List[float]) -> float:
    worst = 0.0
    for g, w, scale in zip(got, want, scales):
        for name in COUNTS:
            worst = max(worst, abs(g[name] - w[name]) / max(abs(w[name]), 1.0))
        worst = max(worst, abs(g["q_abs_mean"] - w["q_abs_mean"])
                    / abs(w["q_abs_mean"]))
        worst = max(worst, abs(g["mean_reward"] - w["mean_reward"])
                    / max(scale, 1e-30))
    return worst


def gaps(q0, late: Late, got: Steps, want: Steps) -> Dict[str, float]:
    """The four compared numbers."""
    q0, q_in = q0.cpu(), late.q_in.cpu()
    return {"metrics_gap": metrics_gap(got.metrics + [got.late_metrics],
                                       want.metrics + [want.late_metrics],
                                       want.scales),
            "dq1_gap": leaf_gap(got.qs[0].cpu() - q0, want.qs[0].cpu() - q0),
            "dq3_gap": leaf_gap(got.qs[-1].cpu() - q0, want.qs[-1].cpu() - q0),
            "dq_late_gap": leaf_gap(got.late_q.cpu() - q_in,
                                    want.late_q.cpu() - q_in)}


def program_step(cfg, inp, wrap=None):
    fn = ws.make_program(cfg)
    fn = wrap(fn) if wrap is not None else fn
    bins = ws.program_bins(inp)

    def step(q, k):
        occ, tp = inp.batch(k)
        return fn(q, bins, occ, inp.scores, tp, inp.prod_rewards, inp.draws(k))
    return step


def floats(metrics) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}


def check_steps(step, q0, n=CHECK_STEPS):
    """The program's first ``n`` steps from ``q0``: Qs and metrics."""
    qs, ms, q = [], [], q0
    for k in range(n):
        q, m = step(q, k)
        qs.append(q)
        ms.append(floats(m))
    return qs, ms


def late_step(step, late: Late):
    """The output Q and metrics of ``step`` at the late step, from the
    late step's input Q."""
    q, m = step(late.q_in, late.k)
    return q, floats(m)


def reference_step(cell, inp, q, k, dtype=torch.float32):
    occ, tp = inp.batch(k)
    return cell.reference.learn_step(cell.config, q, inp.u_edges, inp.v_edges,
                                     occ, inp.scores, tp, inp.prod_rewards,
                                     *inp.draws(k), dtype=dtype)


def reference_steps(cell, inp, late: Late, dtype=torch.float32) -> Steps:
    """The reference's first ``CHECK_STEPS`` steps from the init, and its
    late step from the program's input Q."""
    qs, ms, scales, q = [], [], [], inp.q
    for k in range(CHECK_STEPS):
        q, m, scale = reference_step(cell, inp, q, k, dtype)
        qs.append(q)
        ms.append(m)
        scales.append(scale)
    late_q, late_m, scale = reference_step(cell, inp, late.q_in, late.k, dtype)
    return Steps(qs, ms, late_q, late_m, scales + [scale])


def run(cell, *, seed: int, seconds: float, trace: bool, device,
        setup_start: float, wrap=None) -> dict:
    cfg, traffic = cell.config, cell.traffic
    b, restart = cfg["query_batch"], cfg["learner"]["restart_every"]
    replay_at = cfg["learner"]["replay_at"]
    marks = ws.Marks(setup_start)
    inp = generate.websearch_inputs(cfg, traffic, seed, device,
                                    draw_steps=cfg["learner"]["draw_steps"])
    ws.sync(device)
    marks("inputs")
    step = program_step(cfg, inp, wrap)
    tracer = TraceSlice(device) if trace else None
    if tracer is not None:
        tracer.warm()
    got_q, got_m = check_steps(step, inp.q)
    marks("check steps")
    state = {"q": got_q[-1], "late": None}
    setup_s = time.perf_counter() - setup_start

    def call(i):
        k = CHECK_STEPS + i
        q = inp.q if k % restart == 0 else state["q"]
        keep = k % restart == replay_at and state["late"] is None
        q_in = q.clone() if keep else None
        state["q"], m = step(q, k)
        if keep:
            state["late"] = Late(k, q_in, state["q"].clone(), floats(m))
        return float(m["mean_u"])               # the step's metrics on the host

    window = ws.run_window(call, seconds, device, tracer, traffic["trace_calls"])
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    extra = len(window.results)
    while state["late"] is None:                # a window too short to reach it
        call(extra)
        extra += 1
    late = state["late"]
    del step, call, state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    got = Steps(got_q, got_m, late.q_out, late.metrics)
    found = gaps(inp.q, late, got, reference_steps(cell, inp, late))
    checks = {k: {"value": v, "limit": cfg["limits"][k],
                  "ok": v <= cfg["limits"][k]} for k, v in found.items()}
    ok = all(c["ok"] for c in checks.values())
    n = len(window.results)
    plane = [mean_u * b * ws.plane_bytes(cfg) for mean_u in window.results]
    # the Q table read and written once, the step's rewards and draws read
    table = 2 * cfg["p_bins"] * (cfg["k_rules"] + 2) * 4 + 3 * b * cfg["t_max"] * 4
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {
        "end_to_end": {"learn_qps": n * b / window.seconds, "setup_s": setup_s},
        "attempted": n * b,
        "failed": 0 if ok else (CHECK_STEPS + 1) * b,
        "checks": checks,
        "memory_peak_bytes": peak,
        "layer": ws.layer_context(KIND, window, b,
                                  [p + table for p in plane], plane, kind),
        "notes": [f"{n} steps of {b} episodes in {window.seconds:.3f} s; "
                  f"check steps' metrics {got_m}; late step {late.k}'s "
                  f"{late.metrics}; reference {time.perf_counter() - t0:.2f} s",
                  marks.text(), ws.window_note(window),
                  ws.trace_note(window, plane)],
    }
