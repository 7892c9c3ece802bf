"""The readings that a cell's correctness limits are set from, on the card
at the cell's own sizes, in one process:

    python3 perfbench/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 --first-seed <n>

For each seed, the program's reading (its window's calls, or its first
steps and its step at ``replay_at``, against the plain reference: the
lower reading); for the first
``--control-seeds`` seeds, the control's (the plain reference in
bfloat16 put in the program's place: the upper reading) and, for a
learner, each planted fault's (``faults.py``).  One JSON line a reading.
Benchmark runs never run this.
"""
import time

START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SERVE_CALLS = 8         # program calls a seed, over every variant of the pool


def serve_readings(cell, runner, inp, control: bool):
    import torch

    call = runner.program_call(cell.config, inp)
    results = [call(i) for i in range(SERVE_CALLS)]
    del call
    want = runner.reference_answers(cell, inp)
    out = {"rows_wrong": runner.rows_wrong(results, want),
           "rows": SERVE_CALLS * len(want[0][1])}
    if control:
        low = runner.reference_answers(cell, inp, dtype=torch.bfloat16)
        out["control_rows_wrong"] = runner.rows_wrong(low, want)
        out["control_rows"] = len(low) * len(want[0][1])
    return out


def learn_readings(cell, runner, inp, control: bool):
    """The program's first steps and its step at ``replay_at`` (from its
    own training to there), each against the reference; with
    ``control``, the control's and each fault's at the same steps."""
    import torch

    from perfbench import faults

    cfg = cell.config
    step = runner.program_step(cfg, inp)
    qs, ms = runner.check_steps(step, inp.q)
    q, at = qs[-1], cfg["learner"]["replay_at"]
    for k in range(runner.CHECK_STEPS, at):
        q, _ = step(q, k)
    q_in = q.clone()
    q_out, m = step(q, at)
    late = runner.Late(at, q_in, q_out, runner.floats(m))
    want = runner.reference_steps(cell, inp, late)

    def against(qs, ms, late_q, late_m):
        return runner.gaps(inp.q, late, runner.Steps(qs, ms, late_q, late_m),
                           want)

    out = {"program": against(qs, ms, late.q_out, late.metrics)}
    if control:
        low = runner.reference_steps(cell, inp, late, dtype=torch.bfloat16)
        out["control"] = against(low.qs, low.metrics, low.late_q,
                                 low.late_metrics)
        for name, wrap in faults.LEARN.items():
            bad = runner.program_step(cfg, inp, wrap)
            out[f"fault_{name}"] = against(*runner.check_steps(bad, inp.q),
                                           *runner.late_step(bad, late))
    out["metrics"] = want.metrics + [want.late_metrics]
    out["leaves_left_out"] = [left_out(w - q0, runner.LEAF_FLOOR) for w, q0 in
                              ((want.qs[0], inp.q), (want.qs[-1], inp.q),
                               (want.late_q, late.q_in))]
    return out


def left_out(dq, floor: float) -> int:
    """The leaves (action columns) that the gap leaves out by rule: under
    ``floor`` times the median leaf's change (the largest's where that is
    0)."""
    import statistics

    import torch

    norms = torch.linalg.vector_norm(dq.double().cpu(), dim=0).tolist()
    scale = statistics.median(norms) or max(norms)
    return sum(n < floor * scale for n in norms)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, required=True)
    args = ap.parse_args(argv)

    from perfbench import generate, harness

    cell = harness.resolve(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    harness.import_program()
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runner = cell.runner
    learner = "learner" in cell.config
    for i in range(args.seeds):
        seed = args.first_seed + i
        t0 = time.perf_counter()
        inp = generate.websearch_inputs(
            cell.config, cell.traffic, seed, device,
            draw_steps=cell.config["learner"]["draw_steps"] if learner else 0)
        read = learn_readings if learner else serve_readings
        out = read(cell, runner, inp, i < args.control_seeds)
        del inp
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **out}),
              flush=True)
    found = harness.forbidden_modules()
    print(json.dumps({"workload": args.workload,
                      "card": torch.cuda.get_device_name(device),
                      "forbidden_modules": found,
                      "total_seconds": time.perf_counter() - START}), flush=True)
    return 1 if found else 0


if __name__ == "__main__":
    sys.exit(main())
