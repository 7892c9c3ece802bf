"""Run one cell of ``BENCHMARK.json`` once, on the card, and print its
result as the last line of standard output:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a profiled slice of the window.  Every run ends by
comparing what the window produced with the plain reference and prints
each compared number beside its limit, last on standard error and under
``checks`` in the result line.  Exits with another code than 0, and
prints no result, without enough CUDA cards, without the program in the
checkout's ``src``, or when JAX or the JAX package was loaded.
"""
import time

SETUP_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# Every cache the program may write stays inside the checkout, at fixed
# paths; no library may pull in JAX behind the program's back.
CACHE = ROOT / "build" / "perfbench"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["USE_FLAX"] = "0"
# One process with few threads: the host's work is one thread's
# dispatch, and idle pool threads only take cores from it.
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"


def power_limit_w():
    """The card's power limit (W) as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench import harness

    cell = harness.resolve(args.workload)
    import torch

    torch.set_num_threads(1)

    print(f"perfbench: torch imported at {time.perf_counter() - SETUP_START:.3f} s",
          file=sys.stderr)

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    harness.import_program()
    from repro_torch.kernels import native

    native.BUILD_ROOT = ROOT / "build" / "repro_torch"
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats(device)
    print(f"perfbench: CUDA ready at {time.perf_counter() - SETUP_START:.3f} s",
          file=sys.stderr)

    out = cell.runner.run(cell, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device=device,
                          setup_start=SETUP_START)
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}; no result", file=sys.stderr)
        return 3

    layer = out["layer"]
    if args.trace:
        metrics = harness.read_per_layer(cell, layer)
    else:
        metrics = {m["name"]: {"value": out["end_to_end"][m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end}
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                   "count": chips, "memory_peak_bytes": out["memory_peak_bytes"],
                   "power_limit_w": power_limit_w()}
    checks = out["checks"]
    result = {"correct": all(c["ok"] for c in checks.values()),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device_info}
    if args.trace and layer.trace is not None:
        device_info["busy_s"] = layer.trace.busy_s
        device_info["window_s"] = layer.trace.window_s
        result["breakdown"] = layer.trace.breakdown()
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                        for k, c in checks.items()}
    for note in out["notes"]:
        print(f"perfbench: {note}", file=sys.stderr)
    print(f"perfbench: setup {out['end_to_end']['setup_s']:.3f} s",
          file=sys.stderr)
    for line in harness.check_lines(checks):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
