"""The readings that the row cell's check is held to, on the cards:

    python3 perfbench/calibrate_x4.py --workload ws67m-serve-cat1-x4 --seed <n> --seconds 10

One run of the row (``runners/websearch_serve_x4.py``) with the last
slice's candidates dropped before the gather (``drop_last_slice``): its
``rows_wrong`` is the fault's reading, which the check has to put above
its limit.  Beside it the control: the plain reference in bfloat16,
merged as the float32 one is, counted against it.  One JSON line.
Benchmark runs never run this.
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import run as bench  # noqa: E402  (the run's environment)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)

    from perfbench import harness

    cell = harness.resolve(args.workload)
    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"calibrate_x4: {args.workload} needs {chips} CUDA cards",
              file=sys.stderr)
        return 2
    harness.import_program()
    from repro_torch.kernels import native

    native.BUILD_ROOT = bench.ROOT / "build" / "repro_torch"
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = cell.runner.run(cell, seed=args.seed, seconds=args.seconds,
                          trace=False, device=device,
                          setup_start=bench.SETUP_START, drop_slice=True,
                          control=True)
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "card": torch.cuda.get_device_name(device),
                      "power_limit_w": bench.power_limit_w(),
                      "fault_rows_wrong": out["checks"]["rows_wrong"]["value"],
                      "fault_rows": out["attempted"],
                      "control_rows_wrong": out["control"]["rows_wrong"],
                      "control_rows": out["control"]["rows"],
                      "forbidden_modules": harness.forbidden_modules()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
