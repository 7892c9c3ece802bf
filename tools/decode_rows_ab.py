#!/usr/bin/env python3
"""Time chosen decode-attention rows of ``chip_smoke.py`` in several
checkouts of the repository, one process a checkout, in the order given
(for an A/B: parent, change, change, parent).

Each checkout runs its own ``chip_smoke.decode_phase`` (its own kernels
and wrapper, built from its own sources) restricted to ROWS; a row that
the checkout's ``DECODE_CASES`` lacks (``path_fp32_8k`` before it was
added) is taken from this file's copy of ``chip_smoke.py``, so every
checkout times the same shapes.

Run from the root of a checkout, on a machine with the card and nvcc:

    python3 tools/decode_rows_ab.py build/ab/parent . . build/ab/parent
"""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ROWS = ("path_fp32", "path_fp32_8k", "ragged", "path")

CHILD = r"""
import inspect, sys
sys.path[:0] = ["src", "."]
import torch
import chip_smoke as cs
rows = {rows!r}
have = {{r[0]: r for r in cs.DECODE_CASES}}
cs.DECODE_CASES = [have.get(r[0], r) for r in {extra!r} if r[0] in rows]
dev = torch.device("cuda")
from repro_torch.kernels.decode_attention import (DECODE_ATTENTION_KERNEL,
                                                  DECODE_ATTENTION_TC_KERNEL)
cs.build_kernels([DECODE_ATTENTION_KERNEL, DECODE_ATTENTION_TC_KERNEL])
flush = torch.empty(cs.L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
floor = cs.launch_floor_ms(dev, flush)
print(f"[launch floor] {{floor:.6f}} ms", flush=True)
args = (dev, flush, floor)[:len(inspect.signature(cs.decode_phase).parameters)]
cs.decode_phase(*args)
"""


def main(trees):
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    print(cs.card_line(), flush=True)
    code = CHILD.format(rows=ROWS, extra=cs.DECODE_CASES)
    for n, tree in enumerate(trees, 1):
        out = subprocess.run([sys.executable, "-c", code], cwd=tree,
                             capture_output=True, text=True)
        for line in (out.stdout + out.stderr).splitlines():
            if not line.startswith("[build]"):
                print(f"[{n} {tree}] {line}", flush=True)
        if out.returncode:
            raise SystemExit(f"{tree}: exit {out.returncode}")


if __name__ == "__main__":
    main(sys.argv[1:] or ["."])
