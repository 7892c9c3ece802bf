"""Train a reduced LM on the PyTorch port (the code path the dry run
counts at 12B-314B scale) for a few dozen steps on the GPU, with an
injected mid-run failure to demonstrate checkpoint/restart.

    PYTHONPATH=src python examples/train_lm_torch.py
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu

The command of ``examples/train_lm.py`` on ``repro_torch.launch.train``
with a checkpoint directory of its own.  The command runs with this
process's environment and ``PYTHONPATH=src``, so that the CUDA
libraries and the visible devices stay in reach.
"""
import argparse
import os
import subprocess
import sys

from repro_torch.device import resolve_device

CKPT_DIR = "results/ckpt_lm_torch_example"


def command(device: str = "cuda") -> list:
    """The training command; ``--device`` is passed only off the default."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "lm",
           "--arch", "starcoder2-3b", "--steps", "60", "--inject-failure",
           "--ckpt-dir", CKPT_DIR]
    return cmd if device == "cuda" else cmd + ["--device", device]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)         # no CUDA: raise here, not in the child
    env = dict(os.environ, PYTHONPATH="src")
    return subprocess.run(command(args.device), check=True, env=env).returncode


if __name__ == "__main__":
    sys.exit(main())
