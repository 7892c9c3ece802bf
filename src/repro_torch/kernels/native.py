"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C entry point.  It is
compiled by ``nvcc`` for ``sm_90a`` into a shared library at first use,
into ``build/repro_torch/<hash>/`` under the repository root (listed in
``.gitignore``), keyed by a hash of the sources and flags, and loaded
with ``ctypes``.

Every :class:`NativeKernel` keeps ``launches``, a plain count that its
``launch`` adds one to each time the kernel is launched, and nowhere
else, so that a run can show which kernels the main path went through.

Several threads may launch one kernel (the cluster's replicas and its
trainer): a lock per kernel makes the first launch build and load the
library once, and no count is lost between threads.  Several processes
may too (the process cell's workers, each with its own lock and count):
each builds into a temporary file of its own name and renames it over
the library, so two first builds at once never write one file, and a
process that finds the library already there loads it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

__all__ = ["NativeKernel", "CSRC_DIR", "BUILD_ROOT", "csrc_define"]

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def csrc_define(header: str, name: str) -> int:
    """The integer of ``#define name <int>`` in ``csrc/header``, so that a
    wrapper checks its arguments against the value the kernel is built
    with, not against a copy of it."""
    text = (CSRC_DIR / header).read_text()
    found = re.search(rf"^#define {name} (\d+)\b", text, re.MULTILINE)
    if found is None:
        raise KeyError(f"{name} is not defined in {header}")
    return int(found.group(1))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


class NativeKernel:
    """One CUDA source file with one C entry point ``symbol``."""

    def __init__(self, name: str, source: str, headers: Sequence[str],
                 symbol: str, argtypes: Sequence):
        self.name = name
        self.source = source                  # file name in csrc/
        self.headers = tuple(headers)
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        # Reentrant: _load holds it across build().
        self._lock = threading.RLock()

    def _lib_path(self) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for f in (self.source, *self.headers):
            h.update((CSRC_DIR / f).read_bytes())
        return BUILD_ROOT / h.hexdigest()[:16] / f"lib{self.name}.so"

    def build(self) -> str:
        """Compile the library unless it exists; returns nvcc's output
        (its ``ptxas`` register report), or "" if nothing was built."""
        lib = self._lib_path()
        with self._lock:
            if lib.exists():
                return ""
            lib.parent.mkdir(parents=True, exist_ok=True)
            # Written beside the library and renamed, so that an
            # interrupted build never leaves a library that later loads
            # would take; named per process, so that two processes
            # building at once never write into one file.
            tmp = lib.parent / f"{lib.name}.{os.getpid()}.tmp"
            out = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC_DIR / self.source)],
                capture_output=True, text=True)
            log = out.stdout + out.stderr
            if out.returncode != 0:
                raise RuntimeError(f"nvcc failed for {self.source}:\n{log}")
            os.replace(tmp, lib)
            return log

    def _load(self):
        fn = self._fn
        if fn is None:
            with self._lock:
                if self._fn is None:
                    self.build()
                    fn = getattr(ctypes.CDLL(str(self._lib_path())),
                                 self.symbol)
                    fn.argtypes = self.argtypes
                    fn.restype = ctypes.c_int
                    self._fn = fn
                fn = self._fn
        return fn

    def launch(self, *args) -> None:
        """Call the C entry point; raise if it reports a CUDA error."""
        err = self._load()(*args)
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA error {err} at launch")
        with self._lock:
            self.launches += 1
