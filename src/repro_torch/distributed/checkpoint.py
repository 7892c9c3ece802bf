"""Atomic, fault-tolerant checkpoints on the reference's on-disk format
(its ``distributed/checkpoint.py``), so that either package restores
the other's.

Layout::

    <dir>/step_000000123/
        manifest.json        # step, treedef, leaf paths, and per leaf
                             # {"file", "shape", "dtype"}
        leaf_00000.npy ...   # one .npy per leaf, in the reference's
                             # flatten order (train/tree.py)
    <dir>/step_000000123.COMMIT   # written LAST: a step without it is
                                  # torn and ignored

bfloat16 leaves are stored as their uint16 bits under ``"dtype":
"bfloat16"`` (numpy has no bf16); here they cross through
``Tensor.view(torch.int16)``, with no ``ml_dtypes``.  Leaf files and the
manifest are fsync'd, then the directory is renamed into place, then the
marker is written.  ``CheckpointManager`` keeps the last k, can write on
a background thread, and finds the newest committed step.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.train.tree import (leaf_paths, tree_leaves, tree_map,
                                    tree_unflatten, treedef_str)

__all__ = ["save", "restore", "latest_step", "CheckpointManager"]


def _host_copy(x):
    """A host copy of a leaf, made now: a tensor as a CPU tensor (so
    that an in-place update of the original after this call is not
    seen), anything else as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x)


def _to_numpy(leaf):
    """(array to write, logical dtype name) of a host leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save(directory: str | Path, step: int, tree: Any) -> Path:
    """Atomic checkpoint write.  Returns the committed directory."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:09d}"
    tmp = directory / f".tmp_step_{step:09d}_{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    leaves = tree_leaves(tree)
    manifest = {
        "step": step,
        "treedef": treedef_str(tree),
        "paths": leaf_paths(tree),
        "leaves": [],
        "time": time.time(),
    }
    for i, leaf in enumerate(leaves):
        arr, logical_dtype = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        with open(tmp / fname, "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        manifest["leaves"].append(
            {"file": fname, "shape": list(arr.shape), "dtype": logical_dtype})
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())

    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    commit = directory / f"step_{step:09d}.COMMIT"
    commit.write_text(str(time.time()))
    return final


def latest_step(directory: str | Path) -> Optional[int]:
    """Newest COMMITTED step (torn checkpoints are skipped)."""
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = []
    for marker in directory.glob("step_*.COMMIT"):
        s = int(marker.stem.split("_")[1])
        if (directory / f"step_{s:09d}" / "manifest.json").exists():
            steps.append(s)
    return max(steps) if steps else None


def _restored(a: np.ndarray, logical: str, like):
    """A loaded leaf in ``like``'s kind, dtype and device: a tensor for a
    tensor, else a numpy array."""
    if logical == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    if logical == "bfloat16":
        t = t.float()
    dt = getattr(like, "dtype", None)
    return t.numpy() if dt is None else t.numpy().astype(dt)


def restore(directory: str | Path, step: int, like: Any,
            shardings: Any = None) -> Any:
    """Restore into the structure of ``like``, each leaf in the dtype and
    on the device of ``like``'s.  With ``shardings`` (a matching tree of
    ``NamedSharding``s, or None where a leaf stays whole) each restored
    leaf, the same logical tensor on every rank, is placed as the DTensor
    of its sharding (``elastic.place_tree``) — the elastic-rescale
    path: logical shapes are mesh-independent."""
    d = Path(directory) / f"step_{step:09d}"
    manifest = json.loads((d / "manifest.json").read_text())
    leaves_like = tree_leaves(like)
    if len(leaves_like) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, "
                         f"expected {len(leaves_like)}")
    arrs = [_restored(np.load(d / rec["file"]), rec["dtype"], l)
            for rec, l in zip(manifest["leaves"], leaves_like)]
    restored = tree_unflatten(like, arrs)
    if shardings is None:
        return restored
    from .elastic import place_tree

    return place_tree(restored, shardings)


class CheckpointManager:
    """keep-last-k + optional async writer + resume discovery."""

    def __init__(self, directory: str | Path, keep: int = 3,
                 async_save: bool = False):
        self.directory = Path(directory)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save(self, step: int, tree: Any):
        self.wait()
        # the host copy on the caller's thread: the next step overwrites
        # the tensors in place
        host_tree = tree_map(_host_copy, tree)
        if self.async_save:
            self._thread = threading.Thread(
                target=self._save_and_gc, args=(step, host_tree), daemon=True)
            self._thread.start()
        else:
            self._save_and_gc(step, host_tree)

    def _save_and_gc(self, step: int, tree: Any):
        save(self.directory, step, tree)
        self._gc()

    def _gc(self):
        steps = sorted(
            int(m.stem.split("_")[1]) for m in self.directory.glob("step_*.COMMIT"))
        for s in steps[: -self.keep]:
            (self.directory / f"step_{s:09d}.COMMIT").unlink(missing_ok=True)
            shutil.rmtree(self.directory / f"step_{s:09d}", ignore_errors=True)

    def latest(self) -> Optional[int]:
        self.wait()
        return latest_step(self.directory)

    def restore(self, like: Any, step: Optional[int] = None, shardings: Any = None):
        self.wait()
        step = self.latest() if step is None else step
        if step is None:
            return None, None
        return restore(self.directory, step, like, shardings), step
