"""What every cell shares: finding a cell's files by name, loading the
program, the statistics of a window, the check for JAX, and the result
line."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
SRC_DIR = ROOT / "src"
PROGRAM = "repro_torch"
# Top-level module names that no run may hold once its window has closed:
# JAX, its libraries, and the JAX package that the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything it names."""

    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: List[dict]      # the end-to-end metrics this cell reports
    per_layer: List[dict]       # the per-layer metrics this cell reports
    runner: ModuleType
    reference: ModuleType


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_module(path: Path, name: str) -> ModuleType:
    """A module from its file, by path (the metric readers' names hold
    dots, so they are not importable by name)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _by_name(entries: List[dict], name: str, what: str) -> dict:
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"{what} {name!r} is named {len(found)} times in "
                       f"BENCHMARK.json")
    return found[0]


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: the cells of its
    ``workloads`` key; an end-to-end metric without one is reported by
    every cell (every per-layer metric names its cells)."""
    return cell in metric.get("workloads", [cell])


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json`` and its files."""
    bench = load_benchmark(root)
    wl = _by_name(bench["workloads"], name, "workload")
    cfg_entry = _by_name(bench["configs"], wl["config"], "config")
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((root / BENCH_DIR.name / "traffic"
                          / f"{wl['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    runner = importlib.import_module(f"perfbench.runners.{config['runner']}")
    reference = importlib.import_module(
        f"perfbench.reference.{config['reference']}")
    return Cell(name, wl, config, traffic, e2e, per_layer, runner, reference)


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    return load_module(root / BENCH_DIR.name / "metrics" / f"{name}.py",
                       "perfbench_metric_" + name.replace(".", "_"))


def import_program() -> ModuleType:
    """The port, from the checkout's ``src``, and from nowhere else."""
    if str(SRC_DIR) not in sys.path:
        sys.path.insert(0, str(SRC_DIR))
    try:
        import repro_torch
    except ImportError as exc:
        raise SystemExit(f"perfbench: the program {PROGRAM} is not in "
                         f"{SRC_DIR}: {exc}") from None
    where = Path(repro_torch.__file__).resolve()
    if SRC_DIR not in where.parents:
        raise SystemExit(f"perfbench: {PROGRAM} was imported from {where}, "
                         f"not from {SRC_DIR}")
    return repro_torch


def forbidden_modules(names: Optional[List[str]] = None) -> List[str]:
    """The forbidden top-level names among ``names`` (by default the
    modules loaded), compared whole: ``repro_torch`` is not ``repro``."""
    names = list(sys.modules) if names is None else names
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(tops.intersection(FORBIDDEN))


def p95(values: List[float]) -> float:
    """The 95th percentile by nearest rank: the smallest value that at
    least 95% of the values do not exceed."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(0.95 * len(ordered)) - 1)]


def peak(kind: str, key: str) -> Optional[float]:
    """A published peak of the card named ``kind`` (``peaks.json``), or
    None for a card the table does not hold."""
    table = json.loads((BENCH_DIR / "peaks.json").read_text())["cards"]
    return table.get(kind, {}).get(key)


def read_per_layer(cell: Cell, ctx) -> Dict[str, dict]:
    """Each per-layer metric of the cell that its reader finds something
    to read for; a reader that finds nothing returns None, and the metric
    is left out."""
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def check_lines(checks: Dict[str, dict]) -> List[str]:
    return [f"check {k}: {v['value']!r} (limit {v['limit']!r}, "
            f"{'ok' if v['ok'] else 'FAILED'})" for k, v in checks.items()]
