"""``BENCHMARK.json`` against the rules it is held to, and every entry
resolved to its files by name."""
import json
import re
import shutil
import subprocess
import sys

import pytest

from perfbench import harness

BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
WORKLOAD_NAMES = [w["name"] for w in BENCH["workloads"]]
PER_LAYER_NAMES = [m["name"] for m in BENCH["per_layer"]]


def one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == TOP_KEYS
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16 and 1 <= len(BENCH["per_layer"]) <= 128


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert one_line(c["source"]) and one_line(c["why"]) and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and one_line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_metrics_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in WORKLOAD_NAMES:
        reported = [m for m in e2e.values() if harness.reports(m, w)]
        assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2


def test_per_layer_metrics_name_their_layer_and_what_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert one_line(m["layer"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m["workloads"]:
            assert harness.reports(e2e[m["moves"]], w)
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    for w in WORKLOAD_NAMES:
        assert any(w in m["workloads"] for m in BENCH["per_layer"])


def test_at_most_a_quarter_of_cells_on_four_chips():
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, len(BENCH["workloads"]) // 4)


def test_a_full_check_fits_its_time():
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("workload", WORKLOAD_NAMES)
def test_every_cell_resolves_to_its_files_by_name(workload):
    cell = harness.resolve(workload)
    assert cell.config["name"] == cell.workload["config"]
    assert cell.traffic["name"] == cell.workload["traffic"]
    assert callable(cell.runner.run)
    assert cell.end_to_end and cell.per_layer
    entry = [c for c in BENCH["configs"] if c["name"] == cell.config["name"]][0]
    assert entry["file"].startswith("perfbench/")


@pytest.mark.parametrize("metric", PER_LAYER_NAMES)
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(harness.metric_reader(metric).read)


def test_every_config_is_used_and_names_its_own_source():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert "arXiv:1804.04410" in c["source"]
        body = json.loads((harness.ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert all(k in body for k in c["reduced"])
    sources = [c["source"] for c in BENCH["configs"]]
    assert len(sources) == len(set(sources))


def test_adding_a_cell_is_adding_files_and_an_entry(tmp_path, small, cpu):
    """A new traffic mix, a new per-layer metric and a new workload entry,
    in a copy of the benchmark: the copy resolves the new cell by name
    and runs it, and no file that was there changed."""
    root = tmp_path
    shutil.copytree(harness.BENCH_DIR, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(root): p.read_bytes()
              for p in (root / "perfbench").rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    traffic = json.loads((root / "perfbench/traffic/cat2.json").read_text())
    traffic.update(name="cat3", plane_density_log2=[6, 9])
    (root / "perfbench/traffic/cat3.json").write_text(json.dumps(traffic))
    (root / "perfbench/metrics/calls_traced.serve.py").write_text(
        "def read(ctx):\n    return ctx.traced_calls or None\n")
    bench["workloads"].append({"name": "ws16m-serve-cat3",
                               "config": "websearch-rl-16m-serve",
                               "traffic": "cat3", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "calls_traced.serve", "unit": "calls",
                               "better": "higher", "source": "program_counter",
                               "layer": "cell entry", "moves": "serve_qps",
                               "workloads": ["ws16m-serve-cat3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.resolve("ws16m-serve-cat3", root)
    assert cell.traffic["plane_density_log2"] == [6, 9]
    assert [m["name"] for m in cell.per_layer] == ["calls_traced.serve"]
    from perfbench.conftest import shrink

    shrink(cell)
    out = cell.runner.run(cell, seed=7, seconds=0.2, trace=False, device=cpu,
                          setup_start=0.0)
    assert out["checks"]["rows_wrong"]["ok"]
    assert harness.metric_reader("calls_traced.serve", root).read(out["layer"]) is None
    after = {p.relative_to(root): p.read_bytes()
             for p in (root / "perfbench").rglob("*") if p.is_file()}
    assert all(after[p] == b for p, b in before.items())


def test_run_exits_without_a_result_when_there_is_no_card():
    proc = subprocess.run(
        [sys.executable, str(harness.BENCH_DIR / "run.py"), "--workload",
         WORKLOAD_NAMES[0], "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_no_program_outside_the_checkout(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark,
    the program cannot be loaded, and the harness says so."""
    shutil.copytree(harness.BENCH_DIR, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from perfbench import harness; harness.import_program()")
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                          capture_output=True, text=True, timeout=120,
                          cwd=tmp_path)
    assert proc.returncode != 0 and "not" in proc.stderr
