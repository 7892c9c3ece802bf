"""The port's two standing rules: it never imports JAX or the JAX
package, and it never falls back to the CPU quietly."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"
EXAMPLES = SRC.parent / "examples"

_PROBE = """
import importlib, importlib.util, pathlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
examples = sorted(pathlib.Path(sys.argv[1]).glob("*_torch.py"))
for path in examples:
    spec = importlib.util.spec_from_file_location(path.stem, path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "repro", "ml_dtypes"))
print(len(names), len(examples), bad)
"""


def test_import_pulls_in_no_jax_and_no_reference():
    """Nor ``ml_dtypes`` (JAX's bf16 for numpy), which the card's machine
    lacks: the checkpoints cross bf16 as int16 bits.  The probe also
    imports the port's five examples, ``examples/*_torch.py``."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE, str(EXAMPLES)],
                         env=env, capture_output=True, text=True, check=True)
    n, n_examples, bad = out.stdout.split(" ", 2)
    assert int(n) >= 20          # every submodule was imported
    assert int(n_examples) == 5
    assert bad.strip() == "[]"


def test_probe_walks_the_serving_and_obs_modules():
    """The import probe above walks the engine's, the cluster's, the
    live index's and the process cell's modules too, and the GNN's, its
    kernel's and the roofline's."""
    import pkgutil

    import repro_torch

    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {f"repro_torch.serving.{m}" for m in (
        "array_cache", "batcher", "cache", "engine", "executor", "levels",
        "slab", "telemetry")} <= names
    assert {f"repro_torch.obs.{m}" for m in (
        "events", "health", "metrics", "slo", "trace")} <= names
    assert {f"repro_torch.cluster.{m}" for m in (
        "admission", "cluster", "replica", "router", "tap", "trainer")} <= names
    assert {"repro_torch.obs", "repro_torch.cluster",
            "repro_torch.launch.serve", "repro_torch.launch.cluster"} <= names
    assert {f"repro_torch.index.live.{m}" for m in (
        "live_index", "merge", "parity", "segments", "system")} <= names
    assert {"repro_torch.index.live", "repro_torch.data.freshness",
            "repro_torch.launch.live_index"} <= names
    assert {f"repro_torch.cluster.proc.{m}" for m in (
        "follower", "messages", "replica", "ring", "worker")} <= names
    # the mesh paths: the LM's tensor, sequence and FSDP/ZeRO sharding and
    # sequence-sharded decode, the GNN's edge sharding, ZeRO-1 AdamW
    assert {"repro_torch.models.attention", "repro_torch.models.transformer",
            "repro_torch.models.moe", "repro_torch.models.gnn",
            "repro_torch.distributed.collectives",
            "repro_torch.distributed.embedding_ops",
            "repro_torch.kernels.segment_gather.ops",
            "repro_torch.kernels.decode_attention.ops",
            "repro_torch.train.optimizer", "repro_torch.launch.steps",
            "repro_torch.launch.mesh"} <= names
    assert "repro_torch.cluster.proc" in names
    assert {"repro_torch.models.gnn", "repro_torch.configs.graphsage_reddit",
            "repro_torch.kernels.segment_gather",
            "repro_torch.kernels.segment_gather.ops",
            "repro_torch.kernels.segment_gather.ref",
            "repro_torch.launch.roofline", "repro_torch.launch.steps"} <= names


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the no-fallback path is not reachable")
    from repro_torch.core.match_rules import default_rule_library
    from repro_torch.index.corpus import CorpusConfig
    from repro_torch.system import RetrievalSystem, SystemConfig

    cfg = SystemConfig(corpus=CorpusConfig(n_docs=64))
    with pytest.raises(RuntimeError, match="CUDA"):
        RetrievalSystem(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        RetrievalSystem(cfg, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        default_rule_library()
    from repro_torch.launch.serve import main as serve_main

    with pytest.raises(RuntimeError, match="CUDA"):
        serve_main(["--n-docs", "64", "--n-queries", "16"])
    from repro_torch.launch.cluster import main as cluster_main

    with pytest.raises(RuntimeError, match="CUDA"):
        cluster_main(["--n-docs", "64", "--n-queries", "16"])
    from repro_torch.index.live import LiveRetrievalSystem

    with pytest.raises(RuntimeError, match="CUDA"):
        LiveRetrievalSystem(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        LiveRetrievalSystem(cfg, device="cuda")
    from repro_torch.launch.live_index import main as live_main

    with pytest.raises(RuntimeError, match="CUDA"):
        live_main(["--n-docs", "64", "--n-queries", "16"])


def test_cluster_cli_process_backend_raises_without_cuda(monkeypatch):
    """The process cell on the default device raises before it builds a
    system or spawns a worker: no quiet CPU fallback in the parent, and
    none in a worker (it builds on the parent's device)."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the no-fallback path is not reachable")
    import multiprocessing

    from repro_torch.launch.cluster import main as cluster_main

    def no_spawn(*a, **k):
        raise AssertionError("a worker was spawned")

    monkeypatch.setattr(multiprocessing.context.SpawnProcess, "start",
                        no_spawn)
    with pytest.raises(RuntimeError, match="CUDA"):
        cluster_main(["--replica-backend", "process", "--smoke"])


def test_lm_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the no-fallback path is not reachable")
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import (decode_step, init_kv_cache,
                                                init_params, prefill)

    cfg = get_arch("mistral-nemo-12b").model_cfg(True)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_kv_cache(cfg, 1, 8)
    params = init_params(cfg, device="cpu")
    tokens = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(RuntimeError, match="CUDA"):
        prefill(params, tokens, cfg)
    _, cache = prefill(params, tokens, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        decode_step(params, tokens[:, 0], cache, torch.tensor([8]), cfg)
    mla = get_arch("deepseek-v2-lite-16b").model_cfg(True)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(mla)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_kv_cache(mla, 1, 8)
    assert sorted(init_kv_cache(mla, 1, 8, device="cpu")) == ["c", "k_rope"]


_NEW_MODULES = """
import importlib, sys
for name in ("repro_torch.kernels.decode_attention",
             "repro_torch.kernels.embedding_bag",
             "repro_torch.models.recsys", "repro_torch.models.moe",
             "repro_torch.configs.wide_deep", "repro_torch.configs.deepfm",
             "repro_torch.configs.dcn_v2", "repro_torch.configs.bert4rec",
             "repro_torch.configs.deepseek_v2_lite_16b",
             "repro_torch.configs.grok1_314b"):
    importlib.import_module(name)
print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro")))
"""


def test_decode_and_recsys_modules_import_without_jax():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _NEW_MODULES], env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_recsys_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the no-fallback path is not reachable")
    from repro_torch.configs import get_arch
    from repro_torch.models import recsys

    cfg = get_arch("wide-deep").model_cfg(True)
    with pytest.raises(RuntimeError, match="CUDA"):
        recsys.wide_deep_init(cfg)
    params = recsys.wide_deep_init(cfg, device="cpu")
    ids = torch.zeros((2, cfg.n_sparse), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="CUDA"):
        recsys.wide_deep_forward(params, ids, cfg)
    assert recsys.wide_deep_forward(params, ids, cfg, device="cpu").shape == (2,)
    b4r = get_arch("bert4rec").model_cfg(True)
    with pytest.raises(RuntimeError, match="CUDA"):
        recsys.bert4rec_init(b4r)


_BLOCK_SCAN_OPS = """
import sys
import repro_torch.kernels.block_scan.ops
print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro")))
"""


def test_block_scan_ops_import_without_jax():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _BLOCK_SCAN_OPS], env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_train_modules_import_and_lm_cli_raises_without_cuda():
    """The train slice's modules are walked by the probe; the ``lm``
    command on the default device raises before it builds anything."""
    import pkgutil

    import repro_torch

    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.launch.steps", "repro_torch.distributed",
            "repro_torch.distributed.checkpoint",
            "repro_torch.distributed.fault_tolerance",
            "repro_torch.train.tree", "repro_torch.kernels.embedding_bag.backward",
            } <= names
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the no-fallback path is not reachable")
    from repro_torch.launch.train import main as train_main

    with pytest.raises(RuntimeError, match="CUDA"):
        train_main(["lm", "--steps", "2", "--ckpt-dir", "unused"])


_MESH_PROBE = """
import importlib, sys
import torch.distributed as dist
for name in ("repro_torch.distributed", "repro_torch.distributed.sharding_rules",
             "repro_torch.distributed.collectives", "repro_torch.distributed.elastic",
             "repro_torch.distributed.embedding_ops", "repro_torch.launch.mesh",
             "repro_torch.launch.steps", "repro_torch.models.moe",
             "repro_torch.models.recsys"):
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
print(dist.is_initialized(), bad)
"""


def test_mesh_modules_are_walked_and_touch_no_process_group():
    """The mesh slice's modules are walked by the probe above, import no
    JAX and no reference module, and importing them initialises no
    process group (a mesh is built by a call, as the reference's)."""
    import pkgutil

    import repro_torch

    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {f"repro_torch.distributed.{m}" for m in (
        "collectives", "elastic", "embedding_ops", "sharding_rules")} <= names
    assert "repro_torch.launch.mesh" in names
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _MESH_PROBE], env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "False []"


_DRYRUN_PROBE = """
import importlib, sys
import torch.distributed as dist
for name in ("repro_torch.launch.dryrun", "repro_torch.launch.roofline",
             "repro_torch.kernels.cost"):
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
print(dist.is_initialized(), bad)
"""


def test_dryrun_modules_are_walked_and_import_no_jax():
    """The dry run, the roofline and the kernels' cost channel are walked
    by the probe above, import no JAX and no reference module, and start
    no process group on import (``main`` starts its fake one)."""
    import pkgutil

    import repro_torch

    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.launch.dryrun", "repro_torch.launch.roofline",
            "repro_torch.kernels.cost"} <= names
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _DRYRUN_PROBE], env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "False []"


# (reference module, names with no counterpart in the port's module, why)
_NOT_PORTED = {
    "core/scan_backends.py": {"XlaScanBackend", "PallasBlockScanBackend",
                              "xla_run_rule"},        # renamed: reference, block_scan
    "kernels/block_scan/block_scan.py": {"block_scan_pallas"},
    "kernels/block_scan/block_scan_pruned.py": {"block_scan_pruned_pallas"},
    "kernels/common.py": {"INTERPRET", "pad_axis_to", "reduce_and", "reduce_or",
                          "tpu_compiler_params"},      # Pallas helpers
    "kernels/decode_attention/decode_attention.py": None,   # the Pallas kernels:
    "kernels/embedding_bag/embedding_bag.py": None,         # csrc/*.cu instead
    "kernels/flash_attention/flash_attention.py": None,
    "kernels/decode_attention/ops.py": {"decode_attention_reference"},   # JAX
    "kernels/flash_attention/ops.py": {"flash_attention_reference"},     # oracles
    "launch/dryrun.py": {"DTYPE_BYTES"},    # HLO-text sizes; torch has element_size
    "models/layers.py": {"PyTree"},         # an alias the reference does not use
}


def _public_names(path: Path) -> set:
    """Top-level ``def``s, ``class``es and assignments, no ``_`` names."""
    import ast

    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def test_every_reference_module_has_its_public_names_in_the_port():
    """Each ``src/repro`` module's public names are in its
    ``src/repro_torch`` counterpart, but the Pallas internals, the JAX
    oracles and the backends renamed on purpose (``_NOT_PORTED``)."""
    ref, port = SRC / "repro", SRC / "repro_torch"
    missing = {}
    for path in sorted(ref.rglob("*.py")):
        rel = path.relative_to(ref).as_posix()
        allowed = _NOT_PORTED.get(rel, set())
        twin = port / rel
        if allowed is None:
            assert not twin.exists(), rel
            continue
        assert twin.exists(), f"no counterpart of src/repro/{rel}"
        gap = _public_names(path) - _public_names(twin) - allowed
        if gap:
            missing[rel] = sorted(gap)
        assert allowed <= _public_names(path), rel   # the list stays true
    assert not missing, missing
