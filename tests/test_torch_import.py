"""The port's two standing rules: it never imports JAX or the JAX
package, and it never falls back to the CPU quietly."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(len(names), bad)
"""


def test_import_pulls_in_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, check=True)
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 20          # every submodule was imported
    assert bad.strip() == "[]"


def test_probe_walks_the_serving_and_obs_modules():
    """The import probe above walks the engine's, the cluster's and the
    live index's modules too."""
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


def test_cluster_cli_process_backend_raises():
    """The process cell is not ported yet: the flag raises before
    anything is built, on any device."""
    from repro_torch.launch.cluster import main as cluster_main

    with pytest.raises(NotImplementedError, match="process cell"):
        cluster_main(["--replica-backend", "process", "--device", "cpu"])


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


_NEW_MODULES = """
import importlib, sys
for name in ("repro_torch.kernels.decode_attention",
             "repro_torch.kernels.embedding_bag",
             "repro_torch.models.recsys",
             "repro_torch.configs.wide_deep", "repro_torch.configs.deepfm",
             "repro_torch.configs.dcn_v2", "repro_torch.configs.bert4rec"):
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
