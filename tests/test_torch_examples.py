"""The port's five examples (``examples/*_torch.py``) against the
reference's (``examples/*.py``), on the CPU at ``tiny_system``'s size.

Each example splits building its system from its report, so that a test
hands in the port system of ``tests/test_torch_serving.py``, which
carries ``tiny_system``'s L1 parameters, state bins, rules and plans.

Tolerances, and why:

- quickstart: mean u and mean candidates bit for bit (the plans' rule
  loops read no score); mean NCG@100 within 1e-6 (float32 sums of at
  most 100 small integer gains over their ideal, in another order);
- train_policy: with the reference's trained Q tables, ``evaluate``'s
  u and candidates bit for bit, so Δu % exactly; each query's NCG
  within 1e-6 as above, so ΔNCG % within 100 x 2e-6 / (the baseline's
  mean NCG) x (1 + the ratio of the means), the most two such errors
  move the relative delta;
- serve_retrieval: every response's u and doc ids equal the reference
  engine's over the same stream, before and after the hot swap (the
  port system answers ``batch_inputs`` with the reference's arrays);
- online_learning: its own checks (>= 3 versions, lag within the
  staleness bound, recall non-decreasing, training from the tap only)
  at a small trainer config;
- train_lm: the command equals the reference's but for the module and
  the checkpoint directory.
"""
import ast
import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.querylog import CAT1, CAT2
from repro.policies import PolicyStore as JPolicyStore
from repro.ranking.metrics import batched_ncg as jbatched_ncg
from repro.ranking.metrics import relative_delta
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import ServeEngine as JServeEngine
from repro_torch.cluster import TrainerConfig
from repro_torch.policies import PolicyStore
from test_torch_serving import (ReferenceInputs, port_system,  # noqa: F401
                                reference, trained)
from test_torch_train_step import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "train_policy", "serve_retrieval", "online_learning",
            "train_lm")
NCG_TOL = 1e-6


def _example(name):
    """``examples/<name>_torch.py`` as a module (``main`` not run)."""
    path = ROOT / "examples" / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_report_matches_reference(tiny_system, port_system):
    ex = _example("quickstart")
    got = ex.report(port_system)
    assert [n.split()[0] for _, n in ex.CATEGORIES] == list(got["categories"])
    for cat, name in ex.CATEGORIES:
        qids = np.where(tiny_system.log.category == cat)[0][:32]
        final, _, _ = tiny_system.run_baseline(qids, cat)
        ncg = jbatched_ncg(final.cand, *tiny_system.judged(qids))
        row = got["categories"][name.split()[0]]
        assert row["mean_u"] == np.asarray(final.u).mean()
        assert row["candidates"] == np.asarray(final.cand_cnt).mean()
        assert abs(row["ncg"] - float(np.asarray(ncg).mean())) <= NCG_TOL
    assert got["query"] == int(qids[0])


@pytest.mark.parametrize("cat", [CAT2, CAT1])
def test_train_policy_evaluate_matches_reference(reference, port_system, cat):
    ref, jpolicies = reference
    q = np.asarray(jpolicies[cat].q)
    ex = _example("train_policy")
    got = ex.evaluate(port_system, torch.from_numpy(q.copy()), cat, "")
    qids = np.where(ref.log.category == cat)[0][:ex.EVAL_QUERIES]
    want = ref.evaluate(jnp.asarray(q), qids, cat)
    res = got["result"]
    for k in ("policy_u", "baseline_u", "policy_cand", "baseline_cand"):
        np.testing.assert_array_equal(res[k], want[k], err_msg=k)
    assert got["du_pct"] == relative_delta(want["policy_u"], want["baseline_u"])
    for k in ("policy_ncg", "baseline_ncg"):
        np.testing.assert_allclose(res[k], want[k], rtol=0, atol=NCG_TOL,
                                   err_msg=k)
    b, p = np.mean(want["baseline_ncg"]), np.mean(want["policy_ncg"])
    tol = 100 * 2 * NCG_TOL / b * (1 + p / b)
    assert abs(got["dncg_pct"] - relative_delta(want["policy_ncg"],
                                                want["baseline_ncg"])) <= tol


def test_serve_retrieval_matches_reference_engine(reference, trained,
                                                  port_system):
    ref, jpolicies = reference
    _, policies = trained
    ex = _example("serve_retrieval")
    store = PolicyStore(staleness_bound=1)
    store.publish(policies)
    out, learned, baseline = ex.serve(ReferenceInputs(port_system, ref), store)
    assert out["versions"] == [1, 2]

    jstore = JPolicyStore(staleness_bound=1)
    jstore.publish(jpolicies)
    engine = JServeEngine(ref, jstore, JEngineConfig(
        min_bucket=8, max_bucket=32, cache_capacity=512, n_shards=2))
    engine.warmup()
    qids = np.random.default_rng(0).integers(0, ref.log.n_queries,
                                             size=ex.N_SERVED)
    jlearned = engine.serve(qids)
    jstore.publish(ref.baseline_policies((CAT1, CAT2)))
    jbaseline = engine.serve(qids)
    assert engine.policy_version == 2
    for phase, got, want in (("learned", learned, jlearned),
                             ("static", baseline, jbaseline)):
        assert len(got) == len(want) == ex.N_SERVED
        for g, w in zip(got, want):
            assert (g.qid, g.u, g.policy_version) == (w.qid, w.u,
                                                     w.policy_version), phase
            np.testing.assert_array_equal(g.doc_ids, w.doc_ids, err_msg=phase)
    assert out["mean_u_learned"] == np.mean([r.u for r in jlearned])
    assert out["mean_u_static"] == np.mean([r.u for r in jbaseline])


def test_online_learning_checks_pass_at_small_size(port_system):
    """The example's run at a small trainer config: it asserts its
    properties itself; the report carries what it printed."""
    ex = _example("online_learning")
    out = ex.run(port_system, TrainerConfig(
        iters=6, publish_every=2, batch=16, probe_queries=8,
        publish_initial=False))
    assert len(out["versions"]) >= 3
    assert out["version_lag_observed_max"] <= ex.STALENESS_BOUND
    assert out["tap_batches"] > 0 and out["log_batches"] == 0
    r = out["recall_per_version"]
    assert all(b >= a - 1e-9 for a, b in zip(r, r[1:]))


def _reference_train_lm_command():
    """The argument list of ``examples/train_lm.py``'s ``subprocess.run``,
    read from its source (importing it would run it); the interpreter
    as ``None``."""
    tree = ast.parse((ROOT / "examples" / "train_lm.py").read_text())
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", "") == "run")
    return [None if isinstance(e, ast.Attribute) else ast.literal_eval(e)
            for e in call.args[0].elts]


def test_train_lm_command_matches_reference():
    ex = _example("train_lm")
    want = _reference_train_lm_command()
    got = ex.command()
    assert want[0] is None and got[0] == sys.executable
    swap = {"repro.launch.train": "repro_torch.launch.train",
            "results/ckpt_lm_example": ex.CKPT_DIR}
    assert got[1:] == [swap.get(a, a) for a in want[1:]]
    assert ex.CKPT_DIR != "results/ckpt_lm_example"
    assert ex.command("cpu") == got + ["--device", "cpu"]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_raises_without_cuda(name):
    """Each example's ``main`` runs on CUDA by default: without it, it
    raises before it builds anything (or starts a child)."""
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the no-fallback path is not reachable")
    with pytest.raises(RuntimeError, match="CUDA"):
        _example(name).main([])
