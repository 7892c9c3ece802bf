"""The port's checkpoints and resilient loop (``distributed/``) on the
CPU: the six cases of ``tests/test_checkpoint_ft.py`` on the port's
modules, checkpoints crossing between the two packages both ways, and
``launch/train.py lm`` surviving an injected failure."""
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import torch

from repro.distributed import checkpoint as jckpt
from repro_torch.distributed.checkpoint import (CheckpointManager, latest_step,
                                                restore, save)
from repro_torch.distributed.fault_tolerance import (FailureInjector,
                                                     FaultToleranceConfig,
                                                     run_resilient_loop)
from repro_torch.launch.train import main as train_main
from repro_torch.train.tree import tree_leaves

from test_torch_train_step import one_torch_thread  # noqa: F401


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32)),
        "layers": {"b": torch.from_numpy(rng.normal(size=(4,))).to(torch.bfloat16),
                   "count": torch.tensor(7, dtype=torch.int32)},
    }


def _jax_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": jnp.asarray(rng.normal(size=(8, 16)).astype(np.float32)),
        "layers": {"b": jnp.asarray(rng.normal(size=(4,)), jnp.bfloat16),
                   "count": jnp.int32(7)},
    }


def _bits(x):
    """A leaf's raw bits as numpy (bf16 as uint16), for either package."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16).numpy().view(np.uint16)
                if x.dtype == torch.bfloat16 else x.numpy())
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    save(tmp_path, 3, t)
    assert latest_step(tmp_path) == 3
    got = restore(tmp_path, 3, t)
    for a, b in zip(tree_leaves(got), tree_leaves(t)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_torn_checkpoint_ignored(tmp_path):
    t = _tree()
    save(tmp_path, 1, t)
    save(tmp_path, 2, t)
    # simulate a torn write: dir exists but COMMIT is missing
    (tmp_path / "step_000000002.COMMIT").unlink()
    assert latest_step(tmp_path) == 1


def test_keep_last_k(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    t = _tree()
    for s in (1, 2, 3, 4):
        mgr.save(s, t)
    steps = sorted(int(m.stem.split("_")[1]) for m in tmp_path.glob("step_*.COMMIT"))
    assert steps == [3, 4]


def test_async_save_copies_before_an_in_place_update(tmp_path):
    """The host copy is taken on the caller's thread: a tensor updated in
    place right after ``save`` returns is saved as it was."""
    mgr = CheckpointManager(tmp_path, keep=3, async_save=True)
    t = _tree()
    want = t["w"].clone()
    mgr.save(5, t)
    t["w"].add_(1.0)
    mgr.wait()
    assert mgr.latest() == 5
    assert torch.equal(restore(tmp_path, 5, t)["w"], want)


def test_resilient_loop_survives_failures(tmp_path):
    """Training survives two injected node failures and converges to the
    exact same state as a failure-free run (seeded-by-step contract)."""
    def step_fn(state, step):
        return {"x": state["x"] + torch.tensor(float(step)),
                "step": torch.tensor(step, dtype=torch.int32)}

    def start():
        return {"x": torch.tensor(0.0), "step": torch.tensor(-1, dtype=torch.int32)}

    ft = FaultToleranceConfig(ckpt_dir=str(tmp_path / "a"), ckpt_every=3,
                              async_save=False)
    res = run_resilient_loop(start(), step_fn, 20, ft,
                             injector=FailureInjector(fail_at=(7, 15)))
    assert res["restarts"] == 2
    assert res["steps_replayed"] > 0

    ft2 = FaultToleranceConfig(ckpt_dir=str(tmp_path / "b"), ckpt_every=3,
                               async_save=False)
    clean = run_resilient_loop(start(), step_fn, 20, ft2)
    assert float(res["state"]["x"]) == float(clean["state"]["x"])


def test_resume_from_existing_checkpoints(tmp_path):
    def step_fn(state, step):
        return {"x": state["x"] + 1.0}

    ft = FaultToleranceConfig(ckpt_dir=str(tmp_path), ckpt_every=2, async_save=False)
    run_resilient_loop({"x": torch.tensor(0.0)}, step_fn, 5, ft)
    # second invocation resumes from the last commit, not from scratch
    r2 = run_resilient_loop({"x": torch.tensor(0.0)}, step_fn, 10, ft)
    assert float(r2["state"]["x"]) == 10.0


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A checkpoint the reference writes restores through the port bit
    for bit, and the reverse; both write the same manifest."""
    jt, tt = _jax_tree(1), _tree(1)
    for a, b in zip(jax.tree_util.tree_leaves(jt), tree_leaves(tt)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    jckpt.save(tmp_path / "jax", 4, jt)
    got = restore(tmp_path / "jax", 4, _tree(2))
    save(tmp_path / "torch", 4, tt)
    back = jckpt.restore(tmp_path / "torch", 4, _jax_tree(2))
    for want, a, b in zip(tree_leaves(tt), tree_leaves(got),
                          jax.tree_util.tree_leaves(back)):
        assert a.dtype == want.dtype
        np.testing.assert_array_equal(_bits(a), _bits(want))
        np.testing.assert_array_equal(_bits(b), _bits(want))
    mj = json.loads((tmp_path / "jax/step_000000004/manifest.json").read_text())
    mt = json.loads((tmp_path / "torch/step_000000004/manifest.json").read_text())
    for key in ("step", "treedef", "paths", "leaves"):
        assert mj[key] == mt[key]
    assert [r["dtype"] for r in mt["leaves"]] == ["bfloat16", "int32", "float32"]


def test_train_lm_survives_an_injected_failure_bit_equal(tmp_path):
    """``launch/train.py lm`` with ``--inject-failure`` restarts once from
    the step-0 checkpoint, replays, and ends bit-equal to a clean run.
    40 steps, as the card's run: on random tokens the loss at step 29
    does not yet lie below step 0's for this init, and the command
    asserts that it falls."""
    runs = {}
    for name, extra in (("failed", ["--inject-failure"]), ("clean", [])):
        runs[name] = train_main(["lm", "--device", "cpu", "--steps", "40",
                                 "--ckpt-dir", str(tmp_path / name), *extra])
    assert runs["failed"]["restarts"] == 1 and runs["clean"]["restarts"] == 0
    assert runs["failed"]["steps_replayed"] == 19
    for a, b in zip(tree_leaves(runs["failed"]["state"]),
                    tree_leaves(runs["clean"]["state"])):
        assert torch.equal(a, b)
    assert runs["failed"]["losses"][-1] < runs["failed"]["losses"][0]
