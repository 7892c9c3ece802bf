"""The port's optimizers (``train/optimizer.py``) against the JAX
reference's ``train/optimizer.py``, on the CPU, on identical inputs:
nested trees of float32 and bfloat16 leaves of 0 to 3 dimensions.

Tolerance 1e-6 (absolute and relative): both sides compute the same
float32 elementwise ops in the same order, which round exactly; only
the bias corrections' ``pow`` and the reductions (norm, Adafactor's
means) may differ in the last bit.  The in-place forms
(``adamw_update_``, ``clip_by_global_norm_``) must give the
functional forms' bits, also when every leaf is cut into slices.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as jopt
from repro_torch.train import optimizer as topt
from repro_torch.train.tree import tree_leaves

from test_torch_train_step import one_torch_thread  # noqa: F401

TOL = 1e-6


def _tree(seed, bf16=False):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "stack": {"a": (3, 4, 7), "b": (9,)},
              "s": (), "z": (2, 1, 3)}

    def make(shape):
        return rng.normal(size=shape).astype(np.float32)

    def build(node):
        return ({k: build(v) for k, v in node.items()} if isinstance(node, dict)
                else make(node))

    tree = build(shapes)
    if bf16:
        tree["stack"]["a"] = tree["stack"]["a"].astype(jnp.bfloat16)
    return tree


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _to_torch(tree):
    def conv(a):
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(np.array(a))
    return jax.tree_util.tree_map(conv, tree)


def _close(got_tree, want_tree, tol=TOL):
    got = tree_leaves(got_tree)
    want = jax.tree_util.tree_leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w, np.float32),
                                   atol=tol, rtol=tol)


def _equal(a_tree, b_tree):
    for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("lr_scale", [1.0, 0.37])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bf16_params", [False, True])
def test_adamw_matches_reference_and_in_place_is_bit_equal(
        bf16_params, state_dtype, lr_scale, monkeypatch):
    jcfg = jopt.AdamWConfig(lr=1e-2, weight_decay=0.1,
                            state_dtype=getattr(jnp, state_dtype))
    tcfg = topt.AdamWConfig(lr=1e-2, weight_decay=0.1,
                            state_dtype=getattr(torch, state_dtype))
    params = _tree(0, bf16_params)
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = jopt.adamw_init(jp, jcfg), topt.adamw_init(tp, tcfg)
    ip = jax.tree_util.tree_map(torch.clone, tp)      # the in-place copy
    ist = jax.tree_util.tree_map(torch.clone, ts)
    monkeypatch.setattr(topt, "SLICE_ELEMS", 7)       # every leaf sliced
    for step in range(3):
        grads = _tree(10 + step, bf16_params)
        jp, js = jopt.adamw_update(jp, _to_jax(grads), js, jcfg, lr_scale)
        tp, ts = topt.adamw_update(tp, _to_torch(grads), ts, tcfg, lr_scale)
        topt.adamw_update_(ip, _to_torch(grads), ist, tcfg, lr_scale)
        _close(tp, jp)
        _close(ts, js)
        _equal(ip, tp)
        _equal(ist, ts)
    assert int(ts["count"]) == 3


def test_sgdm_matches_reference():
    params = _tree(1)
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = jopt.sgdm_init(jp), topt.sgdm_init(tp)
    for step in range(3):
        grads = _tree(20 + step)
        jp, js = jopt.sgdm_update(jp, _to_jax(grads), js, lr=0.05, beta=0.8)
        tp, ts = topt.sgdm_update(tp, _to_torch(grads), ts, lr=0.05, beta=0.8)
    _close(tp, jp)
    _close(ts, js)


@pytest.mark.parametrize("bf16_params", [False, True])
def test_adafactor_matches_reference(bf16_params):
    params = _tree(2, bf16_params)
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = jopt.adafactor_init(jp), topt.adafactor_init(tp)
    _close(ts, js)
    for step in range(3):
        grads = _tree(30 + step, bf16_params)
        jp, js = jopt.adafactor_update(jp, _to_jax(grads), js, lr=0.03)
        tp, ts = topt.adafactor_update(tp, _to_torch(grads), ts, lr=0.03)
        _close(tp, jp)
        _close(ts, js)


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
@pytest.mark.parametrize("bf16", [False, True])
def test_clip_by_global_norm_matches_reference(max_norm, bf16, monkeypatch):
    grads = _tree(3, bf16)
    jg, jn = jopt.clip_by_global_norm(_to_jax(grads), max_norm)
    tg, tn = topt.clip_by_global_norm(_to_torch(grads), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=TOL)
    _close(tg, jg)
    monkeypatch.setattr(topt, "SLICE_ELEMS", 5)
    ig = _to_torch(grads)
    _, tn_sliced = topt.clip_by_global_norm(_to_torch(grads), max_norm)
    norm = topt.clip_by_global_norm_(ig, max_norm)
    assert torch.equal(norm, tn_sliced)
    np.testing.assert_allclose(float(norm), float(jn), rtol=TOL)
    _close(ig, jg)


@pytest.mark.parametrize("step", [0, 1, 5, 10, 37, 100, 250])
def test_schedules_match_reference(step):
    for total, warmup, floor in ((200, 10, 0.1), (100, 0, 0.0), (50, 60, 0.2)):
        want = jopt.cosine_schedule(jnp.int32(step), total, warmup, floor)
        got = topt.cosine_schedule(torch.tensor(step, dtype=torch.int32),
                                   total, warmup, floor)
        np.testing.assert_allclose(float(got), float(want), atol=TOL, rtol=TOL)
    for warmup in (0, 7, 100):
        np.testing.assert_allclose(
            float(topt.linear_warmup(step, warmup)),
            float(jopt.linear_warmup(jnp.int32(step), warmup)), atol=TOL, rtol=TOL)
