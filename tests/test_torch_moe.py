"""The port's MoE FFN (``repro_torch.models.moe``) against the JAX
reference's ``models/moe.py``, on the CPU.

Both sides run on the same parameters (the reference's ``moe_init``,
carried across as numpy arrays) and the same numpy-seeded tokens.

Tolerance: the routing integers (experts, dispatch ranks, keeps, counts)
are held bit for bit; the router's weights and aux loss within 1e-6
(float32 softmax and a division, a few ulps); the FFN output within
1e-4 absolute and relative in float32, as ``tests/test_torch_lm.py``
holds the dense LMs: the two sides differ only in summation order (XLA
against torch's CPU BLAS, sums of at most 128 terms) and in exp ulps.
A wrong expert, rank, drop or gate moves outputs by 1e-2 or more.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.models import moe as jmoe
from repro_torch.models import moe

TOL = 1e-4


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree(tree):
    if isinstance(tree, dict):
        return {k: _tree(v) for k, v in tree.items()}
    return _t(tree)


def _case(n_experts, top_k, n_shared=0, t=64, d=32, f=48, seed=0):
    cfg = dict(n_experts=n_experts, top_k=top_k, d_model=d, d_ff=f,
               n_shared=n_shared)
    jparams = jax.tree_util.tree_map(
        np.asarray, jmoe.moe_init(jax.random.key(seed), jmoe.MoEConfig(**cfg)))
    x = np.random.default_rng(seed + 1).normal(size=(t, d)).astype(np.float32)
    return jmoe.MoEConfig(**cfg), moe.MoEConfig(**cfg), jparams, x


@pytest.mark.parametrize("e,k", [(4, 2), (8, 2), (64, 6)])
def test_router_topk_matches(e, k):
    _, _, jparams, x = _case(e, k, d=64, seed=e)
    want_w, want_idx, want_aux = jmoe.router_topk(jparams["router"], x, k)
    w, idx, aux = moe.router_topk(_t(jparams["router"]), _t(x), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    _close(w, want_w, 1e-6)
    _close(aux, want_aux, 1e-6)
    assert w.dtype == torch.float32 and aux.dtype == torch.float32


def test_router_ties_go_to_the_lower_expert():
    """A zero input gives every expert the gate 1/E: experts 0..k-1, in
    order, as ``jax.lax.top_k`` picks them."""
    router = np.random.default_rng(0).normal(size=(16, 8)).astype(np.float32)
    x = np.zeros((5, 16), np.float32)
    _, want_idx, _ = jmoe.router_topk(router, x, 3)
    w, idx, _ = moe.router_topk(_t(router), _t(x), 3)
    np.testing.assert_array_equal(np.asarray(want_idx), np.tile([0, 1, 2], (5, 1)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    _close(w, np.full((5, 3), 1 / 3), 1e-6)


@pytest.mark.parametrize("e,k,cap", [(4, 2, 8), (4, 2, 64), (64, 6, 8), (8, 2, 1)])
def test_build_dispatch_matches(e, k, cap):
    """Ranks, keeps and counts bit-equal, with experts skewed toward 0 so
    that some overflow the capacity."""
    rng = np.random.default_rng(e + cap)
    idx = np.minimum(rng.geometric(0.3, size=(64, k)) - 1, e - 1).astype(np.int32)
    want = jmoe.build_dispatch(jnp.asarray(idx), e, cap)
    got = moe.build_dispatch(_t(idx).long(), e, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not bool(got[1].all()) or cap == 64


@pytest.mark.parametrize("e,k,n_shared", [(4, 2, 0), (4, 2, 1), (64, 6, 2), (8, 2, 0)])
def test_moe_ffn_matches(e, k, n_shared):
    jcfg, tcfg, jparams, x = _case(e, k, n_shared, seed=3)
    want, want_aux = jmoe.moe_ffn(jparams, x, jcfg)
    got, aux = moe.moe_ffn(_tree(jparams), _t(x), tcfg)
    assert got.shape == (64, 32) and got.dtype == torch.float32
    _close(got, want)
    _close(aux, want_aux, 1e-6)


def test_moe_ffn_forced_drops_match():
    """capacity 8 over 64 tokens, top-2 of 4 experts: 128 assignments
    for 32 slots, so most are dropped, the same ones on both sides."""
    jcfg, tcfg, jparams, x = _case(4, 2, seed=5)
    want, _ = jmoe.moe_ffn(jparams, x, jcfg, capacity=8)
    got, _ = moe.moe_ffn(_tree(jparams), _t(x), tcfg, capacity=8)
    _close(got, want)
    _, idx, _ = moe.router_topk(_t(jparams["router"]), _t(x), 2)
    _, keep, counts = moe.build_dispatch(idx, 4, 8)
    assert int(keep.sum()) <= 32 and int(counts.sum()) == 128
    # a token whose both assignments dropped gets no routed output
    dropped = ~keep.any(1)
    assert bool(dropped.any()) and float(got[dropped].abs().max()) == 0.0


@pytest.mark.parametrize("e,k,n_shared", [(4, 2, 1), (64, 6, 2)])
def test_moe_ffn_dense_matches_reference_without_drops(e, k, n_shared):
    """``moe_ffn_dense`` (every expert on every token; the check that
    ``chip_smoke.py`` and the GPU tests hold ``moe_ffn`` to) against the
    reference's ``moe_ffn`` at a capacity of T, where nothing drops."""
    jcfg, tcfg, jparams, x = _case(e, k, n_shared, seed=7)
    want, _ = jmoe.moe_ffn(jparams, x, jcfg, capacity=64)
    _close(moe.moe_ffn_dense(_tree(jparams), _t(x), tcfg), want)
    _close(moe.moe_ffn(_tree(jparams), _t(x), tcfg, capacity=64)[0], want)


@pytest.mark.parametrize("e,k,t", [(4, 2, 64), (64, 6, 64), (8, 2, 1)])
def test_no_drop_keeps_every_assignment(e, k, t):
    """``no_drop``: a capacity of at least T, so every assignment is kept
    even when every token picks the same experts; the reference's
    ``moe_ffn`` at that capacity factor gives the same output."""
    jcfg, tcfg, jparams, x = _case(e, k, seed=11, t=t)
    cfg = moe.no_drop(tcfg)
    cap = moe.moe_capacity(cfg, t)
    assert cap >= t
    same = torch.arange(k).repeat(t, 1)          # all tokens on experts 0..k-1
    _, keep, _ = moe.build_dispatch(same, e, cap)
    assert bool(keep.all())
    want, _ = jmoe.moe_ffn(jparams, x, dataclasses.replace(
        jcfg, capacity_factor=cfg.capacity_factor))
    _close(moe.moe_ffn(_tree(jparams), _t(x), cfg)[0], want)


def test_moe_init_tree_matches_reference():
    """The reference's tree, leaf shapes and dtypes; the router float32
    under a bf16 dtype."""
    cfg = dict(n_experts=8, top_k=2, d_model=16, d_ff=24, n_shared=2)
    want = jax.eval_shape(lambda k: jmoe.moe_init(k, jmoe.MoEConfig(**cfg),
                                                  dtype=jnp.bfloat16),
                          jax.random.key(0))
    gen = torch.Generator().manual_seed(0)
    got = moe.moe_init(gen, moe.MoEConfig(**cfg), dtype=torch.bfloat16)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (_, g), (_, w) in zip(flat_g, flat_w):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[-1] == jnp.dtype(w.dtype).name


# The two MoE properties of tests/test_property.py, on the port.
@settings(deadline=None, max_examples=6)
@given(st.integers(0, 2**31 - 1))
def test_moe_zero_input_zero_output(seed):
    cfg = moe.MoEConfig(n_experts=4, top_k=2, d_model=16, d_ff=32,
                        capacity_factor=4.0)
    params = moe.moe_init(torch.Generator().manual_seed(seed % 100), cfg)
    out, _ = moe.moe_ffn(params, torch.zeros((8, 16)), cfg)
    assert float(out.abs().max()) == 0.0  # SwiGLU(0) = 0


@settings(deadline=None, max_examples=6)
@given(st.integers(0, 2**31 - 1))
def test_moe_capacity_drop_is_graceful(seed):
    """A capacity that drops assignments never gives NaN."""
    cfg = moe.MoEConfig(n_experts=4, top_k=2, d_model=16, d_ff=32)
    params = moe.moe_init(torch.Generator().manual_seed(seed % 100), cfg)
    x = torch.from_numpy(
        np.random.default_rng(seed).normal(size=(8, 16)).astype(np.float32))
    out, _ = moe.moe_ffn(params, x, cfg, capacity=8)
    assert not bool(torch.isnan(out).any())
