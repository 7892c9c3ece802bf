"""The port's recsys train steps and the bag's gradient against the JAX
reference, on the CPU.

``embedding_bag_backward`` (the bag's gradient, plain torch in a fixed
order) against ``jax.vjp`` of the reference's ``embedding_bag_ref``, and
``take_rows``' gradient against that of ``jnp.take``: within 1e-6, in
float32; they differ only in the order of sums of a few terms.

The train steps of the four reduced recsys archs
(``build_cell(arch, "train_batch", reduced=True)``) against the
reference's, from the reference's ``*_init`` weights, zero AdamW state
and the same numpy-seeded batch: the loss within 1e-4, each gradient
leaf within 1e-4 relative L2, the new parameters within 1e-5 +
1e-4|p| (the exemption of near-zero gradients and its 0.1 % bound as in
``test_torch_train_step.py``; the first AdamW step here moves elements
by lr = 1e-3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jax_bag_ref
from repro.launch.steps import build_cell as jax_build_cell
from repro.models import recsys as jrec
from repro_torch.configs import get_arch
from repro_torch.kernels.embedding_bag import (embedding_bag,
                                               embedding_bag_backward,
                                               scatter_rows, take_rows)
from repro_torch.launch.steps import build_cell, recsys_loss, value_and_grad
from repro_torch.models import recsys as trec
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.tree import tree_leaves
from repro_torch.weights import recsys_params_from_reference

from test_torch_train_step import (  # noqa: F401
    EXEMPT_REL, EXEMPT_SHARE, TOL, _rel_l2, one_torch_thread)

BAG_TOL = 1e-6
INITS = {"wide-deep": "wide_deep_init", "deepfm": "deepfm_init",
         "dcn-v2": "dcn_init", "bert4rec": "bert4rec_init"}


# ------------------------------------------------------------ the bag
def _bag_case(seed, v=50, e=3, b=6, l=7, past_v=False):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(v, e)).astype(np.float32)
    idx = rng.integers(0, v, (b, l)).astype(np.int32)
    idx[:, 0] = 3                          # one id in every bag: a long run
    idx[1, 2:] = -1                        # padding
    idx[2, :] = -1                         # an empty bag
    if past_v:
        idx[4, 1] = v + 2                  # a NaN row, no table gradient
    w = rng.normal(size=(b, l)).astype(np.float32)
    g = rng.normal(size=(b, e)).astype(np.float32)
    return table, idx, w, g


@pytest.mark.parametrize("past_v", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_backward_matches_jax_vjp(mode, weighted, past_v):
    table, idx, w, g = _bag_case(1, past_v=past_v)
    wj = jnp.asarray(w) if weighted else None
    _, vjp = jax.vjp(lambda t, ww: jax_bag_ref(t, jnp.asarray(idx), ww, mode=mode),
                     jnp.asarray(table), wj)
    want_t, want_w = vjp(jnp.asarray(g))
    t = torch.from_numpy(table)
    got_t, got_w = embedding_bag_backward(
        torch.from_numpy(g), torch.from_numpy(idx),
        torch.from_numpy(w) if weighted else None, table.shape[0], mode,
        table=t)
    assert got_t.dtype == torch.float32 and got_t.shape == table.shape
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t),
                               atol=BAG_TOL, rtol=BAG_TOL)
    if weighted:
        np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w),
                                   atol=BAG_TOL, rtol=BAG_TOL)   # NaN at NaN
        assert np.isnan(got_w.numpy()).any() == past_v
    else:
        assert got_w is None

    # the wrapper's autograd runs the same backward
    tt = t.clone().requires_grad_()
    ww = torch.from_numpy(w).requires_grad_() if weighted else None
    out = embedding_bag(tt, torch.from_numpy(idx), ww, mode=mode)
    grads = torch.autograd.grad(out, [tt] + ([ww] if weighted else []),
                                grad_outputs=torch.from_numpy(g))
    assert torch.equal(grads[0], got_t)
    if weighted:
        np.testing.assert_array_equal(grads[1].numpy(), got_w.numpy())


def test_take_rows_gradient_matches_jnp_take_and_scatter_drops_outside():
    rng = np.random.default_rng(2)
    table = rng.normal(size=(20, 4)).astype(np.float32)
    idx = rng.integers(0, 6, (9, 5))                   # many repeats
    g = rng.normal(size=(9, 5, 4)).astype(np.float32)
    out, vjp = jax.vjp(lambda t: jnp.take(t, jnp.asarray(idx), axis=0),
                       jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_()
    got = take_rows(tt, torch.from_numpy(idx))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    (grad,) = torch.autograd.grad(got, tt, grad_outputs=torch.from_numpy(g))
    np.testing.assert_allclose(grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               atol=BAG_TOL, rtol=BAG_TOL)
    rows = torch.ones((4, 2))
    ids = torch.tensor([-1, 0, 3, 9])
    want = torch.tensor([[1.0, 1.0], [0, 0], [0, 0], [1.0, 1.0]])
    assert torch.equal(scatter_rows(rows, ids, 4, torch.float32), want)
    assert scatter_rows(rows[:0], ids[:0], 4, torch.bfloat16).dtype == torch.bfloat16


# ------------------------------------------------------ the train steps
def _jax_loss(arch_id, jcfg, params, batch):
    """The reference cell's loss, written out from its own modules (its
    ``_build_recsys`` train branch)."""
    if arch_id == "bert4rec":
        seq, mask_pos, mask_tgt, negs = batch
        h = jrec.bert4rec_forward(params, seq, jcfg)
        hm = jnp.take_along_axis(h, mask_pos[..., None], axis=1)
        emb = params["item_embed"]
        pos_s = jnp.sum(hm * jnp.take(emb, mask_tgt, axis=0), -1)
        neg_s = jnp.einsum("bme,bne->bmn", hm, jnp.take(emb, negs, axis=0))
        alls = jnp.concatenate([pos_s[..., None], neg_s], -1)
        return -jnp.mean(jax.nn.log_softmax(alls.astype(jnp.float32))[..., 0])
    sparse, dense, labels = batch
    fwd = {"wide-deep": lambda p: jrec.wide_deep_forward(p, sparse, jcfg, dense),
           "deepfm": lambda p: jrec.deepfm_forward(p, sparse, jcfg),
           "dcn-v2": lambda p: jrec.dcn_forward(p, sparse, jcfg, dense)}[arch_id]
    return jrec.bce_loss(fwd(params), labels)


def _batch(arch_id, jcfg, cell, seed=3):
    rng = np.random.default_rng(seed)
    shapes = [a.shape for a in cell.args[2:]]
    if arch_id == "bert4rec":
        seq = rng.integers(0, jcfg.n_items, shapes[0]).astype(np.int32)
        seq[:, :4] = jcfg.n_items                       # leading [PAD]s
        mask_pos = rng.integers(0, jcfg.seq_len, shapes[1]).astype(np.int32)
        seq[np.arange(shapes[0][0])[:, None], mask_pos] = jcfg.n_items + 1
        return (seq, mask_pos,
                rng.integers(0, jcfg.n_items, shapes[2]).astype(np.int32),
                rng.integers(0, jcfg.n_items, shapes[3]).astype(np.int32))
    return (rng.integers(0, jcfg.vocab_per_field, shapes[0]).astype(np.int32),
            rng.normal(size=shapes[1]).astype(np.float32),
            rng.integers(0, 2, shapes[2]).astype(np.float32))


@pytest.mark.parametrize("arch_id,changes", [
    ("wide-deep", {}),
    ("wide-deep", {"n_dense": 3}),     # the wide_dense term and dense input
    ("deepfm", {}),
    ("dcn-v2", {}),
    ("bert4rec", {}),
])
def test_recsys_train_step_matches_reference(arch_id, changes):
    jcfg = dataclasses.replace(jax_get_arch(arch_id).model_cfg(True), **changes)
    tcfg = dataclasses.replace(get_arch(arch_id).model_cfg(True), **changes)
    jcell = jax_build_cell(arch_id, "train_batch", reduced=True, cfg_override=jcfg)
    jparams = getattr(jrec, INITS[arch_id])(jax.random.key(4), jcfg)
    jopt = jax.tree_util.tree_map(lambda x: jnp.zeros(x.shape, x.dtype),
                                  jcell.args[1])
    batch = _batch(arch_id, jcfg, jcell)

    def ref(p, o, *bt):
        return (jcell.fn(p, o, *bt),
                jax.grad(lambda q: _jax_loss(arch_id, jcfg, q, bt))(p))

    (jnew, _, jloss), jgrads = jax.jit(ref)(jparams, jopt, *batch)

    params = recsys_params_from_reference(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    tbatch = [torch.from_numpy(x) for x in batch]
    loss0, grads = value_and_grad(
        lambda p: recsys_loss(arch_id, tcfg, p, *tbatch), params)
    cell = build_cell(arch_id, "train_batch", reduced=True, cfg_override=tcfg)
    opt = adamw_init(params, AdamWConfig(lr=1e-3))
    params, opt, loss = cell.fn(params, opt, *tbatch)

    np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL, atol=TOL)
    assert float(loss0) == float(loss)
    jg = [np.asarray(g) for g in jax.tree_util.tree_leaves(jgrads)]
    tg = [g.numpy() for g in tree_leaves(grads)]
    assert [g.shape for g in tg] == [g.shape for g in jg]
    for got, want in zip(tg, jg):
        assert _rel_l2(got, want) <= TOL
    exempt = total = 0
    for p_got, p_want, g_got, g_want in zip(
            tree_leaves(params), jax.tree_util.tree_leaves(jnew), tg, jg):
        p_got, p_want = p_got.numpy(), np.asarray(p_want)
        near_zero = np.abs(g_want) <= EXEMPT_REL * max(np.abs(g_want).max(), 1e-30)
        both_zero = (g_want == 0) & (g_got == 0)
        off = np.abs(p_got - p_want) > 1e-5 + 1e-4 * np.abs(p_want)
        assert not (off & ~(near_zero & ~both_zero)).any(), arch_id
        exempt += int(off.sum())
        total += off.size
    assert exempt < EXEMPT_SHARE * total
    assert int(opt["count"]) == 1


@pytest.mark.parametrize("arch_id", list(INITS))
def test_recsys_train_steps_lower_the_loss_and_cells_are_abstract(arch_id):
    """Three steps on one batch lower the loss each time, in place; the
    full cell's arguments are meta tensors at train_batch's 65,536."""
    jcfg = jax_get_arch(arch_id).model_cfg(True)
    tcfg = get_arch(arch_id).model_cfg(True)
    cell = build_cell(arch_id, "train_batch", reduced=True)
    params = getattr(trec, INITS[arch_id])(tcfg, seed=0, device="cpu")
    opt = adamw_init(params, AdamWConfig(lr=1e-3))
    batch = [torch.from_numpy(x) for x in _batch(arch_id, jcfg, cell, seed=5)]
    losses = [float(cell.fn(params, opt, *batch)[2]) for _ in range(3)]
    assert losses[0] > losses[1] > losses[2]
    full = build_cell(arch_id, "train_batch")
    assert full.donate_argnums == (0, 1)
    assert all(t.device.type == "meta" for t in tree_leaves(full.args))
    assert full.args[2].shape[0] == 65536
