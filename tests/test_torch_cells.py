"""Every (arch, shape) cell of the reference, built by the port's
``build_cell`` on one device, and the websearch-rl cells against the
reference's, on the CPU.

- Every cell of the reference's ``list_archs()`` builds at its full
  shape with ``meta`` arguments (shapes and dtypes, no data).
- Each reduced cell's step runs on the CPU from numpy-seeded inputs
  without NaNs, and its outputs have the shapes and dtypes of the
  reference cell's ``jax.eval_shape`` (the reference's uint32 words are
  the port's int32 words).
- The two reduced websearch cells, on both port backends, against the
  reference's ``xla`` cell on the same numpy inputs: ``cand``, ``u`` and
  ``cand_cnt`` bit-equal (integers); the train step's ``q_new`` and
  metrics within 1e-6 (the TD sums in float64 then rounded once here,
  in float32 in transition order there; ``test_torch_train_system.py``'s
  tolerance), with the reference key's ε-greedy draws (``jax_draws``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import list_archs as jax_list_archs
from repro.core.state_bins import StateBins as JStateBins
from repro.launch.steps import REDUCED_SHAPES as JAX_REDUCED
from repro.launch.steps import build_cell as jax_build_cell
from repro_torch.configs import get_arch, list_archs
from repro_torch.core.state_bins import StateBins
from repro_torch.launch.steps import REDUCED_SHAPES, _lm_opt_cfg, build_cell
from repro_torch.models import recsys as trec
from repro_torch.models.transformer import init_kv_cache, init_params
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.tree import tree_leaves

from test_torch_gnn import _cell_inputs
from test_torch_recsys_train import INITS, _batch
from test_torch_train_step import one_torch_thread  # noqa: F401
from test_torch_train_system import jax_draws

ALL_CELLS = [(a, s) for a, arch in sorted(jax_list_archs().items())
             for s in arch.shapes]
Q_TOL = 1e-6


def _leaves(tree):
    """``tree_leaves``, with a ``StateBins`` as its two edge tensors (a
    pytree node in the reference)."""
    if isinstance(tree, StateBins):
        return [tree.u_edges, tree.v_edges]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return tree_leaves(tree)


def test_port_lists_every_reference_arch_and_unknown_ids_raise():
    assert sorted(list_archs()) == sorted(jax_list_archs())
    for arch_id, arch in jax_list_archs().items():
        assert sorted(get_arch(arch_id).shapes) == sorted(arch.shapes)
        assert get_arch(arch_id).family == arch.family
    with pytest.raises(KeyError):
        get_arch("no-such-arch")
    with pytest.raises(KeyError):
        jax_get_arch("no-such-arch")


@pytest.mark.parametrize("arch_id,shape", ALL_CELLS)
def test_full_cell_builds_with_meta_args(arch_id, shape):
    cell = build_cell(arch_id, shape)
    jcell = jax_build_cell(arch_id, shape)
    assert cell.donate_argnums == jcell.donate_argnums
    leaves = _leaves(cell.args)
    assert leaves and all(t.device.type == "meta" for t in leaves)
    want = [a for a in jax.tree_util.tree_leaves(jcell.args)
            if not jax.dtypes.issubdtype(a.dtype, jax.dtypes.prng_key)]
    if get_arch(arch_id).family == "websearch" and shape == "rl_rollout":
        leaves = leaves[:-2]            # the draws, where the reference's key is
    assert [tuple(t.shape) for t in leaves] == [tuple(a.shape) for a in want]


def test_full_gnn_and_websearch_args_at_published_shapes():
    occ = build_cell("websearch-rl", "serve_queries").args[2]
    assert tuple(occ.shape) == (256, 4096, 4, 4, 128) and occ.dtype == torch.int32
    scores = build_cell("websearch-rl", "rl_rollout").args[3]
    assert tuple(scores.shape) == (256, 16_777_216)
    ogb = build_cell("graphsage-reddit", "ogb_products")
    assert tuple(ogb.args[3].shape) == (2, 61_859_140)
    assert tuple(ogb.args[2].shape) == (2_449_029, 100)
    mb = build_cell("graphsage-reddit", "minibatch_lg")
    assert tuple(mb.args[2].shape) == (180_224, 602)     # fr0
    assert ogb.args[0]["layer_1"]["w_neigh"].shape == (128, 47)


# ------------------------------------------------------- reduced steps
def _lm_inputs(arch_id, kind, rng):
    cfg = get_arch(arch_id).model_cfg(True)
    sp = REDUCED_SHAPES[kind]
    b, s = sp["global_batch"], sp["seq_len"]
    params = init_params(cfg, seed=0, device="cpu")
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))
    if kind == "train":
        tgt = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)).astype(np.int32))
        return params, adamw_init(params, _lm_opt_cfg(True)), tok, tgt
    if kind == "prefill":
        return params, tok
    return (params, tok[:, 0], init_kv_cache(cfg, b, s, device="cpu"),
            torch.full((b,), s // 2, dtype=torch.int32))


def _recsys_inputs(arch_id, kind, jcell, rng):
    cfg = get_arch(arch_id).model_cfg(True)
    jcfg = jax_get_arch(arch_id).model_cfg(True)
    params = getattr(trec, INITS[arch_id])(cfg, seed=0, device="cpu")
    if kind == "train":
        batch = [torch.from_numpy(x) for x in _batch(arch_id, jcfg, jcell)]
        return (params, adamw_init(params, AdamWConfig(lr=1e-3)), *batch)
    shapes = [a.shape for a in jcell.args[1:]]
    if arch_id == "bert4rec":
        return params, torch.from_numpy(
            rng.integers(0, cfg.n_items, shapes[0]).astype(np.int32))
    return (params,
            torch.from_numpy(rng.integers(0, cfg.vocab_per_field,
                                          shapes[0]).astype(np.int32)),
            torch.from_numpy(rng.normal(size=shapes[1]).astype(np.float32)))


def _gnn_inputs(shape, cell):
    from repro_torch.models.gnn import sage_init

    batch = [torch.from_numpy(x) for x in _cell_inputs(shape)]
    n_params = len(cell.donate_argnums) - 1
    sp = REDUCED_SHAPES[get_arch("graphsage-reddit").shape(shape).kind]
    cfg = dataclasses.replace(get_arch("graphsage-reddit").model_cfg(True),
                              d_in=sp["d_feat"], n_classes=sp["n_classes"])
    params = sage_init(cfg, seed=0, device="cpu")
    state = (params,)
    if n_params == 2:
        g = torch.Generator().manual_seed(1)
        state = (params, {"w": torch.randn(cfg.n_classes, sp["n_classes"],
                                           generator=g),
                          "b": torch.zeros(sp["n_classes"])})
    opt = adamw_init(state if n_params == 2 else params, AdamWConfig(lr=1e-3))
    return (*state, opt, *batch)


def _websearch_inputs(seed=0):
    """numpy inputs of the reduced websearch cells: occupancy with a
    bit density 2^-k per (query, term, field) plane, k in [1, 4], 2-4
    present terms (absent terms' planes empty), normal scores, a normal
    q table whose rules lie above reset and stop, and geometric bin
    edges."""
    wcfg = jax_get_arch("websearch-rl").model_cfg(True)
    b = JAX_REDUCED["serve_websearch"]["query_batch"]
    rng = np.random.default_rng(seed)
    w = wcfg.block_docs // 32
    t, f = 4, 4
    k = rng.integers(1, 5, (b, 1, t, f, 1))
    occ = np.full((b, wcfg.n_blocks, t, f, w), 0xFFFFFFFF, np.uint32)
    for i in range(1, 5):
        words = rng.integers(0, 2**32, occ.shape, dtype=np.uint32)
        occ &= np.where(k >= i, words, np.uint32(0xFFFFFFFF))
    n_terms = rng.integers(2, 5, b)
    tp = np.arange(t)[None, :] < n_terms[:, None]
    occ &= np.where(tp[:, None, :, None, None], np.uint32(0xFFFFFFFF), 0)
    scores = rng.normal(size=(b, wcfg.n_blocks * wcfg.block_docs)).astype(np.float32)
    q = rng.normal(scale=0.05, size=(wcfg.p_bins, wcfg.k_rules + 2)).astype(np.float32)
    q[:, wcfg.k_rules:] -= 0.1          # reset and stop below the rules
    pu = int(np.sqrt(wcfg.p_bins))
    pv = wcfg.p_bins // pu
    u_edges = np.geomspace(2, wcfg.u_budget, pu - 1).astype(np.float32)
    v_edges = np.tile(np.geomspace(1, 4096, pv - 1), (pu, 1)).astype(np.float32)
    prod_r = rng.normal(scale=0.1, size=(b, wcfg.t_max)).astype(np.float32)
    return q, (u_edges, v_edges), occ, scores, tp, prod_r


def _websearch_port(inputs, shape):
    q, (ue, ve), occ, scores, tp, prod_r = inputs
    args = [torch.from_numpy(q), StateBins(torch.from_numpy(ue), torch.from_numpy(ve)),
            torch.from_numpy(occ.view(np.int32)), torch.from_numpy(scores),
            torch.from_numpy(tp)]
    if shape == "rl_rollout":
        args.append(torch.from_numpy(prod_r))
        wcfg = get_arch("websearch-rl").model_cfg(True)
        args.append(jax_draws(jax.random.key(3), wcfg.t_max, occ.shape[0],
                              wcfg.k_rules + 2))
    return args


def _websearch_jax(inputs, shape):
    q, (ue, ve), occ, scores, tp, prod_r = inputs
    args = [jnp.asarray(q), JStateBins(jnp.asarray(ue), jnp.asarray(ve)),
            jnp.asarray(occ), jnp.asarray(scores), jnp.asarray(tp)]
    if shape == "rl_rollout":
        args += [jnp.asarray(prod_r), jax.random.key(3)]
    return args


def _inputs(arch_id, shape, cell, jcell):
    rng = np.random.default_rng(21)
    family = get_arch(arch_id).family
    kind = get_arch(arch_id).shape(shape).kind
    if family == "lm":
        return _lm_inputs(arch_id, kind, rng)
    if family == "recsys":
        return _recsys_inputs(arch_id, kind, jcell, rng)
    if family == "gnn":
        return _gnn_inputs(shape, cell)
    return _websearch_port(_websearch_inputs(), shape)


def _dtype_name(dt):
    name = jnp.dtype(dt).name
    return "int32" if name == "uint32" else name


@pytest.mark.parametrize("arch_id,shape", ALL_CELLS)
def test_reduced_step_runs_and_matches_reference_shapes(arch_id, shape):
    cell = build_cell(arch_id, shape, reduced=True)
    jcell = jax_build_cell(arch_id, shape, reduced=True)
    want = jax.tree_util.tree_leaves(jax.eval_shape(jcell.fn, *jcell.args))
    with torch.no_grad() if "train" not in get_arch(arch_id).shape(shape).kind \
            else torch.enable_grad():
        out = cell.fn(*_inputs(arch_id, shape, cell, jcell))
    got = tree_leaves(out)
    assert [tuple(t.shape) for t in got] == [tuple(a.shape) for a in want]
    assert ([str(t.dtype).removeprefix("torch.") for t in got]
            == [_dtype_name(a.dtype) for a in want])
    for t in got:
        assert t.device.type == "cpu"
        if t.is_floating_point():
            assert not torch.isnan(t).any()


# ------------------------------------------- websearch against the reference
@pytest.mark.parametrize("backend", ["reference", "block_scan"])
@pytest.mark.parametrize("shape", ["serve_queries", "rl_rollout"])
def test_websearch_cell_matches_reference(shape, backend):
    jcell = jax_build_cell("websearch-rl", shape, reduced=True)
    assert jax_get_arch("websearch-rl").model_cfg(True).backend == "xla"
    tcfg = dataclasses.replace(get_arch("websearch-rl").model_cfg(True),
                               backend=backend)
    cell = build_cell("websearch-rl", shape, reduced=True, cfg_override=tcfg)
    inputs = _websearch_inputs(seed=4)
    want = jax.jit(jcell.fn)(*_websearch_jax(inputs, shape))
    got = cell.fn(*_websearch_port(inputs, shape))
    if shape == "serve_queries":
        for g, w, name in zip(got, want, ("cand", "u", "cand_cnt")):
            w = np.asarray(w)
            np.testing.assert_array_equal(
                g.numpy(), w.view(np.int32) if w.dtype == np.uint32 else w,
                err_msg=name)
        assert int(got[2].sum()) > 0 and int(got[1].min()) > 0
        return
    (q_new, metrics), (jq, jmetrics) = got, want
    np.testing.assert_allclose(q_new.numpy(), np.asarray(jq), rtol=Q_TOL,
                               atol=Q_TOL)
    assert sorted(metrics) == sorted(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=Q_TOL, atol=Q_TOL, err_msg=k)
    assert not np.array_equal(q_new.numpy(), inputs[0])
