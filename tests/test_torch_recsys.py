"""The port's recsys models against the JAX reference, on the CPU.

Both packages run on the same weights (the reference's ``*_init``,
carried across by ``recsys_params_from_reference``) and the same
numpy-seeded ids, at the reduced configs of the four archs and the
reduced serve and retrieval shapes of ``launch/steps.py``.

Tolerance: 1e-4 (absolute and relative), in float32 on both sides.  The
two sides differ only in summation order (XLA against torch's CPU BLAS,
sums of at most a few hundred terms) and in exp/rsqrt ulps: a few 1e-7
on logits of order 0.1-1.  A real fault (a field offset, a mask, a
norm, a missing term) moves the logits by 1e-3 or more.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.launch.steps import REDUCED_SHAPES
from repro.models import layers as jlayers
from repro.models import recsys as jrec
from repro_torch.configs import get_arch
from repro_torch.models import layers, recsys
from repro_torch.weights import recsys_params_from_reference

TOL = 1e-4
CTR = {"wide-deep": ("wide_deep_init", "wide_deep_forward"),
       "deepfm": ("deepfm_init", "deepfm_forward"),
       "dcn-v2": ("dcn_init", "dcn_forward")}
ARCHS = [*CTR, "bert4rec"]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


def _cfgs(arch_id, **changes):
    jcfg = dataclasses.replace(jax_get_arch(arch_id).model_cfg(True), **changes)
    tcfg = dataclasses.replace(get_arch(arch_id).model_cfg(True), **changes)
    return jcfg, tcfg


def _params(init_name, jcfg, tcfg, seed=0):
    jparams = getattr(jrec, init_name)(jax.random.key(seed), jcfg)
    tparams = recsys_params_from_reference(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    return jparams, tparams


def test_layer_norm_matches():
    rng = np.random.default_rng(0)
    x, w, b = (rng.normal(size=s).astype(np.float32)
               for s in ((3, 7, 32), (32,), (32,)))
    _close(layers.layer_norm(*(torch.from_numpy(a) for a in (x, w, b))),
           jlayers.layer_norm(x, w, b))


@pytest.mark.parametrize("arch_id,changes", [
    ("wide-deep", {}),
    ("wide-deep", {"n_dense": 3}),     # the wide_dense term and dense input
    ("deepfm", {}),
    ("dcn-v2", {}),
])
def test_ctr_forward_matches(arch_id, changes):
    jcfg, tcfg = _cfgs(arch_id, **changes)
    init_name, fwd_name = CTR[arch_id]
    jparams, tparams = _params(init_name, jcfg, tcfg, seed=1)
    b = REDUCED_SHAPES["serve"]["batch"]
    rng = np.random.default_rng(2)
    ids = rng.integers(0, jcfg.vocab_per_field, (b, jcfg.n_sparse)).astype(np.int32)
    dense = rng.normal(size=(b, max(jcfg.n_dense, 1))).astype(np.float32)
    want = getattr(jrec, fwd_name)(jparams, jnp.asarray(ids), jcfg,
                                   jnp.asarray(dense))
    got = getattr(recsys, fwd_name)(tparams, ids, tcfg, torch.from_numpy(dense),
                                    device="cpu")
    assert got.shape == (b,) and got.dtype == torch.float32
    _close(got, want)
    labels = rng.integers(0, 2, b).astype(np.float32)
    _close(recsys.bce_loss(got, torch.from_numpy(labels)),
           jrec.bce_loss(want, jnp.asarray(labels)))


def _b4r_case():
    jcfg, tcfg = _cfgs("bert4rec")
    jparams, tparams = _params("bert4rec_init", jcfg, tcfg, seed=3)
    rng = np.random.default_rng(4)
    seq = rng.integers(0, jcfg.n_items, (4, jcfg.seq_len)).astype(np.int32)
    seq[:, :5] = jcfg.n_items                      # leading [PAD]s are masked
    seq[1, -1] = jcfg.n_items + 1                  # a [MASK] position
    return jcfg, tcfg, jparams, tparams, seq


def test_bert4rec_forward_and_scores_match():
    jcfg, tcfg, jparams, tparams, seq = _b4r_case()
    want = jrec.bert4rec_forward(jparams, jnp.asarray(seq), jcfg)
    got = recsys.bert4rec_forward(tparams, seq, tcfg, device="cpu")
    _close(got, want)
    _close(recsys.bert4rec_score_items(tparams, got[:, -1], tcfg),
           jrec.bert4rec_score_items(jparams, want[:, -1], jcfg))


def test_retrieval_topk_matches():
    """One user state against the item table (the BERT4Rec
    retrieval_cand path).  Scores must agree to the tolerance.  Two
    scores closer than twice the largest difference between the two
    sides' scores may swap places, so the indices must agree wherever a
    score stands further than that from both of its neighbours, and
    wherever two neighbours are exactly equal on both sides (ties go to
    the lower index on both)."""
    jcfg, tcfg, jparams, tparams, seq = _b4r_case()
    user = recsys.bert4rec_forward(tparams, seq[:1], tcfg, device="cpu")[0, -1]
    juser = jnp.asarray(user.numpy())
    table = tparams["item_embed"][: tcfg.n_items]
    jtable = jparams["item_embed"][: jcfg.n_items]
    vals, idx = recsys.retrieval_topk(user, table, k=100)
    jvals, jidx = jrec.retrieval_topk(juser, jtable, k=100)
    _close(vals, jvals)
    err = float(np.abs((table @ user).numpy() - np.asarray(jtable @ juser)).max())
    assert err < TOL
    jgaps = np.abs(np.diff(np.asarray(jvals)))
    gaps = np.abs(np.diff(vals.numpy()))
    near = (jgaps <= 2 * err) & ~((jgaps == 0) & (gaps == 0))
    apart = np.ones(100, bool)
    apart[:-1] &= ~near
    apart[1:] &= ~near
    assert apart.sum() > 90
    np.testing.assert_array_equal(idx.numpy()[apart], np.asarray(jidx)[apart])


@pytest.mark.parametrize("k", [1, 7, 40])
def test_retrieval_topk_ties_match_reference(k):
    """Duplicated candidate rows score exactly alike on both sides:
    ``retrieval_topk`` gives ``jax.lax.top_k``'s indices, lower index
    first among the ties, values equal; also with every score tied, with
    ties straddling the k-th place and with -0.0 against 0.0."""
    rng = np.random.default_rng(k)
    # small integers: every dot product is exact in fp32, so the ties are
    # exact on both sides whatever the order of the sums
    base = rng.integers(-3, 4, size=(12, 8)).astype(np.float32)
    cand = base[rng.integers(0, 12, size=60)]              # many duplicates
    query = rng.integers(-3, 4, size=8).astype(np.float32)
    cases = [cand, np.ones((60, 8), np.float32),
             np.concatenate([cand[:30], -cand[:30]])]
    zero = np.zeros((60, 8), np.float32)
    zero[::2, 0] = -0.0
    zero[1::3, 0] = 1.0
    cases.append(zero)
    for c in cases:
        vals, idx = recsys.retrieval_topk(torch.from_numpy(query),
                                          torch.from_numpy(c), k=k)
        jvals, jidx = jrec.retrieval_topk(jnp.asarray(query), jnp.asarray(c),
                                          k=k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("arch_id", ARCHS)
def test_init_tree_matches_reference(arch_id):
    """The port's own random parameters: the reference's tree, leaf
    shapes and dtypes, drawn from a seeded generator (same seed, same
    values)."""
    jcfg, tcfg = _cfgs(arch_id)
    init_name = CTR[arch_id][0] if arch_id in CTR else "bert4rec_init"
    want = jax.eval_shape(lambda k: getattr(jrec, init_name)(k, jcfg),
                          jax.random.key(0))
    got = getattr(recsys, init_name)(tcfg, seed=5, device="cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert sorted(str(p) for p, _ in flat_g) == sorted(str(p) for p, _ in flat_w)
    shapes = {str(p): w.shape for p, w in flat_w}
    for p, g in flat_g:
        assert tuple(g.shape) == shapes[str(p)] and g.dtype == torch.float32
        assert torch.isfinite(g).all()
    again = getattr(recsys, init_name)(tcfg, seed=5, device="cpu")
    key = "embed" if arch_id in CTR else "item_embed"
    assert torch.equal(got[key], again[key]) and got[key].std() > 0


@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch_id", ARCHS)
def test_configs_equal_reference(arch_id, reduced):
    jarch, tarch = jax_get_arch(arch_id), get_arch(arch_id)
    assert (tarch.family, tarch.source, tarch.notes) == \
        (jarch.family, jarch.source, jarch.notes)
    assert {k: dataclasses.asdict(v) for k, v in tarch.shapes.items()} == \
        {k: dataclasses.asdict(v) for k, v in jarch.shapes.items()}
    jcfg, tcfg = jarch.model_cfg(reduced), tarch.model_cfg(reduced)
    for f in dataclasses.fields(tcfg):
        want, got = getattr(jcfg, f.name), getattr(tcfg, f.name)
        if isinstance(got, torch.dtype):
            want = getattr(torch, jnp.dtype(want).name)
        assert got == want, f.name
    assert [f.name for f in dataclasses.fields(tcfg)] == \
        [f.name for f in dataclasses.fields(jcfg)]


def test_mesh_is_refused():
    """A ``mesh`` that is not a ``DeviceMesh`` is refused with a clear
    error (the sharded forwards, on a real mesh, are held against the
    reference's in ``tests/test_torch_mesh.py``)."""
    jcfg, tcfg = _cfgs("deepfm")
    params = recsys.deepfm_init(tcfg, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        recsys.deepfm_forward(params, np.zeros((2, 6), np.int32), tcfg,
                              mesh=object(), device="cpu")
