"""The port's LM train step (``launch/steps.py``) against the JAX
reference's ``build_cell(arch, "train_4k", reduced=True).fn``, on the
CPU, for the five LM archs.

Both sides start from the reference's ``init_params`` (carried across
by ``lm_params_from_reference``), zero AdamW state and the same
numpy-seeded tokens, in float32.  Per step: the loss and the clipped
global norm within 1e-4, each gradient leaf (before the clip, the
microbatches accumulated) within 1e-4 relative L2, and the new
parameters elementwise within 1e-5 + 1e-4|p|.  The two sides differ
only in summation order (XLA against torch's CPU BLAS), a few 1e-6
relative on gradients of this size.  A first Adam step moves each
element by about lr * sign(g): where the reference's gradient is within
1e-5 of its leaf's largest |g| of zero (and not exactly zero on both
sides, where neither moves), the sign may differ by rounding alone.  An
element outside the parameter tolerance is exempt only there, and the
exempt elements must be fewer than 0.1 % of all.  A fault (a wrong accumulation, a missing
divide, a clip or moment in the wrong dtype) moves parameters by lr =
1e-4, ten times the tolerance, on most elements.

Cases: microbatch 1; microbatch 2 with float32 accumulation and
``remat=True``; microbatch 2 with bfloat16 accumulation (the same
cast on both sides).  With bfloat16 accumulation each gradient element
is rounded to bf16 twice, and a few 1e-6 of float32 difference before a
cast can round it to the neighbouring bf16 value on one side only: those
leaves are held within 2**-8 relative L2 (one bf16 rounding step,
3.9e-3) instead of 1e-4.  A wrong accumulation dtype or a missing
divide moves them by 1e-2 to 50 %.  The loss, the norm and the new
parameters keep their tolerances.  The port's ``remat=True`` step must
equal its ``remat=False`` step bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.launch.steps import build_cell as jax_build_cell
from repro.models import transformer as jtf
from repro_torch.configs import get_arch
from repro_torch.launch.steps import (_lm_opt_cfg, build_cell,
                                      lm_loss_and_grads)
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.tree import tree_leaves
from repro_torch.weights import lm_params_from_reference

TOL = 1e-4
BF16_ROUND = 2.0 ** -8      # one bf16 rounding step, relative
EXEMPT_REL = 1e-5
EXEMPT_SHARE = 1e-3
ARCHS = ["mistral-nemo-12b", "starcoder2-3b", "phi4-mini-3.8b",
         "deepseek-v2-lite-16b", "grok-1-314b"]
CASES = {"mb1": dict(),
         "mb2_fp32_remat": dict(microbatch=2, remat=True),
         "mb2_bf16": dict(microbatch=2)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch in each case.  Beside the other
    pytest-xdist workers, torch's OpenMP threads spin waiting for cores
    that those workers hold: a case of many small ops that takes 3 s
    alone took 214 s in a 6-worker run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_grads(jcfg, params, tokens, targets):
    """The reference's accumulation (``make_lm_train_step``'s scan body)
    written out per microbatch, from its own ``lm_loss``."""
    mb = max(1, jcfg.microbatch)
    loss_grad = jax.value_and_grad(
        lambda p, tk, tg: jtf.lm_loss(p, tk, tg, jcfg))
    if mb == 1:
        return loss_grad(params, tokens, targets)[1]
    b = tokens.shape[0] // mb
    acc = jax.tree_util.tree_map(
        lambda p: jnp.zeros(p.shape, jcfg.grad_accum_dtype), params)
    for i in range(mb):
        g = loss_grad(params, tokens[i * b:(i + 1) * b],
                      targets[i * b:(i + 1) * b])[1]
        acc = jax.tree_util.tree_map(
            lambda a, c: (a.astype(jnp.float32) + c.astype(jnp.float32)
                          ).astype(jcfg.grad_accum_dtype), acc, g)
    return jax.tree_util.tree_map(lambda g: g / mb, acc)


def _cfgs(arch_id, case):
    changes = dict(CASES[case])
    jcfg = dataclasses.replace(jax_get_arch(arch_id).model_cfg(True), **changes)
    tcfg = dataclasses.replace(get_arch(arch_id).model_cfg(True), **changes)
    if case == "mb2_bf16":
        jcfg = dataclasses.replace(jcfg, grad_accum_dtype=jnp.bfloat16)
        tcfg = dataclasses.replace(tcfg, grad_accum_dtype=torch.bfloat16)
    return jcfg, tcfg


def _inputs(arch_id, jcfg, seed=7):
    jparams = jtf.init_params(jax.random.key(1), jcfg)
    cell = jax_build_cell(arch_id, "train_4k", reduced=True, cfg_override=jcfg)
    b, s = cell.args[2].shape
    toks = np.random.default_rng(seed).integers(0, jcfg.vocab, (b, s + 1))
    return cell, jparams, toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def _port_step(arch_id, tcfg, np_params, tokens, targets):
    params = lm_params_from_reference(np_params, tcfg, device="cpu")
    loss, grads = lm_loss_and_grads(params, torch.from_numpy(tokens),
                                    torch.from_numpy(targets), tcfg)
    cell = build_cell(arch_id, "train_4k", reduced=True, cfg_override=tcfg)
    opt = adamw_init(params, _lm_opt_cfg(True))
    params, opt, metrics = cell.fn(params, opt, torch.from_numpy(tokens),
                                   torch.from_numpy(targets))
    return loss, grads, params, opt, metrics


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def check_against_reference(arch_id, case):
    """One step of each side from the same state; see the module's note."""
    jcfg, tcfg = _cfgs(arch_id, case)
    cell, jparams, tokens, targets = _inputs(arch_id, jcfg)
    jopt = jax.tree_util.tree_map(lambda x: jnp.zeros(x.shape, x.dtype),
                                  cell.args[1])

    def ref(p, o, tk, tg):
        return cell.fn(p, o, tk, tg), _jax_grads(jcfg, p, tk, tg)

    (jnew, _, jm), jgrads = jax.jit(ref)(jparams, jopt, tokens, targets)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    loss, grads, params, _, metrics = _port_step(arch_id, tcfg, np_params,
                                                 tokens, targets)

    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(loss), float(jm["loss"]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(jm["grad_norm"]), rtol=TOL, atol=TOL)
    jg_leaves = [np.asarray(g, np.float32) for g in jax.tree_util.tree_leaves(jgrads)]
    tg_leaves = [g.float().numpy() for g in tree_leaves(grads)]
    assert [g.shape for g in tg_leaves] == [g.shape for g in jg_leaves]
    grad_tol = BF16_ROUND if case == "mb2_bf16" else TOL
    for got, want in zip(tg_leaves, jg_leaves):
        assert _rel_l2(got, want) <= grad_tol

    exempt = total = 0
    for p_got, p_want, g_got, g_want in zip(
            tree_leaves(params), jax.tree_util.tree_leaves(jnew),
            tg_leaves, jg_leaves):
        p_got, p_want = p_got.numpy(), np.asarray(p_want)
        near_zero = np.abs(g_want) <= EXEMPT_REL * np.abs(g_want).max()
        both_zero = (g_want == 0) & (g_got == 0)
        off = np.abs(p_got - p_want) > 1e-5 + 1e-4 * np.abs(p_want)
        assert not (off & ~(near_zero & ~both_zero)).any(), (arch_id, case)
        exempt += int(off.sum())
        total += off.size
    assert exempt < EXEMPT_SHARE * total


@pytest.mark.parametrize("arch_id", ARCHS)
def test_lm_train_step_matches_reference(arch_id):
    """Microbatch 1 (the microbatched cases: test_torch_train_step_mb.py)."""
    check_against_reference(arch_id, "mb1")


@pytest.mark.parametrize("arch_id", ARCHS)
def test_lm_remat_step_is_bit_equal_to_plain(arch_id):
    """``remat=True`` recomputes each layer in the backward: the same ops
    on the same values, so the same bits as ``remat=False``."""
    jcfg, tcfg = _cfgs(arch_id, "mb2_fp32_remat")
    _, jparams, tokens, targets = _inputs(arch_id, jcfg, seed=9)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    out = {}
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, remat=remat)
        out[remat] = _port_step(arch_id, cfg, np_params, tokens, targets)
    for a, b in zip(tree_leaves(out[True][1:4]), tree_leaves(out[False][1:4])):
        assert torch.equal(a, b)
    assert torch.equal(out[True][0], out[False][0])


def test_lm_train_step_in_place_and_loss_falls():
    """The step overwrites its parameters and state (the reference
    donates them) and returns the same tensors; three steps on one
    batch lower the loss each time."""
    arch_id = "starcoder2-3b"
    jcfg, tcfg = _cfgs(arch_id, "mb1")
    _, jparams, tokens, targets = _inputs(arch_id, jcfg)
    params = lm_params_from_reference(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    opt = adamw_init(params, _lm_opt_cfg(True))
    cell = build_cell(arch_id, "train_4k", reduced=True)
    embed, mu = params["embed"], opt["mu"]["embed"]
    before = embed.clone()
    losses = []
    for _ in range(3):
        p2, o2, m = cell.fn(params, opt, tokens, targets)
        assert p2 is params and o2 is opt
        losses.append(float(m["loss"]))
    assert params["embed"] is embed and opt["mu"]["embed"] is mu
    assert not torch.equal(embed, before)
    assert int(opt["count"]) == 3
    assert losses[0] > losses[1] > losses[2]


def test_lm_cells_are_abstract_and_mesh_raises():
    cell = build_cell("deepseek-v2-lite-16b", "train_4k")
    assert cell.donate_argnums == (0, 1)
    leaves = tree_leaves(cell.args)
    assert all(t.device.type == "meta" for t in leaves)
    assert cell.args[2].shape == (256, 4096) and cell.args[2].dtype == torch.int32
    assert cell.args[1]["mu"]["embed"].dtype == torch.bfloat16      # _lm_opt_cfg
    assert cell.args[0]["layers"]["ffn"]["router"].dtype == torch.float32
    dec = build_cell("mistral-nemo-12b", "decode_32k")
    assert dec.donate_argnums == (2,) and dec.args[2]["k"].shape[:3] == (40, 128, 32768)
    # every family builds on a mesh (tests/test_torch_mesh_lm.py); a mesh
    # that is not a DeviceMesh raises, naming what it wants
    with pytest.raises(TypeError, match="must be a torch.distributed DeviceMesh"):
        build_cell("mistral-nemo-12b", "train_4k", mesh=object())
    with pytest.raises(TypeError, match="must be a torch.distributed DeviceMesh"):
        build_cell("graphsage-reddit", "ogb_products", mesh=object())
    # the GNN and websearch cells build too, their args meta at the
    # published shapes (tests/test_torch_cells.py holds every cell)
    ws = build_cell("websearch-rl", "rl_rollout")
    assert ws.args[2].device.type == "meta"
    assert tuple(ws.args[2].shape) == (256, 4096, 4, 4, 128)
    gnn = build_cell("graphsage-reddit", "ogb_products")
    assert gnn.donate_argnums == (0, 1) and gnn.args[3].device.type == "meta"
    assert tuple(gnn.args[3].shape) == (2, 61_859_140)
    with pytest.raises(KeyError):
        build_cell("graphsage-reddit", "train_full")
