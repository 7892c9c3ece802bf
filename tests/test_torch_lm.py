"""The port's dense GQA LM against the JAX reference, on the CPU.

Both packages run on the same weights (the reference's ``init_params``,
carried across by ``lm_params_from_reference``) and the same
numpy-seeded tokens, at the reduced configs of the three ported archs
and the reduced prefill/decode shapes of ``launch/steps.py``.

Tolerance: 1e-4 (absolute and relative), in float32 on both sides.  The
two sides differ only in summation order (XLA against torch's CPU BLAS,
reductions of at most 256 terms) and in exp/rsqrt ulps: a few 1e-6 on
logits of order 1 (the reference's own prefill, flash against chunked,
already differs by 2.4e-6 on this file's mistral-nemo-12b prefill).  A real fault (a
mask, a RoPE half, a scale, a cache row) moves logits by 1e-2 or more.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.launch.steps import REDUCED_SHAPES
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.lm_family import make_lm_arch
from repro_torch.models import attention, layers, transformer
from repro_torch.weights import lm_params_from_reference

TOL = 1e-4
ARCHS = ["mistral-nemo-12b", "starcoder2-3b", "phi4-mini-3.8b"]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(arch_id, **changes):
    jcfg = dataclasses.replace(jax_get_arch(arch_id).model_cfg(True), **changes)
    tcfg = dataclasses.replace(get_arch(arch_id).model_cfg(True), **changes)
    return jcfg, tcfg


# ----------------------------------------------------------------- layers
def test_rms_norm_and_rope_match():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 16, 4, 32)).astype(np.float32)
    w = rng.normal(size=(32,)).astype(np.float32)
    _close(layers.rms_norm(_t(x), _t(w)), jlayers.rms_norm(x, w))
    pos = rng.integers(0, 4096, size=(2, 16)).astype(np.int32)
    for theta in (1e4, 1e6):
        jc, js = jlayers.rope_angles(jnp.asarray(pos), 32, theta)
        tc, ts = layers.rope_angles(_t(pos), 32, theta)
        _close(tc, jc)
        _close(ts, js)
        _close(layers.apply_rope(_t(x), tc, ts), jlayers.apply_rope(x, jc, js))


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp_apply_matches(kind):
    params = _numpy_tree(jlayers.mlp_init(jax.random.key(1), 64, 128, kind))
    if kind == "gelu":   # the reference initialises biases to 0
        rng = np.random.default_rng(2)
        params["b_up"] = rng.normal(size=params["b_up"].shape).astype(np.float32)
        params["b_down"] = rng.normal(size=params["b_down"].shape).astype(np.float32)
    x = np.random.default_rng(3).normal(size=(3, 5, 64)).astype(np.float32)
    got = layers.mlp_apply({k: _t(v) for k, v in params.items()}, _t(x), kind)
    _close(got, jlayers.mlp_apply(params, x, kind))


# -------------------------------------------------------------- attention
@pytest.mark.parametrize("use_flash", [False, True])
def test_gqa_forward_matches(use_flash):
    """GQA 2:1 at d_head 32, with a query chunk that splits the sequence."""
    cfg = dict(d_model=128, n_heads=4, n_kv=2, d_head=32, rope_theta=1e6,
               q_chunk=16, use_flash=use_flash)
    params = _numpy_tree(jattn.gqa_init(jax.random.key(4),
                                        jattn.AttnConfig(**cfg)))
    x = np.random.default_rng(5).normal(size=(2, 48, 128)).astype(np.float32)
    want, wcache = jattn.gqa_forward(params, x, jattn.AttnConfig(**cfg),
                                     return_cache=True)
    got, gcache = attention.gqa_forward({k: _t(v) for k, v in params.items()},
                                        _t(x), attention.AttnConfig(**cfg),
                                        return_cache=True)
    _close(got, want)
    for f in ("k", "v"):
        _close(gcache[f], wcache[f])


# ------------------------------------------------------------ whole model
def _params(arch_id, jcfg, tcfg, seed=0):
    jparams = jtf.init_params(jax.random.key(seed), jcfg)
    return jparams, lm_params_from_reference(_numpy_tree(jparams), tcfg,
                                             device="cpu")


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("arch_id", ARCHS)
def test_prefill_matches(arch_id, use_flash):
    jcfg, tcfg = _cfgs(arch_id, use_flash=use_flash)
    jparams, tparams = _params(arch_id, jcfg, tcfg)
    shape = REDUCED_SHAPES["prefill"]
    tokens = np.random.default_rng(6).integers(
        0, jcfg.vocab, (shape["global_batch"], shape["seq_len"])).astype(np.int32)
    want_logits, want_cache = jtf.prefill(jparams, jnp.asarray(tokens), jcfg)
    logits, cache = transformer.prefill(tparams, tokens, tcfg, device="cpu")
    assert logits.dtype == torch.float32 and logits.shape == want_logits.shape
    _close(logits, want_logits)
    for f in ("k", "v"):
        assert cache[f].shape == want_cache[f].shape
        _close(cache[f], want_cache[f])


@pytest.mark.parametrize("use_flash", [False, True])
def test_forward_matches(use_flash):
    """The final hidden states of every position (starcoder2: gelu MLP
    with biases, GQA 2:1)."""
    jcfg, tcfg = _cfgs("starcoder2-3b", use_flash=use_flash)
    jparams, tparams = _params("starcoder2-3b", jcfg, tcfg, seed=2)
    tokens = np.random.default_rng(8).integers(0, jcfg.vocab, (2, 40)).astype(np.int32)
    want, want_aux = jtf.forward(jparams, jnp.asarray(tokens), jcfg)
    got, aux = transformer.forward(tparams, tokens, tcfg, device="cpu")
    _close(got, want)
    assert float(aux) == float(want_aux) == 0.0


@pytest.mark.parametrize("arch_id", ARCHS)
def test_decode_step_matches(arch_id):
    """Per-lane positions that differ: early, mid, the last row of the
    cache (s_max - 1), and s_max itself, where nothing is stored."""
    jcfg, tcfg = _cfgs(arch_id)
    jparams, tparams = _params(arch_id, jcfg, tcfg, seed=1)
    shape = REDUCED_SHAPES["decode"]
    b, s_max = shape["global_batch"], shape["seq_len"]
    rng = np.random.default_rng(7)
    cshape = (jcfg.n_layers, b, s_max, jcfg.n_kv, jcfg.d_head)
    cache = {f: rng.normal(size=cshape).astype(np.float32) for f in ("k", "v")}
    token = rng.integers(0, jcfg.vocab, b).astype(np.int32)
    pos = np.array([0, 17, s_max - 1, s_max], np.int32)
    want_logits, want_cache = jtf.decode_step(
        jparams, jnp.asarray(token), {f: jnp.asarray(c) for f, c in cache.items()},
        jnp.asarray(pos), jcfg)
    tcache = {f: _t(c) for f, c in cache.items()}
    logits, got_cache = transformer.decode_step(tparams, token, tcache, pos,
                                                tcfg, device="cpu")
    _close(logits, want_logits)
    for f in ("k", "v"):
        assert got_cache[f] is tcache[f]            # written in place
        _close(got_cache[f], want_cache[f])
        # lane 3 (pos = s_max) stored nothing
        np.testing.assert_array_equal(got_cache[f][:, 3].numpy(), cache[f][:, 3])


@pytest.mark.parametrize("arch_id", ARCHS)
def test_decode_step_kernel_path_matches(arch_id):
    """``use_flash=True``: decode attention through the decode-attention
    wrapper (its plain version on the CPU, reading the cache through a
    transposed view with per-lane lengths pos + 1) against the
    reference's einsum decode, at positions that differ per lane,
    including s_max, which sees all s_max keys and stores nothing."""
    jcfg, tcfg = _cfgs(arch_id)
    tcfg = dataclasses.replace(tcfg, use_flash=True)
    jparams, tparams = _params(arch_id, jcfg, tcfg, seed=4)
    shape = REDUCED_SHAPES["decode"]
    b, s_max = shape["global_batch"], shape["seq_len"]
    rng = np.random.default_rng(9)
    cshape = (jcfg.n_layers, b, s_max, jcfg.n_kv, jcfg.d_head)
    cache = {f: rng.normal(size=cshape).astype(np.float32) for f in ("k", "v")}
    token = rng.integers(0, jcfg.vocab, b).astype(np.int32)
    pos = np.array([3, 40, s_max - 1, s_max], np.int32)
    want_logits, want_cache = jtf.decode_step(
        jparams, jnp.asarray(token), {f: jnp.asarray(c) for f, c in cache.items()},
        jnp.asarray(pos), jcfg)
    tcache = {f: _t(c) for f, c in cache.items()}
    logits, got_cache = transformer.decode_step(tparams, token, tcache, pos,
                                                tcfg, device="cpu")
    _close(logits, want_logits)
    for f in ("k", "v"):
        _close(got_cache[f], want_cache[f])


def test_init_params_tree_matches_reference():
    """The port's own random parameters: the reference's tree, leaf
    shapes and dtypes, drawn from a seeded generator (same seed, same
    values)."""
    jcfg, tcfg = _cfgs("starcoder2-3b")
    want = jax.eval_shape(lambda k: jtf.init_params(k, jcfg), jax.random.key(0))
    got = transformer.init_params(tcfg, seed=3, device="cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (_, g), (_, w) in zip(flat_g, flat_w):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        assert torch.isfinite(g).all()
    again = transformer.init_params(tcfg, seed=3, device="cpu")
    assert torch.equal(got["layers"]["ffn"]["w_up"], again["layers"]["ffn"]["w_up"])
    w = got["layers"]["attn"]["wq"]
    assert w.abs().max() <= 2 * 128 ** -0.5 and w[0].std() > 0.5 * 128 ** -0.5


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch_id", ARCHS)
def test_configs_equal_reference(arch_id, reduced):
    jarch, tarch = jax_get_arch(arch_id), get_arch(arch_id)
    assert (tarch.family, tarch.source, tarch.notes) == \
        (jarch.family, jarch.source, jarch.notes)
    assert {k: dataclasses.asdict(v) for k, v in tarch.shapes.items()} == \
        {k: dataclasses.asdict(v) for k, v in jarch.shapes.items()}
    jcfg, tcfg = jarch.model_cfg(reduced), tarch.model_cfg(reduced)
    assert (jcfg.attn_kind, jcfg.moe, jcfg.mla) == ("gqa", None, None)
    for f in dataclasses.fields(tcfg):
        want, got = getattr(jcfg, f.name), getattr(tcfg, f.name)
        if isinstance(got, torch.dtype):
            want = getattr(torch, jnp.dtype(want).name)
        assert got == want, f.name
    assert tcfg.param_dtype == (torch.float32 if reduced else torch.bfloat16)


def test_unported_archs_raise():
    others = ["wide-deep", "deepfm", "dcn-v2", "bert4rec", "websearch-rl"]
    assert sorted(list_archs()) == sorted(ARCHS + others)
    for arch_id in ("deepseek-v2-lite-16b", "grok-1-314b"):
        jax_get_arch(arch_id)                     # the reference has them
        with pytest.raises(NotImplementedError, match="not ported yet"):
            get_arch(arch_id)
    with pytest.raises(NotImplementedError, match="MoE and MLA"):
        make_lm_arch("moe-test", "", n_layers=1, d_model=8, n_heads=2, n_kv=1,
                     d_ff=8, vocab=8, moe=dict(n_experts=2, top_k=1, d_ff=8))
