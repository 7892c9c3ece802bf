"""The port's LMs (dense GQA, MoE, MLA) against the JAX reference, on
the CPU.

Both packages run on the same weights (the reference's ``init_params``,
carried across by ``lm_params_from_reference``) and the same
numpy-seeded tokens, at the reduced configs of the five archs and the
reduced prefill/decode shapes of ``launch/steps.py``.

Tolerance: 1e-4 (absolute and relative), in float32 on both sides.  The
two sides differ only in summation order (XLA against torch's CPU BLAS,
reductions of at most 256 terms) and in exp/rsqrt ulps: a few 1e-6 on
logits of order 1 (the reference's own prefill, flash against chunked,
already differs by 2.4e-6 on this file's mistral-nemo-12b prefill).  A real fault (a
mask, a RoPE half, a scale, a cache row) moves logits by 1e-2 or more.
The MoE archs route the same tokens to the same experts on both sides:
a gate would have to sit within ~1e-6 of the next to flip, and a flip
(or a wrong drop) moves that token's logits by far more than 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import list_archs as jax_list_archs
from repro.launch.steps import REDUCED_SHAPES
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch.configs import get_arch, list_archs
from repro_torch.models import attention, layers, transformer
from repro_torch.weights import lm_params_from_reference

TOL = 1e-4
ARCHS = ["mistral-nemo-12b", "starcoder2-3b", "phi4-mini-3.8b"]
MOE_ARCHS = ["deepseek-v2-lite-16b", "grok-1-314b"]
# (arch, use_flash): MLA runs no kernel, so deepseek once; grok-1's GQA
# through both paths.
MOE_CASES = [("deepseek-v2-lite-16b", False), ("grok-1-314b", False),
             ("grok-1-314b", True)]


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


def _mla_case(seed):
    """MLA at the reduced widths, with a query chunk that splits S."""
    cfg = dict(d_model=128, n_heads=4, kv_lora_rank=32, d_nope=16, d_rope=8,
               d_v=16, q_chunk=16)
    params = _numpy_tree(jattn.mla_init(jax.random.key(seed),
                                        jattn.MLAConfig(**cfg)))
    return (jattn.MLAConfig(**cfg), attention.MLAConfig(**cfg), params,
            {k: _t(v) for k, v in params.items()})


def test_mla_forward_matches():
    jcfg, tcfg, jparams, tparams = _mla_case(11)
    x = np.random.default_rng(12).normal(size=(2, 48, 128)).astype(np.float32)
    want, wcache = jattn.mla_forward(jparams, x, jcfg, return_cache=True)
    got, gcache = attention.mla_forward(tparams, _t(x), tcfg, return_cache=True)
    _close(got, want)
    assert sorted(gcache) == ["c", "k_rope"]
    for f in gcache:
        assert gcache[f].shape == wcache[f].shape
        _close(gcache[f], wcache[f])


def test_mla_decode_matches():
    """The absorbed decode at per-lane positions (0, mid, the last row,
    and S, which stores nothing), the cache written in place; and its
    scores and output against attention over K/V materialised from the
    c cache (``mla_forward``'s form)."""
    jcfg, tcfg, jparams, tparams = _mla_case(13)
    rng = np.random.default_rng(14)
    b, s_max = 4, 40
    cache = {"c": rng.normal(size=(b, s_max, 32)).astype(np.float32),
             "k_rope": rng.normal(size=(b, s_max, 8)).astype(np.float32)}
    x = rng.normal(size=(b, 128)).astype(np.float32)
    pos = np.array([0, 17, s_max - 1, s_max], np.int32)
    want, wcache = jattn.mla_decode(jparams, x, {f: jnp.asarray(c) for f, c in
                                                 cache.items()},
                                    jnp.asarray(pos), jcfg)
    tcache = {f: _t(c) for f, c in cache.items()}
    got, gcache = attention.mla_decode(tparams, _t(x), tcache, _t(pos).long(), tcfg)
    _close(got, want)
    for f in cache:
        assert gcache[f] is tcache[f]
        _close(gcache[f], wcache[f])
        np.testing.assert_array_equal(gcache[f][3].numpy(), cache[f][3])

    # absorbed against materialised, on the written cache
    q = rng.normal(size=(b, 4, 24)).astype(np.float32)
    lens = np.minimum(pos, s_max - 1)
    o, sc = attention.mla_absorbed_attention(tparams, _t(q[..., :16]),
                                             _t(q[..., 16:]), tcache["c"],
                                             tcache["k_rope"], _t(lens).long(),
                                             tcfg)
    want_o, want_sc = attention.mla_materialised_attention(
        tparams, _t(q[..., :16]), _t(q[..., 16:]), tcache["c"],
        tcache["k_rope"], _t(lens).long(), tcfg)
    valid = torch.arange(s_max)[None] <= _t(lens).long()[:, None]
    _close(sc[valid[:, None].expand_as(sc)], want_sc[valid[:, None].expand_as(sc)])
    assert bool(torch.isinf(sc[~valid[:, None].expand_as(sc)]).all())
    _close(o, want_o.reshape(b, 64))


# ------------------------------------------------------------ whole model
def _params(arch_id, jcfg, tcfg, seed=0):
    jparams = jtf.init_params(jax.random.key(seed), jcfg)
    return jparams, lm_params_from_reference(_numpy_tree(jparams), tcfg,
                                             device="cpu")


@pytest.mark.parametrize("arch_id,use_flash",
                         [(a, f) for f in (False, True) for a in ARCHS] + MOE_CASES)
def test_prefill_matches(arch_id, use_flash):
    """Logits and the cache: GQA's {"k", "v"}, MLA's {"c", "k_rope"}."""
    jcfg, tcfg = _cfgs(arch_id, use_flash=use_flash)
    jparams, tparams = _params(arch_id, jcfg, tcfg)
    shape = REDUCED_SHAPES["prefill"]
    tokens = np.random.default_rng(6).integers(
        0, jcfg.vocab, (shape["global_batch"], shape["seq_len"])).astype(np.int32)
    want_logits, want_cache = jtf.prefill(jparams, jnp.asarray(tokens), jcfg)
    logits, cache = transformer.prefill(tparams, tokens, tcfg, device="cpu")
    assert logits.dtype == torch.float32 and logits.shape == want_logits.shape
    _close(logits, want_logits)
    assert sorted(cache) == sorted(want_cache)
    for f in cache:
        assert cache[f].shape == want_cache[f].shape
        _close(cache[f], want_cache[f])


@pytest.mark.parametrize("arch_id,use_flash",
                         [("starcoder2-3b", False), ("starcoder2-3b", True)]
                         + MOE_CASES,
                         ids=["False", "True"] + [f"{a}-{f}" for a, f in MOE_CASES])
def test_forward_matches(arch_id, use_flash):
    """The final hidden states of every position and the aux loss
    (starcoder2: gelu MLP with biases, GQA 2:1, aux 0; the MoE archs:
    the sum of the layers' load-balance losses)."""
    jcfg, tcfg = _cfgs(arch_id, use_flash=use_flash)
    jparams, tparams = _params(arch_id, jcfg, tcfg, seed=2)
    tokens = np.random.default_rng(8).integers(0, jcfg.vocab, (2, 40)).astype(np.int32)
    want, want_aux = jtf.forward(jparams, jnp.asarray(tokens), jcfg)
    got, aux = transformer.forward(tparams, tokens, tcfg, device="cpu")
    _close(got, want)
    assert aux.shape == () and aux.dtype == torch.float32
    if jcfg.moe is None:
        assert float(aux) == float(want_aux) == 0.0
    else:
        assert float(aux) > 0
        _close(aux, want_aux)


@pytest.mark.parametrize("arch_id", ARCHS + MOE_ARCHS)
def test_decode_step_matches(arch_id):
    """Per-lane positions that differ: early, mid, the last row of the
    cache (s_max - 1), and s_max itself, where nothing is stored."""
    jcfg, tcfg = _cfgs(arch_id)
    jparams, tparams = _params(arch_id, jcfg, tcfg, seed=1)
    shape = REDUCED_SHAPES["decode"]
    b, s_max = shape["global_batch"], shape["seq_len"]
    rng = np.random.default_rng(7)
    cache = {f: rng.normal(size=shape).astype(np.float32)
             for f, shape in transformer.cache_shapes(tcfg, b, s_max).items()}
    token = rng.integers(0, jcfg.vocab, b).astype(np.int32)
    pos = np.array([0, 17, s_max - 1, s_max], np.int32)
    want_logits, want_cache = jtf.decode_step(
        jparams, jnp.asarray(token), {f: jnp.asarray(c) for f, c in cache.items()},
        jnp.asarray(pos), jcfg)
    tcache = {f: _t(c) for f, c in cache.items()}
    logits, got_cache = transformer.decode_step(tparams, token, tcache, pos,
                                                tcfg, device="cpu")
    _close(logits, want_logits)
    for f in cache:
        assert got_cache[f] is tcache[f]            # written in place
        _close(got_cache[f], want_cache[f])
        # lane 3 (pos = s_max) stored nothing
        np.testing.assert_array_equal(got_cache[f][:, 3].numpy(), cache[f][:, 3])


@pytest.mark.parametrize("arch_id", ARCHS + ["grok-1-314b"])
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
    cache = {f: rng.normal(size=shape).astype(np.float32)
             for f, shape in transformer.cache_shapes(tcfg, b, s_max).items()}
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


@pytest.mark.parametrize("arch_id,use_flash", [("mistral-nemo-12b", True)]
                         + MOE_CASES)
def test_prefill_then_chained_decode_matches(arch_id, use_flash):
    """A prefill of 2 x 64, its cache padded to 68, then 4 greedy decode
    steps, each fed the reference's argmax: the logits of every step and
    the final cache."""
    jcfg, tcfg = _cfgs(arch_id, use_flash=use_flash)
    jparams, tparams = _params(arch_id, jcfg, tcfg, seed=5)
    shape, steps = REDUCED_SHAPES["prefill"], 4
    b, s = shape["global_batch"], shape["seq_len"]
    tokens = np.random.default_rng(15).integers(0, jcfg.vocab, (b, s)).astype(np.int32)
    want_logits, want_cache = jtf.prefill(jparams, jnp.asarray(tokens), jcfg)
    logits, cache = transformer.prefill(tparams, tokens, tcfg, device="cpu")
    _close(logits, want_logits)

    def pad(c, n):
        return np.pad(np.asarray(c), [(0, 0), (0, 0), (0, n)]
                      + [(0, 0)] * (np.ndim(c) - 3))

    want_cache = {f: jnp.asarray(pad(c, steps)) for f, c in want_cache.items()}
    cache = {f: _t(pad(c.numpy(), steps)) for f, c in cache.items()}
    pos = np.full((b,), s, np.int32)
    for _ in range(steps):
        token = np.asarray(want_logits).argmax(-1).astype(np.int32)
        want_logits, want_cache = jtf.decode_step(
            jparams, jnp.asarray(token), want_cache, jnp.asarray(pos), jcfg)
        logits, cache = transformer.decode_step(tparams, token, cache, pos, tcfg,
                                                device="cpu")
        _close(logits, want_logits)
        pos = pos + 1
    for f in cache:
        _close(cache[f], want_cache[f])


@pytest.mark.parametrize("arch_id", ["mistral-nemo-12b"] + MOE_ARCHS)
def test_init_params_dtypes_under_bf16(arch_id):
    """Under a bf16 param_dtype every leaf is bf16 but the MoE router,
    which stays float32 (as the reference draws it): through the port's
    own ``init_params`` and through ``lm_params_from_reference`` of the
    reference's bf16 tree; leaf shapes and dtypes equal the reference's."""
    jcfg, tcfg = _cfgs(arch_id)
    jcfg = dataclasses.replace(jcfg, param_dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tcfg, param_dtype=torch.bfloat16)
    want = jax.eval_shape(lambda k: jtf.init_params(k, jcfg), jax.random.key(0))
    carried = lm_params_from_reference(
        _numpy_tree(jtf.init_params(jax.random.key(0), jcfg)), tcfg, device="cpu")
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    for got in (transformer.init_params(tcfg, seed=1, device="cpu"), carried):
        flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
        assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
        for (path, g), (_, w) in zip(flat_g, flat_w):
            router = path[-1].key == "router"
            assert g.dtype == (torch.float32 if router else torch.bfloat16)
            assert jnp.dtype(w.dtype) == (jnp.float32 if router else jnp.bfloat16)
            assert tuple(g.shape) == w.shape
    assert (jcfg.moe is not None) == ("router" in carried["layers"]["ffn"])


def test_init_params_tree_matches_reference():
    """The port's own random parameters: the reference's tree, leaf
    shapes and dtypes, drawn from a seeded generator (same seed, same
    values)."""
    for arch_id in ["starcoder2-3b"] + MOE_ARCHS:
        jcfg, tcfg = _cfgs(arch_id)
        want = jax.eval_shape(lambda k: jtf.init_params(k, jcfg),
                              jax.random.key(0))
        got = transformer.init_params(tcfg, seed=3, device="cpu")
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
        assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
        for (_, g), (_, w) in zip(flat_g, flat_w):
            assert tuple(g.shape) == w.shape and g.dtype == torch.float32
            assert torch.isfinite(g).all()
    jcfg, tcfg = _cfgs("starcoder2-3b")
    got = transformer.init_params(tcfg, seed=3, device="cpu")
    again = transformer.init_params(tcfg, seed=3, device="cpu")
    assert torch.equal(got["layers"]["ffn"]["w_up"], again["layers"]["ffn"]["w_up"])
    w = got["layers"]["attn"]["wq"]
    assert w.abs().max() <= 2 * 128 ** -0.5 and w[0].std() > 0.5 * 128 ** -0.5


@pytest.mark.parametrize("arch_id", ARCHS + MOE_ARCHS)
def test_init_kv_cache_matches_reference(arch_id):
    """``cache_shapes`` and ``init_kv_cache``: the reference's fields,
    shapes and dtype (GQA's k/v, MLA's c/k_rope), all zeros."""
    jcfg, tcfg = _cfgs(arch_id)
    want = jtf.init_kv_cache(jcfg, 3, 40)
    got = transformer.init_kv_cache(tcfg, 3, 40, device="cpu")
    assert transformer.cache_shapes(tcfg, 3, 40) == \
        {f: tuple(c.shape) for f, c in want.items()}
    assert sorted(got) == sorted(want)
    for f, c in got.items():
        assert tuple(c.shape) == want[f].shape and c.dtype == torch.float32
        assert not bool(c.any())


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("reduced", [True, False])
@pytest.mark.parametrize("arch_id", ARCHS + MOE_ARCHS)
def test_configs_equal_reference(arch_id, reduced):
    jarch, tarch = jax_get_arch(arch_id), get_arch(arch_id)
    assert (tarch.family, tarch.source, tarch.notes) == \
        (jarch.family, jarch.source, jarch.notes)
    assert {k: dataclasses.asdict(v) for k, v in tarch.shapes.items()} == \
        {k: dataclasses.asdict(v) for k, v in jarch.shapes.items()}
    jcfg, tcfg = jarch.model_cfg(reduced), tarch.model_cfg(reduced)
    assert [f.name for f in dataclasses.fields(tcfg)] == \
        [f.name for f in dataclasses.fields(jcfg)]
    for f in dataclasses.fields(tcfg):
        want, got = getattr(jcfg, f.name), getattr(tcfg, f.name)
        if isinstance(got, torch.dtype):
            want = getattr(torch, jnp.dtype(want).name)
        if f.name in ("moe", "mla") and want is not None:   # sub-configs
            assert type(got).__name__ == type(want).__name__
            want, got = dataclasses.asdict(want), dataclasses.asdict(got)
        assert got == want, f.name
    assert (tcfg.moe is not None) == (arch_id in MOE_ARCHS)
    assert (tcfg.attn_kind == "mla") == (arch_id == "deepseek-v2-lite-16b")
    assert tcfg.param_dtype == (torch.float32 if reduced else torch.bfloat16)


def test_unported_archs_raise():
    """Every reference arch is ported (the port lists the reference's
    archs); an id neither package has raises KeyError in both."""
    others = ["wide-deep", "deepfm", "dcn-v2", "bert4rec", "websearch-rl",
              "graphsage-reddit"]
    assert sorted(list_archs()) == sorted(ARCHS + MOE_ARCHS + others)
    assert sorted(list_archs()) == sorted(jax_list_archs())
    assert get_arch("graphsage-reddit").family == "gnn"
    for getter in (get_arch, jax_get_arch):
        with pytest.raises(KeyError):
            getter("graphsage-cora")
