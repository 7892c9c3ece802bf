"""Scan-backend parity of the port against the JAX reference.

Both port backends (``"reference"``, block at a time, and
``"block_scan"``, chunks through the kernel module) must reproduce the
JAX ``"xla"`` backend's final EnvState BIT-FOR-BIT on the case matrix
of ``tests/test_scan_backends.py``: shallow and deep rules, mid-chunk
Δu/Δv crossings, u_budget exhaustion, a start from a midway state,
per-lane rules, chunk sizes and the adaptive chunk — and the same for
whole static-plan and greedy tabular rollouts.  ``topn`` is compared
exactly too: it holds the same float values, selected.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.environment import EnvConfig as JEnvConfig, env_reset as jenv_reset
from repro.core.match_plan import production_plans as jproduction_plans
from repro.core.match_rules import default_rule_library as jrules
from repro.core.rollout import unified_rollout as junified_rollout
from repro.core.scan_backends import get_scan_backend as jget
from repro.core.state_bins import fit_bins as jfit_bins
from repro.policies import StaticPlanPolicy as JStaticPlanPolicy
from repro.policies import TabularQPolicy as JTabularQPolicy
from repro_torch.core.environment import EnvConfig, EnvState
from repro_torch.core.match_plan import production_plans
from repro_torch.core.match_rules import default_rule_library
from repro_torch.core.rollout import unified_rollout
from repro_torch.core.scan_backends import (
    DEFAULT_CHUNK_BLOCKS, MAX_ADAPTIVE_CHUNK, BlockScanBackend, ScanBackend,
    adaptive_chunk_blocks, available_backends, get_scan_backend,
    register_scan_backend)
from repro_torch.core.state_bins import fit_bins
from repro_torch.policies import StaticPlanPolicy, TabularQPolicy

FIELDS = ("block_ptr", "u", "v", "matched", "cand", "cand_cnt", "topn", "done")
PORT_BACKENDS = ("reference", "block_scan")
CPU = torch.device("cpu")

B, NB, D, T, F = 4, 8, 64, 4, 4
W = D // 32


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def _port_state(js) -> EnvState:
    return EnvState(**{f: _t(np.asarray(getattr(js, f))) for f in FIELDS})


def assert_states_equal(port, ref, msg=""):
    for f in FIELDS:
        got = getattr(port, f).numpy()
        want = np.asarray(getattr(ref, f))
        if want.dtype == np.uint32:
            got = got.view(np.uint32)
        np.testing.assert_array_equal(got, want, err_msg=f"{msg}:{f}")


@pytest.fixture(scope="module")
def cfgs():
    kw = dict(n_blocks=NB, block_docs=D, k_rules=6, max_candidates=48,
              n_top=5, u_budget=4096)
    return EnvConfig(**kw), JEnvConfig(**kw)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    # AND of two draws: moderate per-block v, so Δv crossings land mid-chunk.
    occ = (rng.integers(0, 2**32, (B, NB, T, F, W), dtype=np.uint32)
           & rng.integers(0, 2**32, (B, NB, T, F, W), dtype=np.uint32))
    scores = rng.normal(size=(B, NB * D)).astype(np.float32)
    tp = np.ones((B, T), bool)
    return occ, scores, tp


def _rule(planes, required_terms):
    allowed = np.zeros((T, F), bool)
    for t, f in planes:
        allowed[t, f] = True
    required = np.zeros(T, bool)
    required[list(required_terms)] = True
    return (np.broadcast_to(allowed, (B, T, F)).copy(),
            np.broadcast_to(required, (B, T)).copy())


ALL_PLANES = [(t, f) for t in range(T) for f in range(F)]
RULE_CASES = {
    "shallow_2plane": ([(0, 1), (0, 3)], [0], 1000, 10**6),
    "deep_full": (ALL_PLANES, range(T), 1000, 10**6),
    "mid_chunk_du": (ALL_PLANES, range(T), 40, 10**6),
    "mid_chunk_dv": (ALL_PLANES, range(T), 1000, 150),
    "no_required": (ALL_PLANES[:4], [], 1000, 10**6),
    "zero_active": ([], [0], 1000, 10**6),
}


def _run_both(cfgs, inputs, backend, allowed, required, du, dv,
              state=None, jcfg=None, port_backend=None):
    """Run one rule on JAX "xla" and on a port backend from the same
    start state; returns (port_state, jax_state)."""
    jcfg = jcfg or cfgs[1]
    pcfg = EnvConfig(**dataclasses.asdict(jcfg))
    occ, scores, tp = inputs
    if state is None:
        state = jax.vmap(lambda _: jenv_reset(jcfg))(jnp.arange(B))
    du, dv = np.asarray(du, np.int32), np.asarray(dv, np.int32)
    js = jget("xla").run_rule(jcfg, jnp.asarray(occ), jnp.asarray(scores),
                              jnp.asarray(tp), state, jnp.asarray(allowed),
                              jnp.asarray(required), jnp.asarray(du),
                              jnp.asarray(dv))
    scan = port_backend or get_scan_backend(backend)
    ps = scan.run_rule(pcfg, _t(occ), _t(scores), _t(tp), _port_state(state),
                       _t(allowed), _t(required), _t(du), _t(dv))
    return ps, js


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_run_rule_parity(cfgs, inputs, case, backend):
    planes, req_terms, du, dv = RULE_CASES[case]
    allowed, required = _rule(planes, req_terms)
    ps, js = _run_both(cfgs, inputs, backend, allowed, required,
                       np.full(B, du), np.full(B, dv))
    assert_states_equal(ps, js, case)
    if case == "mid_chunk_du":
        assert (ps.block_ptr.numpy() == 3).all()
    if case == "no_required":
        assert (ps.cand_cnt.numpy() == 0).all() and (ps.v.numpy() > 0).all()
    if case == "zero_active":
        assert (ps.u.numpy() == 0).all() and (ps.block_ptr.numpy() == NB).all()


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_run_rule_parity_from_midway_state(cfgs, inputs, backend):
    """Continuation from a non-fresh state (reference-computed, then
    rewound for a second pass over the head of the index)."""
    _, jcfg = cfgs
    occ, scores, tp = inputs
    a1, r1 = _rule([(t, f) for t in range(T) for f in (1, 3)], range(T))
    q = jnp.full((B,), 1000, jnp.int32)
    state1 = jget("xla").run_rule(
        jcfg, jnp.asarray(occ), jnp.asarray(scores), jnp.asarray(tp),
        jax.vmap(lambda _: jenv_reset(jcfg))(jnp.arange(B)), jnp.asarray(a1),
        jnp.asarray(r1), jnp.full((B,), 48, jnp.int32), q)
    state1 = dataclasses.replace(state1, block_ptr=jnp.zeros((B,), jnp.int32))
    a2, r2 = _rule(ALL_PLANES, range(2))
    ps, js = _run_both(cfgs, inputs, backend, a2, r2, np.full(B, 1000),
                       np.full(B, 1000), state=state1)
    assert_states_equal(ps, js, "midway")
    assert (ps.cand_cnt.numpy() > 0).all()


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_run_rule_parity_u_budget_exhaustion(cfgs, inputs, backend):
    """With u_inc=16 and u_budget=40 the loop stops after 3 blocks."""
    small = dataclasses.replace(cfgs[1], u_budget=40)
    allowed, required = _rule(ALL_PLANES, range(T))
    ps, js = _run_both(cfgs, inputs, backend, allowed, required,
                       np.full(B, 10**6), np.full(B, 10**6), jcfg=small)
    assert_states_equal(ps, js, "u_budget")
    assert (ps.u.numpy() == 48).all() and (ps.block_ptr.numpy() == 3).all()


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_run_rule_parity_per_lane_rules(cfgs, inputs, backend):
    """Lanes carry different rules and quotas; idle lanes are no-ops."""
    allowed, _ = _rule(ALL_PLANES, range(T))
    allowed[1] = False
    allowed[1, 0, 1] = allowed[1, 0, 3] = True
    required = np.tile(np.eye(T, dtype=bool)[0], (B, 1))
    ps, js = _run_both(cfgs, inputs, backend, allowed, required,
                       [16, 1000, 40, 0], np.full(B, 10**6))
    assert_states_equal(ps, js, "per_lane")
    assert int(ps.block_ptr[3]) == 0


@pytest.mark.parametrize("chunk", [1, 3, 4, 32])
@pytest.mark.parametrize("case", ["mid_chunk_du", "deep_full"])
def test_chunk_size_invariance(cfgs, inputs, case, chunk):
    """The final state is independent of the speculation depth C,
    including C=1, C > n_blocks, and (deep_full, C=3) a chunk whose
    window runs past the end of the index."""
    planes, req_terms, du, dv = RULE_CASES[case]
    allowed, required = _rule(planes, req_terms)
    ps, js = _run_both(cfgs, inputs, None, allowed, required,
                       np.full(B, du), np.full(B, dv),
                       port_backend=BlockScanBackend(chunk=chunk))
    assert_states_equal(ps, js, f"{case}:chunk={chunk}")


def test_adaptive_chunk_blocks_heuristic():
    """Same picks as the reference's heuristic."""
    def full(x):
        return torch.full((4,), x, dtype=torch.int32)

    assert adaptive_chunk_blocks(64, full(40), full(16), 4096) == 3
    assert adaptive_chunk_blocks(64, full(1000), full(2), 4096) == MAX_ADAPTIVE_CHUNK
    assert adaptive_chunk_blocks(8, full(1000), full(2), 4096) == 8
    assert adaptive_chunk_blocks(64, full(10**6), full(16), 80) == 5
    assert adaptive_chunk_blocks(16, full(40), full(0), 4096) == 16


@pytest.mark.parametrize("case", ["mid_chunk_du", "shallow_2plane"])
def test_adaptive_chunk_parity(cfgs, inputs, case):
    planes, req_terms, du, dv = RULE_CASES[case]
    allowed, required = _rule(planes, req_terms)
    adaptive = BlockScanBackend(chunk=None)
    ps, js = _run_both(cfgs, inputs, None, allowed, required,
                       np.full(B, du), np.full(B, dv), port_backend=adaptive)
    assert_states_equal(ps, js, f"adaptive:{case}")
    assert adaptive.last_chunk == (3 if case == "mid_chunk_du" else NB)


# ------------------------------------------------------- rollout level
def _rollout_inputs(inputs):
    occ, scores, tp = inputs
    return ((jnp.asarray(occ), jnp.asarray(scores), jnp.asarray(tp)),
            (_t(occ), _t(scores), _t(tp)))


def _assert_rollouts_equal(pr, jr):
    assert_states_equal(pr.final_state, jr.final_state, "final")
    for part in ("trajectory", "transitions"):
        for k, want in getattr(jr, part).items():
            got, want = getattr(pr, part)[k].numpy(), np.asarray(want)
            if k in ("r", "topn_sum"):
                # a sum of at most n_top floats: the summation order of
                # the two frameworks may differ in the last bit
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_static_plan_rollout_parity(cfgs, inputs, backend):
    """CAT1 production plan (with a reset-before entry) through the
    unified rollout: final state, trajectory and transitions."""
    cfg, jcfg = cfgs
    (jo, js_, jt), (po, ps_, pt) = _rollout_inputs(inputs)
    jplan = jproduction_plans(jrules(du_scale=2, dv_scale=8))["CAT1"]
    rules = default_rule_library(du_scale=2, dv_scale=8, device=CPU)
    plan = production_plans(rules)["CAT1"]
    jr = junified_rollout(jcfg, jrules(du_scale=2, dv_scale=8), None,
                          JStaticPlanPolicy(jplan, jcfg.n_actions),
                          jplan.length, jo, js_, jt, backend="xla")
    pr = unified_rollout(cfg, rules, None, StaticPlanPolicy(plan, cfg.n_actions),
                         plan.length, po, ps_, pt, backend=backend)
    _assert_rollouts_equal(pr, jr)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_tabular_rollout_parity(cfgs, inputs, backend):
    """Greedy rollout over a seeded random Q-table: a varied action
    stream (rules, resets, stops) per step."""
    cfg, jcfg = cfgs
    (jo, js_, jt), (po, ps_, pt) = _rollout_inputs(inputs)
    u_pts, v_pts = np.linspace(0, 200, 64), np.linspace(0, 4000, 64)
    jbins = jfit_bins(u_pts, v_pts, p=16)
    bins = fit_bins(u_pts, v_pts, p=16, device="cpu")
    np.testing.assert_array_equal(bins.v_edges.numpy(), np.asarray(jbins.v_edges))
    q = np.random.default_rng(11).normal(
        size=(jbins.p, jcfg.n_actions)).astype(np.float32)
    jr = junified_rollout(jcfg, jrules(du_scale=2, dv_scale=8), jbins,
                          JTabularQPolicy(jnp.asarray(q)), 6, jo, js_, jt,
                          backend="xla")
    pr = unified_rollout(cfg, default_rule_library(2, 8, device=CPU), bins,
                         TabularQPolicy(torch.from_numpy(q)), 6, po, ps_, pt,
                         backend=backend)
    _assert_rollouts_equal(pr, jr)
    assert len(np.unique(pr.transitions["a"].numpy())) > 2


# ---------------------------------------------------------- registry
def test_registry_contents_and_errors():
    assert set(PORT_BACKENDS) <= set(available_backends())
    with pytest.raises(KeyError, match="available"):
        get_scan_backend("no_such_backend")
    with pytest.raises(ValueError, match="no name"):
        register_scan_backend(ScanBackend())
    assert get_scan_backend("block_scan").chunk == DEFAULT_CHUNK_BLOCKS


# ------------------------------------------------------- the meta path
@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_tabular_rollout_meta_path_then_cpu_parity(cfgs, inputs, backend):
    """The same greedy rollout on meta tensors (a dry run: the
    reference's rule loop body once, block_scan's one rule-kernel launch
    at its worst case) gives every output's shape and dtype, names the
    loop it counted once, and computes nothing; the CPU rollout after it is still the reference's
    bit for bit (the meta branches leave no state behind)."""
    from repro_torch.launch.dryrun import counting

    cfg, jcfg = cfgs
    (jo, js_, jt), (po, ps_, pt) = _rollout_inputs(inputs)
    u_pts, v_pts = np.linspace(0, 200, 64), np.linspace(0, 4000, 64)
    jbins, bins = jfit_bins(u_pts, v_pts, p=16), fit_bins(u_pts, v_pts, p=16,
                                                          device="cpu")
    q = np.random.default_rng(11).normal(
        size=(jbins.p, jcfg.n_actions)).astype(np.float32)
    meta = torch.device("meta")
    meta_bins = type(bins)(bins.u_edges.to(meta), bins.v_edges.to(meta))
    with counting() as c:
        mr = unified_rollout(cfg, default_rule_library(2, 8, device=meta),
                             meta_bins, TabularQPolicy(torch.from_numpy(q).to(meta)),
                             6, po.to(meta), ps_.to(meta), pt.to(meta),
                             backend=backend)
    # The reference loops on the host, its body counted once; block_scan
    # makes one rule-kernel launch a rule execution, at its worst case.
    assert c.notes == ([] if backend == "block_scan" else
                       ["ReferenceScanBackend.run_rule: data-dependent loop, "
                        "body counted once"])
    rule = c.kernels.get("block_scan_pruned_chunk_rule", {})
    assert (rule.get("launches", 0) > 0) == (backend == "block_scan")
    assert rule.get("worst_case", True)
    pr = unified_rollout(cfg, default_rule_library(2, 8, device=CPU), bins,
                         TabularQPolicy(torch.from_numpy(q)), 6, po, ps_, pt,
                         backend=backend)
    for f in FIELDS:
        got, want = getattr(mr.final_state, f), getattr(pr.final_state, f)
        assert got.device == meta and got.shape == want.shape, f
        assert got.dtype == want.dtype, f
    jr = junified_rollout(jcfg, jrules(du_scale=2, dv_scale=8), jbins,
                          JTabularQPolicy(jnp.asarray(q)), 6, jo, js_, jt,
                          backend="xla")
    _assert_rollouts_equal(pr, jr)
