"""The port's training slice as a whole against the JAX reference system
(``tiny_system``: 2048 docs, 256-doc blocks, p = 256 state bins).

Gate 2: with the reference's ε-greedy draws fed in (computed here from
the reference's key schedule: ``unified_rollout`` splits ``rng, sub``
once a step, ``EpsilonGreedy.act`` splits ``sub`` into k0, k1, k2 and
draws randint from k1, uniform from k2), one ``train_batch`` gives the
reference's transitions and final state bit for bit on both port
backends, and its Q-table and metrics within 1e-6.  Gate 3: a
port-only training run at ``tiny_system``'s config cuts mean u below
the production plan's at NCG > 0.5 × the plan's (the reference's own
assertion, ``tests/test_qlearning.py``).
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.qlearning import _epsilon_rollout as j_epsilon_rollout
from repro.core.qlearning import train_batch as jtrain_batch
from repro.ranking.features import doc_features as jdoc_features
from repro_torch.core.qlearning import _epsilon_rollout, init_q, train_batch
from repro_torch.data.querylog import CAT1, CAT2, QueryLogConfig
from repro_torch.index.corpus import CorpusConfig
from repro_torch.launch.train import table1_rows
from repro_torch.policies import PolicyStore, TabularQPolicy
from repro_torch.system import RetrievalSystem, SystemConfig

FIELDS = ("block_ptr", "u", "v", "matched", "cand", "cand_cnt", "topn", "done")
DISCRETE = ("s", "a", "s2", "done", "valid")
METRICS = ("mean_u", "mean_v", "mean_cand", "mean_reward", "q_abs_mean")
PORT_BACKENDS = ("reference", "block_scan")
N_BATCH = 24
EPS = 0.3


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def _port_config(c, **over):
    return SystemConfig(
        corpus=CorpusConfig(n_docs=c.corpus.n_docs,
                            vocab_size=c.corpus.vocab_size,
                            seed=c.corpus.seed),
        querylog=QueryLogConfig(n_queries=c.querylog.n_queries,
                                seed=c.querylog.seed),
        block_docs=c.block_docs, p_bins=c.p_bins, u_budget=c.u_budget,
        rule_du_scale=c.rule_du_scale, rule_dv_scale=c.rule_dv_scale,
        l1_hidden=c.l1_hidden, l1_steps=c.l1_steps, gamma=c.gamma,
        t_max=c.t_max, seed=c.seed, **over)


@pytest.fixture(scope="module")
def port_system(tiny_system):
    """The port system with the reference's trained L1 and bins."""
    sys_ = RetrievalSystem(_port_config(tiny_system.cfg), device="cpu")
    sys_.load_reference(
        l1_params={k: np.asarray(v) for k, v in tiny_system.l1_params.items()},
        bins={"u_edges": np.asarray(tiny_system.bins.u_edges),
              "v_edges": np.asarray(tiny_system.bins.v_edges)})
    return sys_


@pytest.fixture(scope="module")
def batches(tiny_system):
    """Per category: query ids, the reference's batch inputs and its
    production-plan rewards (Eq. 4's subtrahend)."""
    out = {}
    for cat in (CAT1, CAT2):
        qids = np.where(tiny_system.log.category == cat)[0][:N_BATCH]
        occ, scores, tp = tiny_system.batch_inputs(qids)
        _, traj = tiny_system._run_plan_batch(
            tiny_system.plan_for_category(cat), occ, scores, tp)
        out[cat] = (qids, occ, scores, tp,
                    tiny_system.production_step_rewards(traj))
    return out


def _seeded_q(p, n_actions, seed=5):
    return np.random.default_rng(seed).normal(
        scale=0.05, size=(p, n_actions)).astype(np.float32)


def jax_draws(key, t_max, batch, n_actions):
    """The reference's ε-greedy draws for one episode from ``key``, as
    its rollout and ``EpsilonGreedy.act`` split it."""
    explore, uniform = [], []
    rng = key
    for _ in range(t_max):
        rng, sub = jax.random.split(rng)
        _, k1, k2 = jax.random.split(sub, 3)
        explore.append(np.asarray(jax.random.randint(
            k1, (batch,), 0, n_actions, dtype=jnp.int32)))
        uniform.append(np.asarray(jax.random.uniform(k2, (batch,))))
    return torch.from_numpy(np.stack(explore)), torch.from_numpy(np.stack(uniform))


def _assert_states_equal(got, want):
    for f in FIELDS:
        w = np.asarray(getattr(want, f))
        if w.dtype == np.uint32:
            w = w.view(np.int32)
        np.testing.assert_array_equal(getattr(got, f).numpy(), w, err_msg=f)


# ------------------------------------------------------------------- L1
def test_l1_training_set_matches_reference(tiny_system, port_system):
    """The judged (query, doc) rows ``fit_l1`` regresses on, gathered on
    the device: features within ``test_l1_scores_match``'s rtol 1e-5 /
    atol 1e-6 (the ≤ 4-term feature sums in another order), gains and
    weights exact, rows in the reference's order (the reference's own
    loop, copied here: 40 queries in chunks of 16, one ragged)."""
    ref = tiny_system
    rng = np.random.default_rng(ref.cfg.seed + 1)
    qids = rng.choice(ref.log.n_queries, size=40, replace=False)
    feats_l, gains_l = [], []
    for i in range(0, len(qids), 16):
        chunk = qids[i:i + 16]
        occ, _, tp = ref.batch_inputs(chunk)
        feats = jax.vmap(lambda o, i_, t: jdoc_features(
            o, i_, t, ref.static_rank, ref.doc_len))(
                occ, jnp.asarray(ref.idf_all[chunk]), tp)
        jids = ref.log.judged_ids[chunk]
        for row, q in enumerate(chunk):
            mask = jids[row] >= 0
            feats_l.append(np.asarray(feats[row])[np.clip(jids[row], 0, None)][mask])
            gains_l.append(ref.log.judged_gains[q][mask])
    want_g = np.concatenate(gains_l)

    feats, gains, weights = port_system.l1_training_set(n_queries=40, batch=16)
    assert feats.dtype == np.float32 and feats.shape[0] == len(want_g) > 0
    np.testing.assert_allclose(feats, np.concatenate(feats_l),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(gains, want_g)
    np.testing.assert_array_equal(weights, 1.0 + want_g.astype(np.float32))


# --------------------------------------------------- production baseline
@pytest.mark.parametrize("cat", [CAT1, CAT2])
def test_production_step_rewards_match_reference(tiny_system, port_system,
                                                 batches, cat):
    """Eq. 4's subtrahend, (B, Lp) with Lp the plan's length, from the
    port's plan rollout of the reference's inputs: u and v are bit-equal,
    the ≤ 5-term top-n sum may differ from XLA's in its last ulp, so
    rtol 1e-6."""
    _, occ, scores, tp, want = batches[cat]
    _, traj = port_system._run_plan_batch(
        port_system.plan_for_category(cat), _t(occ), _t(scores), _t(tp))
    got = port_system.production_step_rewards(traj)
    assert got.shape == (N_BATCH, port_system.plan_for_category(cat).length)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# --------------------------------------------------------------- Gate 2
@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("cat", [CAT1, CAT2])
def test_train_batch_matches_reference(tiny_system, port_system, batches,
                                       cat, backend):
    """One ε-greedy episode (ε 0.3, a seeded Q-table) and its TD update on
    the reference's batch inputs, production rewards and draws:
    ``s, a, s2, done, valid`` and the final state bit for bit; ``r``
    within atol 1e-6 (the top-n sum's last ulp); the new Q and the five
    metrics within atol 1e-6 (the TD sums' order, see
    ``test_td_update_matches_reference``)."""
    ref = tiny_system
    _, occ, scores, tp, prod_r = batches[cat]
    q = _seeded_q(ref.qcfg.p, ref.qcfg.n_actions, seed=cat + 5)
    key = jax.random.key(100 + cat)
    jfinal, jtrans = j_epsilon_rollout(
        ref.env_cfg, ref.qcfg, ref.ruleset, ref.bins, jnp.asarray(q), occ,
        scores, tp, prod_r, jnp.float32(EPS), key, backend="xla")
    jq, jm = jtrain_batch(ref.env_cfg, ref.qcfg, ref.ruleset, ref.bins,
                          jnp.asarray(q), occ, scores, tp, prod_r,
                          jnp.float32(EPS), key, backend="xla")

    p = port_system
    draws = jax_draws(key, p.qcfg.t_max, N_BATCH, p.qcfg.n_actions)
    args = (p.env_cfg, p.qcfg, p.ruleset, p.bins, torch.from_numpy(q),
            _t(occ), _t(scores), _t(tp), _t(prod_r), EPS, draws)
    final, trans = _epsilon_rollout(*args, backend=backend)
    for k in DISCRETE:
        np.testing.assert_array_equal(trans[k].numpy(), np.asarray(jtrans[k]),
                                      err_msg=k)
    np.testing.assert_allclose(trans["r"].numpy(), np.asarray(jtrans["r"]),
                               rtol=0, atol=1e-6)
    _assert_states_equal(final, jfinal)
    assert len(np.unique(trans["a"].numpy())) > 2          # varied actions

    q_new, metrics = train_batch(*args, backend=backend)
    np.testing.assert_allclose(q_new.numpy(), np.asarray(jq), rtol=0, atol=1e-6)
    assert not np.array_equal(q_new.numpy(), q)
    assert tuple(metrics) == METRICS
    for k in METRICS:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("cat", [CAT1, CAT2])
def test_policy_train_step_matches_reference(tiny_system, port_system,
                                             batches, cat, backend):
    """``policy_train_step`` end to end on both systems (the reference's
    L1 and bins loaded, the same query ids, the reference key's draws):
    the port builds its own batch inputs and production rewards, so its
    L1 scores differ from the reference's within rtol 1e-5, and its
    rewards, which are sums of scores over u, by that much relative.
    Measured Q difference on these batches: below 2e-9; tolerance
    atol 1e-6, as ``train_batch``'s."""
    qids = batches[cat][0]
    q = _seeded_q(tiny_system.qcfg.p, tiny_system.qcfg.n_actions, seed=cat)
    key = jax.random.key(7 + cat)
    jq, jm = tiny_system.policy_train_step(cat, jnp.asarray(q), key, EPS, qids)
    sys_ = copy.copy(port_system)
    sys_.cfg = dataclasses.replace(port_system.cfg, backend=backend)
    draws = jax_draws(key, sys_.qcfg.t_max, len(qids), sys_.qcfg.n_actions)
    pq, pm = sys_.policy_train_step(cat, torch.from_numpy(q), draws, EPS, qids)
    np.testing.assert_allclose(pq.numpy(), np.asarray(jq), rtol=0, atol=1e-6)
    for k in METRICS:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


# --------------------------------------------------------------- Gate 3
@pytest.fixture(scope="module")
def port_only(tiny_system):
    """A port system at ``tiny_system``'s config, trained only by the
    port: its L1 starts from the port's own ``init_l1`` (a seeded
    torch.Generator) and is fitted by ``fit_l1``; bins by
    ``fit_state_bins``."""
    sys_ = RetrievalSystem(_port_config(tiny_system.cfg), device="cpu")
    losses = sys_.fit_l1(n_queries=96, batch=16)
    sys_.fit_state_bins(n_queries=48, batch=24)
    return sys_, losses


def test_training_from_scratch_cuts_u(port_only):
    """The reference's own assertion on its trained system
    (``tests/test_qlearning.py::test_training_reduces_blocks_accessed``),
    on a port-only run: mean policy u below the production plan's, mean
    NCG above half the plan's.  Both backends train the same Q bit for
    bit (bit-equal episodes, a TD update in a fixed order)."""
    sys_, losses = port_only
    assert len(losses) == sys_.cfg.l1_steps and losses[-1] < losses[0]
    q, hist = sys_.train_policy(CAT2, iters=80, batch=32, seed=1,
                                eps_start=0.6, eps_end=0.1)
    assert len(hist) == 80 and tuple(hist[0]) == METRICS
    qids = np.where(sys_.log.category == CAT2)[0][:64]
    res = sys_.evaluate(q, qids, CAT2)
    assert res["policy_u"].mean() < res["baseline_u"].mean()
    assert res["policy_ncg"].mean() > 0.5 * res["baseline_ncg"].mean()

    other = copy.copy(sys_)
    other.cfg = dataclasses.replace(sys_.cfg, backend="reference")
    q_ref, _ = other.train_policy(CAT2, iters=80, batch=32, seed=1,
                                  eps_start=0.6, eps_end=0.1)
    assert sys_.cfg.backend == "block_scan"
    assert torch.equal(q, q_ref)


def test_table1_rows_shape(port_only):
    """The port's Table 1 command: a row per category × eval set with
    its deltas and p-values (a few iterations: shape, not values)."""
    sys_, _ = port_only
    rows, per_query = table1_rows(sys_, iters=3, train_batch=16, n_eval=200)
    assert [(r["category"], r["set"]) for r in rows] == [
        ("CAT1", "weighted"), ("CAT1", "unweighted"),
        ("CAT2", "weighted"), ("CAT2", "unweighted")]
    for r in rows:
        if "note" in r:
            continue
        assert 0 < r["p_u"] <= 1 and 0 < r["p_ncg"] <= 1
        assert np.isfinite(r["delta_u_pct"]) and np.isfinite(r["delta_ncg_pct"])
        key = f"{r['category']}_{r['set']}"
        assert len(per_query[key]["policy_u"]) == r["n_queries"]


# ---------------------------------------------------- policies and store
def test_fallbacks_and_shallow_cap_match_reference(tiny_system, port_system):
    """Shallow fallback plans equal the reference's prefixes, their u
    caps are equal, and fallbacks travel with snapshots (carried forward
    when a publish omits them, replaced or cleared when given)."""
    for cat in (CAT1, CAT2):
        for length in (1, 2, 9):
            assert (port_system.shallow_u_cap(cat, length)
                    == tiny_system.shallow_u_cap(cat, length))
            jp = tiny_system.shallow_plan(cat, length)
            pp = port_system.shallow_plan(cat, length)
            for f in ("rule_idx", "reset_before", "du_quota", "dv_quota"):
                np.testing.assert_array_equal(getattr(pp, f).numpy(),
                                              np.asarray(getattr(jp, f)))
    store = PolicyStore(staleness_bound=2)
    pol = TabularQPolicy(init_q(port_system.qcfg, device="cpu"))
    fb = port_system.fallback_policies((CAT1,))
    store.publish({CAT1: pol}, fallbacks=fb)
    snap = store.snapshot()
    assert set(snap.fallbacks) == {CAT1}
    assert snap.fallbacks[CAT1].horizon == 2
    store.publish({CAT1: pol})
    assert store.snapshot().fallbacks[CAT1] is snap.fallbacks[CAT1]
    store.publish({CAT1: pol}, fallbacks=dict(fb))
    store.publish({CAT1: pol}, fallbacks={})
    assert not store.snapshot().fallbacks
    with pytest.raises(TypeError, match="fallbacks"):
        store.publish({CAT1: pol}, fallbacks={CAT1: torch.zeros(2, 8)})
    with pytest.raises(TypeError):
        store.snapshot().fallbacks[CAT1] = pol


def test_train_policy_store_publishes_every_category(port_system):
    store = port_system.train_policy_store((CAT1, CAT2), iters=2, batch=8)
    snap = store.snapshot()
    assert snap.version == 1 and set(snap.policies) == {CAT1, CAT2}
    for pol in snap.policies.values():
        assert isinstance(pol, TabularQPolicy)
        assert pol.q.shape == (port_system.qcfg.p, port_system.qcfg.n_actions)
    again = port_system.train_policy_store((CAT1,), store=store, iters=1,
                                           batch=8)
    assert again is store and store.version == 2
    base = port_system.baseline_policies()
    assert set(base) == {CAT1, CAT2}
    assert base[CAT2].plan is port_system.plans["CAT2"]
