"""The port's training pieces, one by one, against the JAX reference:
AdamW, the L1 fit, the query classifier and eval-set sampler, Table 1's
paired statistics, ε-greedy exploration, the TD update, the policy
store and the ``launch/train.py`` command.  Inputs come from seeded
numpy; each test states its tolerance and why."""
import dataclasses
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.core.match_plan import make_plan as jmake_plan
from repro.core.match_rules import default_rule_library as jrules
from repro.core.qlearning import QConfig as JQConfig
from repro.core.qlearning import init_q as jinit_q
from repro.core.qlearning import linear_epsilon as jlinear_epsilon
from repro.core.qlearning import td_update as jtd_update
from repro.data.querylog import QueryLogConfig as JQueryLogConfig
from repro.data.querylog import classify_query as jclassify_query
from repro.data.querylog import generate_querylog as jgenerate_querylog
from repro.data.querylog import sample_eval_sets as jsample_eval_sets
from repro.index.builder import build_index as jbuild_index
from repro.index.corpus import CorpusConfig as JCorpusConfig
from repro.index.corpus import generate_corpus as jgenerate_corpus
from repro.policies import EpsilonGreedy as JEpsilonGreedy
from repro.policies import StaticPlanPolicy as JStaticPlanPolicy
from repro.policies import TabularQPolicy as JTabularQPolicy
from repro.ranking import l1_ranker as jl1
from repro.ranking.metrics import paired_permutation_pvalue as jpvalue
from repro.ranking.metrics import relative_delta as jrelative_delta
from repro.train.optimizer import AdamWConfig as JAdamWConfig
from repro.train.optimizer import adamw_update as jadamw_update
from repro_torch.configs import get_arch
from repro_torch.core.match_plan import make_plan
from repro_torch.core.match_rules import default_rule_library
from repro_torch.core.qlearning import QConfig, init_q, linear_epsilon, td_update
from repro_torch.data.querylog import (CAT1, CAT2, QueryLogConfig,
                                       classify_query, generate_querylog,
                                       sample_eval_sets)
from repro_torch.index.builder import build_index
from repro_torch.index.corpus import CorpusConfig, generate_corpus
from repro_torch.policies import (EpsilonGreedy, PolicySnapshot, PolicyStore,
                                  StalePolicyError, StaticPlanPolicy,
                                  TabularQPolicy)
from repro_torch.ranking import l1_ranker
from repro_torch.ranking.features import FEATURE_DIM
from repro_torch.ranking.metrics import (paired_permutation_pvalue,
                                         relative_delta)
from repro_torch.train.optimizer import AdamWConfig, adamw_update

CPU = torch.device("cpu")
L1_SHAPES = {"w1": (FEATURE_DIM, 64), "b1": (64,), "w2": (64, 64),
             "b2": (64,), "w3": (64, 1), "b3": (1,)}


def _np_tree(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _t_tree(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


# ----------------------------------------------------------------- AdamW
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("count", [0, 7, 1000])
def test_adamw_update_matches_reference(weight_decay, count):
    """One AdamW step on random params, grads and moments.  rtol 1e-6
    (8 float32 ulps): the same float32 ops in the same order; the bias
    corrections' float32 pow and fused multiply-adds may differ by an
    ulp between XLA and torch."""
    rng = np.random.default_rng(count + 17)
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in L1_SHAPES.items()}
    grads = {k: rng.normal(scale=1e-2, size=s).astype(np.float32)
             for k, s in L1_SHAPES.items()}
    mu = {k: rng.normal(scale=1e-2, size=s).astype(np.float32)
          for k, s in L1_SHAPES.items()}
    nu = {k: rng.random(size=s).astype(np.float32) * 1e-4
          for k, s in L1_SHAPES.items()}
    state = {"mu": mu, "nu": nu, "count": np.int32(count)}

    jcfg = JAdamWConfig(lr=3e-3, weight_decay=weight_decay)
    jp, js = jadamw_update(
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in grads.items()},
        {"mu": {k: jnp.asarray(v) for k, v in mu.items()},
         "nu": {k: jnp.asarray(v) for k, v in nu.items()},
         "count": jnp.asarray(state["count"])}, jcfg)
    tp, ts = adamw_update(
        _t_tree(params), _t_tree(grads),
        {"mu": _t_tree(mu), "nu": _t_tree(nu),
         "count": torch.tensor(count, dtype=torch.int32)},
        AdamWConfig(lr=3e-3, weight_decay=weight_decay))
    for k in L1_SHAPES:
        for got, want in ((tp[k], jp[k]), (ts["mu"][k], js["mu"][k]),
                          (ts["nu"][k], js["nu"][k])):
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=0)
    assert ts["count"].dtype == torch.int32
    assert int(ts["count"]) == int(js["count"]) == count + 1


# -------------------------------------------------------------------- L1
def _l1_batch(n, seed):
    rng = np.random.default_rng(seed)
    feats = rng.random((n, FEATURE_DIM)).astype(np.float32)
    gains = rng.integers(0, 5, size=n).astype(np.int8)
    return feats, gains, 1.0 + gains.astype(np.float32)


@pytest.fixture(scope="module")
def ref_l1_init():
    return _np_tree(jl1.init_l1(jax.random.key(0), hidden=64))


def test_l1_adam_step_matches_reference(ref_l1_init):
    """One step from the reference's init on one batch of 4096 rows.
    Loss within rtol 1e-5; params within rtol 1e-5 / atol 1e-6: the
    backward matmuls sum 4096 rows in another order, and a first Adam
    step moves each parameter by ±lr·g/(|g| + ε), so a gradient's
    rounding reaches the parameter only through that ratio."""
    from repro.train.optimizer import adamw_init as jadamw_init
    from repro_torch.train.optimizer import adamw_init

    feats, gains, weights = _l1_batch(4096, 3)
    targets = gains.astype(np.float32) / 4.0
    jp = {k: jnp.asarray(v) for k, v in ref_l1_init.items()}
    jp2, _, jloss = jl1._l1_adam_step(jp, jadamw_init(jp), jnp.asarray(feats),
                                      jnp.asarray(targets),
                                      jnp.asarray(weights))
    tp = _t_tree(ref_l1_init)
    tp2, state, loss = l1_ranker._l1_adam_step(
        tp, adamw_init(tp), torch.from_numpy(feats),
        torch.from_numpy(targets), torch.from_numpy(weights))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in L1_SHAPES:
        np.testing.assert_allclose(tp2[k].numpy(), np.asarray(jp2[k]),
                                   rtol=1e-5, atol=1e-6)
    assert int(state["count"]) == 1
    assert not any(v.requires_grad for v in tp2.values())


def test_train_l1_short_fit_matches_reference(ref_l1_init):
    """20 steps of ``train_l1`` from the reference's init on 6000 rows:
    the port draws the reference's batches (the same numpy generator),
    so the loss histories agree step for step.  Tolerance rtol 1e-5 on
    the losses and atol 1e-6 on the parameters, measured 1.5e-7 and
    6e-8 on the CPU: Adam turns each step's gradient rounding into
    parameter moves of up to lr·δg/|g|, and 20 steps compound them, so
    the bound leaves room for another sum order."""
    feats, gains, weights = _l1_batch(6000, 4)
    jp, jlosses = jl1.train_l1({k: jnp.asarray(v) for k, v in ref_l1_init.items()},
                               feats, gains, weights, steps=20, seed=5)
    tp, losses = l1_ranker.train_l1(_t_tree(ref_l1_init), feats, gains,
                                    weights, steps=20, seed=5)
    assert len(losses) == 20 and all(isinstance(x, float) for x in losses)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[-1] < losses[0]
    for k in L1_SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6)


# -------------------------------------------------------------- querylog
@pytest.fixture(scope="module")
def logs():
    """The same small corpus, index and query log on both sides."""
    jc = jgenerate_corpus(JCorpusConfig(n_docs=1024, vocab_size=512, seed=3))
    ji = jbuild_index(jc, block_docs=256)
    jlog = jgenerate_querylog(jc, ji, JQueryLogConfig(n_queries=240, seed=3))
    pc = generate_corpus(CorpusConfig(n_docs=1024, vocab_size=512, seed=3))
    pi = build_index(pc, block_docs=256)
    plog = generate_querylog(pc, pi, QueryLogConfig(n_queries=240, seed=3))
    return (jlog, ji), (plog, pi)


def test_classify_query_equal(logs):
    (jlog, ji), (plog, pi) = logs
    want = jclassify_query(jlog, ji)
    got = classify_query(plog, pi)
    assert got.dtype == want.dtype == np.int8
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) <= {CAT1, CAT2}


@pytest.mark.parametrize("n_eval,seed", [(64, 0), (1000, 7)])
def test_sample_eval_sets_equal(logs, n_eval, seed):
    """Weighted (∝ popularity, with replacement) and unweighted
    (distinct) eval sets; n_eval past the log's size caps the
    unweighted set."""
    (jlog, _), (plog, _) = logs
    for got, want in zip(sample_eval_sets(plog, n_eval, seed=seed),
                         jsample_eval_sets(jlog, n_eval, seed=seed)):
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------- metrics
@pytest.mark.parametrize("shift", [0.0, 0.05, -0.3])
def test_table1_statistics_equal(shift):
    """Relative delta and the paired sign-permutation p-value: the same
    numpy on the same arrays, so equal floats."""
    rng = np.random.default_rng(int(abs(shift) * 100))
    base = rng.random(200)
    treat = base + shift + rng.normal(scale=0.1, size=200)
    assert relative_delta(treat, base) == jrelative_delta(treat, base)
    assert (paired_permutation_pvalue(treat, base, n_perm=500, seed=2)
            == jpvalue(treat, base, n_perm=500, seed=2))


# ------------------------------------------------------------ Q-learning
def test_linear_epsilon_and_init_q_match_reference():
    for it, iters in ((0, 10), (4, 10), (9, 10), (0, 1)):
        assert linear_epsilon(it, iters, 0.6, 0.1) == \
            jlinear_epsilon(it, iters, 0.6, 0.1)
    q = init_q(QConfig(p=16, n_actions=8), device="cpu")
    assert q.dtype == torch.float32 and q.device == CPU
    np.testing.assert_array_equal(q.numpy(),
                                  np.asarray(jinit_q(JQConfig(p=16, n_actions=8))))


@pytest.mark.parametrize("eps", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("inner", ["tabular", "plan"])
def test_epsilon_greedy_matches_reference(eps, inner):
    """With the reference's own draws passed in (its ``act`` splits the
    step key into k0, k1, k2: randint from k1, uniform from k2), the
    actions and extras equal the reference ``EpsilonGreedy``'s."""
    b, t, n_actions, p = 64, 2, 8, 16
    rng = np.random.default_rng(int(eps * 10) + 3)
    s_bin = rng.integers(0, p, size=b).astype(np.int32)
    if inner == "tabular":
        q = rng.normal(size=(p, n_actions)).astype(np.float32)
        jinner, pinner = JTabularQPolicy(jnp.asarray(q)), TabularQPolicy(torch.from_numpy(q))
    else:
        entries = [(1, False), (2, False), (1, True), (3, False)]
        jinner = JStaticPlanPolicy(jmake_plan(jrules(2, 4), entries), n_actions)
        pinner = StaticPlanPolicy(
            make_plan(default_rule_library(2, 4, device="cpu"), entries),
            n_actions)
    key = jax.random.key(11)
    want = JEpsilonGreedy(jinner, eps).act(jnp.asarray(s_bin), None, key, t)
    _, k1, k2 = jax.random.split(key, 3)
    explore = np.zeros((t + 1, b), np.int32)
    uniform = np.ones((t + 1, b), np.float32)
    explore[t] = np.asarray(jax.random.randint(k1, (b,), 0, n_actions,
                                               dtype=jnp.int32))
    uniform[t] = np.asarray(jax.random.uniform(k2, (b,)))
    pol = EpsilonGreedy(pinner, eps, torch.from_numpy(explore),
                        torch.from_numpy(uniform))
    got = pol.act(torch.from_numpy(s_bin), None, t)
    for name, g, w in zip(("action", "reset_before", "du_quota", "dv_quota"),
                          got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    took = (uniform[t] < np.float32(eps)).sum()
    assert took == {0.0: 0, 1.0: b}.get(eps, took)
    assert pol.n_actions == n_actions


def test_epsilon_greedy_draw_is_seeded():
    """``EpsilonGreedy.draw`` makes (t_max, B) draws on the generator's
    device: the same seed gives the same draws, in range."""
    inner = TabularQPolicy(torch.zeros(4, 8))

    def draw(seed):
        g = torch.Generator(device="cpu").manual_seed(seed)
        return EpsilonGreedy.draw(g, 8, 256, 8, 0.1, inner)

    a, b, c = draw(1), draw(1), draw(2)
    assert a.explore.shape == a.uniform.shape == (8, 256)
    assert a.explore.dtype == torch.int32 and a.uniform.dtype == torch.float32
    assert a.epsilon.dtype == torch.float32
    assert torch.equal(a.explore, b.explore) and torch.equal(a.uniform, b.uniform)
    assert not torch.equal(a.explore, c.explore)
    assert int(a.explore.min()) >= 0 and int(a.explore.max()) == 7
    assert float(a.uniform.min()) >= 0.0 and float(a.uniform.max()) < 1.0


def _random_transitions(seed, t_max=8, b=64, p=12, n_actions=8):
    """Few cells (many repeats), some invalid steps, some terminal."""
    rng = np.random.default_rng(seed)
    return {
        "s": rng.integers(0, p, size=(t_max, b)).astype(np.int32),
        "a": rng.integers(0, 3, size=(t_max, b)).astype(np.int32),
        "r": rng.normal(scale=0.05, size=(t_max, b)).astype(np.float32),
        "s2": rng.integers(0, p, size=(t_max, b)).astype(np.int32),
        "done": rng.random((t_max, b)) < 0.3,
        "valid": rng.random((t_max, b)) < 0.8,
    }


@pytest.mark.parametrize("gamma", [1.0, 0.98])
@pytest.mark.parametrize("seed", [0, 1])
def test_td_update_matches_reference(gamma, seed):
    """Scatter-mean TD(0) on random transitions with up to ~60 terms a
    cell: atol 1e-6.  The reference sums each cell in float32 in
    transition order; the port sums it in float64 and rounds once, so
    they differ by the reference's own rounding, a few ulps of values
    below 1.  Any permutation of the transitions gives the port's
    table bit for bit (the order of the sums is fixed by cell and
    value)."""
    p, n_actions = 12, 8
    tr = _random_transitions(seed, p=p, n_actions=n_actions)
    q = np.random.default_rng(seed + 9).normal(
        scale=0.1, size=(p, n_actions)).astype(np.float32)
    jqcfg = JQConfig(p=p, n_actions=n_actions, gamma=gamma)
    qcfg = QConfig(p=p, n_actions=n_actions, gamma=gamma)
    want = np.asarray(jtd_update(jqcfg, jnp.asarray(q),
                                 {k: jnp.asarray(v) for k, v in tr.items()}))
    got = td_update(qcfg, torch.from_numpy(q), _t_tree(tr))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert not np.array_equal(got.numpy(), q)          # cells moved

    perm = np.random.default_rng(seed).permutation(tr["s"].size)
    shuffled = {k: v.reshape(-1)[perm] for k, v in tr.items()}
    again = td_update(qcfg, torch.from_numpy(q), _t_tree(shuffled))
    assert torch.equal(again, got)


def test_td_update_meta_path_then_reference_parity():
    """td_update on meta tensors (a dry run: every transition valid and
    a cell of its own) gives the table's shape and dtype and says so;
    the CPU update after it is still within the reference's tolerance
    and bit-equal to one made without a meta call before it."""
    from repro_torch.launch.dryrun import counting

    p, n_actions = 12, 8
    tr = _random_transitions(0, p=p, n_actions=n_actions)
    q = np.random.default_rng(9).normal(scale=0.1, size=(p, n_actions)).astype(
        np.float32)
    qcfg = QConfig(p=p, n_actions=n_actions, gamma=0.98)
    before = td_update(qcfg, torch.from_numpy(q), _t_tree(tr))
    with counting() as c:
        got = td_update(qcfg, torch.from_numpy(q).to("meta"),
                        {k: v.to("meta") for k, v in _t_tree(tr).items()})
    assert got.device.type == "meta" and got.shape == (p, n_actions)
    assert got.dtype == torch.float32
    assert c.notes and c.notes[0].startswith("td_update: data-dependent")
    after = td_update(qcfg, torch.from_numpy(q), _t_tree(tr))
    assert torch.equal(after, before)
    want = np.asarray(jtd_update(JQConfig(p=p, n_actions=n_actions, gamma=0.98),
                                 jnp.asarray(q),
                                 {k: jnp.asarray(v) for k, v in tr.items()}))
    np.testing.assert_allclose(after.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["toward_target", "mean_not_race",
                                  "ignores_invalid"])
def test_td_update_reference_cases(case):
    """The reference's own TD cases (tests/test_qlearning.py), on the port."""
    def t(x):
        return torch.tensor([x])

    if case == "toward_target":
        qcfg = QConfig(p=4, n_actions=3, alpha=0.5, gamma=0.9)
        tr = dict(s=t([0]), a=t([1]), r=t([1.0]), s2=t([2]),
                  done=t([True]), valid=t([True]))
        q2 = td_update(qcfg, torch.zeros(4, 3), tr)
        assert float(q2[0, 1]) == pytest.approx(0.5)
        assert float(q2.abs().sum()) == pytest.approx(0.5)
    elif case == "mean_not_race":
        qcfg = QConfig(p=2, n_actions=2, alpha=1.0, gamma=0.0)
        tr = dict(s=t([0, 0]), a=t([0, 0]), r=t([1.0, 3.0]), s2=t([1, 1]),
                  done=t([True, True]), valid=t([True, True]))
        assert float(td_update(qcfg, torch.zeros(2, 2), tr)[0, 0]) == 2.0
    else:
        qcfg = QConfig(p=2, n_actions=2, alpha=1.0, gamma=0.0)
        tr = dict(s=t([0]), a=t([0]), r=t([5.0]), s2=t([1]),
                  done=t([True]), valid=t([False]))
        assert float(td_update(qcfg, torch.zeros(2, 2), tr).abs().sum()) == 0.0


# ----------------------------------------------------------- PolicyStore
def _pol(tag=0.5):
    return TabularQPolicy(torch.full((4, 8), tag))


def test_store_version_monotonicity():
    store = PolicyStore(staleness_bound=2)
    versions = [store.publish({CAT1: _pol()}) for _ in range(5)]
    assert versions == [1, 2, 3, 4, 5]
    assert store.version == 5
    snap = store.snapshot()
    assert isinstance(snap, PolicySnapshot) and snap.version == 5


def test_store_staleness_bound_rejection():
    store = PolicyStore(staleness_bound=1)
    v1 = store.publish({CAT1: _pol()})
    store.publish({CAT1: _pol()})
    assert store.validate(v1) == 1          # exactly at the bound: ok
    store.publish({CAT1: _pol()})
    with pytest.raises(StalePolicyError):
        store.validate(v1)                  # 2 behind, bound 1: rejected
    assert store.validate(store.version) == 0
    with pytest.raises(ValueError):
        PolicyStore(staleness_bound=-1)


@pytest.mark.parametrize("bad", ["raw_tensor", "raw_array", "empty", "not_dict"])
def test_store_rejects_raw_arrays_and_empty(bad):
    store = PolicyStore()
    arg = {"raw_tensor": {CAT1: torch.zeros(4, 8)},
           "raw_array": {CAT1: np.zeros((4, 8))},
           "empty": {}, "not_dict": [_pol()]}[bad]
    match = "TabularQPolicy" if bad.startswith("raw") else None
    with pytest.raises(TypeError, match=match):
        store.publish(arg)
    with pytest.raises(LookupError):
        store.snapshot()


def test_store_subscribe_and_read_only_snapshots():
    store = PolicyStore()
    store.publish({CAT1: _pol()})
    seen = []
    unsubscribe = store.subscribe(lambda snap: seen.append(snap.version))
    assert seen == [1]                      # replay current snapshot
    store.publish({CAT1: _pol()})
    assert seen == [1, 2]
    unsubscribe()
    store.publish({CAT1: _pol()})
    assert seen == [1, 2]
    with pytest.raises(TypeError):
        store.snapshot().policies[CAT2] = _pol()


def test_store_subscribe_under_concurrent_publish_stress():
    """Publishers racing subscribers: every subscriber sees strictly
    increasing versions and never a torn snapshot."""
    store = PolicyStore(staleness_bound=10**9)
    n_publishers, n_pubs, n_subscribers = 3, 25, 8
    tag_by_version, tag_lock = {}, threading.Lock()
    observed = [[] for _ in range(n_subscribers)]

    def publisher(pid):
        for i in range(n_pubs):
            tag = float(pid * 1000 + i)
            with tag_lock:
                version = store.publish({CAT1: _pol(tag), CAT2: _pol(tag)})
                tag_by_version[version] = tag

    def subscriber(sid):
        store.subscribe(lambda snap: observed[sid].append(
            (snap.version, float(snap.policies[CAT1].q[0, 0]),
             float(snap.policies[CAT2].q[0, 0]))))

    threads = [threading.Thread(target=publisher, args=(p,))
               for p in range(n_publishers)]
    threads += [threading.Thread(target=subscriber, args=(s,))
                for s in range(n_subscribers)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
        assert not th.is_alive()
    assert store.version == n_publishers * n_pubs
    for seq in observed:
        versions = [v for v, _, _ in seq]
        assert versions == sorted(set(versions))
        for v, t0, t1 in seq:
            assert t0 == t1 == tag_by_version[v]


# --------------------------------------------------------------- configs
def test_websearch_rl_config_matches_reference():
    """Both shapes and every width equal the reference's; the backend
    default is the port's name for the kernel path."""
    jarch, arch = jget_arch("websearch-rl"), get_arch("websearch-rl")
    assert set(arch.shapes) == set(jarch.shapes) == {"serve_queries",
                                                     "rl_rollout"}
    for name in arch.shapes:
        assert arch.shape(name).kind == jarch.shape(name).kind
        assert arch.shape(name).params == jarch.shape(name).params
    for reduced in (False, True):
        j = dataclasses.asdict(jarch.model_cfg(reduced))
        p = dataclasses.asdict(arch.model_cfg(reduced))
        assert j.pop("backend") == "xla" and p.pop("backend") == "block_scan"
        assert p == j


# ---------------------------------------------------------- device rule
def test_training_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the no-fallback path is not reachable")
    from repro_torch.core.state_bins import fit_bins

    with pytest.raises(RuntimeError, match="CUDA"):
        l1_ranker.init_l1(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        fit_bins(np.arange(100.0), np.arange(100.0), p=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_q(QConfig(p=4, n_actions=8))
    assert l1_ranker.init_l1(torch.Generator().manual_seed(0),
                             device="cpu")["w1"].device == CPU


# ------------------------------------------------------------- launcher
def test_launch_train_policy_writes_both_categories(tmp_path):
    from repro_torch.launch.train import main

    from repro_torch.data.querylog import CAT1, CAT2
    from repro_torch.distributed.checkpoint import latest_step, restore

    out = tmp_path / "train_policy.json"
    ckpt = tmp_path / "ckpt"
    main(["policy", "--n-docs", "1024", "--vocab", "512", "--n-queries",
          "200", "--iters", "3", "--batch", "8", "--p-bins", "64",
          "--device", "cpu", "--out", str(out), "--ckpt-dir", str(ckpt)])
    res = json.loads(out.read_text())
    assert set(res) == {"CAT1", "CAT2"}
    assert [res[c]["policy_version"] for c in ("CAT1", "CAT2")] == [1, 2]
    for c in res.values():
        assert np.isfinite(c["delta_u_pct"]) and np.isfinite(c["delta_ncg_pct"])
    # each category's trained Q-table checkpointed under its category id,
    # as the reference's policy mode saves it
    assert latest_step(ckpt) == max(CAT1, CAT2)
    for cat in (CAT1, CAT2):
        q = restore(ckpt, cat, {"q": torch.zeros(0)})["q"]
        assert q.dim() == 2 and torch.isfinite(q).all()


def _reference_figure2():
    """``benchmarks/figure2.py`` loaded by path (a script, not a package
    module), unedited."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "benchmarks" / "figure2.py"
    spec = importlib.util.spec_from_file_location("reference_figure2", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("keys", [("CAT1_weighted", "CAT2_weighted"),
                                  ("CAT1_unweighted", "CAT1_weighted")])
def test_launch_train_figure2_matches_reference_text(tmp_path, keys):
    """``launch/train.py figure2`` on a per-query record gives the text
    the reference's ``benchmarks/figure2.py`` gives on the same record
    (CAT2 weighted where present, else the first key), with shared
    cells and ties (u drawn from a few values)."""
    from repro_torch.launch.train import main

    rng = np.random.default_rng(9)
    data = {k: {"baseline_u": rng.integers(1, 40, 150).tolist(),
                "policy_u": rng.integers(1, 30, 150).tolist()}
            for k in keys}
    per_query = tmp_path / "table1_torch_perquery.json"
    per_query.write_text(json.dumps(data))
    ref_out, out = tmp_path / "figure2.txt", tmp_path / "figure2_torch.txt"
    _reference_figure2().main(str(per_query), str(ref_out))
    main(["figure2", "--per-query", str(per_query), "--out", str(out)])
    want = ref_out.read_text()
    assert out.read_text() == want
    plot = "".join(want.splitlines()[:16])
    assert "b" in plot and "p" in plot
