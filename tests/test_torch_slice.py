"""The port's serving path as a whole against the JAX reference system
(``tiny_system``: 2048 docs, 256-doc blocks).

Host data must be equal array for array.  With the reference's L1
parameters loaded, L1 scores agree within rtol=1e-5, atol=1e-6: both
compute the same float32 MLP (width 64), only the summation order
inside the matmuls and the ≤4-term feature sums differs.  Everything
downstream of the scores is then fed the REFERENCE's scores, so rollouts
and the executor compare exactly: candidate ids, u and cand_cnt bit for
bit, and the served scores exactly (they are the same floats, selected).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.rollout import unified_rollout as junified_rollout
from repro.data.querylog import CAT1, CAT2
from repro.index.blocks import pack_bits as jpack_bits
from repro.index.builder import batch_query_occupancy as jbatch_occ
from repro.policies import TabularQPolicy as JTabularQPolicy
from repro.serving.executor import ShardedExecutor as JShardedExecutor
from repro_torch.core.rollout import unified_rollout
from repro_torch.data.querylog import QueryLogConfig
from repro_torch.index.blocks import pack_bits, unpack_bits
from repro_torch.index.builder import batch_query_occupancy
from repro_torch.index.corpus import CorpusConfig
from repro_torch.policies import TabularQPolicy
from repro_torch.serving.executor import ShardedExecutor
from repro_torch.system import RetrievalSystem, SystemConfig

FIELDS = ("block_ptr", "u", "v", "matched", "cand", "cand_cnt", "topn", "done")
PORT_BACKENDS = ("reference", "block_scan")
N_BATCH = 12


def _t(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def _reference_arrays(ref):
    return dict(
        l1_params={k: np.asarray(v) for k, v in ref.l1_params.items()},
        bins={"u_edges": np.asarray(ref.bins.u_edges),
              "v_edges": np.asarray(ref.bins.v_edges)},
    )


@pytest.fixture(scope="module")
def port_system(tiny_system):
    c = tiny_system.cfg
    cfg = SystemConfig(
        corpus=CorpusConfig(n_docs=c.corpus.n_docs,
                            vocab_size=c.corpus.vocab_size,
                            seed=c.corpus.seed),
        querylog=QueryLogConfig(n_queries=c.querylog.n_queries,
                                seed=c.querylog.seed),
        block_docs=c.block_docs, p_bins=c.p_bins, u_budget=c.u_budget,
        rule_du_scale=c.rule_du_scale, rule_dv_scale=c.rule_dv_scale,
        l1_hidden=c.l1_hidden, seed=c.seed)
    sys_ = RetrievalSystem(cfg, device="cpu")
    sys_.load_reference(**_reference_arrays(tiny_system))
    return sys_


@pytest.fixture(scope="module")
def batches(tiny_system):
    """Per category: query ids and the reference's batch inputs."""
    out = {}
    for cat in (CAT1, CAT2):
        qids = np.where(tiny_system.log.category == cat)[0][:N_BATCH]
        occ, scores, tp = tiny_system.batch_inputs(qids)
        out[cat] = (qids, np.asarray(occ), np.asarray(scores), np.asarray(tp))
    return out


def _port_inputs(batch):
    _, occ, scores, tp = batch
    return _t(occ), _t(scores), _t(tp)


def test_host_data_equal(tiny_system, port_system):
    rc, pc = tiny_system.corpus, port_system.corpus
    for f in range(4):
        for a, b in zip(rc.field_terms[f], pc.field_terms[f]):
            np.testing.assert_array_equal(a, b)
    for name in ("static_rank", "doc_topic", "topic_terms"):
        np.testing.assert_array_equal(getattr(rc, name), getattr(pc, name))
    ri, pi = tiny_system.index, port_system.index
    for f in range(4):
        np.testing.assert_array_equal(ri.indptr[f], pi.indptr[f])
        np.testing.assert_array_equal(ri.doc_ids[f], pi.doc_ids[f])
    for name in ("static_rank", "doc_len", "df"):
        np.testing.assert_array_equal(getattr(ri, name), getattr(pi, name))
    for name in ("terms", "n_terms", "popularity", "category", "judged_ids",
                 "judged_gains", "seed_doc"):
        np.testing.assert_array_equal(getattr(tiny_system.log, name),
                                      getattr(port_system.log, name))
    np.testing.assert_array_equal(tiny_system.idf_all, port_system.idf_all)
    lists = [tiny_system.log.terms[q, :tiny_system.log.n_terms[q]]
             for q in range(20)]
    want = jbatch_occ(ri, lists)
    got = batch_query_occupancy(pi, lists)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    bits = np.random.default_rng(0).random((3, 5, 256)) < 0.3
    np.testing.assert_array_equal(pack_bits(bits), jpack_bits(bits))
    np.testing.assert_array_equal(unpack_bits(pack_bits(bits)), bits)


def test_converter_carries_rules_plans_and_q(tiny_system, port_system):
    """Rule library, plans and a Q-table cross from the reference
    unchanged, and equal the ones the port builds itself."""
    from repro_torch.weights import from_reference

    q = _seeded_q(tiny_system.bins.p, tiny_system.env_cfg.n_actions)
    rs = tiny_system.ruleset
    w = from_reference(
        q=q,
        ruleset={k: np.asarray(getattr(rs, k))
                 for k in ("allowed", "required", "du_quota", "dv_quota")},
        plans={name: {k: np.asarray(getattr(p, k)) for k in
                      ("rule_idx", "reset_before", "du_quota", "dv_quota")}
               for name, p in tiny_system.plans.items()},
        device="cpu")
    np.testing.assert_array_equal(w.q.numpy(), q)
    for k in ("allowed", "required", "du_quota", "dv_quota"):
        got = getattr(w.ruleset, k)
        assert torch.equal(got, getattr(port_system.ruleset, k)), k
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(rs, k)))
    assert set(w.plans) == set(port_system.plans) == {"CAT1", "CAT2"}
    for name, plan in w.plans.items():
        for k in ("rule_idx", "reset_before", "du_quota", "dv_quota"):
            assert torch.equal(getattr(plan, k),
                               getattr(port_system.plans[name], k)), (name, k)


def test_l1_scores_match(port_system, batches):
    for cat, batch in batches.items():
        qids, occ_ref, scores_ref, tp_ref = batch
        occ, scores, tp = port_system.batch_inputs(qids)
        np.testing.assert_array_equal(occ.numpy().view(np.uint32), occ_ref)
        np.testing.assert_array_equal(tp.numpy(), tp_ref)
        np.testing.assert_allclose(scores.numpy(), scores_ref, rtol=1e-5,
                                   atol=1e-6)


def test_fit_state_bins_equal_edges(tiny_system, port_system):
    """Same harvest (u, v only depend on the index, not on scores)."""
    bins = port_system.fit_state_bins(n_queries=48, batch=24)
    np.testing.assert_array_equal(bins.u_edges.numpy(),
                                  np.asarray(tiny_system.bins.u_edges))
    np.testing.assert_array_equal(bins.v_edges.numpy(),
                                  np.asarray(tiny_system.bins.v_edges))


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("cat", [CAT1, CAT2])
def test_production_plan_rollout(tiny_system, port_system, batches, cat,
                                 backend):
    """The production plan of each category, fed the reference's scores."""
    qids, occ, scores, tp = batches[cat]
    jfin, jtraj = tiny_system._run_plan_batch(
        tiny_system.plan_for_category(cat), jnp.asarray(occ),
        jnp.asarray(scores), jnp.asarray(tp))
    from repro_torch.core.match_plan import plan_rollout

    pfin, ptraj = plan_rollout(port_system.env_cfg, port_system.ruleset,
                               port_system.plan_for_category(cat),
                               *_port_inputs(batches[cat]), backend=backend)
    for f in FIELDS:
        got, want = getattr(pfin, f).numpy(), np.asarray(getattr(jfin, f))
        if want.dtype == np.uint32:
            got = got.view(np.uint32)
        np.testing.assert_array_equal(got, want, err_msg=f)
    for k in ("u", "v", "cand_cnt"):
        np.testing.assert_array_equal(ptraj[k].numpy(), np.asarray(jtraj[k]))


def _seeded_q(bins_p, n_actions):
    return np.random.default_rng(5).normal(
        size=(bins_p, n_actions)).astype(np.float32)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_tabular_rollout(tiny_system, port_system, batches, backend):
    """Greedy rollout over a seeded random Q-table (varied actions)."""
    qids, occ, scores, tp = batches[CAT1]
    q = _seeded_q(tiny_system.bins.p, tiny_system.env_cfg.n_actions)
    jr = junified_rollout(tiny_system.env_cfg, tiny_system.ruleset,
                          tiny_system.bins, JTabularQPolicy(jnp.asarray(q)),
                          tiny_system.cfg.t_max, jnp.asarray(occ),
                          jnp.asarray(scores), jnp.asarray(tp), backend="xla")
    pr = unified_rollout(port_system.env_cfg, port_system.ruleset,
                         port_system.bins, TabularQPolicy(torch.from_numpy(q)),
                         port_system.cfg.t_max, *_port_inputs(batches[CAT1]),
                         backend=backend)
    for f in ("block_ptr", "u", "v", "cand", "cand_cnt", "topn", "done"):
        np.testing.assert_array_equal(getattr(pr.final_state, f).numpy(),
                                      np.asarray(getattr(jr.final_state, f)),
                                      err_msg=f)
    for k in ("s", "a", "s2", "done", "valid"):
        np.testing.assert_array_equal(pr.transitions[k].numpy(),
                                      np.asarray(jr.transitions[k]), err_msg=k)
    assert len(np.unique(pr.transitions["a"].numpy())) > 2


@pytest.fixture(scope="module")
def reference_served(tiny_system, batches):
    """The reference executor's output per (n_shards, category, policy)."""
    q = _seeded_q(tiny_system.bins.p, tiny_system.env_cfg.n_actions)
    out = {}
    for n_shards in (1, 2):
        exe = JShardedExecutor(tiny_system, n_shards=n_shards, backend="xla")
        for cat in (CAT1, CAT2):
            _, occ, scores, tp = batches[cat]
            args = (jnp.asarray(occ), jnp.asarray(scores), jnp.asarray(tp))
            out[n_shards, cat, "plan"] = exe.execute(
                tiny_system.plan_policy(cat), *args)
            out[n_shards, cat, "q"] = exe.execute(
                JTabularQPolicy(jnp.asarray(q)), *args)
    return out, q


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("n_shards", [1, 2])
def test_executor_matches_reference(port_system, batches, reference_served,
                                    n_shards, backend):
    ref, q = reference_served
    exe = ShardedExecutor(port_system, n_shards=n_shards, backend=backend)
    for cat in (CAT1, CAT2):
        inputs = _port_inputs(batches[cat])
        for kind, policy in (("plan", port_system.plan_policy(cat)),
                             ("q", TabularQPolicy(torch.from_numpy(q)))):
            got = exe.execute(policy, *inputs)
            want = ref[n_shards, cat, kind]
            for name, g, w in zip(("ids", "scores", "u", "cand_cnt"), got, want):
                np.testing.assert_array_equal(g, np.asarray(w),
                                              err_msg=f"{cat}/{kind}/{name}")
    assert exe.execute_count == 4


def test_executor_defaults_to_system_backend(port_system):
    assert port_system.cfg.backend == "block_scan"
    assert ShardedExecutor(port_system).backend == "block_scan"
    with pytest.raises(ValueError, match="divide"):
        ShardedExecutor(port_system, n_shards=3)


@pytest.mark.parametrize("cat", [CAT1, CAT2])
def test_evaluate_matches_reference(tiny_system, port_system, cat):
    """Whole evaluate(): the port scores with its own L1 (loaded from the
    reference); u, cand and actions do not depend on the scores."""
    qids = np.where(tiny_system.log.category == cat)[0][:N_BATCH]
    q = _seeded_q(tiny_system.bins.p, tiny_system.env_cfg.n_actions)
    want = tiny_system.evaluate(jnp.asarray(q), qids, cat)
    got = port_system.evaluate(torch.from_numpy(q), qids, cat)
    for k in ("baseline_u", "policy_u", "baseline_cand", "policy_cand",
              "actions"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("baseline_ncg", "policy_ncg"):
        # float32 sums of at most 100 small integer gains over their ideal
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)


# ------------------------------------------- the single-step environment API
def _assert_state_equal(got, want, msg=""):
    """Every field of a port state bit-equal to the reference's
    (``matched`` as the same uint32 bits)."""
    for f in FIELDS:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        if w.dtype == np.uint32:
            g = g.view(np.uint32)
        np.testing.assert_array_equal(g, w, err_msg=f"{msg}{f}")


def _one_query(batch, i=0):
    """(reference inputs, port inputs) of query i of a batch."""
    _, occ, scores, tp = batch
    return ((jnp.asarray(occ[i]), jnp.asarray(scores[i]), jnp.asarray(tp[i])),
            (_t(occ[i]), _t(scores[i]), _t(tp[i])))


@pytest.fixture(scope="module")
def reference_steps(tiny_system, batches):
    """Per action a: the reference's states after env_step with actions
    (1, a, a) from env_reset on one query, and (rules only) after
    execute_rule of rule a with its own quotas from env_reset."""
    from repro.core.environment import env_reset as jenv_reset
    from repro.core.environment import env_step as jenv_step
    from repro.core.environment import execute_rule as jexecute_rule

    cfg, rs = tiny_system.env_cfg, tiny_system.ruleset
    inputs, _ = _one_query(batches[CAT1])
    out = {}
    for a in range(cfg.n_actions):
        s, states = jenv_reset(cfg), []
        for act in (1, a, a):
            s = jenv_step(cfg, rs, *inputs, s, jnp.int32(act))
            states.append(s)
        ran = None
        if a < cfg.k_rules:
            ran = jexecute_rule(cfg, *inputs, jenv_reset(cfg), *rs.gather(a))
        out[a] = states, ran
    return out


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("action", range(8))
def test_env_step_and_execute_rule_match_reference(port_system, batches,
                                                   reference_steps, action,
                                                   backend):
    """One query, no batch axis: each of the 6 rules, a_reset and a_stop
    after rule 1 and once more, bit-equal to the reference's env_step;
    each rule alone through execute_rule bit-equal too."""
    from repro_torch.core import env_reset, env_step, execute_rule

    cfg, rs = port_system.env_cfg, port_system.ruleset
    assert cfg.n_actions == 8
    _, inputs = _one_query(batches[CAT1])
    want_states, want_ran = reference_steps[action]
    s = env_reset(cfg, device="cpu")
    assert s.u.shape == () and s.matched.shape == (cfg.n_words_total,)
    for i, (act, want) in enumerate(zip((1, action, action), want_states)):
        s = env_step(cfg, rs, *inputs, s, act, backend=backend)
        _assert_state_equal(s, want, f"step {i}: ")
    if action < cfg.k_rules:
        allowed, required, du, dv = rs.gather(torch.tensor(action))
        ran = execute_rule(cfg, *inputs, env_reset(cfg, device="cpu"),
                           allowed, required, du, dv, backend=backend)
        _assert_state_equal(ran, want_ran, "execute_rule: ")


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_batched_env_step_matches_reference(tiny_system, port_system, batches,
                                            backend):
    """Two steps over a batch, each lane its own seeded action (every
    action drawn), bit-equal to the reference's jitted vmap."""
    from repro.core.environment import batched_env_step as jbatched_env_step
    from repro.core.environment import env_reset as jenv_reset
    from repro_torch.core import batched_env_step, env_reset

    import jax

    _, occ, scores, tp = batches[CAT1]
    jcfg, pcfg = tiny_system.env_cfg, port_system.env_cfg
    acts = np.random.default_rng(3).integers(0, pcfg.n_actions,
                                             (2, occ.shape[0])).astype(np.int32)
    assert len(np.unique(acts)) == pcfg.n_actions
    js = jax.vmap(lambda _: jenv_reset(jcfg))(jnp.arange(occ.shape[0]))
    ps = env_reset(pcfg, occ.shape[0], "cpu")
    for i, a in enumerate(acts):
        js = jbatched_env_step(jcfg, tiny_system.ruleset, jnp.asarray(occ),
                               jnp.asarray(scores), jnp.asarray(tp), js,
                               jnp.asarray(a))
        ps = batched_env_step(pcfg, port_system.ruleset,
                              *_port_inputs(batches[CAT1]), ps,
                              torch.from_numpy(a), backend=backend)
        _assert_state_equal(ps, js, f"step {i}: ")


# the properties of tests/test_match_engine.py, on the port's API
BIG = 10 ** 9


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_env_u_accounting(port_system, batches, backend):
    """u equals planes-per-block × blocks scanned for a single rule."""
    from repro_torch.core import block_cost, env_reset, execute_rule

    cfg, rs = port_system.env_cfg, port_system.ruleset
    occ, scores, tp = _one_query(batches[CAT1])[1]
    s1 = execute_rule(cfg, occ, scores, tp, env_reset(cfg, device="cpu"),
                      rs.allowed[0], rs.required[0], BIG, BIG, backend=backend)
    planes = int(block_cost(rs.allowed[0], tp))
    assert int(s1.u) == planes * cfg.n_blocks          # scanned the whole index
    assert int(s1.block_ptr) == cfg.n_blocks


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_env_candidates_unique_sorted(port_system, batches, backend):
    from repro_torch.core import env_reset, execute_rule

    cfg, rs = port_system.env_cfg, port_system.ruleset
    occ, scores, tp = _one_query(batches[CAT1])[1]
    s1 = execute_rule(cfg, occ, scores, tp, env_reset(cfg, device="cpu"),
                      rs.allowed[0], rs.required[0], BIG, BIG, backend=backend)
    cand = s1.cand.numpy()
    got = cand[cand >= 0]
    assert len(got) > 0 and len(np.unique(got)) == len(got)
    assert (np.diff(got) > 0).all()                    # scan order = doc id order
    assert int(s1.cand_cnt) == len(got)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_env_dedup_across_reset(port_system, batches, backend):
    """Re-running the same rule after a_reset adds no candidates but
    costs u (on the batch's first query whose rule 1 finds any)."""
    from repro_torch.core import env_reset, env_step

    cfg, rs = port_system.env_cfg, port_system.ruleset
    for i in range(N_BATCH):
        inputs = _one_query(batches[CAT1], i)[1]

        def step(s, a):
            return env_step(cfg, rs, *inputs, s, a, backend=backend)

        s1 = step(env_reset(cfg, device="cpu"), 1)
        if int(s1.cand_cnt) > 0:
            break
    s2 = step(s1, cfg.a_reset)
    assert int(s2.block_ptr) == 0
    s3 = step(s2, 1)
    assert int(s3.cand_cnt) == int(s1.cand_cnt) > 0
    assert int(s3.u) > int(s1.u)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_env_stop_is_terminal_and_frozen(port_system, batches, backend):
    from repro_torch.core import env_reset, env_step

    cfg, rs = port_system.env_cfg, port_system.ruleset
    inputs = _one_query(batches[CAT1])[1]

    def step(s, a):
        return env_step(cfg, rs, *inputs, s, a, backend=backend)

    s1 = step(env_reset(cfg, device="cpu"), 0)
    s2 = step(s1, cfg.a_stop)
    assert bool(s2.done)
    s3 = step(s2, 0)                                   # further rules are no-ops
    assert int(s3.u) == int(s2.u) and int(s3.cand_cnt) == int(s2.cand_cnt)


def test_env_reset_defaults_to_cuda():
    from repro_torch.core import env_reset

    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the no-fallback path is not reachable")
    with pytest.raises(RuntimeError, match="CUDA"):
        env_reset(None)


# ------------------------------------------------------ ncg_at_k, doc_bit
def test_ncg_at_k_matches_reference(tiny_system):
    """One query's NCG against the reference's ``ncg_at_k``, on candidate
    lists that hold some of its judged docs, none, and all; within 1e-6
    (float32 sums of at most 100 small integer gains over their ideal)."""
    from repro.ranking.metrics import ncg_at_k as jncg_at_k
    from repro_torch.ranking.metrics import batched_ncg, ncg_at_k

    rng = np.random.default_rng(9)
    log = tiny_system.log
    n_docs = tiny_system.index.n_docs
    for q in range(12):
        jids, gains = log.judged_ids[q], log.judged_gains[q]
        judged = jids[jids >= 0]
        for kind in ("some", "none", "all"):
            pick = {"some": judged[rng.random(len(judged)) < 0.5],
                    "none": judged[:0], "all": judged}[kind]
            cand = np.unique(np.concatenate(
                [pick, rng.integers(0, n_docs, 40)])).astype(np.int32)
            cand = np.pad(cand, (0, 160 - len(cand)), constant_values=-1)
            want = float(jncg_at_k(jnp.asarray(cand), jnp.asarray(jids),
                                   jnp.asarray(gains, jnp.float32)))
            got = ncg_at_k(torch.from_numpy(cand), torch.from_numpy(jids),
                           torch.from_numpy(gains))
            assert got.shape == () and got.dtype == torch.float32
            assert abs(float(got) - want) <= 1e-6, (q, kind)
            row = batched_ncg(torch.from_numpy(cand)[None],
                              torch.from_numpy(jids)[None],
                              torch.from_numpy(gains)[None])[0]
            assert float(row) == float(got)


def test_doc_bit_matches_reference():
    """Bit for bit against the reference's ``doc_bit`` on a stack of
    blocks: scalar offsets at the word edges and a vector of offsets."""
    from repro.index.blocks import doc_bit as jdoc_bit
    from repro_torch.index.blocks import doc_bit, words_to_tensor

    bits = np.random.default_rng(22).random((3, 5, 256)) < 0.4
    words = pack_bits(bits)
    t = words_to_tensor(words, "cpu")
    for d in (0, 31, 32, 77, 127, 255):
        got = doc_bit(t, d)
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jdoc_bit(jnp.asarray(words), jnp.int32(d))).astype(np.int32))
        np.testing.assert_array_equal(got.numpy(), bits[..., d])
    offs = np.array([3, 64, 200, 255], np.int32)
    got = doc_bit(t, torch.from_numpy(offs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jdoc_bit(jnp.asarray(words), jnp.asarray(offs))).astype(np.int32))
