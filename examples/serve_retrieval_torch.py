"""Serve queries through the PyTorch port's online engine on the GPU:
L0 policy → shard merge → L1 prune, with admission, result caching and
shape-bucketed micro-batching.

Trained Q-table policies are published to a versioned PolicyStore, the
engine serves snapshot v1, and publishing the hand-tuned static plans as
v2 hot-swaps the serving policy — no engine restart, result cache
flushed, new serve steps prepared for the new policy structure.

    PYTHONPATH=src python examples/serve_retrieval_torch.py
    PYTHONPATH=src python examples/serve_retrieval_torch.py --device cpu

The same sizes, seeds and printed lines as
``examples/serve_retrieval.py``; the last line is one JSON object with
the numbers printed before it.
"""
import argparse
import json

import numpy as np

from repro_torch.data.querylog import CAT1, CAT2, QueryLogConfig
from repro_torch.index.corpus import CorpusConfig
from repro_torch.policies import PolicyStore
from repro_torch.serving import EngineConfig, ServeEngine
from repro_torch.system import RetrievalSystem, SystemConfig

N_SERVED = 96


def build_system(device: str = "cuda") -> RetrievalSystem:
    """The example's system: L1 ranker and state bins fitted."""
    sys_ = RetrievalSystem(SystemConfig(
        corpus=CorpusConfig(n_docs=4096, vocab_size=1024, seed=0),
        querylog=QueryLogConfig(n_queries=400, seed=0),
        block_docs=256, p_bins=256, u_budget=1024, l1_steps=100,
    ), device=device)
    sys_.fit_l1(n_queries=96)
    sys_.fit_state_bins(n_queries=64)
    return sys_


def serve(sys_: RetrievalSystem, store: PolicyStore):
    """Serve one stream at the store's snapshot, publish the static plans
    and serve it again; prints as the reference example does.  Returns
    (the numbers printed, the responses before the swap, after it)."""
    engine = ServeEngine(sys_, store, EngineConfig(
        min_bucket=8, max_bucket=32, cache_capacity=512, n_shards=2))
    engine.warmup()

    rng = np.random.default_rng(0)
    qids = rng.integers(0, sys_.log.n_queries, size=N_SERVED)
    learned = engine.serve(qids)
    v_learned = engine.policy_version

    r0 = learned[0]
    print(f"query {r0.qid} (cat {r0.category}): u={r0.u} "
          f"top doc ids {r0.doc_ids[:5].tolist()} "
          f"[policy snapshot v{v_learned}]")

    # Hot-swap: publish the hand-tuned production plans as snapshot v2.
    # The same engine serves them on the next drain — the baseline is
    # just another Policy.
    store.publish(sys_.baseline_policies((CAT1, CAT2)))
    baseline = engine.serve(qids)
    u_learned = np.mean([r.u for r in learned])
    u_baseline = np.mean([r.u for r in baseline])
    du = 100 * (u_learned - u_baseline) / u_baseline
    print(f"hot-swapped to v{engine.policy_version}: "
          f"mean u learned={u_learned:.0f} vs static plan={u_baseline:.0f} "
          f"({du:+.1f}%)")

    summary = engine.summary()
    print("engine summary:", json.dumps(summary, indent=1))
    out = {"example": "serve_retrieval",
           "versions": [v_learned, engine.policy_version],
           "first_query": {"qid": int(r0.qid), "u": int(r0.u),
                           "top_doc_ids": r0.doc_ids[:5].tolist()},
           "mean_u_learned": float(u_learned),
           "mean_u_static": float(u_baseline), "du_pct": float(du),
           "summary": summary}
    return out, learned, baseline


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    sys_ = build_system(args.device)
    store = sys_.train_policy_store(cats=(CAT1, CAT2), iters=60, batch=32)
    out, _, _ = serve(sys_, store)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
