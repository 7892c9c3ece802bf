"""Train the paper's RL match-planning policy end to end on the PyTorch
port and reproduce the Table-1-style result (blocks accessed down, NCG
~flat), on the GPU.

    PYTHONPATH=src python examples/train_policy_torch.py
    PYTHONPATH=src python examples/train_policy_torch.py --device cpu

The same sizes, seeds, iteration counts, category order and printed
lines as ``examples/train_policy.py``; the last line is one JSON object
with the numbers printed before it.
"""
import argparse
import json

import numpy as np

from repro_torch.data.querylog import CAT1, CAT2, QueryLogConfig
from repro_torch.index.corpus import CorpusConfig
from repro_torch.ranking.metrics import relative_delta
from repro_torch.system import RetrievalSystem, SystemConfig

CATEGORIES = ((CAT2, "CAT2"), (CAT1, "CAT1"))
EVAL_QUERIES = 192


def build_system(device: str = "cuda") -> RetrievalSystem:
    """The example's system: L1 ranker and state bins fitted."""
    sys_ = RetrievalSystem(SystemConfig(
        corpus=CorpusConfig(n_docs=4096, vocab_size=2048, seed=0),
        querylog=QueryLogConfig(n_queries=1000, seed=0),
        block_docs=256, p_bins=1024, u_budget=1024, l1_steps=300,
    ), device=device)
    print("L1 ranker ...")
    sys_.fit_l1(n_queries=128, batch=16)
    print("state bins (harvesting baseline (u,v) trajectories) ...")
    sys_.fit_state_bins(n_queries=96, batch=32)
    return sys_


def train(sys_: RetrievalSystem, cat: int):
    """One category's Q table."""
    q, _ = sys_.train_policy(cat, iters=150, batch=48, log_every=30)
    return q


def evaluate(sys_: RetrievalSystem, q, cat: int, name: str) -> dict:
    """The greedy Q policy against the production plan on the category's
    first queries; prints and returns Δu % and ΔNCG %, with the per-query
    arrays of ``RetrievalSystem.evaluate``."""
    qids = np.where(sys_.log.category == cat)[0][:EVAL_QUERIES]
    res = sys_.evaluate(q, qids, cat)
    du = relative_delta(res["policy_u"], res["baseline_u"])
    dncg = relative_delta(res["policy_ncg"], res["baseline_ncg"])
    print(f"[{name}] blocks accessed {du:+.1f}%  "
          f"NCG@100 {dncg:+.1f}%  "
          f"(paper: CAT2 −22.7%/+0.2%, CAT1 −17.5%/−1.8%)")
    return {"du_pct": du, "dncg_pct": dncg, "result": res}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    sys_ = build_system(args.device)
    out = {}
    for cat, name in CATEGORIES:
        row = evaluate(sys_, train(sys_, cat), cat, name)
        out[name] = {"du_pct": row["du_pct"], "dncg_pct": row["dncg_pct"]}
    out = {"example": "train_policy", "categories": out}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
