"""Quickstart on the PyTorch port: build a tiny web index, run the
production match plans, inspect candidates + NCG — the paper's L0 stage
in a few lines, on the GPU.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The same sizes, seeds and printed lines as ``examples/quickstart.py``;
the last line is one JSON object with the numbers printed before it.
"""
import argparse
import json

import numpy as np

from repro_torch.data.querylog import CAT1, CAT2, QueryLogConfig
from repro_torch.index.corpus import CorpusConfig
from repro_torch.ranking.metrics import batched_ncg
from repro_torch.system import RetrievalSystem, SystemConfig

CATEGORIES = ((CAT1, "CAT1 (rare multi-term)"), (CAT2, "CAT2 (navigational)"))
QUERIES_PER_CATEGORY = 32


def build_system(device: str = "cuda") -> RetrievalSystem:
    """The example's system, its L1 ranker fitted."""
    sys_ = RetrievalSystem(SystemConfig(
        corpus=CorpusConfig(n_docs=2048, vocab_size=1024, seed=0),
        querylog=QueryLogConfig(n_queries=200, seed=0),
        block_docs=256, p_bins=256, l1_steps=100,
    ), device=device)
    sys_.fit_l1(n_queries=48, batch=16)
    return sys_


def report(sys_: RetrievalSystem) -> dict:
    """Run each category's production plan over its first queries and
    print the mean u, candidates and NCG@100; returns those numbers."""
    out = {}
    for cat, name in CATEGORIES:
        qids = np.where(sys_.log.category == cat)[0][:QUERIES_PER_CATEGORY]
        final, traj, _ = sys_.run_baseline(qids, cat)
        judged_ids, judged_gains = sys_.judged(qids)
        ncg = batched_ncg(final.cand, judged_ids, judged_gains)
        row = {"mean_u": float(final.u.cpu().numpy().mean()),
               "candidates": float(final.cand_cnt.cpu().numpy().mean()),
               "ncg": float(ncg.cpu().numpy().mean())}
        print(f"{name}: mean u={row['mean_u']:.1f} blocks, "
              f"candidates={row['candidates']:.1f}, "
              f"NCG@100={row['ncg']:.3f}")
        out[name.split()[0]] = row

    q = qids[0]
    terms = sys_.log.terms[q][sys_.log.terms[q] >= 0]
    print(f"\nexample query {q}: terms={terms.tolist()} "
          f"(df={sys_.index.df[terms, 2].tolist()} in body)")
    return {"example": "quickstart", "categories": out,
            "query": int(q), "terms": terms.tolist()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = report(build_system(args.device))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
