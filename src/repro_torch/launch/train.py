"""End-to-end training commands of the port (the reference's
``launch/train.py`` ``policy`` and ``lm`` modes, and its
``benchmarks/table1.py``).

  policy  — the paper: build corpus/index/query log, train the L1
            ranker, fit state bins, Q-learn per-category match policies,
            publish each into a ``PolicyStore``, checkpoint each trained
            Q-table (``--ckpt-dir``), evaluate against the production
            plans, print and write Δu / ΔNCG.

  lm      — train a reduced LM config for a few hundred steps on
            synthetic data through the cell's train step
            (``launch/steps.py``), with checkpoint/restart through the
            resilient loop (``distributed/``); ``--inject-failure``
            kills the step at half way, once.

  table1  — Table 1: ΔNCG@100 and Δu of the learned policy against the
            production plans, per category × weighted/unweighted eval
            set, with paired sign-permutation p-values, at the
            reference's ``small`` or ``full`` scale.

  figure2 — Figure 2 (the reference's ``benchmarks/figure2.py``): the
            per-query u that ``table1`` wrote, sorted per treatment,
            learned policy against production plan, as an ASCII plot.

The first three run on ``--device`` (``cuda`` unless asked), ``policy``
and ``table1`` every rollout through ``--backend`` (``block_scan``: the
chunked CUDA kernel); ``figure2`` only reads a file::

    PYTHONPATH=src python -m repro_torch.launch.train policy --iters 200
    PYTHONPATH=src python -m repro_torch.launch.train lm --arch starcoder2-3b --steps 100
    PYTHONPATH=src python -m repro_torch.launch.train table1 --scale small
    PYTHONPATH=src python -m repro_torch.launch.train figure2
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

# Table 1 of the paper (the envelope the shape is read against):
# (category, eval set) -> (ΔNCG %, Δu %).
PAPER_TABLE1 = {
    ("CAT1", "weighted"): (-1.8, -17.5),
    ("CAT1", "unweighted"): (-6.2, -16.3),
    ("CAT2", "weighted"): (0.2, -22.7),
}


def device_name(dev) -> str:
    import torch

    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def train_policy_cmd(args) -> dict:
    from repro_torch.data.querylog import CAT1, CAT2, QueryLogConfig
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.index.corpus import CorpusConfig
    from repro_torch.policies import PolicyStore, TabularQPolicy
    from repro_torch.ranking.metrics import relative_delta
    from repro_torch.system import RetrievalSystem, SystemConfig

    t0 = time.perf_counter()
    sys_ = RetrievalSystem(SystemConfig(
        corpus=CorpusConfig(n_docs=args.n_docs, vocab_size=args.vocab, seed=0),
        querylog=QueryLogConfig(n_queries=args.n_queries, seed=0),
        block_docs=args.block_docs, p_bins=args.p_bins,
        u_budget=args.u_budget, l1_steps=300, backend=args.backend,
    ), device=args.device)
    print(f"[build] {sys_.index.n_docs} docs, {sys_.log.n_queries} queries, "
          f"{sys_.index.n_blocks} blocks on {device_name(sys_.device)} "
          f"({time.perf_counter() - t0:.1f}s)")
    sys_.fit_l1(n_queries=min(192, args.n_queries // 4))
    sys_.fit_state_bins(n_queries=128)
    print(f"[bins] p={sys_.bins.p}")

    # Trained policies are published per category into a PolicyStore;
    # every snapshot covers every category, so not-yet-trained ones
    # serve the hand-tuned static plan.
    store = PolicyStore(staleness_bound=1)
    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    out = {}
    trained = sys_.baseline_policies((CAT1, CAT2))
    for cat, name in ((CAT1, "CAT1"), (CAT2, "CAT2")):
        q, _ = sys_.train_policy(cat, iters=args.iters, batch=args.batch,
                                 log_every=max(args.iters // 8, 1))
        mgr.save(cat, {"q": q})
        trained[cat] = TabularQPolicy(q)
        version = store.publish(dict(trained))
        qids = np.where(sys_.log.category == cat)[0][:256]
        res = sys_.evaluate(q, qids, cat)
        out[name] = {
            "delta_u_pct": relative_delta(res["policy_u"], res["baseline_u"]),
            "delta_ncg_pct": relative_delta(res["policy_ncg"],
                                            res["baseline_ncg"]),
            "policy_version": version,
        }
        print(f"[{name}] Δu={out[name]['delta_u_pct']:+.1f}%  "
              f"ΔNCG={out[name]['delta_ncg_pct']:+.1f}%  "
              f"(published policy snapshot v{version})")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return out


# ---------------------------------------------------------------------- lm
def train_lm_cmd(args) -> dict:
    """The reference's ``train_lm_cmd``: the reduced config's
    ``train_4k`` cell, data seeded by step (``default_rng(1234 + step)``),
    a checkpoint every 25 steps (async), and the loss must fall.  Returns
    the resilient loop's result with the per-step losses (replayed steps
    included)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.distributed.fault_tolerance import (
        FailureInjector, FaultToleranceConfig, run_resilient_loop)
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.transformer import init_params
    from repro_torch.train.tree import tree_map

    dev = resolve_device(args.device)
    cell = build_cell(args.arch, "train_4k", mesh=None, reduced=True)
    cfg = get_arch(args.arch).model_cfg(True)
    params = init_params(cfg, seed=0, device=dev)
    opt_state = tree_map(lambda x: torch.zeros(x.shape, dtype=x.dtype,
                                               device=dev), cell.args[1])
    b, s = cell.args[2].shape
    losses = []

    def data_for(step: int):
        r = np.random.default_rng(1234 + step)        # stateless, seeded by step
        toks = torch.from_numpy(r.integers(0, cfg.vocab, size=(b, s + 1)))
        toks = toks.to(dev, torch.int32)
        return toks[:, :-1], toks[:, 1:]

    def step_fn(state, step):
        tokens, targets = data_for(step)
        p, o, metrics = cell.fn(state["params"], state["opt"], tokens, targets)
        losses.append(float(metrics["loss"]))
        if step % 10 == 0:
            print(f"step {step:4d} loss {losses[-1]:.4f}")
        return {"params": p, "opt": o}

    ft = FaultToleranceConfig(ckpt_dir=args.ckpt_dir, ckpt_every=25,
                              async_save=True)
    injector = (FailureInjector(fail_at=(args.steps // 2,))
                if args.inject_failure else None)
    res = run_resilient_loop({"params": params, "opt": opt_state}, step_fn,
                             args.steps, ft, injector=injector)
    print(f"[done] steps={args.steps} restarts={res['restarts']} "
          f"first_loss={losses[0]:.3f} last_loss={losses[-1]:.3f} "
          f"wall={res['wall_s']:.0f}s on {device_name(dev)}")
    if not losses[-1] < losses[0]:
        raise AssertionError("loss should decrease")
    return dict(res, losses=losses)


# ------------------------------------------------------------------ table1
def build_table1_system(scale: str = "small", device=None,
                        backend: str = "block_scan"):
    """The reference Table 1 benchmark's system (``build_system``): built,
    L1 fitted, state bins fitted."""
    from repro_torch.data.querylog import QueryLogConfig
    from repro_torch.index.corpus import CorpusConfig
    from repro_torch.system import RetrievalSystem, SystemConfig

    if scale == "small":
        cfg = SystemConfig(
            corpus=CorpusConfig(n_docs=8192, vocab_size=2048, seed=0),
            querylog=QueryLogConfig(n_queries=1200, seed=0),
            block_docs=256, p_bins=1024, u_budget=8192, l1_steps=2500,
            rule_du_scale=8, rule_dv_scale=50, l1_hidden=64, t_max=10,
            backend=backend)
        fit = dict(l1=(384, 24), bins=(128, 32))
    elif scale == "full":
        cfg = SystemConfig(
            corpus=CorpusConfig(n_docs=16384, vocab_size=4096, seed=0),
            querylog=QueryLogConfig(n_queries=4000, seed=0),
            block_docs=512, p_bins=4096, u_budget=16384, l1_steps=3000,
            rule_du_scale=12, rule_dv_scale=100, l1_hidden=64, t_max=10,
            backend=backend)
        fit = dict(l1=(512, 24), bins=(256, 32))
    else:
        raise ValueError(f"unknown scale {scale!r}")
    sys_ = RetrievalSystem(cfg, device=device)
    sys_.fit_l1(*fit["l1"])
    sys_.fit_state_bins(*fit["bins"])
    return sys_


def table1_rows(sys_, iters: int = 300, train_batch: int = 48,
                n_eval: int = 1024, seed: int = 0):
    """Train per category and evaluate on the weighted and unweighted
    eval sets (the reference benchmark's ``run``); returns (rows,
    per-query u)."""
    from repro_torch.data.querylog import CAT1, CAT2, sample_eval_sets
    from repro_torch.ranking.metrics import (paired_permutation_pvalue,
                                             relative_delta)

    rows, per_query = [], {}
    weighted, unweighted = sample_eval_sets(sys_.log, n_eval, seed=seed)
    for cat, cat_name in ((CAT1, "CAT1"), (CAT2, "CAT2")):
        q, _ = sys_.train_policy(cat, iters=iters, batch=train_batch,
                                 seed=seed, eps_start=0.6, eps_end=0.08)
        for set_name, qids_all in (("weighted", weighted),
                                   ("unweighted", unweighted)):
            qids = qids_all[sys_.log.category[qids_all] == cat]
            seg = len(qids) / len(qids_all) * 100.0
            if len(qids) < 12:
                rows.append({"category": cat_name, "set": set_name,
                             "segment_pct": seg, "note": "coverage too low"})
                continue
            res = sys_.evaluate(q, qids, cat)
            rows.append({
                "category": cat_name, "set": set_name, "segment_pct": seg,
                "n_queries": int(len(qids)),
                "delta_ncg_pct": relative_delta(res["policy_ncg"],
                                                res["baseline_ncg"]),
                "delta_u_pct": relative_delta(res["policy_u"],
                                              res["baseline_u"]),
                "p_ncg": paired_permutation_pvalue(res["policy_ncg"],
                                                   res["baseline_ncg"]),
                "p_u": paired_permutation_pvalue(
                    res["policy_u"].astype(float),
                    res["baseline_u"].astype(float)),
                "baseline_ncg": float(res["baseline_ncg"].mean()),
                "policy_ncg": float(res["policy_ncg"].mean()),
                "baseline_u": float(res["baseline_u"].mean()),
                "policy_u": float(res["policy_u"].mean()),
            })
            per_query[f"{cat_name}_{set_name}"] = {
                "policy_u": res["policy_u"].tolist(),
                "baseline_u": res["baseline_u"].tolist(),
            }
    return rows, per_query


def table1_cmd(args) -> list:
    t0 = time.perf_counter()
    sys_ = build_table1_system(args.scale, args.device, args.backend)
    t_build = time.perf_counter() - t0
    rows, per_query = table1_rows(sys_)
    wall = time.perf_counter() - t0
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({
        "rows": rows, "scale": args.scale, "backend": args.backend,
        "device": device_name(sys_.device), "build_fit_s": t_build,
        "wall_s": wall}, indent=1))
    out.with_name(out.stem + "_perquery.json").write_text(json.dumps(per_query))
    print(f"[table1] {args.scale} scale on {device_name(sys_.device)}, "
          f"'{args.backend}': {wall:.1f} s ({t_build:.1f} s build + fits)")
    print(f"{'cat':5s} {'set':11s} {'seg%':>6s} {'dNCG%':>7s} {'du%':>7s} "
          f"{'p_ncg':>7s} {'p_u':>7s}   paper dNCG% du%")
    for r in rows:
        paper = PAPER_TABLE1.get((r["category"], r["set"]))
        paper_s = (f"{paper[0]:+.1f} {paper[1]:+.1f}" if paper
                   else "coverage too low")
        if "note" in r:
            print(f"{r['category']:5s} {r['set']:11s} {r['segment_pct']:6.1f} "
                  f"{r['note']}   paper {paper_s}")
        else:
            print(f"{r['category']:5s} {r['set']:11s} {r['segment_pct']:6.1f} "
                  f"{r['delta_ncg_pct']:7.2f} {r['delta_u_pct']:7.2f} "
                  f"{r['p_ncg']:7.4f} {r['p_u']:7.4f}   paper {paper_s}")
    return rows


# ----------------------------------------------------------------- figure2
def ascii_curve(base: np.ndarray, pol: np.ndarray, width: int = 72,
                height: int = 16) -> str:
    """Sorted per-query u of both treatments on one character grid,
    ``b`` baseline and ``p`` policy (drawn second, so it covers a shared
    cell; as in the reference, the legend's ``x`` is never drawn)."""
    base = np.sort(base)
    pol = np.sort(pol)
    hi = max(base.max(), pol.max()) * 1.05
    grid = [[" "] * width for _ in range(height)]
    for series, ch in ((base, "b"), (pol, "p")):
        xs = np.linspace(0, len(series) - 1, width).astype(int)
        for col, xi in enumerate(xs):
            row = height - 1 - int(series[xi] / hi * (height - 1))
            grid[row][col] = "x" if grid[row][col] == ch else ch
    lines = ["".join(r) for r in grid]
    lines.append("-" * width)
    lines.append("queries sorted by u per treatment;  b=baseline  p=policy  "
                 "x=overlap")
    return "\n".join(lines)


def figure2_text(per_query: dict) -> str:
    """Figure 2 of one ``table1`` per-query record: CAT2 weighted where
    present, else the first key."""
    key = "CAT2_weighted" if "CAT2_weighted" in per_query else sorted(per_query)[0]
    base = np.asarray(per_query[key]["baseline_u"], float)
    pol = np.asarray(per_query[key]["policy_u"], float)
    return ascii_curve(base, pol) + (
        f"\nmean u: baseline={base.mean():.1f} policy={pol.mean():.1f} "
        f"({(pol.mean() - base.mean()) / base.mean() * 100:+.1f}%)  [{key}]")


def figure2_cmd(args) -> str:
    txt = figure2_text(json.loads(Path(args.per_query).read_text()))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(txt)
    print(txt)
    return txt


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="mode", required=True)

    p = sub.add_parser("policy")
    p.add_argument("--n-docs", type=int, default=8192)
    p.add_argument("--vocab", type=int, default=2048)
    p.add_argument("--n-queries", type=int, default=2000)
    p.add_argument("--block-docs", type=int, default=256)
    p.add_argument("--p-bins", type=int, default=1024)
    p.add_argument("--u-budget", type=int, default=1024)
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--batch", type=int, default=48)
    p.add_argument("--ckpt-dir", default="results/ckpt_policy_torch")
    p.add_argument("--out", default="results/train_policy_torch.json")
    p.set_defaults(fn=train_policy_cmd)

    p = sub.add_parser("table1")
    p.add_argument("--scale", choices=("small", "full"), default="small")
    p.add_argument("--out", default="results/table1_torch.json")
    p.set_defaults(fn=table1_cmd)

    for p in sub.choices.values():
        p.add_argument("--backend", default="block_scan",
                       help="index-scan backend of every rollout "
                            "(repro_torch.core.scan_backends)")

    p = sub.add_parser("lm")
    p.add_argument("--arch", default="starcoder2-3b")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--ckpt-dir", default="results/ckpt_lm_torch")
    p.add_argument("--inject-failure", action="store_true")
    p.set_defaults(fn=train_lm_cmd)

    for p in sub.choices.values():
        p.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu")

    p = sub.add_parser("figure2")
    p.add_argument("--per-query", default="results/table1_torch_perquery.json")
    p.add_argument("--out", default="results/figure2_torch.txt")
    p.set_defaults(fn=figure2_cmd)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
