"""Plain reference of the paper's match planning (Rosset et al., SIGIR
2018, §3-4), written from the configuration file alone: no part of the
program is imported or called, and nothing it made is read.

A query's episode runs ``t_max`` agent steps.  Each step picks an action
from the Q table at the state's bin (greedy, or ε-greedy on given draws):
one of the configuration's match rules, reset (rewind to the first
block) or stop.  A rule scans the query's index one block at a time from
its block pointer while, before the block, Δu < its Δu quota, Δv < its Δv
quota, the pointer is inside the index, u < the u budget and the episode
is not done.  A block costs u the number of (term, field) planes the rule
reads for the query's present terms; it adds to v the matches of each
present term in its allowed fields (Σ_t popcount(∨_f occ)); the docs that
match the rule's conjunction and were not matched before join the
candidates in doc order, up to K, and their scores the running top n.
The step's reward is Eq. 4 (Eq. 3 at the new state less the production
plan's reward at that step, a penalty where no candidate joined, 0 once
done); the TD(0) update averages the TD errors of each (state, action)
cell (float64 sums) and moves Q by α times the mean.

Every float is computed in ``dtype``: float32 as configured, or a lower
precision for the control that the check has to reject.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

FIELDS = ("anchor", "url", "body", "title")
# popcount of each byte value
_BYTE_BITS = torch.tensor([bin(i).count("1") for i in range(256)],
                          dtype=torch.int64)


def rules(cfg: dict, device) -> Tuple[torch.Tensor, ...]:
    """allowed (k, T, F), required (k, T), du (k,), dv (k,) from the
    configuration's rule list."""
    t, f = cfg["query_terms_max"], cfg["fields"]
    k = len(cfg["rules"])
    allowed = torch.zeros((k, t, f), dtype=torch.bool)
    required = torch.zeros((k, t), dtype=torch.bool)
    for i, rule in enumerate(cfg["rules"]):
        terms = range(t) if rule["terms"] == "all" else rule["terms"]
        for term in terms:
            required[i, term] = True
            for name in rule["fields"]:
                allowed[i, term, FIELDS.index(name)] = True
    du = torch.tensor([r["du_quota"] for r in cfg["rules"]], dtype=torch.int64)
    dv = torch.tensor([r["dv_quota"] for r in cfg["rules"]], dtype=torch.int64)
    return (allowed.to(device), required.to(device), du.to(device),
            dv.to(device))


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (int32 holding the bits), by bytes."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    table = _BYTE_BITS.to(words.device)
    return sum(table[(x >> s) & 0xFF] for s in (0, 8, 16, 24))


def state_bin(u, v, u_edges, v_edges, dtype):
    """Bin of (u, v): the stratum is the number of u edges <= u, the bin
    within it the number of that stratum's v edges <= v."""
    uf, vf = u.to(dtype), v.to(dtype)
    ue, ve = u_edges.to(dtype), v_edges.to(dtype)
    stratum = (ue[None, :] <= uf[:, None]).sum(1)
    within = (ve[stratum] <= vf[:, None]).sum(1)
    return stratum * (ve.shape[1] + 1) + within


class Episode:
    """A batch of episodes' state, as one block-at-a-time scan."""

    def __init__(self, cfg, occ, scores, tp, dtype):
        self.cfg, self.occ, self.tp, self.dtype = cfg, occ, tp, dtype
        self.scores = scores.to(dtype)
        b, dev = occ.shape[0], occ.device
        self.words = cfg["block_docs"] // 32
        zeros = lambda: torch.zeros(b, dtype=torch.int64, device=dev)  # noqa: E731
        self.bp, self.u, self.v, self.cnt = zeros(), zeros(), zeros(), zeros()
        self.done = torch.zeros(b, dtype=torch.bool, device=dev)
        self.matched = torch.zeros((b, cfg["n_blocks"] * self.words),
                                   dtype=torch.int32, device=dev)
        self.cand = torch.full((b, cfg["max_candidates"]), -1,
                               dtype=torch.int64, device=dev)
        self.topn = torch.full((b, cfg["n_top"]), -math.inf, dtype=dtype,
                               device=dev)

    def scan_block(self, lanes, allowed, required):
        """Scan each lane's block at its pointer with its rule."""
        cfg, w, d = self.cfg, self.words, self.cfg["block_docs"]
        bp = self.bp[lanes]
        block = self.occ[lanes, bp]                              # (n, T, F, W)
        present = self.tp[lanes]
        act = allowed & present[:, :, None]
        planes = torch.where(act[..., None], block, 0)
        term_any = planes[:, :, 0]
        for f in range(1, planes.shape[2]):
            term_any = term_any | planes[:, :, f]                # (n, T, W)
        req = required & present
        conj = torch.full_like(term_any[:, 0], -1)
        for t in range(req.shape[1]):
            conj = torch.where(req[:, t, None], conj & term_any[:, t], conj)
        conj = torch.where(req.any(1)[:, None], conj, 0)
        self.v[lanes] += popcount(term_any).sum((1, 2))
        self.u[lanes] += act.sum((1, 2))
        cols = bp[:, None] * w + torch.arange(w, device=bp.device)[None]
        before = self.matched[lanes[:, None], cols]
        self.matched[lanes[:, None], cols] = before | conj
        new = conj & ~before                                     # (n, W)
        bit = torch.arange(32, device=bp.device)
        is_new = ((new[:, :, None].to(torch.int64) >> bit) & 1).bool()
        is_new = is_new.reshape(len(lanes), d)                   # doc order
        docs = bp[:, None] * d + torch.arange(d, device=bp.device)[None]
        slot = self.cnt[lanes, None] + torch.cumsum(is_new, 1) - 1
        keep = is_new & (slot < cfg["max_candidates"])
        rows = lanes[:, None].expand_as(docs)
        self.cand[rows[keep], slot[keep]] = docs[keep]
        self.cnt[lanes] = torch.clamp(self.cnt[lanes] + is_new.sum(1),
                                      max=cfg["max_candidates"])
        new_scores = torch.where(is_new, self.scores[rows, docs], -math.inf)
        self.topn[lanes] = torch.topk(torch.cat([self.topn[lanes], new_scores],
                                                1), cfg["n_top"], 1).values
        self.bp[lanes] += 1

    def run_rule(self, action, rule_set):
        """One agent step's rule execution for the lanes whose action is
        a rule and whose episode is not done."""
        cfg = self.cfg
        allowed, required, du, dv = rule_set
        k = allowed.shape[0]
        is_rule = (action < k) & ~self.done
        a = torch.clamp(action, max=k - 1)
        du_q = torch.where(is_rule, du[a], 0)
        dv_q = torch.where(is_rule, dv[a], 0)
        u0, v0 = self.u.clone(), self.v.clone()
        while True:
            go = ((self.u - u0 < du_q) & (self.v - v0 < dv_q)
                  & (self.bp < cfg["n_blocks"]) & (self.u < cfg["u_budget"])
                  & ~self.done)
            lanes = torch.nonzero(go).flatten()
            if len(lanes) == 0:
                return
            self.scan_block(lanes, allowed[a[lanes]], required[a[lanes]])

    def r_agent(self):
        """Eq. 3: the mean of the top m = min(v, n) scores (at least one)
        over u."""
        n = self.cfg["n_top"]
        m = torch.clamp(self.v, 1, n)
        first = torch.arange(n, device=m.device)[None] < m[:, None]
        take = first & torch.isfinite(self.topn)
        top = torch.where(take, self.topn, 0).sum(1)
        return top / (m.to(self.dtype) * torch.clamp(self.u, min=1).to(self.dtype))


def rollout(cfg, q, u_edges, v_edges, occ, scores, tp, prod_rewards=None,
            explore=None, uniform=None, epsilon=0.0, dtype=torch.float32):
    """The episodes of a batch; returns the episode (final state) and
    the transitions {s, a, r, s2, done, valid}, each (t_max, B)."""
    ep = Episode(cfg, occ, scores, tp, dtype)
    rule_set = rules(cfg, occ.device)
    k = rule_set[0].shape[0]
    a_reset, a_stop = k, k + 1
    qd = q.to(dtype)
    eps = torch.tensor(epsilon, dtype=torch.float32)
    trans = {n: [] for n in ("s", "a", "r", "s2", "done", "valid")}
    s = state_bin(ep.u, ep.v, u_edges, v_edges, dtype)
    for t in range(cfg["t_max"]):
        action = torch.argmax(qd[s], dim=1)
        if explore is not None:
            action = torch.where(uniform[t] < eps.to(uniform.device),
                                 explore[t].to(torch.int64), action)
        done_before, cnt_before = ep.done.clone(), ep.cnt.clone()
        ep.run_rule(action, rule_set)
        ep.bp = torch.where((action == a_reset) & ~done_before, 0, ep.bp)
        ep.done = done_before | (action == a_stop) | (ep.u >= cfg["u_budget"])
        if prod_rewards is None:
            r = ep.r_agent()
        else:
            last = prod_rewards.shape[1] - 1
            r = ep.r_agent() - prod_rewards[:, min(t, last)].to(dtype)
        r = torch.where(ep.cnt == cnt_before,
                        torch.tensor(-cfg["no_progress_penalty"], dtype=dtype,
                                     device=r.device), r)
        r = torch.where(done_before, torch.zeros((), dtype=dtype,
                                                 device=r.device), r)
        s2 = state_bin(ep.u, ep.v, u_edges, v_edges, dtype)
        for name, val in (("s", s), ("a", action), ("r", r), ("s2", s2),
                          ("done", ep.done), ("valid", ~done_before)):
            trans[name].append(val)
        s = s2
    return ep, {n: torch.stack(v) for n, v in trans.items()}


def serve(cfg, q, u_edges, v_edges, occ, scores, tp, dtype=torch.float32,
          rows: int = 64):
    """The greedy policy's candidates, u and candidate counts per query
    (numpy), in blocks of ``rows`` queries."""
    out = []
    for r0 in range(0, occ.shape[0], rows):
        sl = slice(r0, r0 + rows)
        ep, _ = rollout(cfg, q, u_edges, v_edges, occ[sl], scores[sl], tp[sl],
                        dtype=dtype)
        out.append((ep.cand.cpu().numpy(), ep.u.cpu().numpy(),
                    ep.cnt.cpu().numpy()))
    return tuple(np.concatenate(x) for x in zip(*out))


def td_update(cfg, q, trans, dtype=torch.float32):
    """Scatter-mean TD(0): each (state, action) cell's TD errors summed in
    float64 and averaged, Q moved by α times the mean (numpy)."""
    n_act = q.shape[1]
    qd = q.to(dtype)
    s, a, s2 = (trans[n].reshape(-1) for n in ("s", "a", "s2"))
    r = trans["r"].reshape(-1).to(dtype)
    done, valid = trans["done"].reshape(-1), trans["valid"].reshape(-1)
    best_next = torch.where(done, torch.zeros((), dtype=dtype, device=q.device),
                            qd[s2].max(1).values)
    gamma = torch.tensor(cfg["learner"]["gamma"], dtype=dtype)
    td = r + gamma.to(q.device) * best_next - qd[s, a]
    cells = (s * n_act + a)[valid].cpu().numpy()
    sums = np.zeros(q.numel(), dtype=np.float64)
    counts = np.zeros(q.numel(), dtype=np.float64)
    np.add.at(sums, cells, td[valid].to(torch.float64).cpu().numpy())
    np.add.at(counts, cells, 1.0)
    mean = torch.from_numpy(sums / np.maximum(counts, 1.0)).to(dtype)
    alpha = torch.tensor(cfg["learner"]["alpha"], dtype=dtype)
    q_new = qd.cpu() + alpha * mean.reshape(q.shape)
    return q_new.to(torch.float32).to(q.device)


def learn_step(cfg, q, u_edges, v_edges, occ, scores, tp, prod_rewards,
               explore, uniform, dtype=torch.float32):
    """One ε-greedy episode over the batch and its TD update: the new Q
    and the step's metrics (floats), with the mean |r| over the valid
    transitions that the check scales the mean reward by."""
    ep, trans = rollout(cfg, q, u_edges, v_edges, occ, scores, tp,
                        prod_rewards, explore, uniform,
                        cfg["learner"]["epsilon"], dtype)
    q_new = td_update(cfg, q, trans, dtype)
    valid = trans["valid"]
    r = trans["r"].to(torch.float64)
    n_valid = max(int(valid.sum()), 1)
    metrics: Dict[str, float] = {
        "mean_u": float(ep.u.to(torch.float64).mean()),
        "mean_v": float(ep.v.to(torch.float64).mean()),
        "mean_cand": float(ep.cnt.to(torch.float64).mean()),
        "mean_reward": float((r * valid).sum()) / n_valid,
        "q_abs_mean": float(q_new.to(torch.float64).abs().mean()),
    }
    scale = float((r.abs() * valid).sum()) / n_valid
    return q_new, metrics, scale

