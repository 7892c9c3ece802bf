"""Faults planted under the timed path, to show that the check rejects
them: each wraps the program's cell function.  ``SERVE`` and ``LEARN``
map a fault's name to its wrapper, and ``serve_control``/``learn_control``
put the plain reference in a lower precision in the program's place.
None runs in a benchmark run, only in ``calibrate.py`` on the card and in
the CPU tests."""
from __future__ import annotations

import torch

ALTER = 0.01        # what an altered Q cell gains: a fifth of the table's scale


def serve_unchanged(fn):
    """Every query's state returned as it started: no candidate, u 0."""
    def broken(q, bins, occ, scores, tp):
        cand, u, cnt = fn(q, bins, occ, scores, tp)
        return torch.full_like(cand, -1), torch.zeros_like(u), torch.zeros_like(cnt)
    return broken


def serve_half(fn):
    """Half of the batch left out: the first half served, the rest empty."""
    def broken(q, bins, occ, scores, tp):
        h = occ.shape[0] // 2
        cand, u, cnt = fn(q, bins, occ[:h], scores[:h], tp[:h])
        pad = occ.shape[0] - h
        return (torch.cat([cand, torch.full((pad, cand.shape[1]), -1,
                                            dtype=cand.dtype, device=cand.device)]),
                torch.cat([u, torch.zeros(pad, dtype=u.dtype, device=u.device)]),
                torch.cat([cnt, torch.zeros(pad, dtype=cnt.dtype,
                                            device=cnt.device)]))
    return broken


def serve_altered(fn):
    """One answer altered where it is produced: the first query's first
    candidate slot."""
    def broken(q, bins, occ, scores, tp):
        cand, u, cnt = fn(q, bins, occ, scores, tp)
        cand = cand.clone()
        cand[0, 0] ^= 1
        return cand, u, cnt
    return broken


def serve_repeated(fn):
    """Every call answered with the first call's answers, as a cache of
    answers would."""
    first = []

    def broken(q, bins, occ, scores, tp):
        if not first:
            first.append(fn(q, bins, occ, scores, tp))
        return first[0]
    return broken


def learn_unchanged(fn):
    """A step that returns its Q unchanged."""
    def broken(q, *args):
        _, metrics = fn(q, *args)
        return q, metrics
    return broken


def learn_half(fn):
    """Half of the batch left out: the step over the first half's
    episodes, the TD means over those."""
    def broken(q, bins, occ, scores, tp, prod_r, draws):
        h = occ.shape[0] // 2
        explore, uniform = draws
        return fn(q, bins, occ[:h], scores[:h], tp[:h], prod_r[:h],
                  (explore[:, :h], uniform[:, :h]))
    return broken


def learn_altered(fn):
    """One answer altered where it is produced: a cell of the new Q."""
    def broken(q, *args):
        q_new, metrics = fn(q, *args)
        q_new = q_new.clone()
        q_new[0, 0] += ALTER
        return q_new, metrics
    return broken


SERVE = {"unchanged": serve_unchanged, "half_batch": serve_half,
         "altered": serve_altered, "repeated": serve_repeated}
LEARN = {"unchanged": learn_unchanged, "half_batch": learn_half,
         "altered": learn_altered}


def serve_control(reference, cfg, dtype=torch.bfloat16):
    """The control: the plain reference in ``dtype`` in the program's place."""
    def wrap(fn):
        def control(q, bins, occ, scores, tp):
            ep, _ = reference.rollout(cfg, q, bins.u_edges, bins.v_edges, occ,
                                      scores, tp, dtype=dtype)
            return (ep.cand.to(torch.int32), ep.u.to(torch.int32),
                    ep.cnt.to(torch.int32))
        return control
    return wrap


def learn_control(reference, cfg, dtype=torch.bfloat16):
    """The control: the plain reference in ``dtype`` in the program's place."""
    def wrap(fn):
        def control(q, bins, occ, scores, tp, prod_r, draws):
            q_new, metrics, _ = reference.learn_step(
                cfg, q, bins.u_edges, bins.v_edges, occ, scores, tp, prod_r,
                *draws, dtype=dtype)
            return q_new, {k: torch.tensor(v) for k, v in metrics.items()}
        return control
    return wrap
