"""Table-based Q-learning for dynamic match planning (paper §4).

Q is a dense (p, k+2) table.  Episodes run through the one
``repro_torch.core.rollout.unified_rollout`` loop: ε-greedy behaviour
during training (``EpsilonGreedy(TabularQPolicy(q), ε, ...)``) and
greedy action selection at test time (``TabularQPolicy``).  TD(0)
updates are batched: transitions landing in the same (state, action)
cell are averaged (scatter-mean) before the learning-rate step.

The scatter-mean's sums are pinned in order: the invalid transitions
are dropped (they add 0 to a sum and to a count), the rest are sorted by
cell and, within a cell, by TD value, and each cell's TD errors are
summed in float64 along a row of their own, then rounded to float32.
No atomics and no input order decide the order of a float sum, so one
step run twice gives a bit-equal table on the card, and any permutation
of the transitions gives the same table.
The reference sums in float32 in transition order (XLA's scatter-add):
the two agree within float32 rounding, not bit for bit.

``train_batch`` takes a scan ``backend`` (core/scan_backends.py), so
training episodes run the chunked block-scan kernel, not just serving.

Under an active tracer (``obs.trace.tracing``) a step is a
``train_batch`` span holding the episode's ``rollout``, the
``td_update`` (with a ``sync`` span for each of its four device→host
reads: the two selections of the valid transitions, the cells'
``unique_consecutive`` and the widest cell) and the ``metrics``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.cost import note
from repro_torch.obs.trace import host_sync, scope

from .rollout import unified_rollout

__all__ = ["QConfig", "init_q", "linear_epsilon", "td_update", "train_batch"]

# An episode's ε-greedy draws: a generator to draw them from, or the
# (explore, uniform) pair of (t_max, B) tensors itself.
Draws = Union[torch.Generator, Tuple[torch.Tensor, torch.Tensor]]


def linear_epsilon(it: int, iters: int, eps_start: float,
                   eps_end: float) -> float:
    """The linear ε anneal of the offline trainer
    (``RetrievalSystem.train_policy``)."""
    return eps_start + (eps_end - eps_start) * it / max(iters - 1, 1)


@dataclasses.dataclass(frozen=True)
class QConfig:
    p: int                    # number of state bins
    n_actions: int            # k_rules + 2
    alpha: float = 0.25       # TD learning rate
    gamma: float = 0.98       # discount (paper: 0 < γ ≤ 1)
    t_max: int = 8            # episode cap (paper: max execution time)
    optimistic_init: float = 0.05


def init_q(qcfg: QConfig, device=None) -> torch.Tensor:
    """Optimistic-ish init encourages early exploration of all rules;
    on ``device`` (cuda unless asked)."""
    return torch.full((qcfg.p, qcfg.n_actions), qcfg.optimistic_init,
                      dtype=torch.float32, device=resolve_device(device))


def _epsilon_policy(qcfg: QConfig, q, epsilon, draws: Draws, batch: int):
    from repro_torch.policies import EpsilonGreedy, TabularQPolicy

    inner = TabularQPolicy(q)
    if isinstance(draws, torch.Generator):
        return EpsilonGreedy.draw(draws, qcfg.t_max, batch, qcfg.n_actions,
                                  epsilon, inner)
    explore, uniform = draws
    return EpsilonGreedy(inner, epsilon, explore, uniform)


def _epsilon_rollout(cfg, qcfg, ruleset, bins, q, occ, scores, term_present,
                     prod_rewards, epsilon, draws: Draws,
                     backend="reference"):
    """ε-greedy training episode through the unified loop; returns
    (final_state, transitions)."""
    policy = _epsilon_policy(qcfg, q, epsilon, draws, occ.shape[0])
    res = unified_rollout(cfg, ruleset, bins, policy, qcfg.t_max, occ,
                          scores, term_present, prod_rewards,
                          backend=backend)
    return res.final_state, res.transitions


def _cell_sums(flat: torch.Tensor, td: torch.Tensor, n_cells: int):
    """Per-cell sums of ``td`` over the cells ``flat``, in a fixed order:
    sorted by cell and then by value, one row of float64 per cell, a row
    sum."""
    n = flat.shape[0]
    dev = flat.device
    sums = torch.zeros(n_cells, dtype=torch.float32, device=dev)
    if n == 0:
        return sums
    by_value = torch.argsort(td, stable=True)
    order = by_value[torch.argsort(flat[by_value], stable=True)]
    if dev.type == "meta":
        # the cells depend on the data: a dry run takes each transition
        # as a cell of its own
        cells, counts, width = flat[order], torch.ones_like(flat), 1
    else:
        with host_sync("unique_cells"):
            cells, counts = torch.unique_consecutive(flat[order],
                                                     return_counts=True)
        with host_sync("cell_width"):
            width = int(counts.max())
    starts = torch.cumsum(counts, 0) - counts
    seg = torch.repeat_interleave(
        torch.arange(cells.shape[0], device=dev), counts, output_size=n)
    pos = torch.arange(n, device=dev) - starts[seg]
    rows = torch.zeros((cells.shape[0], width), dtype=torch.float64, device=dev)
    rows[seg, pos] = td[order].to(torch.float64)
    sums[cells] = rows.sum(dim=1).to(torch.float32)
    return sums


def td_update(qcfg: QConfig, q: torch.Tensor, transitions: dict) -> torch.Tensor:
    """Scatter-mean TD(0) over the flattened (state, action) cells."""
    with scope("td_update"):
        s = transitions["s"].reshape(-1).long()
        a = transitions["a"].reshape(-1).long()
        r = transitions["r"].reshape(-1)
        s2 = transitions["s2"].reshape(-1).long()
        done = transitions["done"].reshape(-1)
        valid = transitions["valid"].reshape(-1)

        target = r + qcfg.gamma * torch.where(done, 0.0, q[s2].amax(dim=-1))
        td = target - q[s, a]

        flat = s * qcfg.n_actions + a
        n_cells = qcfg.p * qcfg.n_actions
        if flat.device.type == "meta":
            note("td_update: data-dependent valid transitions and cells; "
                 "every transition counted valid and a cell of its own")
            sums = _cell_sums(flat, td, n_cells)
        else:
            with host_sync("valid_cells"):
                flat_valid = flat[valid]
            with host_sync("valid_td"):
                td_valid = td[valid]
            sums = _cell_sums(flat_valid, td_valid, n_cells)
        # Counts of 0/1 terms are exact in float32 in any order.
        counts = torch.zeros(n_cells, dtype=torch.float32, device=q.device)
        counts.index_add_(0, flat, valid.to(torch.float32))
        mean_td = sums / torch.clamp(counts, min=1.0)
        return q + qcfg.alpha * mean_td.reshape(qcfg.p, qcfg.n_actions)


def train_batch(cfg, qcfg: QConfig, ruleset, bins, q, occ, scores,
                term_present, prod_rewards, epsilon, draws: Draws, *,
                backend="reference"):
    """One ε-greedy episode over the batch and its TD update; returns
    (new q, metrics of 0-dim float32 tensors)."""
    with scope("train_batch", batch=occ.shape[0]):
        final_state, transitions = _epsilon_rollout(
            cfg, qcfg, ruleset, bins, q, occ, scores, term_present,
            prod_rewards, epsilon, draws, backend)
        q_new = td_update(qcfg, q, transitions)
        with scope("metrics"):
            valid = transitions["valid"]
            metrics = {
                "mean_u": final_state.u.to(torch.float32).mean(),
                "mean_v": final_state.v.to(torch.float32).mean(),
                "mean_cand": final_state.cand_cnt.to(torch.float32).mean(),
                "mean_reward": torch.sum(transitions["r"] * valid)
                / torch.clamp(valid.sum(), min=1),
                "q_abs_mean": q_new.abs().mean(),
            }
    return q_new, metrics
