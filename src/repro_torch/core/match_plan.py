"""Static production match plans — the hand-crafted baseline (paper §3).

A plan is a fixed sequence of entries; each entry names a match rule,
optional quota overrides, and whether to reset the scan pointer before
executing.  Executing a plan yields the baseline trajectory used for
the production candidate sets / NCG / u metrics, the (u, v) point cloud
that fits the state discretization, and the per-step production
rewards of Eq. 4.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from .match_rules import RuleSet

__all__ = ["MatchPlan", "make_plan", "production_plans", "plan_rollout"]


@dataclasses.dataclass
class MatchPlan:
    rule_idx: torch.Tensor      # (L,) int32
    reset_before: torch.Tensor  # (L,) bool
    du_quota: torch.Tensor      # (L,) int32  (per-entry override)
    dv_quota: torch.Tensor      # (L,) int32

    @property
    def length(self) -> int:
        return self.rule_idx.shape[0]

    def prefix(self, length: int) -> "MatchPlan":
        """The first ``length`` entries as a standalone plan — the
        shallow degraded-service fallback: its u is bounded by the
        prefix's summed Δu quotas (each rule execution stops at its
        quota), so serving it under pressure has a known worst case."""
        length = max(1, min(int(length), self.length))
        return MatchPlan(
            rule_idx=self.rule_idx[:length],
            reset_before=self.reset_before[:length],
            du_quota=self.du_quota[:length],
            dv_quota=self.dv_quota[:length],
        )

    def u_cap(self, per_entry_overshoot: int = 0) -> int:
        """Hard upper bound on u for one execution of this plan: the
        summed per-entry Δu quotas, plus the rule loop's worst-case
        quota overshoot per entry (it checks the quota between blocks,
        so the final block's planes — at most one block's worth, i.e.
        terms × fields — land past the quota)."""
        return int(self.du_quota.sum()) + self.length * per_entry_overshoot


def make_plan(ruleset: RuleSet,
              entries: Sequence[Tuple[int, bool]]) -> MatchPlan:
    """A plan of (rule index, reset-before) entries with the rules' own
    quotas."""
    dev = ruleset.du_quota.device
    rule_idx = torch.tensor([e[0] for e in entries], dtype=torch.int32,
                            device=dev)
    return MatchPlan(
        rule_idx=rule_idx,
        reset_before=torch.tensor([e[1] for e in entries], dtype=torch.bool,
                                  device=dev),
        du_quota=ruleset.du_quota[rule_idx.long()].clone(),
        dv_quota=ruleset.dv_quota[rule_idx.long()].clone(),
    )


def production_plans(ruleset: RuleSet) -> dict:
    """Hand-crafted per-category plans (the 'tuned for years' baseline).

    CAT1 — rare multi-term: deep all-field pass, topical B|T, body
    backstop, relaxed conjunction, then a reset re-scan of the head.
    CAT2 — navigational: U|T, A|T, U|T again (legacy double pass),
    topical B|T, then a deep all-field sweep.
    """
    return {
        "CAT1": make_plan(ruleset, [(0, False), (3, False), (5, False),
                                    (4, False), (0, True)]),
        "CAT2": make_plan(ruleset, [(1, False), (2, False), (1, True),
                                    (3, False), (0, False)]),
    }


def plan_rollout(cfg, ruleset, plan, occ, scores, term_present,
                 backend="reference"):
    """Batched plan execution through the unified rollout.  Returns
    (final_state, trajectory with (B, L) leaves)."""
    # Local imports: repro_torch.policies wraps MatchPlan.
    from repro_torch.core.rollout import unified_rollout
    from repro_torch.policies import StaticPlanPolicy

    policy = StaticPlanPolicy(plan, cfg.n_actions)
    res = unified_rollout(cfg, ruleset, None, policy, plan.length, occ,
                          scores, term_present, backend=backend)
    return res.final_state, {k: v.T for k, v in res.trajectory.items()}
