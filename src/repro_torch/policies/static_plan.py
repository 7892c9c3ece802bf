"""StaticPlanPolicy — the hand-tuned production baseline as a Policy.

Entry ``t`` of the plan becomes the step-``t`` action, with reset-before
semantics and per-entry Δu/Δv quota overrides.  Past the end of the
plan the policy emits ``a_stop``, so it is safe under any
``t_max >= plan.length``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.match_plan import MatchPlan
from repro_torch.core.rollout import USE_RULE_QUOTA, PolicyAction

from .base import Policy

__all__ = ["StaticPlanPolicy"]


@dataclasses.dataclass
class StaticPlanPolicy(Policy):
    plan: MatchPlan
    n_actions: int                # k_rules + 2 (a_stop = n_actions-1)

    @property
    def horizon(self) -> Optional[int]:
        return self.plan.length

    def act(self, s_bin, state, t: int) -> PolicyAction:
        b, dev = s_bin.shape[0], s_bin.device

        def full(x, dtype):
            return torch.full((b,), x, dtype=dtype, device=dev)

        if t >= self.plan.length:
            q = full(USE_RULE_QUOTA, torch.int32)
            return PolicyAction(full(self.n_actions - 1, torch.int32),
                                full(False, torch.bool), q, q)
        p = self.plan
        return PolicyAction(
            action=p.rule_idx[t].to(torch.int32).expand(b),
            reset_before=p.reset_before[t].expand(b),
            du_quota=p.du_quota[t].to(torch.int32).expand(b),
            dv_quota=p.dv_quota[t].to(torch.int32).expand(b),
        )
