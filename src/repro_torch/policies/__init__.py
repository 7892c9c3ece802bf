"""Unified Policy API: static production plans and greedy tabular Q
policies run through the one ``repro_torch.core.rollout.unified_rollout``
loop.  (ε-greedy exploration and the versioned policy store are not
ported yet.)"""
from repro_torch.core.rollout import PolicyAction, USE_RULE_QUOTA

from .base import Policy
from .static_plan import StaticPlanPolicy
from .tabular import TabularQPolicy

__all__ = ["Policy", "PolicyAction", "StaticPlanPolicy", "TabularQPolicy",
           "USE_RULE_QUOTA"]
