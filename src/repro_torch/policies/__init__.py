"""Unified Policy API: static production plans, learned tabular Q
policies and the ε-greedy exploration wrapper run through the one
``repro_torch.core.rollout.unified_rollout`` loop; ``PolicyStore``
versions immutable snapshots for serve-while-training."""
from repro_torch.core.rollout import PolicyAction, USE_RULE_QUOTA

from .base import Policy, structure_key
from .static_plan import StaticPlanPolicy
from .store import PolicySnapshot, PolicyStore, StalePolicyError
from .tabular import EpsilonGreedy, TabularQPolicy

__all__ = ["EpsilonGreedy", "Policy", "PolicyAction", "PolicySnapshot",
           "PolicyStore", "StalePolicyError", "StaticPlanPolicy",
           "TabularQPolicy", "USE_RULE_QUOTA", "structure_key"]
