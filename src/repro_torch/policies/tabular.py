"""TabularQPolicy — greedy argmax over a dense (p, k+2) Q-table over the
discretized (u, v) state space (paper §4); the serving policy.
``torch.argmax`` takes the first maximum, as ``jnp.argmax`` does, which
matters for tables with ties (a zero table is all ties)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.rollout import PolicyAction

from .base import Policy

__all__ = ["TabularQPolicy"]


@dataclasses.dataclass
class TabularQPolicy(Policy):
    q: torch.Tensor               # (p, n_actions) float32

    def act(self, s_bin, state, t: int) -> PolicyAction:
        greedy = torch.argmax(self.q[s_bin.long()], dim=-1)
        return PolicyAction.plain(greedy)
