"""Tabular policies over the discretized (u, v) state space (paper §4).

``TabularQPolicy`` is the test-time/serving policy: greedy argmax over
a dense (p, k+2) Q-table.  ``torch.argmax`` takes the first maximum, as
``jnp.argmax`` does, which matters for tables with ties (a zero table
is all ties, ``init_q``'s constant table too).

``EpsilonGreedy`` wraps ANY inner policy with ε-exploration.  torch
cannot reproduce ``jax.random``, so the policy carries its random draws
for every step of the episode as (t_max, B) tensors and reads row
``t``: ``explore`` (the uniform action) and ``uniform`` (taken where it
is below ε).  :meth:`EpsilonGreedy.draw` makes them from an explicit
``torch.Generator``; the parity tests pass in the reference's own draws.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.rollout import USE_RULE_QUOTA, PolicyAction

from .base import Policy

__all__ = ["TabularQPolicy", "EpsilonGreedy"]


@dataclasses.dataclass
class TabularQPolicy(Policy):
    q: torch.Tensor               # (p, n_actions) float32

    @property
    def n_actions(self) -> int:
        return self.q.shape[-1]

    def act(self, s_bin, state, t: int) -> PolicyAction:
        greedy = torch.argmax(self.q[s_bin.long()], dim=-1)
        return PolicyAction.plain(greedy)


@dataclasses.dataclass
class EpsilonGreedy(Policy):
    """ε-greedy exploration wrapper; explored steps take a uniform
    action with the rule library's default quotas and no reset-before."""

    inner: Policy
    epsilon: torch.Tensor         # () float32
    explore: torch.Tensor         # (t_max, B) int32 in [0, n_actions)
    uniform: torch.Tensor         # (t_max, B) float32 in [0, 1)

    def __post_init__(self):
        # A number is filled in on the draws' device: a copy of a host
        # scalar to the card would wait for the stream (a host sync).
        dev = self.uniform.device
        self.epsilon = (self.epsilon.to(dev, torch.float32)
                        if isinstance(self.epsilon, torch.Tensor) else
                        torch.full((), self.epsilon, dtype=torch.float32,
                                   device=dev))

    @classmethod
    def draw(cls, generator: torch.Generator, t_max: int, batch: int,
             n_actions: int, epsilon, inner: Policy) -> "EpsilonGreedy":
        """Draw an episode's explore actions and uniforms from
        ``generator``, on its device."""
        dev = generator.device
        explore = torch.randint(0, n_actions, (t_max, batch),
                                generator=generator, device=dev,
                                dtype=torch.int32)
        uniform = torch.rand((t_max, batch), generator=generator, device=dev)
        return cls(inner, epsilon, explore, uniform)

    @property
    def n_actions(self) -> int:
        return self.inner.n_actions

    @property
    def horizon(self):
        return self.inner.horizon

    def act(self, s_bin, state, t: int) -> PolicyAction:
        base = self.inner.act(s_bin, state, t)
        take = self.uniform[t] < self.epsilon
        neutral = torch.full_like(base.action, USE_RULE_QUOTA)
        return PolicyAction(
            action=torch.where(take, self.explore[t], base.action),
            reset_before=torch.where(take, False, base.reset_before),
            du_quota=torch.where(take, neutral, base.du_quota),
            dv_quota=torch.where(take, neutral, base.dv_quota),
        )
