"""The Policy protocol — anything that can drive ``unified_rollout``.

Required surface::

    act(s_bin, state, t) -> PolicyAction   # batched
    n_actions: int                         # k_rules + 2
    horizon: Optional[int]                 # natural episode length

``act`` receives the discretized state index ``s_bin`` (B,), the full
batched :class:`EnvState` and the step counter ``t`` (a Python int).
The reference's ``act`` also takes a PRNG key; here no policy draws
random numbers inside ``act``: ``EpsilonGreedy`` carries its draws for
every step and reads row ``t``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.rollout import PolicyAction

__all__ = ["Policy", "structure_key"]


class Policy:
    """Base class for rollout policies."""

    def act(self, s_bin, state, t: int) -> PolicyAction:
        raise NotImplementedError

    @property
    def horizon(self) -> Optional[int]:
        """Natural episode length, or None to use the caller's t_max."""
        return None


def structure_key(policy: Policy) -> tuple:
    """What the serving executor keys a prepared serve step on, as the
    reference keys its compiled executables on a policy's pytree
    structure: the class, then field by field, recursively through
    dataclasses (a ``StaticPlanPolicy``'s ``MatchPlan``), each tensor's
    shape and dtype and each plain value itself.  A ``TabularQPolicy``
    and a ``StaticPlanPolicy`` differ, and so do plans of different
    lengths; tables of equal shape with other values do not."""
    def walk(x):
        if isinstance(x, torch.Tensor):
            return (tuple(x.shape), str(x.dtype))
        if dataclasses.is_dataclass(x):
            return (type(x),) + tuple((f.name, walk(getattr(x, f.name)))
                                      for f in dataclasses.fields(x))
        if x is None or isinstance(x, (bool, int, float, str)):
            return x
        raise TypeError(f"no structure key for a {type(x).__name__} "
                        f"inside a {type(policy).__name__}")

    if not isinstance(policy, Policy):
        raise TypeError(f"expected a repro_torch.policies.Policy, got "
                        f"{type(policy).__name__}")
    return walk(policy)
