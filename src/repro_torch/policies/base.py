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

from typing import Optional

from repro_torch.core.rollout import PolicyAction

__all__ = ["Policy"]


class Policy:
    """Base class for rollout policies."""

    def act(self, s_bin, state, t: int) -> PolicyAction:
        raise NotImplementedError

    @property
    def horizon(self) -> Optional[int]:
        """Natural episode length, or None to use the caller's t_max."""
        return None
