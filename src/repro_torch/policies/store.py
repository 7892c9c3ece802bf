"""Versioned policy snapshots: publish / snapshot / subscribe.

Serve-while-training needs one primitive: a trainer publishes
immutable policy snapshots with monotonically increasing version ids,
and serving replicas pin a snapshot and periodically refresh, with a *staleness bound* — a replica
more than ``staleness_bound`` versions behind the head must refuse to
serve (``StalePolicyError``) rather than silently answer with an
ancient policy.

The version/staleness/subscribe machinery itself lives in
`repro_torch.core.versioned.VersionedStore` (the port's copy of the
reference's, pure Python), and this module keeps the
policy-specific payload: snapshot validation, the fallback carry-
forward rule, and :class:`PolicySnapshot` immutability (the
category→policy dict is copied on publish, so a reader can never
observe a torn snapshot).
"""
from __future__ import annotations

from dataclasses import dataclass
from types import MappingProxyType
from typing import Dict, Mapping, Optional

from repro_torch.core.versioned import StaleVersionError, VersionedStore

from .base import Policy

__all__ = ["PolicySnapshot", "PolicyStore", "StalePolicyError"]


class StalePolicyError(StaleVersionError):
    """A consumer's pinned snapshot is older than the staleness bound."""


_EMPTY: Mapping[int, Policy] = MappingProxyType({})


@dataclass(frozen=True)
class PolicySnapshot:
    version: int                        # monotonically increasing, from 1
    policies: Mapping[int, Policy]      # category -> Policy (read-only)
    # category -> degraded-service fallback (typically a truncated
    # StaticPlanPolicy with bounded u).  Published and hot-swapped
    # TOGETHER with the live set: a replica can never pair a new live
    # policy with a stale fallback or vice versa.
    fallbacks: Mapping[int, Policy] = _EMPTY


def _validate_policies(policies: Dict[int, Policy], role: str = "policies",
                       allow_empty: bool = False) -> None:
    if not isinstance(policies, dict) or (not policies and not allow_empty):
        raise TypeError(
            f"PolicyStore.publish expects a non-empty {{category: Policy}} "
            f"dict for {role}, got {type(policies).__name__}")
    for cat, pol in policies.items():
        if not isinstance(pol, Policy):
            raise TypeError(
                f"category {cat} ({role}): expected a repro_torch.policies.Policy, "
                f"got {type(pol).__name__}. Raw Q-table arrays are no longer "
                "accepted — wrap them with TabularQPolicy(q) (or a "
                "MatchPlan with StaticPlanPolicy(plan, n_actions)).")


class PolicyStore(VersionedStore):
    stale_error = StalePolicyError
    artifact = "policy snapshot"

    # ------------------------------------------------------------ publish
    def publish(self, policies: Dict[int, Policy],
                fallbacks: Optional[Dict[int, Policy]] = None,
                version: Optional[int] = None) -> int:
        """Install a new snapshot; returns its (strictly increasing)
        version id and notifies subscribers.

        ``fallbacks`` is the degraded-service policy set (category ->
        cheap bounded-u Policy, e.g. a truncated StaticPlanPolicy).
        When omitted, the previous snapshot's fallbacks are carried
        forward — live policies and their fallbacks always travel in
        the same snapshot, so replicas hot-swap them atomically.

        ``version`` pins an explicit version id (must exceed the head):
        the process-cell relay republishes the producer's snapshots into
        worker-local stores under the producer's own numbering, so
        version-lag accounting means the same thing on both sides.
        """
        _validate_policies(policies)
        if fallbacks is not None:
            _validate_policies(fallbacks, role="fallbacks", allow_empty=True)
        frozen = MappingProxyType(dict(policies))
        fb_frozen = (MappingProxyType(dict(fallbacks))
                     if fallbacks is not None else None)

        def build(prev: Optional[PolicySnapshot], ver: int) -> PolicySnapshot:
            fb = fb_frozen if fb_frozen is not None else (
                prev.fallbacks if prev else _EMPTY)
            return PolicySnapshot(ver, frozen, fb)

        return self._publish_snapshot(build, version=version)
