"""Service levels: the graceful-degradation ladder's vocabulary.

The paper prices query evaluation in u (index blocks accessed), and the
cluster's admission ledger reserves u per query.  Under pressure the
honest alternative to queueing into a latency collapse is not a binary
admit/shed, but a *ladder* of progressively cheaper ways to answer:

    FULL        the live learned policy, full horizon (normal serving)
    SHALLOW     the snapshot's fallback policy — a truncated static
                plan whose u is bounded by the plan's summed Δu quotas
    CACHED_ONLY answer only if some replica's result cache already
                holds the key (costs ~zero u); otherwise shed
    SHED        explicit non-response (the pressure valve of last resort)

Levels are ordered by degradation: a cached result produced at level L
may answer a request admitted at any level >= L (a FULL result serves
everyone; a SHALLOW result must never silently answer a FULL request).
``EXECUTED_LEVELS`` are the two that run a rollout and therefore carry
their own (category, df-decile) u-estimate rows and their own entry in
the executor's serve-step key.
"""
from __future__ import annotations

import enum

__all__ = ["ServiceLevel", "EXECUTED_LEVELS"]


class ServiceLevel(enum.IntEnum):
    FULL = 0
    SHALLOW = 1
    CACHED_ONLY = 2
    SHED = 3

    @property
    def degraded(self) -> bool:
        return self is not ServiceLevel.FULL


#: Levels that execute a rollout (and so have a learnable u cost).
EXECUTED_LEVELS = (ServiceLevel.FULL, ServiceLevel.SHALLOW)
