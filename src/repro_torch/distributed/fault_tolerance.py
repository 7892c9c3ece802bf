"""Fault-tolerant training driver: checkpoint/restart and failure
injection (the reference's ``distributed/fault_tolerance.py``).

A failure surfaces as a dead step; recovery is restore-from-last-commit
and replay.  The data pipeline is stateless, seeded by step number, so
replaying never double-feeds or skips a batch.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

from .checkpoint import CheckpointManager

__all__ = ["FaultToleranceConfig", "FailureInjector", "run_resilient_loop"]


@dataclasses.dataclass
class FaultToleranceConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    async_save: bool = True
    max_restarts: int = 10


class FailureInjector:
    """Deterministic failure schedule for tests: raises at given steps
    (once each) to simulate preemption / node loss."""

    def __init__(self, fail_at=()):
        self.fail_at = set(fail_at)
        self.fired = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected node failure at step {step}")


def run_resilient_loop(
    state: Any,
    step_fn: Callable[[Any, int], Any],       # (state, step) -> state
    n_steps: int,
    ft: FaultToleranceConfig,
    injector: Optional[FailureInjector] = None,
    on_metrics: Optional[Callable[[int, Any], None]] = None,
) -> Dict[str, Any]:
    """Run ``n_steps`` of ``step_fn`` surviving injected failures.

    Returns {state, restarts, steps_replayed, wall_s}.  ``step_fn`` must
    be a pure function of (state, step), the seeded-by-step contract
    that makes replay exact; it may overwrite ``state``'s tensors in
    place (``CheckpointManager.save`` copies them to the host first)."""
    mgr = CheckpointManager(ft.ckpt_dir, keep=ft.keep, async_save=ft.async_save)
    t0 = time.time()
    restarts = 0
    replayed = 0

    restored, start = mgr.restore(state)
    step = 0
    if restored is not None:
        state, step = restored, start + 1

    while step < n_steps:
        try:
            if injector is not None:
                injector.maybe_fail(step)
            state = step_fn(state, step)
            if on_metrics is not None:
                on_metrics(step, state)
            if step % ft.ckpt_every == 0:
                mgr.save(step, state)
            step += 1
        except RuntimeError as e:
            if "injected" not in str(e) or restarts >= ft.max_restarts:
                raise
            restarts += 1
            mgr.wait()
            restored, last = mgr.restore(state)
            if restored is None:
                state_step = 0
            else:
                state, state_step = restored, last + 1
            replayed += max(0, step - state_step)
            step = state_step if restored is not None else 0

    mgr.save(n_steps - 1, state)
    mgr.wait()
    return {"state": state, "restarts": restarts,
            "steps_replayed": replayed, "wall_s": time.time() - t0}
