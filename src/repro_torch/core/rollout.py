"""The ONE rollout loop (Unified Policy API).

Static production match plans, ε-greedy Q-learning episodes, greedy
tabular Q policies and serving rollouts are one computation: a loop over agent steps where each step
asks a *policy* for an action and advances the batched match
environment.  The reference runs it as a ``lax.scan``; here it is an
eager Python loop over ``t_max`` steps.  HOW each rule execution
streams the index is a scan backend (``core/scan_backends.py``):
``"reference"`` or ``"block_scan"``, bit-identical.

``unified_rollout`` returns the transition set ``{s, a, r, s2, done,
valid}`` and the per-step trajectory ``{u, v, topn_sum, cand_cnt}``,
each leaf stacked to (t_max, B).

Under an active tracer (``obs.trace.tracing``) a rollout is a
``rollout`` span holding a ``step`` span per agent step (its ``act``,
the backend's ``rule`` and the ``reward`` bookkeeping) and the final
``stack``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Union

import torch

from repro_torch.obs.trace import scope

from .environment import EnvConfig, EnvState, env_reset
from .match_rules import RuleSet
from .reward import step_reward
from .scan_backends import ScanBackend, get_scan_backend
from .state_bins import StateBins, bin_index

__all__ = ["USE_RULE_QUOTA", "PolicyAction", "RolloutResult",
           "policy_env_step", "unified_rollout"]

# Sentinel quota: "use the rule library's own Δu/Δv stopping condition".
USE_RULE_QUOTA = -1


class PolicyAction(NamedTuple):
    """Structured per-query action emitted by a Policy (all (B,) tensors)."""

    action: torch.Tensor        # int32 in [0, k+1]: rule idx, a_reset, a_stop
    reset_before: torch.Tensor  # bool — rewind block_ptr before executing
    du_quota: torch.Tensor      # int32 — Δu override, USE_RULE_QUOTA = default
    dv_quota: torch.Tensor      # int32 — Δv override, USE_RULE_QUOTA = default

    @staticmethod
    def plain(action: torch.Tensor) -> "PolicyAction":
        """Wrap a bare action index with neutral extras."""
        a = action.to(torch.int32)
        q = torch.full_like(a, USE_RULE_QUOTA)
        return PolicyAction(a, torch.zeros_like(a, dtype=torch.bool), q, q)


class RolloutResult(NamedTuple):
    final_state: EnvState
    transitions: Dict[str, torch.Tensor]   # {s, a, r, s2, done, valid}: (T, B)
    trajectory: Dict[str, torch.Tensor]    # {u, v, topn_sum, cand_cnt}: (T, B)


def policy_env_step(cfg: EnvConfig, ruleset: RuleSet, occ, scores,
                    term_present, state: EnvState, pa: PolicyAction,
                    backend: Union[str, ScanBackend] = "reference") -> EnvState:
    """One agent step under a structured action (batched over queries).
    Reset-before is applied unconditionally (plan semantics)."""
    scan = get_scan_backend(backend) if isinstance(backend, str) else backend
    action = pa.action
    is_rule = action < cfg.k_rules
    is_reset = action == cfg.a_reset
    is_stop = action == cfg.a_stop

    bp = torch.where(pa.reset_before, 0, state.block_ptr)
    state = dataclasses.replace(state, block_ptr=bp)

    rule_idx = torch.clamp(action, max=cfg.k_rules - 1).long()
    allowed, required, du_q, dv_q = ruleset.gather(rule_idx)
    du_q = torch.where(pa.du_quota >= 0, pa.du_quota, du_q)
    dv_q = torch.where(pa.dv_quota >= 0, pa.dv_quota, dv_q)
    # Zero quotas make the inner loop a no-op for reset/stop/done.
    live = is_rule & ~state.done
    du_q = torch.where(live, du_q, 0)
    dv_q = torch.where(live, dv_q, 0)

    nstate = scan.run_rule(cfg, occ, scores, term_present, state,
                           allowed, required, du_q, dv_q)

    block_ptr = torch.where(is_reset & ~state.done, 0, nstate.block_ptr)
    done = state.done | is_stop | (nstate.u >= cfg.u_budget)
    return dataclasses.replace(nstate, block_ptr=block_ptr, done=done)


def unified_rollout(
    cfg: EnvConfig,
    ruleset: RuleSet,
    bins: Optional[StateBins],
    policy,                        # repro_torch.policies.Policy
    t_max: int,
    occ: torch.Tensor,             # (B, n_blocks, T, F, W) int32
    scores: torch.Tensor,          # (B, n_pad) float32
    term_present: torch.Tensor,    # (B, T) bool
    prod_rewards: Optional[torch.Tensor] = None,  # (B, Lp) Eq. 4 subtrahend
    *,
    backend: Union[str, ScanBackend] = "reference",
) -> RolloutResult:
    """Run ``policy`` for ``t_max`` steps over a query batch.  The
    recorded reward at step t is Eq. 4 against
    ``prod_rewards[:, min(t, Lp - 1)]``, the production plan's reward at
    that step (``Lp`` is the plan's length); without ``prod_rewards``,
    against 0, as in the reference."""
    batch, dev = occ.shape[0], occ.device
    scan = get_scan_backend(backend) if isinstance(backend, str) else backend
    with scope("rollout", batch=batch, t_max=t_max, backend=scan.name):
        state = env_reset(cfg, batch, dev)

        def state_bin(s: EnvState) -> torch.Tensor:
            if bins is None:
                return torch.zeros(batch, dtype=torch.int32, device=dev)
            return bin_index(bins, s.u, s.v)

        trans = {k: [] for k in ("s", "a", "r", "s2", "done", "valid")}
        traj = {k: [] for k in ("u", "v", "topn_sum", "cand_cnt")}
        s_bin = state_bin(state)
        for t in range(t_max):
            with scope("step", t=t):
                with scope("act"):
                    pa = policy.act(s_bin, state, t)
                new_state = policy_env_step(cfg, ruleset, occ, scores,
                                            term_present, state, pa, scan)
                with scope("reward"):
                    r_prod_t = (0.0 if prod_rewards is None else prod_rewards[
                        :, min(t, prod_rewards.shape[1] - 1)])
                    r = step_reward(cfg, state, new_state, r_prod_t)
                    s2_bin = state_bin(new_state)
                    for k, val in (("s", s_bin), ("a", pa.action), ("r", r),
                                   ("s2", s2_bin), ("done", new_state.done),
                                   ("valid", ~state.done)):
                        trans[k].append(val)
                    topn = new_state.topn
                    topn_sum = torch.where(torch.isfinite(topn), topn,
                                           0.0).sum(dim=-1)
                    for k, val in (("u", new_state.u), ("v", new_state.v),
                                   ("topn_sum", topn_sum),
                                   ("cand_cnt", new_state.cand_cnt)):
                        traj[k].append(val)
            state, s_bin = new_state, s2_bin
        with scope("stack"):
            return RolloutResult(
                state,
                {k: torch.stack(v) for k, v in trans.items()},
                {k: torch.stack(v) for k, v in traj.items()},
            )
