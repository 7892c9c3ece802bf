"""Reward functions — Eq. 3 and Eq. 4 of the paper, batched.

    r_agent(s_t, a_t) = ( Σ_{i=1..m} g(d_i) ) / ( m · u_{t+1} ),
                        m = min(v_{t+1}, n)

The final reward subtracts the production plan's reward at the same
step (Eq. 4); an action that selects no new documents earns a small
negative reward instead.
"""
from __future__ import annotations

import torch

from .environment import EnvConfig, EnvState

__all__ = ["r_agent", "step_reward"]


def r_agent(cfg: EnvConfig, state: EnvState) -> torch.Tensor:
    """Eq. 3 evaluated at a batched state → (B,) float32."""
    m = torch.clamp(torch.clamp(state.v, max=cfg.n_top), 1, cfg.n_top)
    idx = torch.arange(cfg.n_top, device=state.topn.device)
    keep = (idx[None, :] < m[:, None]) & torch.isfinite(state.topn)
    topm = torch.where(keep, state.topn, 0.0)
    u = torch.clamp(state.u, min=1).to(torch.float32)
    return topm.sum(dim=1) / (m.to(torch.float32) * u)


def step_reward(cfg: EnvConfig, prev: EnvState, new: EnvState,
                r_production_t: torch.Tensor) -> torch.Tensor:
    """Eq. 4 with the no-progress penalty, (B,) float32."""
    no_new = new.cand_cnt == prev.cand_cnt
    r = torch.where(no_new, -cfg.no_progress_penalty,
                    r_agent(cfg, new) - r_production_t)
    # Terminal no-op steps (already done) earn exactly zero.
    return torch.where(prev.done, 0.0, r)
