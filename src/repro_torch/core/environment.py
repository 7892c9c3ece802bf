"""The candidate-generation RL environment (paper §3–4).

One environment lane scans ONE index shard for ONE query.  A step
executes a single match rule until its stopping condition (Δu / Δv
quota) fires.  An :class:`EnvState` carries a leading query-batch axis
(the JAX reference vmaps a single-query state; the port writes the
batch out).  The reference's single-step API is here too:
``execute_rule`` and ``env_step`` take ONE query's tensors, with no
batch axis, and ``batched_env_step`` a batch; all three run on a scan
backend (``core/scan_backends.py``), ``"block_scan"`` by default.

State per query:
    block_ptr  next block to scan
    u          cumulative (term,field)-plane block reads  (paper's u)
    v          cumulative term matches among inspected docs (paper's v)
    matched    bitmap of docs already selected (int32 words, same bits
               as the reference's uint32)
    cand       fixed-K candidate buffer (doc ids, -1 pad), static-rank order
    cand_cnt   number of valid candidates
    topn       running top-n L1 scores of selected docs (for Eq. 3)
    done       terminal flag
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional, Union

import torch

from repro_torch.device import resolve_device
from repro_torch.index.blocks import WORD_BITS

if TYPE_CHECKING:
    from .scan_backends import ScanBackend

__all__ = ["EnvConfig", "EnvState", "env_reset", "env_step", "execute_rule",
           "batched_env_step"]


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    n_blocks: int                 # blocks in this index shard
    block_docs: int               # docs per block
    k_rules: int                  # rule library size; actions k=reset, k+1=stop
    max_candidates: int = 512     # K
    n_top: int = 5                # paper's n (reward top-n)
    u_budget: int = 4096          # hard episode budget on u
    no_progress_penalty: float = 0.01

    @property
    def words_per_block(self) -> int:
        return self.block_docs // WORD_BITS

    @property
    def n_words_total(self) -> int:
        return self.n_blocks * self.words_per_block

    @property
    def a_reset(self) -> int:
        return self.k_rules

    @property
    def a_stop(self) -> int:
        return self.k_rules + 1

    @property
    def n_actions(self) -> int:
        return self.k_rules + 2


@dataclasses.dataclass
class EnvState:
    block_ptr: torch.Tensor   # (B,) int32
    u: torch.Tensor           # (B,) int32
    v: torch.Tensor           # (B,) int32
    matched: torch.Tensor     # (B, n_words_total) int32
    cand: torch.Tensor        # (B, K) int32
    cand_cnt: torch.Tensor    # (B,) int32
    topn: torch.Tensor        # (B, n_top) float32, sorted desc, -inf pad
    done: torch.Tensor        # (B,) bool


def env_reset(cfg: EnvConfig, batch: Optional[int] = None,
              device=None) -> EnvState:
    """The start state of ``batch`` lanes on ``resolve_device(device)``;
    with ``batch`` None, one query's state, every field without the
    batch axis (the reference's ``env_reset(cfg)``)."""
    device = resolve_device(device)
    n = 1 if batch is None else batch

    def zeros():
        return torch.zeros(n, dtype=torch.int32, device=device)

    state = EnvState(
        block_ptr=zeros(),
        u=zeros(),
        v=zeros(),
        matched=torch.zeros((n, cfg.n_words_total), dtype=torch.int32,
                            device=device),
        cand=torch.full((n, cfg.max_candidates), -1, dtype=torch.int32,
                        device=device),
        cand_cnt=zeros(),
        topn=torch.full((n, cfg.n_top), float("-inf"),
                        dtype=torch.float32, device=device),
        done=torch.zeros(n, dtype=torch.bool, device=device),
    )
    return state if batch is not None else _state_map(state, _first)


def _one(x) -> torch.Tensor:
    """A batch of one from a single query's tensor."""
    return x[None]


def _first(x) -> torch.Tensor:
    """The single query of a batch of one."""
    return x[0]


def _state_map(state: EnvState, fn) -> EnvState:
    return EnvState(*(fn(getattr(state, f.name))
                      for f in dataclasses.fields(EnvState)))


def _scalar(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device).reshape(1)


def execute_rule(cfg: EnvConfig, occ, scores, term_present, state: EnvState,
                 allowed, required, du_quota, dv_quota,
                 backend: Union[str, ScanBackend] = "block_scan") -> EnvState:
    """Run one match rule for ONE query until its stopping condition
    (paper §3): Δu ≥ du_quota, Δv ≥ dv_quota, end of index, or episode
    budget.  occ (n_blocks, T, F, W) int32, scores (n_pad,) float32,
    term_present (T,) bool, a single-query state (every field without
    the batch axis), allowed (T, F), required (T,), quotas scalars.
    The rule runs as a batch of one on ``backend``."""
    # Local import: scan_backends imports EnvConfig/EnvState from here.
    from .scan_backends import get_scan_backend

    scan = get_scan_backend(backend) if isinstance(backend, str) else backend
    dev = occ.device
    out = scan.run_rule(cfg, _one(occ), _one(scores), _one(term_present),
                        _state_map(state, _one), _one(allowed), _one(required),
                        _scalar(du_quota, dev), _scalar(dv_quota, dev))
    return _state_map(out, _first)


def batched_env_step(cfg: EnvConfig, ruleset, occ, scores, term_present,
                     state: EnvState, action,
                     backend: Union[str, ScanBackend] = "block_scan"
                     ) -> EnvState:
    """One agent step over a batch (the leading axis of occ, scores,
    term_present, state and action (B,) int32): a match-rule execution,
    a_reset, or a_stop.  ``policy_env_step`` under neutral extras (no
    reset-before, the rules' own quotas), which is the reference's
    ``env_step``."""
    from .rollout import PolicyAction, policy_env_step

    action = torch.as_tensor(action, dtype=torch.int32, device=occ.device)
    return policy_env_step(cfg, ruleset, occ, scores, term_present, state,
                           PolicyAction.plain(action), backend)


def env_step(cfg: EnvConfig, ruleset, occ, scores, term_present,
             state: EnvState, action,
             backend: Union[str, ScanBackend] = "block_scan") -> EnvState:
    """One agent step for ONE query (tensors and state without the batch
    axis, ``action`` a scalar in [0, k + 1])."""
    out = batched_env_step(cfg, ruleset, _one(occ), _one(scores),
                           _one(term_present), _state_map(state, _one),
                           _scalar(action, occ.device), backend)
    return _state_map(out, _first)
