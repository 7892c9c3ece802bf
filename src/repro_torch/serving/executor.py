"""Rollout executor: multi-shard scatter–gather of the L0→L1 serve step.

The serve step — a policy rollout per index shard through
``unified_rollout``, candidate scatter to global doc ids, static-rank
merge across shards (``merge_shard_candidates``) and L1 rank/prune — is
one eager function here.  (The reference AOT-compiles it per bucket and
policy structure; PyTorch runs eagerly, so there is no compile cache.)

Sharding is the logical split of the paper's multi-machine index: the
block axis is cut into ``n_shards`` equal slices, each running its own
rollout under the full per-machine u budget, then per-shard candidates
are merged by static rank before L1.  The shards are folded into the
query-batch axis, so one rollout runs S·B lanes: lanes never couple, so
this equals S separate rollouts.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.rollout import unified_rollout
from repro_torch.core.scan_backends import get_scan_backend
from repro_torch.core.telescope import l1_prune, merge_shard_candidates
from repro_torch.policies import Policy

__all__ = ["ShardedExecutor"]


class ShardedExecutor:
    def __init__(self, system, n_shards: int = 1, keep: int = 100,
                 backend: Optional[str] = None):
        """``backend`` is a scan-backend name; None takes the system's
        (``SystemConfig.backend``).  Runs on the system's device."""
        if system.bins is None:
            raise ValueError("system needs fit_state_bins() before serving")
        nb = system.env_cfg.n_blocks
        if n_shards < 1 or nb % n_shards:
            raise ValueError(f"n_shards={n_shards} must divide n_blocks={nb}")
        self.system = system
        self.n_shards = n_shards
        self.keep = keep
        self.backend = system.cfg.backend if backend is None else backend
        self._scan = get_scan_backend(self.backend)
        self.blocks_per_shard = nb // n_shards
        self.docs_per_shard = self.blocks_per_shard * system.env_cfg.block_docs
        self.shard_env_cfg = dataclasses.replace(
            system.env_cfg, n_blocks=self.blocks_per_shard)
        self.execute_count = 0

    def _serve_fn(self, policy: Policy, occ, scores, term_present):
        """(B, NB, T, F, W) occupancy → (ids, scores, u, cand_cnt)."""
        sys_ = self.system
        s, nbs, ds = self.n_shards, self.blocks_per_shard, self.docs_per_shard
        b = occ.shape[0]
        t_max = policy.horizon or sys_.cfg.t_max
        # (B, S, nb/S, ...) -> (S*B, nb/S, ...): shard-major lanes.
        occ_sh = occ.reshape(b, s, nbs, *occ.shape[2:]).transpose(0, 1)
        occ_sh = occ_sh.reshape(s * b, nbs, *occ.shape[2:]).contiguous()
        scores_sh = scores.reshape(b, s, ds).transpose(0, 1).reshape(s * b, ds)
        tp_sh = term_present.repeat(s, 1)

        final = unified_rollout(self.shard_env_cfg, sys_.ruleset, sys_.bins,
                                policy, t_max, occ_sh, scores_sh, tp_sh,
                                backend=self._scan).final_state

        cand = final.cand.reshape(s, b, -1)
        shard_base = (torch.arange(s, dtype=torch.int32, device=occ.device)
                      * ds)[:, None, None]
        global_cand = torch.where(cand >= 0, cand + shard_base, -1)
        merged = merge_shard_candidates(
            global_cand, keep=sys_.env_cfg.max_candidates)     # (B, K)
        ids, sc = l1_prune(scores, merged, keep=self.keep)
        u_tot = final.u.reshape(s, b).sum(dim=0, dtype=torch.int32)
        cand_cnt = (merged >= 0).sum(dim=1, dtype=torch.int32)
        return ids, sc, u_tot, cand_cnt

    def execute(self, policy: Policy, occ, scores, term_present
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Serve one micro-batch; returns host arrays
        (ids (B, keep) int32, scores (B, keep) float32, u (B,), cand_cnt (B,))."""
        if not isinstance(policy, Policy):
            raise TypeError(f"expected a repro_torch.policies.Policy, got "
                            f"{type(policy).__name__}")
        ids, sc, u, cnt = self._serve_fn(policy, occ, scores, term_present)
        self.execute_count += 1
        return (ids.cpu().numpy(), sc.cpu().numpy(), u.cpu().numpy(),
                cnt.cpu().numpy())
