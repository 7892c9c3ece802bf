"""Rollout executor: one prepared serve step per (bucket, backend,
level, policy structure), and multi-shard scatter–gather.

The serve step — a policy rollout per index shard through
``unified_rollout``, candidate scatter to global doc ids, static-rank
merge across shards (``merge_shard_candidates``) and L1 rank/prune — is
one eager function here.  The reference AOT-compiles it once per key
(bucket size, backend, service level, policy structure); PyTorch runs
eagerly, so the port keeps a counted entry per key instead, with the
reference's names (``compiled_for``, ``warmup``, ``compile_count``):

- an entry is the key itself, recorded once the serve step has been
  run once on a zero-occupancy batch of its
  bucket (every term present) on the system's device: that puts the
  kernel's build and load, the library handles and the caching
  allocator's blocks for that bucket ahead of traffic;
- ``execute`` goes through ``compiled_for``, so a key seen first in
  traffic is counted as the reference counts it.

Policy *parameters* (Q-tables, plan entries) and the state bins are
runtime arguments, so one entry serves every query category whose
policy shares a structure (:func:`repro_torch.policies.structure_key`),
and publishing a new snapshot prepares nothing new; in steady state
the count is ``len(BucketConfig.buckets()) × n_policy_structures`` per
level.

No CUDA graph is captured per entry: the rule loop syncs with the host
before each chunk round and once more a rule execution (the
``cond.any()`` of ``core/scan_backends.py``) inside the per-step Python
loop of ``core/rollout.py``, so a graph would need a fixed chunk count
a key.  The entry is where one would sit.

The rollout is a *backend* chosen at construction and kept in the key:
any name in the core scan-backend registry (``core/scan_backends.py``:
``"reference"`` or ``"block_scan"``, bit-identical) runs through
``unified_rollout(..., backend=...)``; serving-only rollout strategies
can be registered here with ``register_rollout_backend``, and a
registered name wins over a scan backend of the same name.

Sharding is the logical split of the paper's multi-machine index: the
block axis is cut into ``n_shards`` equal slices, each running its own
rollout under the full per-machine u budget, then per-shard candidates
are merged by static rank before L1.  The shards are folded into the
query-batch axis, so one rollout runs S·B lanes: lanes never couple, so
this equals S separate rollouts.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Dict, Iterable, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core.rollout import unified_rollout
from repro_torch.core.scan_backends import available_backends as scan_backends
from repro_torch.core.scan_backends import get_scan_backend
from repro_torch.core.telescope import l1_prune, merge_shard_candidates
from repro_torch.index.corpus import N_FIELDS
from repro_torch.obs import NULL_TRACER, tracing
from repro_torch.policies import Policy, structure_key

__all__ = ["ShardedExecutor", "ROLLOUT_BACKENDS", "available_backends",
           "register_rollout_backend", "resolve_rollout_backend"]


# ------------------------------------------------------------------ backends
# A rollout backend runs one policy rollout over a batch of lanes:
#   backend(cfg, ruleset, bins, policy, t_max, occ, scores, tp) -> EnvState
# (the executor folds its shards into the lanes).  Every core scan
# backend is a rollout backend through unified_rollout(..., backend=);
# this registry holds serving-only overrides and extensions.
ROLLOUT_BACKENDS: Dict[str, Callable] = {}


def register_rollout_backend(name: str):
    """Decorator: register ``fn`` as the rollout backend ``name``."""
    def deco(fn: Callable) -> Callable:
        ROLLOUT_BACKENDS[name] = fn
        return fn
    return deco


def available_backends() -> Tuple[str, ...]:
    """Serving-selectable rollout backends: the core scan-backend
    registry and the serving-level registrations, sorted."""
    return tuple(sorted(set(ROLLOUT_BACKENDS) | set(scan_backends())))


def _scan_backend_rollout(scan, cfg, ruleset, bins, policy, t_max, occ,
                          scores, tp):
    return unified_rollout(cfg, ruleset, bins, policy, t_max, occ, scores,
                           tp, backend=scan).final_state


def resolve_rollout_backend(name: str) -> Callable:
    """The rollout function of ``name``: a registered rollout backend,
    else the scan backend of that name; raises on an unknown name."""
    if name in ROLLOUT_BACKENDS:
        return ROLLOUT_BACKENDS[name]
    if name in scan_backends():
        return partial(_scan_backend_rollout, get_scan_backend(name))
    raise ValueError(f"unknown rollout backend {name!r}; available: "
                     f"{available_backends()}")


class ShardedExecutor:
    def __init__(self, system, n_shards: int = 1, keep: int = 100,
                 backend: Optional[str] = None):
        """``backend`` is a rollout-backend name
        (:func:`available_backends`); None takes the system's
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
        self._rollout = resolve_rollout_backend(self.backend)
        self.blocks_per_shard = nb // n_shards
        self.docs_per_shard = self.blocks_per_shard * system.env_cfg.block_docs
        self.shard_env_cfg = dataclasses.replace(
            system.env_cfg, n_blocks=self.blocks_per_shard)
        self._steps: Set[tuple] = set()
        self.compile_count = 0
        self.execute_count = 0
        # Set by the owning engine when tracing is on; each preparation
        # gets its own span (the cold-start cost of a new key), and the
        # rollout runs under it (the rule loop's spans on the calling
        # thread's track).
        self.tracer = NULL_TRACER

    # ----------------------------------------------------------- the step
    def _serve_fn(self, policy: Policy, occ, scores, term_present):
        """(B, NB, T, F, W) occupancy → (ids, scores, u, cand_cnt)."""
        sys_ = self.system
        s, nbs, ds = self.n_shards, self.blocks_per_shard, self.docs_per_shard
        b = occ.shape[0]
        # (B, S, nb/S, ...) -> (S*B, nb/S, ...): shard-major lanes.
        occ_sh = occ.reshape(b, s, nbs, *occ.shape[2:]).transpose(0, 1)
        occ_sh = occ_sh.reshape(s * b, nbs, *occ.shape[2:]).contiguous()
        scores_sh = scores.reshape(b, s, ds).transpose(0, 1).reshape(s * b, ds)
        tp_sh = term_present.repeat(s, 1)

        with tracing(self.tracer):
            final = self._rollout(self.shard_env_cfg, sys_.ruleset,
                                  sys_.bins, policy,
                                  policy.horizon or sys_.cfg.t_max, occ_sh,
                                  scores_sh, tp_sh)

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

    # ------------------------------------------------------------ prepare
    def _zero_batch(self, bucket: int):
        """A zero-occupancy batch of ``bucket`` lanes, every term
        present, so that the rule loop scans (and launches) as traffic
        does."""
        sys_ = self.system
        cfg, dev = sys_.env_cfg, sys_.device
        t = sys_.log.terms.shape[1]
        occ = torch.zeros((bucket, cfg.n_blocks, t, N_FIELDS,
                           cfg.words_per_block), dtype=torch.int32, device=dev)
        scores = torch.zeros((bucket, cfg.n_blocks * cfg.block_docs),
                             dtype=torch.float32, device=dev)
        tp = torch.ones((bucket, t), dtype=torch.bool, device=dev)
        return occ, scores, tp

    def compiled_for(self, bucket: int, policy: Policy,
                     level: int = 0) -> tuple:
        """The key (bucket, backend, level, policy structure) of a
        prepared serve step; prepared (and counted) on first use."""
        if not isinstance(policy, Policy):
            raise TypeError(
                f"expected a repro_torch.policies.Policy, got "
                f"{type(policy).__name__}; wrap a raw Q-table with "
                "TabularQPolicy(q)")
        # The backend AND the service level are part of the key, as in
        # the reference: a degraded (SHALLOW) execution never shares an
        # entry with FULL serving, even at an equal policy structure.
        key = (bucket, self.backend, int(level), structure_key(policy))
        if key not in self._steps:
            with self.tracer.span("compile", bucket=bucket,
                                  backend=self.backend, level=int(level)):
                self._serve_fn(policy, *self._zero_batch(bucket))
                if self.system.device.type == "cuda":
                    torch.cuda.synchronize(self.system.device)
            self._steps.add(key)
            self.compile_count += 1
        return key

    def warmup(self, buckets: Iterable[int], policies: Iterable[Policy],
               level: int = 0) -> None:
        policies = list(policies)
        for b in buckets:
            for pol in policies:
                self.compiled_for(b, pol, level)

    # ------------------------------------------------------------ execute
    def execute(self, policy: Policy, occ, scores, term_present,
                level: int = 0
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Serve one micro-batch through its prepared step; returns host
        arrays (ids (B, keep) int32, scores (B, keep) float32, u (B,),
        cand_cnt (B,))."""
        self.compiled_for(occ.shape[0], policy, level)
        ids, sc, u, cnt = self._serve_fn(policy, occ, scores, term_present)
        self.execute_count += 1
        return (ids.cpu().numpy(), sc.cpu().numpy(), u.cpu().numpy(),
                cnt.cpu().numpy())
