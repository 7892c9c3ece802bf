"""The candidate-generation RL environment (paper §3–4).

One environment lane scans ONE index shard for ONE query.  A step
executes a single match rule until its stopping condition (Δu / Δv
quota) fires.  Every tensor here carries a leading query-batch axis
(the JAX reference vmaps a single-query state; the port writes the
batch out).

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

import torch

from repro_torch.index.blocks import WORD_BITS

__all__ = ["EnvConfig", "EnvState", "env_reset"]


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


def env_reset(cfg: EnvConfig, batch: int, device) -> EnvState:
    def zeros():
        return torch.zeros(batch, dtype=torch.int32, device=device)

    return EnvState(
        block_ptr=zeros(),
        u=zeros(),
        v=zeros(),
        matched=torch.zeros((batch, cfg.n_words_total), dtype=torch.int32,
                            device=device),
        cand=torch.full((batch, cfg.max_candidates), -1, dtype=torch.int32,
                        device=device),
        cand_cnt=zeros(),
        topn=torch.full((batch, cfg.n_top), float("-inf"),
                        dtype=torch.float32, device=device),
        done=torch.zeros(batch, dtype=torch.bool, device=device),
    )
