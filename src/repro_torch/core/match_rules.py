"""Match rules: per-term conjunctions of per-field disjunctions.

A match rule (paper §3) is e.g.::

    mr_A -> (halloween ∈ A|U|B|T) ∧ (costumes ∈ A|U|B|T)
    mr_B -> (facebook  ∈ U|T)                       # 'login' relaxed

A library of ``k`` rules is a dataclass of tensors:

    allowed  (k, T, F) bool   fields a rule inspects per term slot
    required (k, T)    bool   whether the term participates in the conjunction
    du_quota (k,)      int32  stopping condition: max Δu per execution
    dv_quota (k,)      int32  stopping condition: max Δv per execution

``scan_block`` evaluates a rule over one bitpacked block per lane on the
full (T, F, W) tile: the reference backend's per-block step.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.index.blocks import popcount
from repro_torch.index.builder import MAX_QUERY_TERMS
from repro_torch.index.corpus import A, B, N_FIELDS, T, U

__all__ = ["RuleSet", "default_rule_library", "scan_block", "block_cost"]


@dataclasses.dataclass
class RuleSet:
    allowed: torch.Tensor    # (k, T, F) bool
    required: torch.Tensor   # (k, T) bool
    du_quota: torch.Tensor   # (k,) int32
    dv_quota: torch.Tensor   # (k,) int32

    @property
    def k(self) -> int:
        return self.allowed.shape[0]

    def gather(self, a: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Rule parameters for action indices ``a`` (B,)."""
        return (self.allowed[a], self.required[a],
                self.du_quota[a], self.dv_quota[a])


def default_rule_library(du_scale: int = 1, dv_scale: int = 1,
                         t: int = MAX_QUERY_TERMS, device=None) -> RuleSet:
    """Six hand-designed rules, strict → relaxed, mirroring the paper's
    examples.  Quotas are expressed in plane-blocks (Δu) and term matches
    (Δv); ``*_scale`` lets configs adapt them to corpus size."""
    dev = resolve_device(device)
    F = N_FIELDS
    k = 6
    allowed = np.zeros((k, t, F), dtype=bool)
    required = np.zeros((k, t), dtype=bool)
    allowed[0, :, :] = True                   # mr0: every term, any field
    required[0, :] = True
    allowed[1, :, [U]] = allowed[1, :, [T]] = True    # mr1: U|T
    required[1, :] = True
    allowed[2, :, [A]] = allowed[2, :, [T]] = True    # mr2: A|T
    required[2, :] = True
    allowed[3, :, [B]] = allowed[3, :, [T]] = True    # mr3: B|T
    required[3, :] = True
    allowed[4, :2, :] = True                  # mr4: first two terms, any field
    required[4, :2] = True
    allowed[5, :, [B]] = True                 # mr5: body-only backstop
    required[5, :] = True

    du = np.array([16, 4, 4, 8, 8, 12], dtype=np.int32) * du_scale
    dv = np.array([512, 64, 64, 256, 256, 384], dtype=np.int32) * dv_scale
    return RuleSet(
        allowed=torch.from_numpy(allowed).to(dev),
        required=torch.from_numpy(required).to(dev),
        du_quota=torch.from_numpy(du).to(dev),
        dv_quota=torch.from_numpy(dv).to(dev),
    )


def block_cost(allowed: torch.Tensor, term_present: torch.Tensor) -> torch.Tensor:
    """Δu for scanning ONE block with a rule: the number of (term, field)
    posting planes read.  (..., T, F) bool × (..., T) bool → (...) int32."""
    act = allowed & term_present.unsqueeze(-1)
    return act.sum(dim=(-2, -1), dtype=torch.int32)


def _reduce_bits(x: torch.Tensor, dim: int, op) -> torch.Tensor:
    """Bitwise reduction along ``dim`` (torch has no or/and reduce)."""
    parts = x.unbind(dim)
    out = parts[0]
    for p in parts[1:]:
        out = op(out, p)
    return out


def scan_block(
    occ_block: torch.Tensor,      # (B, T, F, W) int32
    allowed: torch.Tensor,        # (B, T, F) bool
    required: torch.Tensor,       # (B, T) bool
    term_present: torch.Tensor,   # (B, T) bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Evaluate each lane's rule over its block.

    Returns match_words (B, W) int32 (bit set iff the doc satisfies the
    rule) and v_inc (B,) int32 (Σ_t popcount(∨_{f allowed} occ[t, f]),
    the paper's v)."""
    mask = (allowed & term_present.unsqueeze(-1)).unsqueeze(-1)      # (B,T,F,1)
    planes = torch.where(mask, occ_block, 0)
    tf_or = _reduce_bits(planes, 2, torch.bitwise_or)                # (B, T, W)
    req = (required & term_present).unsqueeze(-1)                    # (B, T, 1)
    # Non-required slots contribute all-ones to the conjunction.
    conj_in = torch.where(req, tf_or, -1)
    match = _reduce_bits(conj_in, 1, torch.bitwise_and)              # (B, W)
    any_req = (required & term_present).any(dim=1, keepdim=True)
    match = torch.where(any_req, match, 0)
    v_inc = popcount(tf_or).sum(dim=(1, 2), dtype=torch.int32)
    return match, v_inc
