"""Parameters carried across from the JAX reference.

The reference's parameters cannot be re-drawn here (its ``jax.random``
streams have no torch counterpart), so they cross as numpy arrays:
``np.asarray`` of each leaf on the reference side,
:func:`from_reference` (retrieval system),
:func:`lm_params_from_reference` (LM parameter tree),
:func:`recsys_params_from_reference` (recsys parameter trees) or
:func:`gnn_params_from_reference` (GraphSAGE parameters and readout)
here.
Among them are the reference trainer's outputs, a trained ``q`` table
and trained ``l1_params``; the port also trains its own
(``RetrievalSystem.fit_l1``, ``train_policy``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.match_plan import MatchPlan
from repro_torch.core.match_rules import RuleSet
from repro_torch.core.state_bins import StateBins
from repro_torch.device import resolve_device

__all__ = ["ReferenceWeights", "from_reference", "lm_params_from_reference",
           "recsys_params_from_reference", "gnn_params_from_reference"]

_L1_KEYS = ("w1", "b1", "w2", "b2", "w3", "b3")
_RULESET_KEYS = ("allowed", "required", "du_quota", "dv_quota")
_PLAN_KEYS = ("rule_idx", "reset_before", "du_quota", "dv_quota")


@dataclasses.dataclass
class ReferenceWeights:
    l1_params: Optional[Dict[str, torch.Tensor]] = None
    bins: Optional[StateBins] = None
    q: Optional[torch.Tensor] = None
    ruleset: Optional[RuleSet] = None
    plans: Optional[Dict[str, MatchPlan]] = None


def _tensor(x, dtype: np.dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=dtype)).to(device)


def from_reference(
    l1_params: Optional[Mapping[str, np.ndarray]] = None,
    bins: Optional[Mapping[str, np.ndarray]] = None,
    q: Optional[np.ndarray] = None,
    ruleset: Optional[Mapping[str, np.ndarray]] = None,
    plans: Optional[Mapping[str, Mapping[str, np.ndarray]]] = None,
    *,
    device=None,
) -> ReferenceWeights:
    """Convert reference parameters (numpy arrays) to the port's objects.

    ``l1_params``: {w1, b1, w2, b2, w3, b3}; ``bins``: {u_edges,
    v_edges}; ``q``: (p, n_actions); ``ruleset``: {allowed, required,
    du_quota, dv_quota}; ``plans``: {name: {rule_idx, reset_before,
    du_quota, dv_quota}}."""
    dev = resolve_device(device)
    out = ReferenceWeights()
    if l1_params is not None:
        out.l1_params = {k: _tensor(l1_params[k], np.float32, dev)
                         for k in _L1_KEYS}
    if bins is not None:
        out.bins = StateBins(_tensor(bins["u_edges"], np.float32, dev),
                             _tensor(bins["v_edges"], np.float32, dev))
    if q is not None:
        out.q = _tensor(q, np.float32, dev)
    if ruleset is not None:
        dt = (bool, bool, np.int32, np.int32)
        out.ruleset = RuleSet(*(_tensor(ruleset[k], d, dev)
                                for k, d in zip(_RULESET_KEYS, dt)))
    if plans is not None:
        dt = (np.int32, bool, np.int32, np.int32)
        out.plans = {name: MatchPlan(*(_tensor(p[k], d, dev)
                                       for k, d in zip(_PLAN_KEYS, dt)))
                     for name, p in plans.items()}
    return out


# Leaves that the port's init draws in float32 under any param_dtype,
# as the reference does: the MoE router (``models/moe.py``).
_FLOAT32_LEAVES = ("router",)


def lm_params_from_reference(params: Mapping, cfg, device=None) -> Dict:
    """The reference's LM parameter tree (nested dicts of numpy arrays,
    layer leaves stacked ``(n_layers, ...)``) as the port's, each leaf in
    the dtype the port's ``init_params`` gives it: ``cfg.param_dtype``
    (a ``TransformerConfig``), the MoE router float32.  The recsys trees
    of the four archs (``RecsysConfig``, ``B4RConfig``) convert leaf for
    leaf the same way: ``recsys_params_from_reference``."""
    dev = resolve_device(device)

    def convert(tree, name=None):
        if isinstance(tree, Mapping):
            return {k: convert(v, k) for k, v in tree.items()}
        arr = np.array(tree, dtype=np.float32)       # bf16 leaves too
        dt = torch.float32 if name in _FLOAT32_LEAVES else cfg.param_dtype
        return torch.from_numpy(arr).to(dev, dt)

    return convert(params)


recsys_params_from_reference = lm_params_from_reference


def gnn_params_from_reference(params, cfg, device=None):
    """The reference's GraphSAGE tree ({"layer_l": {w_self, w_neigh,
    b}}; numpy leaves) as the port's float32 tensors, the structure kept:
    a (params, readout) pair converts too, readout {"w", "b"} included.
    ``cfg`` is the ``SAGEConfig``: the tree must hold its n_layers
    layers (every leaf is float32)."""
    dev = resolve_device(device)
    layers = params[0] if isinstance(params, (tuple, list)) else params
    if set(layers) != {f"layer_{l}" for l in range(cfg.n_layers)}:
        raise ValueError(f"want layers 0..{cfg.n_layers - 1}; got "
                         f"{sorted(layers)}")

    def convert(tree):
        if isinstance(tree, Mapping):
            return {k: convert(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(convert(v) for v in tree)
        return _tensor(tree, np.float32, dev)

    return convert(params)
