"""Equal-mass discretization of the (u, v) state space (paper §4).

Two-level quantile scheme: √p equal-mass strata over u, then √p
equal-mass v-quantiles *within each stratum*.  ``fit_bins`` is host
numpy, as in the reference; ``bin_index`` runs on the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["StateBins", "fit_bins", "bin_index"]


@dataclasses.dataclass
class StateBins:
    u_edges: torch.Tensor   # (pu - 1,) float32 interior edges over u
    v_edges: torch.Tensor   # (pu, pv - 1) float32 per-stratum edges over v

    @property
    def pu(self) -> int:
        return self.v_edges.shape[0]

    @property
    def pv(self) -> int:
        return self.v_edges.shape[1] + 1

    @property
    def p(self) -> int:
        return self.pu * self.pv


def fit_bins(u: np.ndarray, v: np.ndarray, p: int = 1024,
             device=None) -> StateBins:
    """Fit from harvested baseline (u, v) pairs (host-side); the edges
    go to ``device`` (cuda unless asked)."""
    device = resolve_device(device)
    u = np.asarray(u, dtype=np.float32).ravel()
    v = np.asarray(v, dtype=np.float32).ravel()
    pu = max(1, int(np.sqrt(p)))
    pv = max(1, p // pu)

    u_edges = np.asarray(np.quantile(u, np.linspace(0, 1, pu + 1)[1:-1]),
                         dtype=np.float32)
    strata = np.searchsorted(u_edges, u, side="right")
    v_edges = np.zeros((pu, pv - 1), dtype=np.float32)
    for s in range(pu):
        vs = v[strata == s]
        if len(vs) < pv:
            vs = v  # sparse stratum: fall back to the global distribution
        v_edges[s] = np.quantile(vs, np.linspace(0, 1, pv + 1)[1:-1])
    return StateBins(u_edges=torch.from_numpy(u_edges).to(device),
                     v_edges=torch.from_numpy(v_edges).to(device))


def bin_index(bins: StateBins, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """State index in [0, p) for (B,) u and v."""
    uf = u.to(torch.float32)
    vf = v.to(torch.float32)
    s = torch.searchsorted(bins.u_edges, uf, right=True)            # stratum
    edges = bins.v_edges[s]                                         # (B, pv-1)
    vb = (edges <= vf[:, None]).sum(dim=-1)
    return (s * bins.pv + vb).to(torch.int32)
