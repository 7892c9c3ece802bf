"""AdamW, hand-rolled over a dict of tensors (the reference's
``train/optimizer.py:26-66``).

The state is ``{"mu": {...}, "nu": {...}, "count": int32 scalar}``, as
in the reference.  The bias corrections ``1 - b**c`` are computed in
float32 from the int32 step count, as the reference computes them, not
in Python doubles.  The rest of the reference's file (SGD with
momentum, Adafactor, clipping, schedules) belongs to the LM train step
and is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update"]

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0


def adamw_init(params: Params, cfg: AdamWConfig = AdamWConfig()) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = next(iter(params.values())).device
    return {"mu": {k: zeros(p) for k, p in params.items()},
            "nu": {k: zeros(p) for k, p in params.items()},
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def adamw_update(params: Params, grads: Params, state: dict,
                 cfg: AdamWConfig = AdamWConfig()):
    """One AdamW step; returns (new params, new state).  Inputs are not
    modified."""
    count = state["count"] + 1
    c = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=c.device), c)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=c.device), c)

    new_p, new_mu, new_nu = {}, {}, {}
    for k, p in params.items():
        g32 = grads[k].to(torch.float32)
        mu = cfg.b1 * state["mu"][k] + (1 - cfg.b1) * g32
        nu = cfg.b2 * state["nu"][k] + (1 - cfg.b2) * g32 * g32
        step = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        step = step + cfg.weight_decay * p.to(torch.float32)
        new_p[k] = (p.to(torch.float32) - cfg.lr * step).to(p.dtype)
        new_mu[k] = mu
        new_nu[k] = nu
    return new_p, {"mu": new_mu, "nu": new_nu, "count": count}
