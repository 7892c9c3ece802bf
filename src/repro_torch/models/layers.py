"""Shared model layers: norms, RoPE, MLPs, initializers.

Param-dict + plain-function style, as in the reference
(``repro/models/layers.py``): parameter trees are nested dicts of
tensors.  Initializers draw from an explicit ``torch.Generator``; the
tensors are made on the generator's device.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

__all__ = ["dense_init", "rms_norm", "layer_norm", "rope_angles", "apply_rope",
           "mlp_init", "mlp_apply"]


def dense_init(gen: torch.Generator, shape, scale=None,
               dtype=torch.float32) -> torch.Tensor:
    """A truncated normal on [-2, 2] (not renormalised, as
    ``jax.random.truncated_normal``), drawn in float32 on ``gen``'s
    device, times ``scale`` (default fan_in ** -0.5), cast to ``dtype``."""
    scale = (shape[0] ** -0.5) if scale is None else scale
    x = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return x.mul_(scale).to(dtype)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Normalise in float32, cast back to x's dtype, THEN scale by w."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Normalise in float32, cast back to x's dtype, THEN scale and
    shift, as the reference does."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def rope_angles(positions: torch.Tensor, dim: int, theta: float = 10000.0):
    """positions (...,) -> (cos, sin) each (..., dim/2), float32."""
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                          device=positions.device) / dim))
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D) with cos/sin (..., S, D/2) — rotate-half
    convention; computed in float32, returned in x's dtype."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, kind: str = "swiglu",
             dtype=torch.float32) -> Dict[str, torch.Tensor]:
    if kind == "swiglu":
        return {
            "w_gate": dense_init(gen, (d_model, d_ff), dtype=dtype),
            "w_up": dense_init(gen, (d_model, d_ff), dtype=dtype),
            "w_down": dense_init(gen, (d_ff, d_model), dtype=dtype),
        }
    return {  # plain gelu MLP (starcoder2-style)
        "w_up": dense_init(gen, (d_model, d_ff), dtype=dtype),
        "b_up": torch.zeros((d_ff,), dtype=dtype, device=gen.device),
        "w_down": dense_init(gen, (d_ff, d_model), dtype=dtype),
        "b_down": torch.zeros((d_model,), dtype=dtype, device=gen.device),
    }


def mlp_apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
              kind: str = "swiglu") -> torch.Tensor:
    if kind == "swiglu":
        g = F.silu(x @ params["w_gate"])
        return (g * (x @ params["w_up"])) @ params["w_down"]
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(x @ params["w_up"] + params["b_up"], approximate="tanh")
    return h @ params["w_down"] + params["b_down"]
