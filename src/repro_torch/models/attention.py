"""GQA attention for the dense LMs (the reference's ``models/attention.py``,
GQA half; MLA is not ported yet).

Two prefill paths, as in the reference:
- ``use_flash=False``: chunked causal attention in plain torch (a loop
  over query chunks keeps the score tile at (B, H, q_chunk, Skv)).
- ``use_flash=True``: the flash-attention kernel wrapper
  (``kernels/flash_attention``), which launches the hand-written CUDA
  kernel on CUDA tensors.

Decode keeps a KV cache {"k", "v"}: (B, S, Hkv, D) per layer.  Two
decode paths, chosen by the same ``use_flash``:
- ``use_flash=False``: scores with fp32 einsums over the cache, as the
  reference's ``gqa_decode`` computes them.
- ``use_flash=True``: the decode-attention kernel wrapper
  (``kernels/decode_attention``), which reads the cache in its own dtype
  through a transposed view, with no copy (the reference names
  ``kernels/decode_attention`` as its TPU decode path).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.common import NEG_INF
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention

from .layers import apply_rope, dense_init, rope_angles

__all__ = ["AttnConfig", "gqa_init", "gqa_forward", "gqa_decode",
           "chunked_causal_attention"]


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    rope_theta: float = 10000.0
    q_chunk: int = 512           # plain-path query chunk
    use_flash: bool = False      # flash- and decode-attention kernel paths


def gqa_init(gen: torch.Generator, cfg: AttnConfig,
             dtype=torch.float32) -> Dict[str, torch.Tensor]:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head
    return {
        "wq": dense_init(gen, (d, h * dh), dtype=dtype),
        "wk": dense_init(gen, (d, kv * dh), dtype=dtype),
        "wv": dense_init(gen, (d, kv * dh), dtype=dtype),
        "wo": dense_init(gen, (h * dh, d), scale=(h * dh) ** -0.5, dtype=dtype),
    }


def chunked_causal_attention(q, k, v, q_chunk: int, causal_offset: int = 0):
    """q: (B, S, H, D); k, v: (B, Skv, Hkv, D) → (B, S, H, Dv) float32.
    One query chunk at a time, all in float32."""
    b, s, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    group = h // hkv
    scale = d ** -0.5
    nchunks = max(s // q_chunk, 1)
    if s % nchunks:
        raise ValueError(f"S={s} does not split into {nchunks} query chunks")
    cq = s // nchunks

    kg = k.float()
    vg = v.float()
    key_pos = torch.arange(skv, device=q.device)
    out = torch.empty((b, s, h, dv), dtype=torch.float32, device=q.device)
    for ci in range(nchunks):
        qi = q[:, ci * cq:(ci + 1) * cq].float().reshape(b, cq, hkv, group, d)
        sc = torch.einsum("bqkgd,bskd->bkgqs", qi, kg) * scale   # (B,hkv,g,cq,S)
        q_pos = ci * cq + torch.arange(cq, device=q.device) + causal_offset
        mask = q_pos[:, None] >= key_pos[None, :]
        sc = sc.masked_fill(~mask, NEG_INF)
        p = torch.softmax(sc, dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", p, vg)
        out[:, ci * cq:(ci + 1) * cq] = o.reshape(b, cq, h, dv)
    return out


def gqa_forward(params: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: AttnConfig, positions: Optional[torch.Tensor] = None,
                return_cache: bool = False):
    """Training / prefill.  x: (B, S, d_model); with ``return_cache``
    also {"k", "v"}: (B, S, Hkv, D) after RoPE."""
    b, s, d = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    q = (x @ params["wq"]).reshape(b, s, h, dh)
    k = (x @ params["wk"]).reshape(b, s, kv, dh)
    v = (x @ params["wv"]).reshape(b, s, kv, dh)

    pos = torch.arange(s, device=x.device)[None] if positions is None else positions
    cos, sin = rope_angles(pos, dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if cfg.use_flash:
        o = flash_attention(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), causal=True,
        ).transpose(1, 2)
    else:
        o = chunked_causal_attention(q, k, v, cfg.q_chunk)

    out = o.to(x.dtype).reshape(b, s, h * dh) @ params["wo"]
    if return_cache:
        return out, {"k": k, "v": v}
    return out


def gqa_decode(params: Dict[str, torch.Tensor], x_tok: torch.Tensor,
               cache: Dict[str, torch.Tensor], pos: torch.Tensor,
               cfg: AttnConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode.  x_tok: (B, d_model); cache k/v: (B, S, Hkv, D);
    pos: (B,) current position (number of tokens already cached).

    Unlike the reference, which returns a new cache, this writes the new
    key and value into ``cache`` IN PLACE at ``pos`` and returns it; a
    lane with pos >= S stores nothing, as the reference's select does."""
    b, d = x_tok.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    k_cache, v_cache = cache["k"], cache["v"]
    s_max = k_cache.shape[1]

    q = (x_tok @ params["wq"]).reshape(b, 1, h, dh)
    k_new = (x_tok @ params["wk"]).reshape(b, 1, kv, dh)
    v_new = (x_tok @ params["wv"]).reshape(b, 1, kv, dh)

    cos, sin = rope_angles(pos[:, None], dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)[:, 0]                            # (B, h, dh)
    k_new = apply_rope(k_new, cos, sin)

    # No host sync: every lane writes one row, a lane out of range
    # writes back the row it read.
    lanes = torch.arange(b, device=x_tok.device)
    row = pos.clamp(max=s_max - 1)
    keep = (pos < s_max)[:, None, None]
    k_cache[lanes, row] = torch.where(keep, k_new[:, 0].to(k_cache.dtype),
                                      k_cache[lanes, row])
    v_cache[lanes, row] = torch.where(keep, v_new[:, 0].to(v_cache.dtype),
                                      v_cache[lanes, row])

    if cfg.use_flash:
        # keys 0..pos are valid; a lane with pos >= S sees all S keys
        o, _, _ = decode_attention(
            q.to(k_cache.dtype), k_cache.transpose(1, 2),
            v_cache.transpose(1, 2), kv_len=(pos + 1).clamp(max=s_max))
        o = o.reshape(b, h * dh)
    else:
        group = h // kv
        q4 = q.reshape(b, kv, group, dh).float()
        sc = torch.einsum("bkgd,bskd->bkgs", q4, k_cache.float()) * (dh ** -0.5)
        valid = torch.arange(s_max, device=x_tok.device)[None] <= pos[:, None]
        sc = sc.masked_fill(~valid[:, None, None], NEG_INF)
        p = torch.softmax(sc, dim=-1)
        o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float()).reshape(b, h * dh)

    out = o.to(x_tok.dtype) @ params["wo"]
    return out, {"k": k_cache, "v": v_cache}
