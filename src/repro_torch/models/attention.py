"""Attention modules: GQA (the dense LMs and grok-1) and MLA
(DeepSeek-V2-Lite), as the reference's ``models/attention.py``.

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
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  merge_partials)
from repro_torch.kernels.flash_attention import flash_attention

from .layers import apply_rope, dense_init, rope_angles

__all__ = ["AttnConfig", "gqa_init", "gqa_forward", "gqa_decode", "MLAConfig",
           "mla_init", "mla_forward", "mla_decode", "mla_absorbed_attention",
           "mla_materialised_attention",
           "chunked_causal_attention", "HeadSplit", "gqa_forward_tp",
           "gqa_decode_tp", "mla_forward_tp", "mla_decode_tp",
           "partial_attention"]


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

    out = _attend(q, k, v, cfg).to(x.dtype).reshape(b, s, h * dh) @ params["wo"]
    if return_cache:
        return out, {"k": k, "v": v}
    return out


def _attend(q, k, v, cfg: AttnConfig) -> torch.Tensor:
    """Causal attention of q (B, S, H, D) over k, v (B, S, Hkv, D): the
    flash kernel with ``use_flash``, else the chunked plain path."""
    if cfg.use_flash:
        return flash_attention(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), causal=True,
        ).transpose(1, 2)
    return chunked_causal_attention(q, k, v, cfg.q_chunk)


def _write_rows(cache: torch.Tensor, new: torch.Tensor, pos: torch.Tensor):
    """cache (B, S, ...)[b, pos[b]] = new[b], in place.  No host sync:
    every lane writes one row, a lane with pos >= S writes back the row
    it read, so it stores nothing, as the reference's select does."""
    lanes = torch.arange(cache.shape[0], device=cache.device)
    row = pos.clamp(max=cache.shape[1] - 1)
    keep = (pos < cache.shape[1]).view(-1, *([1] * (new.dim() - 1)))
    cache[lanes, row] = torch.where(keep, new.to(cache.dtype), cache[lanes, row])


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

    _write_rows(k_cache, k_new[:, 0], pos)
    _write_rows(v_cache, v_new[:, 0], pos)

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


# --------------------------------------------------------------------- MLA
@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    kv_lora_rank: int = 512
    d_nope: int = 128
    d_rope: int = 64
    d_v: int = 128
    rope_theta: float = 10000.0
    q_chunk: int = 512


def mla_init(gen: torch.Generator, cfg: MLAConfig,
             dtype=torch.float32) -> Dict[str, torch.Tensor]:
    d, h = cfg.d_model, cfg.n_heads
    return {
        "wq": dense_init(gen, (d, h * (cfg.d_nope + cfg.d_rope)), dtype=dtype),
        "w_dkv": dense_init(gen, (d, cfg.kv_lora_rank + cfg.d_rope), dtype=dtype),
        "w_uk": dense_init(gen, (cfg.kv_lora_rank, h * cfg.d_nope), dtype=dtype),
        "w_uv": dense_init(gen, (cfg.kv_lora_rank, h * cfg.d_v), dtype=dtype),
        "wo": dense_init(gen, (h * cfg.d_v, d), scale=(h * cfg.d_v) ** -0.5,
                         dtype=dtype),
    }


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def mla_forward(params: Dict[str, torch.Tensor], x: torch.Tensor,
                cfg: MLAConfig, return_cache: bool = False,
                heads=_same, own=_same):
    """Training / prefill with the per-head K/V materialised; with
    ``return_cache`` also {"c": (B, S, r), "k_rope": (B, S, d_rope)}
    after RoPE.  ``heads`` takes the (B, S, columns) products of wq,
    w_uk and w_uv to every head and ``own`` the (B, S, H * d_v) output to
    the columns that wo's rows meet: both the identity here, the
    gather and the rank's block in ``mla_forward_tp``."""
    b, s, d = x.shape
    h = cfg.n_heads
    dn, dr, dv, r = cfg.d_nope, cfg.d_rope, cfg.d_v, cfg.kv_lora_rank

    q = heads(x @ params["wq"]).reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    ckv = x @ params["w_dkv"]                                    # (B, S, r + dr)
    c, k_rope = ckv[..., :r], ckv[..., r:]

    pos = torch.arange(s, device=x.device)[None]
    cos, sin = rope_angles(pos, dr, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)         # (B, S, 1, dr)

    k_nope = heads(c @ params["w_uk"]).reshape(b, s, h, dn)
    v = heads(c @ params["w_uv"]).reshape(b, s, h, dv)
    k_full = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], -1)
    q_full = torch.cat([q_nope, q_rope], -1)

    o = chunked_causal_attention(q_full, k_full, v, cfg.q_chunk)
    out = own(o.to(x.dtype).reshape(b, s, h * dv)) @ params["wo"]
    if return_cache:
        return out, {"c": c, "k_rope": k_rope[:, :, 0, :]}
    return out


def mla_absorbed_attention(params: Dict[str, torch.Tensor],
                           q_nope: torch.Tensor, q_rope: torch.Tensor,
                           c_cache: torch.Tensor, kr_cache: torch.Tensor,
                           pos: torch.Tensor, cfg: MLAConfig):
    """Attention of one query per lane against the compressed cache, in
    float32: q_nope (B, h, d_nope) is mapped into c-space through W_uk,
    and the values stay compressed until W_uv.  Keys 0..pos[b] are
    valid.  Returns (out (B, h * d_v) f32, scores (B, h, S) f32, the
    invalid keys at -inf)."""
    b, h = q_nope.shape[:2]
    dn, dr, dv, r = cfg.d_nope, cfg.d_rope, cfg.d_v, cfg.kv_lora_rank
    s_max = c_cache.shape[1]
    cf = c_cache.float()
    w_uk = params["w_uk"].reshape(r, h, dn).float()
    q_c = torch.einsum("bhd,rhd->bhr", q_nope.float(), w_uk)
    sc = torch.einsum("bhr,bsr->bhs", q_c, cf)
    sc = sc + torch.einsum("bhd,bsd->bhs", q_rope.float(), kr_cache.float())
    sc = sc * ((dn + dr) ** -0.5)
    valid = torch.arange(s_max, device=c_cache.device)[None] <= pos[:, None]
    sc = sc.masked_fill(~valid[:, None], NEG_INF)
    p = torch.softmax(sc, dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", p, cf)                   # (B, h, r)
    w_uv = params["w_uv"].reshape(r, h, dv).float()
    o = torch.einsum("bhr,rhd->bhd", ctx, w_uv).reshape(b, h * dv)
    return o, sc


def mla_materialised_attention(params: Dict[str, torch.Tensor],
                               q_nope: torch.Tensor, q_rope: torch.Tensor,
                               c_cache: torch.Tensor, kr_cache: torch.Tensor,
                               pos: torch.Tensor, cfg: MLAConfig):
    """``mla_absorbed_attention`` written as ``mla_forward`` attends, to
    check it by: per-head K = [c W_uk, k_rope] and V = c W_uv
    materialised from the cache, in float32.  Same arguments and
    returns."""
    b, h = q_nope.shape[:2]
    dn, dr, dv = cfg.d_nope, cfg.d_rope, cfg.d_v
    s_max = c_cache.shape[1]
    cf = c_cache.float()
    k_nope = (cf @ params["w_uk"].float()).reshape(b, s_max, h, dn)
    v = (cf @ params["w_uv"].float()).reshape(b, s_max, h, dv)
    k = torch.cat([k_nope, kr_cache.float()[:, :, None].expand(b, s_max, h, dr)],
                  -1)
    q = torch.cat([q_nope.float(), q_rope.float()], -1)
    sc = torch.einsum("bhd,bshd->bhs", q, k) * ((dn + dr) ** -0.5)
    valid = torch.arange(s_max, device=c_cache.device)[None] <= pos[:, None]
    sc = sc.masked_fill(~valid[:, None], NEG_INF)
    o = torch.einsum("bhs,bshd->bhd", torch.softmax(sc, dim=-1), v)
    return o.reshape(b, h * dv), sc


def mla_decode(params: Dict[str, torch.Tensor], x_tok: torch.Tensor,
               cache: Dict[str, torch.Tensor], pos: torch.Tensor,
               cfg: MLAConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Absorbed-matmul MLA decode.  x_tok: (B, d_model); cache c:
    (B, S, r), k_rope: (B, S, d_rope); pos: (B,) tokens already cached.
    Writes the new row into ``cache`` IN PLACE at ``pos`` (a lane with
    pos >= S stores nothing) and returns it, as ``gqa_decode`` does."""
    b, d = x_tok.shape
    h = cfg.n_heads
    dn, dr, r = cfg.d_nope, cfg.d_rope, cfg.kv_lora_rank

    q = (x_tok @ params["wq"]).reshape(b, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    cos, sin = rope_angles(pos[:, None], dr, cfg.rope_theta)
    q_rope = apply_rope(q_rope[:, None], cos, sin)[:, 0]          # (B, h, dr)

    ckv = x_tok @ params["w_dkv"]
    c_new, k_rope_new = ckv[..., :r], ckv[..., r:]
    k_rope_new = apply_rope(k_rope_new[:, None, None, :], cos, sin)[:, 0, 0]
    _write_rows(cache["c"], c_new, pos)
    _write_rows(cache["k_rope"], k_rope_new, pos)

    o, _ = mla_absorbed_attention(params, q_nope, q_rope, cache["c"],
                                  cache["k_rope"], pos, cfg)
    out = o.to(x_tok.dtype) @ params["wo"]
    return out, {"c": cache["c"], "k_rope": cache["k_rope"]}


# --------------------------------------------------- tensor parallel (mesh)
@dataclasses.dataclass(frozen=True)
class HeadSplit:
    """This rank's share (``rank`` of ``size`` along the mesh axis
    ``axis``) of the Megatron split of ``_lm_rule``, which shards the
    columns of wq/wk/wv (and MLA's w_uk/w_uv) and the rows of wo over the
    axis: the column block [rank * H * dh / size, (rank + 1) * H * dh /
    size).  Where ``size`` divides the heads that block is whole heads,
    [rank * Hq / size, (rank + 1) * Hq / size) (the head view:
    ``q_heads``, ``kv_range``; its KV heads are those its Q heads map to,
    group Hq / Hkv); else a block may cut a head (24 heads on 16 ranks:
    1.5 a rank), and the attention gathers every head
    (``whole_heads`` is False)."""
    mesh: object
    axis: str
    size: int
    rank: int

    def whole_heads(self, n_heads: int, n_kv: int, d_head: int) -> bool:
        """Whether the head view holds: ``size`` divides the query heads
        and a rank's heads read whole KV groups or lie within one.  Else
        the caller gathers every head.  Raises where wq's or wk's columns
        do not split evenly, where the reference cannot place the weight
        either."""
        for name, heads in (("wq", n_heads), ("wk", n_kv)):
            self._columns(name, heads, d_head)
        if n_heads % self.size:
            return False
        hq, group = n_heads // self.size, n_heads // n_kv
        return hq % group == 0 or group % hq == 0

    def mla_whole_heads(self, cfg: MLAConfig) -> bool:
        """``whole_heads`` for MLA, whose query heads each have their own
        keys: whether ``size`` divides them.  Raises where the columns
        of wq, w_uk or w_uv do not split evenly."""
        h = cfg.n_heads
        for name, width in (("wq", cfg.d_nope + cfg.d_rope),
                            ("w_uk", cfg.d_nope), ("w_uv", cfg.d_v)):
            self._columns(name, h, width)
        return h % self.size == 0

    def _columns(self, name: str, heads: int, width: int) -> None:
        if heads * width % self.size:
            raise ValueError(f"{heads * width} columns of {name} ({heads} "
                             f"heads of {width}) do not split over the "
                             f"{self.size}-way {self.axis!r} axis")

    def column_heads(self, n_heads: int, width: int,
                     device=None) -> torch.Tensor:
        """The head of each column of this rank's block of an
        (n_heads * width)-column weight, (n_heads * width / size,)."""
        n = n_heads * width // self.size
        return (self.rank * n + torch.arange(n, device=device)) // width

    def q_heads(self, n_heads: int) -> int:
        if n_heads % self.size:
            raise ValueError(f"{n_heads} query heads do not split over the "
                             f"{self.size}-way {self.axis!r} axis")
        return n_heads // self.size

    def kv_range(self, n_heads: int, n_kv: int) -> Tuple[int, int]:
        """[lo, hi): the KV heads this rank's Q heads read.  Raises
        unless they read whole groups or lie within one."""
        hq, group = self.q_heads(n_heads), n_heads // n_kv
        if hq % group and group % hq:
            raise ValueError(
                f"{hq} query heads a rank ({n_heads} over {self.size}) cut "
                f"the GQA groups of {group} ({n_heads} / {n_kv} KV heads)")
        lo = self.rank * hq // group
        return lo, lo + max(hq // group, 1)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' blocks of ``x`` joined along ``dim`` in rank order
        (backward: a reduce-scatter)."""
        from repro_torch.distributed.collectives import all_gather

        return all_gather(x, self.mesh, self.axis, dim)

    def own(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block of ``x`` along ``dim``."""
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.rank * n, n)


def gqa_forward_tp(params: Dict[str, torch.Tensor], x: torch.Tensor,
                   cfg: AttnConfig, split: HeadSplit,
                   return_cache: bool = False):
    """``gqa_forward`` on one rank: ``params`` its column blocks of
    wq/wk/wv and row block of wo, x (B, S, d_model) whole.  Returns its
    partial output (B, S, d_model), which a sum over ``split.axis``
    completes; with ``return_cache`` also every KV head {"k", "v"}:
    (B, S, Hkv, D) after RoPE.  Where ``split.size`` does not divide the
    query heads, q is gathered to every head like k and v (backward: a
    reduce-scatter), every rank attends over all H heads, and its column
    block of the (B, S, H * D) output goes through its rows of wo."""
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    whole = split.whole_heads(h, kv, dh)
    if whole:
        q = (x @ params["wq"]).reshape(b, s, split.q_heads(h), dh)
        lo, hi = split.kv_range(h, kv)
    else:
        q = split.gather(x @ params["wq"], 2).reshape(b, s, h, dh)
        lo, hi = 0, kv
    if kv % split.size == 0:
        k = (x @ params["wk"]).reshape(b, s, kv // split.size, dh)
        v = (x @ params["wv"]).reshape(b, s, kv // split.size, dh)
        sel = slice(None)
    else:   # a column block may hold part of a head: gather them all
        k = split.gather(x @ params["wk"], 2).reshape(b, s, kv, dh)
        v = split.gather(x @ params["wv"], 2).reshape(b, s, kv, dh)
        sel = slice(lo, hi)
    cos, sin = rope_angles(torch.arange(s, device=x.device)[None], dh,
                           cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = _attend(q, k[:, :, sel], v[:, :, sel], cfg)
    o = o.to(x.dtype).reshape(b, s, q.shape[2] * dh)
    out = (o if whole else split.own(o, 2)) @ params["wo"]
    if not return_cache:
        return out
    if sel == slice(None) and split.size > 1:
        k, v = split.gather(k, 2), split.gather(v, 2)
    return out, {"k": k, "v": v}


def mla_forward_tp(params: Dict[str, torch.Tensor], x: torch.Tensor,
                   cfg: MLAConfig, split: HeadSplit, return_cache: bool = False):
    """``mla_forward`` on one rank: its column blocks of wq, w_uk and
    w_uv and row block of wo, the whole (replicated) w_dkv.  Returns the
    partial output; the cache {"c", "k_rope"} is whole on every rank.
    Where ``split.size`` divides the query heads the blocks are the
    rank's heads; else the products of wq, w_uk and w_uv are gathered to
    every head (backward: a reduce-scatter), every rank attends over all
    H heads, and its column block of the (B, S, H * d_v) output goes
    through its rows of wo."""
    if split.mla_whole_heads(cfg):
        return mla_forward(params, x,
                           dataclasses.replace(cfg, n_heads=split.q_heads(cfg.n_heads)),
                           return_cache=return_cache)
    return mla_forward(params, x, cfg, return_cache=return_cache,
                       heads=lambda t: split.gather(t, 2),
                       own=lambda t: split.own(t, 2))


def partial_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      n_valid: torch.Tensor):
    """One query a row against the first ``n_valid[b]`` keys of a cache
    slice, unnormalised, in float32: q (B, H, D), k and v (B, S, Hkv, D)
    → (acc (B, H, D), m (B, H, 1), l (B, H, 1)); a row with no valid key
    gives acc 0, m = -inf, l = 0 (``merge_partials`` weights it 0)."""
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    q4 = q.reshape(b, kv, h // kv, d).float()
    sc = torch.einsum("bkgd,bskd->bkgs", q4, k.float()) * (d ** -0.5)
    valid = torch.arange(s, device=q.device)[None] < n_valid[:, None]
    acc, m, l = _partial_softmax(sc.reshape(b, h, s), valid[:, None])
    o = torch.einsum("bkgs,bskd->bkgd", acc.reshape(b, kv, h // kv, s),
                     v.float())
    return o.reshape(b, h, d), m, l


def _partial_softmax(sc: torch.Tensor, valid: torch.Tensor):
    """(p, m, l) of scores (B, H, S) masked by ``valid``: p = exp(sc - m)
    on the valid keys, 0 elsewhere; m = -inf and l = 0 on a row with
    none."""
    sc = sc.masked_fill(~valid, NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(valid, torch.exp(sc - m_safe), torch.zeros_like(sc))
    return p, m, p.sum(-1, keepdim=True)


def _merge_tp(split: HeadSplit, acc, m, l) -> torch.Tensor:
    """The ranks' partials over their key slices, gathered and merged in
    rank order: (B, H, D) float32."""
    accs, ms, ls = (split.gather(t[None], 0) for t in (acc, m, l))
    return merge_partials(list(accs), list(ms), list(ls))


def _local_rows(split: HeadSplit, pos: torch.Tensor, s_loc: int):
    """(row of this rank's slice to write, or s_loc where another rank
    owns pos; valid keys of the slice, clamp(pos + 1 - off, 0, s_loc))."""
    local = pos - split.rank * s_loc
    row = torch.where((local >= 0) & (local < s_loc), local, s_loc)
    return row, (local + 1).clamp(0, s_loc)


def gqa_decode_tp(params: Dict[str, torch.Tensor], x_tok: torch.Tensor,
                  cache: Dict[str, torch.Tensor], pos: torch.Tensor,
                  cfg: AttnConfig, split: HeadSplit) -> torch.Tensor:
    """``gqa_decode`` on one rank of a sequence-sharded cache: ``cache``
    k/v (B, S / size, Hkv, D) is this rank's slice of every KV head.
    The new key and value (gathered to every head) are written only by
    the rank that owns ``pos``; q is gathered to every head; the rank
    attends over its slice (the decode kernel with ``use_flash``, its
    partial float32, else ``partial_attention``), the partials are
    merged, and the rank's column block of the merged (B, H * D) output
    (its own heads, where ``split.size`` divides them) goes through its
    rows of wo.  Returns the partial output (B, d_model)."""
    b = x_tok.shape[0]
    h, kv, dh = cfg.n_heads, cfg.n_kv, cfg.d_head
    whole = split.whole_heads(h, kv, dh)
    k_cache, v_cache = cache["k"], cache["v"]
    s_loc = k_cache.shape[1]
    k_new = split.gather(x_tok @ params["wk"], 1).reshape(b, 1, kv, dh)
    v_new = split.gather(x_tok @ params["wv"], 1).reshape(b, 1, kv, dh)
    cos, sin = rope_angles(pos[:, None], dh, cfg.rope_theta)
    if whole:
        q = (x_tok @ params["wq"]).reshape(b, 1, split.q_heads(h), dh)
        q = split.gather(apply_rope(q, cos, sin)[:, 0], 1)      # (B, H, D)
    else:                               # a column block may cut a head
        q = split.gather(x_tok @ params["wq"], 1).reshape(b, 1, h, dh)
        q = apply_rope(q, cos, sin)[:, 0]
    k_new = apply_rope(k_new, cos, sin)
    row, n_valid = _local_rows(split, pos, s_loc)
    _write_rows(k_cache, k_new[:, 0], row)
    _write_rows(v_cache, v_new[:, 0], row)
    if cfg.use_flash:
        acc, m, l = decode_attention(
            q.to(k_cache.dtype).contiguous(), k_cache.transpose(1, 2),
            v_cache.transpose(1, 2), kv_len=n_valid, return_partial=True,
            partial_f32=True)
    else:
        acc, m, l = partial_attention(q, k_cache, v_cache, n_valid)
    o = split.own(_merge_tp(split, acc, m, l).reshape(b, h * dh), 1)
    return o.to(x_tok.dtype) @ params["wo"]


def mla_decode_tp(params: Dict[str, torch.Tensor], x_tok: torch.Tensor,
                  cache: Dict[str, torch.Tensor], pos: torch.Tensor,
                  cfg: MLAConfig, split: HeadSplit) -> torch.Tensor:
    """``mla_decode`` on one rank of a sequence-sharded cache (c
    (B, S / size, r), k_rope (B, S / size, d_rope)): the rank maps its
    heads' q_nope into c-space through its columns of w_uk, gathers
    those and the q_rope to every head, scores them against its slice
    (float32, as ``mla_absorbed_attention``), merges the ranks' partials
    in c-space and takes its own heads through w_uv and wo.  Returns the
    partial output (B, d_model).

    Where ``split.size`` does not divide the query heads, q is gathered
    to every head; a rank's columns of w_uk may cut a head, so each
    rank maps its columns of every head's q_nope into c-space and the
    ranks' shares are summed in rank order (``psum_ordered``); the
    merged context of every head goes through the rank's columns of
    w_uv, each column with its own head, and its rows of wo."""
    from repro_torch.distributed.collectives import psum_ordered

    b = x_tok.shape[0]
    h = cfg.n_heads
    whole = split.mla_whole_heads(cfg)
    hq = split.q_heads(h) if whole else h
    dn, dr, dv, r = cfg.d_nope, cfg.d_rope, cfg.d_v, cfg.kv_lora_rank
    q = x_tok @ params["wq"]
    q = (q if whole else split.gather(q, 1)).reshape(b, hq, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    cos, sin = rope_angles(pos[:, None], dr, cfg.rope_theta)
    q_rope = apply_rope(q_rope[:, None], cos, sin)[:, 0]
    ckv = x_tok @ params["w_dkv"]
    c_new, k_rope_new = ckv[..., :r], ckv[..., r:]
    k_rope_new = apply_rope(k_rope_new[:, None, None, :], cos, sin)[:, 0, 0]
    c_cache, kr_cache = cache["c"], cache["k_rope"]
    row, n_valid = _local_rows(split, pos, c_cache.shape[1])
    _write_rows(c_cache, c_new, row)
    _write_rows(kr_cache, k_rope_new, row)

    if whole:
        w_uk = params["w_uk"].reshape(r, hq, dn).float()
        q_c = split.gather(torch.einsum("bhd,rhd->bhr", q_nope.float(), w_uk), 1)
        q_rope = split.gather(q_rope, 1)
    else:
        heads = split.column_heads(h, dn, x_tok.device)
        cols = split.own(q_nope.reshape(b, h * dn), 1).float()
        share = torch.zeros((b, h, r), dtype=torch.float32, device=x_tok.device)
        share.index_add_(1, heads, cols[:, :, None] * params["w_uk"].float().T)
        q_c = psum_ordered(share, split.mesh, split.axis)
    cf = c_cache.float()
    sc = torch.einsum("bhr,bsr->bhs", q_c, cf)
    sc = sc + torch.einsum("bhd,bsd->bhs", q_rope.float(), kr_cache.float())
    sc = sc * ((dn + dr) ** -0.5)
    valid = torch.arange(cf.shape[1], device=cf.device)[None] < n_valid[:, None]
    p, m, l = _partial_softmax(sc, valid[:, None])
    ctx = _merge_tp(split, torch.einsum("bhs,bsr->bhr", p, cf), m, l)
    if whole:
        w_uv = params["w_uv"].reshape(r, hq, dv).float()
        o = torch.einsum("bhr,rhd->bhd", split.own(ctx, 1), w_uv).reshape(b, hq * dv)
    else:
        heads = split.column_heads(h, dv, x_tok.device)
        o = torch.einsum("bjr,rj->bj", ctx[:, heads], params["w_uv"].float())
    return o.to(x_tok.dtype) @ params["wo"]
