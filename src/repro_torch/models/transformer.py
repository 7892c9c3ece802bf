"""Decoder-only transformer LM family, dense GQA / MoE / MLA (the
reference's ``models/transformer.py`` without the mesh paths: its
tensor, FSDP/ZeRO-3 and sequence sharding wait for the next slice of
the port, and every entry point raises for a ``mesh``).

Parameters are a nested dict whose layer leaves are stacked over layers,
``(n_layers, ...)``, as the reference's ``init_params`` builds them; the
layers run in a Python loop over views of those leaves.  The KV cache is
{"k", "v"}: (n_layers, B, S, Hkv, D) for GQA, and MLA's compressed
{"c", "k_rope"}: (n_layers, B, S, r) and (n_layers, B, S, d_rope).  An
MoE FFN runs over the flattened (B*S, d) tokens in prefill and forward
(capacity and drops over all of them, as the reference's), over (B, d)
in decode.

``forward`` and ``lm_loss`` are differentiable: the token embedding's
gather sums its gradient in a fixed order (``take_rows``), and with
``cfg.remat`` each layer's activations are recomputed in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` with
``nothing_saveable``).  They train through the plain attention: the
flash and decode kernels have no backward, as the reference's have no
VJP.

Entry points (``init_params``, ``init_kv_cache``, ``forward``,
``lm_loss``, ``prefill``, ``decode_step``) run on ``cuda`` unless given
``device="cpu"``, and raise without CUDA; ``init_params`` also takes
``device="meta"`` (shapes only).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import (entry_device, refuse_mesh, resolve_device,
                                seeded_generator)
from repro_torch.kernels.embedding_bag import take_rows

from .attention import (AttnConfig, MLAConfig, gqa_decode, gqa_forward,
                        gqa_init, mla_decode, mla_forward, mla_init)
from .layers import dense_init, mlp_apply, mlp_init, rms_norm
from .moe import MoEConfig, moe_ffn, moe_init

__all__ = ["TransformerConfig", "init_params", "forward", "lm_loss", "prefill",
           "decode_step", "init_kv_cache", "cache_shapes", "layer_params",
           "layer_forward", "layer_decode"]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's config.  ``loss_chunk`` (rows per chunk of
    ``lm_loss``), ``remat`` (recompute each layer in ``forward``'s
    backward), ``microbatch`` and ``grad_accum_dtype`` (the gradient
    accumulation of ``launch/steps.make_lm_train_step``) act as in the
    reference; ``sp_carry``, ``fsdp`` and ``zero3`` are sharding knobs,
    kept so that a config carries the reference's values, and ignored
    on one device."""
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    d_ff: int
    vocab: int
    mlp_kind: str = "swiglu"          # swiglu | gelu
    attn_kind: str = "gqa"            # gqa | mla
    moe: Optional[MoEConfig] = None   # None = dense FFN
    mla: Optional[MLAConfig] = None
    rope_theta: float = 10000.0
    max_seq: int = 4096
    q_chunk: int = 512
    loss_chunk: int = 2048
    remat: bool = True
    param_dtype: Any = torch.float32
    use_flash: bool = False           # attention kernels in prefill and decode
    sp_carry: bool = True
    microbatch: int = 1
    fsdp: bool = False
    grad_accum_dtype: Any = torch.float32
    zero3: bool = False

    def attn_cfg(self) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads, n_kv=self.n_kv,
            d_head=self.d_head, rope_theta=self.rope_theta,
            q_chunk=self.q_chunk, use_flash=self.use_flash,
        )


# ---------------------------------------------------------------- params
def _layer_init(gen: torch.Generator, cfg: TransformerConfig) -> Dict:
    """One layer; an MoE router stays float32 under any param_dtype."""
    dt = cfg.param_dtype
    if cfg.attn_kind == "mla":
        attn = mla_init(gen, cfg.mla, dtype=dt)
    else:
        attn = gqa_init(gen, cfg.attn_cfg(), dtype=dt)
    if cfg.moe is not None:
        ffn = moe_init(gen, cfg.moe, dtype=dt)
    else:
        ffn = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind, dtype=dt)
    return {
        "attn": attn,
        "ffn": ffn,
        "ln1": torch.ones((cfg.d_model,), dtype=dt, device=gen.device),
        "ln2": torch.ones((cfg.d_model,), dtype=dt, device=gen.device),
    }


def _stacked_like(tree: Dict, n: int) -> Dict:
    return {k: _stacked_like(v, n) if isinstance(v, dict)
            else v.new_empty((n, *v.shape)) for k, v in tree.items()}


def _copy_layer(dst: Dict, src: Dict, i: int) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_layer(dst[k], v, i)
        else:
            dst[k][i].copy_(v)


def layer_params(layers: Dict, i: int) -> Dict:
    """Layer i's parameters: views into the stacked leaves."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


def init_params(cfg: TransformerConfig, seed: int = 0, device=None) -> Dict:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``
    on the target device.  Layers are drawn one at a time (in float32,
    then cast) into the stacked leaves, so the float32 transient is one
    layer's leaf, not a stacked one (grok-1's expert leaf, (8, 6144, 32768),
    is 6.4 GB in float32)."""
    dev = resolve_device(device)
    gen = seeded_generator(seed, dev)
    embed = dense_init(gen, (cfg.vocab, cfg.d_model), scale=0.02,
                       dtype=cfg.param_dtype)
    layers = None
    for i in range(cfg.n_layers):
        lp = _layer_init(gen, cfg)
        if layers is None:
            layers = _stacked_like(lp, cfg.n_layers)
        _copy_layer(layers, lp, i)
        del lp
    return {
        "embed": embed,
        "layers": layers,
        "ln_f": torch.ones((cfg.d_model,), dtype=cfg.param_dtype, device=dev),
        "lm_head": dense_init(gen, (cfg.d_model, cfg.vocab),
                              dtype=cfg.param_dtype),
    }


# --------------------------------------------------------------- forward
def _ffn(cfg: TransformerConfig, ffn: Dict, h: torch.Tensor):
    """The FFN on h (..., d) -> (out, aux loss () f32, or None when
    dense).  An MoE FFN routes all of h's tokens as one (T, d) batch."""
    if cfg.moe is None:
        return mlp_apply(ffn, h, cfg.mlp_kind), None
    out, aux = moe_ffn(ffn, h.reshape(-1, h.shape[-1]), cfg.moe)
    return out.view(h.shape), aux


def layer_forward(cfg: TransformerConfig, lp: Dict, x: torch.Tensor,
                  return_cache: bool = False):
    """One block of ``forward`` and ``prefill``: pre-norm attn + pre-norm
    FFN.  x: (B, S, d) -> (x, the layer's cache or None, aux loss or
    None when dense)."""
    h = rms_norm(x, lp["ln1"])
    if cfg.attn_kind == "mla":
        out = mla_forward(lp["attn"], h, cfg.mla, return_cache=return_cache)
    else:
        out = gqa_forward(lp["attn"], h, cfg.attn_cfg(),
                          return_cache=return_cache)
    h, cache = out if return_cache else (out, None)
    x = x + h
    h, aux = _ffn(cfg, lp["ffn"], rms_norm(x, lp["ln2"]))
    return x + h, cache, aux


def _unbind_layers(layers: Dict, n: int):
    """The stacked layer leaves as n per-layer dicts of views, through
    one ``unbind`` a leaf: its backward stacks the n layer gradients
    into one tensor, where n ``select``s would each add a zero-filled
    copy of the whole stacked leaf."""
    out = [{} for _ in range(n)]
    for k, v in layers.items():
        parts = (_unbind_layers(v, n) if isinstance(v, dict)
                 else torch.unbind(v, 0))
        for i in range(n):
            out[i][k] = parts[i]
    return out


def forward(params: Dict, tokens, cfg: TransformerConfig, mesh=None,
            device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (final hidden (B, S, d), aux loss: the sum of
    the MoE layers' load-balance losses, 0 for a dense model).  With
    ``cfg.remat`` under grad mode, each layer is recomputed in the
    backward instead of keeping its activations."""
    refuse_mesh(mesh, "the LM")
    dev = entry_device(params["embed"], None, device)
    x = take_rows(params["embed"], torch.as_tensor(tokens, device=dev).long())
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in _unbind_layers(params["layers"], cfg.n_layers):
        if remat:
            x, _, layer_aux = checkpoint(layer_forward, cfg, lp, x,
                                         use_reentrant=False)
        else:
            x, _, layer_aux = layer_forward(cfg, lp, x)
        if layer_aux is not None:
            aux = aux + layer_aux
    return rms_norm(x, params["ln_f"]), aux


def lm_loss(params: Dict, tokens, targets, cfg: TransformerConfig, mesh=None,
            device=None) -> torch.Tensor:
    """Next-token cross-entropy () float32, plus 0.01 x the aux loss.
    The (B*S, d) hidden rows are cut into whole chunks of
    min(cfg.loss_chunk, B*S) rows (a tail that fills no chunk is
    dropped, as the reference drops it); each chunk's logits are float32,
    so no (tokens, vocab) tensor is made whole."""
    h, aux = forward(params, tokens, cfg, mesh, device)
    b, s, d = h.shape
    flat_h = h.reshape(b * s, d)
    flat_t = torch.as_tensor(targets, device=h.device).long().reshape(b * s)
    chunk = min(cfg.loss_chunk, b * s)
    n_chunks = (b * s) // chunk
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(n_chunks):
        rows = slice(c * chunk, (c + 1) * chunk)
        logits = (flat_h[rows] @ params["lm_head"]).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(1, flat_t[rows, None])[:, 0]
        total = total + torch.sum(lse - gold)
    return total / (n_chunks * chunk) + 0.01 * aux


# ----------------------------------------------------------------- decode
def cache_shapes(cfg: TransformerConfig, batch: int, seq: int
                 ) -> Dict[str, Tuple[int, ...]]:
    """The KV cache's fields and shapes: GQA's {"k", "v"} (L, B, S, Hkv,
    D), MLA's {"c": (L, B, S, r), "k_rope": (L, B, S, d_rope)}."""
    lead = (cfg.n_layers, batch, seq)
    if cfg.attn_kind == "mla":
        return {"c": (*lead, cfg.mla.kv_lora_rank),
                "k_rope": (*lead, cfg.mla.d_rope)}
    return {"k": (*lead, cfg.n_kv, cfg.d_head),
            "v": (*lead, cfg.n_kv, cfg.d_head)}


def init_kv_cache(cfg: TransformerConfig, batch: int, max_seq: int,
                  dtype=None, device=None) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    dt = dtype or cfg.param_dtype
    return {f: torch.zeros(shape, dtype=dt, device=dev)
            for f, shape in cache_shapes(cfg, batch, max_seq).items()}


def prefill(params: Dict, tokens, cfg: TransformerConfig, mesh=None,
            device=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the prompt, returning last-position logits (B, vocab) float32
    and the KV cache (layout of ``init_kv_cache``; the prompt occupies
    positions [0, S))."""
    refuse_mesh(mesh, "the LM")
    dev = entry_device(params["embed"], None, device)
    tokens = torch.as_tensor(tokens, device=dev).long()
    b, s = tokens.shape
    x = params["embed"][tokens]
    cache = {f: torch.empty(shape, dtype=x.dtype, device=dev)
             for f, shape in cache_shapes(cfg, b, s).items()}
    for i in range(cfg.n_layers):
        x, layer_cache, _ = layer_forward(cfg, layer_params(params["layers"], i),
                                          x, return_cache=True)
        for f, c in layer_cache.items():
            cache[f][i] = c
    h_last = rms_norm(x[:, -1], params["ln_f"])
    logits = (h_last @ params["lm_head"]).float()
    return logits, cache


def layer_decode(cfg: TransformerConfig, lp: Dict, x: torch.Tensor,
                 layer_cache: Dict[str, torch.Tensor], pos: torch.Tensor
                 ) -> torch.Tensor:
    """One block of ``decode_step``: x (B, d) -> x; writes the layer's
    cache row at ``pos`` in place."""
    h = rms_norm(x, lp["ln1"])
    if cfg.attn_kind == "mla":
        h, _ = mla_decode(lp["attn"], h, layer_cache, pos, cfg.mla)
    else:
        h, _ = gqa_decode(lp["attn"], h, layer_cache, pos, cfg.attn_cfg())
    x = x + h
    return x + _ffn(cfg, lp["ffn"], rms_norm(x, lp["ln2"]))[0]


def decode_step(params: Dict, token, cache: Dict[str, torch.Tensor], pos,
                cfg: TransformerConfig, mesh=None, device=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step.  token (B,) int; pos (B,) current lengths.
    Returns (logits (B, vocab) float32, cache).  The cache is updated IN
    PLACE and returned (the reference returns a new one)."""
    refuse_mesh(mesh, "the LM")
    dev = entry_device(params["embed"], None, device)
    token = torch.as_tensor(token, device=dev).long()
    pos = torch.as_tensor(pos, device=dev)
    x = params["embed"][token]                                   # (B, d)
    for i in range(cfg.n_layers):
        x = layer_decode(cfg, layer_params(params["layers"], i), x,
                         {f: c[i] for f, c in cache.items()}, pos)
    h = rms_norm(x, params["ln_f"])
    logits = (h @ params["lm_head"]).float()
    return logits, cache
