"""Decoder-only transformer LM, dense GQA part (the reference's
``models/transformer.py`` without MoE, MLA, the mesh paths, ``lm_loss``
and the train step).

Parameters are a nested dict whose layer leaves are stacked over layers,
``(n_layers, ...)``, as the reference's ``init_params`` builds them; the
layers run in a Python loop over views of those leaves.  The KV cache is
{"k", "v"}: (n_layers, B, S, Hkv, D).

Entry points (``init_params``, ``init_kv_cache``, ``forward``,
``prefill``, ``decode_step``) run on ``cuda`` unless given
``device="cpu"``, and raise without CUDA.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.device import entry_device, resolve_device

from .attention import AttnConfig, gqa_decode, gqa_forward, gqa_init
from .layers import dense_init, mlp_apply, mlp_init, rms_norm

__all__ = ["TransformerConfig", "init_params", "forward", "prefill",
           "decode_step", "init_kv_cache"]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's config, dense GQA fields.  ``loss_chunk``,
    ``remat``, ``sp_carry``, ``microbatch``, ``fsdp``,
    ``grad_accum_dtype`` and ``zero3`` are training and sharding knobs,
    kept so that a config carries the reference's values; the
    single-device forward, prefill and decode here ignore them."""
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_head: int
    d_ff: int
    vocab: int
    mlp_kind: str = "swiglu"          # swiglu | gelu
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
    dt = cfg.param_dtype
    return {
        "attn": gqa_init(gen, cfg.attn_cfg(), dtype=dt),
        "ffn": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_kind, dtype=dt),
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


def _layer(layers: Dict, i: int) -> Dict:
    """Layer i's parameters: views into the stacked leaves."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in layers.items()}


def init_params(cfg: TransformerConfig, seed: int = 0, device=None) -> Dict:
    """Random parameters from a ``torch.Generator`` seeded with ``seed``
    on the target device.  Layers are drawn one at a time (in float32,
    then cast) into the stacked leaves, so the float32 transient is one
    layer's leaf, not a stacked one."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
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
def _layer_fwd(cfg: TransformerConfig, lp: Dict, x: torch.Tensor,
               return_cache: bool = False):
    """One block: pre-norm attn + pre-norm FFN.  x: (B, S, d)."""
    out = gqa_forward(lp["attn"], rms_norm(x, lp["ln1"]), cfg.attn_cfg(),
                      return_cache=return_cache)
    h, cache = out if return_cache else (out, None)
    x = x + h
    h = mlp_apply(lp["ffn"], rms_norm(x, lp["ln2"]), cfg.mlp_kind)
    return x + h, cache


def forward(params: Dict, tokens, cfg: TransformerConfig, mesh=None,
            device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (final hidden (B, S, d), aux_loss = 0)."""
    dev = entry_device(params["embed"], mesh, device)
    x = params["embed"][torch.as_tensor(tokens, device=dev).long()]
    for i in range(cfg.n_layers):
        x, _ = _layer_fwd(cfg, _layer(params["layers"], i), x)
    return (rms_norm(x, params["ln_f"]),
            torch.zeros((), dtype=torch.float32, device=dev))


# ----------------------------------------------------------------- decode
def init_kv_cache(cfg: TransformerConfig, batch: int, max_seq: int,
                  dtype=None, device=None) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv, cfg.d_head)
    dt = dtype or cfg.param_dtype
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def prefill(params: Dict, tokens, cfg: TransformerConfig, mesh=None,
            device=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the prompt, returning last-position logits (B, vocab) float32
    and the KV cache (layout of ``init_kv_cache``; the prompt occupies
    positions [0, S))."""
    dev = entry_device(params["embed"], mesh, device)
    tokens = torch.as_tensor(tokens, device=dev).long()
    b, s = tokens.shape
    x = params["embed"][tokens]
    shape = (cfg.n_layers, b, s, cfg.n_kv, cfg.d_head)
    cache = {"k": torch.empty(shape, dtype=x.dtype, device=dev),
             "v": torch.empty(shape, dtype=x.dtype, device=dev)}
    for i in range(cfg.n_layers):
        x, layer_cache = _layer_fwd(cfg, _layer(params["layers"], i), x,
                                    return_cache=True)
        cache["k"][i] = layer_cache["k"]
        cache["v"][i] = layer_cache["v"]
    h_last = rms_norm(x[:, -1], params["ln_f"])
    logits = (h_last @ params["lm_head"]).float()
    return logits, cache


def decode_step(params: Dict, token, cache: Dict[str, torch.Tensor], pos,
                cfg: TransformerConfig, mesh=None, device=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step.  token (B,) int; pos (B,) current lengths.
    Returns (logits (B, vocab) float32, cache).  The cache is updated IN
    PLACE and returned (the reference returns a new one)."""
    dev = entry_device(params["embed"], mesh, device)
    token = torch.as_tensor(token, device=dev).long()
    pos = torch.as_tensor(pos, device=dev)
    x = params["embed"][token]                                   # (B, d)
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        h = rms_norm(x, lp["ln1"])
        h, _ = gqa_decode(lp["attn"], h, {"k": cache["k"][i], "v": cache["v"][i]},
                          pos, cfg.attn_cfg())
        x = x + h
        x = x + mlp_apply(lp["ffn"], rms_norm(x, lp["ln2"]), cfg.mlp_kind)
    h = rms_norm(x, params["ln_f"])
    logits = (h @ params["lm_head"]).float()
    return logits, cache
