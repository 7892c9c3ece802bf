"""Decoder-only transformer LM family, dense GQA / MoE / MLA (the
reference's ``models/transformer.py``).

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

On a ``mesh`` (a ``DeviceMesh`` with ``data`` and ``model`` axes, and
``pod``) they run rank by rank on the blocks that ``_lm_rule`` gives
each rank, with explicit collectives (``distributed/collectives.py``)
where the reference leaves the collectives to its partitioner
(``MeshLM`` holds one call's layout):

- Megatron tensor parallelism over ``model``: heads, d_ff and vocab
  split (``attention.HeadSplit``); a block's column-parallel work starts
  at ``MeshLM.enter`` and its row-parallel partials are summed at
  ``MeshLM.leave``.  The embedding is vocab-parallel
  (``embedding_ops.lookup_local``), and so is the chunked cross-entropy:
  float32 logits of the rank's vocab slice, their global max (``pmax``),
  a ``psum`` of the exp-sums and one of the gold logit; no (chunk,
  vocab) tile is gathered.
- ``sp_carry`` (when S divides ``model``, in ``forward``/``lm_loss``):
  the residual between blocks keeps S / M positions a rank; ``enter``
  all-gathers them, ``leave`` reduce-scatters.
- The MoE FFN: ``moe.moe_ffn_local`` on the rank's tokens (over the
  data axes when the batch divides them, else replicated), its shared
  experts tensor parallel as ``_lm_rule`` shards them; ``fsdp`` gathers
  the experts' ``data`` blocks inside.  Where the rows do not divide the
  data axes but their B * S tokens do (a microbatch of fewer rows than
  data ranks), the reference routes each data shard's tokens with its
  own capacity; here every rank routes all of them with one (ROADMAP
  Queue 3).
- ``zero3`` (dense GQA): every weight ``P(None, "data", "model")``,
  gathered inside the layer (inside the remat region), the batch over
  data x model when it divides, else over data.
- ``prefill`` returns the cache laid out by ``kv_cache_specs`` (S over
  ``model``); ``decode_step`` attends over it with a cross-rank merge of
  the partials (``attention.gqa_decode_tp``/``mla_decode_tp``).

The gradient convention is Megatron's: a tensor replicated over
``model`` carries its whole cotangent on every rank, so a replicated
leaf's gradient is whole, except where the rank sees part of its use
(``lm_grad_axes``).  The reference's MoE aux loss is a shard_map output
that each data shard computes for its own tokens: its value in the loss
is the rank's data shard's, its gradient that of the mean over them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.device import entry_device, resolve_device, seeded_generator
from repro_torch.distributed.collectives import (all_gather, axis_index,
                                                 copy_to, gather_replicated,
                                                 pmax, psum, psum_scatter,
                                                 scatter_replicated, shard_in,
                                                 shard_out)
from repro_torch.distributed.embedding_ops import lookup_local, lookup_rs_local
from repro_torch.distributed.sharding_rules import (P, data_axes,
                                                    kv_cache_spec,
                                                    kv_cache_specs,
                                                    lm_param_specs, mesh_shape)
from repro_torch.kernels.embedding_bag import take_rows
from repro_torch.train.tree import tree_map

from .attention import (AttnConfig, HeadSplit, MLAConfig, gqa_decode,
                        gqa_decode_tp, gqa_forward, gqa_forward_tp, gqa_init,
                        mla_decode, mla_decode_tp, mla_forward, mla_forward_tp,
                        mla_init)
from .layers import dense_init, mlp_apply, mlp_init, rms_norm
from .moe import MoEConfig, moe_ffn, moe_ffn_local, moe_init

__all__ = ["TransformerConfig", "init_params", "forward", "lm_loss", "prefill",
           "decode_step", "init_kv_cache", "cache_shapes", "layer_params",
           "layer_forward", "layer_decode", "MeshLM", "local_params",
           "lm_loss_local", "lm_grad_axes"]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's config.  ``loss_chunk`` (rows per chunk of
    ``lm_loss``), ``remat`` (recompute each layer in ``forward``'s
    backward), ``microbatch`` and ``grad_accum_dtype`` (the gradient
    accumulation of ``launch/steps.make_lm_train_step``) act as in the
    reference; ``sp_carry``, ``fsdp`` and ``zero3`` are the mesh's
    sharding knobs (see the module's note), ignored on one device."""
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
    copy of the whole stacked leaf.  A model of no layers (the roofline
    probe's m(0)) has none."""
    if n == 0:
        return []
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
    backward instead of keeping its activations.

    On a ``mesh``: ``params`` are DTensors (or global tensors) laid out
    by ``lm_param_specs``, tokens global or a DTensor over the data
    axes; returns (the hidden as a DTensor, over the data axes and, with
    ``sp_carry``, its S over ``model``; this rank's aux loss)."""
    if mesh is not None:
        entry_device(params["embed"], mesh, device)
        lp, tok, ml = _mesh_call(params, tokens, cfg, mesh)
        h, aux = _forward_local(cfg, lp, tok, ml)
        return shard_out(h, mesh, P(ml.rows or None, "model" if ml.sp else None,
                                    None)), aux
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
    so no (tokens, vocab) tensor is made whole.

    On a ``mesh`` (as ``forward``): this rank's value of the reference's
    loss, a float32 scalar (its aux term that of the rank's data
    shard); differentiate ``lm_loss_local`` to train."""
    if mesh is not None:
        entry_device(params["embed"], mesh, device)
        lp, tok, ml = _mesh_call(params, tokens, cfg, mesh)
        tgt = ml.rows_block(_global(targets, tok.device))
        return lm_loss_local(cfg, lp, tok, tgt, ml,
                             tok.numel() * ml.n_row_ranks)[1]
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
    positions [0, S)).

    On a ``mesh``: logits a DTensor ``P(dp, "model")`` (the rank's vocab
    slice of its rows), the cache DTensors laid out by
    ``kv_cache_specs`` (S over ``model``)."""
    if mesh is not None:
        entry_device(params["embed"], mesh, device)
        return _prefill_mesh(params, tokens, cfg, mesh)
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
    PLACE and returned (the reference returns a new one).

    On a ``mesh``: the cache laid out by ``kv_cache_specs`` (DTensors,
    written in place by the rank that owns ``pos``), token and pos over
    the data axes when B divides them, else replicated; logits a DTensor
    over those axes and ``model`` (vocab)."""
    if mesh is not None:
        entry_device(params["embed"], mesh, device)
        return _decode_mesh(params, token, cache, pos, cfg, mesh)
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


# ----------------------------------------------------------------- on a mesh
@dataclasses.dataclass(frozen=True)
class MeshLM:
    """One call's layout on a mesh: this rank's head split over
    ``model``; ``rows``, the axes the batch's rows lie over (the data
    axes when the batch divides them, else none; with ``zero3``, data x
    model when the batch divides that); ``sp``, the residual's S over
    ``model`` between blocks (``sp_carry``, when S divides it);
    ``tokens``, the axes an MoE FFN's flat B·S tokens lie over: ``rows``,
    or, where the rows are replicated, the data axes when B·S divides
    them (the reference's ``_apply_moe_ffn``: each data shard routes its
    block with its own capacity), else none (the B = 1 decode)."""
    mesh: Any
    split: HeadSplit
    rows: Tuple[str, ...]
    sp: bool
    zero3: bool
    n_row_ranks: int
    tokens: Tuple[str, ...]
    n_token_ranks: int

    @staticmethod
    def of(cfg: "TransformerConfig", mesh, batch: int,
           seq: Optional[int] = None) -> "MeshLM":
        shape = mesh_shape(mesh)
        m, dp = shape["model"], data_axes(mesh)
        if cfg.zero3 and (cfg.moe is not None or cfg.attn_kind != "gqa"):
            raise ValueError("zero3 shards the dense GQA layers only (the "
                             "reference's _layer_fwd_zero3)")

        def size(axes):
            n = 1
            for a in axes:
                n *= shape[a]
            return n

        rows = dp if batch % size(dp) == 0 and batch >= size(dp) else ()
        if cfg.zero3 and batch % size(dp + ("model",)) == 0 and batch >= size(dp) * m:
            rows = dp + ("model",)
        sp = (not cfg.zero3 and cfg.sp_carry and seq is not None and seq % m == 0)
        n_tok = batch * (seq or 1)
        tokens = rows
        if not rows and n_tok % size(dp) == 0 and n_tok >= size(dp):
            tokens = dp
        return MeshLM(mesh, HeadSplit(mesh, "model", m, axis_index(mesh, "model")),
                      rows, sp, cfg.zero3, size(rows), tokens, size(tokens))

    def rows_block(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global (B, ...) tensor."""
        return shard_in(x, self.mesh, P(self.rows or None))

    def enter(self, h: torch.Tensor) -> torch.Tensor:
        """h, replicated over ``model`` (or its S split under ``sp``),
        whole on every rank for a block's column-parallel work: an
        all-gather of S (backward: a reduce-scatter), else the identity
        whose backward sums the ranks' partial cotangents."""
        if self.sp:
            return all_gather(h, self.mesh, "model", 1)
        return copy_to(h, self.mesh, "model")

    def leave(self, y: torch.Tensor) -> torch.Tensor:
        """The row-parallel partials summed over ``model``: reduce-
        scattered over S under ``sp``."""
        if self.sp:
            return psum_scatter(y, self.mesh, "model", 1)
        return psum(y, self.mesh, "model")


def _global(x, dev) -> torch.Tensor:
    """A DTensor's global value (gathered), or a tensor on ``dev``."""
    if isinstance(x, DTensor):
        return x.full_tensor()
    return torch.as_tensor(x, device=dev)


def local_params(params: Dict, cfg: TransformerConfig, mesh) -> Dict:
    """This rank's blocks of ``params`` (DTensors, or global tensors)
    under ``lm_param_specs``: a DTensor's local tensor itself, so an
    in-place update writes the DTensor."""
    specs = lm_param_specs(params, mesh_shape(mesh)["model"], cfg.fsdp, cfg.zero3)
    return tree_map(lambda p, sp: shard_in(p, mesh, sp), params, specs)


def _mesh_call(params, tokens, cfg, mesh):
    """(local blocks, this rank's token rows, the layout) of a call."""
    lp = local_params(params, cfg, mesh)
    tok = _global(tokens, lp["ln_f"].device).long()
    ml = MeshLM.of(cfg, mesh, tok.shape[0], tok.shape[1] if tok.dim() > 1 else None)
    return lp, ml.rows_block(tok), ml


def _mlp_partial(ffn: Dict, h: torch.Tensor, kind: str) -> torch.Tensor:
    """``mlp_apply`` on a rank's d_ff columns, without b_down: the
    partial that a sum over ``model`` completes."""
    if kind == "swiglu":
        return mlp_apply(ffn, h, kind)
    u = F.gelu(h @ ffn["w_up"] + ffn["b_up"], approximate="tanh")
    return u @ ffn["w_down"]


def _layer_zero3(cfg: TransformerConfig, lp: Dict, x: torch.Tensor,
                 ml: MeshLM) -> torch.Tensor:
    """The reference's ``_layer_fwd_zero3``: each weight's (a / data,
    b / model) block gathered whole here (its gradient reduce-scatters
    back), then the block on this rank's rows."""

    def whole(w):
        w = all_gather(w, ml.mesh, "model", w.dim() - 1)
        return all_gather(w, ml.mesh, "data", 0) if w.dim() == 2 else w

    attn = {k: whole(v) for k, v in lp["attn"].items()}
    ffn = {k: whole(v) for k, v in lp["ffn"].items()}
    x = x + gqa_forward(attn, rms_norm(x, lp["ln1"]), cfg.attn_cfg())
    return x + mlp_apply(ffn, rms_norm(x, lp["ln2"]), cfg.mlp_kind)


def _layer_mesh(cfg: TransformerConfig, lp: Dict, x: torch.Tensor, ml: MeshLM,
                return_cache: bool = False):
    """``layer_forward`` on a rank: x its residual (B_loc, S or S / M, d),
    ``lp`` its blocks.  Returns (x, every KV head's or the MLA cache of
    the whole S, the aux loss of its tokens or None)."""
    if ml.zero3:
        return _layer_zero3(cfg, lp, x, ml), None, None
    h = ml.enter(rms_norm(x, lp["ln1"]))
    if cfg.attn_kind == "mla":
        out = mla_forward_tp(lp["attn"], h, cfg.mla, ml.split, return_cache)
    else:
        out = gqa_forward_tp(lp["attn"], h, cfg.attn_cfg(), ml.split, return_cache)
    h, cache = out if return_cache else (out, None)
    x = x + ml.leave(h)
    y, aux = _ffn_mesh(cfg, lp["ffn"], ml.enter(rms_norm(x, lp["ln2"])), ml)
    return x + y, cache, aux


def _ffn_mesh(cfg: TransformerConfig, ffn: Dict, h: torch.Tensor, ml: MeshLM):
    """The FFN of a block on a rank, h whole for it: (the output, its
    partials summed over ``model`` and b_down added; the aux loss of the
    rank's tokens, or None when dense).  An MoE's shared experts are
    tensor parallel, their partial added before the sum.  Where the rows
    are replicated and the flat tokens split over ``ml.tokens``, the MoE
    runs on this rank's block of them and its output is gathered back
    (backward: the own block; ``lm_grad_axes`` sums the FFN's leaves
    over those axes)."""
    aux = None
    if cfg.moe is None:
        y = _mlp_partial(ffn, h, cfg.mlp_kind)
    else:
        flat = h.reshape(-1, h.shape[-1])
        split = ml.tokens if not ml.rows else ()
        for a in split:
            flat = scatter_replicated(flat, ml.mesh, a, 0)
        y, aux = moe_ffn_local(ffn, flat, cfg.moe, ml.mesh, fsdp=cfg.fsdp)
        if cfg.moe.n_shared:
            y = y + mlp_apply(ffn["shared"], flat, cfg.moe.mlp_kind)
        for a in reversed(split):
            y = gather_replicated(y, ml.mesh, a, 0)
        y = y.view(h.shape)
    y = ml.leave(y)
    return (y + ffn["b_down"] if "b_down" in ffn else y), aux


def _embed_mesh(lp: Dict, tok: torch.Tensor, ml: MeshLM) -> torch.Tensor:
    """The vocab-parallel lookup (reduce-scattered over S under ``sp``);
    under ``zero3`` the whole table's rows."""
    if ml.zero3:
        return take_rows(lp["embed"], tok)
    if ml.sp:
        return lookup_rs_local(lp["embed"], tok, ml.mesh, dim=1)
    return lookup_local(lp["embed"], tok, ml.mesh)


def _forward_local(cfg: TransformerConfig, lp: Dict, tok: torch.Tensor,
                   ml: MeshLM):
    """``forward`` on a rank: (its final hidden, the sum of its layers'
    aux losses)."""
    x = _embed_mesh(lp, tok, ml)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in _unbind_layers(lp["layers"], cfg.n_layers):
        if remat:
            # the recomputation issues the layer's collectives again, in
            # the same order on every rank
            x, _, a = checkpoint(_layer_mesh, cfg, layer, x, ml,
                                 use_reentrant=False)
        else:
            x, _, a = _layer_mesh(cfg, layer, x, ml)
        if a is not None:
            aux = aux + a
    return rms_norm(x, lp["ln_f"]), aux


def lm_loss_local(cfg: TransformerConfig, lp: Dict, tok: torch.Tensor,
                  tgt: torch.Tensor, ml: MeshLM, n_rows: int):
    """``lm_loss`` on a rank: ``lp`` its blocks, tok/tgt its rows,
    ``n_rows`` the global B * S.  Returns (the loss whose gradient,
    summed over ``lm_grad_axes``, is the reference's; this rank's value
    of the reference's loss, detached).

    The reference's chunks of min(loss_chunk, B * S) rows drop the rows
    past the last whole chunk; so does the mask here.  Each chunk's
    cross-entropy is vocab-parallel (float32 logits of this rank's
    vocab slice, the max over ``model``, psums of the exp-sums and of the
    gold logit), on all of the data shard's rows; under ``zero3`` the
    rank's own rows against the whole head."""
    h, aux = _forward_local(cfg, lp, tok, ml)
    if not ml.zero3:
        h = ml.enter(h)
    b, s, d = h.shape
    flat_h, flat_t = h.reshape(b * s, d), tgt.reshape(b * s).long()
    rank_row = 0
    for a in ml.rows:
        rank_row = rank_row * mesh_shape(ml.mesh)[a] + axis_index(ml.mesh, a)
    chunk = min(cfg.loss_chunk, n_rows)
    kept = (n_rows // chunk) * chunk
    keep = (rank_row * b * s + torch.arange(b * s, device=h.device)) < kept
    head = lp["lm_head"]
    v_loc = head.shape[1]
    v0 = 0 if ml.zero3 else ml.split.rank * v_loc
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    step = min(cfg.loss_chunk, b * s)
    for c in range(0, b * s, step):
        rows = slice(c, c + step)
        logits = (flat_h[rows] @ head).float()
        loc = flat_t[rows] - v0
        ok = (loc >= 0) & (loc < v_loc)
        gold = torch.where(ok, logits.gather(1, loc.clamp(0, v_loc - 1)[:, None])[:, 0],
                           0.0)
        if ml.zero3:
            lse = torch.logsumexp(logits, dim=-1)
        else:
            m = pmax(logits.detach().amax(dim=-1), ml.mesh, "model")
            lse = m + torch.log(psum(torch.exp(logits - m[:, None]).sum(-1),
                                     ml.mesh, "model"))
            gold = psum(gold, ml.mesh, "model")
        total = total + torch.sum((lse - gold) * keep[rows])
    ce = total / kept
    m_size = ml.split.size
    # zero3 with the rows replicated over model: each rank holds 1/M
    grad_ce = ce / m_size if ml.zero3 and "model" not in ml.rows else ce
    loss = grad_ce + 0.01 * aux / (ml.n_token_ranks * m_size)
    value = ce.detach().clone()
    for a in ml.rows:
        value = psum(value, ml.mesh, a)
    return loss, value + 0.01 * aux.detach()


def lm_grad_axes(cfg: TransformerConfig, ml: MeshLM):
    """(path, spec) -> the mesh axes over which a leaf's local gradient
    is summed after ``lm_loss_local``'s backward: the axes the batch's
    rows lie over that the leaf is not sharded over (with ``zero3``,
    ``model`` too: its rows lie over it, or each rank holds 1/M of the
    loss); plus ``model`` for a replicated leaf whose use each rank sees
    part of: the router and MLA's w_dkv (their cotangents are the rank's
    experts' or heads' share) and, under ``sp``, the norms and b_down
    (the rank's S slice).  An MoE FFN's leaves take ``ml.tokens`` for
    the rows' axes: with the rows replicated, each rank routes only its
    block of the flat tokens."""
    extra = ("model",) if ml.zero3 and "model" not in ml.rows else ()
    batch = ml.rows + extra
    moe_batch = ml.tokens + extra
    seq_leaves = ("ln1", "ln2", "ln_f", "b_down") if ml.sp else ()

    def axes(path: str, spec) -> Tuple[str, ...]:
        own = spec.axes()
        moe_leaf = cfg.moe is not None and "/ffn/" in f"/{path}"
        out = tuple(a for a in (moe_batch if moe_leaf else batch) if a not in own)
        if (not ml.zero3 and "model" not in own
                and path.endswith(("router", "w_dkv") + seq_leaves)):
            out = out + ("model",)
        return out

    return axes


def _prefill_mesh(params, tokens, cfg: TransformerConfig, mesh):
    # the zero3 layout is the train step's: a DTensor laid out by it is
    # redistributed to the tensor-parallel blocks here (shard_in)
    cfg = dataclasses.replace(cfg, zero3=False)
    lp, tok, ml = _mesh_call(params, tokens, cfg, mesh)
    ml = dataclasses.replace(ml, sp=False)      # the reference's prefill: no carry
    b, s = tok.shape
    split = ml.split
    if s % split.size:
        raise ValueError(f"S = {s} does not split over the {split.size}-way "
                         f"'model' axis (the cache's sequence lies over it)")
    s_loc = s // split.size
    x = _embed_mesh(lp, tok, ml)
    cache = {f: torch.empty((shape[0], b, s_loc) + shape[3:], dtype=x.dtype,
                            device=x.device)
             for f, shape in cache_shapes(cfg, b, s).items()}
    for i in range(cfg.n_layers):
        x, layer_cache, _ = _layer_mesh(cfg, layer_params(lp["layers"], i), x, ml,
                                        return_cache=True)
        for f, c in layer_cache.items():
            cache[f][i] = split.own(c, 1)
    h_last = rms_norm(x[:, -1], lp["ln_f"])
    logits = (h_last @ lp["lm_head"]).float()
    # from the shapes alone: a meta cache here would be an allocation of
    # the global cache in a dry run's count
    specs = {f: kv_cache_spec(shape, mesh)
             for f, shape in cache_shapes(cfg, b * ml.n_row_ranks, s).items()}
    return (shard_out(logits, mesh, P(ml.rows or None, "model")),
            {f: shard_out(c, mesh, specs[f]) for f, c in cache.items()})


def _decode_mesh(params, token, cache, pos, cfg: TransformerConfig, mesh):
    cfg = dataclasses.replace(cfg, zero3=False)     # as in _prefill_mesh
    lp = local_params(params, cfg, mesh)
    dev = lp["ln_f"].device
    token = _global(token, dev).long()
    ml = MeshLM.of(cfg, mesh, token.shape[0])
    tok, pos = ml.rows_block(token), ml.rows_block(_global(pos, dev))
    specs = kv_cache_specs(cache, mesh)
    local = {f: shard_in(c, mesh, specs[f]) for f, c in cache.items()}
    x = _embed_mesh(lp, tok, ml)                                  # (B_loc, d)
    for i in range(cfg.n_layers):
        layer = layer_params(lp["layers"], i)
        lc = {f: c[i] for f, c in local.items()}
        h = rms_norm(x, layer["ln1"])
        if cfg.attn_kind == "mla":
            h = mla_decode_tp(layer["attn"], h, lc, pos, cfg.mla, ml.split)
        else:
            h = gqa_decode_tp(layer["attn"], h, lc, pos, cfg.attn_cfg(), ml.split)
        x = x + ml.leave(h)
        x = x + _ffn_mesh(cfg, layer["ffn"], ml.enter(rms_norm(x, layer["ln2"])),
                          ml)[0]
    logits = (rms_norm(x, lp["ln_f"]) @ lp["lm_head"]).float()
    return shard_out(logits, mesh, P(ml.rows or None, "model")), cache
