"""RecSys ranking models: Wide&Deep, DeepFM, DCN-v2, BERT4Rec (the
reference's ``models/recsys.py`` without the mesh paths).

Sparse features use one table of (n_fields · vocab_per_field, dim) rows
indexed with per-field offsets, as in the reference.  The wide and
first-order terms are bag sums through the EmbeddingBag wrapper
(``kernels/embedding_bag``), which launches the hand-written CUDA kernel
on CUDA tensors; the per-field embedding lookups are a plain gather
(``take_rows``), as the reference's are a ``jnp.take`` outside any
kernel.  Both sum their gradients in a fixed order
(``kernels/embedding_bag/backward.py``), so a train step gives the same
bits twice.

Parameters are nested dicts of tensors with the reference's tree.  Entry
points (the ``*_init`` functions and the forwards) run on ``cuda``
unless given ``device="cpu"``, and raise without CUDA (the inits also
take ``device="meta"``, shapes only); ``mesh`` must be None (one
device).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import entry_device, seeded_generator
from repro_torch.kernels.embedding_bag import embedding_bag, take_rows

from .layers import dense_init, layer_norm

__all__ = ["RecsysConfig", "B4RConfig", "wide_deep_init", "wide_deep_forward",
           "deepfm_init", "deepfm_forward", "dcn_init", "dcn_forward",
           "bert4rec_init", "bert4rec_forward", "bert4rec_score_items",
           "bce_loss", "retrieval_topk"]


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    """The reference's config.  ``batch_over_model`` is a sharding knob,
    kept so that a config carries the reference's values; the
    single-device forwards here ignore it."""
    n_sparse: int                 # number of categorical fields
    vocab_per_field: int
    embed_dim: int
    mlp_dims: Tuple[int, ...]
    n_dense: int = 0              # continuous features (dcn-v2: 13)
    n_cross_layers: int = 0       # dcn-v2
    interaction: str = "concat"   # concat | fm | cross | bidir-seq
    param_dtype: Any = torch.float32
    batch_over_model: bool = False

    @property
    def total_vocab(self) -> int:
        return self.n_sparse * self.vocab_per_field


@dataclasses.dataclass(frozen=True)
class B4RConfig:
    n_items: int
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    seq_len: int = 200
    param_dtype: Any = torch.float32


def _global_ids(sparse_ids, cfg: RecsysConfig, dev) -> torch.Tensor:
    """(B, n_sparse) per-field ids → int32 rows of the shared table."""
    ids = torch.as_tensor(sparse_ids, device=dev).to(torch.int32)
    offsets = torch.arange(cfg.n_sparse, dtype=torch.int32, device=dev)
    return ids + offsets * cfg.vocab_per_field


def _bag_sum(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return embedding_bag(table, idx, mode="sum")


def _zeros(shape, dtype, gen) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=gen.device)


def _mlp_init(gen, dims, dtype) -> Dict[str, torch.Tensor]:
    params = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        params[f"w{i}"] = dense_init(gen, (a, b), dtype=dtype)
        params[f"b{i}"] = _zeros((b,), dtype, gen)
    return params


def _mlp_apply(params, x, n, final_relu=False):
    for i in range(n):
        x = x @ params[f"w{i}"] + params[f"b{i}"]
        if i < n - 1 or final_relu:
            x = F.relu(x)
    return x


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    return torch.mean(logits.clamp_min(0) - logits * labels
                      + torch.log1p(torch.exp(-logits.abs())))


# ------------------------------------------------------------- Wide & Deep
def wide_deep_init(cfg: RecsysConfig, seed: int = 0, device=None) -> Dict:
    """Random parameters, one leaf at a time from a generator seeded
    with ``seed`` on the target device."""
    gen = seeded_generator(seed, device)
    dt = cfg.param_dtype
    mlp_dims = (cfg.n_sparse * cfg.embed_dim + cfg.n_dense,) + cfg.mlp_dims + (1,)
    return {
        "wide": dense_init(gen, (cfg.total_vocab, 1), scale=0.01, dtype=dt),
        "embed": dense_init(gen, (cfg.total_vocab, cfg.embed_dim), scale=0.02,
                            dtype=dt),
        "mlp": _mlp_init(gen, mlp_dims, dt),
        "wide_dense": dense_init(gen, (max(cfg.n_dense, 1), 1), scale=0.01,
                                 dtype=dt),
        "bias": _zeros((), dt, gen),
    }


def wide_deep_forward(params: Dict, sparse_ids, cfg: RecsysConfig,
                      dense: Optional[torch.Tensor] = None, mesh=None,
                      device=None) -> torch.Tensor:
    """sparse_ids (B, n_sparse) per-field ids → logits (B,)."""
    dev = entry_device(params["embed"], mesh, device)
    idx = _global_ids(sparse_ids, cfg, dev)
    wide = _bag_sum(params["wide"], idx)[:, 0]                          # (B,)
    emb = take_rows(params["embed"], idx)                                 # (B, F, E)
    deep_in = emb.reshape(emb.shape[0], -1)
    if cfg.n_dense:
        deep_in = torch.cat([dense, deep_in], dim=1)
        wide = wide + (dense @ params["wide_dense"])[:, 0]
    deep = _mlp_apply(params["mlp"], deep_in, len(cfg.mlp_dims) + 1)[:, 0]
    return wide + deep + params["bias"]


# ------------------------------------------------------------------ DeepFM
def deepfm_init(cfg: RecsysConfig, seed: int = 0, device=None) -> Dict:
    gen = seeded_generator(seed, device)
    dt = cfg.param_dtype
    mlp_dims = (cfg.n_sparse * cfg.embed_dim,) + cfg.mlp_dims + (1,)
    return {
        "first_order": dense_init(gen, (cfg.total_vocab, 1), scale=0.01,
                                  dtype=dt),
        "embed": dense_init(gen, (cfg.total_vocab, cfg.embed_dim), scale=0.02,
                            dtype=dt),
        "mlp": _mlp_init(gen, mlp_dims, dt),
        "bias": _zeros((), dt, gen),
    }


def deepfm_forward(params: Dict, sparse_ids, cfg: RecsysConfig,
                   dense: Optional[torch.Tensor] = None, mesh=None,
                   device=None) -> torch.Tensor:
    dev = entry_device(params["embed"], mesh, device)
    idx = _global_ids(sparse_ids, cfg, dev)
    first = _bag_sum(params["first_order"], idx)[:, 0]
    emb = take_rows(params["embed"], idx)                                 # (B, F, E)
    # FM second order: ½((Σv)² − Σv²) summed over dims
    s = emb.sum(1)
    fm = 0.5 * (s * s - (emb * emb).sum(1)).sum(-1)
    deep = _mlp_apply(params["mlp"], emb.reshape(emb.shape[0], -1),
                      len(cfg.mlp_dims) + 1)[:, 0]
    return first + fm + deep + params["bias"]


# ------------------------------------------------------------------ DCN-v2
def dcn_init(cfg: RecsysConfig, seed: int = 0, device=None) -> Dict:
    gen = seeded_generator(seed, device)
    dt = cfg.param_dtype
    d0 = cfg.n_dense + cfg.n_sparse * cfg.embed_dim
    cross = {}
    for i in range(cfg.n_cross_layers):
        cross[f"w{i}"] = dense_init(gen, (d0, d0), scale=0.02, dtype=dt)
        cross[f"b{i}"] = _zeros((d0,), dt, gen)
    return {
        "embed": dense_init(gen, (cfg.total_vocab, cfg.embed_dim), scale=0.02,
                            dtype=dt),
        "cross": cross,
        "mlp": _mlp_init(gen, (d0,) + cfg.mlp_dims, dt),
        "head": dense_init(gen, (d0 + cfg.mlp_dims[-1], 1), dtype=dt),
    }


def dcn_forward(params: Dict, sparse_ids, cfg: RecsysConfig,
                dense: torch.Tensor, mesh=None, device=None) -> torch.Tensor:
    dev = entry_device(params["embed"], mesh, device)
    idx = _global_ids(sparse_ids, cfg, dev)
    emb = take_rows(params["embed"], idx).reshape(idx.shape[0], -1)
    x0 = torch.cat([dense, emb], dim=1)                                 # (B, d0)
    x = x0
    for i in range(cfg.n_cross_layers):
        x = x0 * (x @ params["cross"][f"w{i}"] + params["cross"][f"b{i}"]) + x
    deep = _mlp_apply(params["mlp"], x0, len(cfg.mlp_dims), final_relu=True)
    return (torch.cat([x, deep], dim=1) @ params["head"])[:, 0]


# ---------------------------------------------------------------- BERT4Rec
def bert4rec_init(cfg: B4RConfig, seed: int = 0, device=None) -> Dict:
    gen = seeded_generator(seed, device)
    dt = cfg.param_dtype
    e = cfg.embed_dim
    # +2 for [PAD]=n_items, [MASK]=n_items+1; rows padded to a multiple of
    # 256, as in the reference (its tables row-shard on any mesh)
    n_rows = ((cfg.n_items + 2 + 255) // 256) * 256
    params = {
        "item_embed": dense_init(gen, (n_rows, e), scale=0.02, dtype=dt),
        "pos_embed": dense_init(gen, (cfg.seq_len, e), scale=0.02, dtype=dt),
    }
    blocks = {}
    for b in range(cfg.n_blocks):
        blocks[f"block_{b}"] = {
            "wq": dense_init(gen, (e, e), dtype=dt),
            "wk": dense_init(gen, (e, e), dtype=dt),
            "wv": dense_init(gen, (e, e), dtype=dt),
            "wo": dense_init(gen, (e, e), dtype=dt),
            "mlp": _mlp_init(gen, (e, 4 * e, e), dt),
            "ln1_w": torch.ones((e,), dtype=dt, device=gen.device),
            "ln1_b": _zeros((e,), dt, gen),
            "ln2_w": torch.ones((e,), dtype=dt, device=gen.device),
            "ln2_b": _zeros((e,), dt, gen),
        }
    params["blocks"] = blocks
    params["ln_f_w"] = torch.ones((e,), dtype=dt, device=gen.device)
    params["ln_f_b"] = _zeros((e,), dt, gen)
    return params


def bert4rec_forward(params: Dict, item_seq, cfg: B4RConfig, mesh=None,
                     device=None) -> torch.Tensor:
    """Bidirectional encoder.  item_seq (B, S) int → hidden (B, S, E)."""
    dev = entry_device(params["item_embed"], mesh, device)
    item_seq = torch.as_tensor(item_seq, device=dev)
    b, s = item_seq.shape
    e, h = cfg.embed_dim, cfg.n_heads
    dh = e // h
    x = (take_rows(params["item_embed"], item_seq.long())
         + params["pos_embed"][None, :s])
    pad_mask = item_seq != cfg.n_items                                  # PAD id

    for bi in range(cfg.n_blocks):
        bp = params["blocks"][f"block_{bi}"]
        hx = layer_norm(x, bp["ln1_w"], bp["ln1_b"])
        q = (hx @ bp["wq"]).reshape(b, s, h, dh)
        k = (hx @ bp["wk"]).reshape(b, s, h, dh)
        v = (hx @ bp["wv"]).reshape(b, s, h, dh)
        sc = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * dh ** -0.5
        sc = sc.masked_fill(~pad_mask[:, None, None, :], float("-inf"))
        p = torch.softmax(sc, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(x.dtype)
        x = x + o.reshape(b, s, e) @ bp["wo"]
        hx = layer_norm(x, bp["ln2_w"], bp["ln2_b"])
        x = x + _mlp_apply(bp["mlp"], hx, 2)
    return layer_norm(x, params["ln_f_w"], params["ln_f_b"])


def bert4rec_score_items(params: Dict, hidden_at_mask: torch.Tensor,
                         cfg: B4RConfig) -> torch.Tensor:
    """Tied-weight output: (B, E) → (B, n_items) scores."""
    return hidden_at_mask @ params["item_embed"][: cfg.n_items].T


# -------------------------------------------------------------- retrieval
def retrieval_topk(query_vec: torch.Tensor, cand_emb: torch.Tensor,
                   k: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score N candidates (N, E) against one query (E,) with a batched
    dot and take the top k: (values (k,), int32 indices (k,), as the
    reference's), largest first
    and, among equal scores, lower index first, as the reference's
    ``jax.lax.top_k``.  ``torch.topk`` leaves the order of ties open, so
    the top k is taken over unique int64 keys: the score's bits mapped to
    an order-preserving int32 (with -0.0 read as 0.0), then N - 1 - index
    below them.  No host sync."""
    scores = (cand_emb @ query_vec[:, None])[:, 0]                      # (N,)
    bits = (scores + 0.0).view(torch.int32)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    n = scores.shape[0]
    below = n - 1 - torch.arange(n, device=scores.device)
    _, idx = torch.topk((bits.long() << 32) + below, k)
    return scores[idx], idx.to(torch.int32)
