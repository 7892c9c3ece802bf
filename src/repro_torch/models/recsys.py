"""RecSys ranking models: Wide&Deep, DeepFM, DCN-v2, BERT4Rec (the
reference's ``models/recsys.py``, its mesh paths included).

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
take ``device="meta"``, shapes only).

With a ``mesh`` (a ``DeviceMesh`` with ``data`` and ``model`` axes) the
forwards run the reference's sharded path, rank by rank: the batch's
rows over the data axes, the tables' rows over ``model``
(``distributed/embedding_ops.py``: a masked local gather or bag and a
``psum``; under ``batch_over_model`` a reduce-scatter, after which the
tower runs on this rank's B/(data·model) rows), the dense towers
replicated.  Parameters and inputs are DTensors (placed by
``recsys_param_specs``) or global tensors; the outputs are DTensors
sharded over the batch's axes.  BERT4Rec at B = 1 (retrieval) keeps its
rows replicated and the table sharded.
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
           "bce_loss", "retrieval_topk", "Shards", "TABLES"]


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    """The reference's config.  ``batch_over_model``: on a mesh, the
    reduce-scatter lookup and a tower sharded over ``model`` too."""
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


@dataclasses.dataclass(frozen=True)
class Shards:
    """A forward's place on a mesh: the batch's rows lie over ``batch``
    (the data axes, or none), the tower's over ``tower`` (also ``model``
    under ``batch_over_model``).  ``Shards.of`` is None without a mesh."""
    mesh: Any
    batch: Tuple[str, ...]
    tower: Tuple[str, ...]

    @staticmethod
    def of(mesh, cfg=None, n_rows=None):
        if mesh is None:
            return None
        from repro_torch.distributed.sharding_rules import data_axes, mesh_shape

        batch = data_axes(mesh)
        shape = mesh_shape(mesh)
        size = 1
        for a in batch:
            size *= shape[a]
        if n_rows is not None and (n_rows % size or n_rows < size):
            batch = ()       # B=1 retrieval: rows replicate, the table stays sharded
        tower = batch + ("model",) if getattr(cfg, "batch_over_model", False) \
            else batch
        return Shards(mesh, batch, tower)

    def spec(self, axes, ndim: int):
        from repro_torch.distributed.sharding_rules import P

        return P(axes if axes else None, *([None] * (ndim - 1)))


# The row-sharded tables (``recsys_param_specs``), read through the
# sharded lookup and bag; every other leaf is a dense, replicated one.
TABLES = ("embed", "item_embed", "wide", "first_order")


def _local_params(params: Dict, sh: Optional[Shards]) -> Dict:
    """This rank's blocks: the tables' rows over ``model``, the rest
    whole (``shard_map``'s in_specs)."""
    if sh is None:
        return params
    from repro_torch.distributed.collectives import shard_in
    from repro_torch.distributed.sharding_rules import P
    from repro_torch.train.tree import tree_map

    return {k: (shard_in(v, sh.mesh, P("model", None)) if k in TABLES
                else tree_map(lambda t: shard_in(t, sh.mesh, P()), v))
            for k, v in params.items()}


def _rows(x, sh: Optional[Shards], dev, tower: bool = False) -> torch.Tensor:
    """An input's rows on this rank: the batch's (or the tower's)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        x = torch.as_tensor(x, device=dev)
    if sh is None:
        return x
    from repro_torch.distributed.collectives import shard_in

    return shard_in(x, sh.mesh, sh.spec(sh.tower if tower else sh.batch, x.dim()))


def _to_tower(x: torch.Tensor, sh: Optional[Shards]) -> torch.Tensor:
    """The batch's rows, replicated over ``model``, cut to the tower's."""
    if sh is None or sh.tower == sh.batch:
        return x
    from repro_torch.distributed.collectives import scatter_replicated

    return scatter_replicated(x, sh.mesh, "model", 0)


def _out(x: torch.Tensor, sh: Optional[Shards]):
    """The tower's rows as the DTensor over its axes."""
    if sh is None:
        return x
    from repro_torch.distributed.collectives import shard_out

    return shard_out(x, sh.mesh, sh.spec(sh.tower, x.dim()))


def _lookup(table: torch.Tensor, idx: torch.Tensor,
            sh: Optional[Shards]) -> torch.Tensor:
    """(B, F) global row ids → (B, F, E); on a mesh, the row-sharded
    lookup (reduce-scattered under ``batch_over_model``)."""
    if sh is None:
        return take_rows(table, idx)
    from repro_torch.distributed.embedding_ops import (lookup_local,
                                                       lookup_rs_local)

    if sh.tower != sh.batch:
        return lookup_rs_local(table, idx, sh.mesh)
    return lookup_local(table, idx, sh.mesh)


def _bag_sum(table: torch.Tensor, idx: torch.Tensor,
             sh: Optional[Shards]) -> torch.Tensor:
    if sh is None:
        return embedding_bag(table, idx, mode="sum")
    from repro_torch.distributed.embedding_ops import bag_sum_local

    return _to_tower(bag_sum_local(table, idx, sh.mesh), sh)


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
    sh = Shards.of(mesh, cfg)
    p = _local_params(params, sh)
    idx = _global_ids(_rows(sparse_ids, sh, dev), cfg, dev)
    wide = _bag_sum(p["wide"], idx, sh)[:, 0]                           # (B,)
    emb = _lookup(p["embed"], idx, sh)                             # (B, F, E)
    deep_in = emb.reshape(emb.shape[0], -1)
    if cfg.n_dense:
        dense = _rows(dense, sh, dev, tower=True)
        deep_in = torch.cat([dense, deep_in], dim=1)
        wide = wide + (dense @ p["wide_dense"])[:, 0]
    deep = _mlp_apply(p["mlp"], deep_in, len(cfg.mlp_dims) + 1)[:, 0]
    return _out(wide + deep + p["bias"], sh)


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
    sh = Shards.of(mesh, cfg)
    p = _local_params(params, sh)
    idx = _global_ids(_rows(sparse_ids, sh, dev), cfg, dev)
    first = _bag_sum(p["first_order"], idx, sh)[:, 0]
    emb = _lookup(p["embed"], idx, sh)                             # (B, F, E)
    # FM second order: ½((Σv)² − Σv²) summed over dims
    s = emb.sum(1)
    fm = 0.5 * (s * s - (emb * emb).sum(1)).sum(-1)
    deep = _mlp_apply(p["mlp"], emb.reshape(emb.shape[0], -1),
                      len(cfg.mlp_dims) + 1)[:, 0]
    return _out(first + fm + deep + p["bias"], sh)


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
    sh = Shards.of(mesh, cfg)
    p = _local_params(params, sh)
    idx = _global_ids(_rows(sparse_ids, sh, dev), cfg, dev)
    emb = _lookup(p["embed"], idx, sh)
    emb = emb.reshape(emb.shape[0], -1)
    x0 = torch.cat([_rows(dense, sh, dev, tower=True), emb], dim=1)     # (B, d0)
    x = x0
    for i in range(cfg.n_cross_layers):
        x = x0 * (x @ p["cross"][f"w{i}"] + p["cross"][f"b{i}"]) + x
    deep = _mlp_apply(p["mlp"], x0, len(cfg.mlp_dims), final_relu=True)
    return _out((torch.cat([x, deep], dim=1) @ p["head"])[:, 0], sh)


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
    """Bidirectional encoder.  item_seq (B, S) int → hidden (B, S, E).
    On a mesh the rows lie over the data axes, or, where B does not
    divide over them (B = 1 retrieval), on every rank."""
    dev = entry_device(params["item_embed"], mesh, device)
    sh = Shards.of(mesh, n_rows=item_seq.shape[0])
    params = _local_params(params, sh)
    item_seq = _rows(item_seq, sh, dev)
    b, s = item_seq.shape
    e, h = cfg.embed_dim, cfg.n_heads
    dh = e // h
    x = (_lookup(params["item_embed"], item_seq.long(), sh)
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
    return _out(layer_norm(x, params["ln_f_w"], params["ln_f_b"]), sh)


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
