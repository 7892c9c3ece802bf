"""Per-cell step builders (the single-device half of the reference's
``launch/steps.py``): for an (arch, shape) pair, the step function, its
abstract inputs and its donated arguments.

The reference's ``CellSpec.args`` are ``jax.ShapeDtypeStruct``s; here
they are ``device="meta"`` tensors (shapes and dtypes, no data), and the
shardings are None: the port runs on one device, and a ``mesh`` raises.
The GNN and websearch builders (``_build_gnn``, ``_build_websearch``)
are not ported yet and raise.

A train step takes its parameters and optimizer state as the
reference's donated arguments (``donate_argnums=(0, 1)``): it
overwrites them in place (``adamw_update_``) and returns them.  Every
step runs on the device its tensors lie on.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.configs.base import ArchDef, get_arch
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update_, clip_by_global_norm_)
from repro_torch.train.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["CellSpec", "build_cell", "REDUCED_SHAPES", "make_lm_train_step",
           "lm_loss_and_grads", "recsys_loss", "value_and_grad"]


@dataclasses.dataclass
class CellSpec:
    arch_id: str
    shape_name: str
    fn: Callable                     # the step
    args: Tuple[Any, ...]            # meta tensors (shapes and dtypes)
    in_shardings: Any                # None: one device
    out_shardings: Any
    donate_argnums: Tuple[int, ...] = ()
    static_note: str = ""


# Reduced per-kind shapes used by smoke tests (CPU, 1 device).
REDUCED_SHAPES = {
    "train": dict(global_batch=4, seq_len=64),
    "prefill": dict(global_batch=2, seq_len=64),
    "decode": dict(global_batch=4, seq_len=64),
    "train_graph": dict(n_nodes=128, n_edges=512, d_feat=16, n_classes=7),
    "train_minibatch": dict(n_nodes=256, n_edges=2048, batch_nodes=16,
                            fanout=(5, 3), d_feat=16, n_classes=7),
    "train_batched_graphs": dict(n_nodes=10, n_edges=20, batch=8, d_feat=16,
                                 n_classes=2),
    "train_recsys": dict(batch=64),
    "serve": dict(batch=32),
    "retrieval": dict(batch=1, n_candidates=2048),
    "serve_websearch": dict(query_batch=8),
    "train_websearch": dict(query_batch=8),
}


def _sd(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _dev(params) -> torch.device:
    return tree_leaves(params)[0].device


def value_and_grad(loss_fn: Callable, params):
    """(loss detached, grads: a tree like ``params``) of ``loss_fn(params)``
    (``jax.value_and_grad``).  The parameters themselves never require
    grad (a train step overwrites them); a leaf the loss does not use
    gets a zero gradient, as in JAX."""
    req = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = loss_fn(req)
    leaves = tree_leaves(req)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g.contiguous()
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


# ======================================================================== LM
def _lm_opt_cfg(reduced: bool) -> AdamWConfig:
    # bf16 moments halve optimizer memory on the full configs.
    return AdamWConfig(lr=1e-4, weight_decay=0.01,
                       state_dtype=torch.float32 if reduced else torch.bfloat16)


def lm_loss_and_grads(params, tokens, targets, cfg):
    """(loss, grads: a tree like ``params``) of the reference's train
    step before its clip.  With mb = ``cfg.microbatch`` > 1 the batch is
    cut into mb consecutive microbatches; each one's gradients are added
    to an accumulator in ``cfg.grad_accum_dtype`` (a float32 add, one
    cast), which is divided by mb at the end, as is the summed loss."""
    from repro_torch.models.transformer import lm_loss

    dev = _dev(params)
    tokens = torch.as_tensor(tokens, device=dev)
    targets = torch.as_tensor(targets, device=dev)
    mb = max(1, cfg.microbatch)

    def grads_of(tk, tg):
        return value_and_grad(lambda p: lm_loss(p, tk, tg, cfg, device=dev),
                              params)

    if mb == 1:
        return grads_of(tokens, targets)
    b = tokens.shape[0] // mb
    grads = tree_map(lambda p: torch.zeros(p.shape, dtype=cfg.grad_accum_dtype,
                                           device=dev), params)
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(mb):
        rows = slice(i * b, (i + 1) * b)
        l, g = grads_of(tokens[rows], targets[rows])
        tree_map(lambda a, gi: a.add_(gi), grads, g)   # float32 add, one cast
        loss = loss + l
        del g
    tree_map(lambda a: a.div_(mb), grads)
    return loss / mb, grads


def make_lm_train_step(cfg, opt_cfg: AdamWConfig):
    """Loss + grads (``lm_loss_and_grads``, with its microbatches) + clip
    at global norm 1 + AdamW, as the reference's single-device step.
    ``train_step(params, opt_state, tokens, targets)`` overwrites params
    and opt_state in place and returns (params, opt_state, {"loss",
    "grad_norm"})."""

    def train_step(params, opt_state, tokens, targets):
        loss, grads = lm_loss_and_grads(params, tokens, targets, cfg)
        norm = clip_by_global_norm_(grads, 1.0)
        adamw_update_(params, grads, opt_state, opt_cfg)
        return params, opt_state, {"loss": loss, "grad_norm": norm}

    return train_step


def _build_lm(arch: ArchDef, shape_name: str, reduced: bool) -> CellSpec:
    from repro_torch.models.transformer import (decode_step, init_kv_cache,
                                                init_params, prefill)

    cfg = arch.model_cfg(reduced)
    spec = arch.shape(shape_name)
    sp = dict(REDUCED_SHAPES[spec.kind]) if reduced else dict(spec.params)
    b, s = sp["global_batch"], sp["seq_len"]
    params_abs = init_params(cfg, device="meta")

    if spec.kind == "train":
        opt_cfg = _lm_opt_cfg(reduced)
        fn = make_lm_train_step(cfg, opt_cfg)
        args = (params_abs, adamw_init(params_abs, opt_cfg),
                _sd((b, s), torch.int32), _sd((b, s), torch.int32))
        return CellSpec(arch.arch_id, shape_name, fn, args, None, None,
                        donate_argnums=(0, 1))

    if spec.kind == "prefill":
        def fn(params, tokens):
            return prefill(params, tokens, cfg, device=_dev(params))

        args = (params_abs, _sd((b, s), torch.int32))
        return CellSpec(arch.arch_id, shape_name, fn, args, None, None)

    # decode (decode_32k / long_500k): one new token against an S-token
    # cache, which decode_step updates in place (donated)
    def fn(params, token, cache, pos):
        return decode_step(params, token, cache, pos, cfg, device=_dev(params))

    args = (params_abs, _sd((b,), torch.int32),
            init_kv_cache(cfg, b, s, device="meta"), _sd((b,), torch.int32))
    return CellSpec(arch.arch_id, shape_name, fn, args, None, None,
                    donate_argnums=(2,))


# ==================================================================== recsys
def recsys_loss(arch_id: str, cfg, params, *batch) -> torch.Tensor:
    """The loss of a recsys train cell: the CTR archs' BCE of
    (sparse, dense, labels); BERT4Rec's sampled softmax of (seq,
    mask_pos, mask_tgt, negs): each masked position's hidden state
    against its target item and the shared negatives."""
    from repro_torch.kernels.embedding_bag import take_rows
    from repro_torch.models import recsys as R

    dev = _dev(params)
    if arch_id != "bert4rec":
        sparse, dense, labels = batch
        return R.bce_loss(_ctr_forward(arch_id, cfg, params, sparse, dense),
                          torch.as_tensor(labels, device=dev))
    seq, mask_pos, mask_tgt, negs = (torch.as_tensor(x, device=dev)
                                     for x in batch)
    h = R.bert4rec_forward(params, seq, cfg, device=dev)       # (B, S, E)
    b, s, e = h.shape
    rows = torch.arange(b, device=dev)[:, None] * s + mask_pos.long()
    hm = take_rows(h.reshape(b * s, e), rows)                   # (B, M, E)
    emb = params["item_embed"]
    pos_e = take_rows(emb, mask_tgt.long())                     # (B, M, E)
    neg_e = take_rows(emb, negs.long())                         # (B, N, E)
    pos_s = torch.sum(hm * pos_e, -1)                           # (B, M)
    neg_s = torch.einsum("bme,bne->bmn", hm, neg_e)
    alls = torch.cat([pos_s[..., None], neg_s], -1)
    return -torch.mean(torch.log_softmax(alls.float(), dim=-1)[..., 0])


def _ctr_forward(arch_id: str, cfg, params, sparse, dense):
    from repro_torch.models import recsys as R

    dev = _dev(params)
    dense = torch.as_tensor(dense, device=dev)
    if arch_id == "wide-deep":
        return R.wide_deep_forward(params, sparse, cfg, dense, device=dev)
    if arch_id == "deepfm":
        return R.deepfm_forward(params, sparse, cfg, device=dev)
    return R.dcn_forward(params, sparse, cfg, dense, device=dev)


def _build_recsys(arch: ArchDef, shape_name: str, reduced: bool) -> CellSpec:
    from repro_torch.models import recsys as R

    spec = arch.shape(shape_name)
    kind = "train_recsys" if spec.kind == "train" else spec.kind
    sp = dict(REDUCED_SHAPES[kind]) if reduced else dict(spec.params)
    cfg = arch.model_cfg(reduced)
    opt_cfg = AdamWConfig(lr=1e-3)
    is_b4r = arch.arch_id == "bert4rec"

    if is_b4r:
        p_abs = R.bert4rec_init(cfg, device="meta")
    else:
        init = {"wide-deep": R.wide_deep_init, "deepfm": R.deepfm_init,
                "dcn-v2": R.dcn_init}[arch.arch_id]
        p_abs = init(cfg, device="meta")

    def ctr_forward(params, sparse, dense):
        return _ctr_forward(arch.arch_id, cfg, params, sparse, dense)

    n_dense = getattr(cfg, "n_dense", 0)

    if spec.kind == "train":
        def fn(params, opt_state, *batch):
            loss, grads = value_and_grad(
                lambda p: recsys_loss(arch.arch_id, cfg, p, *batch), params)
            adamw_update_(params, grads, opt_state, opt_cfg)
            return params, opt_state, loss

        b = sp["batch"]
        if is_b4r:
            n_mask, n_neg = 16, 256
            batch = (_sd((b, cfg.seq_len), torch.int32),
                     _sd((b, n_mask), torch.int32), _sd((b, n_mask), torch.int32),
                     _sd((b, n_neg), torch.int32))
        else:
            batch = (_sd((b, cfg.n_sparse), torch.int32),
                     _sd((b, max(n_dense, 1)), torch.float32),
                     _sd((b,), torch.float32))
        return CellSpec(arch.arch_id, shape_name, fn,
                        (p_abs, adamw_init(p_abs, opt_cfg), *batch), None, None,
                        donate_argnums=(0, 1))

    if spec.kind == "serve":
        b = sp["batch"]
        if is_b4r:
            def fn(params, seq):
                h = R.bert4rec_forward(params, seq, cfg, device=_dev(params))
                return _top100(R.bert4rec_score_items(params, h[:, -1], cfg))

            args = (p_abs, _sd((b, cfg.seq_len), torch.int32))
            return CellSpec(arch.arch_id, shape_name, fn, args, None, None)

        args = (p_abs, _sd((b, cfg.n_sparse), torch.int32),
                _sd((b, max(n_dense, 1)), torch.float32))
        return CellSpec(arch.arch_id, shape_name, ctr_forward, args, None, None)

    # retrieval: 1 query vs n_candidates, its top 100
    n_cand = sp["n_candidates"]
    if is_b4r:
        def fn(params, seq):
            h = R.bert4rec_forward(params, seq, cfg, device=_dev(params))
            return R.retrieval_topk(h[0, -1], params["item_embed"][: cfg.n_items])

        args = (p_abs, _sd((1, cfg.seq_len), torch.int32))
        return CellSpec(arch.arch_id, shape_name, fn, args, None, None)

    def fn(params, sparse, dense):
        scores = ctr_forward(params, sparse, dense)
        return _top100(scores)

    args = (p_abs, _sd((n_cand, cfg.n_sparse), torch.int32),
            _sd((n_cand, max(n_dense, 1)), torch.float32))
    return CellSpec(arch.arch_id, shape_name, fn, args, None, None)


def _top100(scores: torch.Tensor):
    """``jax.lax.top_k(scores, 100)`` over the last axis: largest first,
    ties to the lower index (a stable descending sort)."""
    v, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return v[..., :100], i[..., :100]


# =================================================================== dispatch
def build_cell(arch_id: str, shape_name: str, mesh=None, reduced: bool = False,
               cfg_override=None) -> CellSpec:
    """The (arch, shape) cell on one device.  Raises for a ``mesh`` (the
    sharded cells wait for the mesh port) and for the GNN and websearch
    families (their builders are not ported yet)."""
    if mesh is not None:
        raise NotImplementedError("a sharded cell waits for the mesh port")
    arch = get_arch(arch_id)
    if cfg_override is not None:
        arch = dataclasses.replace(arch, model_cfg=lambda reduced_: cfg_override)
    builders = {"lm": _build_lm, "recsys": _build_recsys}
    if arch.family not in builders:
        raise NotImplementedError(
            f"the {arch.family} cells (_build_{arch.family}) are not ported yet")
    return builders[arch.family](arch, shape_name, reduced)
