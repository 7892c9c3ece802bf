"""Per-cell step builders (the reference's ``launch/steps.py``): for an
(arch, shape) pair, the step function, its abstract inputs, their
shardings and its donated arguments.

The reference's ``CellSpec.args`` are ``jax.ShapeDtypeStruct``s; here
they are ``device="meta"`` tensors (shapes and dtypes, no data, at the
global shapes).  Every family has its builder: ``_build_lm``,
``_build_gnn``, ``_build_recsys`` and ``_build_websearch``.  Where a
reference step takes a ``jax.random`` key (the websearch train step),
the port's takes the draws that key would give (``core/qlearning.py``'s
``Draws``).

With a ``mesh`` (a ``DeviceMesh``: ``launch/mesh.py``) every cell runs
sharded, rank by rank, and ``in_shardings`` / ``out_shardings`` are
trees of ``NamedSharding``s with the reference's specs (spec and mesh;
their ``placements`` are the DTensor ones): the arguments are DTensors
placed by them (``distributed/elastic.py``'s ``reshard_tree``) or global
tensors, and the outputs DTensors.  The LM cells run the Megatron
tensor, sequence and FSDP/ZeRO layouts of ``models/transformer.py``,
the GNN cells shard their edges over every axis (``models/gnn.py``).

A train step takes its parameters and optimizer state as the
reference's donated arguments (``donate_argnums=(0, 1)``): it
overwrites them in place (``adamw_update_``) and returns them.  Every
step runs on the device its tensors lie on.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Tuple

import torch

from repro_torch.configs.base import ArchDef, get_arch
from repro_torch.distributed.sharding_rules import (P, NamedSharding,
                                                    data_axes, gnn_param_specs,
                                                    kv_cache_specs,
                                                    lm_param_specs, mesh_shape,
                                                    recsys_param_specs,
                                                    zero1_state_specs)
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update_, clip_by_global_norm_)
from repro_torch.train.tree import (leaf_paths, tree_leaves, tree_map,
                                    tree_unflatten)

__all__ = ["CellSpec", "build_cell", "REDUCED_SHAPES", "make_lm_train_step",
           "lm_loss_and_grads", "recsys_loss", "recsys_loss_and_grads",
           "value_and_grad", "sharded_value_and_grad", "ce_loss",
           "minibatch_budgets"]


@dataclasses.dataclass
class CellSpec:
    arch_id: str
    shape_name: str
    fn: Callable                     # the step
    args: Tuple[Any, ...]            # meta tensors (shapes and dtypes)
    in_shardings: Any                # NamedSharding trees; None: one device
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


def _named(mesh, spec_tree_):
    if mesh is None:
        return None
    return tree_map(lambda sp: NamedSharding(mesh, sp), spec_tree_)


def _dp(mesh) -> Tuple[str, ...]:
    return data_axes(mesh) if mesh is not None else ()


def _dp_size(mesh) -> int:
    n = 1
    for a in _dp(mesh):
        n *= mesh_shape(mesh)[a]
    return n


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


def lm_loss_and_grads(params, tokens, targets, cfg, mesh=None):
    """(loss, grads: a tree like ``params``) of the reference's train
    step before its clip.  With mb = ``cfg.microbatch`` > 1 the batch is
    cut into mb consecutive microbatches; each one's gradients are added
    to an accumulator in ``cfg.grad_accum_dtype`` (a float32 add, one
    cast), which is divided by mb at the end, as is the summed loss.

    On a ``mesh``: ``params`` are DTensors laid out by ``lm_param_specs``
    and tokens/targets global (or DTensors); each microbatch's rows lie
    over the data axes as the reference shards them.  Returns (this
    rank's loss value; grads, this rank's blocks of the global gradient:
    each leaf's local gradient summed over ``lm_grad_axes`` per
    microbatch, then accumulated)."""
    from repro_torch.models.transformer import lm_loss

    if mesh is not None:
        return _lm_loss_and_grads_mesh(params, tokens, targets, cfg, mesh)
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


def _lm_loss_and_grads_mesh(params, tokens, targets, cfg, mesh):
    import torch.distributed as dist

    from repro_torch.models.transformer import (MeshLM, _global, lm_grad_axes,
                                                lm_loss_local, local_params)

    if not all(_is_dtensor(p) for p in tree_leaves(params)):
        raise TypeError("a sharded step takes DTensor parameters "
                        "(distributed.reshard_tree)")
    lp = local_params(params, cfg, mesh)
    specs = tree_leaves(lm_param_specs(params, mesh_shape(mesh)["model"],
                                       cfg.fsdp, cfg.zero3))
    paths, leaves = leaf_paths(params), tree_leaves(lp)
    dev = leaves[0].device
    tokens, targets = _global(tokens, dev).long(), _global(targets, dev).long()
    mb = max(1, cfg.microbatch)
    b, s = tokens.shape[0] // mb, tokens.shape[1]
    ml = MeshLM.of(cfg, mesh, b, s)
    axes = lm_grad_axes(cfg, ml)
    acc, loss = None, torch.zeros((), dtype=torch.float32, device=dev)
    for i in range(mb):
        rows = slice(i * b, (i + 1) * b)
        req = [t.detach().requires_grad_() for t in leaves]
        lg, value = lm_loss_local(cfg, tree_unflatten(lp, req),
                                  ml.rows_block(tokens[rows]),
                                  ml.rows_block(targets[rows]), ml, b * s)
        grads = torch.autograd.grad(lg, req, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g.contiguous()
                 for t, g in zip(req, grads)]
        for g, path, spec in zip(grads, paths, specs):
            for a in axes(path, spec):
                dist.all_reduce(g, group=mesh.get_group(a))
        loss = loss + value
        if mb == 1:
            acc = grads
        elif acc is None:
            acc = [g.to(cfg.grad_accum_dtype) for g in grads]
        else:
            for a, g in zip(acc, grads):
                a.add_(g)                              # float32 add, one cast
        del grads
    if mb > 1:
        for a in acc:
            a.div_(mb)
    return loss / mb, tree_unflatten(params, acc)


def make_lm_train_step(cfg, opt_cfg: AdamWConfig, mesh=None, param_specs=None):
    """Loss + grads (``lm_loss_and_grads``, with its microbatches) + clip
    at global norm 1 + AdamW, as the reference's step.
    ``train_step(params, opt_state, tokens, targets)`` overwrites params
    and opt_state in place and returns (params, opt_state, {"loss",
    "grad_norm"}).  On a ``mesh`` the state is DTensors laid out by
    ``param_specs`` (``lm_param_specs``) and its ZeRO-1 moments
    (``zero1_state_specs``): the norm is summed over each leaf's own
    axes, each rank updates its blocks, and loss and norm come back as
    replicated DTensors (the loss this rank's value)."""

    def train_step(params, opt_state, tokens, targets):
        loss, grads = lm_loss_and_grads(params, tokens, targets, cfg, mesh)
        if mesh is None:
            norm = clip_by_global_norm_(grads, 1.0)
            adamw_update_(params, grads, opt_state, opt_cfg)
            return params, opt_state, {"loss": loss, "grad_norm": norm}
        from repro_torch.distributed.collectives import shard_out

        specs = param_specs or lm_param_specs(
            params, mesh_shape(mesh)["model"], cfg.fsdp, cfg.zero3)
        norm = clip_by_global_norm_(grads, 1.0, mesh=mesh, specs=specs)
        adamw_update_(_local_tree(params), grads, _local_tree(opt_state), opt_cfg,
                      mesh=mesh, param_specs=specs,
                      state_specs=zero1_state_specs(params, specs, mesh))
        return params, opt_state, {"loss": shard_out(loss, mesh, P()),
                                   "grad_norm": shard_out(norm, mesh, P())}

    return train_step


def _build_lm(arch: ArchDef, shape_name: str, mesh, reduced: bool) -> CellSpec:
    from repro_torch.models.transformer import (decode_step, init_kv_cache,
                                                init_params, prefill)

    cfg = arch.model_cfg(reduced)
    spec = arch.shape(shape_name)
    sp = dict(REDUCED_SHAPES[spec.kind]) if reduced else dict(spec.params)
    b, s = sp["global_batch"], sp["seq_len"]
    dp = _dp(mesh)
    dpn = dp if dp else None
    params_abs = init_params(cfg, device="meta")
    p_specs = lm_param_specs(params_abs, mesh_shape(mesh)["model"] if mesh else None,
                             cfg.fsdp, cfg.zero3)

    def dev_of(params):
        return None if mesh is not None else _dev(params)

    if spec.kind == "train":
        opt_cfg = _lm_opt_cfg(reduced)
        fn = make_lm_train_step(cfg, opt_cfg, mesh=mesh, param_specs=p_specs)
        args = (params_abs, adamw_init(params_abs, opt_cfg),
                _sd((b, s), torch.int32), _sd((b, s), torch.int32))
        if mesh is None:
            return CellSpec(arch.arch_id, shape_name, fn, args, None, None,
                            donate_argnums=(0, 1))
        mom_specs = zero1_state_specs(params_abs, p_specs, mesh)
        o_specs = {"mu": mom_specs, "nu": mom_specs, "count": P()}
        tok_axes = dp + ("model",) if cfg.zero3 and dp else dp
        tok_spec = P(tok_axes if tok_axes else None, None)
        in_sh = (_named(mesh, p_specs), _named(mesh, o_specs),
                 _named(mesh, tok_spec), _named(mesh, tok_spec))
        out_sh = (_named(mesh, p_specs), _named(mesh, o_specs),
                  _named(mesh, {"loss": P(), "grad_norm": P()}))
        return CellSpec(arch.arch_id, shape_name, fn, args, in_sh, out_sh,
                        donate_argnums=(0, 1))

    cache_abs = init_kv_cache(cfg, b, s, device="meta")
    c_specs = kv_cache_specs(cache_abs, mesh) if mesh is not None else None
    if spec.kind == "prefill":
        def fn(params, tokens):
            return prefill(params, tokens, cfg, mesh=mesh, device=dev_of(params))

        args = (params_abs, _sd((b, s), torch.int32))
        in_sh = (_named(mesh, p_specs), _named(mesh, P(dpn, None)))
        out_sh = ((_named(mesh, P(dpn, "model")), _named(mesh, c_specs))
                  if mesh is not None else None)
        return CellSpec(arch.arch_id, shape_name, fn, args, in_sh, out_sh)

    # decode (decode_32k / long_500k): one new token against an S-token
    # cache, which decode_step updates in place (donated)
    def fn(params, token, cache, pos):
        return decode_step(params, token, cache, pos, cfg, mesh=mesh,
                           device=dev_of(params))

    n = _dp_size(mesh)
    bspec = P(dp) if (mesh is not None and b % n == 0 and b >= n) else P()
    args = (params_abs, _sd((b,), torch.int32), cache_abs, _sd((b,), torch.int32))
    in_sh = (_named(mesh, p_specs), _named(mesh, bspec), _named(mesh, c_specs),
             _named(mesh, bspec))
    out_sh = ((_named(mesh, P(bspec[0] if len(bspec) else None, "model")),
               _named(mesh, c_specs)) if mesh is not None else None)
    return CellSpec(arch.arch_id, shape_name, fn, args, in_sh, out_sh,
                    donate_argnums=(2,))


# ======================================================================= GNN
def ce_loss(logits, labels, mask) -> torch.Tensor:
    """The GNN cells' masked mean cross-entropy of (N, C) logits."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    gold = logp.gather(1, labels.long()[:, None])[:, 0]
    return -torch.sum(gold * mask) / torch.clamp(mask.sum(), min=1.0)


def minibatch_budgets(batch_nodes: int, fanout) -> Tuple[int, int, int, int]:
    """The minibatch cell's fixed budgets (e1, fr1, e0, fr0): the
    seeds' block has at most e1 edges into a frontier of fr1 rows, the
    inner block e0 edges into fr0 rows; a sampler pads up to them (src
    fr0 or fr1, the dummy row; dst n_dst, the dummy segment)."""
    f_out, f_in = fanout                   # e.g. (15, 10): inner, outer
    e1 = batch_nodes * f_in
    fr1 = batch_nodes + e1
    e0 = fr1 * f_out
    return e1, fr1, e0, fr1 + e0


def _build_gnn(arch: ArchDef, shape_name: str, mesh, reduced: bool) -> CellSpec:
    """The GraphSAGE cells.  On a ``mesh`` the edges (padded to a multiple
    of the rank count, as the reference's ``pad_e``) lie over every axis,
    ``P(None, all axes)`` (the minibatch's edge vectors ``P(all axes)``),
    and the rest is replicated, the weights laid out by
    ``gnn_param_specs``.  A step gathers the weights' blocks, runs the
    forward and backward on whole parameters over this rank's edges
    (``models/gnn.py``), updates the whole parameters and the replicated
    moments (the same bits on every rank) and keeps its blocks."""
    from repro_torch.models.gnn import (SAGEConfig, sage_block_forward,
                                        sage_full_forward, sage_graph_forward,
                                        sage_init)

    spec = arch.shape(shape_name)
    sp = dict(REDUCED_SHAPES[spec.kind]) if reduced else dict(spec.params)
    base = arch.model_cfg(reduced)
    cfg = SAGEConfig(d_in=sp["d_feat"], d_hidden=base.d_hidden,
                     n_classes=sp["n_classes"], n_layers=base.n_layers,
                     aggregator=base.aggregator)
    opt_cfg = AdamWConfig(lr=1e-3)
    p_abs = sage_init(cfg, device="meta")
    shape = mesh_shape(mesh) if mesh is not None else {}
    all_axes = _dp(mesh) + ("model",) if mesh is not None else ()
    n_dev = math.prod(shape.values()) if shape else 1
    p_specs = gnn_param_specs(p_abs, shape.get("model"))
    edge_spec = P(None, all_axes if all_axes else None)
    evec = P(all_axes if all_axes else None)

    def pad_e(e: int) -> int:
        return ((e + n_dev - 1) // n_dev) * n_dev

    def replicated(tree):
        return tree_map(lambda _: P(), tree)

    def step(params, opt_state, loss_fn, specs):
        if mesh is None:
            loss, grads = value_and_grad(loss_fn, params)
            adamw_update_(params, grads, opt_state, opt_cfg)
            return loss
        local = _local_tree(params)
        whole = tree_map(lambda t, sp_: _gather_block(t, mesh, sp_), local, specs)
        loss, grads = value_and_grad(loss_fn, whole)
        adamw_update_(whole, grads, _local_tree(opt_state), opt_cfg)
        with torch.no_grad():
            tree_map(lambda t, w, sp_: t.copy_(shard_in_(w, sp_)), local, whole,
                     specs)
        return loss

    def shard_in_(x, spec_):
        from repro_torch.distributed.collectives import shard_in
        return shard_in(x, mesh, spec_)

    def on(params, pairs):
        dev = _dev(params)
        if mesh is None:
            return [torch.as_tensor(x, device=dev) for x, _ in pairs]
        return [shard_in_(x if _is_dtensor(x) else torch.as_tensor(x, device=dev),
                          spec_) for x, spec_ in pairs]

    if spec.kind == "train_graph":
        n, e = sp["n_nodes"], pad_e(sp["n_edges"])

        def fn(params, opt_state, feats, edges, labels, mask):
            feats, edges, labels, mask = on(params, [
                (feats, P()), (edges, edge_spec), (labels, P()), (mask, P())])
            loss = step(params, opt_state, lambda p: ce_loss(
                sage_full_forward(p, cfg, feats, edges, mesh=mesh), labels, mask),
                p_specs)
            return params, opt_state, loss

        opt = adamw_init(p_abs, opt_cfg)
        args = (p_abs, opt, _sd((n, sp["d_feat"]), torch.float32),
                _sd((2, e), torch.int32), _sd((n,), torch.int32),
                _sd((n,), torch.float32))
        in_sh = (_named(mesh, p_specs), _named(mesh, replicated(opt)),
                 _named(mesh, P()), _named(mesh, edge_spec), _named(mesh, P()),
                 _named(mesh, P()))
        return CellSpec(arch.arch_id, shape_name, fn, args, in_sh, None,
                        donate_argnums=(0, 1))

    if spec.kind == "train_minibatch":
        bn = sp["batch_nodes"]
        e1, fr1, e0, fr0 = minibatch_budgets(bn, sp["fanout"])

        def fn(params, opt_state, feats, src0, dst0, src1, dst1, labels):
            feats, src0, dst0, src1, dst1, labels = on(params, [
                (feats, P()), (src0, evec), (dst0, evec), (src1, evec),
                (dst1, evec), (labels, P())])
            blocks = [(src0, dst0, fr1), (src1, dst1, bn)]
            ones = torch.ones((bn,), dtype=torch.float32, device=feats.device)
            loss = step(params, opt_state, lambda p: ce_loss(
                sage_block_forward(p, cfg, feats, blocks, mesh=mesh), labels, ones),
                p_specs)
            return params, opt_state, loss

        opt = adamw_init(p_abs, opt_cfg)
        e0p, e1p = pad_e(e0), pad_e(e1)
        args = (p_abs, opt, _sd((fr0, sp["d_feat"]), torch.float32),
                _sd((e0p,), torch.int32), _sd((e0p,), torch.int32),
                _sd((e1p,), torch.int32), _sd((e1p,), torch.int32),
                _sd((bn,), torch.int32))
        in_sh = (_named(mesh, p_specs), _named(mesh, replicated(opt)),
                 _named(mesh, P()), _named(mesh, evec), _named(mesh, evec),
                 _named(mesh, evec), _named(mesh, evec), _named(mesh, P()))
        return CellSpec(arch.arch_id, shape_name, fn, args, in_sh, None,
                        donate_argnums=(0, 1))

    if spec.kind != "train_batched_graphs":
        raise ValueError(spec.kind)
    # molecule: block-diagonal batches of small graphs, a readout per graph
    bsz, npg, epg = sp["batch"], sp["n_nodes"], sp["n_edges"]
    n, e = bsz * npg, pad_e(bsz * epg)
    readout_abs = {"w": _sd((cfg.n_classes, sp["n_classes"]), torch.float32),
                   "b": _sd((sp["n_classes"],), torch.float32)}

    def fn(params, readout, opt_state, feats, edges, graph_id, labels):
        feats, edges, graph_id, labels = on(params, [
            (feats, P()), (edges, edge_spec), (graph_id, P()), (labels, P())])
        ones = torch.ones((bsz,), dtype=torch.float32, device=feats.device)
        loss = step((params, readout), opt_state, lambda pr: ce_loss(
            sage_graph_forward(pr[0], cfg, feats, edges, graph_id, bsz, pr[1],
                               mesh=mesh), labels, ones),
            (p_specs, replicated(readout_abs)))
        return params, readout, opt_state, loss

    opt = adamw_init((p_abs, readout_abs), opt_cfg)
    args = (p_abs, readout_abs, opt,
            _sd((n, sp["d_feat"]), torch.float32), _sd((2, e), torch.int32),
            _sd((n,), torch.int32), _sd((bsz,), torch.int32))
    in_sh = (_named(mesh, p_specs), _named(mesh, replicated(readout_abs)),
             _named(mesh, replicated(opt)), _named(mesh, P()),
             _named(mesh, edge_spec), _named(mesh, P()), _named(mesh, P()))
    return CellSpec(arch.arch_id, shape_name, fn, args, in_sh, None,
                    donate_argnums=(0, 1, 2))


def _gather_block(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    """The whole tensor of this rank's block ``t`` under ``spec``: an
    all-gather over each axis that splits a dim (no gradient)."""
    from repro_torch.distributed.collectives import all_gather

    with torch.no_grad():
        for d, e in reversed(list(enumerate(spec))):
            for a in reversed(e if isinstance(e, tuple) else
                              (() if e is None else (e,))):
                t = all_gather(t, mesh, a, d)
    return t.contiguous()


# ==================================================================== recsys
def recsys_loss(arch_id: str, cfg, params, *batch, mesh=None) -> torch.Tensor:
    """The loss of a recsys train cell: the CTR archs' BCE of
    (sparse, dense, labels); BERT4Rec's sampled softmax of (seq,
    mask_pos, mask_tgt, negs): each masked position's hidden state
    against its target item and the shared negatives.  On a ``mesh``,
    this rank's part: the sum over its rows divided by the global count,
    so that the parts of the ranks along the batch's axes add up to the
    mean."""
    from repro_torch.distributed.collectives import shard_in
    from repro_torch.kernels.embedding_bag import take_rows
    from repro_torch.models import recsys as R

    dev = _dev(params)
    if arch_id != "bert4rec":
        sparse, dense, labels = batch
        logits = _ctr_forward(arch_id, cfg, params, sparse, dense, mesh)
        labels = torch.as_tensor(labels, device=dev)
        if mesh is None:
            return R.bce_loss(logits, labels)
        sh = R.Shards.of(mesh, cfg)
        local = logits.to_local()
        terms = R.bce_loss(local, shard_in(labels, mesh, sh.spec(sh.tower, 1)))
        return terms * local.shape[0] / labels.shape[0]
    seq, mask_pos, mask_tgt, negs = (torch.as_tensor(x, device=dev)
                                     for x in batch)
    h = R.bert4rec_forward(params, seq, cfg, mesh=mesh, device=dev.type)
    emb = params["item_embed"]
    if mesh is not None:
        sh = R.Shards.of(mesh, n_rows=seq.shape[0])
        h = h.to_local()
        mask_pos, mask_tgt, negs = (shard_in(x, mesh, sh.spec(sh.batch, 2))
                                    for x in (mask_pos, mask_tgt, negs))
        emb = shard_in(emb, mesh, P())       # whole: the loss reads any row
    b, s, e = h.shape
    rows = torch.arange(b, device=dev)[:, None] * s + mask_pos.long()
    hm = take_rows(h.reshape(b * s, e), rows)                   # (B, M, E)
    pos_e = take_rows(emb, mask_tgt.long())                     # (B, M, E)
    neg_e = take_rows(emb, negs.long())                         # (B, N, E)
    pos_s = torch.sum(hm * pos_e, -1)                           # (B, M)
    neg_s = torch.einsum("bme,bne->bmn", hm, neg_e)
    alls = torch.cat([pos_s[..., None], neg_s], -1)
    loss = -torch.mean(torch.log_softmax(alls.float(), dim=-1)[..., 0])
    if mesh is None:
        return loss
    return loss * b / seq.shape[0]


def recsys_loss_and_grads(arch_id: str, cfg, params, *batch, mesh=None):
    """(loss, grads) of a recsys train cell.  On a ``mesh`` the grads are
    this rank's blocks of the global gradient: a table's summed over the
    data axes, which split the batch that reaches it; a dense leaf's also
    over ``model`` under ``batch_over_model``, where the tower's rows lie
    over it."""
    def loss_fn(p):
        return recsys_loss(arch_id, cfg, p, *batch, mesh=mesh)

    if mesh is None:
        return value_and_grad(loss_fn, params)
    from repro_torch.models import recsys as R

    dp = data_axes(mesh)
    tower = dp + ("model",) if getattr(cfg, "batch_over_model", False) else dp

    def grad_axes(path):
        # the reduce-scatter's backward gathers the rows back over model
        return dp if path.split("/")[0] in R.TABLES else tower

    return sharded_value_and_grad(loss_fn, params, mesh, grad_axes, tower)


def _ctr_forward(arch_id: str, cfg, params, sparse, dense, mesh=None):
    from repro_torch.models import recsys as R

    dev = _dev(params)
    if not _is_dtensor(dense):
        dense = torch.as_tensor(dense, device=dev)
    if arch_id == "wide-deep":
        return R.wide_deep_forward(params, sparse, cfg, dense, mesh=mesh,
                                   device=dev.type)
    if arch_id == "deepfm":
        return R.deepfm_forward(params, sparse, cfg, mesh=mesh, device=dev.type)
    return R.dcn_forward(params, sparse, cfg, dense, mesh=mesh, device=dev.type)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def sharded_value_and_grad(loss_fn: Callable, params, mesh, grad_axes,
                           loss_axes):
    """``value_and_grad`` of a sharded loss, rank by rank: ``params`` are
    DTensors; ``loss_fn`` gets them again as DTensors over this rank's
    blocks, which need grad, and returns this rank's part of the loss.
    Each leaf's local gradient is summed over ``grad_axes(path)``: the
    mesh axes over which the batch that reaches the leaf is split and the
    leaf is not.  Returns (loss: the parts summed over ``loss_axes``;
    grads: a tree of local blocks)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    if not all(_is_dtensor(p) for p in tree_leaves(params)):
        raise TypeError("a sharded step takes DTensor parameters "
                        "(distributed.reshard_tree)")
    local = tree_map(lambda p: p.to_local().detach().requires_grad_(), params)
    wrapped = tree_map(lambda l, p: DTensor.from_local(
        l, mesh, p.placements, run_check=False), local, params)
    loss = loss_fn(wrapped)
    leaves = tree_leaves(local)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g.contiguous()
             for p, g in zip(leaves, grads)]
    for g, path in zip(grads, leaf_paths(params)):
        for a in grad_axes(path):
            dist.all_reduce(g, group=mesh.get_group(a))
    loss = loss.detach().clone()
    for a in loss_axes:
        dist.all_reduce(loss, group=mesh.get_group(a))
    return loss, tree_unflatten(params, grads)


def _local_tree(tree):
    """Each DTensor leaf's local block (the tensor itself, so that an
    in-place update writes the DTensor), other leaves as they are."""
    with torch.no_grad():
        return tree_map(lambda t: t.to_local() if _is_dtensor(t) else t, tree)


def _build_recsys(arch: ArchDef, shape_name: str, mesh, reduced: bool) -> CellSpec:
    from repro_torch.models import recsys as R

    spec = arch.shape(shape_name)
    kind = "train_recsys" if spec.kind == "train" else spec.kind
    sp = dict(REDUCED_SHAPES[kind]) if reduced else dict(spec.params)
    cfg = arch.model_cfg(reduced)
    opt_cfg = AdamWConfig(lr=1e-3)
    is_b4r = arch.arch_id == "bert4rec"
    dp = _dp(mesh)
    bspec = P(dp if dp else None, None)

    if is_b4r:
        p_abs = R.bert4rec_init(cfg, device="meta")
    else:
        init = {"wide-deep": R.wide_deep_init, "deepfm": R.deepfm_init,
                "dcn-v2": R.dcn_init}[arch.arch_id]
        p_abs = init(cfg, device="meta")
    p_specs = recsys_param_specs(p_abs, mesh_shape(mesh)["model"] if mesh else None)

    def ctr_forward(params, sparse, dense):
        return _ctr_forward(arch.arch_id, cfg, params, sparse, dense, mesh)

    def items(params):
        """The item table's first n_items rows, whole on every rank."""
        emb = params["item_embed"]
        if mesh is not None:
            from repro_torch.distributed.collectives import shard_in
            emb = shard_in(emb, mesh, P())
        return emb[: cfg.n_items]

    def local(x):
        return x.to_local() if mesh is not None else x

    n_dense = getattr(cfg, "n_dense", 0)
    dev_of = (lambda params: _dev(params).type)

    if spec.kind == "train":
        def fn(params, opt_state, *batch):
            loss, grads = recsys_loss_and_grads(arch.arch_id, cfg, params,
                                                *batch, mesh=mesh)
            if mesh is None:
                adamw_update_(params, grads, opt_state, opt_cfg)
            else:
                adamw_update_(_local_tree(params), grads,
                              _local_tree(opt_state), opt_cfg)
            return params, opt_state, loss

        b = sp["batch"]
        if is_b4r:
            n_mask, n_neg = 16, 256
            batch = (_sd((b, cfg.seq_len), torch.int32),
                     _sd((b, n_mask), torch.int32), _sd((b, n_mask), torch.int32),
                     _sd((b, n_neg), torch.int32))
            b_specs = (bspec,) * 4
        else:
            batch = (_sd((b, cfg.n_sparse), torch.int32),
                     _sd((b, max(n_dense, 1)), torch.float32),
                     _sd((b,), torch.float32))
            b_specs = (bspec, bspec, P(dp if dp else None))
        o_specs = {"mu": p_specs, "nu": p_specs, "count": P()}
        in_sh = (_named(mesh, p_specs), _named(mesh, o_specs),
                 *(_named(mesh, x) for x in b_specs))
        return CellSpec(arch.arch_id, shape_name, fn,
                        (p_abs, adamw_init(p_abs, opt_cfg), *batch),
                        in_sh if mesh else None, None, donate_argnums=(0, 1))

    if spec.kind == "serve":
        b = sp["batch"]
        if is_b4r:
            def fn(params, seq):
                h = R.bert4rec_forward(params, seq, cfg, mesh=mesh,
                                       device=dev_of(params))
                out = _top100(local(h)[:, -1] @ items(params).T)
                if mesh is None:
                    return out
                sh = R.Shards.of(mesh, n_rows=seq.shape[0])
                return tuple(_out_rows(x, sh) for x in out)

            args = (p_abs, _sd((b, cfg.seq_len), torch.int32))
            in_sh = (_named(mesh, p_specs), _named(mesh, bspec))
            return CellSpec(arch.arch_id, shape_name, fn, args,
                            in_sh if mesh else None, None)

        args = (p_abs, _sd((b, cfg.n_sparse), torch.int32),
                _sd((b, max(n_dense, 1)), torch.float32))
        in_sh = (_named(mesh, p_specs), _named(mesh, bspec), _named(mesh, bspec))
        return CellSpec(arch.arch_id, shape_name, ctr_forward, args,
                        in_sh if mesh else None, None)

    # retrieval: 1 query vs n_candidates, its top 100
    n_cand = sp["n_candidates"]
    if is_b4r:
        def fn(params, seq):
            h = R.bert4rec_forward(params, seq, cfg, mesh=mesh,
                                   device=dev_of(params))
            return R.retrieval_topk(local(h)[0, -1], items(params))

        args = (p_abs, _sd((1, cfg.seq_len), torch.int32))
        in_sh = (_named(mesh, p_specs), _named(mesh, P()))
        return CellSpec(arch.arch_id, shape_name, fn, args,
                        in_sh if mesh else None, None)

    def fn(params, sparse, dense):
        scores = ctr_forward(params, sparse, dense)
        if mesh is not None:
            scores = scores.full_tensor()      # the top 100 of every candidate
        return _top100(scores)

    cand_spec = P(dp if dp else None, None)
    args = (p_abs, _sd((n_cand, cfg.n_sparse), torch.int32),
            _sd((n_cand, max(n_dense, 1)), torch.float32))
    in_sh = (_named(mesh, p_specs), _named(mesh, cand_spec),
             _named(mesh, cand_spec))
    return CellSpec(arch.arch_id, shape_name, fn, args,
                    in_sh if mesh else None, None)


def _out_rows(x, sh):
    from repro_torch.distributed.collectives import shard_out

    return shard_out(x, sh.mesh, sh.spec(sh.batch, x.dim()))


def _top100(scores: torch.Tensor):
    """``jax.lax.top_k(scores, 100)`` over the last axis: largest first,
    ties to the lower index (a stable descending sort), int32 indices."""
    v, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return v[..., :100], i[..., :100].to(torch.int32)


# ================================================================= websearch
def _build_websearch(arch: ArchDef, shape_name: str, mesh, reduced: bool) -> CellSpec:
    """The paper's system: ``serve_websearch`` runs the greedy learned
    policy over a query batch and returns (cand, u, cand_cnt);
    ``train_websearch`` is one ε-greedy episode (ε 0.1) and its TD update,
    returning (q_new, metrics).  The train step takes the episode's
    draws, the (explore, uniform) pair of (t_max, B) tensors (or a
    ``torch.Generator``), where the reference takes a key.

    On a mesh the index's blocks lie over ``model`` and the queries over
    the data axes: each rank runs its own sequence of rules over its
    n_blocks / model blocks (the paper's machines).  Serve gathers the
    ranks' candidate ids (offset to global ids) over ``model``, merges
    them by static rank (``merge_shard_candidates``) and sums u and
    cand_cnt, in a ``shard_serve`` span (``gather``, ``merge``, ``reduce``)
    under the active tracer; a rank's blocks may come as DTensors placed
    by ``in_shardings`` (rank-local, ``DTensor.from_local``), which it
    reads without a copy, or as global tensors that it slices.  Train
    averages q_new and the metrics over ``model``, then over the data
    axes ("the same policy on every machine").  Each rank takes the same
    draws, (t_max, B / data) (the reference's shards draw from one
    replicated key at their local batch)."""
    from repro_torch.core.environment import EnvConfig
    from repro_torch.core.match_rules import default_rule_library
    from repro_torch.core.qlearning import QConfig, train_batch
    from repro_torch.core.rollout import unified_rollout
    from repro_torch.core.state_bins import StateBins
    from repro_torch.core.telescope import merge_shard_candidates
    from repro_torch.distributed.collectives import (all_gather, axis_index,
                                                     pmean, psum, shard_in,
                                                     shard_out)
    from repro_torch.index.builder import MAX_QUERY_TERMS
    from repro_torch.index.corpus import N_FIELDS
    from repro_torch.obs.trace import scope
    from repro_torch.policies import TabularQPolicy

    wcfg = arch.model_cfg(reduced)
    spec = arch.shape(shape_name)
    sp = dict(REDUCED_SHAPES[spec.kind]) if reduced else dict(spec.params)
    q_batch = sp["query_batch"]
    dp = _dp(mesh)
    msize = mesh_shape(mesh)["model"] if mesh else 1
    nb_local = wcfg.n_blocks // msize
    n_pad_local = nb_local * wcfg.block_docs
    w = wcfg.block_docs // 32
    env_cfg = EnvConfig(n_blocks=nb_local, block_docs=wcfg.block_docs,
                        k_rules=wcfg.k_rules, max_candidates=wcfg.max_candidates,
                        n_top=wcfg.n_top, u_budget=wcfg.u_budget)
    qcfg = QConfig(p=wcfg.p_bins, n_actions=env_cfg.n_actions, t_max=wcfg.t_max)
    rulesets = {}

    def ruleset(dev):
        if dev not in rulesets:
            rulesets[dev] = default_rule_library(device=dev)
        return rulesets[dev]

    pu = int(math.sqrt(wcfg.p_bins))
    pv = wcfg.p_bins // pu
    bins_abs = StateBins(u_edges=_sd((pu - 1,), torch.float32),
                         v_edges=_sd((pu, pv - 1), torch.float32))
    occ_abs = _sd((q_batch, wcfg.n_blocks, MAX_QUERY_TERMS, N_FIELDS, w),
                  torch.int32)
    scores_abs = _sd((q_batch, wcfg.n_blocks * wcfg.block_docs), torch.float32)
    tp_abs = _sd((q_batch, MAX_QUERY_TERMS), torch.bool)
    q_abs = _sd((wcfg.p_bins, env_cfg.n_actions), torch.float32)

    dpn = dp if dp else None
    occ_spec = P(dpn, "model" if mesh else None, None, None, None)
    scores_spec = P(dpn, "model" if mesh else None)
    tp_spec = P(dpn, None)

    def local_inputs(qt, bins, occ, scores, tp):
        """This rank's blocks (``shard_map``'s in_specs)."""
        if mesh is None:
            return qt, bins, occ, scores, tp
        rep = P()
        return (shard_in(qt, mesh, rep),
                StateBins(*(shard_in(e, mesh, rep)
                            for e in (bins.u_edges, bins.v_edges))),
                shard_in(occ, mesh, occ_spec), shard_in(scores, mesh, scores_spec),
                shard_in(tp, mesh, tp_spec))

    in_specs = (P(), P(), occ_spec, scores_spec, tp_spec)

    if spec.kind == "serve_websearch":
        def fn(qt, bins, occ, scores, tp):
            qt, bins, occ, scores, tp = local_inputs(qt, bins, occ, scores, tp)
            final = unified_rollout(env_cfg, ruleset(occ.device), bins,
                                    TabularQPolicy(qt), qcfg.t_max, occ,
                                    scores, tp, backend=wcfg.backend).final_state
            if mesh is None:
                return final.cand, final.u, final.cand_cnt
            with scope("shard_serve"):
                with scope("gather"):
                    shard = axis_index(mesh, "model")
                    cand = torch.where(final.cand >= 0,
                                       final.cand + shard * n_pad_local, -1)
                    gathered = all_gather(cand[None], mesh, "model", 0)  # (S, Qloc, K)
                with scope("merge"):
                    merged = merge_shard_candidates(gathered,
                                                    keep=wcfg.max_candidates)
                with scope("reduce"):
                    u = psum(final.u, mesh, "model")
                    cand_cnt = psum(final.cand_cnt, mesh, "model")
            return (shard_out(merged, mesh, P(dpn, None)), shard_out(u, mesh, P(dpn)),
                    shard_out(cand_cnt, mesh, P(dpn)))

        args = (q_abs, bins_abs, occ_abs, scores_abs, tp_abs)
        out_sh = (P(dpn, None), P(dpn), P(dpn))
        return CellSpec(arch.arch_id, shape_name, fn, args,
                        _named(mesh, in_specs), _named(mesh, out_sh))

    if spec.kind != "train_websearch":
        raise ValueError(spec.kind)

    def fn(qt, bins, occ, scores, tp, prod_r, draws):
        qt, bins, occ, scores, tp = local_inputs(qt, bins, occ, scores, tp)
        if mesh is not None:
            prod_r = shard_in(prod_r, mesh, P(dpn, None))
            if not isinstance(draws, torch.Generator):
                draws = tuple(shard_in(x, mesh, P()) for x in draws)
        q_new, metrics = train_batch(env_cfg, qcfg, ruleset(occ.device), bins,
                                     qt, occ, scores, tp, prod_r, 0.1, draws,
                                     backend=wcfg.backend)
        if mesh is None:
            return q_new, metrics
        rep = P()
        q_new = shard_out(pmean(pmean(q_new, mesh, "model"), mesh, dp), mesh, rep)
        metrics = {k: shard_out(pmean(pmean(m, mesh, "model"), mesh, dp), mesh, rep)
                   for k, m in metrics.items()}
        return q_new, metrics

    b_draws = q_batch // _dp_size(mesh)
    draws_abs = (_sd((wcfg.t_max, b_draws), torch.int32),
                 _sd((wcfg.t_max, b_draws), torch.float32))
    args = (q_abs, bins_abs, occ_abs, scores_abs, tp_abs,
            _sd((q_batch, wcfg.t_max), torch.float32), draws_abs)
    in_sh = in_specs + (P(dpn, None), (P(), P()))
    out_sh = (P(), {k: P() for k in ("mean_u", "mean_v", "mean_cand",
                                     "mean_reward", "q_abs_mean")})
    return CellSpec(arch.arch_id, shape_name, fn, args, _named(mesh, in_sh),
                    _named(mesh, out_sh))


# =================================================================== dispatch
def build_cell(arch_id: str, shape_name: str, mesh=None, reduced: bool = False,
               cfg_override=None, shape_params=None) -> CellSpec:
    """The (arch, shape) cell, for every family of the reference (lm,
    gnn, recsys, websearch), on one device or on a ``mesh`` (a
    ``DeviceMesh``; anything else raises).  ``shape_params`` updates the
    shape's published parameters (a cut call at full width; not with
    ``reduced``)."""
    arch = get_arch(arch_id)
    if cfg_override is not None:
        arch = dataclasses.replace(arch, model_cfg=lambda reduced_: cfg_override)
    if shape_params:
        if reduced:
            raise ValueError("shape_params update the published shapes, not "
                             "the reduced ones")
        spec = arch.shape(shape_name)
        spec = dataclasses.replace(spec, params={**spec.params, **shape_params})
        arch = dataclasses.replace(arch, shapes={**arch.shapes, shape_name: spec})
    if mesh is not None:
        from torch.distributed.device_mesh import DeviceMesh

        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch.distributed DeviceMesh, "
                            f"not {type(mesh).__name__}")
    builder = {"lm": _build_lm, "gnn": _build_gnn, "recsys": _build_recsys,
               "websearch": _build_websearch}[arch.family]
    return builder(arch, shape_name, mesh, reduced)
