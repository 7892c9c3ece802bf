"""Per-cell step builders (the single-device half of the reference's
``launch/steps.py``): for an (arch, shape) pair, the step function, its
abstract inputs and its donated arguments.

The reference's ``CellSpec.args`` are ``jax.ShapeDtypeStruct``s; here
they are ``device="meta"`` tensors (shapes and dtypes, no data), and the
shardings are None: the port runs on one device, and a ``mesh`` raises.
Every family has its builder: ``_build_lm``, ``_build_gnn``,
``_build_recsys`` and ``_build_websearch``.  Where a reference step
takes a ``jax.random`` key (the websearch train step), the port's takes
the draws that key would give (``core/qlearning.py``'s ``Draws``).

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
from repro_torch.train.optimizer import (AdamWConfig, adamw_init,
                                         adamw_update_, clip_by_global_norm_)
from repro_torch.train.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["CellSpec", "build_cell", "REDUCED_SHAPES", "make_lm_train_step",
           "lm_loss_and_grads", "recsys_loss", "value_and_grad", "ce_loss",
           "minibatch_budgets"]


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


def _build_gnn(arch: ArchDef, shape_name: str, reduced: bool) -> CellSpec:
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

    def step(params, opt_state, loss_fn):
        loss, grads = value_and_grad(loss_fn, params)
        adamw_update_(params, grads, opt_state, opt_cfg)
        return loss

    def on(dev, *xs):
        return [torch.as_tensor(x, device=dev) for x in xs]

    if spec.kind == "train_graph":
        n, e = sp["n_nodes"], sp["n_edges"]

        def fn(params, opt_state, feats, edges, labels, mask):
            feats, edges, labels, mask = on(_dev(params), feats, edges,
                                            labels, mask)
            loss = step(params, opt_state, lambda p: ce_loss(
                sage_full_forward(p, cfg, feats, edges), labels, mask))
            return params, opt_state, loss

        args = (p_abs, adamw_init(p_abs, opt_cfg),
                _sd((n, sp["d_feat"]), torch.float32), _sd((2, e), torch.int32),
                _sd((n,), torch.int32), _sd((n,), torch.float32))
        return CellSpec(arch.arch_id, shape_name, fn, args, None, None,
                        donate_argnums=(0, 1))

    if spec.kind == "train_minibatch":
        bn = sp["batch_nodes"]
        e1, fr1, e0, fr0 = minibatch_budgets(bn, sp["fanout"])

        def fn(params, opt_state, feats, src0, dst0, src1, dst1, labels):
            dev = _dev(params)
            feats, src0, dst0, src1, dst1, labels = on(
                dev, feats, src0, dst0, src1, dst1, labels)
            blocks = [(src0, dst0, fr1), (src1, dst1, bn)]
            ones = torch.ones((bn,), dtype=torch.float32, device=dev)
            loss = step(params, opt_state, lambda p: ce_loss(
                sage_block_forward(p, cfg, feats, blocks), labels, ones))
            return params, opt_state, loss

        args = (p_abs, adamw_init(p_abs, opt_cfg),
                _sd((fr0, sp["d_feat"]), torch.float32),
                _sd((e0,), torch.int32), _sd((e0,), torch.int32),
                _sd((e1,), torch.int32), _sd((e1,), torch.int32),
                _sd((bn,), torch.int32))
        return CellSpec(arch.arch_id, shape_name, fn, args, None, None,
                        donate_argnums=(0, 1))

    if spec.kind != "train_batched_graphs":
        raise ValueError(spec.kind)
    # molecule: block-diagonal batches of small graphs, a readout per graph
    bsz, npg, epg = sp["batch"], sp["n_nodes"], sp["n_edges"]
    n, e = bsz * npg, bsz * epg
    readout_abs = {"w": _sd((cfg.n_classes, sp["n_classes"]), torch.float32),
                   "b": _sd((sp["n_classes"],), torch.float32)}

    def fn(params, readout, opt_state, feats, edges, graph_id, labels):
        dev = _dev(params)
        feats, edges, graph_id, labels = on(dev, feats, edges, graph_id, labels)
        ones = torch.ones((bsz,), dtype=torch.float32, device=dev)
        loss = step((params, readout), opt_state, lambda pr: ce_loss(
            sage_graph_forward(pr[0], cfg, feats, edges, graph_id, bsz, pr[1]),
            labels, ones))
        return params, readout, opt_state, loss

    args = (p_abs, readout_abs, adamw_init((p_abs, readout_abs), opt_cfg),
            _sd((n, sp["d_feat"]), torch.float32), _sd((2, e), torch.int32),
            _sd((n,), torch.int32), _sd((bsz,), torch.int32))
    return CellSpec(arch.arch_id, shape_name, fn, args, None, None,
                    donate_argnums=(0, 1, 2))


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
    ties to the lower index (a stable descending sort), int32 indices."""
    v, i = torch.sort(scores, dim=-1, descending=True, stable=True)
    return v[..., :100], i[..., :100].to(torch.int32)


# ================================================================= websearch
def _build_websearch(arch: ArchDef, shape_name: str, reduced: bool) -> CellSpec:
    """The paper's system on one index shard: ``serve_websearch`` runs
    the greedy learned policy over a query batch and returns (cand, u,
    cand_cnt); ``train_websearch`` is one ε-greedy episode (ε 0.1) and
    its TD update, returning (q_new, metrics).  The train step takes the
    episode's draws, the (explore, uniform) pair of (t_max, B) tensors
    (or a ``torch.Generator``), where the reference takes a key."""
    from repro_torch.core.environment import EnvConfig
    from repro_torch.core.match_rules import default_rule_library
    from repro_torch.core.qlearning import QConfig, train_batch
    from repro_torch.core.rollout import unified_rollout
    from repro_torch.core.state_bins import StateBins
    from repro_torch.index.builder import MAX_QUERY_TERMS
    from repro_torch.index.corpus import N_FIELDS
    from repro_torch.policies import TabularQPolicy

    wcfg = arch.model_cfg(reduced)
    spec = arch.shape(shape_name)
    sp = dict(REDUCED_SHAPES[spec.kind]) if reduced else dict(spec.params)
    q_batch = sp["query_batch"]
    w = wcfg.block_docs // 32
    env_cfg = EnvConfig(n_blocks=wcfg.n_blocks, block_docs=wcfg.block_docs,
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

    if spec.kind == "serve_websearch":
        def fn(qt, bins, occ, scores, tp):
            final = unified_rollout(env_cfg, ruleset(occ.device), bins,
                                    TabularQPolicy(qt), qcfg.t_max, occ,
                                    scores, tp, backend=wcfg.backend).final_state
            return final.cand, final.u, final.cand_cnt

        args = (q_abs, bins_abs, occ_abs, scores_abs, tp_abs)
        return CellSpec(arch.arch_id, shape_name, fn, args, None, None)

    if spec.kind != "train_websearch":
        raise ValueError(spec.kind)

    def fn(qt, bins, occ, scores, tp, prod_r, draws):
        return train_batch(env_cfg, qcfg, ruleset(occ.device), bins, qt, occ,
                           scores, tp, prod_r, 0.1, draws,
                           backend=wcfg.backend)

    draws_abs = (_sd((wcfg.t_max, q_batch), torch.int32),
                 _sd((wcfg.t_max, q_batch), torch.float32))
    args = (q_abs, bins_abs, occ_abs, scores_abs, tp_abs,
            _sd((q_batch, wcfg.t_max), torch.float32), draws_abs)
    return CellSpec(arch.arch_id, shape_name, fn, args, None, None)


# =================================================================== dispatch
def build_cell(arch_id: str, shape_name: str, mesh=None, reduced: bool = False,
               cfg_override=None) -> CellSpec:
    """The (arch, shape) cell on one device, for every family of the
    reference (lm, gnn, recsys, websearch).  Raises for a ``mesh``: the
    sharded cells wait for the mesh port."""
    if mesh is not None:
        raise NotImplementedError("a sharded cell waits for the mesh port")
    arch = get_arch(arch_id)
    if cfg_override is not None:
        arch = dataclasses.replace(arch, model_cfg=lambda reduced_: cfg_override)
    builder = {"lm": _build_lm, "gnn": _build_gnn, "recsys": _build_recsys,
               "websearch": _build_websearch}[arch.family]
    return builder(arch, shape_name, reduced)
