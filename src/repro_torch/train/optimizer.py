"""Optimizers, hand-rolled over nested dicts of tensors (the reference's
``train/optimizer.py``).

AdamW with float32 or bfloat16 moments (``state_dtype``), SGD with
momentum, Adafactor, global-norm clipping, and cosine / linear
schedules.  States are trees of the parameters' structure
(``{"mu", "nu", "count"}`` for AdamW), walked in the reference's
flatten order (``train/tree.py``: sorted keys).

The arithmetic per element is the reference's: float32 math, one cast
to the parameter's or the state's dtype.  The bias corrections
``1 - b**c`` are computed in float32 from the int32 step count, as the
reference computes them, not in Python doubles.

``adamw_update`` returns new trees, as the reference does.
``adamw_update_`` and ``clip_by_global_norm_`` overwrite their inputs
instead (the train steps' form, standing for the reference's
``donate_argnums``): leaf by leaf, a large leaf in flat slices of
``SLICE_ELEMS`` elements, so that no float32 temporary exceeds
``SLICE_ELEMS * 4`` bytes (a stacked (30, 3072, 12288) MLP leaf would
make 4.5 GB ones).  Elementwise, so both forms give the same bits.

On a mesh (``mesh`` and the leaves' ``PartitionSpec``s) the leaves are
this rank's blocks.  ``global_norm`` sums each leaf's squared norm over
the axes its spec splits it over, and only those (a replicated block
counts once), in rank order (``collectives.psum_ordered``).
``adamw_update_`` updates each rank's blocks; where a moment's spec adds
``data`` to its parameter's (ZeRO-1, ``zero1_state_specs``), the rank
updates its ``data`` slice of the parameter block with its moments and
all-gathers the block over ``data``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

from .tree import tree_leaves, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "adamw_update_",
           "sgdm_init", "sgdm_update", "adafactor_init", "adafactor_update",
           "clip_by_global_norm", "clip_by_global_norm_", "global_norm",
           "cosine_schedule", "linear_warmup", "SLICE_ELEMS"]

PyTree = Any
SLICE_ELEMS = 1 << 25       # 128 MB of float32 per temporary


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    state_dtype: Any = torch.float32   # torch.bfloat16 halves the moments


def _device(tree) -> torch.device:
    return tree_leaves(tree)[0].device


def adamw_init(params: PyTree, cfg: AdamWConfig = AdamWConfig()) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)

    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=_device(params))}


def _bias_corrections(count: torch.Tensor, cfg: AdamWConfig):
    c = count.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=c.device)
    return (1.0 - torch.pow(one * cfg.b1, c), 1.0 - torch.pow(one * cfg.b2, c))


def _adamw_math(p, g, mu, nu, bc1, bc2, cfg: AdamWConfig, lr_scale):
    """The reference's ``upd`` in float32: (new p, mu, nu), float32."""
    g32 = g.float()
    mu32 = cfg.b1 * mu.float() + (1 - cfg.b1) * g32
    nu32 = cfg.b2 * nu.float() + (1 - cfg.b2) * g32 * g32
    step = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + cfg.eps)
    step = step + cfg.weight_decay * p.float()
    return p.float() - cfg.lr * lr_scale * step, mu32, nu32


def adamw_update(params: PyTree, grads: PyTree, state: dict,
                 cfg: AdamWConfig = AdamWConfig(), lr_scale=1.0):
    """One AdamW step; returns (new params, new state).  Inputs are not
    modified."""
    count = state["count"] + 1
    bc1, bc2 = _bias_corrections(count, cfg)

    def upd(p, g, mu, nu):
        newp, mu32, nu32 = _adamw_math(p, g, mu, nu, bc1, bc2, cfg, lr_scale)
        return (newp.to(p.dtype), mu32.to(cfg.state_dtype),
                nu32.to(cfg.state_dtype))

    res = tree_map(upd, params, grads, state["mu"], state["nu"])
    new_p, mu, nu = (tree_map(lambda _, r: r[i], params, res) for i in range(3))
    return new_p, {"mu": mu, "nu": nu, "count": count}


def _slices(*tensors):
    """Matching flat slices of same-shaped contiguous tensors, at most
    ``SLICE_ELEMS`` elements each."""
    flat = [t.view(-1) for t in tensors]
    n = flat[0].numel()
    for i in range(0, n, SLICE_ELEMS):
        yield [f[i:i + SLICE_ELEMS] for f in flat]


@torch.no_grad()
def adamw_update_(params: PyTree, grads: PyTree, state: dict,
                  cfg: AdamWConfig = AdamWConfig(), lr_scale=1.0, mesh=None,
                  param_specs: PyTree = None, state_specs: PyTree = None) -> None:
    """``adamw_update`` in place: overwrites every parameter, both
    moments and the count, and may clobber nothing else.  The leaves
    must be contiguous; the same bits as ``adamw_update``.  On a
    ``mesh``: every leaf is this rank's block, laid out by
    ``param_specs`` (parameters and gradients) and ``state_specs`` (the
    moments; ZeRO-1 where they add ``data``)."""
    state["count"] += 1
    bc1, bc2 = _bias_corrections(state["count"], cfg)

    def upd(p, g, mu, nu):
        for ps, gs, ms, ns in _slices(p, g, mu, nu):
            newp, mu32, nu32 = _adamw_math(ps, gs, ms, ns, bc1, bc2, cfg,
                                           lr_scale)
            ps.copy_(newp)
            ms.copy_(mu32)
            ns.copy_(nu32)

    if mesh is None:
        tree_map(upd, params, grads, state["mu"], state["nu"])
        return
    from repro_torch.distributed.collectives import all_gather, axis_index

    for p, g, mu, nu, psp, ssp in zip(
            *(tree_leaves(t) for t in (params, grads, state["mu"], state["nu"],
                                       param_specs, state_specs))):
        d = _zero1_dim(psp, ssp)
        if d is None:
            upd(p, g, mu, nu)
            continue
        n = mu.shape[d]
        lo = axis_index(mesh, "data") * n
        part = p.narrow(d, lo, n).contiguous()
        upd(part, g.narrow(d, lo, n).contiguous(), mu, nu)
        p.copy_(all_gather(part, mesh, "data", d))


def _zero1_dim(param_spec, state_spec, axis: str = "data"):
    """The dim where ``state_spec`` adds ``axis`` to ``param_spec`` (a
    ZeRO-1 moment), or None."""
    for d, e in enumerate(state_spec):
        pe = param_spec[d] if d < len(param_spec) else None
        if axis in _entry_axes(e) and axis not in _entry_axes(pe):
            return d
    return None


def _entry_axes(e):
    return e if isinstance(e, tuple) else (() if e is None else (e,))


# ------------------------------------------------------------------ SGDM
def sgdm_init(params: PyTree) -> dict:
    return {"mom": tree_map(torch.zeros_like, params)}


def sgdm_update(params, grads, state, lr: float = 0.01, beta: float = 0.9):
    mom = tree_map(lambda m, g: beta * m + g, state["mom"], grads)
    params = tree_map(lambda p, m: p - lr * m, params, mom)
    return params, {"mom": mom}


# ------------------------------------------------------------- Adafactor
def adafactor_init(params: PyTree) -> dict:
    def init(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if p.dim() >= 2:
            return (torch.zeros(p.shape[:-1], **f32),
                    torch.zeros(p.shape[:-2] + p.shape[-1:], **f32))
        return (torch.zeros(p.shape, **f32), None)

    return {"fac": tree_map(init, params),
            "count": torch.zeros((), dtype=torch.int32, device=_device(params))}


def adafactor_update(params, grads, state, lr: float = 1e-2,
                     decay: float = 0.8, eps: float = 1e-30):
    count = state["count"] + 1
    beta = 1.0 - count.to(torch.float32) ** (-decay)

    def upd(p, g, fac):
        g32 = g.float()
        sq = g32 * g32 + eps
        if p.dim() >= 2:
            r, c = fac
            r = beta * r + (1 - beta) * sq.mean(-1)
            c = beta * c + (1 - beta) * sq.mean(-2)
            denom = torch.sqrt(r[..., None] * c[..., None, :] / torch.clamp(
                r.mean(-1, keepdim=True)[..., None], min=eps))
            step = g32 / torch.clamp(denom, min=eps)
            newfac = (r, c)
        else:
            v, _ = fac
            v = beta * v + (1 - beta) * sq
            step = g32 / torch.sqrt(v + eps)
            newfac = (v, None)
        # relative step size (Adafactor's update clipping, simplified)
        rms = torch.sqrt(torch.mean(step * step) + eps)
        step = step / torch.clamp(rms, min=1.0)
        return (p.float() - lr * step).to(p.dtype), newfac

    res = tree_map(upd, params, grads, state["fac"])
    new_p = tree_map(lambda _, r: r[0], params, res)
    new_fac = tree_map(lambda _, r: r[1], params, res)
    return new_p, {"fac": new_fac, "count": count}


# ----------------------------------------------------------------- utils
def global_norm(grads: PyTree, mesh=None, specs: PyTree = None) -> torch.Tensor:
    """sqrt of the sum over leaves (flatten order) of each leaf's sum of
    float32 squares (a large leaf summed slice by slice), float32.  On a
    ``mesh`` each leaf is this rank's block under its spec in ``specs``:
    its squared norm is summed in rank order over the spec's axes alone
    (the leaves that share axes in one gather)."""
    sqs = []
    for g in tree_leaves(grads):
        sq = torch.zeros((), dtype=torch.float32, device=g.device)
        for (s,) in _slices(g.contiguous()):
            sq = sq + torch.sum(torch.square(s.float()))
        sqs.append(sq)
    if mesh is not None:
        from repro_torch.distributed.collectives import psum_ordered

        groups = {}
        for i, sp in enumerate(tree_leaves(specs)):
            groups.setdefault(tuple(sp.axes()), []).append(i)
        for axes, idx in groups.items():
            if axes:
                summed = psum_ordered(torch.stack([sqs[i] for i in idx]), mesh,
                                      axes)
                for j, i in enumerate(idx):
                    sqs[i] = summed[j]
    total = torch.zeros((), dtype=torch.float32,
                        device=sqs[0].device if sqs else None)
    for sq in sqs:
        total = total + sq
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: PyTree, max_norm: float) -> Tuple[PyTree, torch.Tensor]:
    """(grads scaled by min(1, max_norm / norm), norm); inputs kept."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def clip_by_global_norm_(grads: PyTree, max_norm: float, mesh=None,
                         specs: PyTree = None) -> torch.Tensor:
    """``clip_by_global_norm`` in place (contiguous leaves, in slices);
    returns the norm.  On a ``mesh``, of the blocks (``global_norm``)."""
    norm = global_norm(grads, mesh, specs)
    scale = _clip_scale(norm, max_norm)
    for g in tree_leaves(grads):
        for (s,) in _slices(g):
            s.copy_(s.float() * scale)
    return norm


def _steps(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(step, total: int, warmup: int = 0, floor: float = 0.1):
    step = _steps(step)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    return warm * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))


def linear_warmup(step, warmup: int):
    return torch.clamp(_steps(step) / max(warmup, 1), max=1.0)
