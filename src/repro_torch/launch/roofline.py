"""Roofline arithmetic, the single-device half of the reference's
``launch/roofline.py``: the three terms of a step and the analytic
model FLOPs (6·N·D to train, 2·N·D to serve) of an LM cell.

Three terms per step, with the constants of one NVIDIA H100 SXM (its
data sheet: dense bf16 tensor-core rate, HBM3 rate, NVLink each way):

    compute    = FLOPs_per_device      / 989e12 FLOP/s (bf16)
    memory     = bytes_per_device      / 3.35e12 B/s
    collective = wire_bytes_per_device / 450e9  B/s (NVLink, one way)

``model_flops`` counts parameters on ``meta`` tensors (shapes only), so
Grok-1's 314 B parameters are never allocated.  The reference's
``lm_probe``, ``analyze_cell`` and ``main`` read XLA cost analyses of
compiled dry-run artifacts; they wait for the port of ``dryrun`` and
``mesh``.
"""
from __future__ import annotations

import math

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "COLL_MULT", "wire_bytes",
           "roofline_terms", "model_flops"]

PEAK_FLOPS = 989e12      # bf16 dense FLOP/s, H100 SXM
HBM_BW = 3.35e12         # B/s, H100 SXM HBM3
LINK_BW = 450e9          # B/s NVLink, each way, H100 SXM

COLL_MULT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
             "all-to-all": 1.0, "collective-permute": 1.0}


def wire_bytes(coll: dict) -> float:
    """Bytes on the wire of a step's collectives: each type's result bytes
    times its multiplier (an all-reduce is a reduce-scatter and an
    all-gather: ×2)."""
    return sum(COLL_MULT[k] * v for k, v in coll["bytes"].items())


def roofline_terms(flops_dev: float, bytes_dev: float, coll_bytes_dev: float) -> dict:
    t_c = flops_dev / PEAK_FLOPS
    t_m = bytes_dev / HBM_BW
    t_x = coll_bytes_dev / LINK_BW
    dom = max(("compute", t_c), ("memory", t_m), ("collective", t_x),
              key=lambda kv: kv[1])[0]
    total = max(t_c, t_m, t_x)
    return {
        "compute_s": t_c, "memory_s": t_m, "collective_s": t_x,
        "bound": dom,
        "roofline_frac": (t_c / total) if total > 0 else 0.0,
    }


# ------------------------------------------------------- analytic FLOPs
def _param_count(tree) -> int:
    from repro_torch.train.tree import tree_leaves

    return sum(math.prod(l.shape) for l in tree_leaves(tree)
               if hasattr(l, "shape"))


def model_flops(arch_id: str, shape_name: str, cfg=None) -> dict:
    """MODEL_FLOPS = 6·N·D (train, dense) / 6·N_active·D (MoE) /
    2·N_active·D (serve).  Global, whole step; the parameters counted
    on the meta device.  ``cfg`` replaces the arch's full config (a cut
    model: N of its own)."""
    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import init_params

    arch = get_arch(arch_id)
    spec = arch.shape(shape_name)
    if arch.family != "lm":
        return {"model_flops": None, "n_params": None, "note": "6ND defined for LM"}
    cfg = arch.model_cfg(False) if cfg is None else cfg
    params = init_params(cfg, device="meta")
    n_total = _param_count(params)
    if cfg.moe is not None:
        n_experts_all = _param_count(params["layers"]["ffn"]["experts"])
        n_active = (n_total - n_experts_all
                    + int(n_experts_all * cfg.moe.top_k / cfg.moe.n_experts))
    else:
        n_active = n_total
    sp = spec.params
    if spec.kind == "train":
        d = sp["global_batch"] * sp["seq_len"]
        mf = 6 * n_active * d
    elif spec.kind == "prefill":
        d = sp["global_batch"] * sp["seq_len"]
        mf = 2 * n_active * d
    else:  # decode: one token per sequence + attention over the cache
        d = sp["global_batch"]
        kv_flops = (2 * cfg.n_layers * sp["global_batch"] * sp["seq_len"]
                    * cfg.n_heads * cfg.d_head * 2)
        mf = 2 * n_active * d + kv_flops
    return {"model_flops": float(mf), "n_params": n_total, "n_active": n_active}
