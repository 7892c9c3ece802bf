"""Roofline analysis from the dry run's records (the reference's
``launch/roofline.py``): the three terms of a step, the analytic model
FLOPs (6·N·D to train, 2·N·D to serve) of an LM cell, the layer probe
and the rows of every recorded cell.

    PYTHONPATH=src python -m repro_torch.launch.roofline                  # pod16x16 records
    PYTHONPATH=src python -m repro_torch.launch.roofline --lm-corrected   # + the probes

Three terms per step, with the constants of one NVIDIA H100 SXM (its
data sheet: dense bf16 tensor-core rate, HBM3 rate, NVLink each way):

    compute    = FLOPs_per_device      / 989e12 FLOP/s (bf16)
    memory     = bytes_per_device      / 3.35e12 B/s
    collective = wire_bytes_per_device / 450e9  B/s (NVLink, one way)

The records are ``launch/dryrun.py``'s: one rank's call counted eagerly
on meta tensors (FLOPs of the matmuls and of the kernels' reports,
unfused bytes, collectives' result bytes), where the reference reads
XLA's cost analysis of the compiled, fused program.  ``model_flops``
counts parameters on ``meta`` tensors (shapes only), so Grok-1's 314 B
parameters are never allocated.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
from pathlib import Path

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "COLL_MULT", "wire_bytes",
           "roofline_terms", "model_flops", "lm_probe", "analyze_cell", "main"]

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


# ---------------------------------------------------------- the layer probe
def lm_probe(arch_id: str, shape_name: str, mesh, cfg_override=None) -> dict:
    """The reference's three-point probe over n_layers ∈ {L, L/2, 0}, on
    the caller's mesh under the caller's (fake) process group, with its
    probe configs (single-chunk attention and loss, ``microbatch=1``), so
    that the numbers stay comparable with the reference's.

    The reference needs the probe because XLA's cost analysis counts a
    scanned layer body once; an eager count (``launch/dryrun.py``) counts
    every layer, so here measured(l) is linear in l and the keys mean:

    - ``*_per_device``: m(L), the step's count;
    - ``*_layer``: (m(L) − m(0)) / L, the per-layer slope;
    - ``*_linear``: (m(L) − m(L/2)) / (L − L/2), the slope over the
      upper half (equal to ``*_layer`` where the count is linear in l);
    - ``*_outside``: m(0), what lies outside the layers (embedding,
      head, loss, optimizer of the non-layer leaves).

    for ``flops`` (with the kernels' reported operations), ``bytes``
    (unfused) and ``wire`` (``wire_bytes`` of the collectives)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import (collective_bytes, counting,
                                           place_args)
    from repro_torch.launch.steps import build_cell

    arch = get_arch(arch_id)
    base_cfg = cfg_override if cfg_override is not None else arch.model_cfg(False)
    sp = arch.shape(shape_name).params
    seq = sp.get("seq_len", base_cfg.max_seq)
    tokens = sp.get("global_batch", 1) * seq
    probe_cfg = dataclasses.replace(base_cfg, loss_chunk=tokens, microbatch=1,
                                    q_chunk=seq)
    if probe_cfg.mla is not None:
        probe_cfg = dataclasses.replace(
            probe_cfg, mla=dataclasses.replace(probe_cfg.mla, q_chunk=seq))

    def measure(cfg):
        cell = build_cell(arch_id, shape_name, mesh=mesh, cfg_override=cfg)
        args = place_args(cell.args, cell.in_shardings)
        with counting(args) as c:
            cell.fn(*args)
        return {"flops": c.flops,
                "bytes": float(c.bytes + sum(k["bytes"] for k in c.kernels.values())),
                "wire": wire_bytes(collective_bytes(c.collectives))}

    n = probe_cfg.n_layers
    half = max(n // 2, 1)
    m_l = measure(probe_cfg)
    m_h = measure(dataclasses.replace(probe_cfg, n_layers=half))
    m_0 = measure(dataclasses.replace(probe_cfg, n_layers=0))
    out = {}
    for k in ("flops", "bytes", "wire"):
        out[k + "_per_device"] = m_l[k]
        out[k + "_layer"] = (m_l[k] - m_0[k]) / max(n, 1)
        out[k + "_linear"] = (m_l[k] - m_h[k]) / max(n - half, 1)
        out[k + "_outside"] = m_0[k]
    return out


def analyze_cell(rec: dict, corrected: dict | None = None) -> dict:
    """rec: a dry-run record (``launch/dryrun.py``). corrected: optional
    ``lm_probe`` output."""
    if corrected is not None:
        f = corrected["flops_per_device"]
        b = corrected["bytes_per_device"]
        w = corrected["wire_per_device"]
    else:
        f = rec["cost"]["flops_per_device"]
        b = rec["cost"]["bytes_accessed_per_device"]
        w = wire_bytes(rec["collectives"])
    terms = roofline_terms(f, b, w)
    terms.update({"flops_per_device": f, "bytes_per_device": b,
                  "wire_bytes_per_device": w})
    return terms


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun-dir", default="results/dryrun_torch/pod16x16")
    ap.add_argument("--out", default="results/roofline_torch.json")
    ap.add_argument("--lm-corrected", action="store_true",
                    help="run the three-point probes for LM cells (slow)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch

    rows = []
    with contextlib.ExitStack() as stack:
        if args.lm_corrected:
            from repro_torch.launch.dryrun import fake_world
            from repro_torch.launch.mesh import make_production_mesh

            stack.enter_context(fake_world(256))
            mesh = make_production_mesh(multi_pod=False, device="cpu")
        for path in sorted(Path(args.dryrun_dir).glob("*.json")):
            rec = json.loads(path.read_text())
            if not rec.get("ok"):
                continue
            arch_id, shape = rec["arch"], rec["shape"]
            corrected = None
            if args.lm_corrected and get_arch(arch_id).family == "lm":
                try:
                    corrected = lm_probe(arch_id, shape, mesh)
                except Exception as e:  # noqa: BLE001
                    corrected = None
                    rec["probe_error"] = str(e)[:200]
            terms = analyze_cell(rec, corrected)
            mf = model_flops(arch_id, shape)
            n_dev = rec["devices"]
            hlo_global = terms["flops_per_device"] * n_dev
            ratio = (mf["model_flops"] / hlo_global
                     if mf.get("model_flops") and hlo_global else None)
            rows.append({
                "arch": arch_id, "shape": shape, "corrected": corrected is not None,
                **terms,
                "model_flops": mf.get("model_flops"),
                "useful_ratio": ratio,
                "peak_bytes": rec["memory"]["peak_bytes_est"],
            })
            r = rows[-1]
            print(f"{arch_id:24s} {shape:16s} bound={r['bound']:10s} "
                  f"c={r['compute_s']:.2e}s m={r['memory_s']:.2e}s "
                  f"x={r['collective_s']:.2e}s "
                  f"useful={r['useful_ratio'] if r['useful_ratio'] else 0:.2f}",
                  flush=True)

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
