"""The port's mesh, rank by rank, against the reference's sharded
functions, on the CPU.

Two processes run side by side from the same numpy inputs:

- the oracle (``python tests/test_torch_mesh.py --oracle DIR``) sets
  ``XLA_FLAGS`` for 8 host devices before it imports JAX, builds an
  Auto-axis 2 x 4 ``jax.sharding.Mesh`` ("data", "model"; the reference's
  own worker uses ``jax.make_mesh``, whose Explicit axes its LM step
  refuses), writes the reference's parameters and ε-greedy draws first
  (``params.npz``), then every sharded output (``oracle.npz``);
- the port (``--ranks DIR``) spawns an 8-rank gloo world (a
  ``FileStore``, one torch thread a rank) on a 2 x 4 ``make_local_mesh``
  on the CPU, carries the reference's parameters across with
  ``weights.py``'s converters and writes rank 0's view (``port.npz``).

This file's top-level imports are JAX-free, so that the ranks never
import JAX.  Tolerances, and why:

- ``sharded_lookup`` and ``sharded_lookup_rs`` bit-equal (one nonzero
  term per psum: the reference's own bound is ``== 0.0``);
- ``sharded_bag_sum`` within 1e-6 (the bag's fixed order against XLA's);
- the MoE FFN within 1e-5 (EP: the same combine) and 2e-4 (TP: the d_ff
  partial sums joined across ranks), the routing integers bit-equal;
- websearch ``serve_queries``'s cand / u / cand_cnt bit-equal (integer
  state), plus the reference's invariants (unique, sorted, in-range ids;
  u > 0); ``rl_rollout``'s q_new and metrics within 1e-6·(1 + |q|): the
  pmean sums in gloo's order, not XLA's;
- one recsys train step per arch (loss, every gradient leaf, every
  updated parameter) within 1e-4 relative L2, and each serve shape's
  outputs within 1e-4 (fp32 sums in other orders), ids equal;
- ``compressed_psum_grads``: payloads and residuals bit-equal
  (elementwise casts); the mean within 1e-2 relative, as the two sum
  bf16 values in different orders;
- ``restore(..., shardings=)`` onto the mesh bit-equal to the saved tree.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
WORLD, DATA, MODEL = 8, 2, 4
SEED = 0
TIMEOUT_S = 600
DRAWS_KEY = 3
RECSYS_CASES = {                     # case -> (arch, config changes)
    "wide-deep": ("wide-deep", {}),
    "deepfm": ("deepfm", {}),
    # 6 x 1024 rows >= 4096: the table row-shards over model (P("model"))
    "dcn-v2-big": ("dcn-v2", {"vocab_per_field": 1024}),
    "bert4rec": ("bert4rec", {}),
    # the reduce-scatter lookup and a tower sharded over model too
    "wide-deep-bom": ("wide-deep", {"vocab_per_field": 1024,
                                    "batch_over_model": True}),
}
RECSYS_SERVE = ("serve_p99", "serve_bulk", "retrieval_cand")
RECSYS_INITS = {"wide-deep": "wide_deep_init", "deepfm": "deepfm_init",
                "dcn-v2": "dcn_init", "bert4rec": "bert4rec_init"}
MOE_CASES = {                        # case -> (E, top_k, fsdp, tolerance)
    "ep": (8, 2, False, 1e-5),
    "tp": (2, 1, False, 2e-4),       # E = 2 on the 4-way model axis
    "ep_fsdp": (8, 2, True, 1e-5),
    "tp_fsdp": (2, 1, True, 2e-4),
}
MOE_D, MOE_FF, MOE_T = 32, 64, 16
CKPT_SPECS = {"embed": ("model", None), "w": (None, "model"),
              "mu": (("data", "model"),), "bf": ("data", None)}
TRAIN_TOL = SERVE_TOL = 1e-4
Q_TOL = 1e-6


# ------------------------------------------------------------ shared
def _flat(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(v, f"{prefix}/{k}", out)
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def _unflat(npz, prefix):
    tree = {}
    for key in npz.files:
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = npz[key]
    return tree


def _configs(case):
    """The port's reduced config of a recsys case (the reference's has
    the same fields and values: tests/test_torch_recsys.py)."""
    import dataclasses

    from repro_torch.configs import get_arch

    arch, changes = RECSYS_CASES[case]
    return arch, dataclasses.replace(get_arch(arch).model_cfg(True), **changes)


def _inputs():
    """Every input, from one numpy seed."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import REDUCED_SHAPES

    rng = np.random.default_rng(SEED)
    inp = {"table": rng.normal(size=(64, 16)).astype(np.float32),
           "wide": rng.normal(size=(64, 1)).astype(np.float32),
           "idx": rng.integers(0, 64, (8, 5)).astype(np.int32),
           "moe_x": rng.normal(size=(MOE_T, MOE_D)).astype(np.float32)}
    bag = inp["idx"].copy()
    bag[0, 0] = -1
    bag[3, 1:] = -1
    inp["bag_idx"] = bag

    wcfg = get_arch("websearch-rl").model_cfg(True)
    b = REDUCED_SHAPES["serve_websearch"]["query_batch"]
    w, t, f = wcfg.block_docs // 32, 4, 4
    k = rng.integers(1, 5, (b, 1, t, f, 1))
    occ = np.full((b, wcfg.n_blocks, t, f, w), 0xFFFFFFFF, np.uint32)
    for i in range(1, 5):
        words = rng.integers(0, 2**32, occ.shape, dtype=np.uint32)
        occ &= np.where(k >= i, words, np.uint32(0xFFFFFFFF))
    tp = np.arange(t)[None, :] < rng.integers(2, 5, b)[:, None]
    occ &= np.where(tp[:, None, :, None, None], np.uint32(0xFFFFFFFF), 0)
    q = rng.normal(scale=0.05, size=(wcfg.p_bins, wcfg.k_rules + 2)).astype(np.float32)
    q[:, wcfg.k_rules:] -= 0.1          # reset and stop below the rules
    pu = int(np.sqrt(wcfg.p_bins))
    pv = wcfg.p_bins // pu
    inp.update({
        "ws/occ": occ, "ws/tp": tp, "ws/q": q,
        "ws/scores": rng.normal(size=(b, wcfg.n_blocks * wcfg.block_docs)).astype(np.float32),
        "ws/u_edges": np.geomspace(2, wcfg.u_budget, pu - 1).astype(np.float32),
        "ws/v_edges": np.tile(np.geomspace(1, 4096, pv - 1), (pu, 1)).astype(np.float32),
        "ws/prod_r": rng.normal(scale=0.1, size=(b, wcfg.t_max)).astype(np.float32)})

    for case in RECSYS_CASES:
        arch, cfg = _configs(case)
        bt = REDUCED_SHAPES["train_recsys"]["batch"]
        bs = REDUCED_SHAPES["serve"]["batch"]
        nc = REDUCED_SHAPES["retrieval"]["n_candidates"]
        if arch == "bert4rec":
            seq = rng.integers(0, cfg.n_items, (bt, cfg.seq_len)).astype(np.int32)
            seq[:, :4] = cfg.n_items                        # leading [PAD]s
            mask_pos = rng.integers(0, cfg.seq_len, (bt, 16)).astype(np.int32)
            seq[np.arange(bt)[:, None], mask_pos] = cfg.n_items + 1
            inp[f"rs/{case}/train"] = [
                seq, mask_pos,
                rng.integers(0, cfg.n_items, (bt, 16)).astype(np.int32),
                rng.integers(0, cfg.n_items, (bt, 256)).astype(np.int32)]
            for shape, n in (("serve", bs), ("retrieval", 1)):
                inp[f"rs/{case}/{shape}"] = [
                    rng.integers(0, cfg.n_items, (n, cfg.seq_len)).astype(np.int32)]
            continue
        nd = max(cfg.n_dense, 1)
        for shape, n in (("train", bt), ("serve", bs), ("retrieval", nc)):
            inp[f"rs/{case}/{shape}"] = [
                rng.integers(0, cfg.vocab_per_field, (n, cfg.n_sparse)).astype(np.int32),
                rng.normal(size=(n, nd)).astype(np.float32)]
        inp[f"rs/{case}/train"].append(rng.integers(0, 2, bt).astype(np.float32))

    inp["cg/grads"] = {"a": rng.normal(size=(DATA, 64)).astype(np.float32),
                       "b": rng.normal(size=(DATA, 8, 4)).astype(np.float32)}
    inp["cg/residual"] = {k: 1e-3 * rng.normal(size=v.shape).astype(np.float32)
                          for k, v in inp["cg/grads"].items()}
    inp["ckpt"] = {"embed": rng.normal(size=(64, 8)).astype(np.float32),
                   "w": rng.normal(size=(8, 16)).astype(np.float32),
                   "mu": rng.normal(size=(32,)).astype(np.float32),
                   "bf": rng.normal(size=(4, 4)).astype(np.float32),
                   "count": np.int32(7)}
    return inp


def _serve_kind(shape):
    return "retrieval" if shape == "retrieval_cand" else "serve"


# ------------------------------------------------------------ the oracle
def _oracle(out: Path):
    flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
             if not f.startswith("--xla_force_host_platform_device_count")]
    os.environ["XLA_FLAGS"] = " ".join(
        flags + [f"--xla_force_host_platform_device_count={WORLD}"])
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as JP

    from repro.configs import get_arch as jax_get_arch
    from repro.core.state_bins import StateBins as JStateBins
    from repro.distributed.collectives import (compress_with_feedback,
                                               compressed_psum_grads)
    from repro.distributed.embedding_ops import (sharded_bag_sum,
                                                 sharded_lookup,
                                                 sharded_lookup_rs)
    from repro.launch.steps import build_cell as jax_build_cell
    from repro.models import moe as jmoe
    from repro.models import recsys as jrec
    from test_torch_train_system import jax_draws

    assert len(jax.devices()) >= WORLD
    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(DATA, MODEL),
                ("data", "model"))
    inp = _inputs()
    res, params = {}, {}

    moe_cfgs = {}
    for case, (e, k, fsdp, _) in MOE_CASES.items():
        cfg = jmoe.MoEConfig(n_experts=e, top_k=k, d_model=MOE_D, d_ff=MOE_FF,
                             capacity_factor=8.0)
        moe_cfgs[case] = cfg
        _flat(jax.tree_util.tree_map(np.asarray, jmoe.moe_init(
            jax.random.key(e), cfg)), f"moe/{case}", params)
    rs_cfgs = {}
    for case in RECSYS_CASES:
        arch, changes = RECSYS_CASES[case]
        jcfg = dataclasses.replace(jax_get_arch(arch).model_cfg(True), **changes)
        rs_cfgs[case] = jcfg
        _flat(jax.tree_util.tree_map(np.asarray, getattr(jrec, RECSYS_INITS[arch])(
            jax.random.key(4), jcfg)), f"rs/{case}", params)
    wcfg = jax_get_arch("websearch-rl").model_cfg(True)
    b_loc = inp["ws/occ"].shape[0] // DATA
    explore, uniform = jax_draws(jax.random.key(DRAWS_KEY), wcfg.t_max, b_loc,
                                 wcfg.k_rules + 2)
    params["draws/explore"], params["draws/uniform"] = explore.numpy(), uniform.numpy()
    np.savez(out / "params.npz", **params)
    (out / "params.ready").touch()
    t0 = time.perf_counter()

    with mesh:
        table, idx = jnp.asarray(inp["table"]), jnp.asarray(inp["idx"])
        res["lookup"] = sharded_lookup(table, idx, mesh)
        res["lookup_rs"] = sharded_lookup_rs(table, idx, mesh)
        res["bag"] = sharded_bag_sum(table, jnp.asarray(inp["bag_idx"]), mesh)
        res["bag_wide"] = sharded_bag_sum(jnp.asarray(inp["wide"]),
                                          jnp.asarray(inp["bag_idx"]), mesh)

        npz = np.load(out / "params.npz")
        x = jnp.asarray(inp["moe_x"])
        for case, cfg in moe_cfgs.items():
            p = jax.tree_util.tree_map(jnp.asarray, _unflat(npz, f"moe/{case}"))
            fsdp = MOE_CASES[case][2]
            o, _ = jax.jit(lambda p, x, cfg=cfg, fsdp=fsdp: jmoe.moe_ffn_sharded(
                p, x, cfg, mesh, fsdp=fsdp))(p, x)
            res[f"moe/{case}/out"] = o
            res[f"moe/{case}/local"] = jmoe.moe_ffn(p, x, cfg)[0]
            cap = max(8, int(cfg.capacity_factor * (MOE_T // DATA) * cfg.top_k
                             / cfg.n_experts))
            idxs, poss = [], []
            for half in jnp.split(x, DATA):
                _, i, _ = jmoe.router_topk(p["router"], half, cfg.top_k)
                pos, _, _ = jmoe.build_dispatch(i, cfg.n_experts, cap)
                idxs.append(i)
                poss.append(pos)
            res[f"moe/{case}/idx"] = jnp.concatenate(idxs)
            res[f"moe/{case}/pos"] = jnp.concatenate(poss)

        bins = JStateBins(jnp.asarray(inp["ws/u_edges"]), jnp.asarray(inp["ws/v_edges"]))
        ws = [jnp.asarray(inp["ws/q"]), bins, jnp.asarray(inp["ws/occ"]),
              jnp.asarray(inp["ws/scores"]), jnp.asarray(inp["ws/tp"])]
        cell = jax_build_cell("websearch-rl", "serve_queries", mesh=mesh, reduced=True)
        for name, v in zip(("cand", "u", "cand_cnt"), jax.jit(
                cell.fn, in_shardings=cell.in_shardings)(*ws)):
            res[f"ws/{name}"] = v
        cell = jax_build_cell("websearch-rl", "rl_rollout", mesh=mesh, reduced=True)
        q_new, metrics = jax.jit(cell.fn, in_shardings=cell.in_shardings)(
            *ws, jnp.asarray(inp["ws/prod_r"]), jax.random.key(DRAWS_KEY))
        res["ws/q_new"] = q_new
        for k, v in metrics.items():
            res[f"ws/metric/{k}"] = v

        for case, jcfg in rs_cfgs.items():
            arch = RECSYS_CASES[case][0]
            jp = jax.tree_util.tree_map(jnp.asarray, _unflat(npz, f"rs/{case}"))
            batch = [jnp.asarray(a) for a in inp[f"rs/{case}/train"]]
            cell = jax_build_cell(arch, "train_batch", mesh=mesh, reduced=True,
                                  cfg_override=jcfg)
            jopt = jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype),
                                          cell.args[1])
            new_p, _, loss = jax.jit(cell.fn, in_shardings=cell.in_shardings)(
                jp, jopt, *batch)
            grads = jax.jit(jax.grad(lambda q, bt, arch=arch, jcfg=jcfg: _jax_loss(
                jrec, jax, jnp, arch, jcfg, q, bt, mesh)))(jp, batch)
            res[f"rs/{case}/loss"] = loss
            _flat(grads, f"rs/{case}/grad", res)
            _flat(new_p, f"rs/{case}/new", res)
            for shape in RECSYS_SERVE:
                cell = jax_build_cell(arch, shape, mesh=mesh, reduced=True,
                                      cfg_override=jcfg)
                args = [jnp.asarray(a) for a in inp[f"rs/{case}/{_serve_kind(shape)}"]]
                outs = jax.jit(cell.fn, in_shardings=cell.in_shardings)(jp, *args)
                outs = tuple(outs) if isinstance(outs, (tuple, list)) else (outs,)
                for i, o in enumerate(outs):
                    res[f"rs/{case}/{shape}/{i}"] = o

        comp = shard_map(
            lambda g, r: (compress_with_feedback(g, r),
                          compressed_psum_grads(g, r, "data")),
            mesh=mesh, in_specs=(JP("data"), JP("data")),
            out_specs=((JP("data"), JP("data")), (JP("data"), JP("data"))),
            check_rep=False)
        g = jax.tree_util.tree_map(jnp.asarray, inp["cg/grads"])
        r = jax.tree_util.tree_map(jnp.asarray, inp["cg/residual"])
        (payload, res1), (mean, res2) = jax.jit(comp)(g, r)
        _flat(jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), payload),
              "cg/payload", res)
        _flat(res1, "cg/residual", res)
        _flat(mean, "cg/mean", res)
        _flat(res2, "cg/residual2", res)

    res = {k: np.asarray(v) for k, v in res.items()}
    np.savez(out / "oracle.npz", **res)
    print(f"oracle: outputs in {time.perf_counter() - t0:.1f} s", flush=True)


def _jax_loss(jrec, jax, jnp, arch, jcfg, params, batch, mesh):
    """The reference train cell's loss through its sharded forwards."""
    if arch == "bert4rec":
        seq, mask_pos, mask_tgt, negs = batch
        h = jrec.bert4rec_forward(params, seq, jcfg, mesh=mesh)
        hm = jnp.take_along_axis(h, mask_pos[..., None], axis=1)
        emb = params["item_embed"]
        pos_s = jnp.sum(hm * jnp.take(emb, mask_tgt, axis=0), -1)
        neg_s = jnp.einsum("bme,bne->bmn", hm, jnp.take(emb, negs, axis=0))
        alls = jnp.concatenate([pos_s[..., None], neg_s], -1)
        return -jnp.mean(jax.nn.log_softmax(alls.astype(jnp.float32))[..., 0])
    sparse, dense, labels = batch
    if arch == "wide-deep":
        logits = jrec.wide_deep_forward(params, sparse, jcfg, dense, mesh=mesh)
    elif arch == "deepfm":
        logits = jrec.deepfm_forward(params, sparse, jcfg, mesh=mesh)
    else:
        logits = jrec.dcn_forward(params, sparse, jcfg, dense, mesh=mesh)
    return jrec.bce_loss(logits, labels)


# ------------------------------------------------------------ the port
def _rank(rank: int, out: Path):
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(str(out / "store"), WORLD),
                            rank=rank, world_size=WORLD)
    try:
        res = _port_checks(rank, out)
        if rank == 0:
            np.savez(out / "port.npz", **res)
    finally:
        dist.destroy_process_group()


def _port_checks(rank: int, out: Path):
    import dataclasses
    import types
    from unittest import mock

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_arch
    from repro_torch.core.state_bins import StateBins
    from repro_torch.distributed import (NamedSharding, P, place_tree, restore,
                                         save, sharded_bag_sum, sharded_lookup,
                                         sharded_lookup_rs)
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.distributed.collectives import (compress_with_feedback,
                                                     compressed_psum_grads,
                                                     shard_in, shard_out)
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import build_cell, recsys_loss_and_grads
    from repro_torch.models.moe import (MoEConfig, build_dispatch,
                                        moe_capacity, moe_ffn_sharded,
                                        router_topk)
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.tree import tree_leaves, tree_map
    from repro_torch.weights import (lm_params_from_reference,
                                     recsys_params_from_reference)

    res = {}
    # no quiet fallback: a cuda mesh with more ranks than cards raises
    try:
        make_local_mesh(DATA, MODEL)
    except RuntimeError as e:
        res["err/no_cuda"] = np.array(str(e))
    with mock.patch.object(torch.cuda, "is_available", lambda: True), \
            mock.patch.object(torch.cuda, "device_count", lambda: 1):
        try:
            make_local_mesh(DATA, MODEL, device="cuda")
        except RuntimeError as e:
            res["err/too_many_ranks"] = np.array(str(e))
    mesh = make_local_mesh(DATA, MODEL, device="cpu")
    inp = _inputs()
    for _ in range(int(TIMEOUT_S / 0.2)):
        if (out / "params.ready").exists():
            break
        time.sleep(0.2)
    npz = np.load(out / "params.npz")

    def full(x):
        return (x.full_tensor() if isinstance(x, DTensor) else x).detach().numpy()

    t = torch.from_numpy
    with torch.no_grad():
        table, idx = t(inp["table"]), t(inp["idx"])
        res["lookup"] = full(sharded_lookup(table, idx, mesh))
        res["lookup_rs"] = full(sharded_lookup_rs(table, idx, mesh))
        res["bag"] = full(sharded_bag_sum(table, t(inp["bag_idx"]), mesh))
        res["bag_wide"] = full(sharded_bag_sum(t(inp["wide"]), t(inp["bag_idx"]),
                                               mesh))

        x = t(inp["moe_x"])
        f32 = types.SimpleNamespace(param_dtype=torch.float32)
        for case, (e, k, fsdp, _) in MOE_CASES.items():
            cfg = MoEConfig(n_experts=e, top_k=k, d_model=MOE_D, d_ff=MOE_FF,
                            capacity_factor=8.0)
            p = lm_params_from_reference(_unflat(npz, f"moe/{case}"), f32, "cpu")
            o, aux = moe_ffn_sharded(p, x, cfg, mesh, fsdp=fsdp)
            res[f"moe/{case}/out"] = full(o)
            x_l = shard_in(x, mesh, P("data"))
            _, i, _ = router_topk(p["router"], x_l, k)
            pos, _, _ = build_dispatch(i, e, moe_capacity(cfg, x_l.shape[0]))
            res[f"moe/{case}/idx"] = full(shard_out(i, mesh, P("data", None)))
            res[f"moe/{case}/pos"] = full(shard_out(pos, mesh, P("data", None)))

        ws = [t(inp["ws/q"]), StateBins(t(inp["ws/u_edges"]), t(inp["ws/v_edges"])),
              t(inp["ws/occ"].view(np.int32)), t(inp["ws/scores"]), t(inp["ws/tp"])]
        cell = build_cell("websearch-rl", "serve_queries", mesh=mesh, reduced=True)
        placed = [ws[0], ws[1]] + [place_tree(a, s) for a, s in
                                   zip(ws[2:], cell.in_shardings[2:])]
        for name, v in zip(("cand", "u", "cand_cnt"), cell.fn(*placed)):
            res[f"ws/{name}"] = full(v)
        cell = build_cell("websearch-rl", "rl_rollout", mesh=mesh, reduced=True)
        draws = (t(npz["draws/explore"]), t(npz["draws/uniform"]))
        q_new, metrics = cell.fn(*ws, t(inp["ws/prod_r"]), draws)
        res["ws/q_new"] = full(q_new)
        for k, v in metrics.items():
            res[f"ws/metric/{k}"] = full(v)

    for case in RECSYS_CASES:
        arch, cfg = _configs(case)
        host = recsys_params_from_reference(_unflat(npz, f"rs/{case}"), cfg, "cpu")
        cell = build_cell(arch, "train_batch", mesh=mesh, reduced=True,
                          cfg_override=cfg)
        params = place_tree(host, cell.in_shardings[0])
        opt = place_tree(adamw_init(host, AdamWConfig(lr=1e-3)), cell.in_shardings[1])
        batch = [t(a) for a in inp[f"rs/{case}/train"]]
        _, grads = recsys_loss_and_grads(arch, cfg, params, *batch, mesh=mesh)
        grads = tree_map(lambda g, p: DTensor.from_local(g, mesh, p.placements),
                         grads, params)
        _flat(tree_map(full, grads), f"rs/{case}/grad", res)
        params, opt, loss = cell.fn(params, opt, *batch)
        res[f"rs/{case}/loss"] = loss.numpy()
        _flat(tree_map(full, params), f"rs/{case}/new", res)
        assert int(opt["count"].full_tensor()) == 1
        with torch.no_grad():
            params = place_tree(host, cell.in_shardings[0])
            for shape in RECSYS_SERVE:
                cell = build_cell(arch, shape, mesh=mesh, reduced=True,
                                  cfg_override=cfg)
                args = [t(a) for a in inp[f"rs/{case}/{_serve_kind(shape)}"]]
                args = [place_tree(a, s) for a, s in zip(args, cell.in_shardings[1:])]
                outs = cell.fn(params, *args)
                outs = outs if isinstance(outs, tuple) else (outs,)
                for i, o in enumerate(outs):
                    res[f"rs/{case}/{shape}/{i}"] = full(o)

    d = mesh.get_local_rank("data")
    g = {k: t(v[d]) for k, v in inp["cg/grads"].items()}
    r = {k: t(v[d]) for k, v in inp["cg/residual"].items()}
    payload, res1 = compress_with_feedback(g, r)
    mean, res2 = compressed_psum_grads(g, r, mesh, "data")
    for name, tree in (("payload", payload), ("residual", res1), ("mean", mean),
                       ("residual2", res2)):
        for k, v in tree.items():
            res[f"cg/{name}/{k}"] = full(shard_out(v.float()[None], mesh, P("data")))

    logical = {k: t(np.asarray(v)) for k, v in inp["ckpt"].items()}
    logical["bf"] = logical["bf"].to(torch.bfloat16)
    if rank == 0:
        save(out / "ckpt", 7, logical)
        CheckpointManager(out / "ckpt_mgr").save(3, logical)
    dist.barrier()
    shardings = {k: NamedSharding(mesh, P(*s)) for k, s in CKPT_SPECS.items()}
    shardings["count"] = None
    like = {k: torch.zeros_like(v) for k, v in logical.items()}
    got = restore(out / "ckpt", 7, like, shardings=shardings)
    got2, step = CheckpointManager(out / "ckpt_mgr").restore(like, shardings=shardings)
    ok = step == 3
    for k, v in logical.items():
        for tree in (got, got2):
            if k in CKPT_SPECS:
                ok &= isinstance(tree[k], DTensor)
                ok &= tuple(tree[k].placements) == shardings[k].placements
            ok &= torch.equal(tree[k].full_tensor() if k in CKPT_SPECS
                              else tree[k], v)
    res["ckpt/ok"] = np.array(bool(ok))
    res["ckpt/block_rows"] = np.array(got["embed"].to_local().shape[0])
    return res


def _ranks(out: Path):
    import torch.multiprocessing as mp

    mp.spawn(_rank, args=(out,), nprocs=WORLD, join=True)


# ------------------------------------------------------------ the tests
@pytest.fixture(scope="module")
def mesh_results(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    procs = {}
    for mode in ("oracle", "ranks"):
        log = open(out / f"{mode}.log", "w")
        procs[mode] = (subprocess.Popen(
            [sys.executable, __file__, f"--{mode}", str(out)], env=env,
            stdout=log, stderr=subprocess.STDOUT), log)
    for mode, (proc, log) in procs.items():
        try:
            rc = proc.wait(timeout=TIMEOUT_S)
        finally:
            if proc.poll() is None:
                proc.kill()
            log.close()
        assert rc == 0, (f"{mode} exited {rc}:\n"
                         f"{(out / f'{mode}.log').read_text()[-4000:]}")
    return np.load(out / "oracle.npz"), np.load(out / "port.npz")


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def test_sharded_lookup_and_lookup_rs_bit_equal(mesh_results):
    ref, port = mesh_results
    table, idx = _inputs()["table"], _inputs()["idx"]
    for name in ("lookup", "lookup_rs"):
        np.testing.assert_array_equal(port[name], ref[name], err_msg=name)
        np.testing.assert_array_equal(port[name], table[idx], err_msg=name)


def test_sharded_bag_sum(mesh_results):
    ref, port = mesh_results
    for name in ("bag", "bag_wide"):
        np.testing.assert_allclose(port[name], ref[name], rtol=1e-6, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_ffn_sharded(mesh_results, case):
    ref, port = mesh_results
    tol = MOE_CASES[case][3]
    np.testing.assert_allclose(port[f"moe/{case}/out"], ref[f"moe/{case}/out"],
                               rtol=0, atol=tol)
    # and the reference's own sharded/local agreement, on these weights
    np.testing.assert_allclose(ref[f"moe/{case}/out"], ref[f"moe/{case}/local"],
                               rtol=0, atol=tol)
    for name in ("idx", "pos"):
        np.testing.assert_array_equal(port[f"moe/{case}/{name}"],
                                      ref[f"moe/{case}/{name}"], err_msg=name)


def test_websearch_serve_bit_equal(mesh_results):
    ref, port = mesh_results
    for name in ("cand", "u", "cand_cnt"):
        want = ref[f"ws/{name}"]
        want = want.view(np.int32) if want.dtype == np.uint32 else want
        np.testing.assert_array_equal(port[f"ws/{name}"], want, err_msg=name)
    # the reference's own invariants: unique, sorted, in-range ids; u > 0
    n_docs = _inputs()["ws/scores"].shape[1]
    for row in port["ws/cand"]:
        ids = row[row >= 0]
        assert len(np.unique(ids)) == len(ids)
        assert (np.diff(ids) > 0).all() and (ids < n_docs).all()
    assert (port["ws/u"] > 0).all() and port["ws/cand_cnt"].sum() > 0


def test_websearch_rl_rollout(mesh_results):
    ref, port = mesh_results
    want = ref["ws/q_new"]
    np.testing.assert_allclose(port["ws/q_new"], want, rtol=0,
                               atol=Q_TOL * (1 + np.abs(want).max()))
    names = sorted(k for k in ref.files if k.startswith("ws/metric/"))
    assert names == sorted(k for k in port.files if k.startswith("ws/metric/"))
    for k in names:
        np.testing.assert_allclose(port[k], ref[k], rtol=Q_TOL, atol=Q_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("case", list(RECSYS_CASES))
def test_recsys_train_step(mesh_results, case):
    ref, port = mesh_results
    np.testing.assert_allclose(port[f"rs/{case}/loss"], ref[f"rs/{case}/loss"],
                               rtol=TRAIN_TOL)
    for part in ("grad", "new"):
        keys = sorted(k for k in ref.files if k.startswith(f"rs/{case}/{part}/"))
        assert keys and keys == sorted(
            k for k in port.files if k.startswith(f"rs/{case}/{part}/"))
        for k in keys:
            assert port[k].shape == ref[k].shape, k
            assert _rel_l2(port[k], ref[k]) <= TRAIN_TOL, k


@pytest.mark.parametrize("shape", RECSYS_SERVE)
@pytest.mark.parametrize("case", list(RECSYS_CASES))
def test_recsys_serve(mesh_results, case, shape):
    ref, port = mesh_results
    keys = sorted(k for k in ref.files if k.startswith(f"rs/{case}/{shape}/"))
    assert keys and keys == sorted(
        k for k in port.files if k.startswith(f"rs/{case}/{shape}/"))
    for k in keys:
        if ref[k].dtype.kind in "iu":
            np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
        else:
            np.testing.assert_allclose(port[k], ref[k], rtol=SERVE_TOL,
                                       atol=SERVE_TOL, err_msg=k)


def test_compressed_psum_grads(mesh_results):
    ref, port = mesh_results
    for leaf in ("a", "b"):
        for name in ("payload", "residual", "residual2"):
            np.testing.assert_array_equal(port[f"cg/{name}/{leaf}"],
                                          ref[f"cg/{name}/{leaf}"],
                                          err_msg=f"{name}/{leaf}")
        got, want = port[f"cg/mean/{leaf}"], ref[f"cg/mean/{leaf}"]
        assert _rel_l2(got, want) <= 1e-2
        np.testing.assert_array_equal(got[0], got[1])   # one mean on every rank


def test_restore_onto_mesh_bit_equal(mesh_results):
    _, port = mesh_results
    assert bool(port["ckpt/ok"])
    assert int(port["ckpt/block_rows"]) == 64 // MODEL


def test_cuda_mesh_never_falls_back(mesh_results):
    """No CUDA: a default (cuda) mesh raises; more ranks than cards
    raises too, naming both counts."""
    _, port = mesh_results
    assert "CUDA" in str(port["err/no_cuda"])
    assert "8 ranks need 8 cards" in str(port["err/too_many_ranks"])


if __name__ == "__main__":
    mode, where = sys.argv[1], Path(sys.argv[2])
    {"--oracle": _oracle, "--ranks": _ranks}[mode](where)
