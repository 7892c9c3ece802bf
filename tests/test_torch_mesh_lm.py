"""The port's LM and GNN cells on a mesh, rank by rank, against the
reference's ``build_cell(..., mesh=, reduced=True)`` on the CPU.

The same two-process design as ``tests/test_torch_mesh.py``, from one
set of numpy inputs:

- the oracle (``python tests/test_torch_mesh_lm.py --oracle DIR``) sets
  ``XLA_FLAGS`` for 8 host devices before it imports JAX, builds an
  Auto-axis 2 x 4 ``jax.sharding.Mesh`` ("data", "model"), writes the
  reference's parameters first (``params.npz``), then every cell's
  outputs (``oracle.npz``);
- the port (``--ranks DIR``) spawns an 8-rank gloo world on a 2 x 4
  ``make_local_mesh``, carries the parameters across with ``weights.py``,
  places them under each cell's ``in_shardings`` (``place_tree``) and
  writes rank 0's view (``port.npz``).

Cells: for mistral-nemo-12b (dense GQA, 2 KV heads on the 4-way model
axis: a rank's wk/wv block is half a head), deepseek-v2-lite-16b (MLA,
MoE with EP and a shared expert) and grok-1-314b (GQA, MoE with TP over
d_ff), one ``train_4k`` step (``sp_carry``: S = 64 lies over model),
``prefill_32k`` and ``decode_32k`` (positions 5, 17, 40, 63 on a
sequence split into four slices of 16: rows whose slice on a rank holds
no valid key); starcoder2-3b with 6 query heads (``h6``, d_head 32,
2 KV heads) on ``train_4k``, ``prefill_32k`` and ``decode_32k``: 192
columns of wq, 48 a rank on the 4-way model axis, 1.5 heads, as its 24
heads are 1.5 a rank on the production meshes' 16-way axis (before the
port gathered the heads where the axis cuts one, each of the three
raised ``HeadSplit.q_heads``' "6 query heads do not split over the
4-way 'model' axis"); deepseek-v2-lite-16b with 6 MLA heads (``mla6``)
on the same three cells: 144 columns of wq and 96 of w_uk and w_uv, 1.5
heads a rank (before the port gathered them, the same raise); the ``cfg_override`` cases: a dense step with ``zero3``
(B = 4 does not divide data x model, so the rows lie over data and are
replicated over model), deepseek's step with ``remat`` and 2
microbatches, deepseek's step with 4 microbatches (one row each, which
does not divide the 2 data ranks: the rows are replicated, and the MoE
routes each data rank's half of the 64 flat tokens with its own
capacity, as the reference's ``_apply_moe_ffn`` splits them), grok's decode at B = 1 (batch replicated, tokens
replicated into the MoE); all four graphsage-reddit cells (edges over
all 8 ranks) and full_graph_sm with the max aggregator (a ring in the
edges, so that no segment is empty: an empty one is -inf in both).

Tolerances, and why:

- a train step's loss, grad norm, every updated parameter and every
  moment leaf within 1e-4 relative L2 (``TRAIN_TOL``): the port sums in
  other orders than XLA (gloo's all-reduce, the rank-order norm, the
  vocab-parallel logsumexp), all float32; the loss is rank 0's value,
  whose MoE aux term is data shard 0's (the reference's shard_map
  output, read from device 0);
- prefill's logits and sequence-sharded cache, decode's logits and the
  cache with its written rows, within 1e-4 + 1e-4 |x| (``INFER_TOL``):
  float32 partial sums over ranks against XLA's;
- the GNN cells' loss and every leaf within 1e-4 relative L2.

The mutation: deepseek's step again, with the sum over ``model`` of
ln1's gradient under ``sp_carry`` dropped (each rank then keeps its S
slice's share); its leaves must fail the same check.
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
LM_ARCHS = ("mistral-nemo-12b", "deepseek-v2-lite-16b", "grok-1-314b")
# model -> (arch, config changes): each arch's reduced config, and h6
# and mla6, whose query heads do not divide the model axis (their own
# parameters)
LM_MODELS = {a: (a, {}) for a in LM_ARCHS}
LM_MODELS["h6"] = ("starcoder2-3b", {"n_heads": 6})
LM_MODELS["mla6"] = ("deepseek-v2-lite-16b", {"n_heads": 6})
# case -> (model, config changes)
TRAIN_CASES = {a: (a, {}) for a in LM_MODELS}
TRAIN_CASES["zero3"] = ("mistral-nemo-12b", {"zero3": True})
TRAIN_CASES["remat_mb2"] = ("deepseek-v2-lite-16b", {"remat": True, "microbatch": 2})
TRAIN_CASES["mb4"] = ("deepseek-v2-lite-16b", {"microbatch": 4})
DECODE_CASES = {a: (a, 4) for a in LM_MODELS}     # case -> (model, batch)
DECODE_CASES["b1"] = ("grok-1-314b", 1)
GNN_CASES = {s: (s, "mean") for s in ("full_graph_sm", "minibatch_lg",
                                      "ogb_products", "molecule")}
GNN_CASES["max"] = ("full_graph_sm", "max")
MUTANT = "remat_mb2"
TRAIN_TOL = GNN_TOL = 1e-4
INFER_TOL = 1e-4


# ------------------------------------------------------------ shared
def _flat(tree, prefix, out):
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
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


def _model_cfg(get_arch, model, changes=None):
    """(arch, the model's reduced config with ``changes``), through the
    given package's ``get_arch``."""
    import dataclasses

    arch, own = LM_MODELS[model]
    cfg = dataclasses.replace(get_arch(arch).model_cfg(True), **own,
                              **(changes or {}))
    if cfg.mla is not None:         # MLA reads the heads of its own config
        cfg = dataclasses.replace(cfg, mla=dataclasses.replace(
            cfg.mla, n_heads=cfg.n_heads))
    return arch, cfg


def _lm_shapes(model):
    """(the cache's fields and their trailing dims, the reduced config)."""
    from repro_torch.configs import get_arch

    _, cfg = _model_cfg(get_arch, model)
    if cfg.attn_kind == "mla":
        return {"c": (cfg.mla.kv_lora_rank,), "k_rope": (cfg.mla.d_rope,)}, cfg
    return {"k": (cfg.n_kv, cfg.d_head), "v": (cfg.n_kv, cfg.d_head)}, cfg


def _inputs():
    """Every input, from one numpy seed."""
    from repro_torch.launch.steps import REDUCED_SHAPES, minibatch_budgets

    rng = np.random.default_rng(SEED)
    inp = {}
    tr, pf, dc = (REDUCED_SHAPES[k] for k in ("train", "prefill", "decode"))
    for arch in LM_ARCHS:
        fields, cfg = _lm_shapes(arch)
        b, s = tr["global_batch"], tr["seq_len"]
        tok = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
        inp[f"{arch}/tokens"], inp[f"{arch}/targets"] = tok[:, :-1], tok[:, 1:]
        inp[f"{arch}/prompt"] = rng.integers(
            0, cfg.vocab, (pf["global_batch"], pf["seq_len"])).astype(np.int32)
    for case, (model, b) in DECODE_CASES.items():
        if model not in LM_ARCHS:
            continue                        # drawn below, from their own seed
        fields, cfg = _lm_shapes(model)
        s = dc["seq_len"]
        inp[f"dec/{case}/token"] = rng.integers(0, cfg.vocab, (b,)).astype(np.int32)
        inp[f"dec/{case}/pos"] = np.array([5, 17, 40, 63][:b] if b > 1 else [21],
                                          np.int32)
        for f, tail in fields.items():
            inp[f"dec/{case}/cache/{f}"] = (0.5 * rng.normal(
                size=(cfg.n_layers, b, s) + tail)).astype(np.float32)

    g = REDUCED_SHAPES["train_graph"]
    n, e = g["n_nodes"], g["n_edges"]
    edges = rng.integers(0, n, (2, e)).astype(np.int32)
    edges[:, -8:] = n                                 # padding: dummy src, dst
    ring = np.stack([np.arange(n), (np.arange(n) + 1) % n]).astype(np.int32)
    for case in ("full_graph_sm", "ogb_products", "max"):
        inp[f"gnn/{case}"] = [
            rng.normal(size=(n, g["d_feat"])).astype(np.float32),
            np.concatenate([ring, edges[:, :e - n]], 1) if case == "max" else edges,
            rng.integers(0, g["n_classes"], n).astype(np.int32),
            (rng.random(n) < 0.5).astype(np.float32)]
    m = REDUCED_SHAPES["train_minibatch"]
    bn = m["batch_nodes"]
    e1, fr1, e0, fr0 = minibatch_budgets(bn, m["fanout"])
    src0, dst0 = rng.integers(0, fr0, e0), rng.integers(0, fr1, e0)
    src1, dst1 = rng.integers(0, fr1, e1), rng.integers(0, bn, e1)
    src0[-16:], dst0[-16:], src1[-4:], dst1[-4:] = fr0, fr1, fr1, bn  # padding
    inp["gnn/minibatch_lg"] = [
        rng.normal(size=(fr0, m["d_feat"])).astype(np.float32),
        *(x.astype(np.int32) for x in (src0, dst0, src1, dst1)),
        rng.integers(0, m["n_classes"], bn).astype(np.int32)]
    mo = REDUCED_SHAPES["train_batched_graphs"]
    bsz, npg, epg = mo["batch"], mo["n_nodes"], mo["n_edges"]
    off = np.repeat(np.arange(bsz) * npg, epg)
    inp["gnn/molecule"] = [
        rng.normal(size=(bsz * npg, mo["d_feat"])).astype(np.float32),
        (rng.integers(0, npg, (2, bsz * epg)) + off).astype(np.int32),
        np.repeat(np.arange(bsz), npg).astype(np.int32),
        rng.integers(0, mo["n_classes"], bsz).astype(np.int32)]
    inp["gnn/readout"] = {
        "w": (0.3 * rng.normal(size=(mo["n_classes"],) * 2)).astype(np.float32),
        "b": np.zeros(mo["n_classes"], np.float32)}
    # the models past the archs, from a seed of their own, so that the
    # inputs above stay as they were
    rng = np.random.default_rng(SEED + 1)
    for model in LM_MODELS:
        if model in LM_ARCHS:
            continue
        fields, cfg = _lm_shapes(model)
        b, s = tr["global_batch"], tr["seq_len"]
        tok = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
        inp[f"{model}/tokens"], inp[f"{model}/targets"] = tok[:, :-1], tok[:, 1:]
        inp[f"{model}/prompt"] = rng.integers(
            0, cfg.vocab, (pf["global_batch"], pf["seq_len"])).astype(np.int32)
        b, s = DECODE_CASES[model][1], dc["seq_len"]
        inp[f"dec/{model}/token"] = rng.integers(0, cfg.vocab, (b,)).astype(np.int32)
        inp[f"dec/{model}/pos"] = np.array([5, 17, 40, 63][:b], np.int32)
        for f, tail in fields.items():
            inp[f"dec/{model}/cache/{f}"] = (0.5 * rng.normal(
                size=(cfg.n_layers, b, s) + tail)).astype(np.float32)
    return inp


# ------------------------------------------------------------ the oracle
def _oracle(out: Path):
    flags = [f for f in os.environ.get("XLA_FLAGS", "").split()
             if not f.startswith("--xla_force_host_platform_device_count")]
    os.environ["XLA_FLAGS"] = " ".join(
        flags + [f"--xla_force_host_platform_device_count={WORLD}"])
    sys.path.insert(0, str(ROOT / "src"))
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding

    from repro.configs import get_arch as jax_get_arch
    from repro.distributed.sharding_rules import kv_cache_specs
    from repro.launch.steps import build_cell as jax_build_cell
    from repro.models import gnn as jgnn
    from repro.models import transformer as jtf

    assert len(jax.devices()) >= WORLD
    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(DATA, MODEL),
                ("data", "model"))
    inp = _inputs()
    res, params = {}, {}
    for i, model in enumerate(LM_MODELS):
        _, cfg = _model_cfg(jax_get_arch, model)
        _flat(jax.tree_util.tree_map(np.asarray, jtf.init_params(
            jax.random.key(10 + i), cfg)), f"p/{model}", params)
    gcfg = jax_get_arch("graphsage-reddit").model_cfg(True)
    for shape in ("full_graph_sm", "minibatch_lg", "molecule"):
        d_in = 16
        c = jgnn.SAGEConfig(d_in=d_in, d_hidden=gcfg.d_hidden,
                            n_classes=2 if shape == "molecule" else 7,
                            n_layers=gcfg.n_layers)
        _flat(jax.tree_util.tree_map(np.asarray, jgnn.sage_init(
            jax.random.key(20), c)), f"p/gnn/{shape}", params)
    np.savez(out / "params.npz", **params)
    (out / "params.ready").touch()
    t0 = time.perf_counter()
    npz = np.load(out / "params.npz")

    def named(tree):
        return jax.tree_util.tree_map(lambda s: NamedSharding(mesh, s), tree)

    def zeros(abs_tree):
        return jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape, a.dtype), abs_tree)

    with mesh:
        for case, (model, changes) in TRAIN_CASES.items():
            arch, cfg = _model_cfg(jax_get_arch, model, changes)
            cell = jax_build_cell(arch, "train_4k", mesh=mesh, reduced=True,
                                  cfg_override=cfg)
            p = jax.tree_util.tree_map(jnp.asarray, _unflat(npz, f"p/{model}"))
            in_sh = cell.in_shardings[:2] + (None, None)   # zero3: B < data x model
            new_p, new_o, met = jax.jit(cell.fn, in_shardings=in_sh)(
                p, zeros(cell.args[1]), jnp.asarray(inp[f"{model}/tokens"]),
                jnp.asarray(inp[f"{model}/targets"]))
            res[f"train/{case}/loss"] = met["loss"]
            res[f"train/{case}/grad_norm"] = met["grad_norm"]
            _flat(new_p, f"train/{case}/new", res)
            _flat({"mu": new_o["mu"], "nu": new_o["nu"]}, f"train/{case}/opt", res)
        for model in LM_MODELS:
            arch, cfg = _model_cfg(jax_get_arch, model)
            p = jax.tree_util.tree_map(jnp.asarray, _unflat(npz, f"p/{model}"))
            cell = jax_build_cell(arch, "prefill_32k", mesh=mesh, reduced=True,
                                  cfg_override=cfg)
            logits, cache = jax.jit(cell.fn, in_shardings=cell.in_shardings)(
                p, jnp.asarray(inp[f"{model}/prompt"]))
            res[f"prefill/{model}/logits"] = logits
            _flat(cache, f"prefill/{model}/cache", res)
        for case, (model, b) in DECODE_CASES.items():
            arch, cfg = _model_cfg(jax_get_arch, model)
            p = jax.tree_util.tree_map(jnp.asarray, _unflat(npz, f"p/{model}"))
            cache = {f: jnp.asarray(v) for f, v in
                     _unflat(_NpzView(inp), f"dec/{case}/cache").items()}
            c_sh = named(kv_cache_specs(cache, mesh))
            fn = lambda p, t, c, pos, cfg=cfg: jtf.decode_step(p, t, c, pos, cfg, mesh)
            cell = jax_build_cell(arch, "decode_32k", mesh=mesh, reduced=True,
                                  cfg_override=cfg)
            logits, new = jax.jit(fn, in_shardings=(cell.in_shardings[0], None, c_sh,
                                                    None))(
                p, jnp.asarray(inp[f"dec/{case}/token"]), cache,
                jnp.asarray(inp[f"dec/{case}/pos"]))
            res[f"decode/{case}/logits"] = logits
            _flat(new, f"decode/{case}/cache", res)
        for case, (shape, agg) in GNN_CASES.items():
            over = (None if agg == "mean" else dataclasses.replace(
                jax_get_arch("graphsage-reddit").model_cfg(True), aggregator=agg))
            cell = jax_build_cell("graphsage-reddit", shape, mesh=mesh, reduced=True,
                                  cfg_override=over)
            key = "minibatch_lg" if shape == "minibatch_lg" else (
                "molecule" if shape == "molecule" else "full_graph_sm")
            p = jax.tree_util.tree_map(jnp.asarray, _unflat(npz, f"p/gnn/{key}"))
            data = [jnp.asarray(a) for a in inp[f"gnn/{case}"]]
            f = jax.jit(cell.fn, in_shardings=cell.in_shardings)
            if shape == "molecule":
                r = jax.tree_util.tree_map(jnp.asarray, inp["gnn/readout"])
                new_p, new_r, new_o, loss = f(p, r, zeros(cell.args[2]), *data)
                new_p = {"params": new_p, "readout": new_r}
                mu, nu = new_o["mu"], new_o["nu"]
            else:
                new_p, new_o, loss = f(p, zeros(cell.args[1]), *data)
                mu, nu = new_o["mu"], new_o["nu"]
            res[f"gnn/{case}/loss"] = loss
            _flat(new_p, f"gnn/{case}/new", res)
            _flat({"mu": mu, "nu": nu}, f"gnn/{case}/opt", res)

    res = {k: np.asarray(v) for k, v in res.items()}
    np.savez(out / "oracle.npz", **res)
    print(f"oracle: outputs in {time.perf_counter() - t0:.1f} s", flush=True)


class _NpzView:
    """A dict of arrays with ``files``, for ``_unflat``."""

    def __init__(self, d):
        self._d = d
        self.files = [k for k, v in d.items() if isinstance(v, np.ndarray)]

    def __getitem__(self, k):
        return self._d[k]


# ------------------------------------------------------------ the port
def _rank(rank: int, out: Path):
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(str(out / "store"), WORLD),
                            rank=rank, world_size=WORLD)
    try:
        res = _port_checks(out)
        if rank == 0:
            np.savez(out / "port.npz", **res)
    finally:
        dist.destroy_process_group()


def _port_checks(out: Path):
    import dataclasses
    from unittest import mock

    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_arch
    from repro_torch.distributed import place_tree
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import _lm_opt_cfg, build_cell
    from repro_torch.models import transformer as ttf
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.tree import tree_map
    from repro_torch.weights import (gnn_params_from_reference,
                                     lm_params_from_reference)

    mesh = make_local_mesh(DATA, MODEL, device="cpu")
    inp = _inputs()
    for _ in range(int(TIMEOUT_S / 0.2)):
        if (out / "params.ready").exists():
            break
        time.sleep(0.2)
    npz = np.load(out / "params.npz")
    t = torch.from_numpy
    res = {}

    def full(x):
        if isinstance(x, DTensor):
            x = x.full_tensor()
        return x.detach().numpy()

    def train(case, prefix):
        model, changes = TRAIN_CASES[case]
        arch, cfg = _model_cfg(get_arch, model, changes)
        host = lm_params_from_reference(_unflat(npz, f"p/{model}"), cfg, "cpu")
        cell = build_cell(arch, "train_4k", mesh=mesh, reduced=True,
                          cfg_override=cfg)
        params = place_tree(host, cell.in_shardings[0])
        opt = place_tree(adamw_init(host, _lm_opt_cfg(True)), cell.in_shardings[1])
        new_p, new_o, met = cell.fn(params, opt, t(inp[f"{model}/tokens"]),
                                    t(inp[f"{model}/targets"]))
        assert new_p is params and new_o is opt
        res[f"{prefix}/loss"] = met["loss"].to_local().numpy()
        res[f"{prefix}/grad_norm"] = met["grad_norm"].to_local().numpy()
        _flat(tree_map(full, new_p), f"{prefix}/new", res)
        _flat(tree_map(full, {"mu": new_o["mu"], "nu": new_o["nu"]}),
              f"{prefix}/opt", res)

    for case in TRAIN_CASES:
        train(case, f"train/{case}")
    orig = ttf.lm_grad_axes

    def dropped(cfg, ml):
        axes = orig(cfg, ml)
        return lambda path, spec: tuple(
            a for a in axes(path, spec) if not (a == "model" and path.endswith("ln1")))

    with mock.patch.object(ttf, "lm_grad_axes", dropped):
        train(MUTANT, "mutant")

    with torch.no_grad():
        for model in LM_MODELS:
            arch, cfg = _model_cfg(get_arch, model)
            host = lm_params_from_reference(_unflat(npz, f"p/{model}"), cfg, "cpu")
            cell = build_cell(arch, "prefill_32k", mesh=mesh, reduced=True,
                              cfg_override=cfg)
            params = place_tree(host, cell.in_shardings[0])
            logits, cache = cell.fn(params, t(inp[f"{model}/prompt"]))
            res[f"prefill/{model}/logits"] = full(logits)
            _flat(tree_map(full, cache), f"prefill/{model}/cache", res)
        for case, (model, b) in DECODE_CASES.items():
            arch, cfg = _model_cfg(get_arch, model)
            host = lm_params_from_reference(_unflat(npz, f"p/{model}"), cfg, "cpu")
            cell = build_cell(arch, "decode_32k", mesh=mesh, reduced=True,
                              cfg_override=cfg)
            params = place_tree(host, cell.in_shardings[0])
            from repro_torch.distributed import NamedSharding, kv_cache_specs

            cache = {f: t(v.copy()) for f, v in
                     _unflat(_NpzView(inp), f"dec/{case}/cache").items()}
            cache = place_tree(cache, tree_map(lambda s: NamedSharding(mesh, s),
                                               kv_cache_specs(cache, mesh)))
            logits, new = cell.fn(params, t(inp[f"dec/{case}/token"]), cache,
                                  t(inp[f"dec/{case}/pos"]))
            assert new is cache
            res[f"decode/{case}/logits"] = full(logits)
            _flat(tree_map(full, new), f"decode/{case}/cache", res)

    gcfg = get_arch("graphsage-reddit").model_cfg(True)
    for case, (shape, agg) in GNN_CASES.items():
        over = None if agg == "mean" else dataclasses.replace(gcfg, aggregator=agg)
        cell = build_cell("graphsage-reddit", shape, mesh=mesh, reduced=True,
                          cfg_override=over)
        key = shape if shape in ("minibatch_lg", "molecule") else "full_graph_sm"
        host = gnn_params_from_reference(_unflat(npz, f"p/gnn/{key}"), gcfg, "cpu")
        data = [t(a) for a in inp[f"gnn/{case}"]]
        params = place_tree(host, cell.in_shardings[0])
        if shape == "molecule":
            r_host = {k: t(v) for k, v in inp["gnn/readout"].items()}
            readout = place_tree(r_host, cell.in_shardings[1])
            opt = place_tree(adamw_init((host, r_host), AdamWConfig(lr=1e-3)),
                             cell.in_shardings[2])
            new_p, new_r, new_o, loss = cell.fn(params, readout, opt, *data)
            new_p = {"params": new_p, "readout": new_r}
        else:
            opt = place_tree(adamw_init(host, AdamWConfig(lr=1e-3)),
                             cell.in_shardings[1])
            new_p, new_o, loss = cell.fn(params, opt, *data)
        res[f"gnn/{case}/loss"] = full(loss)
        _flat(tree_map(full, new_p), f"gnn/{case}/new", res)
        _flat(tree_map(full, {"mu": new_o["mu"], "nu": new_o["nu"]}),
              f"gnn/{case}/opt", res)
    return res


def _ranks(out: Path):
    import torch.multiprocessing as mp

    mp.spawn(_rank, args=(out,), nprocs=WORLD, join=True)


# ------------------------------------------------------------ the tests
@pytest.fixture(scope="module")
def lm_mesh_results(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_lm")
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


def _leaf_errors(ref, port, prefix, port_prefix=None):
    port_prefix = port_prefix or prefix
    keys = sorted(k for k in ref.files if k.startswith(prefix + "/"))
    assert keys and [port_prefix + k[len(prefix):] for k in keys] == sorted(
        k for k in port.files if k.startswith(port_prefix + "/"))
    out = {}
    for k in keys:
        got = port[port_prefix + k[len(prefix):]]
        assert got.shape == ref[k].shape, k
        out[k] = _rel_l2(got, ref[k])
    return out


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_lm_train_step(lm_mesh_results, case):
    ref, port = lm_mesh_results
    for name in ("loss", "grad_norm"):
        np.testing.assert_allclose(port[f"train/{case}/{name}"],
                                   ref[f"train/{case}/{name}"], rtol=TRAIN_TOL,
                                   err_msg=name)
    for part in ("new", "opt"):
        errs = _leaf_errors(ref, port, f"train/{case}/{part}")
        bad = {k: e for k, e in errs.items() if e > TRAIN_TOL}
        assert not bad, bad


def test_dropped_model_sum_fails_the_check(lm_mesh_results):
    """ln1's gradient left unsummed over model under sp_carry: the same
    check on the same step must fail (the loss itself is unchanged)."""
    ref, port = lm_mesh_results
    np.testing.assert_allclose(port["mutant/loss"], ref[f"train/{MUTANT}/loss"],
                               rtol=TRAIN_TOL)
    errs = _leaf_errors(ref, port, f"train/{MUTANT}/opt", "mutant/opt")
    assert max(e for k, e in errs.items() if k.endswith("ln1")) > TRAIN_TOL


@pytest.mark.parametrize("model", list(LM_MODELS))
def test_lm_prefill_sequence_sharded_cache(lm_mesh_results, model):
    ref, port = lm_mesh_results
    keys = sorted(k for k in ref.files if k.startswith(f"prefill/{model}/"))
    assert keys == sorted(k for k in port.files if k.startswith(f"prefill/{model}/"))
    for k in keys:
        np.testing.assert_allclose(port[k], ref[k], rtol=INFER_TOL, atol=INFER_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_lm_decode_sequence_sharded(lm_mesh_results, case):
    ref, port = lm_mesh_results
    keys = sorted(k for k in ref.files if k.startswith(f"decode/{case}/"))
    assert keys == sorted(k for k in port.files if k.startswith(f"decode/{case}/"))
    inp = _inputs()
    for k in keys:
        np.testing.assert_allclose(port[k], ref[k], rtol=INFER_TOL, atol=INFER_TOL,
                                   err_msg=k)
        if "/cache/" in k:       # the new rows were written, nothing else moved
            f = k.rsplit("/", 1)[1]
            before = inp[f"dec/{case}/cache/{f}"]
            pos = inp[f"dec/{case}/pos"]
            moved = np.any(port[k] != before, axis=tuple(range(3, before.ndim)))
            want = np.zeros_like(moved)
            want[:, np.arange(len(pos)), pos] = True
            np.testing.assert_array_equal(moved, want, err_msg=k)


def test_head_split_whole_heads_or_columns():
    """The head view where the axis divides the query heads and a rank's
    heads read whole KV groups (or lie within one); the gathered heads
    where it does not (24 on 16, 6 on 4, a rank cutting a group); a
    raise only where wq's or wk's columns do not split, naming both
    numbers."""
    from repro_torch.models.attention import HeadSplit

    def split(size):
        return HeadSplit(None, "model", size, 0)

    assert split(16).whole_heads(32, 8, 128) and split(4).whole_heads(4, 2, 32)
    assert split(16).whole_heads(16, 1, 128)              # within one group
    assert not split(16).whole_heads(24, 2, 128)          # 1.5 heads a rank
    assert not split(4).whole_heads(6, 2, 32)
    assert not split(2).whole_heads(12, 3, 32)            # 6 heads cut groups of 4
    with pytest.raises(ValueError, match="6 columns of wq .* 4-way 'model'"):
        split(4).whole_heads(6, 1, 1)
    with pytest.raises(ValueError, match="2 columns of wk .* 4-way 'model'"):
        split(4).whole_heads(4, 1, 2)


def test_head_split_mla_whole_heads_or_columns():
    """MLA's head view where the axis divides the query heads; the
    gathered heads where it does not (6 on 4, 24 on 16); a raise only
    where the columns of wq, w_uk or w_uv do not split.  The column
    heads of a rank's block cut a head where the block does."""
    from repro_torch.models.attention import HeadSplit, MLAConfig

    def mla(h, dn=16, dr=8, dv=16):
        return MLAConfig(d_model=128, n_heads=h, kv_lora_rank=32, d_nope=dn,
                         d_rope=dr, d_v=dv)

    assert HeadSplit(None, "model", 4, 0).mla_whole_heads(mla(4))
    assert HeadSplit(None, "model", 16, 0).mla_whole_heads(mla(16, 128, 64, 128))
    assert not HeadSplit(None, "model", 4, 0).mla_whole_heads(mla(6))
    assert not HeadSplit(None, "model", 16, 0).mla_whole_heads(mla(24, 128, 64, 128))
    with pytest.raises(ValueError, match="18 columns of wq .* 4-way 'model'"):
        HeadSplit(None, "model", 4, 0).mla_whole_heads(mla(6, 1, 2, 4))
    with pytest.raises(ValueError, match="6 columns of w_uv .* 4-way 'model'"):
        HeadSplit(None, "model", 4, 0).mla_whole_heads(mla(6, 2, 2, 1))
    heads = [HeadSplit(None, "model", 4, r).column_heads(6, 16).tolist()
             for r in range(4)]
    assert heads[1] == [1] * 8 + [2] * 16 and sum(heads, []) == [
        h for h in range(6) for _ in range(16)]


@pytest.mark.parametrize("case", list(GNN_CASES))
def test_gnn_edge_sharded_step(lm_mesh_results, case):
    ref, port = lm_mesh_results
    np.testing.assert_allclose(port[f"gnn/{case}/loss"], ref[f"gnn/{case}/loss"],
                               rtol=GNN_TOL)
    for part in ("new", "opt"):
        errs = _leaf_errors(ref, port, f"gnn/{case}/{part}")
        bad = {k: e for k, e in errs.items() if e > GNN_TOL}
        assert not bad, bad


if __name__ == "__main__":
    mode, where = sys.argv[1], Path(sys.argv[2])
    {"--oracle": _oracle, "--ranks": _ranks}[mode](where)
