"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``), one cell of each family at the
reduced configs on a 2 x 4 (data, model) mesh.

Two subprocesses, side by side:

- the oracle (``python tests/test_torch_dryrun.py --oracle DIR``)
  imports the reference's module, which sets ``XLA_FLAGS`` for 512 host
  devices, and runs its ``run_cell`` on an Auto-axis
  ``jax.sharding.Mesh`` over 8 of them (``make_production_mesh``'s
  Explicit axes fail under JAX 0.9).  ``jax.jit`` is given
  ``keep_unused=True``, so that XLA's argument sizes count the arguments
  a step does not read, as the port's placed arguments do;
- the port (``--port DIR``) runs ``run_cell`` as rank 0 of an 8-rank
  ``fake`` process group, with a spy on each kernel wrapper's cost
  channel, and the same counters around a real CPU call of the LM cells.

What must hold, and why:

- every cell ran OK on both sides, and ``collective_bytes`` has the
  reference's names and shape; ``CommDebugMode``'s counts agree with the
  port's counts type by type;
- ``argument_bytes`` and ``alias_bytes`` equal the reference's (the
  same leaves, dtypes and local shards); ``output_bytes`` equals the
  reference's less XLA's tuple index table, 8 bytes an output buffer
  where a step returns more than one (the port's outputs have none).
  The GNN cell is named apart: its reference has ``out_shardings`` None,
  so XLA lays its outputs out as it likes, where the port returns its
  donated arguments in their placed layout (output = the donated
  blocks + the 4-byte loss, all of them aliased);
- the LM cells launch no kernel: the meta count equals the same
  counters around a real CPU call of the same cell, also (port side
  only) for starcoder2-3b with 6 query heads, which do not divide the
  4-way model axis, on its three shapes (``HEADS6``) (prefill and decode:
  FLOPs, bytes and transcendentals; the train step: FLOPs and
  transcendentals, its bytes apart because the embedding gradient's
  ``scatter_rows`` counts each id as a run of its own on meta, where on
  the CPU ``unique_consecutive`` finds the runs of the data);
- the GNN, recsys and websearch cells: each kernel's totals are its
  wrapper's ``cost(...)`` at each call's arguments summed over its
  launches, and the record's FLOPs and bytes are the aten ops' plus the
  kernels';
- ``flops_per_device`` against the reference's, with bounds that follow
  from what each side counts: XLA counts elementwise ops as FLOPs (the
  port's ``FlopCounterMode`` counts matmuls only), counts a scanned
  layer body once (the port counts every layer: the LM cells), and
  splits dense work that the port replicates.  LM (L = 2 layers):
  ref <= port <= L x ref; GNN (the node-wise dense layers run whole on
  every rank, only the edges are split): ref <= port <= 8 x ref; recsys
  (matmuls and the bag's multiply-adds, without the activations):
  0.8 x ref <= port <= ref; websearch (only the rule kernel's reported
  ops, a launch a rule execution at its worst case; XLA counts every
  elementwise op of the rule loop's body once): 0 < port <= ref.

About a minute on one worker, the two subprocesses in parallel.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
WORLD, DATA, MODEL = 8, 2, 4
TIMEOUT_S = 600
CELLS = [("starcoder2-3b", "train_4k"), ("starcoder2-3b", "prefill_32k"),
         ("deepseek-v2-lite-16b", "decode_32k"),
         ("graphsage-reddit", "ogb_products"), ("wide-deep", "serve_bulk"),
         ("websearch-rl", "serve_queries")]
FAMILY = {"starcoder2-3b": "lm", "deepseek-v2-lite-16b": "lm",
          "graphsage-reddit": "gnn", "wide-deep": "recsys",
          "websearch-rl": "websearch"}
# port-only LM cells: 6 query heads of 32 on the 4-way model axis, 48
# columns of wq a rank (1.5 heads), as starcoder2-3b's 24 on 16 ranks
HEADS6 = [("starcoder2-3b", s, {"n_heads": 6})
          for s in ("train_4k", "prefill_32k", "decode_32k")]
LM_LAYERS = 2                           # the reduced LMs' depth
XLA_TUPLE_ENTRY = 8                     # bytes an output in XLA's tuple table


# ------------------------------------------------------------ the oracle
def _oracle(out: Path):
    sys.path.insert(0, str(ROOT / "src"))
    import functools

    from repro.launch import dryrun as jd      # sets XLA_FLAGS first

    import jax
    import numpy as np
    from jax.sharding import Mesh

    from repro.launch.steps import build_cell

    jd.jax.jit = functools.partial(jax.jit, keep_unused=True)
    mesh = Mesh(np.array(jax.devices()[:WORLD]).reshape(DATA, MODEL),
                ("data", "model"))
    res = {}
    for arch, shape in CELLS:
        rec = jd.run_cell(arch, shape, mesh, "local2x4", reduced=True)
        cell = build_cell(arch, shape, mesh=mesh, reduced=True)
        with mesh:
            outs = jax.eval_shape(cell.fn, *cell.args)
        rec["n_outputs"] = len(jax.tree_util.tree_leaves(outs))
        res[f"{arch}/{shape}"] = rec
    (out / "oracle.json").write_text(json.dumps(res))


# ------------------------------------------------------------ the port
def _kernel_spies():
    """Patches of each kernel wrapper's ``run`` that record the cost
    ``cost(...)`` gives at the call's arguments, by kernel name."""
    import importlib
    from unittest import mock

    import numpy as np

    from repro_torch.kernels import cost as kcost

    bsp, bsr, bag, sg = (
        importlib.import_module(f"repro_torch.kernels.{m}") for m in (
            "block_scan.block_scan_pruned", "block_scan.block_scan_rule",
            "embedding_bag.ops", "segment_gather.ops"))

    seen = {}

    def own_cost(module, args):
        if module is sg:
            return sg.cost(*args)
        if module is bag:
            _, table, indices, weights, _ = args
            return bag.cost(table, indices, weights is not None)
        if module is bsr:
            cfg, occ = args[:2]
            b, nb, t, f, w = occ.shape
            return bsr.rule_cost(np.full(b, t * f), np.full(b, nb), nb, t, f,
                                 w, cfg.max_candidates, cfg.n_top)
        occ, meta, chunk, n_terms = args
        b, nb, tf, w = occ.shape
        return bsp.chunk_cost(np.full(b, tf), np.zeros(b), nb, chunk, w,
                              meta.shape[2], n_terms, worst_case=True)

    def spy(module):
        def run(name, cost, fn, *args):
            c = own_cost(module, args)
            k = seen.setdefault(name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
            k["calls"] += 1
            k["flops"] += float(c.flops)
            k["bytes"] += float(c.bytes)
            return kcost.run(name, cost, fn, *args)
        return mock.patch.object(module, "run", run)

    return seen, [spy(m) for m in (sg, bag, bsp, bsr)]


def _real_args(cell, arch, seed):
    """CPU tensors of the cell's arguments' shapes and dtypes: floats
    normal, token ids below the vocab, positions below the sequence."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.train.tree import tree_map

    cfg = get_arch(arch).model_cfg(True)
    gen = torch.Generator().manual_seed(seed)

    def real(t):
        if t.dtype.is_floating_point:
            return (0.02 * torch.randn(t.shape, generator=gen)).to(t.dtype)
        high = cfg.vocab if t.dim() else 1
        if t.dim() == 1 and cell.shape_name.startswith(("decode", "long")):
            high = 32                       # positions inside the cache
        return torch.randint(0, high, t.shape, generator=gen).to(t.dtype)

    return tree_map(real, cell.args)


def _port(out: Path):
    sys.path.insert(0, str(ROOT / "src"))
    import contextlib
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import (counting, fake_world, place_args,
                                           run_cell)
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import build_cell

    torch.set_num_threads(1)
    res = {}
    with fake_world(WORLD, 0):
        mesh = make_local_mesh(DATA, MODEL, device="cpu")
        for arch, shape, changes in HEADS6:
            cfg = dataclasses.replace(get_arch(arch).model_cfg(True), **changes)
            rec = run_cell(arch, shape, mesh, "local2x4", reduced=True,
                           cfg_override=cfg)
            cell = build_cell(arch, shape, mesh=mesh, reduced=True,
                              cfg_override=cfg)
            args = place_args(_real_args(cell, arch, 7), cell.in_shardings)
            with counting(args) as c:
                cell.fn(*args)
            rec["cpu"] = {"flops": c.flops, "bytes": c.bytes,
                          "transcendentals": c.transcendentals,
                          "kernels": c.kernels}
            res[f"{arch}/{shape}/h6"] = rec
        for arch, shape in CELLS:
            seen, spies = _kernel_spies()
            with contextlib.ExitStack() as stack:
                for s in spies:
                    stack.enter_context(s)
                rec = run_cell(arch, shape, mesh, "local2x4", reduced=True)
            rec["spied"] = seen
            if FAMILY[arch] == "lm":
                cell = build_cell(arch, shape, mesh=mesh, reduced=True)
                args = place_args(_real_args(cell, arch, 7), cell.in_shardings)
                with counting(args) as c:
                    cell.fn(*args)
                rec["cpu"] = {"flops": c.flops, "bytes": c.bytes,
                              "transcendentals": c.transcendentals,
                              "kernels": c.kernels}
            res[f"{arch}/{shape}"] = rec
    (out / "port.json").write_text(json.dumps(res))


# ------------------------------------------------------------ the tests
@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = {}
    for mode in ("oracle", "port"):
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
    return (json.loads((out / "oracle.json").read_text()),
            json.loads((out / "port.json").read_text()))


IDS = [f"{a}/{s}" for a, s in CELLS]


@pytest.mark.parametrize("key", IDS)
def test_cell_runs_on_both_sides(records, key):
    ref, port = records
    assert ref[key]["ok"], ref[key].get("error")
    assert port[key]["ok"], port[key].get("traceback")
    assert port[key]["t_run_s"] >= 0 and port[key]["n_ops"] > 0


@pytest.mark.parametrize("key", IDS)
def test_collectives_have_reference_names_and_agree_with_comm_debug(records, key):
    from repro_torch.launch.dryrun import _KIND, COLLECTIVES

    ref, port = records
    got, want = port[key]["collectives"], ref[key]["collectives"]
    assert list(got) == list(want) == ["bytes", "counts"]
    for part in ("bytes", "counts"):
        assert list(got[part]) == list(want[part]) == list(COLLECTIVES)
    by_kind = {k: 0 for k in COLLECTIVES}
    for op, n in port[key]["comm_debug_counts"].items():
        kind = _KIND.get(op.split(".")[-1])
        if kind is not None:
            by_kind[kind] += n
    assert by_kind == got["counts"]
    assert sum(got["counts"].values()) > 0


@pytest.mark.parametrize("key", IDS)
def test_memory_matches_reference(records, key):
    ref, port = records
    r, p = ref[key]["memory"], port[key]["memory"]
    assert p["argument_bytes"] == r["argument_bytes"]
    assert p["peak_bytes_est"] == (p["argument_bytes"] + p["output_bytes"]
                                   + p["temp_bytes"] - p["alias_bytes"])
    if key == "graphsage-reddit/ogb_products":
        # out_shardings None: XLA picks the outputs' layouts; the port
        # returns the donated blocks (params, moments, count) and the loss
        assert p["alias_bytes"] == p["output_bytes"] - 4
        assert r["alias_bytes"] <= p["alias_bytes"]
        return
    n = ref[key]["n_outputs"]
    table = XLA_TUPLE_ENTRY * n if n > 1 else 0
    assert p["output_bytes"] + table == r["output_bytes"]
    assert p["alias_bytes"] == r["alias_bytes"]


@pytest.mark.parametrize("key", [k for k in IDS if FAMILY[k.split("/")[0]] == "lm"]
                         + [f"{a}/{s}/h6" for a, s, _ in HEADS6])
def test_lm_meta_count_equals_cpu_count(records, key):
    rec = records[1][key]
    assert rec["ok"], rec.get("traceback")
    cpu, cost = rec["cpu"], rec["cost"]
    assert rec["kernels"] == {} and cpu["kernels"] == {}
    assert cost["flops_per_device"] == cpu["flops"] > 0
    assert cost["transcendentals"] == cpu["transcendentals"] > 0
    if "/train_4k" in key:
        assert any("scatter_rows" in n for n in rec["notes"])
    else:
        assert cost["bytes_accessed_per_device"] == cpu["bytes"]
        assert rec["notes"] == []


@pytest.mark.parametrize("key,kernel", [
    ("graphsage-reddit/ogb_products", "segment_gather"),
    ("wide-deep/serve_bulk", "embedding_bag_lanes"),
    ("websearch-rl/serve_queries", "block_scan_pruned_chunk_rule")])
def test_kernel_costs_are_their_cost_functions(records, key, kernel):
    rec = records[1][key]
    k, spied = rec["kernels"], rec["spied"]
    assert set(k) == set(spied) == {kernel}
    assert k[kernel]["launches"] == spied[kernel]["calls"] > 0
    assert k[kernel]["flops"] == spied[kernel]["flops"]
    assert k[kernel]["bytes"] == spied[kernel]["bytes"]
    assert k[kernel]["worst_case"]              # on meta, by construction
    c = rec["cost"]
    assert c["flops_per_device"] == c["aten_flops_per_device"] + k[kernel]["flops"]
    assert (c["bytes_accessed_per_device"]
            == c["aten_bytes_per_device"] + k[kernel]["bytes"])
    if key.startswith("websearch"):
        assert rec["notes"] == []   # a rule execution is one launch


@pytest.mark.parametrize("key", IDS)
def test_flops_against_reference(records, key):
    ref, port = records
    r = ref[key]["cost"]["flops_per_device"]
    p = port[key]["cost"]["flops_per_device"]
    family = FAMILY[key.split("/")[0]]
    lo, hi = {"lm": (r, LM_LAYERS * r), "gnn": (r, WORLD * r),
              "recsys": (0.8 * r, r), "websearch": (1e-300, r)}[family]
    assert lo <= p <= hi, (p, r)


# ------------------------------------------- the wrappers' meta paths
def wrapper_cases():
    """{case: (kernel name, make)}: ``make(dev)`` returns a call of one
    kernel route's wrapper on inputs on ``dev`` (seeded), at shapes whose
    data-dependent cost equals its worst case (every plane active and a
    whole chunk of blocks; every bag id in a sector of its own; every
    edge in a segment; an int key length), so that the cost the card
    reports equals the meta one."""
    import torch

    def gen():
        return torch.Generator().manual_seed(3)

    def flash(dtype):
        def make(dev):
            g = gen()
            q = torch.randn((1, 4, 128, 64), generator=g).to(dtype)
            k, v = (torch.randn((1, 2, 128, 64), generator=g).to(dtype)
                    for _ in range(2))
            from repro_torch.kernels.flash_attention import flash_attention

            q, k, v = (t.to(dev) for t in (q, k, v))
            return lambda: flash_attention(q, k, v, causal=True)
        return make

    def decode(dtype, d, kv_len):
        def make(dev):
            g = gen()
            q = torch.randn((2, 8, d), generator=g).to(dtype)
            k, v = (torch.randn((2, 2, 256, d), generator=g).to(dtype)
                    for _ in range(2))
            from repro_torch.kernels.decode_attention import decode_attention

            q, k, v = (t.to(dev) for t in (q, k, v))
            return lambda: decode_attention(q, k, v, kv_len=kv_len)
        return make

    def bag(e):
        def make(dev):
            from repro_torch.kernels.embedding_bag import embedding_bag

            b, l = 64, 8
            stride = 8 if e == 1 else 1           # a 4-byte row: 8 a sector
            table = torch.randn((stride * b * l, e), generator=gen())
            ids = (torch.randperm(b * l, generator=gen()) * stride).reshape(b, l)
            table, ids = table.to(dev), ids.to(torch.int32).to(dev)
            return lambda: embedding_bag(table, ids)
        return make

    def gather(dev):
        from repro_torch.kernels.segment_gather import segment_gather_sum

        g = gen()
        x = torch.randn((50, 8), generator=g)
        idx = torch.randint(0, 50, (200,), generator=g, dtype=torch.int32)
        ptr = torch.linspace(0, 200, 21).to(torch.int64)
        scale = torch.rand((20,), generator=g)
        x, idx, ptr, scale = (t.to(dev) for t in (x, idx, ptr, scale))
        return lambda: segment_gather_sum(x, idx, ptr, scale)

    def chunk(dev):
        from repro_torch.kernels.block_scan import (block_scan_pruned_chunk,
                                                    build_rule_meta)

        b, nb, t, f, w = 4, 8, 4, 4, 4
        occ = torch.randint(-2**31, 2**31 - 1, (b, nb, t * f, w), generator=gen(),
                            dtype=torch.int32)
        ones = torch.ones((b, t), dtype=torch.bool)
        meta = build_rule_meta(torch.ones((b, t, f), dtype=torch.bool), ones, ones,
                               torch.zeros(b, dtype=torch.int32))
        occ, meta = occ.to(dev), meta.to(dev)
        return lambda: block_scan_pruned_chunk(occ, meta, chunk=4, n_terms=t)

    return {"flash_tc": ("flash_attention_tc", flash(torch.bfloat16)),
            "flash_fp32": ("flash_attention", flash(torch.float32)),
            "decode_tc": ("decode_attention_tc", decode(torch.bfloat16, 128, 200)),
            "decode_fp32": ("decode_attention", decode(torch.float32, 64, None)),
            "bag_lanes": ("embedding_bag_lanes", bag(1)),
            "bag_warp": ("embedding_bag", bag(16)),
            "segment_gather": ("segment_gather", gather),
            "chunk_scan": ("block_scan_pruned_chunk", chunk)}


def native_kernel(name):
    from repro_torch.kernels.block_scan import BLOCK_SCAN_KERNEL
    from repro_torch.kernels.decode_attention import (DECODE_ATTENTION_KERNEL,
                                                      DECODE_ATTENTION_TC_KERNEL)
    from repro_torch.kernels.embedding_bag import (EMBEDDING_BAG_KERNEL,
                                                   EMBEDDING_BAG_LANES_KERNEL)
    from repro_torch.kernels.flash_attention import (FLASH_ATTENTION_KERNEL,
                                                     FLASH_ATTENTION_TC_KERNEL)
    from repro_torch.kernels.segment_gather import SEGMENT_GATHER_KERNEL

    return {k.name: k for k in (
        BLOCK_SCAN_KERNEL, DECODE_ATTENTION_KERNEL, DECODE_ATTENTION_TC_KERNEL,
        EMBEDDING_BAG_KERNEL, EMBEDDING_BAG_LANES_KERNEL, FLASH_ATTENTION_KERNEL,
        FLASH_ATTENTION_TC_KERNEL, SEGMENT_GATHER_KERNEL)}[name]


def count_call(call):
    """(outputs as a list, the counter's kernels) of one counted call."""
    import torch

    from repro_torch.launch.dryrun import _tensors, counting

    with counting() as c:
        out = call()
    return _tensors(out if isinstance(out, (tuple, list)) else [out]), c.kernels


@pytest.mark.parametrize("case", list(wrapper_cases()))
def test_kernel_wrapper_on_meta_gives_shapes_and_launches_nothing(case):
    """On meta each wrapper returns its outputs' shapes and dtypes (those
    of its plain version on the CPU), launches nothing (its count stays)
    and reports one call of its kernel, with the worst case marked where
    the cost depends on the data."""
    name, make = wrapper_cases()[case]
    kernel = native_kernel(name)
    before = kernel.launches
    got, kernels = count_call(make("meta"))
    want, cpu_kernels = count_call(make("cpu"))
    assert kernel.launches == before
    assert cpu_kernels == {}                   # the plain version: no kernel
    assert [(t.device.type, t.shape, t.dtype) for t in got] == [
        ("meta", t.shape, t.dtype) for t in want]
    assert list(kernels) == [name] and kernels[name]["launches"] == 1
    assert kernels[name]["flops"] > 0 and kernels[name]["bytes"] > 0
    data_dependent = case in ("bag_lanes", "bag_warp", "segment_gather",
                              "chunk_scan")
    assert kernels[name]["worst_case"] == data_dependent


def test_entry_device_on_meta():
    """Parameters on meta give meta, with or without a mesh (any
    device type); asked for another device they still raise."""
    import types

    import torch
    import torch.distributed as dist

    from repro_torch.device import entry_device
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_local_mesh

    p = torch.empty((2, 3), device="meta")
    assert entry_device(p) == entry_device(p, device="meta") == torch.device("meta")
    with pytest.raises(ValueError, match="lie on meta"):
        entry_device(p, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        entry_device(p, mesh=types.SimpleNamespace())
    assert not dist.is_initialized()
    with fake_world(8, 3):
        mesh = make_local_mesh(DATA, MODEL, device="cpu")
        assert entry_device(p, mesh) == torch.device("meta")
        with pytest.raises(ValueError, match="lie on meta"):
            entry_device(p, mesh, device="cpu")


if __name__ == "__main__":
    mode, where = sys.argv[1], Path(sys.argv[2])
    {"--oracle": _oracle, "--port": _port}[mode](where)
