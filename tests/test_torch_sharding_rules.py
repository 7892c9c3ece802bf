"""The port's sharding rules, mesh planning and spec checks against the
reference's, leaf by leaf, with no world: the rules are pure functions
of shapes (``jax.eval_shape`` trees on one side, ``device="meta"``
trees on the other) and take the mesh's ``{axis: size}``.  Plus the
production meshes, built under a 256- and a 512-rank fake process group
in a subprocess, and every LM and GNN cell built on them: its in and
out specs against the reference's ``build_cell`` on an ``AbstractMesh``
of the same shape, its args meta tensors of the reference's shapes."""
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs import get_arch as jax_get_arch
from repro.configs import list_archs as jax_list_archs
from repro.distributed import elastic as jel
from repro.distributed import sharding_rules as jsr
from repro.models import gnn as jgnn
from repro.models import recsys as jrec
from repro.models import transformer as jtf
from repro_torch.configs import get_arch
from repro_torch.distributed import elastic as tel
from repro_torch.distributed import sharding_rules as tsr
from repro_torch.models import gnn as tgnn
from repro_torch.models import recsys as trec
from repro_torch.models import transformer as ttf
from repro_torch.train.tree import leaf_paths, tree_leaves

ROOT = Path(__file__).resolve().parents[1]
MODEL_SIZES = (1, 4, 16)
PRODUCTION = {"16x16": {"data": 16, "model": 16},
              "2x16x16": {"pod": 2, "data": 16, "model": 16}}
INITS = {"wide-deep": "wide_deep_init", "deepfm": "deepfm_init",
         "dcn-v2": "dcn_init", "bert4rec": "bert4rec_init"}
ARCHS = sorted(a for a, arch in jax_list_archs().items()
               if arch.family != "websearch")       # websearch has no parameters


def _jax_specs(specs):
    """(path, entries) of a reference spec tree, in flatten order."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp),
             tuple(s)) for kp, s in flat]


def _port_specs(tree, specs):
    return list(zip(leaf_paths(tree), [tuple(s) for s in tree_leaves(specs)]))


def _gnn_cfgs(arch_id):
    """Each shape's SAGEConfig, as the cells build it (reference, port)."""
    jarch, tarch = jax_get_arch(arch_id), get_arch(arch_id)
    out = []
    for name, spec in jarch.shapes.items():
        sp = spec.params
        jb, tb = jarch.model_cfg(False), tarch.model_cfg(False)
        out.append((
            jgnn.SAGEConfig(d_in=sp["d_feat"], d_hidden=jb.d_hidden,
                            n_classes=sp["n_classes"], n_layers=jb.n_layers,
                            aggregator=jb.aggregator),
            tgnn.SAGEConfig(d_in=sp["d_feat"], d_hidden=tb.d_hidden,
                            n_classes=sp["n_classes"], n_layers=tb.n_layers,
                            aggregator=tb.aggregator)))
    return out


def _trees(arch_id):
    """[(reference abstract params, port meta params, family, cfg pair)]
    at the arch's full config."""
    family = jax_get_arch(arch_id).family
    if family == "gnn":
        return [(jax.eval_shape(lambda c=jc: jgnn.sage_init(jax.random.key(0), c)),
                 tgnn.sage_init(tc, device="meta"), family, (jc, tc))
                for jc, tc in _gnn_cfgs(arch_id)]
    jcfg = jax_get_arch(arch_id).model_cfg(False)
    tcfg = get_arch(arch_id).model_cfg(False)
    if family == "lm":
        return [(jax.eval_shape(lambda: jtf.init_params(jax.random.key(0), jcfg)),
                 ttf.init_params(tcfg, device="meta"), family, (jcfg, tcfg))]
    init = INITS[arch_id]
    return [(jax.eval_shape(lambda: getattr(jrec, init)(jax.random.key(0), jcfg)),
             getattr(trec, init)(tcfg, device="meta"), family, (jcfg, tcfg))]


@pytest.mark.parametrize("model_size", MODEL_SIZES)
@pytest.mark.parametrize("arch_id", ARCHS)
def test_param_specs_match_reference(arch_id, model_size):
    for jtree, ttree, family, (jcfg, tcfg) in _trees(arch_id):
        if family == "lm":
            fsdp, zero3 = (getattr(jcfg, "fsdp", False), getattr(jcfg, "zero3", False))
            assert (fsdp, zero3) == (getattr(tcfg, "fsdp", False),
                                     getattr(tcfg, "zero3", False))
            want = jsr.lm_param_specs(jtree, model_size, fsdp, zero3)
            got = tsr.lm_param_specs(ttree, model_size, fsdp, zero3)
        elif family == "gnn":
            want = jsr.gnn_param_specs(jtree, model_size)
            got = tsr.gnn_param_specs(ttree, model_size)
        else:
            want = jsr.recsys_param_specs(jtree, model_size)
            got = tsr.recsys_param_specs(ttree, model_size)
        assert _port_specs(ttree, got) == _jax_specs(want)


@pytest.mark.parametrize("arch_id", ["deepseek-v2-lite-16b", "grok-1-314b"])
def test_lm_rule_options_match_reference(arch_id):
    """fsdp and zero3 on both MoE archs, whatever their configs say."""
    ((jtree, ttree, _, _),) = _trees(arch_id)
    for fsdp in (False, True):
        for zero3 in (False, True):
            for m in MODEL_SIZES:
                assert (_port_specs(ttree, tsr.lm_param_specs(ttree, m, fsdp, zero3))
                        == _jax_specs(jsr.lm_param_specs(jtree, m, fsdp, zero3)))


@pytest.mark.parametrize("mesh_name", list(PRODUCTION))
@pytest.mark.parametrize("arch_id", sorted(a for a, arch in jax_list_archs().items()
                                           if arch.family == "lm"))
def test_zero1_and_kv_cache_specs_on_production_meshes(arch_id, mesh_name):
    shape = PRODUCTION[mesh_name]
    jmesh = types.SimpleNamespace(shape=shape)
    ((jtree, ttree, _, (jcfg, tcfg)),) = _trees(arch_id)
    jp = jsr.lm_param_specs(jtree, shape["model"], getattr(jcfg, "fsdp", False),
                            getattr(jcfg, "zero3", False))
    tp = tsr.lm_param_specs(ttree, shape["model"], getattr(tcfg, "fsdp", False),
                            getattr(tcfg, "zero3", False))
    assert (_port_specs(ttree, tsr.zero1_state_specs(ttree, tp, shape))
            == _jax_specs(jsr.zero1_state_specs(jtree, jp, jmesh)))
    for name, spec in jax_get_arch(arch_id).shapes.items():
        if spec.kind != "decode":
            continue
        b, s = spec.params["global_batch"], spec.params["seq_len"]
        jcache = jax.eval_shape(lambda: jtf.init_kv_cache(jcfg, b, s))
        tcache = ttf.init_kv_cache(tcfg, b, s, device="meta")
        assert (_port_specs(tcache, tsr.kv_cache_specs(tcache, shape))
                == _jax_specs(jsr.kv_cache_specs(jcache, jmesh))), name
    assert tsr.data_axes(shape) == jsr.data_axes(jmesh)


def test_partition_spec_normalises_as_jax():
    for entries in [(), (None,), ("data",), (("data",),), ((), None),
                    (("pod", "data"), None), (None, "model", None)]:
        assert tuple(tsr.P(*entries)) == tuple(JP(*entries)), entries
        assert len(tsr.P(*entries)) == len(JP(*entries))
    assert tsr.P(("data",)) == tsr.P("data") and tsr.P(None) != tsr.P()


def test_plan_mesh_shape_matches_reference():
    for n in range(1, 513):
        for prefer in (16, 8):
            assert tel.plan_mesh_shape(n, prefer) == jel.plan_mesh_shape(n, prefer)
    with pytest.raises(ValueError):
        tel.plan_mesh_shape(0)


def test_validate_specs_matches_reference():
    """The same problem strings, on a reduced LM over a 16-way model
    axis (dims that do not divide), and none where all divide."""
    jcfg = jax_get_arch("starcoder2-3b").model_cfg(True)
    tcfg = get_arch("starcoder2-3b").model_cfg(True)
    jtree = jax.eval_shape(lambda: jtf.init_params(jax.random.key(0), jcfg))
    ttree = ttf.init_params(tcfg, device="meta")
    for shape in ({"data": 2, "model": 16}, {"data": 2, "model": 2},
                  {"pod": 2, "data": 3, "model": 5}):
        jmesh = types.SimpleNamespace(shape=shape)
        jspecs = jsr.lm_param_specs(jtree, shape["model"])
        jspecs = jsr.zero1_state_specs(jtree, jspecs, jmesh)
        tspecs = tsr.lm_param_specs(ttree, shape["model"])
        tspecs = tsr.zero1_state_specs(ttree, tspecs, shape)
        want = jel.validate_specs(jtree, jspecs, jmesh)
        assert tel.validate_specs(ttree, tspecs, shape) == want
    assert want                                  # a failing case
    wide = {"w": np.zeros((6, 8))}
    bad = {"w": JP(("data", "model"), None)}
    assert (tel.validate_specs(wide, {"w": tsr.P(("data", "model"), None)},
                               {"data": 2, "model": 4})
            == jel.validate_specs(wide, bad, types.SimpleNamespace(
                shape={"data": 2, "model": 4})))


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert tsr.to_placements(tsr.P(("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert tsr.to_placements(tsr.P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        tsr.to_placements(tsr.P(("model", "data")), mesh)
    with pytest.raises(ValueError, match="two dims"):
        tsr.to_placements(tsr.P("data", "data"), mesh)


_FAKE_MESHES = """
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.mesh import make_production_mesh
for world, multi in ((256, False), (512, True)):
    dist.init_process_group("fake", store=FakeStore(), rank=3, world_size=world)
    mesh = make_production_mesh(multi_pod=multi, device="cpu")
    print(tuple(mesh.shape), tuple(mesh.mesh_dim_names), mesh.device_type)
    dist.destroy_process_group()
"""


def test_make_production_mesh_under_a_fake_process_group():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _FAKE_MESHES], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.splitlines()[-2:] == [
        "(16, 16) ('data', 'model') cpu",
        "(2, 16, 16) ('pod', 'data', 'model') cpu"]


_FAKE_CELLS = """
import json
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import list_archs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_cell
from repro_torch.train.tree import leaf_paths, tree_leaves

def specs(tree):
    if tree is None:
        return None
    return [[p, repr(tuple(s.spec))] for p, s in zip(leaf_paths(tree),
                                                     tree_leaves(tree))]

for world, multi in ((256, False), (512, True)):
    dist.init_process_group("fake", store=FakeStore(), rank=5, world_size=world)
    mesh = make_production_mesh(multi_pod=multi, device="cpu")
    out = {}
    for arch_id, arch in sorted(list_archs().items()):
        if arch.family not in ("lm", "gnn"):
            continue
        for shape in arch.shapes:
            cell = build_cell(arch_id, shape, mesh=mesh)
            out[f"{arch_id}/{shape}"] = {
                "in": specs(cell.in_shardings), "out": specs(cell.out_shardings),
                "args": [[p, list(t.shape), str(t.dtype).split(".")[-1],
                          t.device.type]
                         for p, t in zip(leaf_paths(cell.args),
                                         tree_leaves(cell.args))]}
    print(json.dumps({"mesh": list(mesh.shape), "cells": out}))
    dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def production_cells():
    """{mesh name: {arch/shape: the port's specs and args}}, built under
    the fake process groups."""
    import json

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _FAKE_CELLS], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    runs = [json.loads(line) for line in out.stdout.splitlines()[-2:]]
    assert [r["mesh"] for r in runs] == [[16, 16], [2, 16, 16]]
    return dict(zip(PRODUCTION, (r["cells"] for r in runs)))


def _jax_cell_specs(tree):
    from jax.sharding import NamedSharding as JNS

    if tree is None:
        return None
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JNS))
    return [["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp),
             repr(tuple(s.spec))] for kp, s in flat]


@pytest.mark.parametrize("mesh_name", list(PRODUCTION))
@pytest.mark.parametrize("arch_id", sorted(a for a, arch in jax_list_archs().items()
                                           if arch.family in ("lm", "gnn")))
def test_cells_on_production_meshes_match_reference(production_cells, arch_id,
                                                    mesh_name):
    from jax.sharding import AbstractMesh

    from repro.launch.steps import build_cell as jax_build_cell

    shape = PRODUCTION[mesh_name]
    jmesh = AbstractMesh(tuple(shape.values()), tuple(shape))
    for name in jax_get_arch(arch_id).shapes:
        got = production_cells[mesh_name][f"{arch_id}/{name}"]
        cell = jax_build_cell(arch_id, name, mesh=jmesh)
        assert got["in"] == _jax_cell_specs(cell.in_shardings), name
        assert got["out"] == _jax_cell_specs(cell.out_shardings), name
        flat, _ = jax.tree_util.tree_flatten_with_path(cell.args)
        want = [["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp),
                 list(a.shape), np.dtype(a.dtype).name, "meta"] for kp, a in flat]
        assert got["args"] == want, name
