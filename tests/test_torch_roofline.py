"""The port's roofline arithmetic (``repro_torch.launch.roofline``, the
single-device half of the reference's) against the reference's.

``model_flops`` must equal the reference's exactly for every LM (arch,
shape): the same integers (parameter counts on meta tensors there,
``jax.eval_shape`` here) in the same formula.  ``roofline_terms`` and
``wire_bytes`` are the reference's formulas over the H100 SXM's
constants, not the v5e's.

Importing the reference's module sets ``XLA_FLAGS`` (512 host devices)
when unset; the backend is started first and the variable restored, so
this test changes nothing for the tests after it in the process.
"""
import os

import jax
import pytest

from repro.configs import list_archs as jax_list_archs
from repro_torch.launch import roofline

from test_torch_train_step import one_torch_thread  # noqa: F401

jax.devices()
_saved = os.environ.get("XLA_FLAGS")
from repro.launch import roofline as jroof  # noqa: E402
if _saved is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _saved

LM_CELLS = [(a, s) for a, arch in sorted(jax_list_archs().items())
            if arch.family == "lm" for s in arch.shapes]


@pytest.mark.parametrize("arch_id,shape", LM_CELLS)
def test_model_flops_equal_reference(arch_id, shape):
    got = roofline.model_flops(arch_id, shape)
    assert got == jroof.model_flops(arch_id, shape)
    assert got["n_active"] <= got["n_params"]


def test_model_flops_of_other_families_is_undefined():
    for arch_id, shape in (("graphsage-reddit", "ogb_products"),
                           ("wide-deep", "train_batch"),
                           ("websearch-rl", "serve_queries")):
        assert (roofline.model_flops(arch_id, shape)
                == jroof.model_flops(arch_id, shape))


def test_roofline_terms_use_h100_constants():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    t = roofline.roofline_terms(989e12, 3.35e12 * 2, 450e9 * 0.5)
    assert (t["compute_s"], t["memory_s"], t["collective_s"]) == (1.0, 2.0, 0.5)
    assert t["bound"] == "memory" and t["roofline_frac"] == 0.5
    assert roofline.roofline_terms(0, 0, 0)["roofline_frac"] == 0.0
    coll = {"bytes": {"all-reduce": 10.0, "all-gather": 3.0,
                      "collective-permute": 1.0}}
    assert roofline.wire_bytes(coll) == jroof.wire_bytes(coll) == 24.0
    assert roofline.COLL_MULT == jroof.COLL_MULT
    # the reference's formula, its constants swapped for the H100's
    ref = jroof.roofline_terms(197e12, 819e9, 50e9)
    assert ref["compute_s"] == 1.0 and ref["memory_s"] == 1.0


# ------------------------------------------------ analyze_cell, lm_probe, main
def _record(flops=3.0e12, nbytes=4.0e11, coll=None, peak=7 * 2**30):
    coll = coll or {"bytes": {"all-reduce": 1.0e9, "all-gather": 5.0e8,
                              "reduce-scatter": 2.5e8, "all-to-all": 0,
                              "collective-permute": 0},
                    "counts": {"all-reduce": 3, "all-gather": 2,
                               "reduce-scatter": 1, "all-to-all": 0,
                               "collective-permute": 0}}
    return {"arch": "mistral-nemo-12b", "shape": "train_4k", "mesh": "pod16x16",
            "devices": 256, "ok": True,
            "memory": {"argument_bytes": 1, "output_bytes": 1, "temp_bytes": 1,
                       "alias_bytes": 1, "peak_bytes_est": peak},
            "cost": {"flops_per_device": flops, "bytes_accessed_per_device": nbytes,
                     "transcendentals": 0.0},
            "collectives": coll}


def test_analyze_cell_equals_reference_scaled_by_constants():
    rec = _record()
    got, want = roofline.analyze_cell(rec), jroof.analyze_cell(rec)
    for k in ("flops_per_device", "bytes_per_device", "wire_bytes_per_device"):
        assert got[k] == want[k]
    ratios = {"compute_s": jroof.PEAK_FLOPS / roofline.PEAK_FLOPS,
              "memory_s": jroof.HBM_BW / roofline.HBM_BW,
              "collective_s": jroof.LINK_BW / roofline.LINK_BW}
    for k, r in ratios.items():
        assert got[k] == pytest.approx(want[k] * r, rel=1e-12)
    assert set(got) == set(want)
    corrected = {"flops_per_device": 1e14, "bytes_per_device": 2e11,
                 "wire_per_device": 3e9}
    got, want = (roofline.analyze_cell(rec, corrected),
                 jroof.analyze_cell(rec, corrected))
    assert got["compute_s"] == pytest.approx(want["compute_s"] * ratios["compute_s"],
                                             rel=1e-12)
    assert got["bound"] == "compute" and got["roofline_frac"] == 1.0


PROBE_ARCHS = ("starcoder2-3b", "deepseek-v2-lite-16b")   # dense, MoE
PROBE_KEYS = {f"{k}_{m}" for k in ("flops", "bytes", "wire")
              for m in ("per_device", "layer", "linear", "outside")}

_REF_PROBE = """
import json, sys
from repro.launch import roofline as jr         # sets XLA_FLAGS first
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import get_arch
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
print(json.dumps({a: jr.lm_probe(a, "train_4k", mesh,
                                 cfg_override=get_arch(a).model_cfg(True))
                  for a in sys.argv[1:]}))
"""

_PORT_PROBE = """
import json, sys
from repro_torch.configs import get_arch
from repro_torch.launch import roofline
from repro_torch.launch.dryrun import fake_world, run_cell
from repro_torch.launch.mesh import make_local_mesh
out, archs = sys.argv[1], sys.argv[2:]
with fake_world(8, 0):
    mesh = make_local_mesh(2, 4, device="cpu")
    for arch, shape in (("starcoder2-3b", "prefill_32k"), ("wide-deep", "serve_p99")):
        rec = run_cell(arch, shape, mesh, "local2x4", reduced=True)
        open(f"{out}/{arch}__{shape}.json", "w").write(json.dumps(rec))
    print(json.dumps({a: roofline.lm_probe(a, "train_4k", mesh,
                                           cfg_override=get_arch(a).model_cfg(True))
                      for a in archs}))
"""


@pytest.fixture(scope="module")
def probes(tmp_path_factory):
    """(the reference's lm_probe, the port's lm_probe, a directory of the
    port's dry-run records), the two sides in subprocesses side by side."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    out = tmp_path_factory.mktemp("probe")
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, "-c", code, *extra, *PROBE_ARCHS],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for code, extra in ((_REF_PROBE, ()), (_PORT_PROBE, (str(out),)))]
    results = []
    for p in procs:
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, stderr[-3000:]
        results.append(json.loads(stdout.strip().splitlines()[-1]))
    return results[0], results[1], out


@pytest.mark.parametrize("arch_id", PROBE_ARCHS)
def test_lm_probe_against_reference(probes, arch_id):
    """The same probe configs on the same 2 x 4 mesh.  The port counts
    the matmuls (FlopCounterMode), the reference's XLA also every
    elementwise op (norms, activations, softmax, the MoE router and
    dispatch): at the reduced widths (d_model 128) those are a few
    percent of a dense step and under a fifth of an MoE step, so the
    port's FLOPs lie in [0.75, 1] x the reference's, and those outside
    the layers (embedding, head, loss) in [0.9, 1]."""
    ref, port = probes[0][arch_id], probes[1][arch_id]
    assert set(port) == set(ref) == PROBE_KEYS
    for key, lo in (("flops_per_device", 0.75), ("flops_outside", 0.9)):
        assert lo * ref[key] <= port[key] <= ref[key], (key, port[key], ref[key])


@pytest.mark.parametrize("arch_id", PROBE_ARCHS)
def test_lm_probe_eager_meanings(probes, arch_id):
    """Under eager counting m(l) is linear in l: ``*_per_device`` is
    m(L) = m(0) + L x the per-layer slope; the slope over the upper half
    equals it (FLOPs exactly; bytes and wire bytes within 1e-4: the
    unbound layers' gradient stack and norms scale with l too)."""
    from repro_torch.configs import get_arch

    port = probes[1][arch_id]
    n = get_arch(arch_id).model_cfg(True).n_layers
    for k in ("flops", "bytes", "wire"):
        assert port[f"{k}_per_device"] == pytest.approx(
            port[f"{k}_outside"] + n * port[f"{k}_layer"], rel=1e-12)
        assert port[f"{k}_layer"] > 0 and port[f"{k}_outside"] > 0
    assert port["flops_linear"] == pytest.approx(port["flops_layer"], rel=1e-12)
    for k in ("bytes", "wire"):
        assert port[f"{k}_linear"] == pytest.approx(port[f"{k}_layer"], rel=1e-4)


def test_main_writes_reference_rows(probes, tmp_path):
    """``main`` over a directory of the port's records (and a failed
    one, skipped) writes a row per ok record with the reference's keys;
    the reference's ``main`` over the same records gives the same rows,
    its terms at the v5e's constants."""
    import json
    import shutil
    import sys
    from unittest import mock

    d = tmp_path / "records"
    shutil.copytree(probes[2], d)
    (d / "grok-1-314b__train_4k.json").write_text(json.dumps(
        {"arch": "grok-1-314b", "shape": "train_4k", "ok": False,
         "error": "ValueError: x"}))
    out, ref_out = tmp_path / "rows.json", tmp_path / "ref_rows.json"
    roofline.main(["--dryrun-dir", str(d), "--out", str(out)])
    with mock.patch.object(sys, "argv", ["roofline", "--dryrun-dir", str(d),
                                         "--out", str(ref_out)]):
        jroof.main()
    rows, want = json.loads(out.read_text()), json.loads(ref_out.read_text())
    assert [(r["arch"], r["shape"]) for r in rows] == [
        ("starcoder2-3b", "prefill_32k"), ("wide-deep", "serve_p99")]
    assert [set(r) for r in rows] == [set(r) for r in want]
    for r, w in zip(rows, want):
        for k in ("arch", "shape", "corrected", "flops_per_device",
                  "bytes_per_device", "wire_bytes_per_device", "model_flops",
                  "peak_bytes"):
            assert r[k] == w[k], k
        assert r["compute_s"] == pytest.approx(
            w["compute_s"] * jroof.PEAK_FLOPS / roofline.PEAK_FLOPS, rel=1e-12)
    assert rows[0]["useful_ratio"] > 0 and rows[1]["useful_ratio"] is None
