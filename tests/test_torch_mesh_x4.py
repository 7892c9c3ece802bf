"""The port's sharded serve step over a row of four index slices, rank by
rank, on the CPU: a 1 x 4 gloo mesh, each rank holding one slice, its
inputs made and handed over as the benchmark's row runner makes them
(``perfbench/runners/websearch_serve_x4.py``: ``slice_inputs``, then
DTensors of the rank's own blocks), against the row's plain reference
(``perfbench/reference/websearch_rl_x4.py``), which merges the slices'
reference answers without the program.

The ranks (``python tests/test_torch_mesh_x4.py --ranks DIR``) run in a
subprocess: four processes by ``torch.multiprocessing.spawn`` over a
``FileStore``, one torch thread a rank.  Rank 0 writes what every rank
saw (``ranks.npz``).  Two mixes at the benchmark's reduced width:
``sparse`` is the cell's own CAT1 traffic (a few candidates a slice);
``dense`` is CAT2 with K 64, where the slices' candidates exceed K and
the merge truncates.  The merged cand, u and cand_cnt are compared bit
for bit: integer state, in any order of the sums."""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
SEED = 2**31 + 370
TIMEOUT_S = 300
MIXES = {"sparse": ("cat1", None), "dense": ("cat2", 64)}   # traffic, K


def _cell(mix):
    """The row cell at the benchmark's reduced width, under ``mix``."""
    from perfbench import harness
    from perfbench.conftest import shrink

    traffic, keep = MIXES[mix]
    cell = harness.resolve("ws67m-serve-cat1-x4")
    cell.traffic = harness.resolve("ws16m-serve-" + traffic).traffic
    shrink(cell)
    if keep is not None:
        cell.config["max_candidates"] = keep
    return cell


def _rank(rank, out):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench.reference import websearch_rl_x4 as reference
    from perfbench.runners import websearch_serve_x4 as x4
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.obs import Tracer, collectives, tracing

    dist.init_process_group("gloo", rank=rank, world_size=WORLD,
                            store=dist.FileStore(str(out / "store"), WORLD))
    mesh = make_local_mesh(1, WORLD, device="cpu")
    cpu = torch.device("cpu")
    res = {}
    with torch.no_grad():
        for mix in MIXES:
            cell = _cell(mix)
            cfg = cell.config
            inp = x4.slice_inputs(cfg, cell.traffic, SEED, rank, cpu)
            call = x4.program_call(cfg, inp, mesh)
            res[f"{mix}/got"] = np.stack(
                [np.concatenate([a.reshape(len(a), -1) for a in call(i)], 1)
                 for i in range(inp.variants)])
            want = x4.slice_reference(cfg, reference, inp, torch.float32)
            for name, i in (("cand", 0), ("u", 1), ("cnt", 2)):
                res[f"{mix}/slice_{name}"] = np.stack([w[i] for w in want])
            for name in ("q", "u_edges", "v_edges", "term_present", "occ"):
                res[f"{mix}/{name}"] = getattr(inp, name).numpy()
            if mix == "sparse":
                tracer = Tracer()
                before = collectives()
                with tracing(tracer):
                    call(0)
                res["collectives"] = np.array(collectives() - before)
                entries = tracer.log.snapshot()
                by_id = {e["id"]: e for e in entries}
                res["spans"] = np.array(json.dumps(
                    [(e["name"], by_id[e["parent"]]["name"]
                      if e["parent"] in by_id else None, e["args"])
                     for e in entries]))
    gathered = [None] * WORLD
    dist.all_gather_object(gathered, res)
    if rank == 0:
        np.savez(out / "ranks.npz", **{f"{r}/{k}": v for r, got in
                                       enumerate(gathered)
                                       for k, v in got.items()})
    dist.barrier()
    dist.destroy_process_group()


def _ranks(out: Path):
    import torch.multiprocessing as mp

    mp.spawn(_rank, args=(out,), nprocs=WORLD, join=True)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh_x4")
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": f"{ROOT / 'src'}:{ROOT}"}
    with open(out / "ranks.log", "w") as log:
        proc = subprocess.Popen([sys.executable, __file__, "--ranks", str(out)],
                                env=env, cwd=ROOT, stdout=log,
                                stderr=subprocess.STDOUT)
        try:
            rc = proc.wait(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = "timeout"
    assert rc == 0, (out / "ranks.log").read_text()[-4000:]
    npz = np.load(out / "ranks.npz")
    return {k: npz[k] for k in npz.files}


def _row_reference(ranks, mix):
    from perfbench.reference import websearch_rl_x4 as reference

    cfg = _cell(mix).config
    slices = [[ranks[f"{r}/{mix}/slice_{n}"] for n in ("cand", "u", "cnt")]
              for r in range(WORLD)]
    docs = cfg["n_blocks"] * cfg["block_docs"]
    return [reference.merge([[x[v] for x in s] for s in slices], docs,
                            cfg["max_candidates"])
            for v in range(len(slices[0][0]))]


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_the_row_is_bit_equal_to_the_merged_reference(ranks, mix):
    k = _cell(mix).config["max_candidates"]
    want = _row_reference(ranks, mix)
    for r in range(WORLD):
        got = ranks[f"{r}/{mix}/got"]
        for v, (cand, u, cnt) in enumerate(want):
            np.testing.assert_array_equal(got[v, :, :k], cand)
            np.testing.assert_array_equal(got[v, :, k], u)
            np.testing.assert_array_equal(got[v, :, k + 1], cnt)
    cand = np.stack([w[0] for w in want])
    assert (cand >= 0).any(axis=-1).all()       # every query found something
    valid = cand >= 0
    assert (valid[..., :-1] | ~valid[..., 1:]).all()     # the pads trail
    steps = np.diff(cand, axis=-1)[valid[..., 1:]]
    assert (steps > 0).all()                    # unique, in static-rank order
    if mix == "sparse":     # every slice's candidates reach the merge
        docs = _cell(mix).config["n_blocks"] * _cell(mix).config["block_docs"]
        assert set(np.unique(cand[cand >= 0] // docs)) == set(range(WORLD))


def test_the_dense_mix_truncates_at_k(ranks):
    """In the dense mix the slices' candidates exceed K in some rows, and
    the merge keeps the K smallest ids of the row."""
    k = _cell("dense").config["max_candidates"]
    found = sum(ranks[f"{r}/dense/slice_cnt"] for r in range(WORLD))
    assert (found > k).any()
    want = _row_reference(ranks, "dense")
    full = np.stack([w[0] for w in want])[found > k]
    assert (full >= 0).all()
    _, _, sparse_cnt = _row_reference(ranks, "sparse")[0]
    assert (sparse_cnt <= _cell("sparse").config["max_candidates"]).all()


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_the_slices_share_the_queries_and_differ_in_their_words(ranks, mix):
    """Every slice has the same queries (term counts, plane densities), Q
    table and bins; each has its own occupancy words."""
    for name in ("q", "u_edges", "v_edges", "term_present"):
        for r in range(1, WORLD):
            np.testing.assert_array_equal(ranks[f"{r}/{mix}/{name}"],
                                          ranks[f"0/{mix}/{name}"])
    occ = [ranks[f"{r}/{mix}/occ"] for r in range(WORLD)]
    for r in range(1, WORLD):
        assert (occ[r] != occ[0]).mean() > 0.01
    if mix == "dense":
        # a plane's density 2^-k over the slice's docs: the same k in
        # every slice (CAT2's 2^-3..2^-6 are far apart at 4,096 docs)
        bits = [np.unpackbits(o.view(np.uint8), axis=-1).sum((1, -1))
                for o in occ]
        present = ranks[f"0/{mix}/term_present"][:, :, None].repeat(
            bits[0].shape[-1], -1)
        k = [np.round(np.log2(occ[0].shape[1] * occ[0].shape[-1] * 32
                              / np.maximum(b, 1)))[present] for b in bits]
        for r in range(1, WORLD):
            assert (k[r] == k[0]).mean() >= 0.95


def test_a_call_makes_three_collectives_under_one_shard_serve_span(ranks):
    for r in range(WORLD):
        assert int(ranks[f"{r}/collectives"]) == 3
        spans = json.loads(str(ranks[f"{r}/spans"]))
        inside = sorted(name for name, parent, _ in spans
                        if parent == "shard_serve")
        assert inside == ["gather", "merge", "reduce"]
        coll = [(parent, args) for name, parent, args in spans
                if name == "collective"]
        assert [(p, a["op"], a["axis"]) for p, a in coll] == [
            ("gather", "all_gather", "model"), ("reduce", "all_reduce", "model"),
            ("reduce", "all_reduce", "model")]
        assert coll[0][1]["bytes"] == 4 * 8 * _cell("sparse").config["max_candidates"]
        assert [n for n, p, _ in spans if p is None] == ["rollout", "shard_serve"]


def test_the_one_card_path_opens_no_span_and_makes_no_collective(monkeypatch):
    """Without a tracer the one-card serve step opens no span, and it
    makes no collective."""
    import torch

    from perfbench import generate
    from perfbench.runners import websearch as ws
    from repro_torch.obs import NULL_TRACER, active, collectives
    from repro_torch.obs import trace as obs_trace

    opened = []
    monkeypatch.setattr(obs_trace.Span, "__init__",
                        lambda self, *a, **k: opened.append(a[0]))
    cell = _cell("sparse")
    cfg = {**cell.config, "n_blocks": WORLD * cell.config["n_blocks"]}
    inp = generate.websearch_inputs(cfg, cell.traffic, SEED, torch.device("cpu"))
    fn, bins = ws.make_program(cfg), ws.program_bins(inp)
    occ, tp = inp.batch(0)
    before = collectives()
    cand, u, cnt = fn(inp.q, bins, occ, inp.scores, tp)
    assert active() is NULL_TRACER and opened == []
    assert collectives() == before and (cnt > 0).all()


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--ranks":
        t0 = time.perf_counter()
        _ranks(Path(sys.argv[2]))
        print(f"ranks done in {time.perf_counter() - t0:.1f} s")
    else:
        sys.exit("usage: test_torch_mesh_x4.py --ranks DIR")
