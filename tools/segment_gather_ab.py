#!/usr/bin/env python3
"""A/B of the segment gather-sum kernel: its first form, a warp per
segment (``tools/segment_gather_first.cu``, frozen under its own entry
point), against the current ``csrc/segment_gather.cu``, built at its own
``SG_DEPTH`` and at the other depths given, in one process on one card.

Shapes: ``chip_smoke.py`` phase 7's ``ogb_products`` graph (the same
seed; 2,449,029 nodes, 61,859,140 edges, skewed in-degrees, uniform
sources): the forward of layer 0 (d 100) and layer 1 (d 128) by dst with
the mean's scale, and the backward at d 128 over the transposed CSR (by
src).  Every kernel's output is checked bit-equal to the current
kernel's at its own depth first (all add in each segment's edge order).
Then ``--pairs`` rounds, each launching every kernel once, cold (the L2
flushed by a 1 GiB read before each launch), timed with CUDA events, the
order reversed every other round (old, new, new, old).  Prints the
card, each CSR's degree profile, each build's registers and CTAs a
multiprocessor, each shape's bounds (``chip_smoke.gather_bounds``), and
per kernel and shape the median, min, max and max / min of its
launches; with ``--out``, writes them to that JSON file.

Run from the root of the repository, on a machine with the card and
nvcc (``chip_smoke.py`` does not run it):

    python3 tools/segment_gather_ab.py --pairs 12 --depths 4,16 --out ab.json
"""
import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FIRST_SOURCE = ROOT / "tools" / "segment_gather_first.cu"


def build(source, defines, name):
    """nvcc ``source`` with ``defines`` into build/segment_gather_ab/;
    returns (library path, ptxas lines)."""
    from repro_torch.kernels.native import CSRC_DIR, NVCC_FLAGS, _nvcc

    flags = [*NVCC_FLAGS, *(f"-D{d}" for d in defines), "-I", str(CSRC_DIR)]
    h = hashlib.sha256(" ".join(flags).encode() + source.read_bytes())
    for f in CSRC_DIR.glob("segment_gather.cu*"):
        h.update(f.read_bytes())
    lib = ROOT / "build" / "segment_gather_ab" / h.hexdigest()[:16] / f"lib{name}.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    out = subprocess.run([_nvcc(), *flags, "-o", str(lib), str(source)],
                         capture_output=True, text=True)
    log = out.stdout + out.stderr
    if out.returncode:
        raise SystemExit(f"nvcc failed for {source}:\n{log}")
    return lib, [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=12)
    ap.add_argument("--depths", default="",
                    help="other SG_DEPTH values to build, comma-separated")
    ap.add_argument("--out", default=None, help="a JSON file for the results")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_arch
    from repro_torch.kernels.native import csrc_define
    from repro_torch.kernels.segment_gather import SegmentCSR

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the A/B runs on the card")
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    depth = csrc_define("segment_gather.cuh", "SG_DEPTH")
    depths = [depth] + [int(k) for k in args.depths.split(",") if k and int(k) != depth]
    jobs = [("first", FIRST_SOURCE, [])] + [
        (f"new_u{k}", ROOT / "src" / "repro_torch" / "csrc" / "segment_gather.cu",
         [f"SG_DEPTH={k}"]) for k in depths]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda j: build(j[1], j[2], j[0]), jobs))
    print(f"[ab] built {len(jobs)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)
    P, L = ctypes.c_void_p, ctypes.c_int64
    kernels = {}
    for (name, _, _), (lib, ptxas) in zip(jobs, built):
        so = ctypes.CDLL(str(lib))
        fn = so.segment_gather_first_launch if name == "first" else so.segment_gather_launch
        fn.argtypes = ([P] * 5 + [L] * 3 + ([P] if name != "first" else []) + [P])
        fn.restype = ctypes.c_int
        kernels[name] = fn
        for line in ptxas:
            print(f"[ab] {name}: {line}", flush=True)
        if name != "first":
            for vec in (1, 0):
                blocks = ctypes.c_int(0)
                so.segment_gather_blocks_per_sm(vec, ctypes.byref(blocks))
                print(f"[ab] {name}: {'16-byte' if vec else 'scalar'} path "
                      f"{blocks.value} CTAs of 256 threads a multiprocessor "
                      f"({blocks.value * 8} warps of 64)", flush=True)

    sp = dict(get_arch("graphsage-reddit").shape("ogb_products").params)
    i = cs.GNN_SHAPES.index("ogb_products")
    batch, _, note = cs.gnn_batch(dev, "ogb_products", sp, cs.SEED + 63 + i)
    feats, edges = batch[0], batch[1]
    n = feats.shape[0]
    csr = SegmentCSR(edges[0], edges[1], n, n)
    idx_t, ptr_t = csr.transposed()
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 81)
    h = torch.randn((n, 128), generator=gen, device=dev)
    g = torch.randn((n, 128), generator=gen, device=dev) * csr.scale[:, None]
    print(f"[ab] ogb_products graph: {note}", flush=True)
    cases = {"fwd_d100": (feats, csr.idx, csr.ptr, csr.scale),
             "fwd_d128": (h, csr.idx, csr.ptr, csr.scale),
             "bwd_d128": (g, idx_t, ptr_t, None)}
    for label, ptr in (("by dst", csr.ptr), ("by src (transposed)", ptr_t)):
        print(f"[ab] CSR {label}: {ptr.numel() - 1:,} segments, "
              f"{int(ptr[-1]):,} edges; {cs.degree_profile(ptr)}", flush=True)
    ticket = torch.empty(1, dtype=torch.int32, device=dev)

    def launcher(name, case):
        x, idx, ptr, scale = cases[case]
        out = torch.empty((ptr.numel() - 1, x.shape[1]), device=dev)
        head = [x.data_ptr(), idx.data_ptr(), ptr.data_ptr(),
                None if scale is None else scale.data_ptr(), out.data_ptr(),
                x.shape[0], x.shape[1], ptr.numel() - 1]
        tail = ([] if name == "first" else [ticket.data_ptr()])

        def run():
            err = kernels[name](*head, *tail, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
            return out
        return run

    runs = {(k, c): launcher(k, c) for k in kernels for c in cases}
    for c in cases:
        want = runs[(f"new_u{depth}", c)]().clone()
        for k in kernels:
            got = runs[(k, c)]()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise SystemExit(f"[ab] {k} {c}: not bit-equal to new_u{depth}")
        print(f"[ab] {c}: every build bit-equal ({', '.join(kernels)})", flush=True)

    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    times = {key: [] for key in runs}
    names = list(kernels)
    for p in range(args.pairs):
        for c in cases:
            for k in (names if p % 2 == 0 else names[::-1]):
                flush.sum()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                runs[(k, c)]()
                end.record()
                end.synchronize()
                times[(k, c)].append(start.elapsed_time(end))
    res = {}
    for c in cases:
        base = statistics.median(times[("first", c)])
        bound, gathered = cs.gather_bounds(*cases[c])
        print(f"[ab] {c}: compulsory bound {bound:.6f} ms, gathered-row bound "
              f"{gathered:.6f} ms", flush=True)
        for k in names:
            t = times[(k, c)]
            med = statistics.median(t)
            res[f"{k}/{c}"] = dict(median_ms=med, min_ms=min(t), max_ms=max(t),
                                   spread=max(t) / min(t), n=len(t))
            print(f"[ab] {c} {k}: median {med:.6f} ms over {len(t)} cold launches "
                  f"(min {min(t):.6f}, max {max(t):.6f}, max/min "
                  f"{max(t) / min(t):.3f}); first / this {base / med:.3f}; "
                  f"{med / gathered:.3f}x the gathered-row bound", flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(
            {"card": cs.card_line(), "pairs": args.pairs, "results": res},
            indent=1))


if __name__ == "__main__":
    main()
