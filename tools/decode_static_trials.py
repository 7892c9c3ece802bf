#!/usr/bin/env python3
"""Trials behind the tuning of two kernels, on the card.

- ``csrc/decode_attention.cu`` (the CUDA-core decode route) built with
  other warp tiles, ring depths and CTAs an SM (``DA_WARP_KEYS``,
  ``DA_BK``, ``DA_STAGES``, ``DA_CTAS_PER_SM``; the wrapper's
  ``split_plan`` follows ``DA_BK`` and ``DA_CTAS_PER_SM``), timed in
  turns at ``chip_smoke.py``'s ``path_fp32``, ``path_fp32_8k``, ``mha``,
  ``gqa4`` and the bf16 ``path`` through this kernel, every variant's
  first call held against the plain version; with ptxas's report of
  each variant's registers and spills.
- ``csrc/block_scan_static.cu`` at one query x 4096 blocks under
  ``chip_smoke.py``'s deep, random and shallow rules, at tiles of 4 to 32
  blocks a CTA, in turns, bit-equal to ``block_scan_reference``; with
  ptxas's report of every instantiation (slot width, word path).

Run from the root of a checkout, on a machine with the card and nvcc:

    python3 tools/decode_static_trials.py

Prints each reading's mean device ms (CUDA events, L2 flushed before
every call: ``chip_smoke.py``'s ``time_cuda``), in two turns.
"""
import ctypes
import importlib
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

# (DA_WARP_KEYS, DA_STAGES, DA_CTAS_PER_SM); DA_BK = 4 warps x DA_WARP_KEYS
DECODE_VARIANTS = [(8, 3, 2), (8, 2, 3), (8, 4, 1), (4, 3, 4)]
DECODE_ROWS = ("path_fp32", "path_fp32_8k", "mha", "gqa4", "path")
STATIC_TILES = (4, 8, 16, 32)


def ptxas_report(log):
    """The entry names and their register / spill lines of nvcc -v."""
    keep = ("Compiling entry", "registers", "spill")
    return [line.strip() for line in log.splitlines()
            if any(k in line for k in keep)]


def build_variant(native, keys, stages, ctas):
    """decode_attention.cu with the variant's defines, built into
    build/trials/; returns (library path, ptxas report)."""
    out = ROOT / "build" / "trials" / f"da_k{keys}s{stages}c{ctas}"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(native.CSRC_DIR, out)
    header = out / "decode_attention.cuh"
    text = header.read_text()
    for name, value in (("DA_WARP_KEYS", keys), ("DA_BK", 4 * keys),
                        ("DA_STAGES", stages), ("DA_CTAS_PER_SM", ctas)):
        text, n = re.subn(rf"^#define {name} \d+", f"#define {name} {value}",
                          text, flags=re.MULTILINE)
        assert n == 1, name
    header.write_text(text)
    lib = out / "libdecode_attention.so"
    run = subprocess.run([native._nvcc(), *native.NVCC_FLAGS, "-o", str(lib),
                          str(out / "decode_attention.cu")],
                         capture_output=True, text=True)
    if run.returncode:
        raise RuntimeError(run.stdout + run.stderr)
    return lib, ptxas_report(run.stdout + run.stderr)


def decode_inputs(dev, name):
    """chip_smoke.py's DECODE_CASES row ``name``, drawn as decode_phase
    draws it."""
    row = next(r for r in cs.DECODE_CASES if r[0] == name)
    _, b, hq, hkv, s, d, dtype, lens, view = row
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + s + d + hq)
    dt = getattr(torch, dtype)
    q = torch.randn((b, hq, d), generator=gen, device=dev).to(dt)
    shape = (b, s, hkv, d) if view else (b, hkv, s, d)
    k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
            for _ in range(2))
    if view:
        k, v = k.transpose(1, 2), v.transpose(1, 2)
    kv_len = None if lens is None else torch.tensor(lens, device=dev)
    return q, k, v, kv_len


def decode_trials(dev, flush):
    from repro_torch.kernels import native
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref)
    from repro_torch.kernels.decode_attention import ops

    with ThreadPoolExecutor(len(DECODE_VARIANTS)) as pool:
        built = list(pool.map(lambda v: build_variant(native, *v),
                              DECODE_VARIANTS))
    kernels = []
    for (keys, stages, ctas), (lib, report) in zip(DECODE_VARIANTS, built):
        name = f"k{keys}s{stages}c{ctas}"
        print(f"[trial] decode {name}: " + " | ".join(report), flush=True)
        kern = native.NativeKernel(
            name=f"decode_attention_{name}", source="decode_attention.cu",
            headers=(), symbol="decode_attention_launch",
            argtypes=ops.DECODE_ATTENTION_KERNEL.argtypes)
        fn = ctypes.CDLL(str(lib)).decode_attention_launch
        fn.argtypes, fn.restype = kern.argtypes, ctypes.c_int
        kern._fn = fn
        kernels.append((name, kern, 4 * keys, ctas))
    order = kernels + kernels[::-1]
    for row in DECODE_ROWS:
        q, k, v, kv_len = decode_inputs(dev, row)
        want = decode_attention_ref(q, k, v, kv_len=kv_len)[0].float()
        tol = cs.BF16_TOL if q.dtype == torch.bfloat16 else cs.FP32_TOL
        times = {}
        for name, kern, bk, ctas in order:
            with mock.patch.object(ops, "DECODE_ATTENTION_KERNEL", kern), \
                    mock.patch.object(ops, "BLOCK_K", bk), \
                    mock.patch.object(ops, "CTAS_PER_SM", ctas), \
                    cs.decode_route(False):
                call = lambda: decode_attention(q, k, v, kv_len=kv_len)  # noqa: E731
                if name not in times:
                    err = float((call()[0].float() - want).abs().max())
                    if err > tol + tol * float(want.abs().max()):
                        raise AssertionError(f"{row} {name}: max |d| {err}")
                times.setdefault(name, []).append(cs.time_cuda(call, 50,
                                                               flush))
        print(f"[trial] decode {row} (ms in two turns): "
              + "; ".join(f"{n}: {t[0]:.6f} / {t[1]:.6f}"
                          for n, t in times.items()), flush=True)
        del q, k, v


def static_trials(dev, flush):
    from repro_torch.kernels import native
    from repro_torch.kernels.block_scan import (BLOCK_SCAN_STATIC_KERNEL,
                                                block_scan_reference)
    bsp = importlib.import_module(
        "repro_torch.kernels.block_scan.block_scan_pruned")

    (ROOT / "build" / "trials").mkdir(parents=True, exist_ok=True)
    run = subprocess.run([native._nvcc(), *native.NVCC_FLAGS, "-o",
                          str(ROOT / "build" / "trials" / "libbs_static.so"),
                          str(native.CSRC_DIR / "block_scan_static.cu")],
                         capture_output=True, text=True)
    print("[trial] static ptxas: "
          + " | ".join(ptxas_report(run.stdout + run.stderr)), flush=True)
    BLOCK_SCAN_STATIC_KERNEL.build()
    t, f, nb, w = 4, 4, cs.FULL_BLOCKS, cs.BLOCK_DOCS // 32
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED + 14)
    occ = torch.randint(-2**31, 2**31, (nb, t, f, w), generator=gen,
                        device=dev, dtype=torch.int64).to(torch.int32)
    rules = cs.whole_index_rules(cs.QUERY_BATCH, t, f, cs.SEED + 15)
    for name, rule in rules.items():
        host = tuple(x[0] for x in rule)
        want = block_scan_reference(occ, *(torch.from_numpy(x).to(dev)
                                           for x in host))
        times = {}
        for bb in STATIC_TILES + STATIC_TILES[::-1]:
            with mock.patch.object(bsp, "static_tile", lambda *a, bb=bb: bb):
                call = lambda: bsp.block_scan_pruned(occ, *host)  # noqa: E731
                if bb not in times:
                    for g, r in zip(call(), want):
                        if not torch.equal(g, r):
                            raise AssertionError(f"static {name} tile {bb}")
                times.setdefault(bb, []).append(cs.time_cuda(call, 50, flush))
        n_planes = len(bsp.static_plane_list(*host)[0])
        print(f"[trial] static {name} ({n_planes} planes; static_tile gives "
              f"{bsp.static_tile(nb, n_planes)}), blocks a CTA: ms in two "
              f"turns: " + "; ".join(f"{bb}: {t[0]:.6f} / {t[1]:.6f}"
                                     for bb, t in times.items()), flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    print(f"[trial] launch floor {cs.launch_floor_ms(dev, flush):.6f} ms",
          flush=True)
    static_trials(dev, flush)
    decode_trials(dev, flush)


if __name__ == "__main__":
    main()
