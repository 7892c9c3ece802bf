#!/usr/bin/env python3
"""Probe what the card's memory system gives the E = 1 embedding bag at
Wide&Deep's serve_bulk shape (V = 40M rows of one fp32, one id a field at
the field's offset, L = 40, B = 262,144; and DeepFM's L = 39): the column
route beside a plain gather of the same ids (``index_select``, in bag
order and in field order), each under every L2 fetch granularity the
CUDA context takes (``cuCtxSetLimit(CU_LIMIT_MAX_L2_FETCH_GRANULARITY)``); then
the trial forms of tools/bag_column_trials.cu, each held bit for bit
against the column route.

Run from the root of a checkout, on a machine with the card and nvcc:

    python3 tools/bag_gather_probe.py

Prints each reading's mean device ms (CUDA events, L2 flushed before
every call, chip_smoke.py's time_cuda), twice, and the rate of distinct
32-byte sectors it implies.
"""
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

CU_LIMIT_MAX_L2_FETCH_GRANULARITY = 0x05


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    from repro_torch.kernels.embedding_bag import (EMBEDDING_BAG_KERNEL,
                                                   embedding_bag)

    print(cs.card_line(), flush=True)
    dev = torch.device("cuda")
    EMBEDDING_BAG_KERNEL.build()
    cuda = ctypes.CDLL("libcuda.so.1")
    torch.zeros(1, device=dev)                      # the primary context
    limit = ctypes.c_size_t()

    def granularity(g=None):
        if g is not None:
            err = cuda.cuCtxSetLimit(CU_LIMIT_MAX_L2_FETCH_GRANULARITY,
                                     ctypes.c_size_t(g))
            if err:
                raise RuntimeError(f"cuCtxSetLimit({g}): CUDA error {err}")
        err = cuda.cuCtxGetLimit(ctypes.byref(limit),
                                 CU_LIMIT_MAX_L2_FETCH_GRANULARITY)
        if err:
            raise RuntimeError(f"cuCtxGetLimit: CUDA error {err}")
        return limit.value

    out_dir = ROOT / "build" / "trials"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libbag_column_trials.so"
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-I", str(ROOT / "src" / "repro_torch" / "csrc"), "-o", str(lib_path),
                    str(ROOT / "tools" / "bag_column_trials.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.form_name.restype = ctypes.c_char_p
    lib.run_form.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    default = granularity()
    print(f"L2 fetch granularity: {default} bytes by default", flush=True)
    flush = torch.empty(cs.L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    for b, l in ((262_144, 40), (262_144, 39)):
        v = l * cs.WD_VOCAB
        gen = torch.Generator(device=dev)
        gen.manual_seed(cs.SEED + v + 1 + b)
        table = torch.randn((v, 1), generator=gen, device=dev)
        idx = (torch.randint(0, cs.WD_VOCAB, (b, l), generator=gen, device=dev,
                             dtype=torch.int32)
               + torch.arange(l, device=dev, dtype=torch.int32) * cs.WD_VOCAB)
        flat, by_bag, by_field = table.view(-1), idx.view(-1), idx.t().contiguous().view(-1)
        bound, _, sectors = cs.bag_bound_ms(table, idx, False)
        want = embedding_bag(table, idx)
        forms = {
            "column route": lambda: embedding_bag(table, idx),
            "gather, bag order": lambda: flat.index_select(0, by_bag),
            "gather, field order": lambda: flat.index_select(0, by_field),
        }
        print(f"B={b} L={l}: {sectors} distinct 32-byte sectors for {b * l} "
              f"lookups; bound {bound:.6f} ms", flush=True)
        for g in sorted({default, 32, 64, 128}):
            granularity(g)
            with cs.bag_route_forced("column"):
                got = embedding_bag(table, idx)
                torch.cuda.synchronize()
                if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                    raise AssertionError(f"column route at granularity {g}: other bits")
                res = []
                for name, fn in forms.items():
                    a, c = cs.time_cuda(fn, 50, flush), cs.time_cuda(fn, 50, flush)
                    res.append(f"{name} {a:.6f} / {c:.6f} ms "
                               f"({32 * sectors / min(a, c) / 1e9:.3f} TB/s of sectors)")
            print(f"  granularity {granularity()} B: " + "; ".join(res), flush=True)
        granularity(default)
        out = torch.empty(b, device=dev)
        st_sum, st_past = torch.empty(b, device=dev), torch.empty(2 * b, device=dev, dtype=torch.int32)
        stream = torch.cuda.current_stream().cuda_stream
        for f in range(lib.n_forms()):
            name = lib.form_name(f).decode()

            def call(f=f, name=name):
                err = lib.run_form(f, table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                   st_sum.data_ptr(), st_past.data_ptr(), v, b, l, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            if not torch.equal(out.view(torch.int32), want.view(-1).view(torch.int32)):
                raise AssertionError(f"{name} at L={l}: not the column route's bits")
            a, c = cs.time_cuda(call, 50, flush), cs.time_cuda(call, 50, flush)
            print(f"  trial {name}: {a:.6f} / {c:.6f} ms "
                  f"({32 * sectors / min(a, c) / 1e9:.3f} TB/s of sectors)", flush=True)
        del out, st_sum, st_past
        del table, idx, flat, by_bag, by_field
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
