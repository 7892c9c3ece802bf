#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Print the card's name and power limit; build every CUDA kernel of
   the paths from ``src/repro_torch/csrc``, one ``nvcc`` per source, all
   started together.
2. Hold every kernel against its plain torch version on the card, at
   the shapes the paths give it, and time both (CUDA events, L2 flushed
   before every launch) beside the least time the card could take (the
   bound): the block scan bit for bit; flash attention within 2e-5
   (fp32) and 2e-2 (bf16), the JAX package's own tolerances, at the LM
   path's shape (B=2, Hq=32, Hkv=8, S=8192, D=128, bf16, causal), the
   five shapes of ``tests/test_kernels.py`` and one case with fully
   masked rows, beside ``scaled_dot_product_attention``'s time.  This
   runs before any model is resident: the plain attention materialises
   the (S, S) scores.
3. Serve: ``RetrievalSystem(device="cuda")`` at the widths of the
   websearch-rl config (block_docs=4096, T=4, F=4, k_rules=6,
   max_candidates=512, n_top=5, t_max=8, u_budget=65536, p_bins=10000,
   query batch 256) with ONE cut in depth: 64 index blocks instead of
   4096 (262,144 docs instead of 16.7M), because the synthetic corpus
   is built by a per-document Python loop.  L1 weights come from a
   seeded torch.Generator; state bins are fitted through the kernel
   backend; batches of 256 queries are served through
   ``ShardedExecutor.execute`` under the production plans and a greedy
   policy over a seeded random Q-table.  The kernels' launch counts are
   set to 0 just before and read just after; one batch must be
   bit-equal between the ``block_scan`` and ``reference`` backends.
   The rule quotas are scaled (du x16, dv x64) so that production rules
   scan several chunks; one batch is also served at the config's own
   quotas for comparison, and two batches run under torch.profiler.
4. LM serve: Mistral-NeMo-12B at full width and depth (40 layers,
   d_model 5120, 32 heads, 8 KV heads, d_head 128, d_ff 14336, vocab
   131072, bf16), random weights from a seeded CUDA generator.  The
   launch counts are set to 0, then ``prefill`` with ``use_flash=True``
   runs B=2 prompts of 8192 random tokens, the cache is padded to 8208
   positions and 16 greedy ``decode_step``s follow; the counts are read
   (the flash kernel: exactly one launch per layer).  Then a timed and
   a profiled prefill, and the same prefill through the plain chunked
   attention, whose layer-0 attention output must agree within 2e-2.
5. Print the kernels' JSON line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Without CUDA, or outside a checkout, it fails before printing a result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
INT32_OPS_PER_S = 67e12        # non-tensor 32-bit rate used for the op bound
BF16_FLOPS_PER_S = 989e12      # dense bf16 tensor-core rate
FP32_FLOPS_PER_S = 67e12       # float32 outside the tensor cores
# Read before every timed launch: > 50 MB of L2, so the launch finds
# none of its data there, and long enough (~0.3 ms) that the host has
# enqueued the launch before the GPU reaches it.
L2_FLUSH_BYTES = 1 << 30

# Serve-path widths (src/repro/configs/websearch_rl.py) and the one cut.
FULL_BLOCKS, N_BLOCKS, BLOCK_DOCS = 4096, 64, 4096
QUERY_BATCH = 256
BATCHES_PER_CATEGORY = 2
N_QUERIES = 1280               # enough for 2 batches of each category
RULE_DU_SCALE, RULE_DV_SCALE = 16, 64
SEED = 0

# LM serve path (src/repro/configs/mistral_nemo_12b.py) and its cuts.
LM_ARCH = "mistral-nemo-12b"
LM_BATCH, LM_PROMPT, LM_DECODE_STEPS = 2, 8192, 16
BF16_TOL, FP32_TOL = 2e-2, 2e-5     # tests/test_kernels.py:68


def path_kernels():
    """The CUDA kernels of the paths: the websearch serve path's block
    scan and the LM path's flash attention."""
    from repro_torch.kernels.block_scan import BLOCK_SCAN_KERNEL
    from repro_torch.kernels.flash_attention import FLASH_ATTENTION_KERNEL

    return [BLOCK_SCAN_KERNEL, FLASH_ATTENTION_KERNEL]


def build_kernels(kernels):
    """One nvcc per source, all started together; raises if any fails."""
    def build(k):
        t0 = time.perf_counter()
        return k.build(), time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(kernels)) as pool:
        results = list(pool.map(build, kernels))
    for k, (log, secs) in zip(kernels, results):
        print(f"[build] {k.name}: {secs:.1f} s "
              f"({'built now' if log else 'already built'})", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {k.name}: {line.strip()}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_cuda(fn, reps: int, flush) -> float:
    """Mean device ms per call over ``reps`` calls, the L2 flushed before
    each by READING ``flush`` (a write would leave dirty lines whose
    write-back the timed call would pay)."""
    import torch

    for _ in range(2):
        fn()
    total = 0.0
    for _ in range(reps):
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


# ------------------------------------------------------------ phase 2
def block_scan_case(dev, b, nb, tf_planes, w, chunk, seed):
    """Random per-lane rules at the serve path's shapes, plus the
    degenerate lanes: zero active planes, zero required terms, no term
    present, and a block start that runs off the end of the index."""
    import numpy as np
    import torch

    from repro_torch.kernels.block_scan import build_rule_meta

    t = 4
    f = tf_planes // t
    rng = np.random.default_rng(seed)
    occ = (rng.integers(0, 2**32, (b, nb, tf_planes, w), dtype=np.uint32)
           & rng.integers(0, 2**32, (b, nb, tf_planes, w), dtype=np.uint32))
    allowed = rng.random((b, t, f)) < 0.5
    required = rng.random((b, t)) < 0.6
    present = rng.random((b, t)) < 0.8
    bp = rng.integers(0, nb, b).astype(np.int32)
    allowed[0] = False
    required[1] = False
    present[2] = False
    bp[3] = nb - 2
    allowed[3], required[3], present[3] = True, True, True

    def tt(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    occ_t = tt(occ.view(np.int32))
    meta = build_rule_meta(tt(allowed), tt(required), tt(present), tt(bp))
    n_active = (allowed & present[:, :, None]).sum(axis=(1, 2))
    return occ_t, meta, n_active, bp, t


def block_scan_bound_ms(n_active, bp, nb, chunk, w, meta_cols):
    """Least time for one launch: bytes it must move (the active planes'
    words of each lane's DISTINCT blocks read once -- chunk positions
    clamped to block nb-1 reread that block --, the meta read once, the
    outputs written once) over the memory rate, against its 32-bit
    operations over the op rate."""
    import numpy as np

    b = len(bp)
    blocks = np.minimum(chunk, nb - bp.astype(np.int64))
    words_read = int((n_active * blocks).sum()) * w
    bytes_moved = 4 * (words_read + b * 4 * meta_cols + b * chunk * w
                       + 2 * b * chunk)
    # per word: one OR per active plane; per term: popc, AND, add
    ops = words_read + b * chunk * w * 4 * 3
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(dev, flush):
    import numpy as np
    import torch

    from repro_torch.kernels.block_scan import (block_scan_pruned_chunk,
                                                block_scan_pruned_chunk_ref)

    b, nb, tf_planes, w = QUERY_BATCH, N_BLOCKS, 16, BLOCK_DOCS // 32
    rows = {}
    for chunk in (4, 32):
        occ, meta, n_active, bp, t = block_scan_case(dev, b, nb, tf_planes,
                                                     w, chunk, SEED + chunk)
        got = block_scan_pruned_chunk(occ, meta, chunk=chunk, n_terms=t)
        torch.cuda.synchronize()
        want = block_scan_pruned_chunk_ref(occ, meta, chunk=chunk, n_terms=t)
        err = 0
        for g, r in zip(got, want):
            diff = (g.to(torch.int64) & 0xFFFFFFFF) - (r.to(torch.int64) & 0xFFFFFFFF)
            err = max(err, int(diff.abs().max()))
            if not torch.equal(g, r):
                raise AssertionError(f"block_scan C={chunk}: kernel != plain")

        def kernel():
            block_scan_pruned_chunk(occ, meta, chunk=chunk, n_terms=t)

        ms = time_cuda(kernel, 50, flush)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            kernel()
        host_us = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        plain_ms = time_cuda(lambda: block_scan_pruned_chunk_ref(
            occ, meta, chunk=chunk, n_terms=t), 10, flush)
        bound, bound_by = block_scan_bound_ms(n_active, bp, nb, chunk, w,
                                              meta.shape[2])
        distinct = int(np.minimum(chunk, nb - bp.astype(np.int64)).sum())
        rows[chunk] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound, bound_by=bound_by)
        print(f"[kernel] block_scan_pruned_chunk B={b} nb={nb} T*F={tf_planes} "
              f"W={w} C={chunk}: bit-equal to plain (max_abs_err={err}); "
              f"kernel {ms:.6f} ms (cold L2; host {host_us:.1f} us to "
              f"enqueue one call), plain "
              f"{plain_ms:.6f} ms, bound "
              f"{bound:.6f} ms ({bound_by}; {int(n_active.sum())} active "
              f"planes over {b} lanes, {distinct} distinct lane-blocks of "
              f"{b * chunk}); kernel/bound {ms / bound:.2f}x",
              flush=True)
    return rows


# ------------------------------------------------------ phase 2, flash
# (name, B, Hq, Hkv, Sq, Skv, D, causal, dtype): the LM path's launch,
# the five shapes of tests/test_kernels.py, and fully masked rows
# (causal, Sq > Skv: the first Sq - Skv rows see no key).
FLASH_CASES = [
    ("path", LM_BATCH, 32, 8, LM_PROMPT, LM_PROMPT, 128, True, "bfloat16"),
    ("mha", 1, 4, 4, 128, 128, 64, True, "float32"),
    ("gqa4", 2, 8, 2, 256, 256, 64, True, "float32"),
    ("gqa3_bf16", 1, 6, 2, 128, 128, 128, True, "bfloat16"),
    ("bidir", 1, 2, 2, 128, 384, 64, False, "float32"),
    ("ragged", 1, 4, 1, 100, 200, 64, True, "float32"),
    ("masked", 1, 32, 8, 1024, 512, 128, True, "bfloat16"),
]


def flash_bound_ms(b, hq, hkv, sq, skv, d, causal, dtype):
    """Least time for one launch: its FLOPs (QK^T and PV over the
    (query, key) pairs the mask leaves visible, 2 per multiply-add) over
    the rate for its type (bf16 tensor cores; fp32 outside them, as
    TF32 would not keep fp32's precision), against q, k, v read once and
    o written once over the memory rate."""
    import numpy as np

    if causal:
        pairs = int(np.clip(np.arange(sq) + (skv - sq) + 1, 0, skv).sum())
    else:
        pairs = sq * skv
    flops = 4 * d * pairs * b * hq
    elt, rate = ((2, BF16_FLOPS_PER_S) if dtype == "bfloat16"
                 else (4, FP32_FLOPS_PER_S))
    bytes_moved = elt * d * (2 * b * hq * sq + 2 * b * hkv * skv)
    t_ops = flops / rate * 1e3
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def flash_phase(dev, flush):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import attention_ref, flash_attention

    rows = {}
    for name, b, hq, hkv, sq, skv, d, causal, dtype in FLASH_CASES:
        dt = getattr(torch, dtype)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + sq + skv + d)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
                   for shape in ((b, hq, sq, d), (b, hkv, skv, d),
                                 (b, hkv, skv, d)))
        got = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        want = attention_ref(q, k, v, causal=causal).float()
        tol = BF16_TOL if dtype == "bfloat16" else FP32_TOL
        diff = (got.float() - want).abs()
        err = float(diff.max())
        if not (bool((diff <= tol + tol * want.abs()).all())
                and bool(torch.isfinite(got).all())):
            raise AssertionError(f"flash {name}: kernel != plain "
                                 f"(max_abs_err={err}, tol {tol})")
        masked = max(sq - skv, 0) if causal else 0
        if masked and not bool((got[:, :, :masked] == 0).all()):
            raise AssertionError(f"flash {name}: fully masked rows are not 0")
        del want, diff, got

        reps = 3 if name == "path" else 20
        ms = time_cuda(lambda: flash_attention(q, k, v, causal=causal), reps,
                       flush)
        plain_ms = time_cuda(lambda: attention_ref(q, k, v, causal=causal),
                             reps, flush)
        # SDPA aligns its causal mask top-left: the same function only
        # when Sq == Skv or without a mask.
        library_ms = None
        if sq == skv or not causal:
            library_ms = time_cuda(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), reps, flush)
        bound, bound_by = flash_bound_ms(b, hq, hkv, sq, skv, d, causal, dtype)
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          library_ms=library_ms, bound_ms=bound,
                          bound_by=bound_by)
        lib = "n/a (other mask)" if library_ms is None else f"{library_ms:.6f} ms"
        print(f"[kernel] flash_attention {name}: B={b} Hq={hq} Hkv={hkv} "
              f"Sq={sq} Skv={skv} D={d} {'causal' if causal else 'bidir'} "
              f"{dtype}: max_abs_err={err:.3g} (tol {tol}"
              f"{f', {masked} rows fully masked, all 0' if masked else ''}); "
              f"kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, sdpa {lib}, "
              f"bound {bound:.6f} ms ({bound_by}); kernel/bound "
              f"{ms / bound:.2f}x", flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    return rows


# ------------------------------------------------------------ phase 3
def serve_config(n_blocks=N_BLOCKS, n_queries=N_QUERIES):
    from repro_torch.data.querylog import QueryLogConfig
    from repro_torch.index.corpus import CorpusConfig
    from repro_torch.system import SystemConfig

    return SystemConfig(
        corpus=CorpusConfig(n_docs=n_blocks * BLOCK_DOCS, seed=SEED),
        querylog=QueryLogConfig(n_queries=n_queries, seed=SEED),
        block_docs=BLOCK_DOCS, max_candidates=512, n_top=5, p_bins=10_000,
        u_budget=65536, t_max=8, rule_du_scale=RULE_DU_SCALE,
        rule_dv_scale=RULE_DV_SCALE, seed=SEED, backend="block_scan")


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def mean_blocks_per_rule(sys_, cat, inputs):
    """Blocks scanned per rule execution of the production plan: Δu of
    each step over the rule's planes per block, over steps that scanned."""
    import torch

    from repro_torch.core.match_plan import plan_rollout
    from repro_torch.core.match_rules import block_cost

    plan = sys_.plan_for_category(cat)
    occ, scores, tp = inputs
    _, traj = plan_rollout(sys_.env_cfg, sys_.ruleset, plan, occ, scores, tp,
                           backend="block_scan")
    u = traj["u"]                                           # (B, L)
    du = torch.diff(u, dim=1, prepend=torch.zeros_like(u[:, :1]))
    u_inc = torch.stack([block_cost(sys_.ruleset.allowed[int(r)][None], tp)
                         for r in plan.rule_idx.tolist()], dim=1)
    ran = (du > 0) & (u_inc > 0)
    return float((du[ran] / u_inc[ran]).mean())


def serve_phase(dev, cfg, batch=QUERY_BATCH, batches_per_cat=BATCHES_PER_CATEGORY):
    """Build the system, fit bins, serve and check what was served;
    returns the kernels' launch counts of the serve step."""
    import numpy as np
    import torch

    from repro_torch.data.querylog import CAT1, CAT2
    from repro_torch.policies import TabularQPolicy
    from repro_torch.serving.executor import ShardedExecutor
    from repro_torch.system import RetrievalSystem

    t0 = time.perf_counter()
    sys_ = RetrievalSystem(cfg, device=dev)
    print(f"[serve] system built in {time.perf_counter() - t0:.1f} s: "
          f"{sys_.index.n_docs} docs, {sys_.env_cfg.n_blocks} blocks of "
          f"{cfg.block_docs} docs, {sys_.log.n_queries} queries; "
          f"L1 scoring sub-batch {sys_.scoring_batch_size()} queries",
          flush=True)

    t0 = time.perf_counter()
    bins = sys_.fit_state_bins(n_queries=batch, batch=batch)
    sync(dev)
    print(f"[serve] state bins fitted through '{cfg.backend}' in "
          f"{time.perf_counter() - t0:.1f} s: p={bins.p}", flush=True)

    # A seeded random Q-table whose stop column never wins: every lane
    # starts in the same bin, so a winning stop would end every episode
    # at once; otherwise lanes diverge over bins and take varied rules.
    q_np = np.random.default_rng(SEED + 7).normal(
        size=(bins.p, sys_.env_cfg.n_actions)).astype(np.float32)
    q_np[:, sys_.env_cfg.a_stop] = q_np.min() - 1.0
    q = torch.from_numpy(q_np).to(dev)
    greedy = TabularQPolicy(q)
    exe = ShardedExecutor(sys_, n_shards=1, backend=cfg.backend)
    work = []
    for cat in (CAT1, CAT2):
        qids_all = np.where(sys_.log.category == cat)[0]
        if len(qids_all) < batch * batches_per_cat:
            raise AssertionError(f"category {cat}: too few queries")
        for i in range(batches_per_cat):
            work.append((cat, qids_all[i * batch:(i + 1) * batch]))

    # Query inputs are built before the counts are reset: the main path
    # measured here is the serve step.
    inputs = []
    for cat, qids in work:
        t0 = time.perf_counter()
        inputs.append(sys_.batch_inputs(qids))
        sync(dev)
        print(f"[serve] batch inputs (cat {cat}, {len(qids)} queries): "
              f"{time.perf_counter() - t0:.3f} s", flush=True)

    kernels = path_kernels()
    for k in kernels:
        k.launches = 0
    counter = kernels[0]
    served = []
    for (cat, qids), inp in zip(work, inputs):
        for name, policy in (("plan", sys_.plan_policy(cat)),
                             ("greedy_q", greedy)):
            before = counter.launches
            t0 = time.perf_counter()
            out = exe.execute(policy, *inp)
            wall = time.perf_counter() - t0
            chunks = counter.launches - before
            served.append((name, out))
            print(f"[serve] cat {cat} {name:8s}: {wall * 1e3:.1f} ms/batch, "
                  f"{len(qids) / wall:.0f} queries/s, {chunks} kernel "
                  f"launches (chunks), mean u {out[2].mean():.1f}, mean "
                  f"cand {out[3].mean():.1f}", flush=True)
    launches = {k.name: k.launches for k in kernels}
    print(f"[serve] main path launches: {launches}", flush=True)

    # Checks of what came out, by the repo's own means.
    n_docs = sys_.index.n_docs
    for name, (ids, sc, u, cnt) in served:
        if ids.shape != (batch, exe.keep) or sc.shape != (batch, exe.keep):
            raise AssertionError(f"bad output shape {ids.shape}")
        valid = ids >= 0
        if not (np.isfinite(sc[valid]).all() and (ids[valid] < n_docs).all()):
            raise AssertionError("served ids/scores out of range")
        if not (np.diff(np.where(np.isfinite(sc), sc, -1.0), axis=1) <= 0).all():
            raise AssertionError("served scores are not sorted")
        scanned = (u > 0).all() if name == "plan" else (u > 0).any()
        if not (scanned and (cnt > 0).any()):
            raise AssertionError(f"{name} batch scanned nothing")

    # One batch, bit-equal between the kernel and the reference backend.
    ref_exe = ShardedExecutor(sys_, n_shards=1, backend="reference")
    cat0, _ = work[0]
    for name, policy in (("plan", sys_.plan_policy(cat0)), ("greedy_q", greedy)):
        t0 = time.perf_counter()
        got = exe.execute(policy, *inputs[0])
        t1 = time.perf_counter()
        want = ref_exe.execute(policy, *inputs[0])
        t2 = time.perf_counter()
        for field, g, w in zip(("ids", "scores", "u", "cand_cnt"), got, want):
            if not np.array_equal(g, w):
                raise AssertionError(f"block_scan != reference on {name}/{field}")
        print(f"[serve] cat {cat0} {name:8s}: 'block_scan' {(t1 - t0) * 1e3:.1f} "
              f"ms/batch, 'reference' {(t2 - t1) * 1e3:.1f} ms/batch", flush=True)
    print(f"[serve] cat {cat0} batch bit-equal between 'block_scan' and "
          f"'reference' backends (ids, scores, u, cand_cnt; plan and greedy_q)",
          flush=True)
    blocks = mean_blocks_per_rule(sys_, cat0, inputs[0])
    print(f"[serve] production plan (cat {cat0}): {blocks:.2f} blocks per "
          f"rule execution (mean over steps that scanned)", flush=True)
    unscaled_batch(sys_, cat0, inputs[0], greedy, counter)
    if dev.type == "cuda":
        for name, policy in (("plan", sys_.plan_policy(cat0)),
                             ("greedy_q", greedy)):
            profile_batch(exe, name, policy, inputs[0])
    return launches


def unscaled_batch(sys_, cat, inp, greedy, counter):
    """Serve one batch at the config's own rule quotas (scale 1), beside
    the scaled quotas of the main run: blocks per rule, chunks per batch."""
    import copy

    from repro_torch.core.match_plan import production_plans
    from repro_torch.core.match_rules import default_rule_library
    from repro_torch.serving.executor import ShardedExecutor

    plain = copy.copy(sys_)
    plain.cfg = dataclasses.replace(sys_.cfg, rule_du_scale=1, rule_dv_scale=1)
    plain.ruleset = default_rule_library(1, 1, device=sys_.device)
    plain.plans = production_plans(plain.ruleset)
    exe = ShardedExecutor(plain, n_shards=1)
    for name, policy in (("plan", plain.plan_policy(cat)), ("greedy_q", greedy)):
        before = counter.launches
        t0 = time.perf_counter()
        out = exe.execute(policy, *inp)
        wall = time.perf_counter() - t0
        print(f"[serve] unscaled quotas (du x1, dv x1) cat {cat} {name:8s}: "
              f"{wall * 1e3:.1f} ms/batch, {counter.launches - before} kernel "
              f"launches (chunks), mean u {out[2].mean():.1f}, mean cand "
              f"{out[3].mean():.1f}", flush=True)
    blocks = mean_blocks_per_rule(plain, cat, inp)
    print(f"[serve] unscaled quotas, production plan (cat {cat}): "
          f"{blocks:.2f} blocks per rule execution", flush=True)


# ------------------------------------------------------------ phase 4
def count_params(tree) -> int:
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    return tree.numel()


def attention_layer0(params, tokens, cfg):
    """Layer 0's attention output (B, S, d_model) on the prompt, through
    the path ``cfg.use_flash`` selects."""
    from repro_torch.models.attention import gqa_forward
    from repro_torch.models.layers import rms_norm

    lp = params["layers"]
    h = rms_norm(params["embed"][tokens], lp["ln1"][0])
    return gqa_forward({k: w[0] for k, w in lp["attn"].items()}, h,
                       cfg.attn_cfg())


def lm_phase(dev, cfg=None, batch=LM_BATCH, prompt=LM_PROMPT,
             steps=LM_DECODE_STEPS):
    """Prefill through the flash kernel, pad the cache, decode greedily
    (the main path, between a reset and a read of the launch counts);
    then a timed and a profiled prefill and the plain chunked one.
    Returns the kernels' launch counts of the main path."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import FLASH_ATTENTION_KERNEL as flash
    from repro_torch.models.transformer import decode_step, init_params, prefill

    cfg = dataclasses.replace(cfg or get_arch(LM_ARCH).model_cfg(False),
                              use_flash=True)
    plain_cfg = dataclasses.replace(cfg, use_flash=False)
    on_card = dev.type == "cuda"
    per_prefill = cfg.n_layers if on_card else 0    # one launch per layer
    print(f"[lm] {LM_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, {cfg.n_kv} kv heads, d_head {cfg.d_head}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.param_dtype}, random "
          f"weights (seed {SEED}); no width or depth cut", flush=True)
    print(f"[lm] traffic cut: prefill {batch} x {prompt} tokens instead of "
          f"prefill_32k's 32 x 32768, and decode batch {batch} instead of "
          f"decode_32k's 128 ({steps} steps from a cache padded to "
          f"{prompt + steps}), so that the simple flash kernel and the plain "
          f"(S, S) check fit the run's time", flush=True)
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device=dev)
    sync(dev)
    print(f"[lm] {count_params(params) / 1e9:.3f} B parameters drawn in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt), generator=gen,
                           device=dev)

    def run_prefill(what, c=cfg):
        before = flash.launches
        t0 = time.perf_counter()
        logits, cache = prefill(params, tokens, c, device=dev)
        sync(dev)
        secs = time.perf_counter() - t0
        if c.use_flash and flash.launches - before != per_prefill:
            raise AssertionError(f"{what}: {flash.launches - before} flash "
                                 f"launches, want {per_prefill}")
        print(f"[lm] {what}: {secs * 1e3:.1f} ms, {batch * prompt / secs:.0f} "
              f"prompt tokens/s", flush=True)
        return logits, cache

    kernels = path_kernels()
    for k in kernels:
        k.launches = 0
    logits, cache = run_prefill("prefill (flash, first call)")
    first_logits = logits
    cache = {f: F.pad(c, (0, 0, 0, 0, 0, steps)) for f, c in cache.items()}
    token = logits.argmax(dim=-1)
    pos = torch.full((batch,), prompt, dtype=torch.int64, device=dev)
    outs, step_ms = [logits], []
    for _ in range(steps):
        t0 = time.perf_counter()
        logits, cache = decode_step(params, token, cache, pos, cfg, device=dev)
        sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(logits)
        token = logits.argmax(dim=-1)
        pos = pos + 1
    launches = {k.name: k.launches for k in kernels}
    print(f"[lm] main path launches: {launches}", flush=True)
    if launches["flash_attention"] != per_prefill:
        raise AssertionError("the LM path's flash launches are not one per layer")
    for out in outs:
        if out.shape != (batch, cfg.vocab) or not bool(torch.isfinite(out).all()):
            raise AssertionError("LM logits are not finite or misshapen")
    rest = step_ms[1:] or step_ms
    print(f"[lm] decode: {steps} greedy steps at B={batch}, first "
          f"{step_ms[0]:.2f} ms, then mean {sum(rest) / len(rest):.2f} ms/step "
          f"(min {min(rest):.2f}); {batch * len(rest) / sum(rest) * 1e3:.1f} "
          f"tokens/s", flush=True)
    if on_card:     # pos is now past the cache: this step stores nothing
        profile_device("lm decode step", lambda: decode_step(
            params, token, cache, pos, cfg, device=dev), "flash_attention")
    del cache, outs

    logits, cache = run_prefill("prefill (flash, steady)")
    print(f"[lm] steady prefill against the first: max |dlogit| "
          f"{float((logits - first_logits).abs().max()):.3g}", flush=True)
    del logits, cache
    if on_card:
        before = flash.launches
        kern_us, busy_us, _ = profile_device(
            "lm prefill", lambda: prefill(params, tokens, cfg, device=dev),
            "flash_attention")
        if flash.launches - before != per_prefill:
            raise AssertionError("profiled prefill: flash launches != layers")
        print(f"[lm] flash kernel share of prefill device time: "
              f"{100 * kern_us / busy_us:.1f}%", flush=True)

    plain_logits, cache = run_prefill("prefill (plain chunked attention)",
                                        plain_cfg)
    del cache
    print(f"[lm] flash against plain prefill: max |dlogit| "
          f"{float((first_logits - plain_logits).abs().max()):.4g} over "
          f"{batch} x {cfg.vocab} logits, last-token argmax agrees on "
          f"{int((first_logits.argmax(-1) == plain_logits.argmax(-1)).sum())}"
          f" of {batch}", flush=True)
    got = attention_layer0(params, tokens, cfg).float()
    want = attention_layer0(params, tokens, plain_cfg).float()
    diff = (got - want).abs()
    print(f"[lm] layer-0 attention output, flash against plain: max |d| "
          f"{float(diff.max()):.4g} (values up to {float(want.abs().max()):.3g}; "
          f"tol {BF16_TOL} + {BF16_TOL}|plain|)", flush=True)
    if not bool((diff <= BF16_TOL + BF16_TOL * want.abs()).all()):
        raise AssertionError("layer-0 attention: flash != plain within bf16 tol")
    if on_card:
        print(f"[lm] peak device memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} "
              f"GB (torch.cuda.max_memory_allocated)", flush=True)
    return launches


def profile_batch(exe, name, policy, inp):
    """One served batch under torch.profiler."""
    profile_device(name, lambda: exe.execute(policy, *inp),
                   "block_scan_pruned_chunk")


def profile_device(name, fn, kernel):
    """Run ``fn`` under torch.profiler and print the device's busy and
    idle share of the wall time, ``kernel``'s share of busy time, and
    where the device and host time go; returns (kernel us, busy us,
    wall us)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Device-side events only (kernels, memcpy, memset): an aten op's
    # self device time repeats that of the kernels it launched.
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev_events)
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:                 # union of the events' intervals
        if e > end:
            busy_us += e - max(s, end)
            end = e
    per_name = {}
    for e in dev_events:
        n, us = per_name.get(e.name, (0, 0.0))
        per_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    # CUDA names a template kernel "void name<T>(...)"
    kern = [v for k, v in per_name.items() if f"{kernel}_kernel" in k]
    kern_us = sum(us for _, us in kern)
    print(f"[profile] {name}: wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%, idle "
          f"{100 - 100 * busy_us / wall_us:.1f}%) over {len(dev_events)} "
          f"device events; {kernel} kernel {kern_us / 1e3:.3f} ms over "
          f"{sum(n for n, _ in kern)} launches "
          f"({100 * kern_us / max(busy_us, 1e-9):.1f}% of busy)", flush=True)
    top = sorted(per_name.items(), key=lambda kv: kv[1][1], reverse=True)[:8]
    for key, (n, us) in top:
        print(f"[profile] {name} top by device: {key[:60]!r} n={n} "
              f"{us / 1e3:.3f} ms", flush=True)
    events = prof.key_averages()
    top = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    for e in top:
        print(f"[profile] {name} top by host: {e.key[:60]!r} n={e.count} "
              f"{e.self_cpu_time_total / 1e3:.3f} ms", flush=True)
    return kern_us, busy_us, wall_us


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    from repro_torch.device import resolve_device

    t_start = time.perf_counter()
    dev = resolve_device("cuda")
    card = card_line()
    print(f"[card] {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    t0 = time.perf_counter()
    build_kernels(path_kernels())
    print(f"[build] all kernels in {time.perf_counter() - t0:.1f} s", flush=True)

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
    rows = kernel_phase(dev, flush)
    flash_rows = flash_phase(dev, flush)
    del flush
    torch.cuda.empty_cache()

    cfg = serve_config()
    print(f"[serve] depth cut: {N_BLOCKS} index blocks instead of "
          f"{FULL_BLOCKS} ({N_BLOCKS * BLOCK_DOCS} docs instead of "
          f"{FULL_BLOCKS * BLOCK_DOCS}); all widths as configured; rule "
          f"quotas scaled du x{RULE_DU_SCALE}, dv x{RULE_DV_SCALE} so that "
          f"rules span several chunks (one batch at x1 follows)", flush=True)
    launches = serve_phase(dev, cfg)
    if launches["block_scan_pruned_chunk"] <= 0:
        raise AssertionError("the serve path launched no block_scan kernel")

    lm_launches = lm_phase(dev)
    flash_main = flash_rows["path"]

    main_row = rows[4]      # DEFAULT_CHUNK_BLOCKS: the serve path's chunk
    kernels = [dict(
        name="block_scan_pruned_chunk", route="cuda",
        source="src/repro_torch/csrc/block_scan.cu",
        replaces="src/repro/kernels/block_scan/block_scan_pruned.py:222",
        launches=launches["block_scan_pruned_chunk"],
        max_abs_err=max(r["max_abs_err"] for r in rows.values()),
        ms=main_row["ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=None), dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/flash_attention.py:87",
        launches=lm_launches["flash_attention"],
        max_abs_err=max(r["max_abs_err"] for r in flash_rows.values()),
        ms=flash_main["ms"], plain_ms=flash_main["plain_ms"],
        bound_ms=flash_main["bound_ms"], bound_by=flash_main["bound_by"],
        library_ms=flash_main["library_ms"])]
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
