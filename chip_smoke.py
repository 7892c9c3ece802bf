#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Print the card's name and power limit; build the nine CUDA kernels
   of the paths from ``src/repro_torch/csrc``, one ``nvcc`` per kernel,
   all started together.
2. Hold every kernel against its plain torch version on the card, at
   the shapes the paths give it, and time both (CUDA events, L2 flushed
   before every launch) beside the least time the card could take (the
   bound) and, where one exists, one PyTorch call that computes the same
   function: the chunked block scan bit for bit, beside a launch floor
   (one launch of a one-element ``add_``, timed the same way); the
   whole-index scans
   through ``kernels/block_scan/ops`` (``block_scan_batched`` and
   ``block_scan`` on the tile kernel, ``block_scan_pruned`` on the
   static kernel) at the websearch-rl config's full index (Q=256
   queries x 4096 blocks x 16 planes x 128 words, 8.59 GB of occupancy
   from a seeded generator on the device) under the deepest rule, a
   shallow one (2 active planes) and a random rule per query: that path
   runs between a reset and a read of the launch counts, then every
   output is held bit for bit against ``block_scan_reference`` in
   slices of 16 queries, and timed (no PyTorch call computes these
   scans; every block-scan row prints its GB/s and bound/time; the
   static kernel's rows also the launch floor and (ms - floor)/bound,
   and the static kernel is timed at twice its tile, in turns); flash
   attention within 2e-5
   (fp32) and 2e-2 (bf16), the JAX package's own tolerances, on its two
   routes (bf16 at D 64 or 128: the tensor-core kernel; fp32 and other
   D: the CUDA-core kernel; each row prints its route): at the LM
   path's shape (B=2, Hq=32, Hkv=8, S=8192, D=128, bf16, causal), at
   ``prefill_32k``'s length (B=1, S=32768; held on its first and last
   512 rows, as the (S, S) plain scores would take 137 GB, so no plain
   time), at the fp32 route's LM shape (B=2, S=1024, fp32), the five
   shapes of ``tests/test_kernels.py`` and one case with fully masked
   rows, beside ``scaled_dot_product_attention``; decode
   attention within the same tolerances, element by element and row by
   row, on its two routes (bf16 at D 64/128, group <= 16: the
   tensor-core kernel, every such row also through the CUDA-core kernel;
   fp32: the CUDA-core kernel) at the LM decode path's shape (B=2,
   Hq=32, Hkv=8, S=8208, D=128, bf16, kv_len 8193, through the
   transposed view of a (B, S, Hkv, D) cache; the tensor-core kernel
   also under two other split plans), phase 4's fp32-route launch
   (B=2, S=1026, kv_len 1025, fp32; one call under torch.profiler: one
   kernel), the LM path's cache in fp32 (S=8208, kv_len 8193: bytes,
   not the launch, set the time), both fp32 rows also under half and
   twice the split plan's slices, the four shapes of
   ``tests/test_kernels.py``, per-row lengths with a row of length 0,
   and partials merged across four shards (fp32 1e-4, bf16 2e-2),
   beside SDPA with a length mask and the launch floor ((ms -
   floor)/bound); the embedding bag within 1e-5 (fp32)
   and 3e-2 (bf16), bags with an id past the table NaN as in the plain
   version, at the Wide&Deep path's shapes (V=40M, E=1, L=40, B=512,
   the lane route's largest batch on this card with half and twice as
   many, and 262,144, each through both E = 1 routes, the column route
   also bit for bit against the warp route's ``eb_bag_column``) and the
   shapes of ``tests/test_kernels.py``, beside ``F.embedding_bag``; at
   262,144 bags also a plain gather of the same ids (``index_select``, in
   bag and in field order), the card's rate for these random sectors.
   This runs before any model is resident:
   the plain attention materialises the (S, S) scores.
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
   On that batch's real occupancy, for each of the six rules, the
   whole-index scans (``block_scan_batched``; ``block_scan_pruned`` on
   one query) and the chunk kernel with block pointer 0 and chunk = 64
   must agree bit for bit with ``block_scan_reference``.
   The rule quotas are scaled (du x16, dv x64) so that production rules
   scan several chunks; one batch is also served at the config's own
   quotas for comparison, and two batches run under torch.profiler.
3b. Train (websearch-rl's ``rl_rollout`` shape, query batch 256) on
   the system phase 3 built: ``fit_l1`` (256 judged queries, l1_steps
   Adam steps of 4096 pairs; the loss must fall) and one
   ``_l1_adam_step`` on the card against the CPU (rtol 1e-5, atol
   1e-6); one ``train_batch`` at ε 0.1 with draws from a seeded CUDA
   generator, run twice on ``block_scan`` (Q bit-equal) and once on
   ``reference`` (transitions, final state and Q bit-equal), its TD
   update against a float64 scatter-mean (1e-6 x (1 + |q|)), and its
   chunk-kernel launches (> 0); then, between a reset and a read of
   the launch counts, ``train_policy`` per category (ε 0.5 -> 0.05, as
   many iterations as fit in about 60 s for both), three steps timed
   stage by stage, ``evaluate`` of each trained Q against its
   production plan (Δu %, ΔNCG %; no threshold at this depth) and one
   step under torch.profiler.
3c. Engine: phase 3b's trained Qs published as ``TabularQPolicy``s
   (fallbacks: the system's two-entry shallow plans) into a
   ``PolicyStore``, served through ``ServeEngine`` on the same system
   (buckets 8..256, a result cache of 4096, ``block_scan``): warmup,
   then with the counts set to 0 a stream of 2,560 arrivals drawn under
   the query log's own popularity (``QueryLog.popularity``) —
   64 one ticket at a time (``serve``), 1,984 in slabs of 256
   (``serve_many``), 256 at SHALLOW, then a publish of the same Qs as v2
   and 256 more in two slabs — and the counts read.  Checks: no serve
   step prepared after warmup, chunk launches > 0, every response's ids
   in range and scores sorted, hits before the swap and none after it
   before a fill at v2, and an engine on the ``reference`` backend over
   the same stream giving every response field (all but the host-clock
   latency) bit-equal.  Prints queries/s, the Telemetry latency
   percentiles, the hit rate, each bucket's split into ``batch_inputs``
   and ``execute``, chunk launches per micro-batch and one profiled
   drain of a bucket of cold arrivals.
3d. Serve while training: phase 3b's Qs published as v1 (with the
   shallow-plan fallbacks) into a ``PolicyStore`` whose publishes are
   recorded through ``subscribe``; a ``ReplicaSet`` of 2 thread replicas
   (engines as 3c's, ``block_scan``, tracing on, the tap's holdout every
   4th record, the cold SHALLOW estimate at the smaller shallow cap)
   and a ``TrainerLoop`` (8 iterations of 64 queries a category, a
   publish every 4, gated on the tap's holdout) that trains from the
   cluster's served-traffic tap.  Warmup (serial, before the threads),
   then with the counts set to 0: waves of 256 arrivals under the log's
   popularity through ``submit_many`` while the trainer runs, one wave
   after its join (profiled on the card), then a burst of 256 submits
   against a finite u budget sized as the reference's smoke sizes it;
   the counts are read.  Checks: no ``Shed`` for a ``replica_error``
   (a replica turns any exception into one), no shed at all in the
   waves (infinite budget), the trainer raised nothing, chunk launches
   > 0, versions 2 and 3 published by the trainer, version lag within
   the staleness bound, the trainer's batches from the tap only, the
   burst degraded to SHALLOW with no hard shed, no serve step prepared
   after warmup, and every response bit-equal (ids, scores, u,
   candidates, version, epoch, level) to its query served by a
   ``reference``-backend engine on its version's snapshot at its level.
   The Chrome trace and the fleet metrics go under ``results/`` and
   through ``tools/check_trace.py --require-chain --metrics``; then
   ``launch/cluster.py --smoke`` runs as a subprocess on the card, its
   trace through ``check_trace.py`` and its statusz through
   ``tools/obsctl.py``, each required to exit 0.  Prints queries/s,
   ticket latency percentiles of the waves and the burst, the admission
   mix, versions and lag, each replica's micro-batches with their
   ``batch_inputs``/``execute`` means, the launch counts and the
   profiled wave's idle share.
3e. Serve while the index mutates: a ``LiveRetrievalSystem`` at phase
   3's config (the same 64-block base, 262,144 docs, its one cut) with
   the reference's default capacity, twice the base (128 blocks,
   524,288 docs), its base generations memmapped from a temporary
   directory; ``fit_l1`` and ``fit_state_bins`` on it (the capacity
   planes); the production plans (shallow-plan fallbacks) published
   into a ``PolicyStore``; a ``ReplicaSet`` of 2 thread replicas with
   3c's engines on ``block_scan``; a ``MergeDaemon`` compacting at
   2,048 delta docs.  Warmup, then with the counts set to 0: 8
   freshness ticks (``FreshnessWorkload``: 1,024 new docs at static
   rank 0.01 and their chase queries, after 64 base-doc updates through
   ``update_document``; each tick commits an epoch) each followed by a
   wave of 256 (70% fresh), a settle while the daemon compacts, one
   last wave (profiled on the card); the counts are read.  Checks: no shed and nothing
   dropped, no ``replica_error`` shed, no ``MergeDaemon.last_error``,
   >= 2 merges and generations, responses across >= 2 epochs, a base
   that reads as mmapped, chunk launches > 0, every response bit-equal
   to a ``reference`` rollout at its own pinned epoch and level, and
   ``check_epoch_parity`` (structure, occupancy, rollouts on
   ``reference`` and ``block_scan``) at every epoch recorded through
   ``live.store.subscribe``, 16 queries each.  Prints queries/s, ticket
   p50/p99, each commit's and merge's ms (the index's spans), the
   generations' bytes and docs, bytes per query from the base and the
   delta, epoch swaps and lag, the share of fresh responses whose
   judged doc is among their rollout's candidates and among the served
   ids, each replica's ``batch_inputs``/``execute`` means,
   the occupancy build at capacity beside the static build of the same
   base, and one compaction of 2,048 new docs timed with no serving
   thread beside it; then ``launch/live_index.py --smoke`` runs as a
   subprocess on the card and must exit 0.
4. LM serve: Mistral-NeMo-12B at full width and depth (40 layers,
   d_model 5120, 32 heads, 8 KV heads, d_head 128, d_ff 14336, vocab
   131072, bf16), random weights from a seeded CUDA generator.  The
   launch counts are set to 0, then ``prefill`` with ``use_flash=True``
   runs B=2 prompts of 8192 random tokens, the cache is padded to 8208
   positions and 16 greedy ``decode_step``s follow through the decode
   kernel; the counts are read (the tensor-core flash kernel: one
   launch per layer per prefill; the tensor-core decode kernel: one per
   layer per step).  One decode step then runs
   from copies of one cache through the kernel and through the plain
   einsums (max |dlogit|, argmax agreement, ms per step), a decode step
   is profiled on each decode kernel, and a timed and a profiled
   prefill follow, with the
   same prefill through the plain chunked attention, whose layer-0
   attention output must agree within 2e-2.  Then the fp32 route: the
   same model at full width in fp32, cut to 2 layers, prefills B=2
   prompts of 1024 tokens and takes 2 decode steps between a reset and
   a read of the counts (the CUDA-core flash and decode kernels: one
   launch per layer per call), held against the plain chunked prefill
   and the plain decode step (1e-4 + 1e-4|logit|, the CPU tests' fp32
   tolerance).
5. Recsys serve: Wide&Deep, DeepFM, DCN-v2 and BERT4Rec at their full
   configs (no width cut), random fp32 weights from a seeded CUDA
   generator, ids uniform per field from a seeded generator.  With the
   counts set to 0: ``serve_p99`` (batch 512) for every arch,
   ``serve_bulk`` (batch 262,144) for Wide&Deep and DeepFM, and
   ``retrieval_cand`` (1 query x 1M items) for BERT4Rec; exactly one
   embedding-bag launch per Wide&Deep or DeepFM forward, of the lane
   route at ``serve_p99`` and of the column route at ``serve_bulk``;
   ``retrieval_topk``'s indices against a stable sort's, and its time
   beside ``torch.topk``'s on the same scores.  Each
   kernel-path forward is held against the same forward with the plain
   bag (1e-5 + 1e-5|logit|); one ``serve_bulk`` forward of each of the
   two runs under torch.profiler.
6. Print the kernels' JSON line (the chunk kernel's row also carries
   the training path's launches, ``train_launches``, the engine
   stream's, ``engine_launches``, the cluster stream's,
   ``cluster_launches``, and the live fleet's, ``live_launches``), the
   card line, and last
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
from unittest import mock
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
MERGE_TOL = 1e-4                    # tests/test_kernels.py:122
# Flash and decode attention's out, row by row: the relative L2 error of
# each (b, head, query) row that has a key.  A row over n keys has |out|
# of about sqrt(e / n): ~0.015 at the LM path's lengths, below the
# elementwise 2e-2 above; this scales with the row.  bf16: one rounding
# of out and, on the tensor-core route, of P, 2**-9 relative per
# element or term; fp32: sums in another order.
ROW_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
PLANTED_SCALE = 0.9    # a planted fault (out scaled) the check must reject
BAG_BF16_TOL, BAG_FP32_TOL = 3e-2, 1e-5     # tests/test_kernels.py:141

# Recsys serve path (src/repro/configs/{wide_deep,deepfm,dcn_v2,bert4rec}.py,
# shapes of configs/recsys_family.py).
RECSYS_ARCHS = ("wide-deep", "deepfm", "dcn-v2", "bert4rec")
BAG_ARCHS = ("wide-deep", "deepfm")             # the archs with a bag sum
# Kernel path against plain bag, one forward: the wide / first-order
# term is a sum of 40 (39) fp32 terms of ~1e-2 in another order, and the
# rest of the forward is the same ops on the same inputs.
RECSYS_TOL = 1e-5


def path_kernels():
    """The CUDA kernels of the paths: the websearch serve path's block
    scan, the whole-index block scans behind ``kernels/block_scan/ops``,
    the LM path's flash attention and decode attention (both routes
    each), and the recsys path's embedding bag (both E = 1 routes; the
    column kernel also takes E > 1)."""
    from repro_torch.kernels.block_scan import (BLOCK_SCAN_KERNEL,
                                                BLOCK_SCAN_STATIC_KERNEL,
                                                BLOCK_SCAN_TILE_KERNEL)
    from repro_torch.kernels.decode_attention import (
        DECODE_ATTENTION_KERNEL, DECODE_ATTENTION_TC_KERNEL)
    from repro_torch.kernels.embedding_bag import (EMBEDDING_BAG_KERNEL,
                                                   EMBEDDING_BAG_LANES_KERNEL)
    from repro_torch.kernels.flash_attention import (FLASH_ATTENTION_KERNEL,
                                                     FLASH_ATTENTION_TC_KERNEL)

    return [BLOCK_SCAN_KERNEL, BLOCK_SCAN_TILE_KERNEL,
            BLOCK_SCAN_STATIC_KERNEL, FLASH_ATTENTION_KERNEL,
            FLASH_ATTENTION_TC_KERNEL, DECODE_ATTENTION_KERNEL,
            DECODE_ATTENTION_TC_KERNEL, EMBEDDING_BAG_KERNEL,
            EMBEDDING_BAG_LANES_KERNEL]


def reset_counts():
    for k in path_kernels():
        k.launches = 0


def read_counts():
    return {k.name: k.launches for k in path_kernels()}


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


def time_warm(fn, reps=20) -> float:
    """Mean device ms per call over ``reps`` back-to-back calls (CUDA
    events), after two warm-up calls: L2 left warm."""
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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
    operations over the op rate.  Returns (ms, what bounds it, bytes)."""
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
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", bytes_moved)


def launch_floor_ms(dev, flush) -> float:
    """One launch of a one-element elementwise op, timed as the kernels
    are (``time_cuda``): the part of a short kernel's time that is the
    launch itself."""
    import torch

    one = torch.zeros(1, device=dev)
    return time_cuda(lambda: one.add_(1), 50, flush)


def rate_text(ms, bound, bytes_moved) -> str:
    """A block-scan row's achieved rate and share of its bound."""
    return (f"{bytes_moved / ms / 1e6:.1f} GB/s, bound/time "
            f"{bound / ms:.2f}")


def excess_text(ms, floor, bound) -> str:
    """A short kernel's time beside the launch floor: its excess over
    the floor as a share of its bound."""
    return (f"launch floor {floor:.6f} ms, (ms - floor)/bound "
            f"{(ms - floor) / bound:.2f}")


def kernel_phase(dev, flush, floor):
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
        bound, bound_by, moved = block_scan_bound_ms(n_active, bp, nb, chunk,
                                                     w, meta.shape[2])
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
              f"{b * chunk}); kernel/bound {ms / bound:.2f}x; "
              f"{rate_text(ms, bound, moved)}; launch floor {floor:.6f} ms "
              f"({floor / ms:.0%} of the kernel's time)",
              flush=True)
    return rows


# ---------------------------------------------- phase 2, whole-index scans
WHOLE_SLICE = 16        # queries per plain-version slice (its temporaries)


def whole_index_rules(q, t, f, seed):
    """(allowed (Q, T, F), required (Q, T), present (Q, T)) bool numpy
    arrays per rule: the deepest rule (all T*F planes, every term
    required), a shallow one (one field over two present terms: 2
    active planes) and a random rule per query, drawn as
    ``tests/test_kernels.py``'s ``test_block_scan_property`` draws
    them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    deep = (np.ones((q, t, f), bool), np.ones((q, t), bool),
            np.ones((q, t), bool))
    two = np.zeros((q, t), bool)
    two[:, :2] = True
    shallow_allowed = np.zeros((q, t, f), bool)
    shallow_allowed[:, :, f - 1] = True
    shallow = (shallow_allowed, two, two.copy())
    rand = (rng.random((q, t, f)) < 0.6, rng.random((q, t)) < 0.6,
            rng.random((q, t)) < 0.8)
    return {"deep": deep, "shallow": shallow, "random": rand}


def whole_index_bound_ms(n_active, nb, w, rule_bytes):
    """Least time for one launch over every block of len(n_active)
    queries: the active planes' words read once, the rule read once,
    match, v_inc and n_match written once, over the memory rate; against
    its 32-bit operations (one OR per active word read; per term word a
    popcount, an AND and an add) over the op rate.  Returns (ms, what
    bounds it, bytes)."""
    q = len(n_active)
    words_read = int(n_active.sum()) * nb * w
    bytes_moved = 4 * (words_read + q * nb * w + 2 * q * nb) + rule_bytes
    ops = words_read + q * nb * w * 4 * 3
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", bytes_moved)


def max_word_err(got, want):
    """Largest |got - want| over the outputs, words read as uint32;
    raises unless they are equal."""
    import torch

    err = 0
    for g, r in zip(got, want):
        diff = ((g.to(torch.int64) & 0xFFFFFFFF)
                - (r.to(torch.int64) & 0xFFFFFFFF))
        err = max(err, int(diff.abs().max()))
        if not torch.equal(g, r):
            raise AssertionError(f"kernel != plain (max_abs_err={err})")
    return err


def whole_index_phase(dev, flush, q=QUERY_BATCH, nb=FULL_BLOCKS,
                      w=BLOCK_DOCS // 32, floor=None):
    """The whole-index scans through ``kernels/block_scan/ops`` at the
    websearch-rl config's full index (the path: the launch counts are
    set to 0 just before and read just after), then every output held
    bit for bit against the plain version, in slices of queries, and,
    on the card, cold-L2 times beside the bounds (the static kernel's
    also beside the launch floor ``floor``, and at twice its tile, in
    turns).  Returns the path's counts and the rows of the two
    kernels."""
    import importlib

    import numpy as np
    import torch

    bsp = importlib.import_module(
        "repro_torch.kernels.block_scan.block_scan_pruned")

    from repro_torch.kernels.block_scan import (block_scan, block_scan_batched,
                                                block_scan_pruned,
                                                block_scan_reference)

    t, f = 4, 4
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 14)
    occ = torch.empty((q, nb, t, f, w), dtype=torch.int32, device=dev)
    for i in range(0, q, WHOLE_SLICE):      # int64 draws, a slice at a time
        part = occ[i:i + WHOLE_SLICE]
        part.copy_(torch.randint(-2**31, 2**31, part.shape, generator=gen,
                                 device=dev, dtype=torch.int64))
    rules = whole_index_rules(q, t, f, SEED + 15)
    rules_t = {name: tuple(torch.from_numpy(a).to(dev) for a in r)
               for name, r in rules.items()}
    print(f"[whole] index: Q={q} queries x {nb} blocks x T*F={t * f} planes "
          f"x W={w} words ({occ.numel() * 4 / 1e9:.2f} GB of occupancy from a "
          f"seeded generator on the device, not a corpus)", flush=True)

    reset_counts()
    outs = {}
    for name, (a, r, p) in rules_t.items():
        host = tuple(x[0] for x in rules[name])
        outs[name] = (block_scan_batched(occ, a, r, p),
                      block_scan(occ[0], a[0], r[0], p[0]),
                      block_scan_pruned(occ[0], *host))
    sync(dev)
    counts = read_counts()
    print(f"[whole] path launches: {counts}", flush=True)

    errs = {"tile": 0, "static": 0}
    for name, (a, r, p) in rules_t.items():
        batched, one, static = outs[name]
        for i in range(0, q, WHOLE_SLICE):
            s = slice(i, i + WHOLE_SLICE)
            want = block_scan_reference(occ[s], a[s], r[s], p[s])
            errs["tile"] = max(errs["tile"], max_word_err(
                [x[s] for x in batched], want))
            if i == 0:
                first = [x[0] for x in want]
                errs["tile"] = max(errs["tile"], max_word_err(one, first))
                errs["static"] = max(errs["static"],
                                     max_word_err(static, first))
            del want
        n_active = (rules[name][0] & rules[name][2][:, :, None]).sum(axis=(1, 2))
        print(f"[whole] {name}: block_scan_batched, block_scan and "
              f"block_scan_pruned bit-equal to block_scan_reference; "
              f"{int(n_active.sum())} active planes over {q} queries; "
              f"{int(batched[2].sum())} matched docs, v {int(batched[1].sum())}",
              flush=True)
    if dev.type != "cuda":
        return counts, {}

    rows = {}
    for name, (a, r, p) in rules_t.items():
        host = tuple(x[0] for x in rules[name])
        n_active = (rules[name][0] & rules[name][2][:, :, None]).sum(axis=(1, 2))

        def plain_all(a=a, r=r, p=p):
            for i in range(0, q, WHOLE_SLICE):
                s = slice(i, i + WHOLE_SLICE)
                block_scan_reference(occ[s], a[s], r[s], p[s])

        def plain_one(a=a, r=r, p=p):
            block_scan_reference(occ[0], a[0], r[0], p[0])

        # The tile kernel reads each query's rule as bools: allowed
        # (T*F), required and present (T) bytes.  The static kernel's
        # rule arrives by value.
        query_rule_bytes = t * f + 2 * t
        cases = {
            "batched": (lambda a=a, r=r, p=p: block_scan_batched(occ, a, r, p),
                        plain_all, n_active, q * query_rule_bytes, 10, 2),
            "one": (lambda a=a, r=r, p=p: block_scan(occ[0], a[0], r[0], p[0]),
                    plain_one, n_active[:1], query_rule_bytes, 50, 10),
            "static": (lambda host=host: block_scan_pruned(occ[0], *host),
                       plain_one, n_active[:1], 0, 50, 10),
        }
        for case, (kern, plain, act, rule_bytes, reps, plain_reps) in cases.items():
            ms = time_cuda(kern, reps, flush)
            plain_ms = time_cuda(plain, plain_reps, flush)
            bound, bound_by, moved = whole_index_bound_ms(act, nb, w,
                                                          rule_bytes)
            kernel = "static" if case == "static" else "tile"
            rows[(case, name)] = dict(max_abs_err=errs[kernel], ms=ms,
                                      plain_ms=plain_ms, bound_ms=bound,
                                      bound_by=bound_by, library_ms=None)
            entry = {"batched": "block_scan_batched", "one": "block_scan",
                     "static": "block_scan_pruned"}[case]
            print(f"[kernel] {entry} (block_scan_{kernel}) "
                  f"{name}: Q={len(act)} nb={nb} W={w}, "
                  f"{int(act.sum())} active planes: bit-equal to plain; kernel "
                  f"{ms:.6f} ms (cold L2), plain {plain_ms:.6f} ms, bound "
                  f"{bound:.6f} ms ({bound_by}); kernel/bound {ms / bound:.2f}x; "
                  f"{rate_text(ms, bound, moved)}"
                  + (f"; {excess_text(ms, floor, bound)}"
                     if case == "static" else ""),
                  flush=True)
        # the static tile against twice it, in turns
        n_planes = len(bsp.static_plane_list(*host)[0])
        tile = bsp.static_tile(nb, n_planes)
        times = {}
        for bb in (tile, 2 * tile, 2 * tile, tile):
            with mock.patch.object(bsp, "static_tile", lambda *a, bb=bb: bb):
                times.setdefault(bb, []).append(time_cuda(
                    lambda host=host: block_scan_pruned(occ[0], *host), 50,
                    flush))
        print(f"[kernel] block_scan_pruned (block_scan_static) {name}, tiles "
              f"(blocks a CTA: ms in two turns; static_tile gives {tile} for "
              f"{n_planes} planes): "
              + "; ".join(f"{bb}: {t[0]:.6f} / {t[1]:.6f}"
                          for bb, t in times.items()), flush=True)
        torch.cuda.empty_cache()
    del occ, outs
    torch.cuda.empty_cache()
    return counts, rows


# ------------------------------------------------------ phase 2, flash
# (name, B, Hq, Hkv, Sq, Skv, D, causal, dtype): the LM path's launch,
# the same at prefill_32k's length, the fp32 route's LM launch (phase
# 4's fp32 prefill), the five shapes of tests/test_kernels.py, fully
# masked rows (causal, Sq > Skv: the first Sq - Skv rows see no key), and
# bf16 at a head dim the tensor-core kernel is not built for (D=96: the
# CUDA-core route's bf16 loads).
LM_PROMPT_32K = 32768
LM_FP32_LAYERS, LM_FP32_PROMPT, LM_FP32_STEPS = 2, 1024, 2
LM_FP32_TOL = 1e-4                  # tests/test_torch_lm.py:32
FLASH_SLICE = 512   # rows per check of path32k, whose (S, S) scores are 137 GB
FLASH_CASES = [
    ("path", LM_BATCH, 32, 8, LM_PROMPT, LM_PROMPT, 128, True, "bfloat16"),
    ("path32k", 1, 32, 8, LM_PROMPT_32K, LM_PROMPT_32K, 128, True,
     "bfloat16"),
    ("path_fp32", LM_BATCH, 32, 8, LM_FP32_PROMPT, LM_FP32_PROMPT, 128, True,
     "float32"),
    ("mha", 1, 4, 4, 128, 128, 64, True, "float32"),
    ("gqa4", 2, 8, 2, 256, 256, 64, True, "float32"),
    ("gqa3_bf16", 1, 6, 2, 128, 128, 128, True, "bfloat16"),
    ("bidir", 1, 2, 2, 128, 384, 64, False, "float32"),
    ("ragged", 1, 4, 1, 100, 200, 64, True, "float32"),
    ("masked", 1, 32, 8, 1024, 512, 128, True, "bfloat16"),
    ("bf16_d96", 1, 8, 2, 256, 256, 96, True, "bfloat16"),
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


def flash_check(name, q, k, v, causal, tol, row_tol):
    """The wrapper's output against ``attention_ref`` within ``tol`` +
    ``tol``|want| element by element and within ``row_tol`` row by row
    (``row_rel_err``; out scaled by PLANTED_SCALE must fail that), finite,
    with rows that see no key exactly 0, through one launch of the
    route's kernel and none of the other; returns the max abs error.
    ``path32k`` is held on its first FLASH_SLICE rows (against the first
    keys alone) and its last ones (against all keys): with the causal
    offset Skv - Sq those slices are exact."""
    import torch

    from repro_torch.kernels.flash_attention import (
        FLASH_ATTENTION_KERNEL, FLASH_ATTENTION_TC_KERNEL, attention_ref,
        flash_attention, tensor_core_route)

    route, other = ((FLASH_ATTENTION_TC_KERNEL, FLASH_ATTENTION_KERNEL)
                    if tensor_core_route(q.dtype, q.shape[-1]) else
                    (FLASH_ATTENTION_KERNEL, FLASH_ATTENTION_TC_KERNEL))
    before, before_other = route.launches, other.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    if route.launches != before + 1 or other.launches != before_other:
        raise AssertionError(f"flash {name}: not one launch of {route.name} "
                             f"alone")
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"flash {name}: output not finite")
    sq, skv = q.shape[2], k.shape[2]
    if name == "path32k":
        n = FLASH_SLICE
        parts = [(got[:, :, :n], (q[:, :, :n], k[:, :, :n], v[:, :, :n])),
                 (got[:, :, -n:], (q[:, :, -n:], k, v))]
    else:
        parts = [(got, (q, k, v))]
    err = row_worst = 0.0
    for out, args in parts:
        want = attention_ref(*(a.contiguous() for a in args),
                             causal=causal).float()
        diff = (out.float() - want).abs()
        err = max(err, float(diff.max()))
        if not bool((diff <= tol + tol * want.abs()).all()):
            raise AssertionError(f"flash {name}: kernel != plain "
                                 f"(max_abs_err={err}, tol {tol})")
        row_err = row_rel_err(out, want)
        row_worst = max(row_worst, row_err)
        if row_err > row_tol:
            raise AssertionError(f"flash {name}: kernel != plain (row "
                                 f"relative error {row_err}, tol {row_tol})")
        if row_rel_err(out.float() * PLANTED_SCALE, want) <= row_tol:
            raise AssertionError(f"flash {name}: the row check passes out "
                                 f"scaled by {PLANTED_SCALE}")
        del want, diff
    masked = max(sq - skv, 0) if causal else 0
    if masked and not bool((got[:, :, :masked] == 0).all()):
        raise AssertionError(f"flash {name}: fully masked rows are not 0")
    return err, row_worst


def flash_phase(dev, flush):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention,
                                                     tensor_core_route)

    rows = {}
    for name, b, hq, hkv, sq, skv, d, causal, dtype in FLASH_CASES:
        dt = getattr(torch, dtype)
        route = ("flash_attention_tc" if tensor_core_route(dt, d)
                 else "flash_attention")
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + sq + skv + d)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
                   for shape in ((b, hq, sq, d), (b, hkv, skv, d),
                                 (b, hkv, skv, d)))
        tol = BF16_TOL if dtype == "bfloat16" else FP32_TOL
        err, row_err = flash_check(name, q, k, v, causal, tol, ROW_TOL[dtype])
        masked = max(sq - skv, 0) if causal else 0

        reps = 3 if name in ("path", "path32k") else 20
        ms = time_cuda(lambda: flash_attention(q, k, v, causal=causal), reps,
                       flush)
        plain_ms = None     # path32k: the plain (S, S) scores would be 137 GB
        if name != "path32k":
            plain_ms = time_cuda(lambda: attention_ref(q, k, v, causal=causal),
                                 reps, flush)
        # SDPA aligns its causal mask top-left: the same function only
        # when Sq == Skv or without a mask.
        library_ms = None
        if sq == skv or not causal:
            library_ms = time_cuda(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True), reps, flush)
        bound, bound_by = flash_bound_ms(b, hq, hkv, sq, skv, d, causal, dtype)
        rows[name] = dict(route=route, max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound, bound_by=bound_by)
        lib = "n/a (other mask)" if library_ms is None else f"{library_ms:.6f} ms"
        plain = ("n/a (the (S, S) scores would take 137 GB; held on the "
                 f"first and last {FLASH_SLICE} rows)" if plain_ms is None
                 else f"{plain_ms:.6f} ms")
        print(f"[kernel] flash_attention {name} (route {route}): B={b} "
              f"Hq={hq} Hkv={hkv} Sq={sq} Skv={skv} D={d} "
              f"{'causal' if causal else 'bidir'} "
              f"{dtype}: max_abs_err={err:.3g} (tol {tol}"
              f"{f', {masked} rows fully masked, all 0' if masked else ''}), "
              f"row relative error {row_err:.3g} (tol {ROW_TOL[dtype]}; out "
              f"x{PLANTED_SCALE} rejected); "
              f"kernel {ms:.6f} ms, plain {plain}, sdpa {lib}, "
              f"bound {bound:.6f} ms ({bound_by}); kernel/bound "
              f"{ms / bound:.2f}x", flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    return rows


# ----------------------------------------------------- phase 2, decode
# (name, B, Hq, Hkv, S, D, dtype, kv_len, cache view): the LM decode
# path's first step (kv_len prompt + 1 over the cache padded by the
# decode steps, read through the transposed (B, S, Hkv, D) cache), the
# four shapes of tests/test_kernels.py, per-row lengths with a row of
# length 0, the path's cache at batch 8 (toward decode_32k's 128),
# where the fixed cost of a launch weighs less against its bytes,
# phase 4's fp32-route decode launch (its first step: kv_len prompt + 1
# over the cache padded by its steps), the fp32 kernel's own path, and
# the bf16 path's cache at the fp32 route's type (134 MB: bytes, not
# the launch, set the time; a measurement row, not a path).
DECODE_CASES = [
    ("path", LM_BATCH, 32, 8, LM_PROMPT + LM_DECODE_STEPS, 128, "bfloat16",
     [LM_PROMPT + 1] * LM_BATCH, True),
    ("mha", 2, 8, 8, 512, 64, "float32", None, False),
    ("gqa4", 2, 8, 2, 1024, 64, "float32", None, False),
    ("gqa6_bf16", 1, 48, 8, 640, 128, "bfloat16", None, False),
    ("wide", 1, 16, 16, 300, 64, "float32", None, False),
    ("ragged", 4, 32, 8, 1000, 128, "bfloat16", [0, 1, 517, 1000], True),
    ("path_b8", 8, 32, 8, LM_PROMPT + LM_DECODE_STEPS, 128, "bfloat16",
     [LM_PROMPT - 192] * 8, True),
    ("path_fp32", LM_BATCH, 32, 8, LM_FP32_PROMPT + LM_FP32_STEPS, 128,
     "float32", [LM_FP32_PROMPT + 1] * LM_BATCH, True),
    ("path_fp32_8k", LM_BATCH, 32, 8, LM_PROMPT + LM_DECODE_STEPS, 128,
     "float32", [LM_PROMPT + 1] * LM_BATCH, True),
]
DECODE_FP32_PLAN_ROWS = ("path_fp32", "path_fp32_8k")


def decode_bound_ms(b, hq, hkv, d, lens, dtype):
    """Least time for one launch: q read, the K and V rows below each
    sequence's kv_len read once, out, m and l written once, over the
    memory rate, against QK^T and PV over those keys (2 FLOPs per
    multiply-add) over the rate for the type."""
    elt, rate = ((2, BF16_FLOPS_PER_S) if dtype == "bfloat16"
                 else (4, FP32_FLOPS_PER_S))
    keys = sum(lens)
    bytes_moved = elt * (2 * b * hq * d + 2 * hkv * keys * d) + 8 * b * hq
    flops = 4 * d * hq * keys
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err_rows(got, want):
    """Largest |got - want| over finite entries, after checking that
    both sides are infinite at the same places (rows with no key)."""
    import torch

    got, want = got.float(), want.float()
    if not torch.equal(torch.isinf(got), torch.isinf(want)):
        raise AssertionError("kernel and plain disagree on empty rows")
    fin = torch.isfinite(want)
    diff = (got[fin] - want[fin]).abs()
    return diff, want[fin]


def row_rel_err(got, want):
    """Largest relative L2 error over the rows (last axis) of ``want``
    that are not all zero."""
    got, want = got.float().flatten(0, -2), want.float().flatten(0, -2)
    norm = want.norm(dim=-1)
    keep = norm > 0
    if not bool(keep.any()):
        return 0.0
    return float(((got - want)[keep].norm(dim=-1) / norm[keep]).max())


def decode_route(use_tc):
    """Force the decode wrapper's route (measurement only): the
    tensor-core kernel, or the CUDA-core one, whatever the shape."""
    from repro_torch.kernels.decode_attention import ops

    return mock.patch.object(ops, "tensor_core_route", lambda *a: use_tc)


def decode_check(name, q, k, v, kv_len, lens, kernel, other):
    """One ``decode_attention`` call through one launch of ``kernel`` and
    none of ``other``, held against ``decode_attention_ref``: out, m and
    l within the type's tolerance + tol|want| (infinities at the same
    places), out row by row within ROW_TOL (out x PLANTED_SCALE must
    fail that), rows with no key 0 and -inf.  Returns (max |d| on out,
    the row relative error)."""
    import torch

    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref)

    dtype = "bfloat16" if q.dtype == torch.bfloat16 else "float32"
    before, before_other = kernel.launches, other.launches
    got = decode_attention(q, k, v, kv_len=kv_len)
    torch.cuda.synchronize()
    if kernel.launches != before + 1 or other.launches != before_other:
        raise AssertionError(f"decode {name}: not one launch of {kernel.name} "
                             f"alone")
    want = decode_attention_ref(q, k, v, kv_len=kv_len)
    tol = BF16_TOL if dtype == "bfloat16" else FP32_TOL
    for what, g, w in zip(("out", "m", "l"), got, want):
        diff, ref = max_err_rows(g, w)
        if not bool((diff <= tol + tol * ref.abs()).all()):
            raise AssertionError(f"decode {name} ({kernel.name}): kernel {what} "
                                 f"!= plain (max |d| {float(diff.max())}, tol "
                                 f"{tol})")
        if what == "out":
            err = float(diff.max())
    row_tol = ROW_TOL[dtype]
    row_err = row_rel_err(got[0], want[0])
    if row_err > row_tol:
        raise AssertionError(f"decode {name} ({kernel.name}): kernel out != "
                             f"plain (row relative error {row_err}, tol "
                             f"{row_tol})")
    if row_rel_err(got[0] * PLANTED_SCALE, want[0]) <= row_tol:
        raise AssertionError(f"decode {name}: the row check passes out scaled "
                             f"by {PLANTED_SCALE}")
    empty = torch.tensor(lens, device=q.device) == 0
    if bool(empty.any()) and not (bool((got[0][empty] == 0).all())
                                  and bool(torch.isinf(got[1][empty]).all())):
        raise AssertionError(f"decode {name}: empty rows are not 0, -inf")
    return err, row_err


def decode_phase(dev, flush, floor):
    """Every DECODE_CASES row through its route's kernel; the rows the
    tensor-core route takes also through the CUDA-core kernel, both held
    and timed, beside the launch floor ``floor``; at ``path`` the
    tensor-core kernel also under two other split plans, at
    DECODE_FP32_PLAN_ROWS the CUDA-core kernel; one fp32 call at
    ``path_fp32`` under torch.profiler (one kernel launch)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import (
        DECODE_ATTENTION_KERNEL, DECODE_ATTENTION_TC_KERNEL, decode_attention,
        decode_attention_ref, merge_partials, split_plan, split_plan_tc,
        tensor_core_route)
    from repro_torch.kernels.decode_attention import ops as dops

    kernels = {True: (DECODE_ATTENTION_TC_KERNEL, DECODE_ATTENTION_KERNEL),
               False: (DECODE_ATTENTION_KERNEL, DECODE_ATTENTION_TC_KERNEL)}
    rows = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name, b, hq, hkv, s, d, dtype, lens, view in DECODE_CASES:
        dt = getattr(torch, dtype)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + s + d + hq)
        q = torch.randn((b, hq, d), generator=gen, device=dev).to(dt)
        kv_shape = (b, s, hkv, d) if view else (b, hkv, s, d)
        k, v = (torch.randn(kv_shape, generator=gen, device=dev).to(dt)
                for _ in range(2))
        if view:
            k, v = k.transpose(1, 2), v.transpose(1, 2)
        kv_len = None if lens is None else torch.tensor(lens, device=dev)
        lens = [s] * b if lens is None else lens
        tc = tensor_core_route(dt, d, hq // hkv)
        reps = 50
        res = {}
        for use_tc in ((True, False) if tc else (False,)):
            kernel, other = kernels[use_tc]
            with decode_route(use_tc):
                err, row_err = decode_check(name, q, k, v, kv_len, lens,
                                            kernel, other)
                ms = time_cuda(lambda: decode_attention(q, k, v, kv_len=kv_len),
                               reps, flush)
            plan = (split_plan_tc if use_tc else split_plan)(b, hkv, s, sms)
            res[kernel.name] = (err, row_err, ms, plan)
        route = "decode_attention_tc" if tc else "decode_attention"
        err, row_err, ms, plan = res[route]
        plain_ms = time_cuda(lambda: decode_attention_ref(q, k, v,
                                                          kv_len=kv_len),
                             10, flush)
        mask = (torch.arange(s, device=dev)[None]
                < torch.tensor(lens, device=dev)[:, None])[:, None, None]
        library_ms = time_cuda(lambda: F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask, enable_gqa=True), reps, flush)
        bound, bound_by = decode_bound_ms(b, hq, hkv, d, lens, dtype)
        rows[name] = dict(route=route, max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound, bound_by=bound_by)
        if tc:
            core_err, _, core_ms, _ = res["decode_attention"]
            rows[name]["cuda_core"] = dict(
                max_abs_err=core_err, ms=core_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound, bound_by=bound_by)
        tol = BF16_TOL if dtype == "bfloat16" else FP32_TOL
        for kname, (e, r, t, (n_split, per)) in res.items():
            print(f"[kernel] decode_attention {name} (kernel {kname}"
                  f"{', the route' if kname == route else ''}): B={b} Hq={hq} "
                  f"Hkv={hkv} S={s} D={d} {dtype} kv_len "
                  f"{lens if len(set(lens)) > 1 else lens[0]}"
                  f"{' (cache view)' if view else ''}, {n_split} slices of "
                  f"{per} keys: max_abs_err={e:.3g} on out (tol {tol}; m and l "
                  f"within it too), row relative error {r:.3g} (tol "
                  f"{ROW_TOL[dtype]}; out x{PLANTED_SCALE} rejected); kernel "
                  f"{t:.6f} ms, plain {plain_ms:.6f} ms, sdpa {library_ms:.6f} "
                  f"ms, bound {bound:.6f} ms ({bound_by}); kernel/bound "
                  f"{t / bound:.2f}x, kernel/sdpa {t / library_ms:.2f}x; "
                  f"{excess_text(t, floor, bound)}", flush=True)
        if name == "path":      # the plan against two others, in turns
            n_tiles = -(-s // dops.TC_BLOCK_K)
            times = {}
            for n in (plan[0], 15, 33, 33, 15, plan[0]):
                per = -(-n_tiles // n) * dops.TC_BLOCK_K
                with mock.patch.object(dops, "split_plan_tc",
                                       lambda *a, per=per: (-(-s // per), per)):
                    times.setdefault(-(-s // per), []).append(time_cuda(
                        lambda: decode_attention(q, k, v, kv_len=kv_len),
                        reps, flush))
            print(f"[kernel] decode_attention_tc path, split plans (slices: ms "
                  f"in two turns; split_plan_tc gives {plan[0]}): "
                  + "; ".join(f"{n}: {t[0]:.6f} / {t[1]:.6f}"
                              for n, t in times.items()), flush=True)
            # the same keys laid out (B, Hkv, S, D): each CTA's rows
            # contiguous, against the cache view's 2 KB row stride
            kc, vc = k.contiguous(), v.contiguous()
            t_view = time_cuda(lambda: decode_attention(q, k, v, kv_len=kv_len),
                               reps, flush)
            t_cont = time_cuda(lambda: decode_attention(q, kc, vc,
                                                        kv_len=kv_len),
                               reps, flush)
            print(f"[kernel] decode_attention_tc path, K/V layout: cache view "
                  f"(B, S, Hkv, D) {t_view:.6f} ms, contiguous (B, Hkv, S, D) "
                  f"{t_cont:.6f} ms", flush=True)
            del kc, vc
        if name in DECODE_FP32_PLAN_ROWS:   # the plan against two others
            n_rounds = -(-s // dops.BLOCK_K)
            times = {}
            for n in (plan[0], max(plan[0] // 2, 1), 2 * plan[0],
                      2 * plan[0], max(plan[0] // 2, 1), plan[0]):
                per = -(-n_rounds // n) * dops.BLOCK_K
                with mock.patch.object(dops, "split_plan",
                                       lambda *a, per=per: (-(-s // per), per)):
                    times.setdefault(-(-s // per), []).append(time_cuda(
                        lambda: decode_attention(q, k, v, kv_len=kv_len),
                        reps, flush))
            print(f"[kernel] decode_attention {name}, split plans (slices: ms "
                  f"in two turns; split_plan gives {plan[0]}): "
                  + "; ".join(f"{n}: {t[0]:.6f} / {t[1]:.6f}"
                              for n, t in times.items()), flush=True)
        if name == "path_fp32":
            before = DECODE_ATTENTION_KERNEL.launches
            profile_device(
                "decode_attention path_fp32 call",
                lambda: decode_attention(q, k, v, kv_len=kv_len),
                "decode_attention_kernel")
            print(f"[profile] decode_attention path_fp32: "
                  f"{DECODE_ATTENTION_KERNEL.launches - before} wrapper launch "
                  f"for one call (device events above)", flush=True)
        del q, k, v
        torch.cuda.empty_cache()

    # tests/test_kernels.py:107: four shards' partials, LSE-merged, on both
    # kernels (fp32 here: the CUDA-core kernel; bf16: the tensor-core one)
    b, h, s, d, shards = 2, 4, 512, 64, 4
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    q, k, v = (torch.randn(shape, generator=gen, device=dev)
               for shape in ((b, h, d), (b, h, s, d), (b, h, s, d)))
    cut = [slice(i * s // shards, (i + 1) * s // shards) for i in range(shards)]
    for dt, tol in ((torch.float32, MERGE_TOL), (torch.bfloat16, BF16_TOL)):
        qq, kk, vv = q.to(dt), k.to(dt), v.to(dt)
        parts = [decode_attention(qq, kk[:, :, c], vv[:, :, c],
                                  return_partial=True) for c in cut]
        merged = merge_partials(*(list(x) for x in zip(*parts))).float()
        full = decode_attention_ref(qq, kk, vv)[0].float()
        err = float((merged - full).abs().max())
        if not bool(((merged - full).abs() <= tol + tol * full.abs()).all()):
            raise AssertionError(f"decode partials merge != full ({err}, {dt})")
        rows[f"merge_{str(dt)[6:]}"] = dict(max_abs_err=err)
        print(f"[kernel] decode_attention partials of {shards} shards (B={b} "
              f"H={h} S={s} D={d} {str(dt)[6:]}), LSE-merged, against the full "
              f"plain attention: max_abs_err={err:.3g} (tol {tol})", flush=True)
    return rows


# ------------------------------------------------ phase 2, embedding bag
# (name, V, E, B, L, mode, dtype, weighted, per-field ids): the Wide&Deep
# path's wide term at serve_p99 and serve_bulk (one id per field, at the
# field's offset, no padding), and the cases of tests/test_kernels.py
# (random ids with -1 padding).
WD_FIELDS, WD_VOCAB = 40, 1_000_000
BAG_CASES = [
    ("wd_p99", WD_FIELDS * WD_VOCAB, 1, 512, WD_FIELDS, "sum", "float32",
     False, True),
    ("wd_bulk", WD_FIELDS * WD_VOCAB, 1, 262_144, WD_FIELDS, "sum",
     "float32", False, True),
    ("t_sum", 64, 8, 4, 6, "sum", "float32", False, False),
    ("t_mean", 128, 16, 8, 3, "mean", "float32", False, False),
    ("t_wide", 1000, 32, 16, 10, "sum", "float32", False, False),
    ("t_bf16_mean", 64, 128, 4, 4, "mean", "bfloat16", False, False),
    ("t_weighted", 32, 8, 4, 5, "sum", "float32", True, False),
]


def bag_bound_ms(table, idx, weighted):
    """Least time for one launch: every 32-byte sector of the table that
    an index inside the table touches, read once (a random row read moves at least
    one sector; rows that share a sector share its read), the indices
    and weights read once and the output written once, over the memory
    rate; against one multiply-add per (index, column) over the fp32
    rate."""
    import torch

    v, e = table.shape
    row_bytes = e * table.element_size()
    rows = torch.unique(idx[(idx >= 0) & (idx < v)].long())
    first = rows * row_bytes // 32
    last = ((rows + 1) * row_bytes - 1) // 32
    span = int((last - first).max()) + 1 if rows.numel() else 0
    sectors = (first[:, None] + torch.arange(span, device=idx.device)[None])
    sectors = torch.unique(sectors[sectors <= last[:, None]])
    b, l = idx.shape
    bytes_moved = (32 * sectors.numel() + 4 * b * l * (2 if weighted else 1)
                   + b * row_bytes)
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * b * l * e / FP32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"),
            sectors.numel())


def bag_route_forced(route):
    """Force the bag wrapper's route (measurement only)."""
    from repro_torch.kernels.embedding_bag import ops

    return mock.patch.object(ops, "bag_route", lambda *a: route)


def bag_check(name, table, idx, w, mode, kernel, other):
    """One ``embedding_bag`` call through one launch of ``kernel`` and
    none of ``other``, against ``embedding_bag_ref``: NaN rows (bags with
    an id past the table) at the same places and whole, the rest within
    the type's tolerance + tol|want|.  Returns the max abs error."""
    import torch

    from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_ref

    before, before_other = kernel.launches, other.launches
    got = embedding_bag(table, idx, w, mode=mode).float()
    torch.cuda.synchronize()
    if kernel.launches != before + 1 or other.launches != before_other:
        raise AssertionError(f"embedding_bag {name}: not one launch of "
                             f"{kernel.name} alone")
    want = embedding_bag_ref(table, idx, w, mode=mode).float()
    nan = torch.isnan(want)
    if not (torch.equal(torch.isnan(got), nan)
            and torch.equal(nan.any(1), nan.all(1))):
        raise AssertionError(f"embedding_bag {name} ({kernel.name}): NaN rows "
                             f"differ from the plain version's")
    tol = BAG_BF16_TOL if table.dtype == torch.bfloat16 else BAG_FP32_TOL
    diff = (got[~nan] - want[~nan]).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if not bool((diff <= tol + tol * want[~nan].abs()).all()):
        raise AssertionError(f"embedding_bag {name} ({kernel.name}): kernel != "
                             f"plain (max_abs_err={err}, tol {tol})")
    return err


def bag_phase(dev, flush):
    """Every BAG_CASES row through its route's kernel, and the rule's E = 1
    edge on this card (``wd_edge``: as many bags as the lane route takes
    at most) with half and twice as many bags; the Wide&Deep rows through
    both E = 1 routes, each held and timed, the column route's output
    also bit for bit against the warp route's loop (``eb_bag_column``,
    over column 0 of a two-column table that holds the table there).
    At ``wd_bulk`` a plain gather of the same ids, in bag order and in
    field order, gives the card's rate for these random sectors.  The
    other cases plant ids past the table (a NaN row each)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import (
        EMBEDDING_BAG_KERNEL, EMBEDDING_BAG_LANES_KERNEL, bag_route,
        embedding_bag, embedding_bag_ref)
    from repro_torch.kernels.embedding_bag.ops import LANE_BAGS_PER_SM

    kernels = {"lanes": (EMBEDDING_BAG_LANES_KERNEL, EMBEDDING_BAG_KERNEL),
               "column": (EMBEDDING_BAG_KERNEL, EMBEDDING_BAG_LANES_KERNEL),
               "warp": (EMBEDDING_BAG_KERNEL, EMBEDDING_BAG_LANES_KERNEL)}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    edges = [(f"wd_edge{suffix}", WD_FIELDS * WD_VOCAB, 1,
              int(LANE_BAGS_PER_SM * f * sms), WD_FIELDS, "sum", "float32",
              False, True)
             for suffix, f in (("_half", 0.5), ("", 1), ("_2x", 2))]
    rows = {}
    for name, v, e, b, l, mode, dtype, weighted, per_field in BAG_CASES + edges:
        dt = getattr(torch, dtype)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + v + e + b)
        table = torch.randn((v, e), generator=gen, device=dev).to(dt)
        if per_field:
            idx = (torch.randint(0, WD_VOCAB, (b, l), generator=gen, device=dev,
                                 dtype=torch.int32)
                   + torch.arange(l, device=dev, dtype=torch.int32) * WD_VOCAB)
        else:
            idx = torch.randint(-1, v, (b, l), generator=gen, device=dev,
                                dtype=torch.int32)
            idx[1, 0], idx[2, l - 1] = v, 2**31 - 1     # NaN rows 1 and 2
        w = (torch.randn((b, l), generator=gen, device=dev) if weighted
             else None)
        route = bag_route(b, e, sms)
        routes = [route] + ([{"lanes": "column", "column": "lanes"}[route]]
                            if per_field else [])
        res = {}
        for r in routes:
            kernel, other = kernels[r]
            with bag_route_forced(r):
                err = bag_check(name, table, idx, w, mode, kernel, other)
                ms = time_cuda(lambda: embedding_bag(table, idx, w, mode=mode),
                               50, flush)
            res[r] = (kernel.name, err, ms)
            if r == "column":
                with bag_route_forced(r):
                    col = embedding_bag(table, idx, w, mode=mode)
                wide = torch.zeros((v, 2), device=dev, dtype=dt)
                wide[:, 0] = table[:, 0]
                warp = embedding_bag(wide, idx, w,
                                     mode=mode)[:, :1].contiguous()
                if not torch.equal(col.view(torch.int16), warp.view(torch.int16)):
                    raise AssertionError(f"embedding_bag {name}: the column "
                                         f"route != eb_bag_column bit for bit")
                del col, wide, warp
        plain_ms = time_cuda(lambda: embedding_bag_ref(table, idx, w,
                                                       mode=mode), 10, flush)
        library_ms = None
        if per_field:     # no padding: F.embedding_bag computes the same
            ones = torch.ones((b, l), device=dev)
            library_ms = time_cuda(lambda: F.embedding_bag(
                idx, table, mode="sum", per_sample_weights=ones), 50, flush)
        bound, bound_by, sectors = bag_bound_ms(table, idx, weighted)
        kname, err, ms = res[route]
        rows[name] = dict(kernel=kname, max_abs_err=err, ms=ms,
                          plain_ms=plain_ms, library_ms=library_ms,
                          bound_ms=bound, bound_by=bound_by,
                          routes={r: t for r, (_, _, t) in res.items()})
        lib = ("n/a (padding, ids past the table)" if library_ms is None
               else f"{library_ms:.6f} ms")
        for r, (kn, e_r, t) in res.items():
            print(f"[kernel] embedding_bag {name} (route {r}, kernel {kn}"
                  f"{', the rule' if r == route else ''}): V={v} E={e} B={b} "
                  f"L={l} {mode} {dtype}{' weighted' if weighted else ''}: "
                  f"max_abs_err={e_r:.3g} (tol "
                  f"{BAG_BF16_TOL if dtype == 'bfloat16' else BAG_FP32_TOL}"
                  f"{'' if per_field else '; NaN rows 1, 2 as the plain'}"
                  f"{'; bit-equal to eb_bag_column' if r == 'column' else ''}); "
                  f"kernel {t:.6f} ms, plain {plain_ms:.6f} ms, "
                  f"F.embedding_bag {lib}, bound {bound:.6f} ms ({bound_by}; "
                  f"{sectors} distinct 32-byte sectors for {b * l} lookups); "
                  f"kernel/bound {t / bound:.2f}x", flush=True)
        if name == "wd_bulk":
            flat = table.view(-1)
            for order, ids in (("bag", idx.view(-1)),
                               ("field", idx.t().contiguous().view(-1))):
                g_ms = time_cuda(lambda: flat.index_select(0, ids), 50, flush)
                rows[name][f"gather_{order}_ms"] = g_ms
                print(f"[kernel] embedding_bag {name}: plain gather of the same "
                      f"{b * l} ids in {order} order (index_select, writes "
                      f"{4 * b * l} bytes more): {g_ms:.6f} ms, "
                      f"{32 * sectors / g_ms / 1e9:.3f} TB/s of distinct "
                      f"sectors; the rule's route {ms / g_ms:.2f}x its time",
                      flush=True)
        del table, idx, w
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
    returns the kernels' launch counts of the serve step and the system."""
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

    from repro_torch.kernels.block_scan import BLOCK_SCAN_KERNEL as counter

    # Each (bucket, policy structure) serve step is prepared (run once on
    # a zero-occupancy batch) at its first use; do that before the reset.
    exe.warmup([batch], [sys_.plan_policy(CAT1), sys_.plan_policy(CAT2),
                         greedy])
    reset_counts()
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
    launches = read_counts()
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
    ref_exe.warmup([batch], [sys_.plan_policy(cat0), greedy])
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
    real_data_check(sys_, inputs[0])
    blocks = mean_blocks_per_rule(sys_, cat0, inputs[0])
    print(f"[serve] production plan (cat {cat0}): {blocks:.2f} blocks per "
          f"rule execution (mean over steps that scanned)", flush=True)
    unscaled_batch(sys_, cat0, inputs[0], greedy, counter)
    if dev.type == "cuda":
        for name, policy in (("plan", sys_.plan_policy(cat0)),
                             ("greedy_q", greedy)):
            profile_batch(exe, name, policy, inputs[0])
    return launches, sys_


def real_data_check(sys_, inp):
    """The whole-index scans on the served batch's real occupancy, for
    each rule of the ruleset, against the chunk kernel with block
    pointer 0 and chunk = n_blocks and against the plain version:
    ``block_scan_batched`` over the batch, ``block_scan_pruned`` on the
    query with the most present terms."""
    import torch

    from repro_torch.kernels.block_scan import (block_scan_batched,
                                                block_scan_pruned,
                                                block_scan_pruned_chunk,
                                                block_scan_reference,
                                                build_rule_meta)

    occ, _, tp = inp
    b, nb, t, f, w = occ.shape
    q0 = int(tp.sum(dim=1).argmax())
    zeros = torch.zeros(b, dtype=torch.int32, device=occ.device)
    rs = sys_.ruleset
    for k in range(rs.k):
        allowed = rs.allowed[k].expand(b, t, f).contiguous()
        required = rs.required[k].expand(b, t).contiguous()
        want = block_scan_reference(occ, allowed, required, tp)
        meta = build_rule_meta(allowed, required, tp, zeros)
        chunk = block_scan_pruned_chunk(occ.reshape(b, nb, t * f, w), meta,
                                        chunk=nb, n_terms=t)
        max_word_err(block_scan_batched(occ, allowed, required, tp), want)
        max_word_err(chunk, want)
        max_word_err(block_scan_pruned(occ[q0], rs.allowed[k].cpu().numpy(),
                                       rs.required[k].cpu().numpy(),
                                       tp[q0].cpu().numpy()),
                     [x[q0] for x in want])
        print(f"[serve] real occupancy, rule {k}: block_scan_batched, "
              f"block_scan_pruned (query {q0}) and block_scan_pruned_chunk "
              f"(block 0, chunk {nb}) bit-equal to block_scan_reference "
              f"over {b} queries x {nb} blocks; {int(want[2].sum())} matched docs",
              flush=True)


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
    exe.warmup([inp[0].shape[0]], [plain.plan_policy(cat), greedy])
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


# ------------------------------------------------------------ phase 3b
# The rl_rollout step (src/repro/configs/websearch_rl.py:48-52): query
# batch 256, ε 0.1 (src/repro/launch/steps.py:538-540).
TRAIN_EPS = 0.1
EPS_START, EPS_END = 0.5, 0.05          # train_policy's defaults
TRAIN_SECONDS = 60.0                    # train_policy, both categories
TRAIN_ITERS = (4, 64)                   # least and most iterations a category
SPLIT_STEPS = 3                         # timed steps, split by stage
# One L1 Adam step, card against CPU: the CPU tests' one-step tolerance
# (tests/test_torch_train.py::test_l1_adam_step_matches_reference).
L1_STEP_RTOL, L1_STEP_ATOL = 1e-5, 1e-6
# td_update against a float64 scatter-mean: float32 target, TD error,
# mean and step each round once (a few ulps of values below 1); the
# sums themselves are float64 on both sides.
TD_TOL = 1e-6


def l1_step_check(dev, params0, feats, gains, weights):
    """One ``_l1_adam_step`` from ``params0`` on one batch of 4096 judged
    rows, on the card and on the CPU; returns the largest parameter
    difference."""
    import numpy as np
    import torch

    from repro_torch.ranking.l1_ranker import _l1_adam_step
    from repro_torch.train.optimizer import adamw_init

    idx = np.random.default_rng(SEED).integers(0, len(feats),
                                               size=min(4096, len(feats)))
    batch = [torch.from_numpy(x[idx]).to(torch.float32)
             for x in (feats, gains / 4.0, weights)]
    out = {}
    for d in (dev, torch.device("cpu")):
        p = {k: v.detach().to(d) for k, v in params0.items()}
        out[d.type] = _l1_adam_step(p, adamw_init(p), *[x.to(d) for x in batch])
    (pc, _, lc), (ph, _, lh) = out[dev.type], out["cpu"]
    if not np.isclose(float(lc), float(lh), rtol=L1_STEP_RTOL, atol=0):
        raise AssertionError(f"L1 step loss {float(lc)} != CPU {float(lh)}")
    worst = 0.0
    for k in ph:
        got, want = pc[k].cpu().numpy(), ph[k].numpy()
        if not np.allclose(got, want, rtol=L1_STEP_RTOL, atol=L1_STEP_ATOL):
            raise AssertionError(f"L1 step {k}: card != CPU beyond "
                                 f"rtol {L1_STEP_RTOL} atol {L1_STEP_ATOL}")
        worst = max(worst, float(np.abs(got - want).max()))
    return len(idx), worst


def td_float64(qcfg, q, trans):
    """The TD scatter-mean in float64 numpy, from the same transitions."""
    import numpy as np

    t = {k: v.cpu().numpy().reshape(-1) for k, v in trans.items()}
    q64 = q.cpu().numpy().astype(np.float64)
    target = t["r"].astype(np.float64) + qcfg.gamma * np.where(
        t["done"], 0.0, q64[t["s2"]].max(axis=-1))
    td = np.where(t["valid"], target - q64[t["s"], t["a"]], 0.0)
    flat = t["s"].astype(np.int64) * qcfg.n_actions + t["a"]
    sums = np.zeros(q64.size)
    counts = np.zeros(q64.size)
    np.add.at(sums, flat, td)
    np.add.at(counts, flat, t["valid"].astype(np.float64))
    mean = (sums / np.maximum(counts, 1.0)).reshape(q64.shape)
    return q64 + qcfg.alpha * mean, int((counts > 0).sum())


def train_step_check(dev, sys_, batch):
    """One ``train_batch`` at ``batch`` queries from a seeded generator on
    the device: twice on ``block_scan`` (Q bit-equal), once on
    ``reference`` (transitions, final state and Q bit-equal), and its
    TD update against a float64 scatter-mean.  Returns the chunk-kernel
    launches of one step and the step's stage times (s)."""
    import numpy as np
    import torch

    from repro_torch.core.qlearning import _epsilon_rollout, td_update, train_batch
    from repro_torch.data.querylog import CAT1
    from repro_torch.kernels.block_scan import BLOCK_SCAN_KERNEL as counter
    from repro_torch.policies import EpsilonGreedy, TabularQPolicy

    qcfg = sys_.qcfg
    qids = sys_.sample_train_qids(CAT1, batch, np.random.default_rng(SEED))
    # A seeded table whose stop column never wins (as the serve phase's):
    # greedy actions vary over bins, so the episode visits many cells.
    q_np = np.random.default_rng(SEED + 11).normal(
        scale=0.05, size=(qcfg.p, qcfg.n_actions)).astype(np.float32)
    q_np[:, sys_.env_cfg.a_stop] = q_np.min() - 1.0
    q = torch.from_numpy(q_np).to(dev)
    times = {}
    t0 = time.perf_counter()
    occ, scores, tp = sys_.batch_inputs(qids)
    sync(dev)
    times["batch_inputs"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, traj = sys_._run_plan_batch(sys_.plan_for_category(CAT1), occ, scores, tp)
    prod_r = sys_.production_step_rewards(traj)
    sync(dev)
    times["production_rollout"] = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pol = EpsilonGreedy.draw(gen, qcfg.t_max, len(qids), qcfg.n_actions,
                             TRAIN_EPS, TabularQPolicy(q))
    draws = (pol.explore, pol.uniform)
    args = (sys_.env_cfg, qcfg, sys_.ruleset, sys_.bins, q, occ, scores, tp,
            prod_r, TRAIN_EPS, draws)

    before = counter.launches
    t0 = time.perf_counter()
    q_a, m_a = train_batch(*args, backend="block_scan")
    sync(dev)
    times["train_batch"] = time.perf_counter() - t0
    step_launches = counter.launches - before
    q_b, _ = train_batch(*args, backend="block_scan")
    if not torch.equal(q_a, q_b):
        raise AssertionError("train_batch twice on block_scan: Q differs")
    fin_k, tr_k = _epsilon_rollout(*args, backend="block_scan")
    fin_r, tr_r = _epsilon_rollout(*args, backend="reference")
    for k in tr_k:
        if not torch.equal(tr_k[k], tr_r[k]):
            raise AssertionError(f"block_scan != reference on transitions/{k}")
    for f in dataclasses.fields(fin_k):
        if not torch.equal(getattr(fin_k, f.name), getattr(fin_r, f.name)):
            raise AssertionError(f"block_scan != reference on state/{f.name}")
    q_r = td_update(qcfg, q, tr_r)
    if not (torch.equal(q_r, q_a) and torch.equal(td_update(qcfg, q, tr_k), q_a)):
        raise AssertionError("TD update of the reference backend's "
                             "transitions != train_batch's Q")
    want, cells = td_float64(qcfg, q, tr_k)
    err = np.abs(q_a.cpu().numpy().astype(np.float64) - want)
    if not (err <= TD_TOL * (1.0 + np.abs(want))).all():
        raise AssertionError(f"td_update vs float64: max |dq| {err.max():.3e}")
    if not (torch.isfinite(q_a).all() and (q_a != q).any()):
        raise AssertionError("the TD update left Q unchanged or not finite")
    n_valid = int(tr_k["valid"].sum())
    explored = int((pol.uniform < TRAIN_EPS).sum())
    print(f"[train] train_batch at {len(qids)} queries, eps {TRAIN_EPS}: "
          f"{n_valid} valid transitions into {cells} cells, {explored} "
          f"explored draws, {len(torch.unique(tr_k['a']))} distinct actions; "
          f"Q bit-equal twice on 'block_scan' and to 'reference' "
          f"(transitions, final state, Q); td_update vs float64 "
          f"scatter-mean max |dq| {err.max():.3e} (tol {TD_TOL} x (1+|q|)); "
          f"{step_launches} block_scan_pruned_chunk launches a step; "
          f"mean_u {float(m_a['mean_u']):.1f}, mean_reward "
          f"{float(m_a['mean_reward']):.6f}", flush=True)
    print(f"[train] one step's stages: batch_inputs "
          f"{times['batch_inputs'] * 1e3:.1f} ms, production rollout "
          f"{times['production_rollout'] * 1e3:.1f} ms, train_batch "
          f"(ε-greedy rollout + TD) {times['train_batch'] * 1e3:.1f} ms",
          flush=True)
    return step_launches, times


def split_steps(dev, sys_, cat, q, batch, n=SPLIT_STEPS):
    """``n`` training steps run stage by stage, each stage ending in a
    synchronize: mean seconds of batch_inputs, the production rollout,
    the ε-greedy rollout and the TD update."""
    import numpy as np
    import torch

    from repro_torch.core.qlearning import _epsilon_rollout, td_update

    rng = np.random.default_rng(SEED + 3)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    names = ("batch_inputs", "production_rollout", "epsilon_rollout",
             "td_update")
    sums = dict.fromkeys(names, 0.0)
    for _ in range(n):
        qids = sys_.sample_train_qids(cat, batch, rng)
        marks = [time.perf_counter()]
        occ, scores, tp = sys_.batch_inputs(qids)
        sync(dev)
        marks.append(time.perf_counter())
        _, traj = sys_._run_plan_batch(sys_.plan_for_category(cat), occ,
                                       scores, tp)
        prod_r = sys_.production_step_rewards(traj)
        sync(dev)
        marks.append(time.perf_counter())
        _, trans = _epsilon_rollout(sys_.env_cfg, sys_.qcfg, sys_.ruleset,
                                    sys_.bins, q, occ, scores, tp, prod_r,
                                    EPS_END, gen, backend=sys_.cfg.backend)
        sync(dev)
        marks.append(time.perf_counter())
        q = td_update(sys_.qcfg, q, trans)
        sync(dev)
        marks.append(time.perf_counter())
        for name, a, b in zip(names, marks, marks[1:]):
            sums[name] += b - a
    return {k: v / n for k, v in sums.items()}


def train_phase(dev, sys_, batch=QUERY_BATCH, train_seconds=TRAIN_SECONDS):
    """Train the match-planning policy on the serve phase's system: the
    L1 fit, one checked ``train_batch``, ``train_policy`` per category
    between a reset and a read of the launch counts, ``evaluate`` of
    each trained Q against its production plan, one profiled step.
    Returns the kernels' launch counts of ``train_policy`` and the
    trained Q table of each category."""
    import numpy as np
    import torch

    from repro_torch.data.querylog import CAT1, CAT2
    from repro_torch.ranking.metrics import relative_delta

    if sys_.qcfg is None:
        raise AssertionError("the serve phase fitted no state bins")
    # 1. The L1 fit (256 judged queries, l1_steps Adam steps of 4096).
    params0 = {k: v.clone() for k, v in sys_.l1_params.items()}
    t0 = time.perf_counter()
    losses = sys_.fit_l1()
    sync(dev)
    fit_s = time.perf_counter() - t0
    feats, gains, weights = sys_.l1_training_set()
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"L1 fit: loss {losses[0]} -> {losses[-1]}")
    rows, worst = l1_step_check(dev, params0, feats, gains, weights)
    print(f"[train] L1 fit: {len(feats)} judged pairs, {len(losses)} Adam "
          f"steps, loss {losses[0]:.6f} -> {losses[-1]:.6f}, {fit_s:.2f} s "
          f"(training set and steps); one step on {rows} rows, card vs CPU "
          f"(TF32 off): max |dparam| {worst:.3e} (rtol {L1_STEP_RTOL}, "
          f"atol {L1_STEP_ATOL})", flush=True)

    # 2. One train_batch, checked.
    step_launches, stage = train_step_check(dev, sys_, batch)
    if dev.type == "cuda" and step_launches <= 0:
        raise AssertionError("a train step launched no block_scan kernel")
    step_s = sum(stage.values())
    iters = int(min(TRAIN_ITERS[1], max(TRAIN_ITERS[0],
                                        train_seconds / 2 / step_s)))

    # 3. train_policy per category: the main path, counts reset before.
    reset_counts()
    trained, walls = {}, {}
    for cat in (CAT1, CAT2):
        t0 = time.perf_counter()
        q, hist = sys_.train_policy(cat, iters=iters, batch=batch,
                                    eps_start=EPS_START, eps_end=EPS_END,
                                    seed=SEED)
        sync(dev)
        walls[cat] = time.perf_counter() - t0
        if not (torch.isfinite(q).all() and all(
                np.isfinite(list(h.values())).all() for h in hist)):
            raise AssertionError(f"cat {cat}: Q or history not finite")
        trained[cat] = q
        h0, h1 = hist[0], hist[-1]
        print(f"[train] cat {cat} train_policy: {iters} iterations of "
              f"{batch} queries, eps {EPS_START} -> {EPS_END}, "
              f"{walls[cat] * 1e3 / iters:.1f} ms/step; mean_u "
              f"{h0['mean_u']:.1f} -> {h1['mean_u']:.1f}, mean_reward "
              f"{h0['mean_reward']:.6f} -> {h1['mean_reward']:.6f}, "
              f"q_abs_mean {h1['q_abs_mean']:.6f}", flush=True)
    launches = read_counts()
    n_steps = 2 * iters
    print(f"[train] main path launches ({n_steps} steps): {launches}; "
          f"{launches['block_scan_pruned_chunk'] / n_steps:.1f} "
          f"block_scan_pruned_chunk launches a step", flush=True)

    split = split_steps(dev, sys_, CAT1, trained[CAT1], batch)
    print("[train] step split (mean of %d, each stage synchronized): %s; "
          "total %.1f ms" % (SPLIT_STEPS, ", ".join(
              f"{k} {v * 1e3:.1f} ms" for k, v in split.items()),
              sum(split.values()) * 1e3), flush=True)

    # 4. Learned policy vs production plan, per category.
    for cat in (CAT1, CAT2):
        qids = np.where(sys_.log.category == cat)[0][:batch]
        res = sys_.evaluate(trained[cat], qids, cat)
        for k in ("policy_ncg", "baseline_ncg"):
            if not (np.isfinite(res[k]).all() and (res[k] >= 0).all()
                    and (res[k] <= 1 + 1e-6).all()):
                raise AssertionError(f"cat {cat}: {k} out of [0, 1]")
        if (res["baseline_u"].shape != (len(qids),)
                or not (res["baseline_u"] > 0).all()):
            raise AssertionError(f"cat {cat}: the production plan scanned nothing")
        d_u = relative_delta(res["policy_u"], res["baseline_u"])
        d_ncg = relative_delta(res["policy_ncg"], res["baseline_ncg"])
        print(f"[train] cat {cat} evaluate on {len(qids)} queries: "
              f"du {d_u:+.2f}% (u {res['policy_u'].mean():.1f} vs plan "
              f"{res['baseline_u'].mean():.1f}), dNCG {d_ncg:+.2f}% (NCG "
              f"{res['policy_ncg'].mean():.4f} vs plan "
              f"{res['baseline_ncg'].mean():.4f})", flush=True)

    # 5. One training step under the profiler.
    if dev.type == "cuda":
        gen = torch.Generator(device=dev).manual_seed(SEED + 5)
        qids = sys_.sample_train_qids(CAT2, batch, np.random.default_rng(SEED + 5))
        profile_device("train step", lambda: sys_.policy_train_step(
            CAT2, trained[CAT2], gen, EPS_END, qids), "block_scan_pruned_chunk")
    return launches, trained


# ------------------------------------------------------------ phase 3c
# The online engine on the serve phase's system, serving phase 3b's
# policies: arrivals are drawn under the query log's own popularity
# (Zipf over distinct queries, CAT2 at the head).
ENGINE_ARRIVALS = 2048                 # the main stream
ENGINE_TICKETS = 64                    # of it served one ticket at a time
ENGINE_SLAB = 256                      # serve_many slabs for the rest
ENGINE_SHALLOW = 256                   # then arrivals at SHALLOW
ENGINE_SWAP = 256                      # then after a publish of v2, in 2 slabs
ENGINE_CFG = dict(min_bucket=8, max_bucket=256, cache_capacity=4096)


def drive_engine(dev, sys_, trained, backend, stream):
    """One engine on ``backend``: publish the trained Qs (fallbacks: the
    system's shallow plans), warm up, serve the stream in its four parts;
    returns (engine, responses per part, warmup seconds, stream seconds,
    compile count after warmup)."""
    from repro_torch.policies import PolicyStore, TabularQPolicy
    from repro_torch.serving import EngineConfig, ServeEngine, ServiceLevel

    policies = {cat: TabularQPolicy(q) for cat, q in trained.items()}
    store = PolicyStore(staleness_bound=1)
    store.publish(dict(policies), fallbacks=sys_.fallback_policies())
    engine = ServeEngine(sys_, store, EngineConfig(backend=backend,
                                                   **ENGINE_CFG))
    t0 = time.perf_counter()
    n_warm = engine.warmup()
    sync(dev)
    t_warm = time.perf_counter() - t0
    if backend == "block_scan":
        reset_counts()            # the main path: the stream, after warmup
    a, b = ENGINE_TICKETS, ENGINE_ARRIVALS
    c = b + ENGINE_SHALLOW
    t0 = time.perf_counter()
    parts = {"tickets": [r for q in stream[:a] for r in engine.serve([q])],
             "slabs": [r for i in range(a, b, ENGINE_SLAB)
                       for r in engine.serve_many(stream[i:min(i + ENGINE_SLAB, b)])],
             "shallow": engine.serve_many(stream[b:c], ServiceLevel.SHALLOW)}
    store.publish(dict(policies), fallbacks=sys_.fallback_policies())
    half = c + ENGINE_SWAP // 2
    parts["swap"] = (engine.serve_many(stream[c:half])
                     + engine.serve_many(stream[half:c + ENGINE_SWAP]))
    t_stream = time.perf_counter() - t0
    return engine, parts, t_warm, t_stream, n_warm


def engine_phase(dev, sys_, trained):
    """Phase 3c: serve phase 3b's policies through ``ServeEngine`` on the
    chunk kernel, check what came out, hold every response bit for bit
    against an engine on the ``reference`` backend; returns the kernels'
    launch counts of the stream."""
    import numpy as np

    from repro_torch.data.querylog import CAT2
    from repro_torch.serving.cache import canonical_query_key

    log = sys_.log
    n = ENGINE_ARRIVALS + ENGINE_SHALLOW + ENGINE_SWAP
    stream = np.random.default_rng(SEED + 11).choice(
        log.n_queries, size=n, p=log.popularity)
    cat2 = float((log.category[stream] == CAT2).mean())
    print(f"[engine] stream: {n} arrivals over {log.n_queries} queries "
          f"(the log's popularity, {len(np.unique(stream))} distinct, CAT2 "
          f"share {cat2:.4f}): "
          f"{ENGINE_TICKETS} one ticket at a time, "
          f"{ENGINE_ARRIVALS - ENGINE_TICKETS} in slabs of {ENGINE_SLAB}, "
          f"{ENGINE_SHALLOW} at SHALLOW, {ENGINE_SWAP} after a publish of "
          f"v2; {ENGINE_CFG}", flush=True)
    engine, parts, t_warm, t_stream, n_warm = drive_engine(
        dev, sys_, trained, "block_scan", stream)
    launches = read_counts()
    summ = engine.summary()
    print(f"[engine] 'block_scan': warmup prepared {n_warm} serve steps "
          f"(buckets {engine.bucket_cfg.buckets()} x FULL and SHALLOW "
          f"structures) in {t_warm:.2f} s", flush=True)

    # Checks.
    if engine.compile_count != n_warm:
        raise AssertionError(f"compile count {n_warm} -> {engine.compile_count} "
                             f"after warmup")
    if dev.type == "cuda" and launches["block_scan_pruned_chunk"] <= 0:
        raise AssertionError("the engine launched no block_scan kernel")
    n_docs = sys_.index.n_docs
    responses = [r for part in parts.values() for r in part]
    for r in responses:
        valid = r.doc_ids >= 0
        if r.doc_ids.shape != (engine.cfg.keep,) or not (
                np.isfinite(r.scores[valid]).all()
                and (r.doc_ids[valid] < n_docs).all()):
            raise AssertionError(f"request {r.request_id}: ids/scores out of range")
        if not (np.diff(np.where(np.isfinite(r.scores), r.scores, -1.0)) <= 0).all():
            raise AssertionError(f"request {r.request_id}: scores not sorted")
    pre = parts["tickets"] + parts["slabs"] + parts["shallow"]
    hits_pre = sum(r.cached for r in pre)
    if hits_pre <= 0:
        raise AssertionError("no cache hit before the swap")
    seen = set()
    for r in parts["swap"]:
        key = canonical_query_key(log.terms[r.qid], r.category)
        if r.policy_version != 2 or (key not in seen and r.cached):
            raise AssertionError(f"request {r.request_id}: a hit before a "
                                 f"fill after the swap (v{r.policy_version})")
        seen.add(key)
    hits_swap = sum(r.cached for r in parts["swap"])

    # Prints.
    lat = {k: np.array([r.latency_s for r in v]) * 1e3 for k, v in parts.items()}
    print(f"[engine] 'block_scan' stream: {len(responses)} responses in "
          f"{t_stream:.2f} s, {len(responses) / t_stream:.1f} queries/s; "
          f"Telemetry latency p50 {summ['latency_p50_ms']:.3f} ms, p99 "
          f"{summ['latency_p99_ms']:.3f} ms, mean {summ['latency_mean_ms']:.3f}; "
          f"hit rate {summ['cache_hit_rate']:.4f} ({summ['n_cached']} of "
          f"{summ['n_requests']}); {summ['n_batches']} micro-batches, padding "
          f"{summ['padding_overhead']:.4f}; level counts {summ['level_counts']}; "
          f"mean u {summ['mean_u']:.1f}", flush=True)
    for k, v in lat.items():
        miss = np.array([r.latency_s for r in parts[k] if not r.cached]) * 1e3
        print(f"[engine] {k:8s}: {len(v)} responses, {int(sum(r.cached for r in parts[k]))} "
              f"hits; latency p50 {np.percentile(v, 50):.3f} ms, p99 "
              f"{np.percentile(v, 99):.3f} ms; misses p50 "
              f"{np.percentile(miss, 50) if len(miss) else 0.0:.3f} ms",
              flush=True)
    print(f"[engine] swap to v2: {hits_pre} hits before; after, no hit before "
          f"a fill at v2 ({hits_swap} hits in the second post-swap slab)",
          flush=True)
    by_bucket = {}
    for row in engine.telemetry.batches:
        by_bucket.setdefault(row["bucket"], []).append(row)
    for bucket, rows in sorted(by_bucket.items()):
        print(f"[engine] micro-batch bucket {bucket:3d}: {len(rows)} batches, "
              f"{np.mean([r['n_real'] for r in rows]):.1f} real lanes; "
              f"batch_inputs {np.mean([r['t_inputs_s'] for r in rows]) * 1e3:.1f} "
              f"ms, execute {np.mean([r['t_execute_s'] for r in rows]) * 1e3:.1f} "
              f"ms (means)", flush=True)
    n_batches = len(engine.telemetry.batches)
    print(f"[engine] main path launches: {launches}; "
          f"{launches['block_scan_pruned_chunk'] / n_batches:.1f} "
          f"block_scan_pruned_chunk launches per micro-batch", flush=True)

    # The same stream on the reference backend: every field but the
    # host-clock latency bit-equal.
    ref, ref_parts, _, t_ref, _ = drive_engine(dev, sys_, trained, "reference",
                                               stream)
    fields = ("request_id", "qid", "category", "u", "cand_cnt", "cached",
              "policy_version", "index_epoch", "level")
    for k in parts:
        for g, w in zip(parts[k], ref_parts[k], strict=True):
            if not (all(getattr(g, f) == getattr(w, f) for f in fields)
                    and np.array_equal(g.doc_ids, w.doc_ids)
                    and np.array_equal(g.scores, w.scores)):
                raise AssertionError(f"{k}: request {g.request_id} differs "
                                     f"between 'block_scan' and 'reference'")
    if ref.summary()["cache_hits"] != summ["cache_hits"]:
        raise AssertionError("cache hits differ between the backends")
    print(f"[engine] 'reference' engine, same stream: {t_ref:.2f} s "
          f"({len(responses) / t_ref:.1f} queries/s); every response equal "
          f"to 'block_scan' bit for bit (doc_ids, scores, u, cand_cnt, cached, "
          f"level, policy_version, index_epoch, request ids)", flush=True)

    # One drain of a full bucket of keys not in the cache, profiled.
    if dev.type == "cuda":
        cold = np.array([q for q in np.random.default_rng(SEED + 12).permutation(
            log.n_queries) if not engine.cache_has(
                canonical_query_key(log.terms[q], int(log.category[q])))])
        cat = int(log.category[cold[0]])
        cold = cold[log.category[cold] == cat][:ENGINE_CFG["max_bucket"]]
        profile_device(f"engine drain (cat {cat}, {len(cold)} cold arrivals)",
                       lambda: engine.serve_many(cold),
                       "block_scan_pruned_chunk")
    return launches


# ------------------------------------------------------------ phase 3d
# Serve while training: the thread-backed ReplicaSet on the serve phase's
# system, phase 3b's Qs published as v1, a TrainerLoop fed from the
# served-traffic tap publishing v2 and v3 (8 iterations of 64 queries a
# category, a publish every 4, gated on the tap's holdout).
CLUSTER_WAVE = 256                     # arrivals per wave, the log's popularity
CLUSTER_BURST = 256                    # then a burst against a finite budget
CLUSTER_REPLICAS = 2
CLUSTER_STALENESS = 2
CLUSTER_TRAIN = dict(iters=8, publish_every=4, batch=64, probe_from_tap=True,
                     publish_initial=False)
CLUSTER_TIMEOUT_S = 300.0


def serve_wave(cluster, qids):
    """Submit one wave through the slab front door and wait for every
    ticket; returns the tickets (results and ticket latencies on them)."""
    tickets = cluster.submit_many(qids)
    for t in tickets:
        if t.result(timeout=CLUSTER_TIMEOUT_S) is None:
            raise AssertionError(f"qid {t.qid} not served in "
                                 f"{CLUSTER_TIMEOUT_S} s (replica {t.replica})")
    return tickets


def pct_ms(tickets, q):
    import numpy as np

    return float(np.percentile([t.latency_s for t in tickets], q)) * 1e3


def check_against_reference_engine(sys_, snaps, responses):
    """Every response bit-equal (doc_ids, scores, u, cand_cnt,
    policy_version, index_epoch, level) to its query served by a
    ``reference``-backend engine (no cache) on the snapshot of the
    response's version, at the level that produced it; returns the
    number of reference rollouts."""
    import numpy as np

    from repro_torch.policies import PolicyStore
    from repro_torch.serving import EngineConfig, ServeEngine, ServiceLevel

    groups = {}
    for r in responses:
        groups.setdefault((r.policy_version, int(r.level)), []).append(r)
    n_ref = 0
    for (version, level), rs in sorted(groups.items()):
        store = PolicyStore(staleness_bound=0)
        for v in range(1, version + 1):      # the same version number
            store.publish(dict(snaps[v].policies),
                          fallbacks=dict(snaps[v].fallbacks))
        ref = ServeEngine(sys_, store, EngineConfig(
            min_bucket=8, max_bucket=256, cache_capacity=0,
            backend="reference"))
        qids = np.unique([r.qid for r in rs])
        want = dict(zip(qids.tolist(), ref.serve_many(qids, ServiceLevel(level))))
        n_ref += len(qids)
        for r in rs:
            w = want[r.qid]
            if not ((r.u, r.cand_cnt, r.policy_version, r.index_epoch,
                     int(r.level)) == (w.u, w.cand_cnt, w.policy_version,
                                       w.index_epoch, int(w.level))
                    and np.array_equal(r.doc_ids, w.doc_ids)
                    and np.array_equal(r.scores, w.scores)):
                raise AssertionError(
                    f"qid {r.qid} v{version} level {level}: the cluster's "
                    f"response differs from the 'reference' engine's")
    return n_ref


def cluster_cli(dev):
    """``launch/cluster.py --smoke`` as a subprocess on ``dev`` (the
    port's cluster-smoke and the thread half of trace-smoke), its trace
    through ``tools/check_trace.py --require-chain`` and its statusz
    through ``tools/obsctl.py``; raises on any non-zero exit."""
    import os

    out = ROOT / "results"
    files = {k: str(out / f"cluster_cli_{k}_torch.json")
             for k in ("trace", "metrics", "statusz", "out")}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmds = [
        [sys.executable, "-m", "repro_torch.launch.cluster", "--smoke",
         "--device", dev.type, "--trace-out", files["trace"],
         "--metrics-json", files["metrics"], "--statusz-out",
         files["statusz"], "--out", files["out"]],
        [sys.executable, str(ROOT / "tools" / "check_trace.py"),
         files["trace"], "--require-chain", "--metrics", files["metrics"]],
        [sys.executable, str(ROOT / "tools" / "obsctl.py"), "statusz",
         files["statusz"]]]
    for cmd in cmds:
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=600)
        name = Path(cmd[1]).name if cmd[1] != "-m" else cmd[2]
        for line in (res.stdout + res.stderr).strip().splitlines()[-8:]:
            print(f"[cluster cli] {name}: {line}", flush=True)
        if res.returncode != 0:
            raise AssertionError(f"{name} exited {res.returncode}")
        print(f"[cluster cli] {name}: rc 0 in {time.perf_counter() - t0:.1f} s",
              flush=True)


def stream_probe(dev, sys_, policy, reps=5):
    """Hazard 3, measured: every thread launches on the one default
    stream, so a rollout's per-chunk sync waits for whatever another
    thread queued.  Times one bucket-8 serve step (median of ``reps``)
    alone, beside a thread that keeps fp32 4096^3 GEMMs queued on the
    same stream, and beside the same thread on a stream of its own;
    returns the three medians in ms."""
    import contextlib
    import threading

    import numpy as np
    import torch

    from repro_torch.data.querylog import CAT1
    from repro_torch.serving import ShardedExecutor

    exe = ShardedExecutor(sys_, backend="block_scan")
    qids = np.where(sys_.log.category == CAT1)[0][:8]
    inputs = sys_.batch_inputs(qids)
    exe.execute(policy, *inputs)                  # prepared, built, warm

    def median_ms():
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            exe.execute(policy, *inputs)          # ends in a device-to-host copy
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    a = torch.randn(4096, 4096, device=dev)
    out = {"alone": median_ms()}
    for label, stream in (("same stream", None),
                          ("own stream", torch.cuda.Stream(dev))):
        stop = threading.Event()

        def hog():
            ctx = (torch.cuda.stream(stream) if stream is not None
                   else contextlib.nullcontext())
            with ctx:
                while not stop.is_set():
                    for _ in range(4):
                        torch.mm(a, a)
                    torch.cuda.current_stream().synchronize()

        th = threading.Thread(target=hog, daemon=True)
        th.start()
        try:
            time.sleep(0.05)
            out[label] = median_ms()
        finally:
            stop.set()
            th.join(timeout=60)
    sync(dev)
    print(f"[cluster] hazard 3 (one stream, many threads): a bucket-8 serve "
          f"step (8 CAT1 queries, chunk kernel) {out['alone']:.3f} ms alone, "
          f"{out['same stream']:.3f} ms beside a thread queuing fp32 GEMMs "
          f"(4096^3, 4 a sync) on the same stream, {out['own stream']:.3f} "
          f"ms beside it on a stream of its own (medians of {reps})",
          flush=True)
    return out


def cluster_phase(dev, sys_, trained):
    """Phase 3d: serve while training through the thread-backed
    ``ReplicaSet`` (2 replicas) with a ``TrainerLoop`` on the served
    traffic; check that no fault was read as load, every response
    against a ``reference`` engine at its version, the trace; run the
    cluster CLI's smoke; returns the kernels' launch counts of the
    stream."""
    import math

    import numpy as np

    from repro_torch.cluster import (ClusterConfig, ReplicaSet, ServiceLevel,
                                     Shed, TrainerConfig, TrainerLoop)
    from repro_torch.data.querylog import CAT1, CAT2
    from repro_torch.index.corpus import N_FIELDS
    from repro_torch.obs import Tracer
    from repro_torch.policies import PolicyStore, TabularQPolicy
    from repro_torch.serving import EngineConfig

    t_phase = time.perf_counter()
    log = sys_.log
    tracer = Tracer()
    store = PolicyStore(staleness_bound=CLUSTER_STALENESS)
    snaps = {}
    store.subscribe(lambda snap: snaps.setdefault(snap.version, snap))
    store.publish({cat: TabularQPolicy(q) for cat, q in trained.items()},
                  fallbacks=sys_.fallback_policies())
    shallow_caps = {cat: sys_.shallow_u_cap(cat) for cat in (CAT1, CAT2)}
    trainer = TrainerLoop(sys_, store, cfg=TrainerConfig(**CLUSTER_TRAIN),
                          tracer=tracer)
    cluster = ReplicaSet(sys_, store, ClusterConfig(
        n_replicas=CLUSTER_REPLICAS, backend="thread", tap_holdout_every=4,
        prior_shallow_u=float(min(shallow_caps.values()))),
        EngineConfig(backend="block_scan", **ENGINE_CFG), tracer=tracer)
    trainer.source = cluster.tap
    t0 = time.perf_counter()
    n_warm = cluster.warmup()
    sync(dev)
    print(f"[cluster] {CLUSTER_REPLICAS} thread replicas over one system, "
          f"{ENGINE_CFG}, 'block_scan', tracing on; warmup prepared {n_warm} "
          f"serve steps in {time.perf_counter() - t0:.2f} s; trainer "
          f"{CLUSTER_TRAIN} from the tap (holdout every 4th)", flush=True)

    rng = np.random.default_rng(SEED + 13)

    def draw(n):
        return rng.choice(log.n_queries, size=n, p=log.popularity)

    reset_counts()                # the main path: the stream, after warmup
    waves, trainer_error = [], None
    with cluster:
        t0 = time.perf_counter()
        trainer.start()
        while trainer.alive or not waves:
            waves.append(serve_wave(cluster, draw(CLUSTER_WAVE)))
        t_train = time.perf_counter() - t0
        try:
            trainer.join(timeout=CLUSTER_TIMEOUT_S)
        except Exception as e:            # noqa: BLE001 — reported below
            trainer_error = e
        if trainer.alive:
            raise AssertionError(f"the trainer ran past {CLUSTER_TIMEOUT_S} s")
        # One more wave on the last version, under the profiler on the card.
        last = draw(CLUSTER_WAVE)
        if dev.type == "cuda":
            box = []
            _, busy_us, wall_us = profile_device(
                f"cluster wave ({CLUSTER_WAVE} arrivals, {CLUSTER_REPLICAS} "
                f"replicas)", lambda: box.append(serve_wave(cluster, last)),
                "block_scan_pruned_chunk")
            final = box[0]
        else:
            final = serve_wave(cluster, last)
        # Burst against a finite budget, sized as the reference smoke
        # sizes it (src/repro/launch/cluster.py:278-295): FULL may hold
        # three median queries or one query at the most it can read, the
        # SHALLOW rung provably fits the whole burst.  "The most it can
        # read" is the reference's u_budget there (1024 over 8 blocks);
        # here it is every block's every plane, as the configured
        # u_budget (65536) never binds at this depth.
        burst_qids = draw(CLUSTER_BURST)
        est = cluster.admission.estimator
        est_med = float(np.median([est.estimate(int(q)) for q in burst_qids]))
        one_query = min(sys_.cfg.u_budget, sys_.env_cfg.n_blocks
                        * log.terms.shape[1] * N_FIELDS)
        cap = max(shallow_caps.values())
        full_u = max(3 * est_med, one_query)
        budget = full_u + (CLUSTER_BURST + 1) * cap
        cluster.admission.u_inflight_budget = budget
        cluster.admission.full_watermark = min(0.5, full_u / budget)
        t0 = time.perf_counter()
        burst = [cluster.submit(int(q)) for q in burst_qids]
        for t in burst:
            if t.result(timeout=CLUSTER_TIMEOUT_S) is None:
                raise AssertionError(f"burst qid {t.qid} not served")
        t_burst = time.perf_counter() - t0
        cluster.admission.u_inflight_budget = math.inf
        sync(dev)
    launches = read_counts()
    stats = cluster.stats()

    # Checks.  A replica turns any exception into a Shed and keeps
    # serving, so a failing kernel would read as load: hazards first.
    wave_tickets = [t for w in waves for t in w] + final
    every = wave_tickets + burst
    results = [t.result() for t in every]
    err = [r for r in results
           if isinstance(r, Shed) and r.reason.startswith("replica_error")]
    if err:
        raise AssertionError(f"{len(err)} replica_error sheds: {err[:3]}")
    wave_sheds = [t.result() for t in wave_tickets if t.shed]
    if wave_sheds:
        raise AssertionError(f"{len(wave_sheds)} sheds at an infinite budget: "
                             f"{wave_sheds[:3]}")
    if trainer_error is not None:
        raise AssertionError(f"the trainer raised {trainer_error!r}")
    if dev.type == "cuda" and launches["block_scan_pruned_chunk"] <= 0:
        raise AssertionError("the cluster launched no block_scan kernel")
    if store.version < 3 or trainer.versions_published != [2, 3]:
        raise AssertionError(f"versions: head v{store.version}, trainer "
                             f"{trainer.versions_published}")
    if stats["version_lag_observed_max"] > CLUSTER_STALENESS:
        raise AssertionError("served a snapshot beyond the staleness bound")
    if not (trainer.tap_batches > 0 and trainer.log_batches == 0):
        raise AssertionError(f"trainer batches: tap {trainer.tap_batches}, "
                             f"log {trainer.log_batches}")
    if stats["n_submitted"] != len(every) or \
            stats["n_submitted"] != stats["n_responses"] + stats["n_shed"]:
        raise AssertionError("dropped tickets")
    burst_mix = {l.name: sum(t.level == l for t in burst) for l in ServiceLevel}
    hard = [t.result() for t in burst if t.shed]
    if hard or burst_mix["SHALLOW"] <= 0:
        raise AssertionError(f"burst: mix {burst_mix}, hard sheds {hard[:3]}")
    compiles = sum(r.engine.compile_count for r in cluster.replicas)
    if compiles != n_warm:
        raise AssertionError(f"serve steps {n_warm} -> {compiles} after warmup")
    n_docs = sys_.index.n_docs
    responses = [r for r in results if not isinstance(r, Shed)]
    for r in responses:
        valid = r.doc_ids >= 0
        if not (np.isfinite(r.scores[valid]).all()
                and (r.doc_ids[valid] < n_docs).all()):
            raise AssertionError(f"qid {r.qid}: ids/scores out of range")
    t0 = time.perf_counter()
    n_ref = check_against_reference_engine(sys_, snaps, responses)
    t_ref = time.perf_counter() - t0

    # Trace and fleet metrics, checked by the repo's own tool.
    out = ROOT / "results"
    out.mkdir(exist_ok=True)
    trace_path = out / "cluster_trace_torch.json"
    metrics_path = out / "cluster_metrics_torch.json"
    n_entries = cluster.write_trace(trace_path)
    metrics_path.write_text(json.dumps(cluster.metrics_snapshot(), indent=1))
    res = subprocess.run([sys.executable, str(ROOT / "tools" / "check_trace.py"),
                          str(trace_path), "--require-chain", "--metrics",
                          str(metrics_path)], capture_output=True, text=True)
    print(f"[cluster] trace: {n_entries} span entries; "
          f"{res.stdout.strip()}", flush=True)
    if res.returncode != 0:
        raise AssertionError(f"check_trace exited {res.returncode}")

    # Prints.
    n_wave = sum(len(w) for w in waves)
    hits = sum(t.result().cached for t in wave_tickets)
    print(f"[cluster] serve while training: {len(waves)} waves of "
          f"{CLUSTER_WAVE} ({n_wave} arrivals) in {t_train:.2f} s while the "
          f"trainer ran, {n_wave / t_train:.1f} queries/s; ticket latency "
          f"p50 {pct_ms([t for w in waves for t in w], 50):.3f} ms, p99 "
          f"{pct_ms([t for w in waves for t in w], 99):.3f} ms; hits "
          f"{hits} of {len(wave_tickets)}", flush=True)
    print(f"[cluster] last wave (after join, profiled on the card): p50 "
          f"{pct_ms(final, 50):.3f} ms, p99 {pct_ms(final, 99):.3f} ms",
          flush=True)
    print(f"[cluster] burst: {CLUSTER_BURST} submits against {budget:.0f} u "
          f"(FULL watermark {cluster.admission.full_watermark:.4f}, median "
          f"estimate {est_med:.1f} u, shallow cap {cap} u) in {t_burst:.2f} s; "
          f"mix {burst_mix}; p50 {pct_ms(burst, 50):.3f} ms, p99 "
          f"{pct_ms(burst, 99):.3f} ms", flush=True)
    print(f"[cluster] admission mix (all): {stats['admission']['levels']}; "
          f"router {stats['router']}", flush=True)
    print(f"[cluster] versions: trainer published {trainer.versions_published} "
          f"(head v{store.version}), gate recall "
          f"{[row['probe_recall'] for row in trainer.history]} from "
          f"{[row['probe_source'] for row in trainer.history]}; version lag "
          f"observed max {stats['version_lag_observed_max']}, mean "
          f"{stats['version_lag_observed_mean']:.4f}; trainer batches tap "
          f"{trainer.tap_batches}, log {trainer.log_batches}", flush=True)
    for r in cluster.replicas:
        rows = list(r.engine.telemetry.batches)
        summ = r.summary()
        print(f"[cluster] replica {r.idx}: {summ['n_requests']} requests, "
              f"{len(rows)} micro-batches ({np.mean([b['n_real'] for b in rows]):.1f} "
              f"real lanes), batch_inputs "
              f"{np.mean([b['t_inputs_s'] for b in rows]) * 1e3:.1f} ms, execute "
              f"{np.mean([b['t_execute_s'] for b in rows]) * 1e3:.1f} ms (means), "
              f"sum of both {sum(b['t_inputs_s'] + b['t_execute_s'] for b in rows):.2f} s; "
              f"hit rate {summ['cache_hit_rate']:.4f}", flush=True)
        by_bucket = {}
        for b in rows:
            by_bucket.setdefault(b["bucket"], []).append(b)
        print(f"[cluster] replica {r.idx} by bucket: " + "; ".join(
            f"{k}: {len(v)} x (batch_inputs "
            f"{np.mean([b['t_inputs_s'] for b in v]) * 1e3:.1f}, execute "
            f"{np.mean([b['t_execute_s'] for b in v]) * 1e3:.1f} ms)"
            for k, v in sorted(by_bucket.items())), flush=True)
    print(f"[cluster] main path launches: {launches}", flush=True)
    print(f"[cluster] every response ({len(responses)}) bit-equal to a "
          f"'reference' engine on its version's snapshot at its level "
          f"({n_ref} reference rollouts, {t_ref:.2f} s); no replica_error "
          f"shed, no shed at the infinite budget, trainer raised nothing",
          flush=True)
    if dev.type == "cuda":
        stream_probe(dev, sys_, snaps[1].policies[CAT1])
    cluster_cli(dev)
    print(f"[cluster] phase 3d in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


# ------------------------------------------------------------ phase 3e
# Serve while the index mutates: a LiveRetrievalSystem at the serve
# cell's widths, its base the serve cell's 64 blocks and its capacity
# the reference's default, twice the base; production-plan policies, 2
# thread replicas with 3c's engines, a MergeDaemon, freshness ticks.
LIVE_CAPACITY_MULT = 2                 # the reference's default capacity
LIVE_TICKS = 8
LIVE_DOCS_PER_TICK = 1024              # 8,192 new docs: blocks 64-65 fill
LIVE_UPDATES_PER_TICK = 64             # base docs replaced each tick
LIVE_WAVE = 256                        # the serve cell's query batch
LIVE_FRAC_FRESH = 0.7
LIVE_STATIC_RANK_FRESH = 0.01
LIVE_MERGE_MIN_DOCS = 2048
LIVE_PARITY_QUERIES = 16
LIVE_REPLICAS = 2
LIVE_SETTLE_S = 120.0


def updated_doc(rng, vocab):
    """A replacement for a base doc in the corpus's field shape: a body,
    a title from it, a url from the title, an anchor term."""
    import numpy as np

    body = np.unique(rng.integers(0, vocab, size=48)).astype(np.int32)
    title = np.unique(rng.choice(body, size=6)).astype(np.int32)
    url = np.unique(rng.choice(title, size=3)).astype(np.int32)
    anchor = np.unique(rng.choice(title, size=1)).astype(np.int32)
    return [anchor, url, body, title]


def check_live_against_reference(sys_, store, epochs, responses):
    """Every response bit-equal (doc_ids, scores, u, cand_cnt,
    policy_version, level) to a ``reference``-backend rollout of its
    query at the response's own pinned index epoch and level, under the
    policy of its category; returns the number of reference rollouts."""
    import numpy as np

    from repro_torch.serving import ServiceLevel, ShardedExecutor

    exe = ShardedExecutor(sys_, n_shards=1, backend="reference")
    snap = store.snapshot()
    groups = {}
    for r in responses:
        groups.setdefault((r.index_epoch, int(r.level), r.category),
                          []).append(r)
    n_ref = 0
    for (epoch, level, cat), rs in sorted(groups.items()):
        policy = (snap.policies[cat] if level == int(ServiceLevel.FULL)
                  else snap.fallbacks[cat])
        qids = np.unique([r.qid for r in rs])
        occ, scores, tp = sys_.batch_inputs(qids, epoch=epochs[epoch])
        ids, sc, u, cnt = exe.execute(policy, occ, scores, tp, level=level)
        lane = {int(q): i for i, q in enumerate(qids)}
        n_ref += len(qids)
        for r in rs:
            i = lane[r.qid]
            if not ((r.u, r.cand_cnt, r.policy_version) ==
                    (int(u[i]), int(cnt[i]), snap.version)
                    and np.array_equal(r.doc_ids, ids[i])
                    and np.array_equal(r.scores, sc[i])):
                raise AssertionError(
                    f"qid {r.qid} epoch {epoch} level {level}: the fleet's "
                    "response differs from the 'reference' rollout at its "
                    "pinned epoch")
    return n_ref


def fresh_in_candidates(sys_, epochs, responses):
    """How many of the responses' queries have their judged doc among
    the candidates of their production-plan rollout at the response's
    pinned epoch (the served ids are the top of those candidates)."""
    import numpy as np
    import torch

    from repro_torch.core.match_plan import plan_rollout

    groups = {}
    for r in responses:
        groups.setdefault((r.index_epoch, r.category), set()).add(r.qid)
    hit = {}
    for (epoch, cat), qids in sorted(groups.items()):
        qids = np.array(sorted(qids))
        occ, scores, tp = sys_.batch_inputs(qids, epoch=epochs[epoch])
        final, _ = plan_rollout(sys_.env_cfg, sys_.ruleset,
                                sys_.plan_for_category(cat), occ, scores, tp,
                                backend="block_scan")
        judged = torch.from_numpy(sys_.log.judged_ids[qids, :1]).to(occ.device)
        found = (final.cand == judged).any(dim=1).cpu().numpy()
        hit.update({(epoch, int(q)): bool(f) for q, f in zip(qids, found)})
    return sum(hit[(r.index_epoch, r.qid)] for r in responses)


def live_cli(dev):
    """``launch/live_index.py --smoke`` as a subprocess on ``dev`` (the
    port's index smoke); raises on a non-zero exit."""
    import os

    out = ROOT / "results"
    cmd = [sys.executable, "-m", "repro_torch.launch.live_index", "--smoke",
           "--device", dev.type, "--out",
           str(out / "live_index_cli_torch.json"), "--metrics-json",
           str(out / "live_index_cli_metrics_torch.json")]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    for line in (res.stdout + res.stderr).strip().splitlines()[-8:]:
        print(f"[live cli] {line}", flush=True)
    if res.returncode != 0:
        raise AssertionError(f"launch/live_index.py --smoke exited "
                             f"{res.returncode}")
    print(f"[live cli] rc 0 in {time.perf_counter() - t0:.1f} s", flush=True)


def live_phase(dev, cfg):
    """Phase 3e: serve the freshness workload through a 2-replica
    ``ReplicaSet`` while documents are added and updated, epochs
    hot-swap and a ``MergeDaemon`` compacts; check parity at every
    recorded epoch on both backends and every response against a
    ``reference`` rollout at its epoch; run the CLI smoke; returns the
    kernels' launch counts of the serving run."""
    import tempfile

    import numpy as np

    from repro_torch.cluster import ClusterConfig, ReplicaSet, Shed
    from repro_torch.data.freshness import FreshnessConfig, FreshnessWorkload
    from repro_torch.index.builder import batch_query_occupancy
    from repro_torch.index.live import (DeltaOp, LiveIndex,
                                        LiveRetrievalSystem, MergeConfig,
                                        MergeDaemon, check_epoch_parity)
    from repro_torch.index.live.live_index import MERGE_MS_EDGES
    from repro_torch.obs import Tracer
    from repro_torch.policies import PolicyStore
    from repro_torch.serving import EngineConfig

    t_phase = time.perf_counter()
    storage = tempfile.TemporaryDirectory(prefix="live-index-")
    tracer = Tracer()                        # the live index's spans only
    base_docs = cfg.corpus.n_docs
    capacity = LIVE_CAPACITY_MULT * base_docs
    t0 = time.perf_counter()
    sys_ = LiveRetrievalSystem(cfg, capacity_docs=capacity,
                               storage_dir=storage.name, tracer=tracer,
                               device=dev)
    live = sys_.live
    sync(dev)
    print(f"[live] system built in {time.perf_counter() - t0:.1f} s: base "
          f"{sys_.index.n_docs} docs ({sys_.index.n_blocks} blocks), capacity "
          f"{live.capacity_docs} docs ({live.capacity_blocks} blocks), base "
          f"generation 0 {'mmapped' if live.stats()['base_mmapped'] else 'in memory'} "
          f"({live.stats()['base_nbytes']} bytes); L1 scoring sub-batch "
          f"{sys_.scoring_batch_size()} queries", flush=True)
    t0 = time.perf_counter()
    losses = sys_.fit_l1(n_queries=QUERY_BATCH)
    sync(dev)
    t1 = time.perf_counter()
    bins = sys_.fit_state_bins(n_queries=QUERY_BATCH, batch=QUERY_BATCH)
    sync(dev)
    print(f"[live] fit_l1 on the live system (capacity planes): loss "
          f"{float(losses[0]):.6f} -> {float(losses[-1]):.6f} in "
          f"{t1 - t0:.2f} s; fit_state_bins p={bins.p} in "
          f"{time.perf_counter() - t1:.2f} s", flush=True)
    if not np.isfinite(float(losses[-1])) or losses[-1] >= losses[0]:
        raise AssertionError("fit_l1 on the live system did not lower the loss")

    store = PolicyStore(staleness_bound=1)
    store.publish(sys_.baseline_policies(), fallbacks=sys_.fallback_policies())
    epochs = {}
    unsubscribe = live.store.subscribe(lambda e: epochs.setdefault(e.version, e))
    gens = {}                                # generation -> (bytes, docs, epoch)

    def on_epoch(e):
        gens.setdefault(e.generation, (e.view.base.nbytes, e.view.base.n_docs,
                                       e.version))
    unsub_gens = live.store.subscribe(on_epoch)
    workload = FreshnessWorkload(sys_, FreshnessConfig(
        docs_per_tick=LIVE_DOCS_PER_TICK, wave_queries=LIVE_WAVE,
        frac_fresh=LIVE_FRAC_FRESH, static_rank_fresh=LIVE_STATIC_RANK_FRESH,
        seed=SEED))
    cluster = ReplicaSet(sys_, store, ClusterConfig(n_replicas=LIVE_REPLICAS),
                         EngineConfig(backend="block_scan", **ENGINE_CFG))
    t0 = time.perf_counter()
    n_warm = cluster.warmup()
    sync(dev)
    print(f"[live] {LIVE_REPLICAS} thread replicas, {ENGINE_CFG}, "
          f"'block_scan', production-plan policies; warmup prepared {n_warm} "
          f"serve steps in {time.perf_counter() - t0:.2f} s; MergeDaemon "
          f"min_delta_docs {LIVE_MERGE_MIN_DOCS}", flush=True)

    urng = np.random.default_rng(SEED + 17)
    vocab = cfg.corpus.vocab_size
    waves = []
    daemon = MergeDaemon(live, MergeConfig(min_delta_docs=LIVE_MERGE_MIN_DOCS,
                                           poll_interval_s=0.02))
    reset_counts()            # the main path: ticks, waves, merges
    t0 = time.perf_counter()
    with cluster, daemon:
        for _ in range(LIVE_TICKS):
            for d in urng.choice(base_docs, size=LIVE_UPDATES_PER_TICK,
                                 replace=False):
                sys_.update_document(int(d), updated_doc(urng, vocab))
            wave = workload.tick()          # docs + queries + commit
            daemon.trigger()
            waves.append(serve_wave(cluster, wave))
        t_settle = time.perf_counter()
        while (live.delta_docs >= LIVE_MERGE_MIN_DOCS
               and daemon.last_error is None
               and time.perf_counter() - t_settle < LIVE_SETTLE_S):
            time.sleep(0.02)
        settle = workload.wave()
        if dev.type == "cuda":               # profiled on the card
            box = []
            profile_device(f"live settle wave ({LIVE_WAVE} arrivals, "
                           f"{LIVE_REPLICAS} replicas)",
                           lambda: box.append(serve_wave(cluster, settle)),
                           "block_scan_pruned_chunk")
            waves.append(box[0])
        else:
            waves.append(serve_wave(cluster, settle))
        sync(dev)
    wall = time.perf_counter() - t0
    launches = read_counts()
    unsubscribe()
    unsub_gens()
    stats = cluster.stats()
    istats = live.stats()

    # Checks.  A replica turns any exception into a Shed and the daemon
    # keeps its exception: hazards first.
    if daemon.last_error is not None:
        raise AssertionError(f"the merge daemon raised {daemon.last_error!r}")
    tickets = [t for w in waves for t in w]
    results = [t.result() for t in tickets]
    err = [r for r in results
           if isinstance(r, Shed) and r.reason.startswith("replica_error")]
    if err:
        raise AssertionError(f"{len(err)} replica_error sheds: {err[:3]}")
    sheds = [r for r in results if isinstance(r, Shed)]
    if sheds or stats["n_shed"]:
        raise AssertionError(f"{len(sheds)} sheds while the index mutated")
    if stats["n_submitted"] != len(tickets) or \
            stats["n_submitted"] != stats["n_responses"]:
        raise AssertionError("dropped tickets")
    if dev.type == "cuda" and launches["block_scan_pruned_chunk"] <= 0:
        raise AssertionError("the live fleet launched no block_scan kernel")
    if istats["merges"] < 2 or istats["generation"] < 2:
        raise AssertionError(f"merges {istats['merges']}, generation "
                             f"{istats['generation']}: expected >= 2 each")
    resp_epochs = sorted({r.index_epoch for r in results})
    if len(resp_epochs) < 2:
        raise AssertionError(f"responses span epochs {resp_epochs}")
    if not istats["base_mmapped"]:
        raise AssertionError("the merged base does not read as mmapped")
    n_docs = live.n_docs
    for r in results:
        valid = r.doc_ids >= 0
        if not (np.isfinite(r.scores[valid]).all()
                and (r.doc_ids[valid] < n_docs).all()):
            raise AssertionError(f"qid {r.qid}: ids/scores out of range")
    t1 = time.perf_counter()
    n_ref = check_live_against_reference(sys_, store, epochs, results)
    t_ref = time.perf_counter() - t1

    # Parity at every recorded epoch, on both backends.
    prng = np.random.default_rng(SEED + 19)
    before = read_counts()["block_scan_pruned_chunk"]
    t1 = time.perf_counter()
    for version in sorted(epochs):
        qids = prng.choice(sys_.log.n_queries, size=LIVE_PARITY_QUERIES,
                           replace=False)
        rep = check_epoch_parity(sys_, epochs[version], qids)
        if not rep["ok"]:
            raise AssertionError(f"parity failed at epoch v{version}")
    t_parity = time.perf_counter() - t1
    parity_launches = read_counts()["block_scan_pruned_chunk"] - before

    # Prints.
    n_arrivals = len(tickets)
    print(f"[live] serve while mutating: {LIVE_TICKS} ticks of "
          f"{LIVE_DOCS_PER_TICK} new docs (static rank "
          f"{LIVE_STATIC_RANK_FRESH}) and {LIVE_UPDATES_PER_TICK} base-doc "
          f"updates, a wave of {LIVE_WAVE} each ({LIVE_FRAC_FRESH} fresh), "
          f"one settle wave: {n_arrivals} arrivals in {wall:.2f} s, "
          f"{n_arrivals / wall:.1f} queries/s; ticket p50 "
          f"{pct_ms(tickets, 50):.3f} ms, p99 {pct_ms(tickets, 99):.3f} ms; "
          f"hits {sum(r.cached for r in results)} of {n_arrivals}", flush=True)
    spans = [e for e in tracer.log.snapshot() if e["kind"] == "span"]
    for name in ("index_commit", "index_merge"):
        ms = [(e["t1"] - e["t0"]) * 1e3 for e in spans if e["name"] == name]
        print(f"[live] {name}: {len(ms)} spans, ms each "
              f"{[round(m, 3) for m in ms]}", flush=True)
    h = live.registry.histogram("index.merge_ms", MERGE_MS_EDGES).snapshot()
    print(f"[live] index.merge_ms: count {h['count']}, sum {h['sum']:.3f}, "
          f"min {h['min']:.3f}, max {h['max']:.3f}; generations (bytes, base "
          f"docs, first epoch): {dict(sorted(gens.items()))}", flush=True)
    print(f"[live] index stats: {istats['commits']} commits, "
          f"{istats['merges']} merges -> generation {istats['generation']}, "
          f"head epoch {istats['epoch']}, {istats['n_docs']} docs "
          f"({istats['delta_docs']} in the delta), docs added "
          f"{istats['docs_added']}, updated {istats['docs_updated']}; "
          f"bytes_per_query_base {istats['bytes_per_query_base']:.1f}, "
          f"bytes_per_query_delta {istats['bytes_per_query_delta']:.1f}",
          flush=True)
    swaps = [r.engine.summary()["index_epoch_swaps"] for r in cluster.replicas]
    print(f"[live] epoch swaps per replica {swaps}; responses at epochs "
          f"{resp_epochs}; epoch_lag_observed_max "
          f"{stats['epoch_lag_observed_max']}, mean "
          f"{stats['epoch_lag_observed_mean']:.4f}", flush=True)
    fresh = [r for r in results if r.qid >= cfg.querylog.n_queries]
    in_cand = fresh_in_candidates(sys_, epochs, fresh)
    served = sum(int(sys_.log.judged_ids[r.qid, 0]) in set(r.doc_ids.tolist())
                 for r in fresh)
    n_fresh = max(1, len(fresh))
    print(f"[live] fresh responses {len(fresh)}; their judged (new) doc among "
          f"the candidates in {in_cand} ({in_cand / n_fresh:.4f}), among the "
          f"served ids (the top {len(fresh[0].doc_ids) if fresh else 0}) in "
          f"{served} ({served / n_fresh:.4f})", flush=True)
    for r in cluster.replicas:
        rows = list(r.engine.telemetry.batches)
        print(f"[live] replica {r.idx}: {len(rows)} micro-batches, "
              f"batch_inputs {np.mean([b['t_inputs_s'] for b in rows]) * 1e3:.1f} "
              f"ms, execute {np.mean([b['t_execute_s'] for b in rows]) * 1e3:.1f} "
              f"ms (means)", flush=True)
    print(f"[live] main path launches: {launches}", flush=True)
    print(f"[live] every response ({len(results)}) bit-equal to a "
          f"'reference' rollout at its pinned epoch and level ({n_ref} "
          f"reference rollouts, {t_ref:.2f} s); parity green at all "
          f"{len(epochs)} recorded epochs (v{min(epochs)}..v{max(epochs)}) on "
          f"'reference' and 'block_scan', {LIVE_PARITY_QUERIES} queries each, "
          f"{t_parity:.2f} s, {parity_launches} chunk launches; no "
          f"replica_error shed, no merge error", flush=True)

    # The occupancy build at capacity against the static build of the
    # same base (phase 3's path), on one wave's term lists.
    log = sys_.log
    lists = [log.terms[t.qid, : log.n_terms[t.qid]] for t in waves[0]]
    head = live.store.snapshot().view
    for name, build in (("static (base index)",
                         lambda: batch_query_occupancy(sys_.index, lists)),
                        ("live view at capacity",
                         lambda: head.batch_query_occupancy(lists))):
        times = []
        for _ in range(3):
            t1 = time.perf_counter()
            occ = build()
            times.append((time.perf_counter() - t1) * 1e3)
        print(f"[live] occupancy build, {name}: {occ.shape} in "
              f"{np.median(times):.1f} ms per batch of {len(lists)} (median "
              f"of 3)", flush=True)
    # One compaction with no serving thread beside it: the head base and
    # one trigger's worth of new docs, compacted and written to a scratch
    # generation that is never published.
    base = live.store.snapshot().view.base
    mrng = np.random.default_rng(SEED + 23)
    ops = [DeltaOp("add", base.n_docs + i, tuple(updated_doc(mrng, vocab)),
                   LIVE_STATIC_RANK_FRESH) for i in range(LIVE_MERGE_MIN_DOCS)]
    t1 = time.perf_counter()
    merged = LiveIndex._compact(base, ops)
    t2 = time.perf_counter()
    merged.save(Path(storage.name) / "alone")
    t3 = time.perf_counter()
    print(f"[live] one compaction alone (no serving thread): "
          f"{LIVE_MERGE_MIN_DOCS} new docs onto {base.n_docs}: compact "
          f"{(t2 - t1) * 1e3:.1f} ms, write and map {(t3 - t2) * 1e3:.1f} ms "
          f"({merged.nbytes} bytes)", flush=True)
    live_cli(dev)
    storage.cleanup()
    print(f"[live] phase 3e in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


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
    through the decode kernel (the main path, between a reset and a read
    of the launch counts); then one decode step through the kernel and
    the plain einsums from copies of one cache, a profiled decode step, a
    timed and a profiled prefill and the plain chunked one.  Returns the
    kernels' launch counts of the main path."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.kernels.decode_attention import DECODE_ATTENTION_TC_KERNEL as dec
    from repro_torch.kernels.flash_attention import FLASH_ATTENTION_TC_KERNEL as flash
    from repro_torch.models.transformer import decode_step, init_params, prefill

    cfg = dataclasses.replace(cfg or get_arch(LM_ARCH).model_cfg(False),
                              use_flash=True)
    plain_cfg = dataclasses.replace(cfg, use_flash=False)
    on_card = dev.type == "cuda"
    per_prefill = cfg.n_layers if on_card else 0    # one launch per layer
    per_step = cfg.n_layers if on_card else 0
    print(f"[lm] {LM_ARCH}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, {cfg.n_kv} kv heads, d_head {cfg.d_head}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.param_dtype}, random "
          f"weights (seed {SEED}); no width or depth cut", flush=True)
    print(f"[lm] traffic cut: prefill {batch} x {prompt} tokens instead of "
          f"prefill_32k's 32 x 32768, and decode batch {batch} instead of "
          f"decode_32k's 128 ({steps} steps from a cache padded to "
          f"{prompt + steps}), so that the plain chunked prefill's check fits "
          f"the run's time (phase 2 times the flash kernel at 32768)",
          flush=True)
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

    reset_counts()
    logits, cache = run_prefill("prefill (flash, first call)")
    first_logits = logits
    cache = {f: F.pad(c, (0, 0, 0, 0, 0, steps)) for f, c in cache.items()}
    token = logits.argmax(dim=-1)
    pos = torch.full((batch,), prompt, dtype=torch.int64, device=dev)
    outs, step_ms = [logits], []
    for _ in range(steps):
        before = dec.launches
        t0 = time.perf_counter()
        logits, cache = decode_step(params, token, cache, pos, cfg, device=dev)
        sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if dec.launches - before != per_step:
            raise AssertionError(f"decode step: {dec.launches - before} decode "
                                 f"launches, want {per_step}")
        outs.append(logits)
        token = logits.argmax(dim=-1)
        pos = pos + 1
    launches = read_counts()
    print(f"[lm] main path launches: {launches}", flush=True)
    if launches["flash_attention_tc"] != per_prefill:
        raise AssertionError("the LM path's tensor-core flash launches are not "
                             "one per layer")
    if (launches["decode_attention_tc"] != per_step * steps
            or launches["decode_attention"]):
        raise AssertionError("the LM path's decode launches are not one "
                             "tensor-core launch per layer per step")
    for out in outs:
        if out.shape != (batch, cfg.vocab) or not bool(torch.isfinite(out).all()):
            raise AssertionError("LM logits are not finite or misshapen")
    rest = step_ms[1:] or step_ms
    print(f"[lm] decode: {steps} greedy steps at B={batch}, first "
          f"{step_ms[0]:.2f} ms, then mean {sum(rest) / len(rest):.2f} ms/step "
          f"(min {min(rest):.2f}); {batch * len(rest) / sum(rest) * 1e3:.1f} "
          f"tokens/s", flush=True)
    decode_both_ways(params, token, cache, pos - 1, cfg, plain_cfg, dev)
    if on_card:     # pos is now past the cache: this step stores nothing
        profile_device("lm decode step", lambda: decode_step(
            params, token, cache, pos, cfg, device=dev), "decode_attention_tc")
        with decode_route(False):   # the same step on the CUDA-core kernel
            profile_device("lm decode step (CUDA-core decode kernel)",
                           lambda: decode_step(params, token, cache, pos, cfg,
                                               device=dev),
                           "decode_attention_")
    del cache, outs

    logits, cache = run_prefill("prefill (flash, steady)")
    print(f"[lm] steady prefill against the first: max |dlogit| "
          f"{float((logits - first_logits).abs().max()):.3g}", flush=True)
    del logits, cache
    if on_card:
        before = flash.launches
        kern_us, busy_us, _ = profile_device(
            "lm prefill", lambda: prefill(params, tokens, cfg, device=dev),
            "flash_attention_tc")
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


def lm_fp32_route(dev, cfg=None, layers=LM_FP32_LAYERS, batch=LM_BATCH,
                  prompt=LM_FP32_PROMPT, steps=LM_FP32_STEPS):
    """The LM path's fp32 route: the same model (``cfg``, by default
    Mistral-NeMo-12B) at full width in fp32, cut to ``layers`` layers,
    one prefill through ``flash_attention`` (fp32 goes to the CUDA-core
    kernel) and ``steps`` greedy decode steps through ``decode_attention``
    (fp32 goes to the CUDA-core kernel), between a reset and a read of
    the launch counts; the prefill held against the plain chunked
    prefill and each step against the plain einsums' step from a copy
    of the same cache, within LM_FP32_TOL.  Returns the counts."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import decode_step, init_params, prefill

    cfg = dataclasses.replace(cfg or get_arch(LM_ARCH).model_cfg(False),
                              n_layers=layers, param_dtype=torch.float32,
                              use_flash=True)
    plain_cfg = dataclasses.replace(cfg, use_flash=False)
    params = init_params(cfg, seed=SEED, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt), generator=gen,
                           device=dev)
    reset_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(params, tokens, cfg, device=dev)
    sync(dev)
    secs = time.perf_counter() - t0
    cache = {f: F.pad(c, (0, 0, 0, 0, 0, steps)) for f, c in cache.items()}
    plain_cache = {f: c.clone() for f, c in cache.items()}
    token = logits.argmax(dim=-1)
    pos = torch.full((batch,), prompt, dtype=torch.int64, device=dev)
    outs = []
    for _ in range(steps):
        step_logits, cache = decode_step(params, token, cache, pos, cfg,
                                         device=dev)
        outs.append((token, pos, step_logits))
        token, pos = step_logits.argmax(dim=-1), pos + 1
    sync(dev)
    launches = read_counts()
    print(f"[lm fp32] {LM_ARCH} at full width in fp32, {layers} layers: "
          f"prefill {batch} x {prompt} in {secs * 1e3:.1f} ms, {steps} decode "
          f"steps; launches {launches}", flush=True)
    on_card = dev.type == "cuda"
    want = layers if on_card else 0    # one per layer on the card
    if launches["flash_attention"] != want or launches["flash_attention_tc"]:
        raise AssertionError("the fp32 route's flash launches are not one "
                             "CUDA-core launch per layer")
    if (launches["decode_attention"] != want * steps
            or launches["decode_attention_tc"]):
        raise AssertionError("the fp32 route's decode launches are not one "
                             "CUDA-core launch per layer per step")
    plain_logits, _ = prefill(params, tokens, plain_cfg, device=dev)
    checks = [("prefill", logits, plain_logits)]
    for i, (tok, p, got) in enumerate(outs):
        want_logits, plain_cache = decode_step(params, tok, plain_cache, p,
                                               plain_cfg, device=dev)
        checks.append((f"decode step {i}", got, want_logits))
    for what, got, want_logits in checks:
        diff = (got - want_logits).abs()
        print(f"[lm fp32] {what}, kernels against plain: max |dlogit| "
              f"{float(diff.max()):.4g} (tol {LM_FP32_TOL} + "
              f"{LM_FP32_TOL}|plain|)", flush=True)
        if not (bool(torch.isfinite(got).all()) and bool(
                (diff <= LM_FP32_TOL + LM_FP32_TOL * want_logits.abs()).all())):
            raise AssertionError(f"fp32 {what}: kernel != plain within tol")
    return launches


# ------------------------------------------------------------ phase 5
def recsys_runs(arch_id):
    """The (shape name, batch) runs of one arch: serve_p99 for every
    arch, serve_bulk for the two archs with a bag sum, retrieval_cand for
    BERT4Rec."""
    from repro_torch.configs import get_arch

    shapes = get_arch(arch_id).shapes
    runs = [("serve_p99", shapes["serve_p99"].params["batch"])]
    if arch_id in BAG_ARCHS:
        runs.append(("serve_bulk", shapes["serve_bulk"].params["batch"]))
    if arch_id == "bert4rec":
        runs.append(("retrieval_cand",
                     shapes["retrieval_cand"].params["n_candidates"]))
    return runs


def recsys_phase(dev, reduced=False, batch_cap=None, reps=5):
    """Serve the four recsys archs (the main path between a reset and a
    read of the launch counts) and check each run's output; then, on the
    card, profile the serve_bulk forwards, after the read.
    ``reduced``/``batch_cap`` cut the configs and batches for a rehearsal
    on the CPU.  Returns the main path's launch counts."""
    import statistics

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.embedding_bag import (EMBEDDING_BAG_KERNEL,
                                                   EMBEDDING_BAG_LANES_KERNEL)
    from repro_torch.models import recsys

    # the bag route each shape must take: lanes at serve_p99's 512 bags,
    # the column kernel at serve_bulk's 262,144
    route_of = {"serve_p99": EMBEDDING_BAG_LANES_KERNEL,
                "serve_bulk": EMBEDDING_BAG_KERNEL}
    bags = (EMBEDDING_BAG_KERNEL, EMBEDDING_BAG_LANES_KERNEL)

    on_card = dev.type == "cuda"
    print("[recsys] traffic cut: serve shapes only (no train_batch); "
          "retrieval_cand for BERT4Rec only (the CTR archs' 1M-row forward is "
          "serve_bulk's work at 4x the batch); no width or depth cut",
          flush=True)
    inits = {"wide-deep": (recsys.wide_deep_init, recsys.wide_deep_forward),
             "deepfm": (recsys.deepfm_init, recsys.deepfm_forward),
             "dcn-v2": (recsys.dcn_init, recsys.dcn_forward),
             "bert4rec": (recsys.bert4rec_init, None)}
    to_profile = []         # (name, forward): run after the counts are read
    reset_counts()
    for arch_id in RECSYS_ARCHS:
        cfg = get_arch(arch_id).model_cfg(reduced)
        init, forward = inits[arch_id]
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)   # kept for to_profile
        t0 = time.perf_counter()
        params = init(cfg, seed=SEED, device=dev)
        sync(dev)
        n = count_params(params)
        print(f"[recsys] {arch_id}: {cfg}; {n / 1e6:.1f} M parameters "
              f"({n * 4 / 1e9:.3f} GB fp32) drawn in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 11)
        for shape, b in recsys_runs(arch_id):
            b = min(b, batch_cap or b)
            if arch_id == "bert4rec":
                rows = 1 if shape == "retrieval_cand" else b
                seq = torch.randint(0, cfg.n_items, (rows, cfg.seq_len),
                                    generator=gen, device=dev)

                def run(seq=seq, shape=shape, b=b):
                    h = recsys.bert4rec_forward(params, seq, cfg, device=dev)
                    if shape == "retrieval_cand":
                        return recsys.retrieval_topk(
                            h[0, -1], params["item_embed"][:b], k=100)
                    return torch.topk(
                        recsys.bert4rec_score_items(params, h[:, -1], cfg), 100)
            else:
                ids = torch.randint(0, cfg.vocab_per_field, (b, cfg.n_sparse),
                                    generator=gen, device=dev,
                                    dtype=torch.int32)
                dense = (torch.randn((b, cfg.n_dense), generator=gen,
                                     device=dev) if cfg.n_dense else None)

                def run(ids=ids, dense=dense, forward=forward, params=params,
                        cfg=cfg):
                    return forward(params, ids, cfg, dense, device=dev)
            before = {k.name: k.launches for k in bags}
            out = run()
            sync(dev)
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                run()
                sync(dev)
                times.append((time.perf_counter() - t0) * 1e3)
            counts = {k.name: k.launches - before[k.name] for k in bags}
            launches = sum(counts.values())
            want = {k.name: 0 for k in bags}
            if on_card and arch_id in BAG_ARCHS:
                want[route_of[shape].name] = reps + 1
            if counts != want:
                raise AssertionError(f"{arch_id} {shape}: bag launches "
                                     f"{counts} over {reps + 1} forwards, "
                                     f"want {want}")
            ms = statistics.median(times)
            # this arch's own: earlier archs' tables held for the profile
            # are left out
            peak = (f"{(torch.cuda.max_memory_allocated(dev) - held) / 1e9:.2f}"
                    f" GB" if on_card else "n/a (CPU)")
            print(f"[recsys] {arch_id} {shape} (batch {b}): median "
                  f"{ms:.3f} ms/batch over {reps} (min {min(times):.3f}), "
                  f"{b / ms * 1e3:.0f} examples/s; peak device memory "
                  f"{peak}; {launches / (reps + 1):g} embedding-bag launches "
                  f"per forward {counts}", flush=True)
            if arch_id == "bert4rec":
                bert4rec_check(shape, out, params, cfg, seq, b, recsys, dev)
            else:
                ctr_check(arch_id, shape, out, run, recsys, bags)
            if on_card and shape == "serve_bulk":
                to_profile.append((f"{arch_id} {shape}", run))
        del params, run, out    # only to_profile keeps an arch's tables
    counts = read_counts()
    for name, run in to_profile:
        profile_device(name, run, "embedding_bag")
    return counts


def ctr_check(arch_id, shape, out, run, recsys, bags):
    """Finite logits of the right shape; for the archs with a bag sum,
    the same forward with the plain bag (``embedding_bag_ref`` on the
    same device) within ``RECSYS_TOL``."""
    import torch

    from repro_torch.kernels.embedding_bag import embedding_bag_ref

    if out.dim() != 1 or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{arch_id} {shape}: logits not finite or misshapen")
    if arch_id not in BAG_ARCHS:
        print(f"[recsys] {arch_id} {shape}: {out.shape[0]} finite logits "
              f"(no bag sum on this path)", flush=True)
        return
    before = [k.launches for k in bags]
    with mock.patch.object(recsys, "embedding_bag", embedding_bag_ref):
        want = run()
    if [k.launches for k in bags] != before:
        raise AssertionError("the plain-bag forward launched a bag kernel")
    diff = (out - want).abs()
    err = float(diff.max())
    if not bool((diff <= RECSYS_TOL + RECSYS_TOL * want.abs()).all()):
        raise AssertionError(f"{arch_id} {shape}: kernel bag != plain bag "
                             f"({err})")
    print(f"[recsys] {arch_id} {shape}: kernel-path forward against the plain "
          f"bag: max |dlogit| {err:.3g} over {out.shape[0]} logits (tol "
          f"{RECSYS_TOL} + {RECSYS_TOL}|logit|; logits up to "
          f"{float(want.abs().max()):.3g})", flush=True)


def bert4rec_check(shape, out, params, cfg, seq, n_cand, recsys, dev):
    """A finite, sorted top 100; for retrieval, ``retrieval_topk``'s
    scores against the top 100 of ``bert4rec_score_items`` over the same
    candidates (the same dot products, as a matrix-vector and as a
    vector-matrix product: within 1e-5 + 1e-5|score|)."""
    import torch

    vals, _ = out
    if not (bool(torch.isfinite(vals).all()) and vals.shape[-1] == 100
            and bool((vals[..., :-1] >= vals[..., 1:]).all())):
        raise AssertionError(f"bert4rec {shape}: top-100 not finite or sorted")
    note = ""
    if shape == "retrieval_cand":
        h = recsys.bert4rec_forward(params, seq, cfg, device=dev)
        scores = recsys.bert4rec_score_items(params, h[:, -1], cfg)[0, :n_cand]
        want = torch.topk(scores, 100).values
        diff = (vals - want).abs()
        if not bool((diff <= 1e-5 + 1e-5 * want.abs()).all()):
            raise AssertionError("bert4rec retrieval: retrieval_topk != "
                                 "bert4rec_score_items top-k")
        note = (f"; against bert4rec_score_items' top 100: max |d| "
                f"{float(diff.max()):.3g}")
        if dev.type == "cuda":      # the tie-breaking's cost, warm L2
            user, cand = h[0, -1], params["item_embed"][:n_cand]
            _, idx = out
            order = torch.sort(cand @ user, descending=True, stable=True)[1]
            if not torch.equal(idx, order[:100]):
                raise AssertionError("bert4rec retrieval: indices differ from "
                                     "a stable descending sort's")
            ms = time_warm(lambda: recsys.retrieval_topk(user, cand, k=100))
            topk_ms = time_warm(lambda: torch.topk(cand @ user, 100))
            note += (f"; indices equal a stable sort's (ties lower index "
                     f"first); retrieval_topk {ms:.6f} ms against "
                     f"torch.topk on the same scores {topk_ms:.6f} ms "
                     f"(CUDA events, warm L2, {n_cand} candidates)")
    print(f"[recsys] bert4rec {shape}: top-100 finite and sorted, scores "
          f"{float(vals.min()):.4g}..{float(vals.max()):.4g}{note}", flush=True)


def decode_both_ways(params, token, cache, pos, cfg, plain_cfg, dev, reps=3):
    """One decode step at ``pos`` from two copies of ``cache``: through
    the decode kernel (``cfg``) and through the plain einsums
    (``plain_cfg``), in turns (kernel, plain, plain, kernel, ...); prints
    max |dlogit|, argmax agreement and the median ms per step of each.
    Every run after the first rewrites the same cache row with the same
    values, so each copy sees the same step every time."""
    import statistics

    import torch

    from repro_torch.models.transformer import decode_step

    paths = {"kernel": cfg, "plain": plain_cfg}
    copies = {name: {f: c.clone() for f, c in cache.items()} for name in paths}
    logits, times = {}, {name: [] for name in paths}
    order = ["kernel", "plain"]
    for _ in range(reps):
        for name in order:
            t0 = time.perf_counter()
            out, _ = decode_step(params, token, copies[name], pos, paths[name],
                                 device=dev)
            sync(dev)
            times[name].append((time.perf_counter() - t0) * 1e3)
            logits.setdefault(name, out)
        order.reverse()
    got, want = logits["kernel"], logits["plain"]
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("decode kernel path: logits are not finite")
    for f in ("k", "v"):
        if not torch.equal(copies["kernel"][f][0], copies["plain"][f][0]):
            raise AssertionError("decode paths wrote layer 0's cache apart")
    print(f"[lm] decode step at pos {pos.tolist()}, kernel against plain "
          f"einsums from copies of one cache: max |dlogit| "
          f"{float((got - want).abs().max()):.4g} over {got.numel()} logits, "
          f"argmax agrees on {int((got.argmax(-1) == want.argmax(-1)).sum())} "
          f"of {got.shape[0]}; median ms/step kernel "
          f"{statistics.median(times['kernel']):.2f}, plain "
          f"{statistics.median(times['plain']):.2f} ({reps} runs each, in turns)",
          flush=True)
    del copies


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
    # CUDA names a template kernel "void name_kernel<T>(...)"
    kern = [v for k, v in per_name.items() if kernel in k]
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
    floor = launch_floor_ms(dev, flush)
    print(f"[kernel] launch floor: one launch of a one-element add_ "
          f"{floor:.6f} ms (cold L2, as the rows below)", flush=True)
    rows = kernel_phase(dev, flush, floor)
    whole_launches, whole_rows = whole_index_phase(dev, flush, floor=floor)
    for name in ("block_scan_tile", "block_scan_static"):
        if whole_launches[name] <= 0:
            raise AssertionError(f"the whole-index path launched no {name}")
    flash_rows = flash_phase(dev, flush)
    decode_rows = decode_phase(dev, flush, floor)
    bag_rows = bag_phase(dev, flush)
    del flush
    torch.cuda.empty_cache()

    cfg = serve_config()
    print(f"[serve] depth cut: {N_BLOCKS} index blocks instead of "
          f"{FULL_BLOCKS} ({N_BLOCKS * BLOCK_DOCS} docs instead of "
          f"{FULL_BLOCKS * BLOCK_DOCS}); all widths as configured; rule "
          f"quotas scaled du x{RULE_DU_SCALE}, dv x{RULE_DV_SCALE} so that "
          f"rules span several chunks (one batch at x1 follows)", flush=True)
    launches, sys_ = serve_phase(dev, cfg)
    if launches["block_scan_pruned_chunk"] <= 0:
        raise AssertionError("the serve path launched no block_scan kernel")
    train_launches, trained = train_phase(dev, sys_)
    if train_launches["block_scan_pruned_chunk"] <= 0:
        raise AssertionError("the training path launched no block_scan kernel")
    engine_launches = engine_phase(dev, sys_, trained)
    if engine_launches["block_scan_pruned_chunk"] <= 0:
        raise AssertionError("the engine launched no block_scan kernel")
    cluster_launches = cluster_phase(dev, sys_, trained)
    if cluster_launches["block_scan_pruned_chunk"] <= 0:
        raise AssertionError("the cluster launched no block_scan kernel")
    del sys_, trained
    torch.cuda.empty_cache()
    live_launches = live_phase(dev, cfg)
    if live_launches["block_scan_pruned_chunk"] <= 0:
        raise AssertionError("the live fleet launched no block_scan kernel")
    torch.cuda.empty_cache()

    lm_launches = lm_phase(dev)
    torch.cuda.empty_cache()
    fp32_launches = lm_fp32_route(dev)
    torch.cuda.empty_cache()
    recsys_launches = recsys_phase(dev)
    for name in ("embedding_bag", "embedding_bag_lanes"):
        if recsys_launches[name] <= 0:
            raise AssertionError(f"the recsys path launched no {name} kernel")
    print(f"[recsys] main path launches: {recsys_launches}", flush=True)

    def row(name, source, replaces, n, r, err):
        return dict(name=name, route="cuda", source=f"src/repro_torch/csrc/{source}",
                    replaces=replaces, launches=n, max_abs_err=err, ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r.get("library_ms"))

    def worst(rs):
        return max(r["max_abs_err"] for r in rs.values())

    def flash_route_rows(route):
        return {n: r for n, r in flash_rows.items() if r["route"] == route}

    kernels = [
        row("block_scan_pruned_chunk", "block_scan.cu",
            "src/repro/kernels/block_scan/block_scan_pruned.py:222",
            launches["block_scan_pruned_chunk"],
            rows[4], worst(rows)),      # C=4: the serve path's chunk
        # (its "train_launches", "engine_launches", "cluster_launches"
        # and "live_launches" keys are added below)
        row("block_scan_tile", "block_scan_tile.cu",
            "src/repro/kernels/block_scan/block_scan.py:65",
            whole_launches["block_scan_tile"], whole_rows[("batched", "deep")],
            whole_rows[("batched", "deep")]["max_abs_err"]),
        row("block_scan_static", "block_scan_static.cu",
            "src/repro/kernels/block_scan/block_scan_pruned.py:92",
            whole_launches["block_scan_static"],
            whole_rows[("static", "deep")],
            whole_rows[("static", "deep")]["max_abs_err"]),
        row("flash_attention", "flash_attention.cu",
            "src/repro/kernels/flash_attention/flash_attention.py:87",
            fp32_launches["flash_attention"], flash_rows["path_fp32"],
            worst(flash_route_rows("flash_attention"))),
        row("flash_attention_tc", "flash_attention_tc.cu",
            "src/repro/kernels/flash_attention/flash_attention.py:87",
            lm_launches["flash_attention_tc"], flash_rows["path"],
            worst(flash_route_rows("flash_attention_tc"))),
        row("decode_attention", "decode_attention.cu",
            "src/repro/kernels/decode_attention/decode_attention.py:74",
            fp32_launches["decode_attention"], decode_rows["path_fp32"],
            max([r["max_abs_err"] for r in decode_rows.values()
                 if r.get("route") == "decode_attention"]
                + [r["cuda_core"]["max_abs_err"] for r in decode_rows.values()
                   if "cuda_core" in r])),
        row("decode_attention_tc", "decode_attention_tc.cu",
            "src/repro/kernels/decode_attention/decode_attention.py:74",
            lm_launches["decode_attention_tc"], decode_rows["path"],
            max(r["max_abs_err"] for r in decode_rows.values()
                if r.get("route") == "decode_attention_tc")),
        row("embedding_bag", "embedding_bag.cu",
            "src/repro/kernels/embedding_bag/embedding_bag.py:48",
            recsys_launches["embedding_bag"], bag_rows["wd_bulk"],
            max(r["max_abs_err"] for r in bag_rows.values()
                if r["kernel"] == "embedding_bag")),
        row("embedding_bag_lanes", "embedding_bag.cu",
            "src/repro/kernels/embedding_bag/embedding_bag.py:48",
            recsys_launches["embedding_bag_lanes"], bag_rows["wd_p99"],
            max(r["max_abs_err"] for r in bag_rows.values()
                if r["kernel"] == "embedding_bag_lanes"))]
    kernels[0]["train_launches"] = train_launches["block_scan_pruned_chunk"]
    kernels[0]["engine_launches"] = engine_launches["block_scan_pruned_chunk"]
    kernels[0]["cluster_launches"] = cluster_launches["block_scan_pruned_chunk"]
    kernels[0]["live_launches"] = live_launches["block_scan_pruned_chunk"]
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
