#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and check them.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Print the card's name and power limit; build the ten CUDA kernels
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
   Grok-1's (phase 4b: Hq=48, group 6, otherwise the same), at
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
   also under two other split plans) and at Grok-1's (phase 4b: Hq=48,
   group 6, otherwise the same), phase 4's fp32-route launch
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
   2,048 delta docs.  Warmup, then with the counts set to 0: 4
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
   ids, each replica's ``batch_inputs``/``execute`` means, and
   the occupancy build at capacity beside the static build of the same
   base; then ``launch/live_index.py --smoke`` runs as a subprocess on
   the card and must exit 0.
3f. Serve through worker processes: phase 3e's live system (its fleet
   and daemon stopped; the head at generation >= 2) behind a
   ``ReplicaSet(backend="process")`` of 2 workers with 3c's engines on
   ``block_scan``, tracing on, the cell dir in a temporary directory,
   the production plans published as v1; every worker spawned before
   the first is waited on, each warmed right after its spawn.  With the
   counts set to 0 (the parent's and, over the control pipe, the
   workers'): 2 freshness ticks (each commit relayed as an epoch with
   the queries it appended), each followed by a wave of 256 (70% fresh);
   a relayed v2 and a wave of 256; 64 tickets submitted one at a time,
   a SIGKILL of worker 0 with them in flight, its respawn, and a last
   wave of 256; the counts are read.  Checks: no shed and nothing
   dropped (no ``replica_error``), two distinct worker pids, neither
   the parent's, both on the card with chunk launches > 0 and none in
   the parent, a worker serving generation >= 2 from a merged
   generation's dir, the respawned pid new and a ``worker_dead``
   postmortem bundle, no private-dirty page in the workers' mappings of
   the cell and the generations, every response bit-equal to a
   ``reference`` rollout at its epoch, level and policy version, and the
   merged trace through ``tools/check_trace.py --require-proc-chain``.
   Prints spawn-to-ready seconds per worker and the respawn's,
   queries/s and ticket p50/p99 (and before the kill), each worker's
   ``batch_inputs``/``execute`` means beside phases 3d's and 3e's
   thread replicas, an A/B of one cold wave through the process cell
   and a 2-replica thread cell on the same system, epoch and version (4
   pairs in alternating order, responses equal), the clock offsets and
   RTTs, Rss/Pss of the mapped files per worker, and the launches; then
   ``launch/cluster.py --smoke --replica-backend process`` runs as a
   subprocess on the card, its trace through ``check_trace.py
   --require-proc-chain``, each required to exit 0.
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
4b. MoE and MLA LM serve, phase 4's traffic through the same entry
   points.  DeepSeek-V2-Lite-16B at full width and depth (27 layers,
   d_model 2048, MLA with kv_lora_rank 512, 64 experts top-6 + 2 shared,
   vocab 102400, bf16; its path runs no kernel, as the reference's runs
   no Pallas kernel for MLA or MoE): between a reset and a read of the
   counts (all 0), a prefill of B=2 x 8192 and 16 greedy decode steps;
   (a) every logits finite and (2, vocab); a profiled decode step; (e)
   layer 0's absorbed MLA decode against attention over K/V
   materialised from the c cache (fp32, 1e-4); a second prefill, timed,
   (b) its logits bit-equal to the first's; a profiled prefill; one
   more with the routing recorded (layer 0's least and most tokens per
   expert, drops per layer); (c) at S = 1023 with a capacity of at
   least T, decode for token S from prefill(S)'s cache against
   prefill(S + 1): each layer on the same input within 2e-2 relative
   L2 (bf16), and on a full-width 8-layer fp32 copy each layer within
   1e-4 and the logits end to end (1e-4, argmax equal); (d) layer 0's
   MoE FFN on 64 tokens against every expert on every token (fp32,
   1e-4).  Then Grok-1-314B at full width (d_model 6144, GQA 48:8,
   d_head 128, 8 experts top-2, d_ff 32768, vocab 131072, bf16) cut to
   4 of its 64 layers (633 GB in bf16), ``use_flash=True``: the same
   traffic with one tensor-core flash launch per layer per prefill and
   one tensor-core decode launch per layer per step (none on the CUDA
   cores); each layer's attention in one decode step through the
   kernel and the plain einsums on the same input and copies of its
   cache, row by row within 1e-2 relative L2 (out x 0.9 must fail);
   the whole step both ways (max |dlogit|, ms per step); a profiled
   decode step; a second prefill, timed, and a profiled one; the
   routing; layer 0's flash attention against plain within 2e-2.
4c. LM train (``launch/steps.py``: loss, microbatched gradients, clip,
   in-place AdamW; the plain attention, as the reference trains: no
   kernel runs, the counts read 0): (a) starcoder2-3b at full width and
   depth (30 layers, d_model 3072, GQA 24:2, d_head 128, d_ff 12288,
   vocab 49152), bf16 with bf16 moments, microbatch 4 accumulated in
   float32, remat, batch 8 x 4096 (cut from ``train_4k``'s 256 x 4096):
   3 steps on one batch (the loss finite and falling), 2 timed steps on
   fresh batches (ms, tokens/s, peak memory, 6 N D over time against the
   bf16 peak), one profiled step; (c) DeepSeek-V2-Lite at full width,
   4 of its 27 layers (16 B parameters with AdamW state do not fit the
   card), the same traffic: two steps from copies of one state
   bit-equal (parameters, moments, loss), the loss falling over 3 steps
   on one batch, 2 timed steps, drops per layer, peak memory; (d)
   ``launch/train.py lm --arch starcoder2-3b --steps 40`` on the card
   with ``--inject-failure`` and without: one restart, the loss falls,
   the final state bit-equal; then (b) the same starcoder2-3b at full
   width cut to 2 layers, fp32, 2 x 256 in 2 microbatches, one step on
   the card and one on the CPU: loss, grad norm and every gradient leaf
   within 1e-4 (relative L2 for the leaves).
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
5b. Recsys train (``build_cell(arch, "train_batch").fn``: loss,
   gradients, AdamW; the bag's backward is plain torch in a fixed
   order): Wide&Deep and DeepFM at full config and 65,536, one loss and
   gradient through the bag kernel and one through the plain bag on one
   state (one column-route launch in the forward, none in the backward;
   the loss within 1e-5 + 1e-5|loss|, the ``wide`` / ``first_order``
   gradient within 1e-5 + 1e-5|g|, every leaf within 1e-4 relative L2);
   then, between a reset and a read of the counts, each of the four
   archs at its full config (the CTR labels a function of the ids: 1
   where more than half are odd) (BERT4Rec's batch cut to 4,096: its fp32
   scores at 65,536 would be 21 GB a layer) takes 3 steps on one batch:
   the loss finite and falling, ms/step, one bag launch a step for the
   two archs with a bag.
6. The websearch-rl cells at full width and depth
   (``build_cell("websearch-rl", ...).fn``: 256 queries x 4096 blocks x
   4096 docs, the block_scan backend) on synthetic inputs seeded on the
   card, not the corpus's (occupancy 8.59 GB with each (query, term,
   field) plane at bit density 2^-k, k uniform in [3, 13]; 2-4 present
   terms; normal scores, 17.18 GB; a seeded q table; geometric bin
   edges).  With the counts set to 0: ``serve_queries`` 3 times (ms per
   call, median, queries/s; mean u, blocks scanned and cand_cnt; chunk
   launches a call; peak memory; one call profiled), its first 8
   queries through the ``reference`` backend on the same tensors (cand,
   u, cand_cnt bit-equal); ``rl_rollout`` 3 times from one q and one
   set of draws (ε 0.1): ms/step, q_new and metrics bit-equal; the
   counts read.
7. The four graphsage-reddit cells at their published shapes
   (``build_cell("graphsage-reddit", ...).fn``; the mean aggregation
   through the segment gather-sum kernel, its gradient through the same
   kernel over the transposed CSR) on seeded synthetic graphs:
   full_graph_sm (2,708 nodes, 10,556 edges, d 1433), minibatch_lg
   (232,965 nodes, 114,615,892 edges in a CSR built on the host, the
   port's ``sample_blocks`` from 1,024 seeds at fanout 15-10, blocks
   padded to the cell's budgets: 180,224 frontier rows, d 602),
   ogb_products (2,449,029 nodes, 61,859,140 edges, d 100) and molecule
   (128 graphs of 30 nodes and 64 edges); in-degrees skewed (the
   largest ~200x the mean) but the molecules'; labels a function of the
   features.  First, uncounted: the kernel against its plain version at
   every cell's aggregate shapes (ogb_products on its first 8 M edges,
   so that the plain (E, d) fits): each element within 1e-5 of its sum
   of absolute values, empty segments 0, a x0.9 planted on one segment
   rejected, and the gradient through the kernel against the plain one
   the same way; a reduced step card vs CPU
   (1e-4); the kernel cold at ogb_products' layer 0 beside its bound,
   the plain version and ``F.embedding_bag``.  Then, with the counts set
   to 0: each cell 3 steps on one batch (the loss falling) and 2 timed
   (ms/step, edges/s, peak memory), its launches a step against a count
   written down before the run; two ogb_products runs of 2 steps from
   one seed bit-equal; a profiled ogb_products step (busy, idle, the
   kernel's share and the sorts'); the counts read.
8. The mesh: a one-rank NCCL world (a ``FileStore`` rendezvous in a
   temporary directory) and a 1 x 1 ``make_local_mesh`` on the card;
   NCCL's version and the card line printed.  At world size 1 every
   collective is an identity (multi-card NCCL, the TP regime and the
   cost of collectives are not measured).  Each check computes the
   unsharded result first, uncounted, then runs the sharded path
   between a reset and a read of the counts: websearch-rl's
   ``serve_queries`` and ``rl_rollout`` through the sharded
   ``build_cell`` at full width (256 queries x 4096 blocks, phase 6's
   synthetic inputs placed as DTensors): cand, u, cand_cnt, q_new and
   the metrics bit-equal to the unsharded cells', chunk launches > 0;
   Wide&Deep at its full config, ``serve_bulk`` (262,144) and one
   ``train_batch`` step (65,536) through the sharded cells from one
   state: logits within 1e-5 + 1e-5|x|, the loss and every leaf within
   1e-4 relative L2, bag launches > 0; ``moe_ffn_sharded`` at
   DeepSeek-V2-Lite's FFN widths (64 experts, top-6, d 2048, ff 1408, 2
   shared) on 4,096 float32 tokens against ``moe_ffn``: within 1e-5.
   Each call's ms printed beside the unsharded one's.
8b. In the same one-rank world, the LM's and the GNN's mesh paths, each
   unsharded call first (uncounted), then the sharded one between a
   reset and a read of the counts: mistral-nemo-12b at full width, 4 of
   40 layers, bf16, ``use_flash``: the sharded ``prefill_32k`` cell at
   2 x 8192 against ``prefill`` (layer-0 attention through the
   tensor-parallel path and the caches within 2e-2 + 2e-2|x|, the
   logits' argmax equal), 8 greedy steps of the sharded ``decode_32k``
   cell through the sequence-sharded cache against ``decode_step``
   (each step's logits within the same, argmax equal), one tensor-core
   flash launch a layer and one tensor-core decode launch a layer a
   step; DeepSeek-V2-Lite at full width, 4 of 27 layers: one sharded
   ``train_4k`` step (phase 4c's 8 x 4096, 4 microbatches, remat,
   ``sp_carry``) against the unsharded step from one state: the loss
   and the grad norm within 1e-4, every parameter and moment leaf within
   2e-2 relative L2 (bf16 roundings in another order, see
   MESH_BF16_STEP_TOL), and a float32 copy at 2 layers: the loss and
   every gradient leaf within 1e-4; graphsage-reddit ``ogb_products`` on phase 7's batch and
   state: the edge-sharded aggregate within 1e-5 of its sum of |x|, one
   sharded step against the unsharded one (loss and every leaf within
   1e-4 relative L2), 3 segment-gather launches a step.
9. The dry run's counts against the card (``launch/dryrun.py``'s
   counters, ``launch/roofline.py``'s terms): (a) one bf16 8192^3
   ``torch.matmul`` counts 2 x 8192^3 FLOPs and 3 x 8192^2 x 2 bytes on
   meta and on the card alike, and its time (CUDA events, 10 reps, L2
   flushed) stands beside ``roofline_terms``' compute term; (b)
   mistral-nemo-12b's sharded ``prefill_32k`` at phase 8b's cut (full
   width, 4 layers, 2 x 8192, bf16, ``use_flash``) on a one-rank NCCL
   mesh: the dry run of the same call (``python -m
   repro_torch.launch.dryrun ... --mesh 1x1`` in a subprocess under a
   fake group, since NCCL takes no meta tensor and a process has one
   default group) and the same counters around the card's call give
   equal FLOPs, bytes, transcendentals and collective counts, and the
   flash kernel's 4 launches the same cost; (c) one ``ogb_products``
   step (phase 7's batch and state) held the same way, its 3
   segment-gather launches included.  Each measured time against
   ``analyze_cell``'s terms of the meta record (bound, ``roofline_frac``,
   measured / largest term); none may lie below its largest term less
   5%: no card beats its own roofline, so the count would be wrong.
10. The examples, ``examples/*_torch.py``, at the reference examples'
   sizes, seeds and iteration counts: quickstart, train_policy,
   serve_retrieval and online_learning each through its ``main`` in
   this process on the card, between a reset and a read of the counts
   (each must launch the chunk kernel; each asserts its own checks,
   online_learning its three properties); each prints its JSON numbers
   (mean u, candidates, NCG; Δu %, ΔNCG %; versions, recalls), its wall
   seconds and its chunk launches.  Then ``python
   examples/quickstart_torch.py`` and ``python
   examples/train_lm_torch.py`` (the starcoder2-3b reduced LM, 60 steps
   with an injected failure) as a user runs them, from the repo root:
   each must end rc 0.
11. Print the kernels' JSON line (the chunk kernel's row also carries
   the training path's launches, ``train_launches``, the engine
   stream's, ``engine_launches``, the cluster stream's,
   ``cluster_launches``, the live fleet's, ``live_launches``, the
   process cell's workers', ``proc_launches``, phase 6's,
   ``websearch_launches``, phase 8's, ``mesh_launches``, and phase
   10's, ``examples_launches``, summed over the four examples; the
   tensor-core flash and decode rows also Grok-1's,
   ``moe_lm_launches``; the column bag row 5b's, ``train_launches``;
   both bag rows phase 8's, ``mesh_launches``; the tensor-core flash and
   decode rows and the segment gather row phase 8b's, ``mesh_launches``;
   the segment gather row, which replaces no TPU kernel, phase 7's), the
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
    each), the recsys path's embedding bag (both E = 1 routes; the
    column kernel also takes E > 1) and the GNN's segment gather-sum."""
    from repro_torch.kernels.block_scan import (BLOCK_SCAN_KERNEL,
                                                BLOCK_SCAN_STATIC_KERNEL,
                                                BLOCK_SCAN_TILE_KERNEL)
    from repro_torch.kernels.decode_attention import (
        DECODE_ATTENTION_KERNEL, DECODE_ATTENTION_TC_KERNEL)
    from repro_torch.kernels.embedding_bag import (EMBEDDING_BAG_KERNEL,
                                                   EMBEDDING_BAG_LANES_KERNEL)
    from repro_torch.kernels.flash_attention import (FLASH_ATTENTION_KERNEL,
                                                     FLASH_ATTENTION_TC_KERNEL)
    from repro_torch.kernels.segment_gather import SEGMENT_GATHER_KERNEL

    return [BLOCK_SCAN_KERNEL, BLOCK_SCAN_TILE_KERNEL,
            BLOCK_SCAN_STATIC_KERNEL, FLASH_ATTENTION_KERNEL,
            FLASH_ATTENTION_TC_KERNEL, DECODE_ATTENTION_KERNEL,
            DECODE_ATTENTION_TC_KERNEL, EMBEDDING_BAG_KERNEL,
            EMBEDDING_BAG_LANES_KERNEL, SEGMENT_GATHER_KERNEL]


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


def block_scan_bound_ms(n_active, bp, nb, chunk, w, meta_cols, n_terms):
    """Least time for one launch: the bytes of its cost (the wrapper's
    ``chunk_cost``: the active planes' words of each lane's DISTINCT
    blocks read once -- chunk positions clamped to block nb-1 reread
    that block --, the meta read once, the outputs written once) over
    the memory rate, against its 32-bit operations over the op rate.
    Returns (ms, what bounds it, bytes)."""
    from repro_torch.kernels.block_scan.block_scan_pruned import chunk_cost

    c = chunk_cost(n_active, bp, nb, chunk, w, meta_cols, n_terms)
    t_bytes = c.bytes / HBM_BYTES_PER_S * 1e3
    t_ops = c.flops / INT32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", c.bytes)


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
                                                     w, meta.shape[2], t)
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
# (name, B, Hq, Hkv, Sq, Skv, D, causal, dtype): "path" is Mistral-NeMo's
# prefill (phase 4), "grok" Grok-1's (phase 4b: group 6).
FLASH_CASES = [
    ("path", LM_BATCH, 32, 8, LM_PROMPT, LM_PROMPT, 128, True, "bfloat16"),
    ("grok", LM_BATCH, 48, 8, LM_PROMPT, LM_PROMPT, 128, True, "bfloat16"),
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
    """Least time for one launch: the FLOPs of its cost (the wrapper's
    ``cost``: QK^T and PV over the (query, key) pairs the mask leaves
    visible, 2 per multiply-add) over the rate for its type (bf16
    tensor cores; fp32 outside them, as TF32 would not keep fp32's
    precision), against q, k, v read once and o written once over the
    memory rate."""
    import torch

    from repro_torch.kernels.flash_attention.ops import cost

    c = cost(b, hq, hkv, sq, skv, d, causal, getattr(torch, dtype))
    rate = BF16_FLOPS_PER_S if dtype == "bfloat16" else FP32_FLOPS_PER_S
    t_ops = c.flops / rate * 1e3
    t_bytes = c.bytes / HBM_BYTES_PER_S * 1e3
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

        reps = 3 if name in ("path", "grok", "path32k") else 20
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
# the launch, set the time; a measurement row, not a path), and Grok-1's
# decode path's first step (phase 4b: group 6).
DECODE_CASES = [
    ("path", LM_BATCH, 32, 8, LM_PROMPT + LM_DECODE_STEPS, 128, "bfloat16",
     [LM_PROMPT + 1] * LM_BATCH, True),
    ("grok", LM_BATCH, 48, 8, LM_PROMPT + LM_DECODE_STEPS, 128, "bfloat16",
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
    """Least time for one launch: the bytes of its cost (the wrapper's
    ``cost``: q read, the K and V rows below each sequence's kv_len read
    once, out, m and l written once) over the memory rate, against QK^T
    and PV over those keys (2 FLOPs per multiply-add) over the rate for
    the type."""
    import torch

    from repro_torch.kernels.decode_attention.ops import cost

    c = cost(b, hq, hkv, d, sum(lens), getattr(torch, dtype))
    rate = BF16_FLOPS_PER_S if dtype == "bfloat16" else FP32_FLOPS_PER_S
    t_bytes = c.bytes / HBM_BYTES_PER_S * 1e3
    t_ops = c.flops / rate * 1e3
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
    """Least time for one launch: the bytes of its cost (the wrapper's
    ``cost``: every 32-byte sector of the table that an index inside the
    table touches, read once -- a random row read moves at least one
    sector; rows that share a sector share its read --, the indices and
    weights read once and the output written once) over the memory
    rate; against one multiply-add per (index, column) over the fp32
    rate."""
    from repro_torch.kernels.embedding_bag.ops import cost, table_sectors

    c = cost(table, idx, weighted)
    t_bytes = c.bytes / HBM_BYTES_PER_S * 1e3
    t_ops = c.flops / FP32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"),
            table_sectors(table, idx)[0])


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
# Per thread replica, (batch_inputs, execute) means in ms of phases 3d
# and 3e: phase 3f prints its workers' beside them.
THREAD_MEANS = {}


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
        THREAD_MEANS.setdefault("3d", []).append(
            (np.mean([b['t_inputs_s'] for b in rows]) * 1e3,
             np.mean([b['t_execute_s'] for b in rows]) * 1e3))
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
LIVE_TICKS = 4                         # 4,096 new docs cross the 2,048 of
LIVE_DOCS_PER_TICK = 1024              # LIVE_MERGE_MIN_DOCS twice: 2 merges
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


def check_live_against_reference(sys_, store, epochs, responses, snaps=None):
    """Every response bit-equal (doc_ids, scores, u, cand_cnt,
    policy_version, level) to a ``reference``-backend rollout of its
    query at the response's own pinned index epoch and level, under the
    policy of its category in the snapshot of its version (``snaps``:
    version -> snapshot; the store's head when None); returns the
    number of reference rollouts."""
    import numpy as np

    from repro_torch.serving import ServiceLevel, ShardedExecutor

    exe = ShardedExecutor(sys_, n_shards=1, backend="reference")
    head = store.snapshot()
    groups = {}
    for r in responses:
        version = r.policy_version if snaps is not None else head.version
        groups.setdefault((r.index_epoch, int(r.level), r.category, version),
                          []).append(r)
    n_ref = 0
    for (epoch, level, cat, version), rs in sorted(groups.items()):
        snap = snaps[version] if snaps is not None else head
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
    kernels' launch counts of the serving run, the live system and its
    storage directory (phase 3f serves that system next)."""
    import tempfile

    import numpy as np

    from repro_torch.cluster import ClusterConfig, ReplicaSet, Shed
    from repro_torch.data.freshness import FreshnessConfig, FreshnessWorkload
    from repro_torch.index.builder import batch_query_occupancy
    from repro_torch.index.live import (LiveRetrievalSystem, MergeConfig,
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
        THREAD_MEANS.setdefault("3e", []).append(
            (np.mean([b['t_inputs_s'] for b in rows]) * 1e3,
             np.mean([b['t_execute_s'] for b in rows]) * 1e3))
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
    live_cli(dev)
    print(f"[live] phase 3e in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches, sys_, storage


# ------------------------------------------------------------ phase 3f
# Serve through worker processes: phase 3e's live system behind a
# 2-worker process cell (the reference's GIL-free deployment: one
# mmapped index, replicas that survive a crash), 3c's engines in each
# worker, tracing on, production plans as v1.
PROC_REPLICAS = 2
PROC_TICKS = 2
PROC_WAVE = 256                        # the serve cell's query batch
PROC_KILL_INFLIGHT = 64
PROC_AB_PAIRS = 4          # process/thread pairs of one cold wave each


def proc_cli(dev):
    """``launch/cluster.py --smoke --replica-backend process`` as a
    subprocess on ``dev`` (the port's proc-smoke and the process half of
    trace-smoke), its trace through ``tools/check_trace.py
    --require-proc-chain``; raises on any non-zero exit."""
    import os

    out = ROOT / "results"
    files = {k: str(out / f"proc_cli_{k}_torch.json")
             for k in ("trace", "metrics", "out")}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmds = [
        [sys.executable, "-m", "repro_torch.launch.cluster", "--smoke",
         "--replica-backend", "process", "--device", dev.type,
         "--trace-out", files["trace"], "--metrics-json", files["metrics"],
         "--out", files["out"]],
        [sys.executable, str(ROOT / "tools" / "check_trace.py"),
         files["trace"], "--require-proc-chain", "--metrics",
         files["metrics"]]]
    for cmd in cmds:
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=600)
        name = Path(cmd[1]).name if cmd[1] != "-m" else cmd[2]
        for line in (res.stdout + res.stderr).strip().splitlines()[-6:]:
            print(f"[proc cli] {name}: {line}", flush=True)
        if res.returncode != 0:
            raise AssertionError(f"{name} exited {res.returncode}")
        print(f"[proc cli] {name}: rc 0 in {time.perf_counter() - t0:.1f} s",
              flush=True)


def ab_process_thread(sys_, store, cluster, workload):
    """The same wave of 256 through the process cell and through a
    2-replica thread cell on the same system, epoch and policy version,
    both caches cold (a publish before each pair retires every entry),
    in alternating order; per pair the wall of each, and the
    micro-batches' mean ``execute`` of each side over the pairs.  The
    two sides' responses must agree (ids, scores, u, candidates,
    versions).  Returns {"proc": [s...], "thread": [s...], "execute":
    {side: ms}}."""
    import numpy as np

    from repro_torch.cluster import ClusterConfig, ReplicaSet, Shed
    from repro_torch.serving import EngineConfig

    thread = ReplicaSet(sys_, store, ClusterConfig(n_replicas=PROC_REPLICAS),
                        EngineConfig(backend="block_scan", **ENGINE_CFG))
    thread.warmup()
    cells = {"proc": cluster, "thread": thread}
    walls = {"proc": [], "thread": []}

    def batch_sums():
        return [(s["n_timed_batches"], (s["t_execute_mean_s"] or 0.0)
                 * s["n_timed_batches"]) for s in cluster.stats()["replicas"]]

    with thread:
        before = batch_sums()
        for i in range(PROC_AB_PAIRS):
            store.publish(sys_.baseline_policies())
            deadline = time.perf_counter() + CLUSTER_TIMEOUT_S
            while (min(r.policy_version for r in cluster.replicas)
                   < store.version and time.perf_counter() < deadline):
                time.sleep(0.005)
            wave = workload.wave()
            got = {}
            for name in (("proc", "thread") if i % 2 == 0
                         else ("thread", "proc")):
                t0 = time.perf_counter()
                got[name] = [t.result() for t in serve_wave(cells[name], wave)]
                walls[name].append(time.perf_counter() - t0)
            for a, b in zip(got["proc"], got["thread"], strict=True):
                if isinstance(a, Shed) or isinstance(b, Shed) or not (
                        (a.qid, a.u, a.cand_cnt, a.policy_version,
                         a.index_epoch) == (b.qid, b.u, b.cand_cnt,
                                            b.policy_version, b.index_epoch)
                        and np.array_equal(a.doc_ids, b.doc_ids)
                        and np.array_equal(a.scores, b.scores)):
                    raise AssertionError(f"qid {a.qid}: the process and "
                                         "the thread cell disagree")
        after = batch_sums()
        rows = [b for r in thread.replicas for b in r.engine.telemetry.batches]
    n = sum(a[0] - b[0] for a, b in zip(after, before))
    t = sum(a[1] - b[1] for a, b in zip(after, before))
    return {**walls, "execute": {
        "proc": t / max(n, 1) * 1e3,
        "thread": float(np.mean([b["t_execute_s"] for b in rows])) * 1e3},
        "batches": {"proc": n, "thread": len(rows)}}


def proc_phase(dev, sys_, storage):
    """Phase 3f: serve phase 3e's live system through a 2-worker process
    cell — freshness ticks (each commit relayed as an epoch, with the
    queries it appended), a relayed policy publish, a SIGKILL of one
    worker with tickets in flight and its respawn — and check every
    response against a ``reference`` rollout at its epoch, level and
    version, the workers' devices, launches and base generation, the
    postmortem bundle and the merged cross-process trace; run the CLI
    smoke; returns the chunk kernel's launches inside the workers over
    the main path."""
    import json
    import os
    import signal
    import tempfile

    import numpy as np
    import torch

    from repro_torch.cluster import ClusterConfig, ReplicaSet, Shed
    from repro_torch.data.freshness import FreshnessConfig, FreshnessWorkload
    from repro_torch.launch.cluster import (_cell_mapping_stats,
                                            _smaps_counts_sharing)
    from repro_torch.obs import Tracer
    from repro_torch.policies import PolicyStore
    from repro_torch.serving import EngineConfig

    t_phase = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    cell = tempfile.TemporaryDirectory(prefix="proc-cell-")
    store = PolicyStore(staleness_bound=1)
    store.publish(sys_.baseline_policies(), fallbacks=sys_.fallback_policies())
    snaps, epochs = {}, {}
    unsub_p = store.subscribe(lambda sn: snaps.setdefault(sn.version, sn))
    unsub_e = sys_.live.store.subscribe(
        lambda e: epochs.setdefault(e.version, e))
    workload = FreshnessWorkload(sys_, FreshnessConfig(
        docs_per_tick=LIVE_DOCS_PER_TICK, wave_queries=PROC_WAVE,
        frac_fresh=LIVE_FRAC_FRESH, static_rank_fresh=LIVE_STATIC_RANK_FRESH,
        seed=SEED + 29))
    tracer = Tracer()
    cluster = ReplicaSet(sys_, store, ClusterConfig(
        n_replicas=PROC_REPLICAS, backend="process",
        proc_storage_dir=cell.name),
        EngineConfig(backend="block_scan", **ENGINE_CFG), tracer=tracer)
    cluster.warmup()                  # each worker warms right after spawn
    gen0 = sys_.live.stats()["generation"]
    waves = []
    t0 = time.perf_counter()
    with cluster:
        t_ready = time.perf_counter() - t0
        cluster.kernel_launches(reset=True)   # answered after the warmups
        t_warm = time.perf_counter() - t0
        print(f"[proc] {PROC_REPLICAS} workers ready in {t_ready:.2f} s "
              f"(spawn to ready each: "
              f"{[round(r.spawn_seconds[0], 3) for r in cluster.replicas]} s), "
              f"warm in {t_warm:.2f} s; {ENGINE_CFG}, 'block_scan', "
              f"production plans v1; the live head at generation {gen0}, "
              f"epoch {sys_.index_epoch}, {sys_.log.n_queries} queries in "
              f"the log", flush=True)
        reset_counts()                # the main path: ticks, waves, a kill
        t0 = time.perf_counter()
        for _ in range(PROC_TICKS):
            waves.append(serve_wave(cluster, workload.tick()))
        store.publish(sys_.baseline_policies())           # v2, relayed
        waves.append(serve_wave(cluster, workload.wave()))
        t_before_kill = time.perf_counter() - t0
        victim = cluster.replicas[0]
        pid_before = victim.worker_pid
        # One ticket at a time (each with its own admit span, so that
        # the merged trace holds whole cross-process chains).
        inflight = [cluster.submit(int(q))
                    for q in workload.wave()[:PROC_KILL_INFLIGHT]]
        os.kill(pid_before, signal.SIGKILL)
        t_kill = time.perf_counter()
        for t in inflight:
            if t.result(timeout=CLUSTER_TIMEOUT_S) is None:
                raise AssertionError(f"qid {t.qid} lost in the kill")
        while (len(victim.spawn_seconds) < 2
               and time.perf_counter() - t_kill < CLUSTER_TIMEOUT_S):
            time.sleep(0.01)
        t_respawn = time.perf_counter() - t_kill
        waves.append(inflight)
        waves.append(serve_wave(cluster, workload.wave()))
        wall = time.perf_counter() - t0
        per_replica = [r.kernel_launches() for r in cluster.replicas]
        parent_launches = read_counts()
        stats = cluster.stats()
        summaries = stats["replicas"]
        pids = [s["worker_pid"] for s in summaries]
        maps = _cell_mapping_stats(pids, (cell.name, storage.name))
        sharing = _smaps_counts_sharing(cell.name)
        offsets = [r.clock_offset() for r in cluster.replicas]
        trace_path = ROOT / "results" / "proc_phase_trace_torch.json"
        trace_path.parent.mkdir(parents=True, exist_ok=True)
        n_entries = cluster.write_trace(trace_path)
        base_dir = str(Path(cell.name) / "base")
        ab = ab_process_thread(sys_, store, cluster, workload)
    unsub_p()
    unsub_e()
    proc_launches = sum(c.get("block_scan_pruned_chunk", 0)
                        for c in per_replica)

    # Checks: hazards first.
    tickets = [t for w in waves for t in w]
    results = [t.result() for t in tickets]
    err = [r for r in results
           if isinstance(r, Shed) and r.reason.startswith("replica_error")]
    if err:
        raise AssertionError(f"{len(err)} replica_error sheds: {err[:3]}")
    sheds = [r for r in results if isinstance(r, Shed)]
    if sheds or stats["n_submitted"] != len(tickets) or \
            stats["n_responses"] != len(tickets):
        raise AssertionError(f"{len(sheds)} sheds, {stats['n_submitted']} "
                             f"submitted, {stats['n_responses']} responses "
                             f"for {len(tickets)} tickets")
    if len(set(pids)) != PROC_REPLICAS or os.getpid() in pids:
        raise AssertionError(f"worker pids {pids}")
    if {s["device"] for s in summaries} != {str(dev)} and \
            {s["device"] for s in summaries} != {dev.type}:
        raise AssertionError(f"workers on {[s['device'] for s in summaries]}")
    if dev.type == "cuda" and not all(
            c.get("block_scan_pruned_chunk", 0) > 0 for c in per_replica):
        raise AssertionError(f"a worker launched no chunk kernel: "
                             f"{per_replica}")
    if any(v for v in parent_launches.values()):
        raise AssertionError(f"the parent launched kernels: {parent_launches}")
    if not any(s["index_generation"] >= 2 and s["index_gen_dir"]
               not in (None, base_dir) for s in summaries):
        raise AssertionError(f"no worker served at generation >= 2 from a "
                             f"merged generation: "
                             f"{[(s['index_generation'], s['index_gen_dir']) for s in summaries]}")
    if victim.worker_pid == pid_before or victim.n_restarts != 1:
        raise AssertionError(f"no respawn: pid {victim.worker_pid}, "
                             f"restarts {victim.n_restarts}")
    bundle = json.loads(Path(victim.last_bundle_path).read_text())
    if bundle["reason"] != "worker_dead" or bundle["worker_pid"] != pid_before:
        raise AssertionError(f"postmortem bundle {bundle['reason']}, "
                             f"pid {bundle['worker_pid']}")
    if maps["private_dirty_kb_total"] != 0 or not all(
            w["n_mappings"] > 0 for w in maps["workers"]):
        raise AssertionError(f"the cell's files are not mapped shared: {maps}")
    n_docs = sys_.live.n_docs
    for r in results:
        valid = r.doc_ids >= 0
        if not (np.isfinite(r.scores[valid]).all()
                and (r.doc_ids[valid] < n_docs).all()):
            raise AssertionError(f"qid {r.qid}: ids/scores out of range")
    t1 = time.perf_counter()
    n_ref = check_live_against_reference(sys_, store, epochs, results, snaps)
    t_ref = time.perf_counter() - t1
    chk = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "check_trace.py"),
         str(trace_path), "--require-proc-chain"],
        capture_output=True, text=True, timeout=300)
    print(f"[proc] check_trace: {chk.stdout.strip()[-400:]}", flush=True)
    if chk.returncode != 0:
        raise AssertionError(f"check_trace exited {chk.returncode}: "
                             f"{chk.stderr[-2000:]}")

    # Prints.
    n_arr = len(tickets)
    before = [t for w in waves[:PROC_TICKS + 1] for t in w]
    print(f"[proc] serve through {PROC_REPLICAS} worker processes: "
          f"{PROC_TICKS} freshness ticks of {LIVE_DOCS_PER_TICK} docs, a wave "
          f"of {PROC_WAVE} ({LIVE_FRAC_FRESH} fresh) after each, a relayed "
          f"v2 and a wave, {PROC_KILL_INFLIGHT} tickets across a SIGKILL, a "
          f"last wave: {n_arr} arrivals in {wall:.2f} s, "
          f"{n_arr / wall:.1f} queries/s ({len(before) / t_before_kill:.1f} "
          f"before the kill); ticket p50 {pct_ms(tickets, 50):.3f} ms, p99 "
          f"{pct_ms(tickets, 99):.3f} ms (before the kill: "
          f"{pct_ms(before, 50):.3f} / {pct_ms(before, 99):.3f} ms); hits "
          f"{sum(r.cached for r in results)}", flush=True)
    print(f"[proc] SIGKILL of worker {pid_before} with "
          f"{PROC_KILL_INFLIGHT} tickets in flight: every ticket answered and "
          f"the respawn ready {t_respawn:.2f} s after the kill (spawn to "
          f"ready {victim.spawn_seconds[1]:.3f} s), new pid "
          f"{victim.worker_pid}; postmortem bundle "
          f"{Path(victim.last_bundle_path).name} ({bundle['reason']}, "
          f"{len(bundle['trace_tail'])} trace entries)", flush=True)
    for i, s in enumerate(summaries):
        print(f"[proc] worker {i} (pid {s['worker_pid']}, {s['device']}, "
              f"restarts {s['n_restarts']}): {s['n_timed_batches']} "
              f"micro-batches, batch_inputs "
              f"{(s['t_inputs_mean_s'] or 0) * 1e3:.1f} ms, execute "
              f"{(s['t_execute_mean_s'] or 0) * 1e3:.1f} ms (means); "
              f"chunk launches {per_replica[i]}; scoring sub-batch "
              f"{s['scoring_batch_size']} queries; serves generation "
              f"{s['index_generation']} from {Path(s['index_gen_dir']).name}; "
              f"policy v{s['policy_version']}, epoch {s['index_epoch']}",
              flush=True)
    for phase, rows in sorted(THREAD_MEANS.items()):
        print(f"[proc] beside phase {phase}'s thread replicas: "
              + "; ".join(f"batch_inputs {a:.1f} ms, execute {b:.1f} ms"
                          for a, b in rows), flush=True)
    print(f"[proc] A/B, the same cold wave of {PROC_WAVE} on the same epoch "
          f"and version, {PROC_AB_PAIRS} pairs in alternating order: process "
          f"cell {[round(x, 3) for x in ab['proc']]} s, thread cell "
          f"{[round(x, 3) for x in ab['thread']]} s (medians "
          f"{np.median(ab['proc']):.3f} / {np.median(ab['thread']):.3f} s); "
          f"execute per micro-batch {ab['execute']['proc']:.1f} / "
          f"{ab['execute']['thread']:.1f} ms (means over "
          f"{ab['batches']['proc']} / {ab['batches']['thread']}); responses "
          f"equal", flush=True)
    print(f"[proc] clock offsets and RTTs (s): "
          f"{[(round(o, 6), round(rt, 6)) for o, rt in offsets]}", flush=True)
    print(f"[proc] mapped cell and generations per worker (kB): "
          + "; ".join(f"pid {w['pid']}: {w['n_mappings']} maps, Rss "
                      f"{w['rss_kb']}, Pss {w['pss_kb']}, private dirty "
                      f"{w['private_dirty_kb']}" for w in maps["workers"])
          + ("" if sharing else " (this host's smaps reports Pss = Rss for "
             "every shared page: the Pss of a shared mapping is not "
             "observable here)"), flush=True)
    print(f"[proc] proc_launches {proc_launches} (per replica {per_replica}; "
          f"the parent's {parent_launches}); {n_entries} trace entries merged; "
          f"every response ({len(results)}) bit-equal to a 'reference' "
          f"rollout at its epoch, level and version ({n_ref} reference "
          f"rollouts, {t_ref:.2f} s); epochs served "
          f"{sorted({r.index_epoch for r in results})}, versions "
          f"{sorted({r.policy_version for r in results})}", flush=True)
    cell.cleanup()
    proc_cli(dev)
    print(f"[proc] phase 3f in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return proc_launches


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


# ------------------------------------------------------------ phase 4b
# The MoE and MLA LMs (src/repro/configs/deepseek_v2_lite_16b.py,
# grok1_314b.py) through the same entry points, with phase 4's traffic.
MLA_ARCH, GQA_MOE_ARCH = "deepseek-v2-lite-16b", "grok-1-314b"
GROK_LAYERS = 4        # of 64: 316.5 B parameters are 633 GB in bf16
MOE_FP32_LAYERS = 8    # check (c) again on a full-width fp32 copy
# Check (c): decode_step for token S from prefill(S)'s cache against
# prefill(S + 1)'s last position.  S + 1 = 1024 splits into two query
# chunks of 512 (8193 would not split: the chunked attention raises).
DECODE_CHECK_PROMPT = 1023
# Check (c), layer by layer: each layer's decode output for token S
# (``layer_decode`` on prefill(S)'s cache) against its prefill output at
# position S (``layer_forward``), both given prefill(S + 1)'s input to
# that layer; relative L2 of the (B, d) outputs.  bf16 keeps 8
# significant bits (2**-9 relative a rounding), and the two paths round
# different intermediates of a layer: prefill the materialised per-head
# K/V and its (B*S)-row GEMM outputs, decode the absorbed W_uk/W_uv
# products (in fp32) and its B-row GEMM outputs, about ten roundings
# deep, so a few 2**-9, ~1e-2.  That catches gross faults (in a CPU
# rehearsal at the reduced widths a decode routed to the wrong experts
# gives 1.13, a RoPE position off by one 6e-2) but not every subtle one
# (the new c row written one row early: 1.6e-2, among 1,024 keys); the
# fp32 copy's 1e-4 catches those (1.2e-2 there), as only the summation
# order differs in fp32 (~1e-6).
MOE_LAYER_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# The logits end to end are held only in fp32: with random weights the
# bf16 model at full depth is chaotic (on an H100, scaling the
# embeddings by 1 + 2**-8 moves its logits by ~5, as much as decode
# against prefill, and its argmax), so bf16 logits carry no agreement
# to hold.
MOE_DENSE_TOKENS = 64  # check (d): tokens of layer 0's FFN input
MOE_CHECK_TOL = 1e-4   # checks (c) in fp32, (d) and (e): float32, order only


def routing_recorder(stats):
    """A stand-in for ``transformer.moe_ffn`` that appends each call's
    (tokens per expert (E,), assignments dropped past capacity, capacity)
    as device tensors, then runs the real one."""
    from repro_torch.models.moe import (build_dispatch, moe_capacity, moe_ffn,
                                        router_topk)

    def recording(params, x, cfg, capacity=None):
        cap = capacity or moe_capacity(cfg, x.shape[0])
        _, idx, _ = router_topk(params["router"], x, cfg.top_k)
        _, keep, counts = build_dispatch(idx, cfg.n_experts, cap)
        stats.append((counts, (~keep).sum(), cap))
        return moe_ffn(params, x, cfg, capacity)

    return recording


def moe_lm_serve(dev, cfg, name, batch, prompt, steps, flash_per_layer):
    """The main path of one MoE LM: init, a timed prefill of ``batch`` x
    ``prompt`` random tokens, the cache padded by ``steps``, ``steps``
    greedy decode steps, between a reset and a read of the launch
    counts; the launch counts per prefill and per step asserted (one
    flash and one tensor-core decode launch per layer where
    ``flash_per_layer``, none of any kernel otherwise) and every logits
    finite and (batch, vocab) (check (a)).  Returns (params, tokens,
    first prefill logits, cache, last token, pos, launches)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import DECODE_ATTENTION_TC_KERNEL as dec
    from repro_torch.models.transformer import decode_step, init_params, prefill

    on_card = dev.type == "cuda"
    per_layer = cfg.n_layers if (on_card and flash_per_layer) else 0
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED, device=dev)
    sync(dev)
    router = params["layers"]["ffn"]["router"]
    print(f"[moe] {name}: {count_params(params) / 1e9:.3f} B parameters drawn "
          f"in {time.perf_counter() - t0:.1f} s ({cfg.param_dtype}, router "
          f"{router.dtype})", flush=True)
    if router.dtype != torch.float32:
        raise AssertionError(f"{name}: the router is not float32")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt), generator=gen,
                           device=dev)
    reset_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(params, tokens, cfg, device=dev)
    sync(dev)
    secs = time.perf_counter() - t0
    after_prefill = read_counts()
    print(f"[moe] {name} prefill (first call): {secs * 1e3:.1f} ms, "
          f"{batch * prompt / secs:.0f} prompt tokens/s", flush=True)
    first = logits
    cache = {f: F.pad(c, (0, 0) * (c.dim() - 3) + (0, steps))
             for f, c in cache.items()}
    token = logits.argmax(dim=-1)
    pos = torch.full((batch,), prompt, dtype=torch.int64, device=dev)
    outs, step_ms = [logits], []
    for _ in range(steps):
        before = dec.launches
        t0 = time.perf_counter()
        logits, cache = decode_step(params, token, cache, pos, cfg, device=dev)
        sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if dec.launches - before != per_layer:
            raise AssertionError(f"{name}: {dec.launches - before} decode "
                                 f"launches in a step, want {per_layer}")
        outs.append(logits)
        token = logits.argmax(dim=-1)
        pos = pos + 1
    launches = read_counts()
    print(f"[moe] {name} main path launches: {launches}", flush=True)
    want = {k: 0 for k in launches}
    want["flash_attention_tc"] = per_layer
    want["decode_attention_tc"] = per_layer * steps
    if after_prefill["flash_attention_tc"] != per_layer or launches != want:
        raise AssertionError(f"{name}: launches {launches} (after prefill "
                             f"{after_prefill}), want {want}")
    for out in outs:
        if out.shape != (batch, cfg.vocab) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name}: logits are not finite or misshapen")
    print(f"[moe] {name} check (a): {len(outs)} logits ({batch} x {cfg.vocab}) "
          f"finite", flush=True)
    rest = step_ms[1:] or step_ms
    print(f"[moe] {name} decode: {steps} greedy steps at B={batch}, first "
          f"{step_ms[0]:.2f} ms, then mean {sum(rest) / len(rest):.2f} ms/step "
          f"(min {min(rest):.2f}); {batch * len(rest) / sum(rest) * 1e3:.1f} "
          f"tokens/s", flush=True)
    return params, tokens, first, cache, token, pos, launches


def steady_prefill(dev, params, tokens, cfg, name, first, require_equal,
                   kernel):
    """A second prefill, timed: its logits against the first's bit for
    bit (check (b) where ``require_equal``); then a third under
    torch.profiler (``kernel``'s share of busy time)."""
    import torch

    from repro_torch.models.transformer import prefill

    t0 = time.perf_counter()
    logits, cache = prefill(params, tokens, cfg, device=dev)
    sync(dev)
    secs = time.perf_counter() - t0
    b, s = tokens.shape
    print(f"[moe] {name} prefill (steady): {secs * 1e3:.1f} ms, "
          f"{b * s / secs:.0f} prompt tokens/s", flush=True)
    del cache
    same = torch.equal(logits, first)
    print(f"[moe] {name}{' check (b):' if require_equal else ''} second "
          f"prefill bit-equal to the first: {same} (max |dlogit| "
          f"{float((logits - first).abs().max()):.3g})", flush=True)
    if require_equal and not same:
        raise AssertionError(f"{name}: two prefills gave different logits")
    del logits
    if dev.type == "cuda":
        profile_device(f"{name} prefill", lambda: prefill(
            params, tokens, cfg, device=dev), kernel)


def routing_stats(dev, params, tokens, cfg, name):
    """One more prefill, untimed, with each MoE layer's routing recorded:
    prints layer 0's least and most tokens per expert and every layer's
    drops, and the prefill's ms with the recorder's extra router and
    dispatch in every layer."""
    from repro_torch.models import transformer

    stats = []
    with mock.patch.object(transformer, "moe_ffn", routing_recorder(stats)):
        t0 = time.perf_counter()
        transformer.prefill(params, tokens, cfg, device=dev)
        sync(dev)
        secs = time.perf_counter() - t0
    b, s = tokens.shape
    counts0, _, cap = stats[0]
    drops = [int(d) for _, d, _ in stats]
    assigned = b * s * cfg.moe.top_k
    print(f"[moe] {name} prefill with the routing recorded (one more router "
          f"and dispatch a layer; not a serve time): {secs * 1e3:.1f} ms",
          flush=True)
    print(f"[moe] {name} layer 0 routing: {assigned} assignments over "
          f"{cfg.moe.n_experts} experts, capacity {cap}: least "
          f"{int(counts0.min())}, most {int(counts0.max())} tokens per expert",
          flush=True)
    print(f"[moe] {name} dropped past capacity per layer: {drops} (of "
          f"{assigned} each; {sum(drops)} in all, "
          f"{100 * sum(drops) / (assigned * len(drops)):.2f}%)", flush=True)


def decode_equals_prefill(dev, params, tokens, cfg, label):
    """Check (c) at S = DECODE_CHECK_PROMPT and no MoE drop
    (``no_drop``: prefill(S + 1) ranks 2(S + 1) tokens against its
    capacity and drops the last ones' assignments past it, a decode step
    of B tokens does not): layer by layer, decode against prefill on the
    same input within MOE_LAYER_TOL; in fp32 also ``decode_step`` for
    token S from prefill(S)'s cache against prefill(S + 1)'s last
    logits (argmax equal, |dlogit| <= tol + tol|logit|)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models.moe import no_drop
    from repro_torch.models.transformer import (decode_step, layer_decode,
                                                layer_forward, layer_params,
                                                prefill)

    s = DECODE_CHECK_PROMPT
    cfg = dataclasses.replace(cfg, moe=no_drop(cfg.moe))
    b = tokens.shape[0]
    fp32 = cfg.param_dtype == torch.float32
    layer_tol = MOE_LAYER_TOL["float32" if fp32 else "bfloat16"]
    _, cache = prefill(params, tokens[:, :s], cfg, device=dev)
    cache = {f: F.pad(c, (0, 0) * (c.dim() - 3) + (0, 1)) for f, c in cache.items()}
    pos = torch.full((b,), s, dtype=torch.int64, device=dev)

    x = params["embed"][tokens[:, :s + 1]]
    errs = []
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        x_in = x[:, s].clone()
        x, _, _ = layer_forward(cfg, lp, x)
        got = layer_decode(cfg, lp, x_in, {f: c[i].clone() for f, c in cache.items()},
                           pos)
        want = x[:, s].float()
        errs.append(float((got.float() - want).norm() / want.norm()))
    print(f"[moe] {label} check (c), layer by layer on the same input: "
          f"decode against prefill at pos {s}, relative L2 per layer "
          f"{[float(f'{e:.3g}') for e in errs]} (tol {layer_tol})", flush=True)
    if not max(errs) <= layer_tol:
        raise AssertionError(f"{label}: a decode layer != its prefill layer")
    if not fp32:
        return

    got, _ = decode_step(params, tokens[:, s], cache, pos, cfg, device=dev)
    want, _ = prefill(params, tokens[:, :s + 1], cfg, device=dev)
    diff = (got - want).abs()
    agree = int((got.argmax(-1) == want.argmax(-1)).sum())
    print(f"[moe] {label} check (c), end to end: decode at pos {s} from "
          f"prefill({s})'s cache against prefill({s + 1})'s last position: "
          f"max |dlogit| {float(diff.max()):.4g} (logits up to "
          f"{float(want.abs().max()):.3g}), argmax agrees on {agree} of {b}; "
          f"tol {MOE_CHECK_TOL} + {MOE_CHECK_TOL}|logit|", flush=True)
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: decode logits are not finite")
    if agree != b or not bool((diff <= MOE_CHECK_TOL * (1 + want.abs())).all()):
        raise AssertionError(f"{label}: decode != prefill within tol")


def layer0_ffn_input(params, tokens, cfg):
    """Layer 0's FFN input (T, d) for ``tokens`` (B, S): embed, ln1,
    attention, residual, ln2."""
    from repro_torch.models.attention import gqa_forward, mla_forward
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.transformer import layer_params

    lp = layer_params(params["layers"], 0)
    x = params["embed"][tokens]
    h = rms_norm(x, lp["ln1"])
    h = (mla_forward(lp["attn"], h, cfg.mla) if cfg.attn_kind == "mla"
         else gqa_forward(lp["attn"], h, cfg.attn_cfg()))
    return rms_norm(x + h, lp["ln2"]).reshape(-1, cfg.d_model)


def upcast(tree):
    return {k: upcast(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


def moe_dense_check(params, tokens, cfg, name):
    """Check (d): layer 0's ``moe_ffn`` on MOE_DENSE_TOKENS prompt tokens
    against ``moe_ffn_dense`` (every expert on every token, gates zeroed
    outside the top-k), both in fp32 on layer 0's weights, at a capacity
    of T (nothing drops)."""
    from repro_torch.models.moe import moe_ffn, moe_ffn_dense
    from repro_torch.models.transformer import layer_params

    x = layer0_ffn_input(params, tokens[:1, :MOE_DENSE_TOKENS], cfg).float()
    ffn = upcast(layer_params(params["layers"]["ffn"], 0))
    got, _ = moe_ffn(ffn, x, cfg.moe, capacity=x.shape[0])
    want = moe_ffn_dense(ffn, x, cfg.moe)
    diff = (got - want).abs()
    print(f"[moe] {name} check (d): layer-0 MoE FFN on {x.shape[0]} tokens "
          f"against every expert on every token (fp32): max |d| "
          f"{float(diff.max()):.4g} (values up to {float(want.abs().max()):.4g}; "
          f"tol {MOE_CHECK_TOL} + {MOE_CHECK_TOL}|dense|)", flush=True)
    if not bool((diff <= MOE_CHECK_TOL * (1 + want.abs())).all()):
        raise AssertionError(f"{name}: moe_ffn != dense formulation")


def mla_absorbed_check(params, cache, token, pos, cfg):
    """Check (e): at layer 0, the absorbed scores and output of
    ``mla_decode`` (``mla_absorbed_attention``) against attention over
    K/V materialised from the c cache, both in fp32, on the main path's
    cache, for the decode input of ``token`` at ``pos`` (keys 0..pos)."""
    import torch

    from repro_torch.models.attention import (mla_absorbed_attention,
                                              mla_materialised_attention)
    from repro_torch.models.layers import apply_rope, rms_norm, rope_angles
    from repro_torch.models.transformer import layer_params

    m = cfg.mla
    lp = layer_params(params["layers"], 0)
    attn = upcast(lp["attn"])
    h = rms_norm(params["embed"][token], lp["ln1"]).float()
    q = (h @ attn["wq"]).reshape(h.shape[0], m.n_heads, m.d_nope + m.d_rope)
    cos, sin = rope_angles(pos[:, None], m.d_rope, m.rope_theta)
    q_rope = apply_rope(q[..., m.d_nope:][:, None], cos, sin)[:, 0]
    args = (attn, q[..., :m.d_nope], q_rope, cache["c"][0], cache["k_rope"][0],
            pos, m)
    o, sc = mla_absorbed_attention(*args)
    want_o, want_sc = mla_materialised_attention(*args)
    valid = torch.isfinite(want_sc)
    if not torch.equal(valid, torch.isfinite(sc)):
        raise AssertionError("MLA absorbed scores: the key mask differs")
    d_sc = (sc[valid] - want_sc[valid]).abs()
    d_o = (o - want_o).abs()
    print(f"[moe] {MLA_ARCH} check (e): layer-0 absorbed decode against K/V "
          f"materialised from c (fp32, {int(valid[0, 0].sum())} keys): scores "
          f"max |d| {float(d_sc.max()):.4g} (up to "
          f"{float(want_sc[valid].abs().max()):.3g}), output max |d| "
          f"{float(d_o.max()):.4g} (up to {float(want_o.abs().max()):.3g}); tol "
          f"{MOE_CHECK_TOL} + {MOE_CHECK_TOL}|want|", flush=True)
    if not (bool((d_sc <= MOE_CHECK_TOL * (1 + want_sc[valid].abs())).all())
            and bool((d_o <= MOE_CHECK_TOL * (1 + want_o.abs())).all())):
        raise AssertionError("MLA absorbed decode != materialised attention")


def print_moe_cuts(name, cfg, batch, prompt, steps, depth):
    m = cfg.moe
    attn = (f"MLA {cfg.n_heads} heads, kv_lora_rank {cfg.mla.kv_lora_rank}, "
            f"d_nope {cfg.mla.d_nope}, d_rope {cfg.mla.d_rope}, d_v {cfg.mla.d_v}"
            if cfg.attn_kind == "mla" else
            f"GQA {cfg.n_heads} heads, {cfg.n_kv} kv heads, d_head {cfg.d_head}")
    print(f"[moe] {name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{attn}; {m.n_experts} experts top-{m.top_k}, {m.n_shared} shared, "
          f"expert d_ff {m.d_ff}; vocab {cfg.vocab}, {cfg.param_dtype}, random "
          f"weights (seed {SEED}); {depth}", flush=True)
    print(f"[moe] {name} traffic cut: prefill {batch} x {prompt} tokens instead "
          f"of prefill_32k's 32 x 32768, and decode batch {batch} instead of "
          f"decode_32k's 128 ({steps} steps from a cache padded to "
          f"{prompt + steps}), phase 4's traffic", flush=True)


def deepseek_phase(dev, cfg=None, batch=LM_BATCH, prompt=LM_PROMPT,
                   steps=LM_DECODE_STEPS, fp32_layers=MOE_FP32_LAYERS):
    """DeepSeek-V2-Lite (MLA + 64-expert MoE) at full width and depth in
    bf16: the main path (``moe_lm_serve``; no kernel: the reference runs
    no Pallas kernel for MLA or MoE), checks (a)-(e), a profiled decode
    step, a second prefill and a profiled one, the routing; then check
    (c) on a full-width ``fp32_layers``-layer fp32 copy."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import decode_step

    cfg = cfg or get_arch(MLA_ARCH).model_cfg(False)
    print_moe_cuts(MLA_ARCH, cfg, batch, prompt, steps, "no width or depth cut")
    params, tokens, first, cache, token, pos, launches = moe_lm_serve(
        dev, cfg, MLA_ARCH, batch, prompt, steps, flash_per_layer=False)
    if dev.type == "cuda":
        print(f"[moe] {MLA_ARCH} peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB "
              f"(torch.cuda.max_memory_allocated)", flush=True)
        profile_device(f"{MLA_ARCH} decode step", lambda: decode_step(
            params, token, cache, pos, cfg, device=dev), "gemm")
    mla_absorbed_check(params, cache, token, pos - 1, cfg)
    del cache
    steady_prefill(dev, params, tokens, cfg, MLA_ARCH, first,
                   require_equal=True, kernel="gemm")
    routing_stats(dev, params, tokens, cfg, MLA_ARCH)
    decode_equals_prefill(dev, params, tokens, cfg, f"{MLA_ARCH} bf16")
    moe_dense_check(params, tokens, cfg, MLA_ARCH)
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    from repro_torch.models.transformer import init_params

    f32 = dataclasses.replace(cfg, n_layers=fp32_layers, param_dtype=torch.float32)
    params = init_params(f32, seed=SEED, device=dev)
    decode_equals_prefill(dev, params, tokens, f32,
                          f"{MLA_ARCH} fp32 {fp32_layers} layers")
    del params
    return launches


def grok_phase(dev, cfg=None, layers=GROK_LAYERS, batch=LM_BATCH,
               prompt=LM_PROMPT, steps=LM_DECODE_STEPS):
    """Grok-1 (GQA 48:8, 8-expert MoE) at full width, cut to ``layers``
    layers, bf16, ``use_flash=True``: the main path through the
    tensor-core flash kernel (one launch per layer per prefill) and the
    tensor-core decode kernel (one per layer per step, none on the CUDA
    cores), check (a); each layer's decode attention held against the
    plain einsums (``decode_attention_held``); one decode step through
    the kernel and the plain einsums from copies of one cache; a
    profiled decode step; a second prefill and a profiled one; the
    routing; layer-0 flash attention against plain within BF16_TOL.
    Returns the main path's launch counts."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import decode_step

    full = cfg or get_arch(GQA_MOE_ARCH).model_cfg(False)
    cfg = dataclasses.replace(full, n_layers=layers, use_flash=True)
    plain_cfg = dataclasses.replace(cfg, use_flash=False)
    print_moe_cuts(GQA_MOE_ARCH, cfg, batch, prompt, steps,
                   f"depth cut to {layers} of {full.n_layers} layers: 316.5 B "
                   f"parameters are 633 GB in bf16, more than the card's 80 GB")
    params, tokens, first, cache, token, pos, launches = moe_lm_serve(
        dev, cfg, GQA_MOE_ARCH, batch, prompt, steps, flash_per_layer=True)
    if dev.type == "cuda":
        print(f"[moe] {GQA_MOE_ARCH} peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB "
              f"(torch.cuda.max_memory_allocated)", flush=True)
    decode_attention_held(params, token, cache, pos - 1, cfg, plain_cfg, dev)
    decode_both_ways(params, token, cache, pos - 1, cfg, plain_cfg, dev)
    if dev.type == "cuda":  # pos is past the cache: this step stores nothing
        profile_device(f"{GQA_MOE_ARCH} decode step", lambda: decode_step(
            params, token, cache, pos, cfg, device=dev), "decode_attention_tc")
    del cache
    steady_prefill(dev, params, tokens, cfg, GQA_MOE_ARCH, first,
                   require_equal=False, kernel="flash_attention_tc")
    routing_stats(dev, params, tokens, cfg, GQA_MOE_ARCH)
    got = attention_layer0(params, tokens, cfg).float()
    want = attention_layer0(params, tokens, plain_cfg).float()
    diff = (got - want).abs()
    print(f"[moe] {GQA_MOE_ARCH} layer-0 attention output, flash against plain: "
          f"max |d| {float(diff.max()):.4g} (values up to "
          f"{float(want.abs().max()):.3g}; tol {BF16_TOL} + {BF16_TOL}|plain|)",
          flush=True)
    if not bool((diff <= BF16_TOL + BF16_TOL * want.abs()).all()):
        raise AssertionError("grok-1 layer-0 attention: flash != plain")
    del params
    return launches


def moe_phase(dev):
    """Phase 4b: DeepSeek-V2-Lite, then Grok-1; returns Grok-1's launch
    counts (DeepSeek-V2-Lite's path launches no kernel)."""
    import torch

    t0 = time.perf_counter()
    deepseek_phase(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    launches = grok_phase(dev)
    print(f"[moe] phase 4b in {time.perf_counter() - t0:.1f} s", flush=True)
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
            if not torch.equal(idx.long(), order[:100]):
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


def decode_attention_held(params, token, cache, pos, cfg, plain_cfg, dev):
    """Each layer's attention in one decode step at ``pos``, through the
    decode kernel (``cfg``: one tensor-core launch, none on the CUDA
    cores) and through the plain einsums (``plain_cfg``), on the same
    input (the kernel path's residual stream) and copies of the layer's
    cache: the (B, d_model) outputs row by row within ROW_TOL (out x
    PLANTED_SCALE must fail), the caches written alike.  A step's logits
    go through every later layer and the routing, so this holds the
    kernel where the logits cannot."""
    import torch

    from repro_torch.kernels.decode_attention import (
        DECODE_ATTENTION_KERNEL, DECODE_ATTENTION_TC_KERNEL)
    from repro_torch.models.attention import gqa_decode
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.transformer import layer_decode, layer_params

    row_tol = ROW_TOL["bfloat16"]
    want_launches = 1 if dev.type == "cuda" else 0
    x = params["embed"][token]
    errs = []
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        h = rms_norm(x, lp["ln1"])
        kern, plain = ({f: c[i].clone() for f, c in cache.items()}
                       for _ in range(2))
        tc, cc = (DECODE_ATTENTION_TC_KERNEL.launches,
                  DECODE_ATTENTION_KERNEL.launches)
        got, _ = gqa_decode(lp["attn"], h, kern, pos, cfg.attn_cfg())
        sync(dev)
        if (DECODE_ATTENTION_TC_KERNEL.launches - tc != want_launches
                or DECODE_ATTENTION_KERNEL.launches != cc):
            raise AssertionError(f"decode layer {i}: not one launch of the "
                                 f"tensor-core decode kernel alone")
        want, _ = gqa_decode(lp["attn"], h, plain, pos, plain_cfg.attn_cfg())
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"decode layer {i}: attention not finite")
        if not all(torch.equal(kern[f], plain[f]) for f in kern):
            raise AssertionError(f"decode layer {i}: caches written apart")
        errs.append(row_rel_err(got, want))
        if errs[-1] > row_tol:
            raise AssertionError(f"decode layer {i}: kernel attention != plain "
                                 f"(row relative error {errs[-1]}, tol "
                                 f"{row_tol})")
        if row_rel_err(got.float() * PLANTED_SCALE, want) <= row_tol:
            raise AssertionError(f"decode layer {i}: the row check passes out "
                                 f"scaled by {PLANTED_SCALE}")
        x = layer_decode(cfg, lp, x, kern, pos)
    print(f"[moe] {GQA_MOE_ARCH} decode attention at pos {pos.tolist()}, kernel "
          f"against plain einsums on the same input, layer by layer: row "
          f"relative error {[float(f'{e:.3g}') for e in errs]} (tol {row_tol}; "
          f"out x{PLANTED_SCALE} rejected)", flush=True)


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


# ------------------------------------------------------------ phase 4c
# Train the LMs (launch/steps.py make_lm_train_step: loss, microbatched
# grads, clip, in-place AdamW), through the plain attention as the
# reference trains (its Pallas kernels have no VJP): no kernel runs.
LM_TRAIN_ARCH = "starcoder2-3b"
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 8, 4096   # cut from train_4k's 256 x 4096
LM_TRAIN_FALL_STEPS = 3                  # on one fixed batch
LM_TRAIN_TIMED_STEPS = 2                 # on fresh batches
# (b): the same model at full width, cut in depth, fp32, card against CPU
LM_CHECK_LAYERS, LM_CHECK_BATCH, LM_CHECK_SEQ, LM_CHECK_MB = 2, 2, 256, 2
# float32 on both sides, summation order only (tests/test_torch_train_step.py)
LM_CHECK_TOL = 1e-4
MOE_TRAIN_LAYERS = 4                     # of 27: 16 B parameters with AdamW
                                         # state do not fit 80 GB
LM_CLI_STEPS = 40


def lm_tokens(gen, vocab, b, s, dev):
    """(tokens, targets) (b, s) int32 from ``gen``: one random sequence of
    s + 1 tokens a row, shifted by one."""
    import torch

    toks = torch.randint(0, vocab, (b, s + 1), generator=gen, device=dev,
                         dtype=torch.int32)
    return toks[:, :-1], toks[:, 1:]


def falling_steps(step, state, batch, n, name, first=()):
    """``n`` steps of ``step(params, opt, *batch)`` (the loss as its
    third output, or its "loss" entry) on one batch, after the losses
    ``first`` of steps already taken on it: every loss finite and each
    below the one before; returns the losses."""
    import math

    losses = list(first)
    for _ in range(n):
        out = step(*state, *batch)[2]
        losses.append(float(out["loss"] if isinstance(out, dict) else out))
    if not all(math.isfinite(x) for x in losses) or not all(
            b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"{name}: loss not finite and falling over "
                             f"{len(losses)} steps on one batch: {losses}")
    print(f"[train] {name}: loss over {len(losses)} steps on one batch "
          f"{[round(x, 6) for x in losses]} (finite, falling)", flush=True)
    return losses


def timed_steps(dev, step, state, batches, name, tokens_per_step=None):
    """One step per batch, each timed on the host clock to a synchronize;
    returns the ms of each."""
    times = []
    for batch in batches:
        t0 = time.perf_counter()
        step(*state, *batch)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    rate = (f", {tokens_per_step / (min(times) / 1e3):.0f} tokens/s at the "
            f"fastest" if tokens_per_step else "")
    print(f"[train] {name}: {len(times)} steps on fresh batches, ms/step "
          f"{[round(t, 1) for t in times]}{rate}", flush=True)
    return times


def peak_text(dev) -> str:
    import torch

    if dev.type != "cuda":
        return "n/a (CPU)"
    return f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB"


def lm_train_full(dev, cfg=None, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ):
    """(a) starcoder2-3b at full width and depth, bf16, _lm_opt_cfg's bf16
    moments, microbatch 4 with float32 accumulation, remat, the plain
    attention: 3 steps on one batch (the loss falls), 2 timed steps on
    fresh batches (ms, tokens/s, peak memory, 6 N D / time against the
    bf16 peak), one profiled step."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.roofline import model_flops
    from repro_torch.launch.steps import _lm_opt_cfg, make_lm_train_step
    from repro_torch.models.transformer import init_params
    from repro_torch.train.optimizer import adamw_init

    cfg = cfg or get_arch(LM_TRAIN_ARCH).model_cfg(False)
    opt_cfg = _lm_opt_cfg(False)
    print(f"[train] {LM_TRAIN_ARCH}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, GQA {cfg.n_heads}:{cfg.n_kv}, d_head {cfg.d_head}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.param_dtype}, moments "
          f"{opt_cfg.state_dtype}, microbatch {cfg.microbatch} accumulated in "
          f"{cfg.grad_accum_dtype}, remat {cfg.remat}, plain attention; no "
          f"width or depth cut; traffic cut: batch {batch} x {seq} instead of "
          f"train_4k's 256 x 4096 (a step of 256 would take minutes)",
          flush=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    params = init_params(cfg, seed=SEED, device=dev)
    opt = adamw_init(params, opt_cfg)
    n = model_flops(LM_TRAIN_ARCH, "train_4k", cfg=cfg)["n_active"]
    step = make_lm_train_step(cfg, opt_cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 41)
    falling_steps(step, (params, opt), lm_tokens(gen, cfg.vocab, batch, seq, dev),
                  LM_TRAIN_FALL_STEPS, f"{LM_TRAIN_ARCH} full")
    batches = [lm_tokens(gen, cfg.vocab, batch, seq, dev)
               for _ in range(LM_TRAIN_TIMED_STEPS)]
    times = timed_steps(dev, step, (params, opt), batches,
                        f"{LM_TRAIN_ARCH} full", batch * seq)
    flops = 6 * n * batch * seq
    best = min(times) / 1e3
    print(f"[train] {LM_TRAIN_ARCH} full: {n / 1e9:.3f} B parameters; peak "
          f"device memory {peak_text(dev)}; 6 N D = {flops:.4g} FLOP a step, "
          f"{flops / best / 1e12:.1f} TFLOP/s at the fastest, "
          f"{100 * flops / best / BF16_FLOPS_PER_S:.2f}% of the {BF16_FLOPS_PER_S:.3g} "
          f"bf16 peak (remat and the quadratic attention not counted)",
          flush=True)
    if dev.type == "cuda":
        tk, tg = batches[0]
        t0 = time.perf_counter()
        profile_device(f"{LM_TRAIN_ARCH} train step",
                       lambda: step(params, opt, tk, tg), "gemm", host=False)
        print(f"[train] the profiled step and its tables in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    del params, opt


def lm_train_card_vs_cpu(dev, cfg=None, layers=LM_CHECK_LAYERS,
                         batch=LM_CHECK_BATCH, seq=LM_CHECK_SEQ,
                         mb=LM_CHECK_MB):
    """(b) The same model at full width, cut to ``layers``, fp32, batch
    ``batch`` x ``seq`` in ``mb`` microbatches: one step on the card and
    one on the CPU from the same weights and tokens; the loss, the grad
    norm and every (clipped) gradient leaf within LM_CHECK_TOL (relative
    L2 for the leaves); the new parameters' relative L2 printed."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch import steps
    from repro_torch.models.transformer import init_params
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.tree import leaf_paths, tree_leaves, tree_map

    cfg = dataclasses.replace(cfg or get_arch(LM_TRAIN_ARCH).model_cfg(False),
                              n_layers=layers, param_dtype=torch.float32,
                              microbatch=mb)
    opt_cfg = steps._lm_opt_cfg(True)
    params = init_params(cfg, seed=SEED, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 43)
    tokens, targets = lm_tokens(gen, cfg.vocab, batch, seq, dev)
    step = steps.make_lm_train_step(cfg, opt_cfg)
    cpu = torch.device("cpu")
    runs = {}
    for where, d in (("card", dev), ("cpu", cpu)):
        p = tree_map(lambda t: t.to(d, copy=True), params)
        o = adamw_init(p, opt_cfg)
        seen = []
        real = steps.lm_loss_and_grads

        def recording(*a, **k):
            out = real(*a, **k)
            seen.append(out[1])           # clipped in place by the step
            return out

        t0 = time.perf_counter()
        with mock.patch.object(steps, "lm_loss_and_grads", recording):
            _, _, m = step(p, o, tokens.to(d), targets.to(d))
        sync(dev)
        runs[where] = (m, seen[0], p, time.perf_counter() - t0)
    (mg, gg, pg, tg_), (mc, gc, pc, tc_) = runs["card"], runs["cpu"]
    errs = {}
    for key in ("loss", "grad_norm"):
        a, b = float(mg[key]), float(mc[key])
        errs[key] = abs(a - b)
        if errs[key] > LM_CHECK_TOL * (1 + abs(b)):
            raise AssertionError(f"card vs CPU {key}: {a} against {b}")

    def rel(a, b):
        a, b = a.detach().double().cpu(), b.detach().double()
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    grad_err = max((rel(a, b), path) for a, b, path in zip(
        tree_leaves(gg), tree_leaves(gc), leaf_paths(gc)))
    if grad_err[0] > LM_CHECK_TOL:
        raise AssertionError(f"card vs CPU: gradient {grad_err} (relative L2, "
                             f"tol {LM_CHECK_TOL})")
    # not held: an element whose gradient is near 0 may step the other
    # way on one side (tests/test_torch_train_step.py's exemption)
    param_err = max(rel(a, b) for a, b in zip(tree_leaves(pg), tree_leaves(pc)))
    print(f"[train] {LM_TRAIN_ARCH} at full width, {layers} layers, fp32, "
          f"{batch} x {seq} in {mb} microbatches, card against CPU: loss "
          f"{float(mg['loss']):.6f} (|d| {errs['loss']:.3g}), grad norm "
          f"{float(mg['grad_norm']):.6f} (|d| {errs['grad_norm']:.3g}), worst "
          f"gradient leaf relative L2 {grad_err[0]:.3g} ({grad_err[1]}; tol "
          f"{LM_CHECK_TOL}), worst new parameter leaf {param_err:.3g}; step "
          f"{tg_ * 1e3:.1f} ms card (first call), {tc_ * 1e3:.1f} ms CPU",
          flush=True)


def moe_train(dev, cfg=None, layers=MOE_TRAIN_LAYERS, batch=LM_TRAIN_BATCH,
              seq=LM_TRAIN_SEQ):
    """(c) DeepSeek-V2-Lite at full width, cut to ``layers``, bf16, (a)'s
    traffic and step: two steps from copies of one state bit-equal
    (parameters, moments, loss); the loss finite and falling over 3
    steps on one batch; 2 timed steps; drops per layer; peak memory."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import _lm_opt_cfg, make_lm_train_step
    from repro_torch.models import transformer
    from repro_torch.models.transformer import init_params
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(cfg or get_arch(MLA_ARCH).model_cfg(False),
                              n_layers=layers)
    opt_cfg = _lm_opt_cfg(False)
    print(f"[train] {MLA_ARCH}: full width (MLA r {cfg.mla.kv_lora_rank}, "
          f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} + "
          f"{cfg.moe.n_shared} shared), {cfg.param_dtype}, moments "
          f"{opt_cfg.state_dtype}, microbatch {cfg.microbatch}, remat "
          f"{cfg.remat}; depth cut: {layers} of 27 layers (16 B parameters "
          f"with AdamW state do not fit 80 GB); traffic as {LM_TRAIN_ARCH}'s",
          flush=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    params = init_params(cfg, seed=SEED, device=dev)
    opt = adamw_init(params, opt_cfg)
    step = make_lm_train_step(cfg, opt_cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 47)
    batch0 = lm_tokens(gen, cfg.vocab, batch, seq, dev)
    twin = (tree_map(torch.clone, params), tree_map(torch.clone, opt))
    _, _, m = step(params, opt, *batch0)
    _, _, m2 = step(*twin, *batch0)
    same = (torch.equal(m["loss"], m2["loss"])
            and torch.equal(m["grad_norm"], m2["grad_norm"])
            and all(torch.equal(a, b) for a, b in zip(
                tree_leaves((params, opt)), tree_leaves(twin))))
    print(f"[train] {MLA_ARCH}: two steps from copies of one state bit-equal "
          f"(parameters, moments, loss, norm): {same}; loss "
          f"{float(m['loss']):.6f}", flush=True)
    if not same:
        raise AssertionError(f"{MLA_ARCH}: two steps from one state differ")
    del twin
    falling_steps(step, (params, opt), batch0, LM_TRAIN_FALL_STEPS - 1,
                  f"{MLA_ARCH} {layers} layers", first=[float(m["loss"])])
    batches = [lm_tokens(gen, cfg.vocab, batch, seq, dev)
               for _ in range(LM_TRAIN_TIMED_STEPS)]
    timed_steps(dev, step, (params, opt), batches, f"{MLA_ARCH} {layers} layers",
                batch * seq)
    stats = []
    mb_rows = batch // cfg.microbatch
    with torch.no_grad(), mock.patch.object(transformer, "moe_ffn",
                                            routing_recorder(stats)):
        transformer.lm_loss(params, *(t[:mb_rows] for t in batches[0]), cfg,
                            device=dev)
    drops = [int(d) for _, d, _ in stats]
    assigned = mb_rows * seq * cfg.moe.top_k
    print(f"[train] {MLA_ARCH}: dropped past capacity {stats[0][2]} per layer "
          f"in one microbatch's forward: {drops} of {assigned} assignments "
          f"each; peak device memory {peak_text(dev)}", flush=True)
    del params, opt


def lm_train_cli(dev, steps=LM_CLI_STEPS):
    """(d) ``launch/train.py lm --arch starcoder2-3b`` on ``dev`` for
    ``steps`` steps with ``--inject-failure`` and without, from fresh
    checkpoint directories: one restart, the loss falls (the command
    asserts it), and the final parameters and state bit-equal."""
    import tempfile

    import torch

    from repro_torch.launch.train import main as train_main
    from repro_torch.train.tree import tree_leaves

    runs = {}
    with tempfile.TemporaryDirectory(prefix="ckpt-lm-") as tmp:
        for name, extra in (("injected", ["--inject-failure"]), ("clean", [])):
            t0 = time.perf_counter()
            runs[name] = train_main(["lm", "--arch", LM_TRAIN_ARCH, "--steps",
                                     str(steps), "--device", dev.type,
                                     "--ckpt-dir", f"{tmp}/{name}", *extra])
            runs[name]["secs"] = time.perf_counter() - t0
    inj, clean = runs["injected"], runs["clean"]
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(inj["state"]),
                                                  tree_leaves(clean["state"])))
    print(f"[train] launch/train.py lm --arch {LM_TRAIN_ARCH} --steps {steps} "
          f"on {dev.type}: with --inject-failure {inj['restarts']} restart, "
          f"{inj['steps_replayed']} steps replayed, loss "
          f"{inj['losses'][0]:.4f} -> {inj['losses'][-1]:.4f}, "
          f"{inj['secs']:.1f} s; clean {clean['secs']:.1f} s; final state "
          f"bit-equal: {same}", flush=True)
    if inj["restarts"] != 1 or clean["restarts"] != 0 or not same:
        raise AssertionError("launch/train.py lm: the injected run did not "
                             "restart once and end bit-equal to the clean one")


def lm_train_phase(dev):
    """Phase 4c: (a)-(d), the main path (a, c, d) between a reset and a
    read of the launch counts: no kernel runs (the plain attention)."""
    t_phase = time.perf_counter()
    reset_counts()
    for part in (lm_train_full, moe_train, lm_train_cli):
        t0 = time.perf_counter()
        part(dev)
        print(f"[train] {part.__name__} in {time.perf_counter() - t0:.1f} s",
              flush=True)
    launches = read_counts()
    if any(launches.values()):
        raise AssertionError(f"the LM train path launched kernels: {launches}")
    print(f"[train] LM train path launches: {launches} (none: the reference "
          f"trains through the plain attention)", flush=True)
    lm_train_card_vs_cpu(dev)
    print(f"[train] phase 4c in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return launches


# ------------------------------------------------------------ phase 5b
RECSYS_TRAIN_B4R_BATCH = 4096    # cut from 65,536: its fp32 scores would
                                 # be 21 GB a layer
RECSYS_TRAIN_STEPS = 3


def recsys_train_batch(arch_id, cfg, b, gen, dev):
    """One seeded train batch: the CTR archs' (ids, dense, labels: 1
    where more than half the ids are odd);
    BERT4Rec's (seq with 16 positions set to [MASK], those positions,
    their targets, 256 shared negatives a row)."""
    import torch

    def ints(hi, shape):
        return torch.randint(0, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    if arch_id == "bert4rec":
        seq = ints(cfg.n_items, (b, cfg.seq_len))
        pos = ints(cfg.seq_len, (b, 16))
        seq.scatter_(1, pos, cfg.n_items + 1)
        return seq, pos, ints(cfg.n_items, (b, 16)), ints(cfg.n_items, (b, 256))
    dense = torch.randn((b, max(cfg.n_dense, 1)), generator=gen, device=dev)
    ids = ints(cfg.vocab_per_field, (b, cfg.n_sparse))
    # a label the ids determine (more odd ids than even), so that a step
    # has a signal to fit beyond memorising random labels
    labels = ((ids % 2).sum(1) * 2 > cfg.n_sparse).float()
    return ids, dense, labels


def recsys_train_init(arch_id, cfg, dev):
    from repro_torch.models import recsys

    init = {"wide-deep": recsys.wide_deep_init, "deepfm": recsys.deepfm_init,
            "dcn-v2": recsys.dcn_init, "bert4rec": recsys.bert4rec_init}[arch_id]
    return init(cfg, seed=SEED, device=dev)


def bag_train_check(arch_id, cfg, params, batch, dev):
    """One loss and gradient through the bag kernel and one through the
    plain bag, on one state: one column-route launch in the forward and
    none in the backward; the loss within RECSYS_TOL + RECSYS_TOL|loss|,
    the bag table's gradient within RECSYS_TOL + RECSYS_TOL|g|
    elementwise, every leaf within 1e-4 relative L2."""
    import torch

    from repro_torch.kernels.embedding_bag import (EMBEDDING_BAG_KERNEL,
                                                   EMBEDDING_BAG_LANES_KERNEL,
                                                   embedding_bag_ref)
    from repro_torch.launch.steps import recsys_loss, value_and_grad
    from repro_torch.models import recsys
    from repro_torch.train.tree import leaf_paths, tree_leaves, tree_map

    bags = (EMBEDDING_BAG_KERNEL, EMBEDDING_BAG_LANES_KERNEL)
    on_card = dev.type == "cuda"
    req = tree_map(lambda p: p.detach().requires_grad_(), params)
    before = [k.launches for k in bags]
    loss = recsys_loss(arch_id, cfg, req, *batch)
    sync(dev)
    fwd = [k.launches - b for k, b in zip(bags, before)]
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
        tree_leaves(req), torch.autograd.grad(loss, tree_leaves(req),
                                              allow_unused=True))]
    sync(dev)
    bwd = [k.launches - b - f for k, b, f in zip(bags, before, fwd)]
    if fwd != ([1, 0] if on_card else [0, 0]) or bwd != [0, 0]:
        raise AssertionError(f"{arch_id} train: bag launches {fwd} in the "
                             f"forward, {bwd} in the backward")
    with mock.patch.object(recsys, "embedding_bag", embedding_bag_ref):
        want_loss, want = value_and_grad(
            lambda p: recsys_loss(arch_id, cfg, p, *batch), params)
    if [k.launches for k in bags] != [b + f for b, f in zip(before, fwd)]:
        raise AssertionError("the plain-bag train step launched a bag kernel")
    table = "wide" if arch_id == "wide-deep" else "first_order"
    loss = loss.detach()
    d_loss = abs(float(loss) - float(want_loss))
    worst_rel, worst_table = 0.0, 0.0
    for path, g, w in zip(leaf_paths(want), grads, tree_leaves(want)):
        err = float((g.double() - w.double()).norm()
                    / w.double().norm().clamp_min(1e-30))
        worst_rel = max(worst_rel, err)
        if err > 1e-4:
            raise AssertionError(f"{arch_id} train: kernel-bag gradient of "
                                 f"{path} != plain ({err} relative L2)")
        if path == table:
            diff = (g - w).abs()
            worst_table = float(diff.max())
            if not bool((diff <= RECSYS_TOL + RECSYS_TOL * w.abs()).all()):
                raise AssertionError(f"{arch_id} train: {table} gradient, "
                                     f"kernel bag != plain ({worst_table})")
    if d_loss > RECSYS_TOL * (1 + abs(float(want_loss))):
        raise AssertionError(f"{arch_id} train: loss kernel bag {float(loss)} "
                             f"!= plain {float(want_loss)}")
    print(f"[recsys train] {arch_id}: kernel bag against plain bag on one "
          f"state: loss {float(loss):.8f} (|d| {d_loss:.3g}), {table} "
          f"gradient max |d| {worst_table:.3g} (tol {RECSYS_TOL} + "
          f"{RECSYS_TOL}|g|), worst leaf relative L2 {worst_rel:.3g} (tol "
          f"1e-4); bag launches {fwd} in the forward (column, lanes), {bwd} "
          f"in the backward", flush=True)


def recsys_train_phase(dev, reduced=False, batch_cap=None):
    """Phase 5b: the bag kernel against the plain bag in one loss and
    gradient of Wide&Deep and DeepFM at train_batch (uncounted); then the
    main path between a reset and a read of the launch counts: each of
    the four archs at its full config, 3 train steps on one batch (the
    loss finite and falling, the last two timed), one bag launch per
    step where the arch has a bag.  ``reduced``/``batch_cap`` cut it for
    a rehearsal on the CPU.  Returns the main path's launch counts."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.embedding_bag import EMBEDDING_BAG_KERNEL
    from repro_torch.launch.steps import build_cell
    from repro_torch.train.optimizer import AdamWConfig, adamw_init

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"

    def setup(arch_id):
        cfg = get_arch(arch_id).model_cfg(reduced)
        b = get_arch(arch_id).shape("train_batch").params["batch"]
        if arch_id == "bert4rec":
            b = min(b, RECSYS_TRAIN_B4R_BATCH)
        b = min(b, batch_cap or b)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 51)
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        return cfg, b, recsys_train_init(arch_id, cfg, dev), \
            recsys_train_batch(arch_id, cfg, b, gen, dev)

    print(f"[recsys train] full configs at train_batch (65,536); cut: "
          f"BERT4Rec's batch to {RECSYS_TRAIN_B4R_BATCH} (its fp32 attention "
          f"scores at 65,536 x 200 x 200 x 2 heads are 21 GB a layer)",
          flush=True)
    for arch_id in BAG_ARCHS:
        cfg, b, params, batch = setup(arch_id)
        bag_train_check(arch_id, cfg, params, batch, dev)
        del params, batch
    reset_counts()
    for arch_id in RECSYS_ARCHS:
        cfg, b, params, batch = setup(arch_id)
        opt = adamw_init(params, AdamWConfig(lr=1e-3))
        step = build_cell(arch_id, "train_batch", cfg_override=cfg).fn
        before = EMBEDDING_BAG_KERNEL.launches
        times = []

        def timed(*args):
            t0 = time.perf_counter()
            out = step(*args)
            sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
            return out

        falling_steps(timed, (params, opt), batch, RECSYS_TRAIN_STEPS,
                      f"{arch_id} (batch {b})")
        bag = EMBEDDING_BAG_KERNEL.launches - before
        want = RECSYS_TRAIN_STEPS if (on_card and arch_id in BAG_ARCHS) else 0
        if bag != want:
            raise AssertionError(f"{arch_id} train: {bag} column-route bag "
                                 f"launches over {RECSYS_TRAIN_STEPS} steps, "
                                 f"want {want}")
        print(f"[recsys train] {arch_id} (batch {b}): ms/step "
              f"{[round(t, 1) for t in times]} (the first with its "
              f"allocations), {b / (min(times[1:]) / 1e3):.0f} examples/s at "
              f"the fastest; {bag / RECSYS_TRAIN_STEPS:g} bag launches a step; "
              f"{count_params(params) / 1e6:.1f} M parameters; peak device "
              f"memory {peak_text(dev)}", flush=True)
        del params, opt, batch, step
    launches = read_counts()
    print(f"[recsys train] main path launches: {launches}; phase 5b in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# ------------------------------------------------------------ phase 6
WS_HELD = 8                    # queries held against the reference backend
WS_REPS = 3                    # timed serve calls (median) and train steps
WS_DENSITY_K = (3, 13)         # plane bit density 2^-k, k uniform here
WS_SLICE = 16                  # queries per occupancy fill


def ws_inputs(dev, wcfg, b, seed):
    """The websearch cells' inputs, synthetic and seeded on the device
    (not the corpus's occupancy: the corpus generator is a per-document
    Python loop, too slow for 16.7 M docs): each (query, term, field) plane of
    occupancy has bit density 2^-k, k uniform in WS_DENSITY_K (the AND of
    k random words); 2-4 present terms a query, the absent terms' planes
    empty; normal scores; a normal q table (rules 0.1 above reset and
    stop); geometric bin edges; the production plan's step rewards and
    the ε-greedy draws."""
    import math

    import torch

    from repro_torch.core.state_bins import StateBins

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    t, f, w = 4, 4, wcfg.block_docs // 32
    n_act = wcfg.k_rules + 2
    lo, hi = WS_DENSITY_K
    k = torch.randint(lo, hi + 1, (b, 1, t, f, 1), generator=gen, device=dev)
    n_terms = torch.randint(2, 5, (b,), generator=gen, device=dev)
    tp = torch.arange(t, device=dev)[None] < n_terms[:, None]
    occ = torch.empty((b, wcfg.n_blocks, t, f, w), dtype=torch.int32, device=dev)
    for q0 in range(0, b, WS_SLICE):
        part = occ[q0:q0 + WS_SLICE]
        part.fill_(-1)
        kk = k[q0:q0 + WS_SLICE]
        for i in range(1, hi + 1):
            words = torch.randint(-2**31, 2**31, part.shape, generator=gen,
                                  device=dev, dtype=torch.int32)
            part &= torch.where(kk >= i, words, -1)
        part &= torch.where(tp[q0:q0 + WS_SLICE, None, :, None, None], -1, 0)
    scores = torch.randn((b, wcfg.n_blocks * wcfg.block_docs), generator=gen,
                         device=dev)
    q = 0.05 * torch.randn((wcfg.p_bins, n_act), generator=gen, device=dev)
    q[:, wcfg.k_rules:] -= 0.1
    pu = int(math.sqrt(wcfg.p_bins))
    pv = wcfg.p_bins // pu
    bins = StateBins(
        torch.logspace(1, math.log2(wcfg.u_budget), pu - 1, base=2.0,
                       device=dev),
        torch.logspace(0, 20, pv - 1, base=2.0, device=dev).repeat(pu, 1))
    prod_r = 0.1 * torch.randn((b, wcfg.t_max), generator=gen, device=dev)
    draws = (torch.randint(0, n_act, (wcfg.t_max, b), generator=gen,
                           device=dev, dtype=torch.int32),
             torch.rand((wcfg.t_max, b), generator=gen, device=dev))
    return q, bins, occ, scores, tp, prod_r, draws


def ws_blocks_scanned(wcfg, q, bins, occ, scores, tp):
    """Blocks scanned per query by the greedy policy: each step's Δu over
    its rule's planes per block (``block_cost``), summed over the steps
    that ran a rule (an untimed rollout of the serve cell's)."""
    import torch

    from repro_torch.core.environment import EnvConfig
    from repro_torch.core.match_rules import block_cost, default_rule_library
    from repro_torch.core.rollout import unified_rollout
    from repro_torch.policies import TabularQPolicy

    env = EnvConfig(n_blocks=wcfg.n_blocks, block_docs=wcfg.block_docs,
                    k_rules=wcfg.k_rules, max_candidates=wcfg.max_candidates,
                    n_top=wcfg.n_top, u_budget=wcfg.u_budget)
    rules = default_rule_library(device=occ.device)
    res = unified_rollout(env, rules, bins, TabularQPolicy(q), wcfg.t_max, occ,
                          scores, tp, backend=wcfg.backend)
    u = res.trajectory["u"]                                   # (T, B)
    du = torch.diff(u, dim=0, prepend=torch.zeros_like(u[:1]))
    a = res.transitions["a"].long()                           # (T, B)
    is_rule = a < wcfg.k_rules
    cost = block_cost(rules.allowed[a.clamp(max=wcfg.k_rules - 1)],
                      tp[None].expand(a.shape[0], -1, -1))
    blocks = torch.where(is_rule & (cost > 0), du / cost.clamp_min(1), 0.0)
    return float(blocks.sum(0).float().mean())


def websearch_phase(dev, reduced=False):
    """Phase 6: the websearch-rl cells at full width through
    ``build_cell("websearch-rl", ...).fn`` on synthetic inputs
    (``ws_inputs``): ``serve_queries`` (ms per call, median of WS_REPS,
    queries/s, mean u, blocks scanned and cand_cnt, chunk launches a
    call, peak memory, a profiled call) with WS_HELD queries held bit
    for bit against the ``reference`` backend on the same tensors; then
    ``rl_rollout`` (ms/step; WS_REPS runs from the same q and draws give
    the same bits).  The chunk kernel's launches are read between a reset
    before the timed serve calls and a read after the train steps.
    ``reduced`` runs the reduced cells (a CPU rehearsal).  Returns the
    launch counts."""
    import dataclasses as dc
    import statistics

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.block_scan import BLOCK_SCAN_KERNEL
    from repro_torch.launch.steps import REDUCED_SHAPES, build_cell

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    arch = get_arch("websearch-rl")
    wcfg = arch.model_cfg(reduced)
    b = (REDUCED_SHAPES["serve_websearch"] if reduced
         else arch.shape("serve_queries").params)["query_batch"]
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    q, bins, occ, scores, tp, prod_r, draws = ws_inputs(dev, wcfg, b, SEED + 61)
    sync(dev)
    print(f"[websearch] synthetic inputs (seeded on the device, not the "
          f"corpus's): {b} queries x {wcfg.n_blocks} blocks x "
          f"{wcfg.block_docs} docs, occupancy {occ.numel() * 4 / 1e9:.2f} GB "
          f"(plane density 2^-k, k in {WS_DENSITY_K}), scores "
          f"{scores.numel() * 4 / 1e9:.2f} GB; {int(tp.sum())} present terms; "
          f"made in {time.perf_counter() - t_phase:.1f} s; no cut of width "
          f"or depth", flush=True)
    serve = build_cell("websearch-rl", "serve_queries", reduced=reduced).fn
    train = build_cell("websearch-rl", "rl_rollout", reduced=reduced).fn
    serve(q, bins, occ, scores, tp)                       # warm, uncounted
    sync(dev)
    reset_counts()
    times, outs = [], []
    for _ in range(WS_REPS):
        t0 = time.perf_counter()
        outs.append(serve(q, bins, occ, scores, tp))
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    serve_launches = BLOCK_SCAN_KERNEL.launches
    cand, u, cand_cnt = outs[0]
    for other in outs[1:]:
        if not all(torch.equal(x, y) for x, y in zip(outs[0], other)):
            raise AssertionError("websearch serve: two calls differ")
    if not (cand.shape == (b, wcfg.max_candidates) and u.shape == (b,)
            and int(cand_cnt.sum()) > 0 and bool((cand < wcfg.n_blocks
                                                   * wcfg.block_docs).all())):
        raise AssertionError("websearch serve: outputs out of shape or range, "
                             "or no candidate")
    ms = statistics.median(times)
    print(f"[websearch] serve_queries: ms per call {[round(t, 1) for t in times]}"
          f" (median {ms:.1f}), {b / (ms / 1e3):.0f} queries/s; mean u "
          f"{float(u.float().mean()):.1f} plane-blocks, mean cand_cnt "
          f"{float(cand_cnt.float().mean()):.1f}; block_scan_pruned_chunk "
          f"{serve_launches / WS_REPS:g} launches a call; peak device memory "
          f"{peak_text(dev)}", flush=True)
    print(f"[websearch] serve_queries: mean blocks scanned per query "
          f"{ws_blocks_scanned(wcfg, q, bins, occ, scores, tp):.2f} (of "
          f"{wcfg.n_blocks}; an untimed rollout)", flush=True)
    held = min(WS_HELD, b)
    ref_cfg = dc.replace(wcfg, backend="reference")
    ref = build_cell("websearch-rl", "serve_queries", reduced=reduced,
                     cfg_override=ref_cfg).fn
    t0 = time.perf_counter()
    want = ref(q, bins, occ[:held], scores[:held], tp[:held])
    sync(dev)
    for name, x, y in zip(("cand", "u", "cand_cnt"), outs[0], want):
        if not torch.equal(x[:held], y):
            raise AssertionError(f"websearch serve: {name} of the first "
                                 f"{held} queries differs from the reference "
                                 f"backend's")
    cut = (f"; {held} queries, not {b}: the reference backend scans a "
           f"block a step" if held < b else "")
    print(f"[websearch] serve_queries: the first {held} of {b} queries "
          f"through the reference backend on the same tensors: cand, u and "
          f"cand_cnt bit-equal ({time.perf_counter() - t0:.1f} s{cut})",
          flush=True)
    if on_card:
        profile_device("websearch serve_queries",
                       lambda: serve(q, bins, occ, scores, tp),
                       "block_scan_pruned_chunk")
    before = BLOCK_SCAN_KERNEL.launches
    times, runs = [], []
    for _ in range(WS_REPS):
        t0 = time.perf_counter()
        runs.append(train(q, bins, occ, scores, tp, prod_r, draws))
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    q_new, metrics = runs[0]
    for q2, m2 in runs[1:]:
        if not (torch.equal(q_new, q2)
                and all(torch.equal(metrics[k], m2[k]) for k in metrics)):
            raise AssertionError("websearch rl_rollout: two runs from the "
                                 "same q and draws differ")
    if not (bool(torch.isfinite(q_new).all()) and not torch.equal(q_new, q)):
        raise AssertionError("websearch rl_rollout: q_new not finite or "
                             "unchanged")
    train_launches = BLOCK_SCAN_KERNEL.launches - before
    launches = read_counts()
    print(f"[websearch] rl_rollout: ms/step {[round(t, 1) for t in times]} "
          f"(the cell's ε 0.1, {b} queries), {WS_REPS} runs from one q and draws "
          f"bit-equal; metrics "
          f"{ {k: round(float(v), 4) for k, v in metrics.items()} }; "
          f"{train_launches / WS_REPS:g} chunk launches a step; peak device "
          f"memory {peak_text(dev)}", flush=True)
    print(f"[websearch] main path launches: {launches}; phase 6 in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    del q, bins, occ, scores, tp, prod_r, draws, outs, runs, want
    return launches


# ------------------------------------------------------------ phase 7
GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
GNN_FALL_STEPS, GNN_TIMED_STEPS = 3, 2
GNN_EQUAL_STEPS = 2            # steps of each of two ogb_products runs
# segment_gather launches a step, written down before the first card
# run: each layer's forward and the hidden layer's backward (the
# features need no gradient); the molecule cell's readout adds one each
# way.
GNN_LAUNCHES_PER_STEP = {"train_graph": 3, "train_minibatch": 3,
                         "train_batched_graphs": 5}
GNN_SKEW = 200                 # the largest in-degree, in mean in-degrees
GNN_CHECK_EDGES = 8_000_000    # ogb_products' check: its first 8 M edges
# Kernel against plain on the card: each element within GNN_TOL of the
# same sum of absolute values (scale * sum |x[idx]|), the size of the
# rounding of a float32 sum in another order (the plain version's
# index_add_ adds through atomics), however much the terms cancel; a
# planted x0.9 on one segment must fail it.
GNN_TOL = 1e-5
GNN_CARD_CPU_TOL = 1e-4        # a reduced step, card vs CPU (float32 GEMMs)


def skewed_degrees(rng, n, e):
    """n in-degrees summing to e: lognormal(0, 1.5) weights with the
    largest raised to GNN_SKEW times their mean, floored, the remainder
    one each to the largest fractional parts."""
    import numpy as np

    w = rng.lognormal(0.0, 1.5, n)
    w[np.argmax(w)] = max(w.max(), GNN_SKEW * w.mean())
    x = w / w.sum() * e
    deg = np.floor(x).astype(np.int64)
    deg[np.argsort(deg - x)[:e - int(deg.sum())]] += 1
    return deg


def gnn_cfg(arch, sp, reduced):
    return dataclasses.replace(arch.model_cfg(reduced), d_in=sp["d_feat"],
                               n_classes=sp["n_classes"])


def gnn_batch(dev, shape, sp, seed):
    """A seeded synthetic batch at the cell's own shape (not a real
    graph): features normal, labels the argmax of the first n_classes
    features (so that the loss can fall); in-degrees ``skewed_degrees``
    (the largest ~GNN_SKEW means) with uniform sources, except in the
    molecule cell, whose 30-node graphs hold 64 uniform edges each.
    minibatch_lg: the whole graph's CSR built on the host, the port's
    ``sample_blocks`` from seeds, blocks padded to the cell's fixed
    budgets (src: the dummy row, dst: the dummy segment).  Returns (the
    batch, edges a step, a note)."""
    import numpy as np
    import torch

    from repro_torch.launch.steps import minibatch_budgets
    from repro_torch.models.gnn import sample_blocks

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    c = sp["n_classes"]
    if "batch_nodes" in sp:
        n, e, bn = sp["n_nodes"], sp["n_edges"], sp["batch_nodes"]
        e1, fr1, e0, fr0 = minibatch_budgets(bn, sp["fanout"])
        t0 = time.perf_counter()
        deg = skewed_degrees(rng, n, e)
        indptr = np.concatenate([[0], np.cumsum(deg)])
        nbrs = rng.integers(0, n, e, dtype=np.int32)
        t_csr = time.perf_counter() - t0
        seeds = rng.choice(n, bn, replace=False)
        t0 = time.perf_counter()
        frontier, blocks = sample_blocks(indptr, nbrs, seeds, sp["fanout"], rng)
        t_sample = time.perf_counter() - t0
        feats_all = torch.randn((n, sp["d_feat"]), generator=gen, device=dev)
        feats = torch.zeros((fr0, sp["d_feat"]), device=dev)
        feats[:len(frontier)] = feats_all[torch.from_numpy(frontier).to(dev)]
        labels = feats[:bn, :c].argmax(1).to(torch.int32)

        def pad(a, size, fill):
            out = np.full(size, fill, np.int32)
            out[:len(a)] = a
            return torch.from_numpy(out).to(dev)

        b0, b1 = blocks
        batch = (feats, pad(b0.src, e0, fr0), pad(b0.dst, e0, fr1),
                 pad(b1.src, e1, fr1), pad(b1.dst, e1, bn), labels)
        note = (f"host CSR of {e:,} edges in {t_csr:.1f} s (largest in-degree "
                f"{deg.max() / deg.mean():.0f}x the mean); sample_blocks "
                f"{t_sample:.2f} s: frontier {len(frontier):,} of {fr0:,}, "
                f"blocks {len(b0.src):,} of {e0:,} and {len(b1.src):,} of "
                f"{e1:,} edges")
        del feats_all, nbrs
        return batch, len(b0.src) + len(b1.src), note
    if "batch" in sp:                       # molecule
        bsz, npg, epg = sp["batch"], sp["n_nodes"], sp["n_edges"]
        base = torch.arange(bsz, device=dev).repeat_interleave(epg) * npg
        edges = torch.stack([
            base + torch.randint(0, npg, (bsz * epg,), generator=gen, device=dev),
            base + torch.randint(0, npg, (bsz * epg,), generator=gen, device=dev),
        ]).to(torch.int32)
        feats = torch.randn((bsz * npg, sp["d_feat"]), generator=gen, device=dev)
        graph_id = torch.arange(bsz, dtype=torch.int32,
                                device=dev).repeat_interleave(npg)
        labels = (feats[:, 0].reshape(bsz, npg).mean(1) > 0).to(torch.int32)
        return ((feats, edges, graph_id, labels), bsz * epg,
                f"{bsz} graphs of {npg} nodes and {epg} uniform edges (no "
                f"100x skew fits a 64-edge graph)")
    n, e = sp["n_nodes"], sp["n_edges"]
    deg = skewed_degrees(rng, n, e)
    dst = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int32, device=dev),
        torch.from_numpy(deg).to(dev), output_size=e)
    dst = dst[torch.randperm(e, generator=gen, device=dev)]
    src = torch.randint(0, n, (e,), generator=gen, device=dev, dtype=torch.int32)
    feats = torch.randn((n, sp["d_feat"]), generator=gen, device=dev)
    labels = feats[:, :c].argmax(1).to(torch.int32)
    mask = torch.ones(n, device=dev)
    return ((feats, torch.stack([src, dst]), labels, mask), e,
            f"largest in-degree {deg.max() / deg.mean():.0f}x the mean "
            f"({deg.max():,} of {e:,} edges)")


def gnn_state(dev, arch, sp, reduced, molecule, seed=SEED):
    """Fresh parameters (seeded), the readout for the molecule cell, and
    zero AdamW state: the arguments before the batch."""
    import torch

    from repro_torch.models.gnn import sage_init
    from repro_torch.models.layers import dense_init
    from repro_torch.train.optimizer import AdamWConfig, adamw_init

    cfg = gnn_cfg(arch, sp, reduced)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 71)
    params = sage_init(cfg, gen=gen)
    if not molecule:
        return params, adamw_init(params, AdamWConfig(lr=1e-3))
    readout = {"w": dense_init(gen, (cfg.n_classes, sp["n_classes"])),
               "b": torch.zeros(sp["n_classes"], device=dev)}
    return params, readout, adamw_init((params, readout), AdamWConfig(lr=1e-3))


def gnn_layer_graphs(shape, cfg, batch, dev):
    """(x, src, dst, n_dst) of each aggregate of the cell's step: layer
    0 on the features, layer 1 on a seeded (rows, d_hidden) input over
    the same (or the inner block's) edges, and the molecule readout."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 81)

    def hidden(rows):
        return torch.randn((rows, cfg.d_hidden), generator=gen, device=dev)

    if shape == "minibatch_lg":
        feats, s0, d0, s1, d1, labels = batch
        fr1, bn = s1.numel() + labels.numel(), labels.numel()
        return [("layer 0", feats, s0, d0, fr1),
                ("layer 1", hidden(fr1), s1, d1, bn)]
    feats, edges = batch[0], batch[1]
    n = feats.shape[0]
    out = [("layer 0", feats, edges[0], edges[1], n),
           ("layer 1", hidden(n), edges[0], edges[1], n)]
    if shape == "molecule":
        graph_id = batch[2]
        out.append(("readout", torch.randn((n, cfg.n_classes), generator=gen,
                                           device=dev),
                    torch.arange(n, dtype=torch.int32, device=dev), graph_id,
                    int(graph_id.max()) + 1))
    if shape == "ogb_products":          # the plain (E, d) must fit
        out = [(f"{name}, first {GNN_CHECK_EDGES:,} edges", x,
                src[:GNN_CHECK_EDGES], dst[:GNN_CHECK_EDGES], n_dst)
               for name, x, src, dst, n_dst in out]
    return out


def gather_check(name, x, src, dst, n_dst):
    """The kernel against its plain version, forward (with scale) and
    backward (the transposed CSR): bit-equal to the plain version on the
    CPU, which adds in the kernel's order (each segment's edge order),
    both ways; and on the card against the plain version there (its
    index_add_ adds through atomics) and, for the backward, autograd of
    the plain gather and index_add_: each element within GNN_TOL of its
    sum of absolute values, empty segments exactly 0, and a planted x0.9
    on the largest segment rejected; the rows' relative L2 error is
    printed.  Returns the largest |kernel - plain on the card|."""
    import torch

    from repro_torch.kernels.segment_gather import (SegmentCSR,
                                                    segment_gather_sum,
                                                    segment_gather_sum_ref,
                                                    segment_mean)

    def within(a, b, size):
        return bool(((a - b).abs() <= GNN_TOL * size).all())

    csr = SegmentCSR(src, dst, x.shape[0], n_dst)
    got = segment_gather_sum(x, csr.idx, csr.ptr, csr.scale)
    want = segment_gather_sum_ref(x, csr.idx, csr.ptr, csr.scale)
    size = segment_gather_sum_ref(x.abs(), csr.idx, csr.ptr, csr.scale)
    empty = want.norm(dim=-1) == 0
    err = row_rel_err(got, want)
    bad = got.clone()
    bad[int(want.norm(dim=-1).argmax())] *= PLANTED_SCALE
    if not (within(got, want, size) and bool((got[empty] == 0).all())
            and not within(bad, want, size)):
        raise AssertionError(f"segment_gather {name}: kernel vs plain past "
                             f"{GNN_TOL} of the sum of |x| (row error "
                             f"{err:.3g}), or the planted fault passed")
    gen = torch.Generator(device=x.device)
    gen.manual_seed(SEED + 91)
    g = torch.randn(want.shape, generator=gen, device=x.device)
    xk = x.detach().clone().requires_grad_()
    (gk,) = torch.autograd.grad(segment_mean(xk, csr), xk, g)
    idx_t, ptr_t = csr.transposed()
    cpu = [t.cpu() for t in (x, csr.idx, csr.ptr, csr.scale, idx_t, ptr_t,
                             g * csr.scale[:, None])]
    if not (torch.equal(got.cpu(), segment_gather_sum_ref(*cpu[:4]))
            and torch.equal(gk.cpu(), segment_gather_sum_ref(cpu[6], *cpu[4:6]))):
        raise AssertionError(f"segment_gather {name}: the kernel's forward or "
                             f"backward differs from the plain version's bits "
                             f"on the CPU (the same order of adds)")
    del cpu
    xp = x.detach().clone().requires_grad_()
    keep = (dst.long() >= 0) & (dst.long() < n_dst) & (src.long() < x.shape[0])
    msgs = xp[src.long()[keep]]
    plain = torch.zeros(want.shape, device=x.device).index_add(
        0, dst.long()[keep], msgs) * csr.scale[:, None]
    (gp,) = torch.autograd.grad(plain, xp, g, retain_graph=True)
    (gsize,) = torch.autograd.grad(plain, xp, g.abs())
    gerr = row_rel_err(gk, gp)
    if not within(gk, gp, gsize):
        raise AssertionError(f"segment_gather {name}: gradient through the "
                             f"kernel vs the plain version past {GNN_TOL} of "
                             f"the sum of |g| (row error {gerr:.3g})")
    e_valid = int(csr.ptr[-1])
    mx = float((got - want).abs().max()) if got.numel() else 0.0
    print(f"[gnn] check {name}: x {tuple(x.shape)}, {e_valid:,} edges into "
          f"{n_dst:,} segments; kernel bit-equal to the plain version on the "
          f"CPU both ways; kernel vs plain within {GNN_TOL} of the sum "
          f"of |x|, row rel err {err:.3g}, max |d| {mx:.3g}, empty segments "
          f"exactly 0, x0.9 planted on one segment rejected; gradient within "
          f"{GNN_TOL} of the sum of |g|, row rel err {gerr:.3g}", flush=True)
    return mx


def gather_bounds(x, idx, ptr, scale):
    """(compulsory ms, gathered-row ms) of one gather-sum call, over the
    memory rate.  Compulsory: its ``cost`` (x, idx, ptr and scale read
    once, out and the ticket written once).  Gathered rows: every valid
    edge's row read, less the share the card's L2 can serve when sources
    are uniform (L2 / |x|), in place of x's one read, and the rest of the
    compulsory bytes."""
    import torch

    from repro_torch.kernels.segment_gather.ops import cost as gather_cost

    n, d = x.shape
    c = gather_cost(x, idx, ptr, scale)
    e = int(ptr[-1])
    ids = idx[:e]
    e_valid = int(((ids >= 0) & (ids < n)).sum())
    x_bytes = 4 * n * d
    l2 = torch.cuda.get_device_properties(x.device).L2_cache_size
    rows = max(x_bytes, 4 * e_valid * d * (1 - min(1.0, l2 / x_bytes)))
    return (c.bytes / HBM_BYTES_PER_S * 1e3,
            (c.bytes - x_bytes + rows) / HBM_BYTES_PER_S * 1e3)


def degree_profile(ptr):
    """Text: a CSR's largest segment (edges, over the mean) and the share
    of the edges that its top 1% of segments hold."""
    import torch

    deg = ptr.diff().double()
    top = torch.topk(deg, max(1, deg.numel() // 100)).values
    return (f"largest {int(deg.max()):,} edges ({float(deg.max() / deg.mean()):.1f}x "
            f"the mean {float(deg.mean()):.2f}), top 1% of segments "
            f"{100 * float(top.sum() / deg.sum()):.2f}% of the edges")


def gnn_kernel_times(feats, edges, flush):
    """The kernel's row: ogb_products' layer-0 aggregate timed cold
    (after a 1 GiB read) beside its bound (x, idx, ptr and scale read
    once, out written once, over the memory rate; E d fp32 adds over the
    fp32 rate) and its gathered-row bound (``gather_bounds``), the plain
    version and ``F.embedding_bag`` (sum, unscaled; the port never calls
    it); the layer-1 width (d 128) forward and its backward over the
    transposed CSR too, each with both bounds; the CSRs' degree profiles
    and the kernel's CTAs a multiprocessor."""
    import ctypes

    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.segment_gather import (SEGMENT_GATHER_KERNEL,
                                                    SegmentCSR,
                                                    segment_gather_sum,
                                                    segment_gather_sum_ref)
    from repro_torch.kernels.segment_gather.ops import cost as gather_cost

    n, d = feats.shape
    csr = SegmentCSR(edges[0], edges[1], n, n)
    idx_t, ptr_t = csr.transposed()
    e = int(csr.ptr[-1])
    ms = time_cuda(lambda: segment_gather_sum(feats, csr.idx, csr.ptr,
                                              csr.scale), 5, flush)
    c = gather_cost(feats, csr.idx, csr.ptr, csr.scale)
    bytes_moved = c.bytes
    t_bytes, gathered = gather_bounds(feats, csr.idx, csr.ptr, csr.scale)
    t_ops = c.flops / FP32_FLOPS_PER_S * 1e3
    bound, by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                      "operations")
    offsets = csr.ptr[:-1].to(torch.int32)
    lib_ms = time_cuda(lambda: F.embedding_bag(csr.idx, feats, offsets,
                                               mode="sum"), 5, flush)
    plain_ms = time_cuda(lambda: segment_gather_sum_ref(
        feats, csr.idx, csr.ptr, csr.scale), 2, flush)
    h = torch.randn((n, 128), device=feats.device)
    ms_128 = time_cuda(lambda: segment_gather_sum(h, csr.idx, csr.ptr,
                                                  csr.scale), 5, flush)
    b_128, g_128 = gather_bounds(h, csr.idx, csr.ptr, csr.scale)
    ms_bwd = time_cuda(lambda: segment_gather_sum(h, idx_t, ptr_t), 5, flush)
    b_bwd, g_bwd = gather_bounds(h, idx_t, ptr_t, None)
    lib = ctypes.CDLL(str(SEGMENT_GATHER_KERNEL._lib_path()))
    ctas = ctypes.c_int(0)
    lib.segment_gather_blocks_per_sm(1, ctypes.byref(ctas))
    print(f"[kernel] segment_gather CSR by dst: {degree_profile(csr.ptr)}; "
          f"by src (the backward's): {degree_profile(ptr_t)}; "
          f"{ctas.value} CTAs of 256 threads a multiprocessor on the 16-byte "
          f"path", flush=True)
    print(f"[kernel] segment_gather ogb_products layer 0 (N {n:,}, d {d}, "
          f"E {e:,}): {ms:.6f} ms cold, bound {bound:.6f} ms ({by}: "
          f"{bytes_moved / 1e9:.3f} GB compulsory; the gathered rows E d 4 = "
          f"{4 * e * d / 1e9:.2f} GB), gathered-row bound {gathered:.6f} ms "
          f"({ms / gathered:.3f}x), {bytes_moved / ms / 1e6:.1f} GB/s "
          f"compulsory, {4 * e * d / ms / 1e6:.1f} GB/s gathered; plain "
          f"{plain_ms:.3f} ms; F.embedding_bag (sum, unscaled) {lib_ms:.6f} "
          f"ms; at d 128 (layer 1) {ms_128:.6f} ms (bound {b_128:.6f}, "
          f"gathered-row bound {g_128:.6f}, {ms_128 / g_128:.3f}x); its "
          f"backward over the transposed CSR at d 128 {ms_bwd:.6f} ms (bound "
          f"{b_bwd:.6f}, gathered-row bound {g_bwd:.6f}, {ms_bwd / g_bwd:.3f}x)",
          flush=True)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms, gathered_bound_ms=gathered, ms_d128=ms_128,
                gathered_bound_ms_d128=g_128, ms_bwd_d128=ms_bwd,
                gathered_bound_ms_bwd_d128=g_bwd, ctas_per_sm=ctas.value)


def gnn_card_vs_cpu(dev, shape="full_graph_sm"):
    """A reduced cell's step on the card against the port on the CPU from
    one state and batch: the loss and every leaf within GNN_CARD_CPU_TOL
    relative L2."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import REDUCED_SHAPES, build_cell
    from repro_torch.train.tree import tree_leaves, tree_map

    arch = get_arch("graphsage-reddit")
    sp = REDUCED_SHAPES[arch.shape(shape).kind]
    cpu = torch.device("cpu")
    state = gnn_state(cpu, arch, sp, True, False)
    batch, _, _ = gnn_batch(cpu, shape, sp, SEED + 101)
    fn = build_cell("graphsage-reddit", shape, reduced=True).fn
    on_dev = fn(*tree_map(lambda t: t.to(dev, copy=True), state),
                *[t.to(dev) for t in batch])
    on_cpu = fn(*state, *batch)
    worst = 0.0
    for a, b in zip(tree_leaves(on_dev), tree_leaves(on_cpu)):
        diff = (a.cpu().double() - b.double()).norm()
        worst = max(worst, float(diff / b.double().norm().clamp_min(1e-30)))
    if worst > GNN_CARD_CPU_TOL:
        raise AssertionError(f"graphsage {shape} reduced: card vs CPU {worst:.3g}")
    print(f"[gnn] {shape} reduced: one step card vs CPU, loss "
          f"{float(on_dev[-1]):.6f} vs {float(on_cpu[-1]):.6f}, worst leaf "
          f"relative L2 {worst:.3g} (tol {GNN_CARD_CPU_TOL})", flush=True)


def gnn_phase(dev, reduced=False):
    """Phase 7: the four graphsage-reddit cells at their published shapes
    (``gnn_batch``) through ``build_cell("graphsage-reddit", ...).fn``.
    First, uncounted: the kernel against its plain version at every
    cell's aggregate shapes (``gather_check``), a reduced step card vs
    CPU, and the kernel's row (``gnn_kernel_times``).  Then the main path
    between a reset and a read of the counts: each cell 3 steps on one
    batch (the loss falling), 2 timed steps (ms/step, edges/s, peak
    memory), segment_gather launches a step against
    GNN_LAUNCHES_PER_STEP; ogb_products also two fresh runs of 2 steps
    bit-equal and a profiled step.  ``reduced`` runs the reduced cells
    (a CPU rehearsal).  Returns (launch counts, the kernel's row)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels.segment_gather import SEGMENT_GATHER_KERNEL
    from repro_torch.launch.steps import REDUCED_SHAPES, build_cell
    from repro_torch.train.tree import tree_leaves

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    arch = get_arch("graphsage-reddit")
    specs = {s: (arch.shape(s).kind, dict(REDUCED_SHAPES[arch.shape(s).kind])
                 if reduced else dict(arch.shape(s).params))
             for s in GNN_SHAPES}
    batches = {}
    worst = 0.0
    for i, shape in enumerate(GNN_SHAPES):
        t0 = time.perf_counter()
        batch, edges, note = gnn_batch(dev, shape, specs[shape][1], SEED + 63 + i)
        sync(dev)
        batches[shape] = (batch, edges)
        print(f"[gnn] {shape} ({specs[shape][0]}): {specs[shape][1]}; "
              f"synthetic, seeded: {note}; made in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        cfg = gnn_cfg(arch, specs[shape][1], reduced)
        if on_card:
            for args in gnn_layer_graphs(shape, cfg, batch, dev):
                worst = max(worst, gather_check(f"{shape} {args[0]}", *args[1:]))
                torch.cuda.empty_cache()
    row = {"max_abs_err": worst}
    if on_card:
        gnn_card_vs_cpu(dev)
        flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
        feats, edges = batches["ogb_products"][0][:2]
        row.update(gnn_kernel_times(feats, edges, flush))
        del flush
        torch.cuda.empty_cache()
    print(f"[gnn] checks and kernel times in {time.perf_counter() - t_phase:.1f}"
          f" s", flush=True)

    reset_counts()
    for shape in GNN_SHAPES:
        kind, sp = specs[shape]
        batch, edges = batches[shape]
        molecule = kind == "train_batched_graphs"
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        cell = build_cell("graphsage-reddit", shape, reduced=reduced)

        def step(*args):
            return cell.fn(*args)[-3:]      # (..., opt_state, loss)

        state = gnn_state(dev, arch, sp, reduced, molecule)
        before = SEGMENT_GATHER_KERNEL.launches
        falling_steps(step, state, batch, GNN_FALL_STEPS, f"graphsage {shape}")
        times = []
        for _ in range(GNN_TIMED_STEPS):         # on the same batch
            t0 = time.perf_counter()
            step(*state, *batch)
            sync(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        per_step = ((SEGMENT_GATHER_KERNEL.launches - before)
                    / (GNN_FALL_STEPS + GNN_TIMED_STEPS))
        want = GNN_LAUNCHES_PER_STEP[kind] if on_card else 0
        if per_step != want:
            raise AssertionError(f"graphsage {shape}: {per_step:g} "
                                 f"segment_gather launches a step, want {want}")
        print(f"[gnn] {shape}: ms/step {[round(t, 3) for t in times]}, "
              f"{edges / (min(times) / 1e3):.4g} edges/s at the fastest "
              f"({edges:,} edges a step); segment_gather {per_step:g} "
              f"launches a step (written down before the run: {want}); peak "
              f"device memory {peak_text(dev)}", flush=True)
        if shape == "ogb_products":
            runs = []
            for _ in range(2):
                st = gnn_state(dev, arch, sp, reduced, molecule)
                for _ in range(GNN_EQUAL_STEPS):
                    step(*st, *batch)
                runs.append([t.clone() for t in tree_leaves(st)])
            if not all(torch.equal(a, b) for a, b in zip(*runs)):
                raise AssertionError("graphsage ogb_products: two runs from "
                                     "one seed differ")
            print(f"[gnn] ogb_products: two runs of {GNN_EQUAL_STEPS} steps "
                  f"from one seed: parameters and moments bit-equal",
                  flush=True)
            if on_card:
                profile_device("graphsage ogb_products train step",
                               lambda: step(*state, *batch), "segment_gather",
                               host=False, shares=("sort", "elementwise",
                                                   "gemm"))
        del state, cell
    launches = read_counts()
    print(f"[gnn] main path launches: {launches}; phase 7 in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    del batches
    return launches, row


# ------------------------------------------------------------ phase 8
MESH_LOGIT_TOL = 1e-5          # sharded vs unsharded logits: atol + rtol
MESH_LEAF_TOL = 1e-4           # each leaf after one step, relative L2
# Phase 8b's bf16 DeepSeek-V2-Lite step, each parameter and moment leaf
# against the unsharded step: relative L2.  Both paths are deterministic
# and agree to 1.6e-6 in float32 (the fp32 check beside it), but the
# sharded graph has more nodes (the collectives, the masked lookup, the
# vocab-parallel logsumexp), so autograd adds a bf16 tensor's three or
# more gradient contributions in another order; each such sum rounds to
# bf16 (2^-9 relative) and the roundings compound down the layers: 0.37%
# of relative L2 at one layer, 0.86% (moments 1.15%) at four (H100
# probes, with and without sp_carry alike).  2e-2 is 1.7x the
# largest seen; the loss and the norm stay at MESH_LEAF_TOL.
MESH_BF16_STEP_TOL = 2e-2
MESH_FP32_LAYERS = 2           # the fp32 gradient check: layers, 1 x 4096
MESH_MOE_TOKENS = 4096         # tokens through DeepSeek-V2-Lite's FFN
MESH_MOE_TOL = 1e-5            # float32 experts, atol


def mesh_timed(dev, fn):
    """(result, ms) of one call, ending in a synchronise."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, (time.perf_counter() - t0) * 1e3


def mesh_websearch(dev, mesh, reduced):
    """The websearch-rl cells through the sharded ``build_cell`` on a
    one-rank mesh, against the unsharded cells on the same inputs (phase
    6's synthetic occupancy): cand, u, cand_cnt and q_new (and the
    metrics) bit-equal.  The sharded calls run between a reset and a read
    of the launch counts."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.distributed import place_tree
    from repro_torch.launch.steps import REDUCED_SHAPES, build_cell

    arch = get_arch("websearch-rl")
    wcfg = arch.model_cfg(reduced)
    b = (REDUCED_SHAPES["serve_websearch"] if reduced
         else arch.shape("serve_queries").params)["query_batch"]
    q, bins, occ, scores, tp, prod_r, draws = ws_inputs(dev, wcfg, b, SEED + 81)
    serve = build_cell("websearch-rl", "serve_queries", reduced=reduced)
    train = build_cell("websearch-rl", "rl_rollout", reduced=reduced)
    want_s, ms_s = mesh_timed(dev, lambda: serve.fn(q, bins, occ, scores, tp))
    want_t, ms_t = mesh_timed(dev, lambda: train.fn(q, bins, occ, scores, tp,
                                                    prod_r, draws))
    s_serve = build_cell("websearch-rl", "serve_queries", mesh=mesh,
                         reduced=reduced)
    s_train = build_cell("websearch-rl", "rl_rollout", mesh=mesh, reduced=reduced)
    # the cell's arguments as DTensors placed by its shardings: copies,
    # one at a time, each original freed as its copy replaces it
    occ = place_tree(occ, s_serve.in_shardings[2])
    scores = place_tree(scores, s_serve.in_shardings[3])
    tp = place_tree(tp, s_serve.in_shardings[4])
    sync(dev)
    reset_counts()
    got_s, sms_s = mesh_timed(dev, lambda: s_serve.fn(q, bins, occ, scores, tp))
    got_t, sms_t = mesh_timed(dev, lambda: s_train.fn(q, bins, occ, scores, tp,
                                                      prod_r, draws))
    launches = read_counts()
    for name, g, w in zip(("cand", "u", "cand_cnt"), got_s, want_s):
        if not torch.equal(g.full_tensor(), w):
            raise AssertionError(f"mesh websearch serve: {name} differs from "
                                 f"the unsharded cell's")
    q_new, metrics = got_t
    if not (torch.equal(q_new.full_tensor(), want_t[0]) and all(
            torch.equal(metrics[k].full_tensor(), want_t[1][k])
            for k in want_t[1])):
        raise AssertionError("mesh websearch rl_rollout: q_new or a metric "
                             "differs from the unsharded cell's")
    print(f"[mesh] websearch-rl at {b} queries x {wcfg.n_blocks} blocks x "
          f"{wcfg.block_docs} docs (phase 6's synthetic inputs, seed "
          f"{SEED + 81}): sharded serve_queries {sms_s:.1f} ms (unsharded "
          f"{ms_s:.1f} ms), cand, u and cand_cnt bit-equal; sharded "
          f"rl_rollout {sms_t:.1f} ms (unsharded {ms_t:.1f} ms), q_new and "
          f"the metrics bit-equal; launches {launches}", flush=True)
    return launches


def mesh_wide_deep(dev, mesh, reduced, batch_cap=None):
    """Wide&Deep at its config through the sharded cells on a one-rank
    mesh against the unsharded cells on one state: serve_bulk's logits
    within MESH_LOGIT_TOL + MESH_LOGIT_TOL|x|, and one train_batch step's
    loss and every leaf within MESH_LEAF_TOL relative L2.  The sharded
    calls run between a reset and a read of the launch counts (``main``
    requires a bag launch there)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.distributed import place_tree
    from repro_torch.launch.steps import build_cell
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.tree import leaf_paths, tree_leaves

    arch = get_arch("wide-deep")
    cfg = arch.model_cfg(reduced)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 82)
    b_serve = min(arch.shape("serve_bulk").params["batch"], batch_cap or 1 << 30)
    b_train = min(arch.shape("train_batch").params["batch"], batch_cap or 1 << 30)
    sparse, dense, _ = recsys_train_batch("wide-deep", cfg, b_serve, gen, dev)
    batch = recsys_train_batch("wide-deep", cfg, b_train, gen, dev)
    params = recsys_train_init("wide-deep", cfg, dev)
    opt_cfg = AdamWConfig(lr=1e-3)
    s_serve = build_cell("wide-deep", "serve_bulk", mesh=mesh, reduced=reduced)
    s_train = build_cell("wide-deep", "train_batch", mesh=mesh, reduced=reduced)
    s_params = place_tree(params, s_train.in_shardings[0])
    s_opt = place_tree(adamw_init(params, opt_cfg), s_train.in_shardings[1])
    with torch.no_grad():
        want, ms_s = mesh_timed(dev, lambda: build_cell(
            "wide-deep", "serve_bulk", reduced=reduced).fn(params, sparse, dense))
    opt = adamw_init(params, opt_cfg)
    (params, _, loss), ms_t = mesh_timed(dev, lambda: build_cell(
        "wide-deep", "train_batch", reduced=reduced).fn(params, opt, *batch))
    del opt
    sync(dev)
    reset_counts()
    with torch.no_grad():
        got, sms_s = mesh_timed(dev, lambda: s_serve.fn(s_params, sparse, dense))
    (s_params, s_opt, s_loss), sms_t = mesh_timed(
        dev, lambda: s_train.fn(s_params, s_opt, *batch))
    launches = read_counts()
    got = got.full_tensor()
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=MESH_LOGIT_TOL, atol=MESH_LOGIT_TOL):
        raise AssertionError(f"mesh wide-deep serve_bulk: logits differ from "
                             f"the unsharded cell's by {err:g}")
    if not abs(float(s_loss) - float(loss)) <= MESH_LEAF_TOL * abs(float(loss)):
        raise AssertionError(f"mesh wide-deep train: loss {float(s_loss)} != "
                             f"{float(loss)}")
    worst = 0.0
    for path, p, sp in zip(leaf_paths(params), tree_leaves(params),
                           tree_leaves(s_params)):
        rel = float(torch.linalg.vector_norm((sp.full_tensor() - p).float())
                    / torch.linalg.vector_norm(p.float()).clamp_min(1e-30))
        worst = max(worst, rel)
        if rel > MESH_LEAF_TOL:
            raise AssertionError(f"mesh wide-deep train: leaf {path} off by "
                                 f"{rel:g} relative L2")
    bags = launches["embedding_bag"] + launches["embedding_bag_lanes"]
    print(f"[mesh] wide-deep ({'reduced' if reduced else 'full'} config): "
          f"sharded serve_bulk at {b_serve} {sms_s:.1f} ms (unsharded "
          f"{ms_s:.1f} ms), logits max |diff| {err:g}; sharded train_batch at "
          f"{b_train} {sms_t:.1f} ms (unsharded {ms_t:.1f} ms), loss "
          f"{float(s_loss):.6f} vs {float(loss):.6f}, worst leaf relative L2 "
          f"{worst:g}; launches {launches} (bag kernels {bags})", flush=True)
    return launches


def mesh_moe(dev, mesh, reduced, tokens=MESH_MOE_TOKENS):
    """``moe_ffn_sharded`` (EP: E % 1 == 0) at DeepSeek-V2-Lite's FFN
    widths in float32 against ``moe_ffn`` on the same tokens."""
    import dataclasses as dc

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.moe import moe_ffn, moe_ffn_sharded, moe_init

    mcfg = get_arch("deepseek-v2-lite-16b").model_cfg(reduced).moe
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 83)
    params = moe_init(gen, mcfg, dtype=torch.float32)
    x = torch.randn((tokens, mcfg.d_model), generator=gen, device=dev)
    with torch.no_grad():
        (want, _), ms = mesh_timed(dev, lambda: moe_ffn(params, x, mcfg))
        reset_counts()
        (got, _), sms = mesh_timed(dev, lambda: moe_ffn_sharded(params, x, mcfg,
                                                                 mesh))
        launches = read_counts()
    err = float((got.full_tensor() - want).abs().max())
    if not err <= MESH_MOE_TOL:
        raise AssertionError(f"mesh moe_ffn_sharded differs from moe_ffn by {err:g}")
    print(f"[mesh] moe_ffn_sharded at DeepSeek-V2-Lite's widths ("
          f"{dc.asdict(mcfg)}), {tokens} tokens, float32: {sms:.1f} ms "
          f"(moe_ffn {ms:.1f} ms), max |diff| {err:g} (tolerance "
          f"{MESH_MOE_TOL:g}); launches {launches} (no kernel on this path: "
          f"the MoE FFN is plain torch, as in the reference)", flush=True)
    return launches


def mesh_phase(dev, reduced=False, batch_cap=None, moe_tokens=MESH_MOE_TOKENS,
               **lm_gnn):
    """Phase 8: the mesh on one card.  A one-rank world (NCCL on the card,
    gloo for a CPU rehearsal; a ``FileStore`` rendezvous in a temporary
    directory) and a 1 x 1 ``make_local_mesh``; then the sharded
    websearch-rl cells at full width, Wide&Deep's sharded serve_bulk and
    one sharded train_batch step, and ``moe_ffn_sharded`` at
    DeepSeek-V2-Lite's widths, each against its unsharded counterpart;
    then phase 8b in the same world (``mesh_lm_gnn_phase``, which takes
    ``lm_gnn``'s sizes).  At world size 1 every collective is an
    identity.  Returns the summed launch counts of phase 8's sharded
    paths and of phase 8b's."""
    import os
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.distributed.collectives import psum
    from repro_torch.launch.mesh import make_local_mesh

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    backend = "nccl" if on_card else "gloo"
    tmp = tempfile.mkdtemp(prefix="mesh_store_")
    dist.init_process_group(backend, rank=0, world_size=1,
                            store=dist.FileStore(os.path.join(tmp, "store"), 1))
    try:
        mesh = make_local_mesh(1, 1, device=dev.type)
        # build each axis's communicator before any timed call
        one = torch.ones((), device=dev)
        for axis in mesh.mesh_dim_names:
            psum(one, mesh, axis)
        sync(dev)
        nccl = ".".join(map(str, torch.cuda.nccl.version())) if on_card else "n/a"
        print(f"[mesh] a one-rank {backend} world (FileStore rendezvous) and a "
              f"1 x 1 make_local_mesh on {dev.type}; NCCL {nccl}; card "
              f"{card_line() if on_card else 'n/a (CPU)'}.  At world size 1 "
              f"every collective is an identity: multi-card NCCL, the TP "
              f"regime (it needs M > E) and the cost of collectives are not "
              f"measured here", flush=True)
        parts = [mesh_websearch(dev, mesh, reduced)]
        if on_card:
            torch.cuda.empty_cache()
        parts.append(mesh_wide_deep(dev, mesh, reduced, batch_cap))
        if on_card:
            torch.cuda.empty_cache()
        parts.append(mesh_moe(dev, mesh, reduced, moe_tokens))
        launches = {k: sum(p[k] for p in parts) for k in parts[0]}
        print(f"[mesh] sharded paths' launches: {launches}; phase 8 in "
              f"{time.perf_counter() - t_phase:.1f} s", flush=True)
        if on_card:
            torch.cuda.empty_cache()
        lm_launches = mesh_lm_gnn_phase(dev, mesh, reduced, **lm_gnn)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, lm_launches


# ----------------------------------------------------------- phase 8b
MESH_LM_LAYERS = 4             # of mistral-nemo-12b's 40, DeepSeek-V2-Lite's 27
MESH_LM_STEPS = 8              # decode steps through the sequence-sharded cache
GNN_MESH_SHAPE = "ogb_products"
GNN_MESH_SEED = SEED + 63 + GNN_SHAPES.index(GNN_MESH_SHAPE)   # phase 7's batch


def attention_layer0_mesh(s_params, tokens, cfg, mesh):
    """Layer 0's attention output on the prompt through the mesh path:
    the vocab-parallel lookup, ln1, ``MeshLM.enter``, the rank's heads
    (``gqa_forward_tp``, through the flash kernel with ``use_flash``) and
    the sum over ``model``.  This rank's rows."""
    from repro_torch.distributed.embedding_ops import lookup_local
    from repro_torch.models.attention import gqa_forward_tp
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.transformer import MeshLM, local_params

    lp = local_params(s_params, cfg, mesh)
    ml = MeshLM.of(cfg, mesh, tokens.shape[0])          # prefill: no sp carry
    x = lookup_local(lp["embed"], ml.rows_block(tokens.long()), mesh)
    h = ml.enter(rms_norm(x, lp["layers"]["ln1"][0]))
    out = gqa_forward_tp({k: w[0] for k, w in lp["layers"]["attn"].items()}, h,
                         cfg.attn_cfg(), ml.split)
    return ml.leave(out)


def mesh_mistral(dev, mesh, reduced, batch=LM_BATCH, prompt=LM_PROMPT,
                 steps=MESH_LM_STEPS):
    """mistral-nemo-12b at full width, MESH_LM_LAYERS layers, bf16,
    ``use_flash``: the sharded ``prefill_32k`` cell at batch x prompt and
    ``steps`` greedy steps of the sharded ``decode_32k`` cell through its
    sequence-sharded cache, against ``prefill`` and ``decode_step`` from
    one state and one token sequence (run first, uncounted).  Layer-0
    attention within BF16_TOL + BF16_TOL|x|, the caches and every step's
    logits within the same, the argmax equal; flash launches one a layer,
    decode launches one a layer a step."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.distributed import NamedSharding, kv_cache_specs, place_tree
    from repro_torch.launch.steps import build_cell
    from repro_torch.models.transformer import decode_step, init_params, prefill
    from repro_torch.train.tree import tree_map

    base = get_arch(LM_ARCH).model_cfg(reduced)
    cfg = dataclasses.replace(base, use_flash=True,
                              n_layers=min(MESH_LM_LAYERS, base.n_layers))
    on_card = dev.type == "cuda"
    params = init_params(cfg, seed=SEED + 84, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 84)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt), generator=gen,
                           device=dev)
    pre = build_cell(LM_ARCH, "prefill_32k", mesh=mesh, reduced=reduced,
                     cfg_override=cfg)
    dec = build_cell(LM_ARCH, "decode_32k", mesh=mesh, reduced=reduced,
                     cfg_override=cfg)
    s_params = place_tree(params, pre.in_shardings[0])
    pos0 = torch.full((batch,), prompt, dtype=torch.int64, device=dev)
    with torch.no_grad():
        prefill(params, tokens, cfg, device=dev)        # warm, untimed
        (want_logits, cache), ms = mesh_timed(
            dev, lambda: prefill(params, tokens, cfg, device=dev))
        want_att = attention_layer0(params, tokens, cfg).float()
        want_cache = {f: c.clone() for f, c in cache.items()}
        cache = {f: F.pad(c, (0, 0, 0, 0, 0, steps)) for f, c in cache.items()}
        token, pos, want, ms_dec = want_logits.argmax(-1), pos0, [], []
        for _ in range(steps):
            (logits, cache), t = mesh_timed(dev, lambda: decode_step(
                params, token, cache, pos, cfg, device=dev))
            want.append(logits)
            ms_dec.append(t)
            token, pos = logits.argmax(-1), pos + 1
        del cache
        got_att = attention_layer0_mesh(s_params, tokens, cfg, mesh).float()
        sync(dev)
        reset_counts()
        (got_logits, s_cache), sms = mesh_timed(dev, lambda: pre.fn(s_params,
                                                                    tokens))
        prefill_launches = read_counts()
        got_logits = got_logits.full_tensor()
        got_cache = {f: c.full_tensor() for f, c in s_cache.items()}
        padded = {f: F.pad(c, (0, 0, 0, 0, 0, steps)) for f, c in got_cache.items()}
        s_cache = place_tree(padded, tree_map(lambda s: NamedSharding(mesh, s),
                                              kv_cache_specs(padded, mesh)))
        del padded
        token, pos, got, sms_dec = want_logits.argmax(-1), pos0, [], []
        for i in range(steps):
            (logits, s_cache), t = mesh_timed(dev, lambda: dec.fn(
                s_params, token, s_cache, pos))
            got.append(logits.full_tensor())
            sms_dec.append(t)
            token, pos = want[i].argmax(-1), pos + 1
        launches = read_counts()
        del s_cache

    def check(name, a, b):
        a, b = a.float(), b.float()
        diff = (a - b).abs()
        if not bool((diff <= BF16_TOL + BF16_TOL * b.abs()).all()):
            raise AssertionError(f"mesh {LM_ARCH} {name}: past {BF16_TOL} + "
                                 f"{BF16_TOL}|x| (max |d| {float(diff.max()):g})")
        return float(diff.max())

    errs = {"layer-0 attention": check("layer-0 attention", got_att, want_att),
            "prefill logits": check("prefill logits", got_logits, want_logits)}
    for f in want_cache:
        errs[f"cache {f}"] = check(f"cache {f}", got_cache[f], want_cache[f])
    if not torch.equal(got_logits.argmax(-1), want_logits.argmax(-1)):
        raise AssertionError(f"mesh {LM_ARCH} prefill: logits' argmax differs")
    for i, (g, w) in enumerate(zip(got, want)):
        errs[f"decode step {i}"] = check(f"decode step {i}", g, w)
        if not torch.equal(g.argmax(-1), w.argmax(-1)):
            raise AssertionError(f"mesh {LM_ARCH} decode step {i}: argmax "
                                 f"differs")
    n = cfg.n_layers if on_card else 0
    want_counts = {"flash_attention_tc": n, "decode_attention_tc": n * steps}
    for name, k in want_counts.items():
        if launches[name] != k:
            raise AssertionError(f"mesh {LM_ARCH}: {launches[name]} {name} "
                                 f"launches, want {k}")
    if launches["decode_attention"] or launches["flash_attention"]:
        raise AssertionError(f"mesh {LM_ARCH}: a CUDA-core attention launch on "
                             f"the bf16 D 128 path")
    print(f"[mesh-lm] {LM_ARCH} at full width, {cfg.n_layers} of 40 layers "
          f"(depth cut: phase 8b's time), {cfg.param_dtype}, use_flash, random "
          f"weights: "
          f"sharded prefill_32k at {batch} x {prompt} {sms:.1f} ms (unsharded "
          f"prefill {ms:.1f} ms; prefill launches {prefill_launches}); "
          f"{steps} sharded decode_32k steps through the sequence-sharded "
          f"cache, ms {[round(t, 2) for t in sms_dec]} (unsharded "
          f"{[round(t, 2) for t in ms_dec]}); max |d| "
          f"{', '.join(f'{k} {v:.3g}' for k, v in errs.items())} "
          f"(tol {BF16_TOL} + {BF16_TOL}|x|), argmax equal at every step; "
          f"launches {launches}", flush=True)
    return launches


def mesh_deepseek_train(dev, mesh, reduced, batch=LM_TRAIN_BATCH,
                        seq=LM_TRAIN_SEQ):
    """DeepSeek-V2-Lite at full width: one sharded ``train_4k`` step at
    MOE_TRAIN_LAYERS layers, bf16 (phase 4c's batch, its 4 microbatches
    and remat; ``sp_carry`` on) against the unsharded step from copies
    of one state: the loss and the grad norm within MESH_LEAF_TOL, every
    parameter and moment leaf within MESH_BF16_STEP_TOL relative L2.
    Then a float32 copy at MESH_FP32_LAYERS layers, one sequence of
    ``seq``, one microbatch: the sharded loss and every gradient leaf
    within MESH_LEAF_TOL of the unsharded ones."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.distributed import place_tree
    from repro_torch.launch.steps import (_lm_opt_cfg, build_cell,
                                          lm_loss_and_grads, make_lm_train_step)
    from repro_torch.models.transformer import init_params
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.tree import leaf_paths, tree_leaves

    def rel(a, b):
        a = a.full_tensor() if hasattr(a, "full_tensor") else a
        return float((a.double() - b.double()).norm()
                     / b.double().norm().clamp_min(1e-30))

    base = get_arch(MLA_ARCH).model_cfg(reduced)
    cfg = dataclasses.replace(base, n_layers=min(MOE_TRAIN_LAYERS, base.n_layers))
    opt_cfg = _lm_opt_cfg(reduced)
    params = init_params(cfg, seed=SEED + 85, device=dev)
    opt = adamw_init(params, opt_cfg)
    cell = build_cell(MLA_ARCH, "train_4k", mesh=mesh, reduced=reduced,
                      cfg_override=cfg)
    s_params = place_tree(params, cell.in_shardings[0])
    s_opt = place_tree(opt, cell.in_shardings[1])
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 85)
    batch0 = lm_tokens(gen, cfg.vocab, batch, seq, dev)
    (_, _, m), ms = mesh_timed(dev, lambda: make_lm_train_step(cfg, opt_cfg)(
        params, opt, *batch0))
    reset_counts()
    (_, _, sm), sms = mesh_timed(dev, lambda: cell.fn(s_params, s_opt, *batch0))
    launches = read_counts()
    head = {name: abs(float(sm[name].to_local()) - float(m[name])) / abs(float(m[name]))
            for name in ("loss", "grad_norm")}
    leaves = {p: rel(a, b) for p, a, b in zip(
        leaf_paths((s_params, s_opt)), tree_leaves((s_params, s_opt)),
        tree_leaves((params, opt)))}
    bad = {k: v for k, v in head.items() if v > MESH_LEAF_TOL}
    bad.update({k: v for k, v in leaves.items() if v > MESH_BF16_STEP_TOL})
    if bad:
        raise AssertionError(f"mesh {MLA_ARCH} train step: past tolerance: {bad}")
    top = max(leaves, key=leaves.get)
    del params, opt, s_params, s_opt
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    f32 = dataclasses.replace(cfg, n_layers=min(MESH_FP32_LAYERS, cfg.n_layers),
                              param_dtype=torch.float32, microbatch=1, remat=False)
    params = init_params(f32, seed=SEED + 86, device=dev)
    cell = build_cell(MLA_ARCH, "train_4k", mesh=mesh, reduced=reduced,
                      cfg_override=f32)
    s_params = place_tree(params, cell.in_shardings[0])
    tok, tgt = (t[:1] for t in batch0)
    loss, grads = lm_loss_and_grads(params, tok, tgt, f32)
    s_loss, s_grads = lm_loss_and_grads(s_params, tok, tgt, f32, mesh)
    f32_errs = {p: rel(a, b) for p, a, b in zip(
        leaf_paths(grads), tree_leaves(s_grads), tree_leaves(grads))}
    f32_errs["loss"] = abs(float(s_loss) - float(loss)) / abs(float(loss))
    bad = {k: v for k, v in f32_errs.items() if v > MESH_LEAF_TOL}
    if bad:
        raise AssertionError(f"mesh {MLA_ARCH} fp32 gradients: past "
                             f"{MESH_LEAF_TOL}: {bad}")
    f32_top = max(f32_errs, key=f32_errs.get)
    print(f"[mesh-lm] {MLA_ARCH} at full width, {cfg.n_layers} of 27 layers, "
          f"{cfg.param_dtype}, moments {opt_cfg.state_dtype}, {batch} x {seq} "
          f"in {cfg.microbatch} microbatches, remat {cfg.remat}, sp_carry "
          f"{cfg.sp_carry}: sharded train_4k step {sms:.1f} ms (unsharded "
          f"{ms:.1f} ms); loss {float(sm['loss'].to_local()):.6f} vs "
          f"{float(m['loss']):.6f} (relative {head['loss']:.3g}), grad norm "
          f"relative {head['grad_norm']:.3g} (tol {MESH_LEAF_TOL}); worst leaf "
          f"{top} {leaves[top]:.3g} relative L2 (bf16 tol {MESH_BF16_STEP_TOL}); "
          f"float32 at {f32.n_layers} layers, 1 x {seq}: worst gradient "
          f"{f32_top} {f32_errs[f32_top]:.3g} (tol {MESH_LEAF_TOL}); launches "
          f"{launches} (no kernel on this path: the train step runs the plain "
          f"attention, as the reference)", flush=True)
    del params, s_params, grads, s_grads
    return launches


def mesh_gnn(dev, mesh, reduced):
    """graphsage-reddit ogb_products at its published shape on phase 7's
    batch and state: the edge-sharded mean aggregate of the features
    against the unsharded one, each element within GNN_TOL of its sum of
    |x| (phase 7's bound), then one sharded step against the unsharded
    step from one state: the loss and every leaf within MESH_LEAF_TOL
    relative L2; segment_gather launches a step as phase 7's."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.distributed import place_tree
    from repro_torch.kernels.segment_gather import (SegmentCSR,
                                                    segment_gather_sum_ref,
                                                    segment_mean)
    from repro_torch.launch.steps import REDUCED_SHAPES, build_cell
    from repro_torch.models.gnn import _aggregate
    from repro_torch.train.tree import leaf_paths, tree_leaves, tree_map

    arch = get_arch("graphsage-reddit")
    kind = arch.shape(GNN_MESH_SHAPE).kind
    sp = dict(REDUCED_SHAPES[kind]) if reduced else dict(
        arch.shape(GNN_MESH_SHAPE).params)
    batch, n_edges, _ = gnn_batch(dev, GNN_MESH_SHAPE, sp, GNN_MESH_SEED)
    feats, edges = batch[:2]
    n = feats.shape[0]
    with torch.no_grad():
        csr = SegmentCSR(edges[0], edges[1], n, n)
        want = segment_mean(feats, csr)
        size = segment_gather_sum_ref(feats.abs(), csr.idx, csr.ptr, csr.scale)
        del csr
        got = _aggregate(feats, edges[0], edges[1], n, "mean", mesh=mesh)
        agg_err = float((got - want).abs().max())
        if not bool(((got - want).abs() <= GNN_TOL * size).all()):
            raise AssertionError(f"mesh graphsage {GNN_MESH_SHAPE}: the sharded "
                                 f"aggregate past {GNN_TOL} of the sum of |x|")
        del got, want, size
    cell = build_cell("graphsage-reddit", GNN_MESH_SHAPE, reduced=reduced)
    s_cell = build_cell("graphsage-reddit", GNN_MESH_SHAPE, mesh=mesh,
                        reduced=reduced)
    state = gnn_state(dev, arch, sp, reduced, False)
    s_state = [place_tree(t, s) for t, s in zip(state, s_cell.in_shardings)]
    out, ms = mesh_timed(dev, lambda: cell.fn(*state, *batch))
    reset_counts()
    s_out, sms = mesh_timed(dev, lambda: s_cell.fn(*s_state, *batch))
    launches = read_counts()
    worst = {"loss": abs(float(s_out[-1]) - float(out[-1])) / abs(float(out[-1]))}
    for path, a, b in zip(leaf_paths(s_out[:-1]), tree_leaves(s_out[:-1]),
                          tree_leaves(out[:-1])):
        a = a.full_tensor().double()
        worst[path] = float((a - b.double()).norm()
                            / b.double().norm().clamp_min(1e-30))
    bad = {k: v for k, v in worst.items() if v > MESH_LEAF_TOL}
    if bad:
        raise AssertionError(f"mesh graphsage {GNN_MESH_SHAPE} step: past "
                             f"{MESH_LEAF_TOL} relative: {bad}")
    per_step = launches["segment_gather"]
    want_n = GNN_LAUNCHES_PER_STEP[kind] if dev.type == "cuda" else 0
    if per_step != want_n:
        raise AssertionError(f"mesh graphsage {GNN_MESH_SHAPE}: {per_step} "
                             f"segment_gather launches a step, want {want_n}")
    top = max(worst, key=worst.get)
    print(f"[mesh-gnn] graphsage {GNN_MESH_SHAPE} {sp} (phase 7's batch, seed "
          f"{GNN_MESH_SEED}, {n_edges:,} edges over the 1-rank mesh): sharded "
          f"aggregate max |d| {agg_err:.3g} (within {GNN_TOL} of the sum of "
          f"|x|); sharded step {sms:.1f} ms (unsharded {ms:.1f} ms), loss "
          f"{float(s_out[-1]):.6f} vs {float(out[-1]):.6f}, worst {top} "
          f"{worst[top]:.3g} relative L2 (tol {MESH_LEAF_TOL}); segment_gather "
          f"{per_step} launches a step; launches {launches}", flush=True)
    del state, s_state, out, s_out, batch
    return launches


def mesh_lm_gnn_phase(dev, mesh, reduced, lm_batch=LM_BATCH,
                      lm_prompt=LM_PROMPT, train_batch=LM_TRAIN_BATCH,
                      train_seq=LM_TRAIN_SEQ):
    """Phase 8b, in phase 8's world: the LM's tensor/sequence-parallel
    prefill and sequence-sharded decode (mistral-nemo-12b), its sharded
    train step (DeepSeek-V2-Lite) and the GNN's edge-sharded step
    (ogb_products), each against its unsharded counterpart from one
    state.  Returns the summed launch counts of the sharded calls."""
    import torch

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    parts = [mesh_mistral(dev, mesh, reduced, lm_batch, lm_prompt)]
    if on_card:
        torch.cuda.empty_cache()
    parts.append(mesh_deepseek_train(dev, mesh, reduced, train_batch, train_seq))
    if on_card:
        torch.cuda.empty_cache()
    parts.append(mesh_gnn(dev, mesh, reduced))
    launches = {k: sum(p[k] for p in parts) for k in parts[0]}
    print(f"[mesh-lm] phase 8b launches: {launches}; phase 8b in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


# ------------------------------------------------------------ phase 9
CALIB_N = 8192                 # the calibration matmul's M = N = K
ROOF_SLACK = 0.95              # a time may lie 5% below its largest term


def dryrun_subprocess(out_dir, arch, shape, reduced, sets=(), shape_params=()):
    """``python -m repro_torch.launch.dryrun`` for one cell on a 1 x 1
    mesh under a fake process group, started (not waited for)."""
    import os

    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", "1x1", "--out", str(out_dir)]
    cmd += ["--reduced"] if reduced else []
    for kv in sets:
        cmd += ["--set", kv]
    for kv in shape_params:
        cmd += ["--shape-param", kv]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def dryrun_record(proc, out_dir, arch, shape):
    """The record of a ``dryrun_subprocess`` once it ends; raises if the
    command or the cell failed."""
    log, _ = proc.communicate(timeout=600)
    path = Path(out_dir) / "local1x1" / f"{arch}__{shape}.json"
    if proc.returncode != 0 or not path.exists():
        raise AssertionError(f"dry run of {arch}/{shape} exited "
                             f"{proc.returncode}:\n{log[-3000:]}")
    rec = json.loads(path.read_text())
    if not rec.get("ok"):
        raise AssertionError(f"dry run of {arch}/{shape}: {rec.get('error')}\n"
                             f"{rec.get('traceback', '')[-2000:]}")
    return rec


def counts_of(c):
    """A ``counting`` block's totals, in a dry-run record's terms."""
    from repro_torch.launch.dryrun import collective_bytes

    kern = {n: (k["launches"], k["flops"], k["bytes"]) for n, k in c.kernels.items()}
    return {"flops": c.flops,
            "bytes": float(c.bytes + sum(k["bytes"] for k in c.kernels.values())),
            "transcendentals": float(c.transcendentals),
            "collectives": collective_bytes(c.collectives)["counts"],
            "kernels": kern}


def record_counts(rec):
    return {"flops": rec["cost"]["flops_per_device"],
            "bytes": rec["cost"]["bytes_accessed_per_device"],
            "transcendentals": rec["cost"]["transcendentals"],
            "collectives": rec["collectives"]["counts"],
            "kernels": {n: (k["launches"], k["flops"], k["bytes"])
                        for n, k in rec["kernels"].items()}}


def roof_check(name, ms, terms, card):
    """Print a measured time against its terms; raise if it lies below
    the largest term less 5%."""
    top = max(terms["compute_s"], terms["memory_s"], terms["collective_s"]) * 1e3
    print(f"[roofline] {name}: measured {ms:.3f} ms; terms compute "
          f"{terms['compute_s'] * 1e3:.3f} ms, memory {terms['memory_s'] * 1e3:.3f} "
          f"ms, collective {terms['collective_s'] * 1e3:.6f} ms; bound "
          f"{terms['bound']} {top:.3f} ms, roofline_frac "
          f"{terms['roofline_frac']:.3f}, measured / largest term "
          f"{ms / top:.3f} ({card})", flush=True)
    if ms < ROOF_SLACK * top:
        raise AssertionError(f"{name}: {ms:.3f} ms lies below its largest "
                             f"roofline term {top:.3f} ms less 5%: the count "
                             f"is wrong")


def calibration(dev, flush, card):
    """(a): one bf16 CALIB_N^3 matmul counted on meta and on the card,
    and timed against its compute term."""
    import torch

    from repro_torch.launch.dryrun import counting
    from repro_torch.launch.roofline import roofline_terms

    n = CALIB_N
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 91)
    a = torch.randn((n, n), generator=gen, device=dev).to(torch.bfloat16)
    b = torch.randn((n, n), generator=gen, device=dev).to(torch.bfloat16)
    want = (2.0 * n ** 3, 3.0 * n * n * 2)
    for x, y in ((a.to("meta"), b.to("meta")), (a, b)):
        with counting((x, y)) as c:
            torch.matmul(x, y)
        got = (c.flops, float(c.bytes))
        if got != want:
            raise AssertionError(f"calibration on {x.device.type}: counted "
                                 f"{got}, want {want}")
    if dev.type != "cuda":
        print(f"[roofline] calibration counts {want} on meta and {dev.type}; "
              f"its time needs the card", flush=True)
        return
    ms = time_cuda(lambda: torch.matmul(a, b), 10, flush)
    terms = roofline_terms(*want, 0.0)
    print(f"[roofline] calibration: bf16 {n}^3 matmul counts {want[0]:.6g} "
          f"FLOPs and {want[1]:.6g} bytes on meta and on the card; "
          f"{ms:.6f} ms ({want[0] / ms / 1e9:.1f} TFLOP/s) against the "
          f"compute term {terms['compute_s'] * 1e3:.6f} ms (989 TFLOP/s)",
          flush=True)
    roof_check("calibration matmul", ms, terms, card)


def counted_against_meta(dev, name, rec, fn, args, card):
    """Run ``fn(*args)`` once warm, once under the dry run's counters and
    three times timed; the counts must equal the meta record's.  Returns
    the mean of the timed calls' ms."""
    from repro_torch.launch.dryrun import counting
    from repro_torch.launch.roofline import analyze_cell

    fn(*args)
    sync(dev)
    with counting(args) as c:
        fn(*args)
    got, want = counts_of(c), record_counts(rec)
    if dev.type == "cuda" and got != want:
        raise AssertionError(f"{name}: the card counts {got}, the dry run "
                             f"{want}")
    print(f"[roofline] {name}: {'equal' if got == want else 'CPU'} counts on "
          f"{dev.type} and meta: {got['flops']:.6g} FLOPs, {got['bytes']:.6g} "
          f"bytes, {got['transcendentals']:.6g} transcendentals, collectives "
          f"{got['collectives']}, kernels {got['kernels']}; dry run {want}",
          flush=True)
    times = [mesh_timed(dev, lambda: fn(*args))[1] for _ in range(3)]
    ms = sum(times) / len(times)
    if dev.type == "cuda":
        roof_check(name, ms, analyze_cell(rec), card)
    return ms


def roofline_phase(dev, reduced=False, lm_batch=LM_BATCH, lm_prompt=LM_PROMPT):
    """Phase 9 (after 8b): the dry run's counts against the card, in a
    one-rank world of its own (NCCL on the card, gloo for a CPU
    rehearsal, where the kernels' plain versions run and the LM goes
    without ``use_flash``: the counts are printed, not held)."""
    import os
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import place_args
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import REDUCED_SHAPES, build_cell
    from repro_torch.models.transformer import init_params

    t_phase = time.perf_counter()
    on_card = dev.type == "cuda"
    card = card_line() if on_card else "CPU"
    tmp = tempfile.mkdtemp(prefix="roofline_")
    base = get_arch(LM_ARCH).model_cfg(reduced)
    cfg = dataclasses.replace(base, use_flash=on_card,
                              n_layers=min(MESH_LM_LAYERS, base.n_layers))
    lm_shape = {} if reduced else {"global_batch": lm_batch, "seq_len": lm_prompt}
    procs = [dryrun_subprocess(
        tmp, LM_ARCH, "prefill_32k", reduced,
        (f"use_flash={str(cfg.use_flash).lower()}", f"n_layers={cfg.n_layers}"),
        [f"{k}={v}" for k, v in lm_shape.items()]),
        dryrun_subprocess(tmp, "graphsage-reddit", GNN_MESH_SHAPE, reduced)]
    flush = (torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device=dev)
             if on_card else None)
    calibration(dev, flush, card)
    del flush
    dist.init_process_group("nccl" if on_card else "gloo", rank=0, world_size=1,
                            store=dist.FileStore(os.path.join(tmp, "store"), 1))
    try:
        mesh = make_local_mesh(1, 1, device=dev.type)
        lm_rec = dryrun_record(procs[0], tmp, LM_ARCH, "prefill_32k")
        cell = build_cell(LM_ARCH, "prefill_32k", mesh=mesh, reduced=reduced,
                          cfg_override=cfg, shape_params=lm_shape or None)
        b, s = cell.args[1].shape
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 84)
        tokens = torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev,
                               dtype=torch.int32)
        args = place_args((init_params(cfg, seed=SEED + 84, device=dev), tokens),
                          cell.in_shardings)
        lm_ms = counted_against_meta(
            dev, f"{LM_ARCH} prefill {b} x {s}, {cfg.n_layers} layers",
            lm_rec, cell.fn, args, card)
        flash = lm_rec["kernels"].get("flash_attention_tc", {}).get("launches", 0)
        if on_card and flash != cfg.n_layers:
            raise AssertionError(f"the prefill's dry run counts "
                                 f"{lm_rec['kernels']} flash launches")
        del args, cell
        if on_card:
            torch.cuda.empty_cache()

        gnn_rec = dryrun_record(procs[1], tmp, "graphsage-reddit", GNN_MESH_SHAPE)
        arch = get_arch("graphsage-reddit")
        kind = arch.shape(GNN_MESH_SHAPE).kind
        sp = dict(REDUCED_SHAPES[kind]) if reduced else dict(
            arch.shape(GNN_MESH_SHAPE).params)
        batch = gnn_batch(dev, GNN_MESH_SHAPE, sp, GNN_MESH_SEED)[0]
        cell = build_cell("graphsage-reddit", GNN_MESH_SHAPE, mesh=mesh,
                          reduced=reduced)
        args = place_args((*gnn_state(dev, arch, sp, reduced, False), *batch),
                          cell.in_shardings)
        gnn_ms = counted_against_meta(dev, f"graphsage {GNN_MESH_SHAPE} step",
                                      gnn_rec, cell.fn, args, card)
        want = GNN_LAUNCHES_PER_STEP[kind]
        if gnn_rec["kernels"]["segment_gather"]["launches"] != want:
            raise AssertionError(f"the GNN step's dry run counts "
                                 f"{gnn_rec['kernels']}, want {want} launches")
        del args, cell, batch
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[roofline] phase 9: prefill {lm_ms:.1f} ms, GNN step {gnn_ms:.1f} "
          f"ms; in {time.perf_counter() - t_phase:.1f} s", flush=True)


# ------------------------------------------------------------ phase 10
EXAMPLES = ("quickstart", "train_policy", "serve_retrieval", "online_learning")
EXAMPLE_SCRIPTS = ("quickstart", "train_lm")       # also run as a user runs them
EXAMPLE_TIMEOUT_S = 300


def load_example(name):
    """``examples/<name>_torch.py`` as a module (its ``main`` not run)."""
    import importlib.util

    path = ROOT / "examples" / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def examples_phase(dev):
    """Phase 10: the port's examples at the reference's sizes.  Each of
    ``EXAMPLES`` runs its ``main`` in this process on ``dev`` between a
    reset and a read of the launch counts (each must launch the chunk
    kernel; the examples assert their own checks); then each of
    ``EXAMPLE_SCRIPTS`` as ``python examples/<name>_torch.py`` from the
    repo root, which must end rc 0.  Returns the chunk kernel's launches
    per example."""
    import os

    launches = {}
    for name in EXAMPLES:
        ex = load_example(name)
        print(f"[examples] {name}: main(['--device', {dev.type!r}])", flush=True)
        reset_counts()
        t0 = time.perf_counter()
        out = ex.main(["--device", dev.type])
        sync(dev)
        secs = time.perf_counter() - t0
        launches[name] = read_counts()["block_scan_pruned_chunk"]
        out = {k: v for k, v in out.items() if k != "summary"}
        print(f"[examples] {name} {json.dumps(out)} wall {secs:.1f} s, "
              f"block_scan_pruned_chunk launches {launches[name]}", flush=True)
        if dev.type == "cuda" and launches[name] <= 0:
            raise AssertionError(f"examples/{name}_torch.py launched no "
                                 "block_scan kernel")
    env = dict(os.environ, PYTHONPATH="src")
    for name in EXAMPLE_SCRIPTS:
        cmd = [sys.executable, f"examples/{name}_torch.py"]
        if dev.type != "cuda":
            cmd += ["--device", dev.type]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=EXAMPLE_TIMEOUT_S)
        secs = time.perf_counter() - t0
        for line in proc.stdout.strip().splitlines()[-3:]:
            print(f"[examples] {name} (script): {line}", flush=True)
        print(f"[examples] python examples/{name}_torch.py: rc "
              f"{proc.returncode}, wall {secs:.1f} s", flush=True)
        if proc.returncode != 0:
            raise AssertionError(f"examples/{name}_torch.py exited "
                                 f"{proc.returncode}:\n{proc.stderr[-3000:]}")
    return launches


def profile_batch(exe, name, policy, inp):
    """One served batch under torch.profiler."""
    profile_device(name, lambda: exe.execute(policy, *inp),
                   "block_scan_pruned_chunk")


def profile_device(name, fn, kernel, host=True, shares=()):
    """Run ``fn`` under torch.profiler and print the device's busy and
    idle share of the wall time, ``kernel``'s share of busy time (and
    that of the device kernels whose names hold each of ``shares``, case
    aside), and where the device and (with ``host``) host time go;
    returns (kernel us, busy us, wall us).  Without ``host`` only the
    device is traced: a call of ~10^5 launches then takes seconds to
    read, not a minute."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
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
    for part in shares:
        hit = [v for k, v in per_name.items() if part.lower() in k.lower()]
        us = sum(u for _, u in hit)
        print(f"[profile] {name}: kernels named *{part}* {us / 1e3:.3f} ms "
              f"over {sum(n for n, _ in hit)} launches "
              f"({100 * us / max(busy_us, 1e-9):.1f}% of busy)", flush=True)
    top = sorted(per_name.items(), key=lambda kv: kv[1][1], reverse=True)[:8]
    for key, (n, us) in top:
        print(f"[profile] {name} top by device: {key[:60]!r} n={n} "
              f"{us / 1e3:.3f} ms", flush=True)
    if not host:
        return kern_us, busy_us, wall_us
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
    live_launches, live_sys, storage = live_phase(dev, cfg)
    if live_launches["block_scan_pruned_chunk"] <= 0:
        raise AssertionError("the live fleet launched no block_scan kernel")
    torch.cuda.empty_cache()
    proc_launches = proc_phase(dev, live_sys, storage)
    if proc_launches <= 0:
        raise AssertionError("the process cell launched no block_scan kernel")
    del live_sys
    storage.cleanup()
    torch.cuda.empty_cache()

    lm_launches = lm_phase(dev)
    torch.cuda.empty_cache()
    fp32_launches = lm_fp32_route(dev)
    torch.cuda.empty_cache()
    moe_launches = moe_phase(dev)
    torch.cuda.empty_cache()
    lm_train_phase(dev)
    torch.cuda.empty_cache()
    recsys_launches = recsys_phase(dev)
    for name in ("embedding_bag", "embedding_bag_lanes"):
        if recsys_launches[name] <= 0:
            raise AssertionError(f"the recsys path launched no {name} kernel")
    print(f"[recsys] main path launches: {recsys_launches}", flush=True)
    torch.cuda.empty_cache()
    recsys_train_launches = recsys_train_phase(dev)
    if recsys_train_launches["embedding_bag"] <= 0:
        raise AssertionError("the recsys train path launched no embedding_bag "
                             "kernel")
    torch.cuda.empty_cache()
    ws_launches = websearch_phase(dev)
    if ws_launches["block_scan_pruned_chunk"] <= 0:
        raise AssertionError("the websearch cells launched no block_scan kernel")
    torch.cuda.empty_cache()
    gnn_launches, gnn_row = gnn_phase(dev)
    if gnn_launches["segment_gather"] <= 0:
        raise AssertionError("the GNN cells launched no segment_gather kernel")
    torch.cuda.empty_cache()
    mesh_launches, mesh_lm_launches = mesh_phase(dev)
    for name in ("flash_attention_tc", "decode_attention_tc", "segment_gather"):
        if mesh_lm_launches[name] <= 0:
            raise AssertionError(f"phase 8b's sharded paths launched no {name}")
    if mesh_launches["block_scan_pruned_chunk"] <= 0:
        raise AssertionError("the sharded websearch cells launched no chunk kernel")
    if mesh_launches["embedding_bag"] + mesh_launches["embedding_bag_lanes"] <= 0:
        raise AssertionError("the sharded wide-deep cells launched no bag kernel")
    torch.cuda.empty_cache()
    roofline_phase(dev)
    torch.cuda.empty_cache()
    t_examples = time.perf_counter()
    examples_launches = examples_phase(dev)
    print(f"[examples] phase 10 in {time.perf_counter() - t_examples:.1f} s",
          flush=True)

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
        # (its "train_launches", "engine_launches", "cluster_launches",
        # "live_launches", "proc_launches", "websearch_launches",
        # "mesh_launches" and "examples_launches" keys are added below)
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
                if r["kernel"] == "embedding_bag_lanes")),
        row("segment_gather", "segment_gather.cu",
            "replaces no TPU kernel (src/repro/models/gnn.py:52 _aggregate: "
            "jnp.take + jax.ops.segment_sum)",
            gnn_launches["segment_gather"], gnn_row, gnn_row["max_abs_err"])]
    kernels[0]["train_launches"] = train_launches["block_scan_pruned_chunk"]
    kernels[0]["engine_launches"] = engine_launches["block_scan_pruned_chunk"]
    kernels[0]["cluster_launches"] = cluster_launches["block_scan_pruned_chunk"]
    kernels[0]["live_launches"] = live_launches["block_scan_pruned_chunk"]
    kernels[0]["proc_launches"] = proc_launches
    kernels[0]["websearch_launches"] = ws_launches["block_scan_pruned_chunk"]
    kernels[0]["mesh_launches"] = mesh_launches["block_scan_pruned_chunk"]
    kernels[0]["examples_launches"] = sum(examples_launches.values())
    by_name = {r["name"]: r for r in kernels}
    for name in ("flash_attention_tc", "decode_attention_tc"):
        by_name[name]["moe_lm_launches"] = moe_launches[name]
    by_name["embedding_bag"]["train_launches"] = (
        recsys_train_launches["embedding_bag"])
    for name in ("embedding_bag", "embedding_bag_lanes"):
        by_name[name]["mesh_launches"] = mesh_launches[name]
    for name in ("flash_attention_tc", "decode_attention_tc", "segment_gather"):
        by_name[name]["mesh_launches"] = mesh_lm_launches[name]
    by_name["segment_gather"].update(
        {k: gnn_row[k] for k in ("gathered_bound_ms", "ms_d128",
                                 "gathered_bound_ms_d128", "ms_bwd_d128",
                                 "gathered_bound_ms_bwd_d128")})
    print(f"[done] {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
