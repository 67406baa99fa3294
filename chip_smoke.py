#!/usr/bin/env python3
"""Drive the PyTorch port of the multisplit system on one NVIDIA card.

    python3 chip_smoke.py

Run it from the root of a checkout on a machine with a CUDA card (an H100
is the target). It needs nothing but the checkout: the Hopper kernels are
built from ``src/repro_torch/kernels/csrc`` into ``build/repro_torch/``.
Phases, one line or more each, every one of which must pass:

1. device  — ``nvidia-smi`` name and power limit, the torch device.
2. build   — nvcc of every kernel source, in parallel; seconds and ptxas use;
   no K3, K2s, K1s, K3s, K2p, K2f, K1p, K3f or B10 instance may spill (K3p's
   spills, chosen by time, are printed).
3. kernels — K1-K3 held bitwise against their plain PyTorch versions on the
   card: the main path's shapes (n = 2^25 keys in 8192 tiles of 4096), every
   spec kind, m in {2, 32, 256}, key-only and key-value, int32 / uint32 /
   float32 keys, NaN and inf keys, bases G above 2^24, ragged tiles. In
   every case the ids path equals the fused path: ``spec_bucket_ids`` (held
   against its plain version) writes the labels out, and K1, K3 and K2 on
   those ids equal K1, K3 and K2 with the labels in the kernel.
   The segmented kernels K1s-K3s likewise: the segmented main path's
   shapes, every spec kind with ragged segment strips that hold empty
   segments, bases above 2^24, and a strip of about 50,000 one- to
   eight-key segments (hundreds of runs a tile).
   The six ids kernels (K1-K3 and K1s-K3s on a materialised int32 ids
   strip) likewise: the main paths' shapes at m = 10 and 256, m in {1, 2,
   7, 32, 255, 256}, tails and tiles up to ``MAX_TILE``, labels outside
   [0, m) (both sides clamp them), bases above 2^24, empty and one- to
   eight-key segments.
   K1 and K2 in their Hopper designs (persistent blocks, staged rows,
   order-free counts), with labels in the kernel and through the ids
   entries: every key of a full tile in one bucket at m = 1, 2 and 256,
   tile counts of 1, 3 and 997 (below and off a multiple of the persistent
   grid), rows of 4095, 37 and ``MAX_TILE`` - 1 keys and planes that start
   off 16 bytes (the kernels' scalar path), ``MAX_TILE`` key-value; the
   same cases run K3 and K3 on ids, persistent and staged too.
   K2s in its Hopper design (persistent staged tiles, K2's path for a tile
   of one run, chunk flags, one warp a short run, long runs listed), through
   K1s-K3s with labels in the kernel and through the ids entries, bases
   above 2^24: one-bucket tiles at m = 1, 2 and 256, tile counts 1, 3 and
   997, rows of 4095, 37 and ``MAX_TILE`` - 1 keys, planes that start off
   16 bytes, ``MAX_TILE`` key-value, tiles of one run, two runs a tile with
   the boundary inside a 32-key round and on one, runs of exactly 32 and 33
   keys, empty segments and s up to 256, each in the shift, general and
   clamp label forms.
   K1s and K3s in their Hopper designs (K1s: persistent 512-thread blocks,
   order-free counts over the tile's window of segments, a one-run tile's
   strip read at its two ends only; K3s: persistent staged tiles, K3's
   path on a one-run tile, K2s's run split on any other), through both
   entries, bases above 2^24: full tiles of one run in the shift, general
   and clamp label forms, one-bucket tiles at m = 1, 2 and 256, tile counts
   1, 3 and 997, rows of 4095, 37, ``MAX_TILE`` - 1 and ``MAX_TILE`` keys,
   the strip and the key plane off 16 bytes, s·m rows not a multiple of 4,
   tiles whose segments fill K1s's shared-memory window exactly and one
   segment past it (and tiles of hundreds of runs, many windows a tile),
   runs of 32 and 33 keys, boundaries inside a round and on one, empty
   segments.
   The packed kernels K1p-K3p in their four forms ({labels in the kernel |
   ids strip} x {flat | segmented}), each held bitwise against its plain
   version and against the onehot kernel of the same form: the main shapes
   (flat at m in {8, 32, 256} and two radix digits, S1, S3), m in {1, 2, 7,
   8, 255, 256}, tiles of 128 to ``MAX_TILE`` keys, subtiles 1, 32, 128 and
   255, one-bucket tiles that drive a counter lane to the 255 cap, labels
   outside [0, m), bases above 2^24, empty and one- to eight-key segments.
   The fused two-digit kernels K1f-K3f ({flat | segmented} x {keys |
   key-value} x {onehot | packed stage rank}), each held bitwise against its
   plain version: the fused paths' shapes (F1's 2^25 keys in 4096 tiles of
   8192 with both 16-bit pairs, F2's 14-bit pair and F3's 16 segments at
   2^22), tiles of 128 to 8192 keys and ragged ones, the pairs (16, 8), (14,
   7) and (6, 4), stage widths 1, 3, 4 and 8, int32 and uint32 keys,
   one-cell tiles, bases above 2^24, empty and one- to eight-key segments;
   and the cases K1f's 16-bit counters (two cells to a word) make new:
   every key of a full tile in one odd cell, and half of them in each cell
   of one word, flat and segmented.
   K2p and K2f in their Hopper designs (K2p: persistent staged tiles, the
   packed rank with its 8-bit lanes in registers and shared words, K2s's run
   split; K2f: persistent, two blocks an SM, the sweep on the shared ranks,
   G read once a cell run), each in its four forms, key-only and key-value,
   against its plain version, bases above 2^24: tile counts 1, 3 and 997,
   rows of 37, 4095 and ``MAX_TILE`` - 1 keys, ``MAX_TILE`` key-value,
   planes off 16 bytes, one-bucket full tiles (a lane at the 255 cap) and
   one-cell full tiles, segmented tiles of one run, ragged ones and runs of
   32 and 33 keys.
   K1p and K3f in their Hopper designs (K1p: persistent 512-thread blocks,
   order-free counts into packed 8-bit copies, two copies a lane at T >
   4096 so no lane passes 255, K1s's window of segments; K3f: K2f's body in
   its positions-only form), each in its four forms against its plain
   version, K2f beside K3f, bases above 2^24: tile counts 1, 3 and 997,
   rows of 37, 4095, ``MAX_TILE`` - 1 and ``MAX_TILE`` keys, planes off 16
   bytes, every key of a full tile in one bucket at m = 1, 2 and 256 at T =
   4096 and ``MAX_TILE`` (the lane cap), one-cell full tiles, segmented
   tiles of one run, ragged, of runs of 32 and 33 keys and of more segments
   than K1p's window, one- to eight-key segments, s·m rows not a multiple
   of 4, stage widths 1, 3, 4 and 8 in both families.
   K3p and B10 in their Hopper designs (K3p: persistent staged tiles, the
   packed rank in registers, K3s's run split, an ids strip read as the keys
   in the clamp form; B10: persistent staged tiles, K2's ballot rank on the
   ids, keys and values moved into the dead planes), each against its plain
   version, K3p also against the onehot K3 / K3s of its form: one-bucket
   tiles of ``MAX_TILE`` at subtile 255 (the lane cap at 32 rounds a warp),
   planes off 16 bytes and rows of 4095, 37 and ``MAX_TILE`` - 1 keys, S1-
   and S3-like strips of one-run tiles, runs of 32 and 33 keys, tiny
   segments and long runs, all four forms; B10 at the unfused baseline's
   tiles of 1024 and 4096, at ``MAX_TILE`` and odd widths, planes off 16
   bytes.
   B10, the standalone tile reorder of the unfused baseline, key-only and
   key-value, against its plain version: the main shape (8192 tiles of
   4096, m = 256, the destinations riding as the values too), m in {1, 2,
   7, 32, 255, 256}, tiles of 1 to ``MAX_TILE`` keys and ragged ones,
   int32 / uint32 / float32 keys with NaN and inf, ids outside [0, m).
   B11, flash attention, against its plain version in the working dtype,
   both routes on the tensor cores (float32 as three TF32 products,
   ``flash_attention_f32_sm90.cu``; bfloat16 and float16,
   ``flash_attention_sm90.cu``):
   2e-4 in float32 (the JAX tests'); in bfloat16 and float16 one unit in
   the last place of each element, ``2^-p * max(|got|, |want|) + 1e-5``
   with p = 7 or 10, and never more than the JAX tests' 5e-2; the max abs
   error of every case and its worst share of the limit printed: the full attention
   widths A1-A3 (below) in float32 and bfloat16, A1 not causal, the JAX
   tests' shapes at their four block pairs in all three dtypes, ragged
   S (not a multiple of the kernels' 64-row tiles) at hd from 8 to 256,
   and the tensor-core routes' edges in all three dtypes: hd 8, 16, 40,
   72, 128, 136, 176, 224 and 256 (one to eight 32-column chunks in
   float32, one to four 64-column chunks in 16 bits, zero-filled past hd),
   S 1, 63, 65 and 4100 (rows past S read as TMA's zero fill), not causal,
   and q, k, v views at an odd element offset (not 16-byte aligned: the
   wrapper copies them), whose result must equal the aligned call's
   bitwise.
4. main    — the port's entry points at the paper's size, n = 2^25 uniform
   random 32-bit keys on the cuda backend: ``ops.multisplit`` for
   ``DeltaSpec(m, 2^32)`` (equal widths over the whole key range, so the
   buckets are uniform) for m in {2, 32, 256}, methods bms and dms,
   key-only and key-value; ``ops.histogram``; ``ops.radix_sort`` at r = 8 (4 passes), key-only and
   key-value. Every result is held bitwise against a stable ``torch.sort``
   of the labels (``rb_sort_multisplit``), or of the keys for the sort.
5. segmented — the segmented entry points, held bitwise against a stable
   ``torch.sort`` of the int64 combined key: S1 ``ops.segmented_multisplit``
   at n = 2^25 over 64 ragged segments (``DeltaSpec(32, 2^32)``, m_eff =
   2048), bms and dms, key-only and key-value, positions_only and
   counts_only; S2 ``ops.segmented_radix_sort`` at n = 2^25 over 16
   segments, r = 8; S3 the serving routing launch, 2^20 expert ids over 256
   requests (``IdentitySpec(64)``, dms, positions_only).
   Callable — a programmer's bucket functions (``ops.from_fn``) at n =
   2^25 through the ids kernels, held against the same oracles: the
   delta-stepping bucket of ``examples/sssp.py`` (m = 10, int32 distances,
   vertex-id values, wms and bms); a multiplicative hash at m in {2, 32,
   256} (bms and dms, key-only and key-value, counts_only, positions_only);
   int16 and int64 keys through ``histogram`` and positions_only; the
   ``even_bucket_ids`` / ``device_histogram`` doors; and the hash at S1's
   shape through ``ops.segmented_multisplit``.
   Packed — the same entry points with ``family="packed"`` at n = 2^25, one
   path a form: flat (key-value bms, dms and ``histogram`` at m in {8, 32,
   256}; ``radix_sort`` r = 8), segmented (S1 key-value bms, S2, S3), flat
   callable (the hash at m = 32) and segmented callable (the hash at S1's
   shape). Every result is held bitwise against the same call on the
   default (onehot) family and against the stable-sort oracle.
   Fused — ``fuse_digits=True``: F1 ``ops.radix_sort`` r = 8 at n = 2^25
   (two 16-bit pairs; key-value bms, key-only dms, ``family="packed"``), F2
   r = 7 at 2^22 (two 14-bit pairs and a 4-bit single pass), F3
   ``ops.segmented_radix_sort`` over 16 ragged segments at 2^22 (S2's
   shape, cut from 2^25 because a pair's H over 16 segments would be 16
   GiB). Each is held bitwise against the unfused sort and a stable
   ``torch.sort``, with H's size and the call's peak device memory.
   Batched — ``(b, n)`` rows, one launch a stage for the whole batch: B1
   the keys as 8 rows of 2^22 (an 8-shard split's local step) at
   ``DeltaSpec(m, 2^32)``, m in {32, 256}, through ``torch.vmap`` of
   ``ops.multisplit_key_value``, ``ops.multisplit`` and ``ops.histogram`` and
   through ``core.batched_multisplit`` (bms and dms, key-only and
   key-value, counts_only, positions_only); B2 256 rows of 2^17 + 37 keys
   at m = 32, every row with pads; B3 the batched ``radix_sort`` r = 8,
   unfused and ``fuse_digits=True``; one packed and one callable batch.
   Every row is held bitwise against the stable-sort oracle, and B1's
   against the flat op on that row.
   Unfused — ``multisplit_unfused`` at n = 2^25, m = 256 (kv bms, key-only
   bms, kv dms: K1 and K3 on the ids, B10 for passes 2 and 3) against the
   fused plan and the oracle; ``radix_sort_per_pass`` flat and batched
   against ``radix_sort``.
   Attention — the kernel door ``repro_torch.kernels.ops.flash_attention``
   (door defaults: causal, blocks of 256) at the full attention widths of
   the repo's configs, batch and heads folded, kv heads repeated to the q
   heads: A1 TinyLlama-1.1B (32 heads of 64, its context 2048, batch 4:
   (128, 2048, 64)) in float32 and bfloat16, and not causal (A1n); A2
   DBRX-132B (48 heads of 128, seq_len 4096, batch 1: (48, 4096, 128)) in
   bfloat16 and float32; A3 h2o-danube-1.8b (32 heads of 80, S = 4096,
   batch 2: (64, 4096, 80)) in bfloat16 and float32. Each result against
   the plain version.
   Consumers (``consumers_phase``) — ``models.moe.route_tokens_segmented``
   at S3's shape (2^20 expert ids, 256 ragged requests with empty ones, E
   = 64, a capacity of 48 that drops tokens) held bitwise against a stable
   ``torch.sort`` of seg·E + expert; ``expert_load_stats`` (segmented and
   flat) against ``bincount``; ``_ranks_multisplit`` against
   ``_ranks_sort``; in both families (the packed one pinned for the
   shapes: K1p and K3p in place of K1s / K3s and K1 / K3);
   ``data.DataPipeline.batches_at`` on the card against the same call on
   the CPU.
   Autotune (``autotune_phase``) — ``ops.set_autotune(True)`` with its file
   under ``build/``: the flat key-value bms call at 2^25, m = 256 runs one
   joint search (each candidate's time printed), bitwise the untuned call;
   the file holds the card's fingerprint; after ``clear_tile_cache()`` the
   call reads the file with no search; ``autotune_fused2`` at 2^22 pins
   (tile, family, stage width) and a fused-pair plan reads them back; the
   searches reach every kernel of the flat, segmented and fused-pair plans;
   ``CUDA_TILE`` measured over {2048, 4096, 8192} at the flat call and S1;
   the shared-memory model of ``core/pipeline/tiles.py`` equals each
   launcher's own report (stages, shared bytes, blocks an SM) for the 12
   plan kernels at every tile from 256 to 8192.
   Serving (``serving_phase``) — ``serving.ServerLoop`` at S3's routing
   shape as a served step (at most 2^20 tokens and 256 requests a step, E
   = 64, capacity 48): prewarmed, a closed loop of 2048 synthetic requests
   (mean length 4096) and an open loop at half the QPS the closed loop
   sustained, every step of both verified at level 2 and its (slot, keep,
   counts) held bitwise against ``route_oracle``; then 80 closed and 24
   open passes unverified, timed (median and spread); every request
   conserved, no retry or requeue; K1s and K3s once a step, K1 and K2 once
   an admission window; one packed step bitwise ``route_oracle``;
   ``launch.serve.main(["--traffic"])`` at its defaults.
   ``serving_trace_phase`` (after the times) traces one step with
   ``torch.profiler``, counts its host syncs and takes the card's idle
   share of that step's own span.
   Resilience (``resilience_phase``) — chaos, not strict, the fallback off
   the card opted in: a seeded ``FaultInjector(rate=0.01,
   dispatch_rate=0.05)`` over the flat kv bms call at 2^25, S1 kv and a
   serving run, results bitwise the strict runs; a real out-of-memory (the
   card filled through the allocator): strict raises
   ``torch.OutOfMemoryError``, classified a resource error; without strict
   the default ladder shrinks the tile and re-raises with no quarantine,
   and opted in it shrinks, quarantines and demotes; freed, the call on
   ``cuda`` is bitwise right again. Every other phase runs strict
   (``ops.set_strict(True)``: a kernel that fails to build or launch fails
   the run) with ``REPRO_AUTOTUNE_DIR`` under ``build/`` (removed before
   and after), and the run ends with no demotion, shrink, retry or
   quarantine counted outside those deliberate faults over the whole run.
   Distributed (``distributed_phase``) — ``core.distributed``:
   ``multisplit_all_shards`` at (8, 2^22) uint32 keys with int32 values,
   ``DeltaSpec(256, 2^32)``, bms, bitwise the flat ``ops.multisplit`` of the
   concatenation (keys, values, starts, counts, permutation), one K1 and one
   K2 for all shards; then four gloo ranks on the one card
   (``torch.multiprocessing``, the kernels built before the spawn), 2^23
   keys a rank, m = 256: ``multisplit_sharded`` bitwise each rank's slice of
   the flat result, ``multisplit_bucket_sharded`` ragged and dense at a
   capacity that drops nothing and one that drops, bitwise an oracle of the
   JAX package's drop rule built from the flat result; the local stage's
   time on the card apart from the whole call's on the host's clock (the
   gloo transport's time is the host's).
   Model (``model_phase``) — the serving path of the dense and MoE
   families: the decode demo ``launch.serve.main(["--arch",
   "tinyllama-1.1b", ...])`` at the full config in bfloat16 (batch 4,
   prompt 32, gen 32; ms/step and tok/s); the smoke configs of tinyllama
   and dbrx in float32, 24 decode steps against one forward; dbrx-132b at
   full width with its depth cut to 2 layers (its 40 layers, 264 GB in
   bfloat16, do not fit one card): ``forward`` on 2 x 2048 tokens launches
   B11, K1 and K3, every layer's MoE ranks and counts bitwise the plain
   multisplit and the stable sort on the same expert ids, 16 decode
   steps (after the times, ``model_trace_phase`` traces one demo decode
   step and the forward's device time by kernel kind); then float32
   from the same parameters, kernels against their plain versions: the
   share of tokens whose top-4 experts agree, and the logits before the
   first token that differs held to ``DBRX_LOGIT_RTOL``.
   Families (``families_phase``, after the model phase has freed dbrx's
   memory) — the hybrid, ssm, vlm and audio families: the decode demo at
   the full configs of zamba2-1.2b, xlstm-350m and musicgen-large
   (bfloat16; musicgen serves its 32 frame embeddings with ``--gen-len
   1`` and exits at ``--gen-len 2``) and on llama-3.2-vision-90b's smoke
   config; the four smoke configs in float32, decode against forward; a
   bfloat16 forward on 2 x 2048 tokens at full width (the vision model's
   depth cut to 10 of its 100 layers: 175 GB in bfloat16 do not fit one
   card) with B11 launched 6, 8 and 48 times inside zamba2, vision and
   musicgen and no kernel in xlstm, then 16 decode steps; zamba2 at its
   full config in float32, kernels against plain versions (each B11 call
   on the same inputs, the logits against what a 2^-21 perturbation of
   the parameters moves them). After the times, ``family_trace_phase``
   splits zamba2's prefill by kernel kind and traces one decode step.
   Training (``training_phase``, after the families have freed their
   memory): ``launch.train.main`` at tinyllama-1.1b's full config, 8
   AdamW steps of 4 x 2048 tokens under the supervisor with checkpoints
   every 4 steps (ms/step, tokens/s, peak memory, B11 44 times a step:
   forward and remat recompute); tinyllama at full width and 2 layers in
   float32, every gradient on the kernels against the plain versions and
   4 steps on one batch that lower its loss; dbrx-132b at full width and
   1 layer in bfloat16 with its float32 master, 4 steps of 1 x 2048 with
   K1, K3 and B11 launched twice a forward's count and every step's ranks
   bitwise the plain multisplit's and the stable sort's; the supervisor
   on the card under injected faults, restoring the step-4 checkpoint and
   replaying. After the times, ``training_trace_phase`` splits one
   tinyllama step by kind (B11, the plain attention backward, the
   optimizer, K1/K3, matmuls, elementwise) with the card's idle share.
   The one-card launchers (the demo and the training launcher) print their
   ``(1,)`` ``data`` mesh of one nccl rank first; their ms a step is
   logged beside the figures of the PRs before the mesh
   (``MESH_MS_BEFORE``).
   Subnormal keys (``subnormal_phase``): float32 keys holding ±1e-38,
   ±5e-39, ±1e-39, ±1.4e-45 and ±0 under ``RangeSpec((-2.0, -0.0, 0.5,
   1.0, 4.0))`` and ``EvenSpec(-1e-38, 1e-38, 4)``, flat and segmented,
   every method and mode, key-value, and both histograms: the ``cuda``
   labels bitwise ``vmap``'s (the port keeps IEEE subnormals; XLA flushes
   them).
   Mesh (``mesh_phase``, last, after training has freed its memory): four
   gloo ranks on the card as a (2, 2) ``(data, model)`` mesh. (a)
   dbrx-132b's MoE block at full width in float32, ``multisplit_ep`` on 2 x
   2048 tokens: within ``MESH_MOE_RTOL`` of the one-process ``multisplit``
   dispatch at capacity factor 8 with drop 0; at the config's 1.25 and at
   1.0 (which drops) each rank's kept slots bitwise an oracle of JAX's
   local-capacity rule and its
   ranks bitwise ``vmap``'s; K1 and K3 counted on each rank. (b) dbrx-132b
   at full width, 2 layers, bfloat16, parameters placed by
   ``decl_to_sharding``, caches by ``cache_shardings``: a prefill of 2 x
   2048 tokens and 4 decode steps (ms by rank, peak memory a rank, the
   collectives of a prefill and a decode step by ``CommDebugMode``: no
   functional all-gather, which gloo cannot run on CUDA tensors); the
   logits against the one-process run routed as the ranks routed, within
   what a relative 2^-8 perturbation of its parameters moves them.
   The sharded training step (``train_mesh_phase``, after the mesh phase):
   gloo ranks on the card again. (a) tinyllama-1.1b at full width, 2
   layers, float32, on a (2, 2) ``(data, model)`` mesh, 2 steps of 4 x 2048
   with ``fsdp`` off and on: the loss, the gradient norm and every leaf of
   the state against the one-process step, each within ``TM_MULT`` times
   what a relative 2^-21 perturbation of the parameters moves the
   one-process run; a control that keeps one rank's gradients unreduced
   over ``data`` must break that limit; no functional all-gather in a
   step. (b) ``launch.train`` at tinyllama-1.1b's full config on two ranks
   (a (2,) data mesh): ms/step, tokens/s, peak memory a rank, a resume
   from the rank-sharded checkpoint replaying to the same losses. (c)
   dbrx-132b at full width, 1 layer, bfloat16 with a float32 master,
   ``multisplit_ep`` on a (1, 2) mesh, 3 steps of 1 x 2048: ms/step, peak
   memory, K1, K3 and B11 on each rank, every route bitwise ``vmap``'s; its
   MoE block alone in float32, gradients within 1e-4 of the one-process
   ``multisplit`` dispatch's. (d) ``compressed_psum`` over the ``pod`` and
   ``data`` groups of a (2, 2) mesh on CUDA tensors, bitwise its CPU answer.
   The dry-run (``dryrun_phase``, A17): (a) ``launch.dryrun.lower_cell`` of
   tinyllama-1.1b's ``decode_32k`` cell on the ``single`` mesh of 256 fake
   ranks on fake CUDA tensors, against the same cell on fake CPU tensors in
   the same run: flops, bytes and collectives equal, no kernel launched.
   (b) tinyllama at full width, 2 layers: a train step of 4 x 2048 on a
   (1,) mesh on the card under the counting mode, against its dry-run on
   fake CUDA tensors: flops and argument bytes equal; the dry-run's peak
   beside ``torch.cuda.max_memory_allocated``; the roofline's time
   (``max(compute_s, memory_s)``, H100 data-sheet constants) no more than
   the step's measured time.
6. launches — every kernel's launch count from its own path's run alone
   (flat, segmented, flat callable, segmented callable, and the four
   packed paths, which launch K1p-K3p and no onehot kernel; each fused
   call, which launches K1f with K2f or K3f twice, F2 also K1 and K2 once;
   each batched call one K1 and one K2 or K3 for all rows, a batched sort
   one of each a sweep; each unfused call K1 and K3 on the ids once and B10
   twice, once or never; the attention path B11 once a call and no other
   kernel); every kernel is launched on one of them.
7. times   — per kernel: ms, the plain version's ms, the bound (bytes moved
   over 3.35 TB/s, the H100 SXM data-sheet rate) and one PyTorch call as a
   yardstick, K1, K2 and both on the ids strip beside their first design's
   times (``K1K2_MS_BEFORE``), K3, K3 on ids, K2s and K2s on ids beside
   theirs (``K3K2S_MS_BEFORE``), K1s, K3s and both on ids beside theirs
   (``K1SK3S_MS_BEFORE``) with the bound their contract forces (a one-run
   tile's strip read at its two ends) beside the whole strip's bound,
   K2p and K2f beside their first design's times (``K2FK2P_MS_BEFORE``),
   K1p and K3f beside theirs (``K1PK3F_MS_BEFORE``), K3p and B10 beside
   theirs (``K3PB10_MS_BEFORE``), B10 key-only, K3p at S1 against the bound
   of a one-run tile's two end ids, K3p / K3 and K3p / K3s in one call (for
   A8), K2f's and K3f's bounds
   also at sector grain (the 32-byte sectors of G's rows their keys hit,
   counted from F1's data),
   K2 beside its time when it had its own copy
   of the rank (``K2_MS_OWN_RANK``), K2s over about 50,000 one- to eight-key
   segments; K1 and K2 key-value with uniform keys at m
   in {2, 32, 256} and every key in one bucket at m = 256; the onehot and
   packed kernels side by side on the same inputs (flat at m in {8, 32,
   256}, S1, both label sources); end to end: ms and Gkeys/s, with the
   same labels as ``DeltaSpec`` and as a callable, and every packed
   path's call beside its onehot twin, the flat key-value dms and
   positions_only calls at m = 256; stage
   splits (S1 key-value bms with K2s and dms with K3s); peak device memory.
   The fused kernels at F1's shapes, K2f and K3f
   at stage widths 4 and 8 in both families, F1-F3 fused against unfused end
   to end in turns, F1 fused at sub_bits 4 and 8 and at tile 4096, and the
   stages of one fused pair (prescan, the scan over H, postscan, scatter)
   beside those of one single-digit pass. The batched calls against the
   loop of flat calls and ``torch.vmap`` against ``batched_multisplit``,
   ``multisplit_unfused`` against the fused plan with its stages,
   ``radix_sort_per_pass`` against ``radix_sort``. K1f at F1 and, segmented,
   at F3. B11 at A1, A1n, A2 and A3 (float32, bfloat16, A1 also float16)
   and at A4 and A5 (bfloat16, the families' prefill shapes):
   ms beside the time before (``ATTN_MS_BEFORE``), the plain version's ms,
   the bytes bound (3.35 TB/s),
   the operations bound and its share (4·hd flops a (q, k) pair the mask
   keeps, the function's work, over the tensor cores' peak for the input
   type: 495 TFLOP/s for float32 inputs, 989 for bf16 / fp16; for float32
   beside it the share of the three TF32 products' 12·hd flops at 495 and
   of 4·hd at the 67 TFLOP/s of the fp32 CUDA cores), and
   ``scaled_dot_product_attention`` on the (B, H, S, hd) view as the library
   yardstick, with the name of the CUDA kernel it runs for float32 at A1
   (read once with ``torch.profiler``); the causal / non-causal ratio at A1,
   which must stay below 0.65 to show the diagonal skip. S3's host work
   (``s3_host_phase``, after SDPA's ``torch.profiler`` read, which a
   session before it would leave without kernels): one traced
   ``route_tokens_segmented`` call (host ops, syncs, launches, kernels),
   each of its steps alone, and S3's routing at ``DISPATCH_TILE`` against
   the resolved tile.

The last lines are the ``nvidia-smi`` line, one JSON line of the kernels
and ``{"ok": true, "device": {...}}``. The script exits non-zero, printing
no result, when no CUDA device is present or a phase fails.
"""

from __future__ import annotations

import atexit
import functools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

N_MAIN = 1 << 25
# F2 and F3 (the fused r = 7 sort and the fused segmented sort) run at 2^22
# keys: F3's H is (L, s·m²) int32, 2 GiB at s = 16, m² = 65536 in tiles of
# 8192 keys, and would be 16 GiB at 2^25 before the scan's temporaries
N_FUSED_SMALL = 1 << 22
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12             # the fp32 CUDA cores, H100 SXM data sheet
TF32_FLOPS_PER_S = 495e12            # dense TF32 tensor cores, H100 SXM data sheet
TENSOR_FLOPS_PER_S = 989e12          # dense bf16 / fp16 tensor cores, H100 SXM data sheet
SEED = 0
# K1-K3 at n = 2^25, m = 256 on an H100 80GB HBM3 at 700 W, as this script
# measured them when they were added (PERF.md's kernel table)
FLAT_MS_BEFORE = {"spec_tile_histograms": 0.3485, "spec_fused_postscan_reorder": 0.7949,
                  "spec_tile_positions": 0.3852}
# K1 and K2 (and both on the ids strip) at n = 2^25, m = 256, key-value, in
# their first design (one block a tile, the rank walk from device memory),
# run 3 of this script on an H100 80GB HBM3 at 700 W (PERF.md's kernel table)
K1K2_MS_BEFORE = {"spec_tile_histograms": 0.3411, "spec_fused_postscan_reorder": 0.8239,
                  "tile_histograms": 0.3372, "fused_postscan_reorder": 0.8026}
# K3, K2s and both on the ids strip in their first design (one block a tile,
# the rank walk from device memory through a meta plane) at the main shapes
# (K3: n = 2^25, m = 256; K2s: S1, key-value), on an H100 80GB HBM3 at 700 W
# (PERF.md's kernel table)
K3K2S_MS_BEFORE = {"spec_tile_positions": 0.3611, "tile_positions": 0.3762,
                   "seg_spec_fused_postscan_reorder": 1.1822, "seg_fused_postscan_reorder": 1.1546}
# K1s, K3s and both on the ids strip in their first design (one block a
# tile, a list of every run start, the rank walk; K3s through a meta
# plane) at S1 (K3s key-only positions), on an H100 80GB HBM3 at 700 W
# (PERF.md's kernel table), and the bound they were held to then: the whole
# strip read (K1s 320 MiB, K3s 385 MiB over 3.35 TB/s)
K1SK3S_MS_BEFORE = {"seg_spec_tile_histograms": 0.2711, "seg_tile_histograms": 0.2863,
                    "seg_spec_tile_positions": 0.3659, "seg_tile_positions": 0.3671}
# K2p (flat m = 256, n = 2^25, key-value) and K2f (F1 key-value) in their
# first design (one block a tile; K2p's rank walk from device memory with
# __match_any_sync peers, K2f's sweep through a meta plane at one block an
# SM and a G read a key), on an H100 80GB HBM3 at 700 W (PERF.md's kernel
# table)
K2FK2P_MS_BEFORE = {"packed_fused_postscan_reorder": 0.8779, "fused2_fused_postscan_reorder": 2.5914}
# K1p (flat m = 256, n = 2^25) and K3f (F1) in their first design (one
# block a tile; K1p's two-level packed rank walk from device memory, K3f's
# sweep through a meta plane at one block an SM and a G read a key), on an
# H100 80GB HBM3 at 700 W (PERF.md's kernel table)
K1PK3F_MS_BEFORE = {"packed_tile_histograms": 0.3713, "fused2_tile_positions": 2.0480}
# K3p (flat m = 256, n = 2^25) and B10 (key-value, m = 256, tiles of 4096)
# in their first design (one block a tile; K3p's two-level packed rank from
# device memory through a meta plane, B10's rank walk from device memory),
# on an H100 80GB HBM3 at 700 W (PERF.md's kernel table)
K3PB10_MS_BEFORE = {"packed_tile_positions": 0.3825, "tile_reorder": 0.5978}
# K2 key-value at the main shape when it kept its own copy of the rank that
# it now shares with K3 and K2s (PERF.md's kernel table); within 5 % of it
# shows the shared rank cost K2 nothing
K2_MS_OWN_RANK = 0.3821
# K1f at F1 and, segmented, at F3 when it added its counts into a zeroed H
# in device memory with global atomics, on an H100 80GB HBM3 at 700 W
# (PERF.md's kernel table and its F3 stage line)
K1F_MS_BEFORE = {"F1": 2.6857, "F3": 1.0089}
# B11's full widths: name -> ((BH, S, hd), causal, (batch, heads), dtypes),
# batch and heads folded, kv heads repeated to the q heads (configs in
# src/repro/configs/)
ATTN = {
    "A1": ((128, 2048, 64), True, (4, 32), ("float32", "bfloat16")),   # tinyllama_1p1b.py
    "A1n": ((128, 2048, 64), False, (4, 32), ("float32",)),
    "A2": ((48, 4096, 128), True, (1, 48), ("bfloat16", "float32")),   # dbrx_132b.py
    "A3": ((64, 4096, 80), True, (2, 32), ("bfloat16", "float32")),    # h2o_danube_1p8b.py
    # the prefills of families_phase: zamba2's shared attention and
    # musicgen's (zamba2_1p2b.py, musicgen_large.py), the vision model's
    # self-attention, kv 8 repeated to 64 heads (llama32_vision_90b.py)
    "A4": ((64, 2048, 64), True, (2, 32), ("bfloat16",)),
    "A5": ((128, 2048, 128), True, (2, 64), ("bfloat16",)),
}
# B11 against its plain version, element by element: |got - want| <= the
# smaller of the JAX tests' tolerance (tests/test_kernels.py:149, 159) and
# ATTN_ULP * max(|got|, |want|) + ATTN_ATOL. Both sides compute in fp32 from
# the same inputs (their fp32 results differ by at most 1.2e-6 at A1-A3 on
# the card), then round to the output dtype: in bfloat16 (7 mantissa bits)
# and float16 (10) the two may then differ by one unit in the last place,
# at most 2^-p of the larger value. ATTN_ATOL covers the fp32 difference
# where that unit is smaller (values near 0, float16 subnormals).
ATTN_TOL = {"float32": 2e-4, "bfloat16": 5e-2, "float16": 5e-2}
ATTN_ULP = {"float32": 0.0, "bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}
ATTN_ATOL = {"float32": 2e-4, "bfloat16": 1e-5, "float16": 1e-5}
# B11 before the float32 route moved to the tensor cores: float32 on the
# CUDA cores (fp32 FMA), the 16-bit route as it stands, on an H100 80GB
# HBM3 at 700 W (PERF.md's kernel table)
ATTN_MS_BEFORE = {("A1", "float32"): 3.2722, ("A1n", "float32"): 5.8919,
                  ("A2", "float32"): 11.6388, ("A1", "bfloat16"): 0.3443,
                  ("A1", "float16"): 0.3322, ("A2", "bfloat16"): 0.6819,
                  ("A3", "bfloat16"): 0.8089}


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# The phases of the consumers and of the autotune layer, each a function of
# its own; main() calls them after the attention path
# ---------------------------------------------------------------------------

N_S3 = 1 << 20            # S3: the expert ids of 256 requests, E = 64
S3_EXPERTS = 64
S3_CAPACITY = 48          # below the 64 tokens a (request, expert) pair holds on average


def route_oracle(ids, starts, e, capacity, dev):
    """(slot, keep, counts) of ``route_tokens_segmented`` from a stable
    ``torch.sort`` of the int64 combined key seg·E + expert."""
    import torch

    from repro_torch.core.pipeline import stages as st

    n, s = ids.shape[0], len(starts)
    seg = st.segment_ids_from_starts(torch.from_numpy(starts).to(dev), n)
    cid = seg.long() * e + ids.long()
    _, order = torch.sort(cid, stable=True)
    counts = torch.bincount(cid, minlength=s * e)
    first = torch.cumsum(counts, 0) - counts
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[order] = torch.arange(n, device=dev) - first[cid[order]]
    keep = rank < capacity
    slot = torch.where(keep, cid * capacity + rank, s * e * capacity).to(torch.int32)
    return slot, keep, counts.to(torch.int32).view(s, e)


def consumers_phase(dev, gen, s3_starts, registry, max_err, log):
    """The routing and length-bucketing consumers on the card, in both
    families (the packed one pinned for the shapes), each held bitwise
    against a stable ``torch.sort`` or ``bincount`` on the card, or, for
    the data pipeline, against the same call on the CPU. Returns the launch
    counts of the phase."""
    import numpy as np
    import torch

    from repro_torch.core.pipeline import clear_tile_cache, tiles
    from repro_torch.data import DataPipeline
    from repro_torch.models import moe

    n3, e, cap = N_S3, S3_EXPERTS, S3_CAPACITY
    s = len(s3_starts)
    ids = torch.randint(0, e, (n3,), dtype=torch.int32, device=dev, generator=gen)
    want = route_oracle(ids, s3_starts, e, cap, dev)
    assert not bool(want[1].all()), "the capacity drops no token"
    cid = torch.from_numpy(np.repeat(np.arange(s), np.diff(np.append(s3_starts, n3)))).to(dev)
    cid = cid * e + ids.long()
    seg_counts = torch.bincount(cid, minlength=s * e).to(torch.int32).view(s, e)
    flat_counts = torch.bincount(ids.long(), minlength=e).to(torch.int32)
    drop = (seg_counts - cap).clamp_min(0).sum().to(torch.float32) / n3
    pipe_cpu = DataPipeline(32000, 2048, 8, seed=0, device="cpu").batches_at(0, 4)
    counts_all = {}
    for family in ("onehot", "packed"):
        clear_tile_cache()
        if family == "packed":
            for key in ((n3, s * e, "dms", "cuda"), (n3, e, "dms", "cuda")):
                tiles._FAMILY_CACHE[key] = ("packed", "pinned by chip_smoke.py")
        torch.cuda.synchronize()
        registry.reset_launches()
        t0 = time.perf_counter()
        got = moe.route_tokens_segmented(ids, s3_starts, e, cap, device=dev)
        load_seg = moe.expert_load_stats(ids, e, capacity=cap, segment_starts=s3_starts,
                                         device=dev)
        load_flat = moe.expert_load_stats(ids, e, device=dev)
        ranks = moe._ranks_multisplit(ids, e, device=dev)
        pipe = (DataPipeline(32000, 2048, 8, seed=0, device=dev).batches_at(0, 4)
                if family == "onehot" else None)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {k: v for k, v in registry.launch_counts().items() if v}
        for k, v in counts.items():
            counts_all[k] = counts_all.get(k, 0) + v
        for name, a, b in zip(("slot", "keep", "counts"), got, want):
            if max_err(a.to(torch.int32), b.to(torch.int32)):
                raise AssertionError(f"route_tokens_segmented ({family}): {name} differs from "
                                     f"the stable-sort oracle")
        if max_err(load_seg[0], seg_counts) or max_err(load_flat[0], flat_counts):
            raise AssertionError(f"expert_load_stats ({family}) differs from bincount")
        if not torch.equal(load_seg[1], drop.view(())):
            raise AssertionError(f"expert_load_stats ({family}): drop share {load_seg[1]} != {drop}")
        sort_ranks = moe._ranks_sort(ids, e, device=dev)
        if max_err(ranks[0], sort_ranks[0]) or max_err(ranks[1], sort_ranks[1]):
            raise AssertionError(f"_ranks_multisplit ({family}) differs from _ranks_sort")
        if pipe is not None:
            for a, b in zip(pipe, pipe_cpu):
                if sorted(a) != sorted(b) or any(not np.array_equal(a[k], b[k]) for k in a):
                    raise AssertionError("DataPipeline.batches_at on the card differs from the CPU")
        # route: K1s and K3s (packed: K1p and K3p); the load: K1 and K1s
        # (K1p twice); the ranks: K1 and K3 (K1p and K3p); the pipeline: K1s
        # and K3s
        expect = ({"spec_tile_histograms": 2, "spec_tile_positions": 1,
                   "seg_spec_tile_histograms": 3, "seg_spec_tile_positions": 2}
                  if family == "onehot" else
                  {"packed_tile_histograms": 4, "packed_tile_positions": 2})
        if counts != expect:
            raise AssertionError(f"consumer path ({family}): launches {counts} != {expect}")
        log("consumers", f"{family}: route_tokens_segmented ({n3} expert ids, {s} requests, "
                         f"{int((np.diff(np.append(s3_starts, n3)) == 0).sum())} empty, E = {e}, "
                         f"capacity {cap}: {int((~got[1]).sum())} tokens dropped), "
                         f"expert_load_stats (segmented, flat), _ranks_multisplit"
                         + (", DataPipeline.batches_at(0, 4) (seq 2048, batch 8)"
                            if pipe is not None else "")
                         + f" in {secs:.2f} s (first calls), bitwise equal to the stable sort, "
                           f"bincount, _ranks_sort" + (" and the CPU" if pipe is not None else "")
                         + f"; launches {counts}")
    # a step with no request: empty slots and (0, E) counts, no launch
    slot, keep, counts = moe.route_tokens_segmented(
        torch.empty(0, dtype=torch.int32, device=dev), np.zeros(0, np.int32), e, cap, device=dev)
    if (tuple(slot.shape), tuple(keep.shape), tuple(counts.shape)) != ((0,), (0,), (0, e)):
        raise AssertionError(f"route_tokens_segmented with no request gave shapes "
                             f"{slot.shape}, {keep.shape}, {counts.shape}")
    clear_tile_cache()
    return counts_all


def s3_host_phase(dev, gen, s3_starts, log, smi):
    """Where the host time of S3's routing launch goes: one
    ``torch.profiler`` trace of ``route_tokens_segmented`` (its host ops,
    syncs and kernels), each of its steps timed alone with a
    synchronisation after it, and S3's routing with the JAX package's tile
    (``DISPATCH_TILE``) against the tile the resolver gives. Returns the
    numbers it printed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import ops
    from repro_torch.core.pipeline import stages as st
    from repro_torch.core.pipeline import tile_decision
    from repro_torch.kernels import multisplit_tile as mst
    from repro_torch.models import moe

    n3, e, cap = N_S3, S3_EXPERTS, S3_CAPACITY
    s = len(s3_starts)
    ids = torch.randint(0, e, (n3,), dtype=torch.int32, device=dev, generator=gen)
    spec = ops.identity_buckets(e)
    run = functools.partial(moe.route_tokens_segmented, ids, s3_starts, e, cap, device=dev)
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.key_averages()
    host = sorted((ev for ev in events if ev.device_type == DeviceType.CPU),
                  key=lambda ev: -ev.self_cpu_time_total)
    kernels = [ev for ev in events if ev.device_type == DeviceType.CUDA]
    syncs = [ev for ev in host if any(w in ev.key for w in (
        "_local_scalar_dense", "Synchronize", "Memcpy", "nonzero"))]
    launch_calls = [ev for ev in host if "LaunchKernel" in ev.key]
    log("s3 host", "torch.profiler over one route_tokens_segmented call at S3: host ops by self "
                   "time " + "; ".join(f"{ev.key} x{ev.count} {ev.self_cpu_time_total / 1e3:.4f} ms"
                                       for ev in host[:14]) + f" [{smi}]")
    log("s3 host", f"syncs: " + "; ".join(f"{ev.key} x{ev.count} "
                                          f"{ev.self_cpu_time_total / 1e3:.4f} ms" for ev in syncs)
                   + f"; launch calls: " + "; ".join(f"{ev.key} x{ev.count} "
                                                     f"{ev.self_cpu_time_total / 1e3:.4f} ms"
                                                     for ev in launch_calls)
                   + f"; device kernels {len(kernels) or 'not read'} kinds, "
                   + "; ".join(f"{ev.key[:48]} x{ev.count} "
                               f"{getattr(ev, 'device_time_total', getattr(ev, 'cuda_time_total', 0)) / 1e3:.4f} ms"
                               for ev in kernels))

    def host_ms(fn, reps=25):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    starts_dev = torch.from_numpy(s3_starts).to(dev)
    plan = ops._segmented_plan(n3, s, e, bucket_fn=spec, method="dms", mode="positions_only",
                               backend="cuda", tile=None, family=None)
    seg = st.segment_ids_from_starts(starts_dev, n3)
    seg_tiled = st.pad_to_tiles(seg, plan.tile, s - 1)[0].view(-1, plan.tile)
    keys_tiled = st.pad_to_tiles(ids, plan.tile, plan.pad_key(ids.dtype))[0].view(-1, plan.tile)
    hist = plan.prescan(keys_tiled, None, seg_tiled)
    g = st.global_scan(hist)
    res = ops.segmented_multisplit(ids, spec, s3_starts, method="dms", mode="positions_only",
                                   device=dev)
    steps = {
        "plan lookup (the cached plan)": host_ms(lambda: ops._segmented_plan(
            n3, s, e, bucket_fn=spec, method="dms", mode="positions_only", backend="cuda",
            tile=None, family=None)),
        "starts check on the host (numpy) and copy": host_ms(
            lambda: ops._segment_starts(s3_starts, n3, dev)),
        "segment ids": host_ms(lambda: st.segment_ids_from_starts(starts_dev, n3)),
        "pad keys and strip to tiles": host_ms(lambda: (
            st.pad_to_tiles(ids, plan.tile, plan.pad_key(ids.dtype)),
            st.pad_to_tiles(seg, plan.tile, s - 1))),
        "K1s launch": host_ms(lambda: plan.prescan(keys_tiled, None, seg_tiled)),
        "global scan": host_ms(lambda: st.global_scan(hist)),
        "K3s launch": host_ms(lambda: mst.seg_spec_tile_positions(keys_tiled, seg_tiled, g,
                                                                  spec, s)),
        "counts and starts (finalize)": host_ms(lambda: st.exclusive_rows(
            hist.sum(0, dtype=torch.int32).view(s, e))),
        "ranks and slots (moe)": host_ms(lambda: torch.where(
            (res.permutation - res.bucket_starts[seg.long(), ids.long()]) < cap,
            (seg * e + ids) * cap, s * e * cap)),
        "route_tokens_segmented end to end": host_ms(run),
    }
    log("s3 host", "steps alone, host wall with a synchronisation after each, median of 25, ms: "
                   + "; ".join(f"{k} {v:.4f}" for k, v in steps.items()) + f" [{smi}]")
    tiles_ms = {}
    for name, tile in (("DISPATCH_TILE", moe.DISPATCH_TILE), ("resolved", None)):
        fn = functools.partial(moe._segmented_ranks, ids, s3_starts, e, tile, device=dev)
        tiles_ms[name] = [host_ms(fn), host_ms(fn)]
    resolved = tile_decision(n3, s * e, "dms", False, "cuda")[0]
    log("s3 host", f"S3 routing (_segmented_ranks) end to end, host wall, two medians of 25 each: "
                   f"tile {moe.DISPATCH_TILE} (DISPATCH_TILE) {tiles_ms['DISPATCH_TILE']} ms; "
                   f"the resolved tile {resolved} {tiles_ms['resolved']} ms [{smi}]")
    return {"steps": steps, "tiles": tiles_ms}


def autotune_phase(dev, gen, registry, max_err, log, smi):
    """The autotune layer on the card: a search armed by ``set_autotune`` at
    the flat key-value bms call of 2^25 keys (m = 256), bitwise the untuned
    call, persisted under the H100's fingerprint and read back after
    ``clear_tile_cache()`` without a second search; a fused-pair grid that
    pins (tile, family, stage width); the searches that reach every kernel
    of the flat, segmented and fused-pair plans; the shared-memory model
    against every launcher's own report; and CUDA_TILE's measurement over
    {2048, 4096, 8192}. Returns the launch counts of the phase."""
    import shutil

    import torch

    from repro_torch import ops
    from repro_torch.core.pipeline import (
        autotune as at,
        autotune_tile,
        clear_tile_cache,
        family_decision,
        resolve_sub_bits,
        resolve_tile,
        set_autotune,
        tile_decision,
        tiles,
    )
    from repro_torch.kernels import multisplit_tile as mst

    cache_dir = os.path.join(ROOT, "build", "autotune_smoke")
    shutil.rmtree(cache_dir, ignore_errors=True)
    n = N_MAIN
    keys = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=dev,
                         generator=gen).view(torch.uint32)
    values = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=dev, generator=gen)
    spec = ops.DeltaSpec(256, 1 << 32)
    fields = ("keys", "values", "bucket_starts", "bucket_counts", "permutation")
    clear_tile_cache()
    torch.cuda.synchronize()
    registry.reset_launches()
    untuned = ops.multisplit_key_value(keys, values, spec, device=dev)
    set_autotune(True, cache_dir=cache_dir, trials=3)
    clear_tile_cache()
    s0 = at._SEARCHES
    t0 = time.perf_counter()
    tuned = ops.multisplit_key_value(keys, values, spec, device=dev)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    if at._SEARCHES - s0 != 1:
        raise AssertionError(f"the armed call ran {at._SEARCHES - s0} searches, not one")
    times = at.last_times()
    tile, tile_reason = tile_decision(n, 256, "bms", True, "cuda")
    fam, fam_reason = family_decision(n, 256, "bms", "cuda")
    for f in fields:
        if max_err(getattr(tuned, f), getattr(untuned, f)):
            raise AssertionError(f"the tuned call's {f} differs from the untuned call's")
    log("autotune", f"set_autotune(True): the flat kv bms call at 2^25, m = 256 ran one joint "
                    f"search in {search_s:.2f} s ({len(times)} candidates, 3 trials each): "
                    + "; ".join(f"({t}, {f_}) {s * 1e3:.4f} ms" for t, f_, s in times)
                    + f"; pinned ({tile}, {fam!r}); tile reason: {tile_reason}; bitwise the "
                      f"untuned call [{smi}]")
    with open(at.cache_path()) as f:
        entries = json.load(f)["entries"]
    fp = at.host_fingerprint()
    if "H100" not in fp or not any(k.startswith(fp + "|") for k in entries):
        raise AssertionError(f"the cache file holds {sorted(entries)}, not the card's "
                             f"fingerprint {fp}")
    clear_tile_cache()
    s0 = at._SEARCHES
    again = ops.multisplit_key_value(keys, values, spec, device=dev)
    if at._SEARCHES != s0 or family_decision(n, 256, "bms", "cuda")[1] != at._DISK_REASON:
        raise AssertionError("after clear_tile_cache() the call searched again instead of "
                             "reading the file")
    for f in fields:
        if max_err(getattr(again, f), getattr(untuned, f)):
            raise AssertionError(f"the call from the file: {f} differs")
    log("autotune", f"{at.cache_path()} holds {len(entries)} entries under {fp}; after "
                    f"clear_tile_cache() the same call read them with no search")
    del untuned, tuned, again
    # a small fused-pair grid: 2^22 keys, the pair (0, 16, 8), key-value
    t0 = time.perf_counter()
    won = at.autotune_fused2(N_FUSED_SMALL, 0, 16, 8, key_value=True, backend="cuda",
                             candidates=(4096, 8192), sub_bits_candidates=(4, 8), trials=2)
    fused_s = time.perf_counter() - t0
    pinned = (resolve_tile(N_FUSED_SMALL, 1 << 16, "bms", True, "cuda", digits=2, stage_m=256),
              family_decision(N_FUSED_SMALL, 256, "bms", "cuda", digits=2)[0],
              resolve_sub_bits(N_FUSED_SMALL, 1 << 16, "bms", True, "cuda", 256))
    if pinned != won:
        raise AssertionError(f"autotune_fused2 won {won} but the caches hold {pinned}")
    plan = ops._plan(ops.BitfieldSpec(0, 16), N_FUSED_SMALL, key_value=True, backend="cuda",
                     digit_split=8)
    if (plan.tile, plan.family, plan.sub_bits) != won:
        raise AssertionError(f"a fused-pair plan resolved {(plan.tile, plan.family, plan.sub_bits)}"
                             f", not the pinned {won}")
    log("autotune", f"autotune_fused2 at 2^22, pair (0, 16, 8), kv, tiles (4096, 8192) x both "
                    f"families x sub_bits (4, 8) in {fused_s:.2f} s: "
                    + "; ".join(f"({t}, {f_}, {sb}) {s * 1e3:.4f} ms"
                                for t, f_, sb, s in at.last_times())
                    + f"; pinned {won} and read back by a fused-pair plan [{smi}]")
    # the dms and segmented shapes, and the fused dms pair: every kernel of
    # the plans
    autotune_tile(n, spec, method="dms", backend="cuda", candidates=(2048, 4096), trials=1)
    autotune_tile(N_S3, ops.IdentitySpec(S3_EXPERTS), method="dms", segments=256,
                  backend="cuda", candidates=(2048, 4096), trials=1)
    autotune_tile(n, ops.DeltaSpec(32, 1 << 32), key_value=True, segments=64, backend="cuda",
                  candidates=(2048, 4096), trials=1)
    at.autotune_fused2(N_FUSED_SMALL, 0, 16, 8, method="dms", backend="cuda",
                       candidates=(8192,), sub_bits_candidates=(8,), trials=1)
    # CUDA_TILE: the flat kv bms call at 2^25, m = 256, and S1 kv bms, onehot
    tile_ms = {}
    for cell, kw in (("flat kv bms m=256", dict(bucket_fn=spec)),
                     ("S1 kv bms", dict(bucket_fn=ops.DeltaSpec(32, 1 << 32), segments=64))):
        bf = kw["bucket_fn"]
        probe, _, _ = at.synthetic_inputs(n, bf, device=dev)
        live = int((torch.bincount(bf(probe).long(), minlength=bf.num_buckets) > 0).sum())
        if live != bf.num_buckets:
            raise AssertionError(f"CUDA_TILE, {cell}: the search's keys fill {live} of "
                                 f"{bf.num_buckets} buckets")
        del probe
        runs = []
        for _ in range(2):
            won_t = autotune_tile(n, key_value=True, backend="cuda", candidates=(2048, 4096, 8192),
                                  families=("onehot",), trials=7, **kw)
            runs.append((won_t, {t: s * 1e3 for t, _, s in at.last_times()}))
        tile_ms[cell] = runs
        log("autotune", f"CUDA_TILE, {cell} at 2^25 (keys over the spec's range, all {live} "
                        f"buckets live), autotune_tile over (2048, 4096, 8192), "
                        f"onehot, least of 7 trials, two searches: "
                        + "; ".join(f"won {w}: " + ", ".join(f"{t} {ms:.4f} ms"
                                                            for t, ms in d.items())
                                    for w, d in runs) + f" [{smi}]")
    counts = {k: v for k, v in registry.launch_counts().items() if v}
    reached = ("spec_tile_histograms", "spec_fused_postscan_reorder", "spec_tile_positions",
               "seg_spec_tile_histograms", "seg_spec_fused_postscan_reorder",
               "seg_spec_tile_positions", "packed_tile_histograms",
               "packed_fused_postscan_reorder", "packed_tile_positions",
               "fused2_tile_histograms", "fused2_fused_postscan_reorder", "fused2_tile_positions")
    if any(counts.get(k, 0) == 0 for k in reached):
        raise AssertionError(f"the autotune path launched {counts}: not every kernel of the "
                             f"flat, segmented and fused-pair plans")
    log("launches", f"autotune path: {counts}")
    set_autotune(False)
    clear_tile_cache()
    shutil.rmtree(cache_dir, ignore_errors=True)
    # the model against every launcher's report, at every candidate tile
    limits = tiles.device_limits(dev)
    n_rep = n_ceiling = 0
    specs = {"shift": spec, "any": ops.EvenSpec(0.0, 2.0**30, 256), "clamp": ops.IdentitySpec(256)}
    cases = []
    for t in (256, 512, 1024, 2048, 4096, 8192):
        for kv in (False, True):
            for seg in (None, 64):
                for family in ("onehot", "packed"):
                    for ids in (False, True):
                        for form, sp in specs.items():
                            if ids and form != "clamp":
                                continue
                            for method in ("bms", "dms"):
                                kv_ = kv and method == "bms"
                                for lay in tiles.plan_kernels(t, 256, method=method, key_value=kv_,
                                                              segments=seg, family=family,
                                                              ids=ids, form=form):
                                    cases.append((lay, t, sp, seg, kv_, "packed_ids" if (
                                        family == "packed" and ids) else family))
        for bits, seg, family in ((16, None, "onehot"), (16, 16, "packed"), (14, None, "packed")):
            for lay in tiles.plan_kernels(t, 1 << bits, key_value=True, segments=seg,
                                          family=family, pair_bits=bits):
                cases.append((lay, t, ops.BitfieldSpec(0, bits), seg, True, family))
    for lay, t, sp, seg, kv, family in cases:
        rep = mst.launch_report(lay.kernel, t, sp, num_segments=seg, key_value=kv, family=family)
        occ = tiles.occupancy(lay, rep["registers"], rep["static_smem"], limits)
        n_rep += 1
        if (occ.stages, occ.smem, occ.blocks, lay.threads) != (
                rep["stages"], rep["smem"], rep["blocks"], rep["threads"]):
            raise AssertionError(f"{lay.kernel} at T = {t} ({family}, s = {seg}, kv = {kv}): the "
                                 f"model gives {occ}, the launcher reports {rep}")
        n_ceiling += tiles.occupancy(lay, limits=limits).blocks == rep["blocks"]
    log("autotune", f"the shared-memory model equals the launchers' reported (stages, shared "
                    f"bytes, blocks an SM) in all {n_rep} reports (12 kernels, tiles 256-8192, "
                    f"both families, flat and segmented, both label sources; the card's "
                    f"registers and static bytes); with the __launch_bounds__ register ceiling "
                    f"instead, {n_ceiling} of {n_rep} block counts agree; limits {limits}")
    return counts, {"search_s": search_s, "times": times, "tile_ms": tile_ms}



# The serving slice (repro_torch.serving): S3's routing shape as a served
# step — steps of at most 2^20 tokens and 256 requests, E = 64, capacity 48
SERVE_REQUESTS = 2048
SERVE_MEAN_LEN, SERVE_MAX_LEN = 4096, 16384
# timed passes over those requests, unverified: a closed pass lasts about
# 0.05 s and an open one about 0.11 s on an H100, so each set spans a few
# seconds, and the median and spread are over passes
SERVE_PASSES, SERVE_OPEN_PASSES = 80, 24
# the chaos parts' injector seed: on the flat kv and S1 calls below its
# "cuda" stream fires as a transient, two resource and a lowering fault,
# never three times on one plan class, and once more in the serving run (a
# CPU rehearsal of the same ladder and the same steps picks it)
CHAOS_SEED = 737


# the resilience layer's counters outside the deliberate faults (the chaos
# runs, the out-of-memory ladder), summed over the whole run: the last check
# reads the sum, so no phase's reset can hide a demotion or a shrink
STRICT_STATS = {}


def settle_stats(deliberate=False):
    """Add the resilience counters since the last reset to
    :data:`STRICT_STATS` (unless they count deliberate faults), reset them,
    and return them."""
    from repro_torch.runtime import resilience as rz

    got = rz.stats()
    if not deliberate:
        for k, v in got.items():
            STRICT_STATS[k] = STRICT_STATS.get(k, 0) + v
    rz.reset_stats()
    return got


def serving_config(dev, **kw):
    from repro_torch.serving import ServingConfig

    base = dict(num_experts=S3_EXPERTS, capacity=S3_CAPACITY, max_batch_requests=256,
                max_batch_tokens=1 << 20, length_splitters=(1024, 4096), device=str(dev))
    base.update(kw)
    return ServingConfig(**base)


def serving_phase(dev, registry, max_err, log, smi):
    """The serving slice at full size: ``ServerLoop`` over S3's routing
    shape, prewarmed. A closed loop of 2048 requests and an open loop at
    half the QPS the closed loop sustained, each verified at level 2 on
    every step in strict mode and every step's (slot, keep, counts) held
    bitwise against ``route_oracle``; then :data:`SERVE_PASSES` closed and
    :data:`SERVE_OPEN_PASSES` open passes unverified, timed, for the median
    and spread of QPS, host ms a step and latency; one packed step bitwise
    ``route_oracle``; ``launch.serve.main(["--traffic"])`` at its defaults.
    Returns the launch counts of all these runs."""
    import torch

    from repro_torch.core.pipeline import clear_tile_cache, tiles
    from repro_torch.launch import serve
    from repro_torch.runtime import resilience as rz
    from repro_torch.serving import (ServerLoop, closed_loop, engine, open_loop,
                                     poisson_arrivals, synthetic_requests)

    cfg = serving_config(dev)
    reqs = synthetic_requests(SERVE_REQUESTS, cfg.num_experts, seed=SEED,
                              mean_len=SERVE_MEAN_LEN, max_len=SERVE_MAX_LEN)
    loop = ServerLoop(cfg)
    t0 = time.perf_counter()
    loop.prewarm()
    torch.cuda.synchronize()
    prewarm_s = time.perf_counter() - t0
    windows, seen = [], []          # admission windows; (ids, starts, out) of verified steps
    groups = loop.policy.length_groups

    def watched(lp, verified):
        lp.policy.length_groups = lambda rs: (windows.append(len(rs)), groups(rs))[1]
        if verified:
            check = lp._maybe_verify

            def keep(p, out):
                out = check(p, out)
                seen.append((p.ids, p.starts, out))
                return out

            lp._maybe_verify = keep
        return lp

    def clean(name, summ):
        if summ["dropped_by_bug"] != 0 or summ["completed"] != (
                summ["submitted"] - summ["shed"] - summ["failed"]) or summ["failed"]:
            raise AssertionError(f"serving ({name}) lost or failed requests: {summ}")
        if summ["retries"] or summ["requeued"] or summ["degradations"]:
            raise AssertionError(f"serving ({name}) retried, requeued or degraded in strict "
                                 f"mode: {summ}")

    def spread(xs):
        q1, _, q3 = statistics.quantiles(xs, n=4)
        return (f"median {statistics.median(xs):.4f} (min {min(xs):.4f}, quartiles "
                f"{q1:.4f} / {q3:.4f}, max {max(xs):.4f})")

    settle_stats()
    torch.cuda.synchronize()
    registry.reset_launches()
    # ---- verified: every step at level 2 and against the oracle
    rz.set_verify(2)
    t0 = time.perf_counter()
    closed = closed_loop(watched(loop, True), reqs)
    closed_v_s = time.perf_counter() - t0
    rz.set_verify(None)
    clean("verified closed loop", closed)
    # ---- timed: the same requests, unverified, pass after pass
    passes = []
    for _ in range(SERVE_PASSES):
        lp = watched(ServerLoop(cfg), False)
        t0 = time.perf_counter()
        summ = closed_loop(lp, reqs)
        dt = time.perf_counter() - t0
        clean("timed closed loop", summ)
        passes.append((summ["completed"] / dt, dt / summ["steps"] * 1e3, summ["steps"], dt))
    qps = statistics.median(p[0] for p in passes)
    rz.set_verify(2)
    opened = open_loop(watched(ServerLoop(cfg), True), reqs,
                       poisson_arrivals(SERVE_REQUESTS, qps / 2, seed=SEED))
    rz.set_verify(None)
    clean("verified open loop", opened)
    open_passes = []
    for i in range(SERVE_OPEN_PASSES):
        t0 = time.perf_counter()
        summ = open_loop(watched(ServerLoop(cfg), False), reqs,
                         poisson_arrivals(SERVE_REQUESTS, qps / 2, seed=SEED + 1 + i))
        clean("timed open loop", summ)
        open_passes.append((summ, time.perf_counter() - t0))
    torch.cuda.synchronize()
    counts = {k: v for k, v in registry.launch_counts().items() if v}
    checks = rz.stats()["verify_checks"]
    verified = closed["steps"] + opened["steps"]
    steps = verified + sum(p[2] for p in passes) + sum(s["steps"] for s, _ in open_passes)
    if checks != verified or len(seen) != verified or closed["verify_mismatches"] or opened[
            "verify_mismatches"]:
        raise AssertionError(f"serving: {checks} routing checks and {len(seen)} outputs kept for "
                             f"{verified} verified steps")
    for i, (ids, starts, out) in enumerate(seen):
        want = route_oracle(torch.from_numpy(ids).to(dev), starts, cfg.num_experts,
                            cfg.capacity, dev)
        for name, a, b in zip(("slot", "keep", "counts"), out, want):
            if max_err(a.to(torch.int32), b.to(torch.int32)):
                raise AssertionError(f"served step {i} ({ids.shape[0]} tokens, {len(starts)} "
                                     f"segments): {name} differs from route_oracle")
    shapes = sorted({(ids.shape[0], len(starts)) for ids, starts, _ in seen})
    del seen[:]
    # every routing step K1s then K3s; every admission window K1 and K2
    # (the length bucketing, key-value)
    expect = {"seg_spec_tile_histograms": steps, "seg_spec_tile_positions": steps,
              "spec_tile_histograms": len(windows), "spec_fused_postscan_reorder": len(windows)}
    if counts != expect:
        raise AssertionError(f"serving launches {counts} != {expect}")
    tokens_per_step = statistics.mean(r.tokens for r in loop.metrics.step_records)
    log("serving", f"ServerLoop (E = {cfg.num_experts}, capacity {cfg.capacity}, at most "
                   f"{cfg.max_batch_requests} requests and 2^20 tokens a step, token classes "
                   f"{cfg.token_pad_classes}, length splitters {cfg.length_splitters}): prewarm "
                   f"{prewarm_s:.2f} s; {SERVE_REQUESTS} requests (mean length "
                   f"{SERVE_MEAN_LEN}, at most {SERVE_MAX_LEN}, {sum(map(len, reqs))} tokens), "
                   f"{closed['steps']} steps of {closed['batch_requests_mean']:.1f} requests and "
                   f"{tokens_per_step:.0f} tokens, occupancy "
                   f"{closed['batch_token_occupancy']:.4f} [{smi}]")
    log("serving", f"closed loop, {SERVE_PASSES} timed passes unverified in "
                   f"{sum(p[3] for p in passes):.4f} s: QPS sustained "
                   f"{spread([p[0] for p in passes])}; host ms a step "
                   f"{spread([p[1] for p in passes])}; every pass {sorted({p[2] for p in passes})} "
                   f"steps; the verified pass (level 2 on every step) {closed_v_s:.4f} s, "
                   f"{closed['completed'] / closed_v_s:.1f} QPS [{smi}]")
    log("serving", f"open loop at {qps / 2:.1f} QPS (Poisson, half the closed loop's median), "
                   f"{SERVE_OPEN_PASSES} timed passes unverified in "
                   f"{sum(t for _, t in open_passes):.4f} s: latency p50 "
                   f"{spread([s['latency_p50_ms'] for s, _ in open_passes])} ms, p95 "
                   f"{spread([s['latency_p95_ms'] for s, _ in open_passes])} ms, p99 "
                   f"{spread([s['latency_p99_ms'] for s, _ in open_passes])} ms; QPS sustained "
                   f"{spread([s['qps_sustained'] for s, _ in open_passes])}; steps a pass "
                   f"{spread([s['steps'] for s, _ in open_passes])}; occupancy "
                   f"{spread([s['batch_token_occupancy'] for s, _ in open_passes])}; queue depth "
                   f"max {max(s['queue_depth_max'] for s, _ in open_passes)} [{smi}]")
    log("serving", f"strict: {verified} verified steps (the closed loop's {closed['steps']}, the "
                   f"open loop's {opened['steps']}), each at level 2 and each (slot, keep, "
                   f"counts) bitwise route_oracle (shapes {shapes}); no retry, requeue or "
                   f"degradation in any pass; every request conserved; launches {counts} "
                   f"({steps} steps, {len(windows)} admission windows)")
    # one step of the packed family, bitwise the stable-sort oracle
    batch = [r for r in reqs[:256] if r.shape[0]][:64]
    from repro_torch.serving.request import Request

    ids, starts, _ = loop._pack([Request(i, r, 0.0) for i, r in enumerate(batch)])
    n_pad, s_pad = ids.shape[0], starts.shape[0]
    clear_tile_cache()
    tiles._FAMILY_CACHE[(n_pad, s_pad * cfg.num_experts, "dms", "cuda")] = (
        "packed", "pinned by chip_smoke.py")
    registry.reset_launches()
    got = engine._routing_op(cfg.num_experts, cfg.capacity, "cuda", str(dev))(ids, starts)
    torch.cuda.synchronize()
    packed = {k: v for k, v in registry.launch_counts().items() if v}
    want = route_oracle(torch.from_numpy(ids).to(dev), starts, cfg.num_experts, cfg.capacity, dev)
    for name, a, b in zip(("slot", "keep", "counts"), got, want):
        if max_err(a.to(torch.int32), b.to(torch.int32)):
            raise AssertionError(f"packed serving step: {name} differs from route_oracle")
    if packed != {"packed_tile_histograms": 1, "packed_tile_positions": 1}:
        raise AssertionError(f"packed serving step launched {packed}")
    clear_tile_cache()
    for k, v in packed.items():
        counts[k] = counts.get(k, 0) + v
    log("serving", f"one packed step ({len(batch)} requests, {n_pad} tokens padded, "
                   f"{s_pad} segments): (slot, keep, counts) bitwise equal to route_oracle; "
                   f"launches {packed}")
    t0 = time.perf_counter()
    summ = serve.main(["--traffic"])
    log("serving", f"launch.serve.main(['--traffic']) at its defaults on the card in "
                   f"{time.perf_counter() - t0:.2f} s: completed {summ['completed']} of "
                   f"{summ['submitted']}, dropped_by_bug {summ['dropped_by_bug']}, retries "
                   f"{summ['retries']}, requeued {summ['requeued']}, p99 "
                   f"{summ['latency_p99_ms']:.4f} ms [{smi}]")
    clean("launch.serve --traffic", summ)
    return counts


def serving_trace_phase(dev, log, smi):
    """Where one serving step's host time goes: a ``torch.profiler`` trace of
    one full step (admit, pack, route, finalize) at the serving phase's
    config, its host syncs counted, and the card's idle share of that same
    step: one minus the union of its device activities over the span from
    the step's start to its final synchronisation. After the times: a
    profiler session before SDPA's would leave that one no kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.serving import ServerLoop, synthetic_requests

    cfg = serving_config(dev, lookahead_batches=1)
    reqs = synthetic_requests(768, cfg.num_experts, seed=SEED + 1, mean_len=SERVE_MEAN_LEN,
                              max_len=SERVE_MAX_LEN)
    loop = ServerLoop(cfg)
    loop.prewarm()
    for r in reqs:
        loop.submit(r)

    def one_step():
        rep_ = loop.step(force=True)
        loop.flush()
        torch.cuda.synchronize()
        return rep_

    one_step()                                  # warm the admission's depth class
    t0 = time.perf_counter()
    timed = one_step()
    step_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("serving_step"):
            rep = one_step()
    spans = [ev.time_range for ev in prof.events()
             if ev.name == "serving_step" and ev.device_type == DeviceType.CPU]
    if len(spans) != 1:
        raise AssertionError(f"the trace holds {len(spans)} serving_step spans, not one")
    span = spans[0]
    busy, end = 0.0, span.start
    # the card's activities (kernels, copies, sets), not the span's own
    # annotation on the card's timeline
    for ev in sorted((ev for ev in prof.events()
                      if ev.device_type == DeviceType.CUDA and ev.name != "serving_step"),
                     key=lambda ev: ev.time_range.start):
        a, b = max(ev.time_range.start, end), min(ev.time_range.end, span.end)
        if b > a:
            busy += b - a
        end = max(end, ev.time_range.end)
    span_ms, busy_ms = (span.end - span.start) / 1e3, busy / 1e3
    events = prof.key_averages()
    host = sorted((ev for ev in events if ev.device_type == DeviceType.CPU),
                  key=lambda ev: -ev.self_cpu_time_total)
    syncs = [ev for ev in host if any(w in ev.key for w in (
        "_local_scalar_dense", "Synchronize", "Memcpy", "nonzero"))]
    kernels = [ev for ev in events if ev.device_type == DeviceType.CUDA
               and ev.key != "serving_step"]
    dev_ms = sum(getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0))
                 for ev in kernels) / 1e3
    n_sync = sum(ev.count for ev in syncs if "Synchronize" in ev.key or "_local_scalar" in ev.key)
    log("serving trace", f"one step ({timed['requests']} requests, {timed['tokens']} tokens, "
                         f"{timed['tokens_padded']} padded) {step_ms:.4f} ms host wall with a "
                         f"synchronisation after it; the next ({rep['requests']} requests, "
                         f"{rep['tokens']} tokens) under torch.profiler: span "
                         f"{span_ms:.4f} ms, the card busy {busy_ms:.4f} ms of it (idle "
                         f"{1 - busy_ms / span_ms:.4f}), device kernels {dev_ms:.4f} ms; host syncs "
                         f"(stream / device / event synchronize and scalar reads) {n_sync}: "
                         + "; ".join(f"{ev.key} x{ev.count} "
                                     f"{ev.self_cpu_time_total / 1e3:.4f} ms" for ev in syncs)
                         + "; host ops by self time " + "; ".join(
                             f"{ev.key} x{ev.count} {ev.self_cpu_time_total / 1e3:.4f} ms"
                             for ev in host[:10]) + f" [{smi}]")
    return {"step_ms": step_ms, "device_ms": dev_ms, "syncs": n_sync, "span_ms": span_ms,
            "busy_ms": busy_ms}


def fill_memory(dev):
    """Blocks of 256, then 16, then 1 MiB until the caching allocator refuses
    each size: what it keeps reserved in partly used segments goes too,
    which holding ``mem_get_info``'s free bytes leaves to the next call."""
    import torch

    held = []
    for mib in (256, 16, 1):
        try:
            while True:
                held.append(torch.empty(mib << 20, dtype=torch.uint8, device=dev))
        except torch.OutOfMemoryError:
            pass
    return held


def resilience_phase(dev, gen, s1_starts, registry, max_err, log, smi):
    """The resilience layer on the card. (a) Chaos, not strict, with the
    fallback off the card opted in (``rz.set_fallback(True)``): a seeded
    ``FaultInjector(rate=0.01, dispatch_rate=0.05)`` over the flat key-value
    bms call at 2^25 (m = 256), S1 key-value and a serving run, each result
    bitwise the strict run's and no request lost. (b) A real out-of-memory:
    with the card filled (:func:`fill_memory`), the same flat call raises
    ``torch.OutOfMemoryError`` in strict mode, which ``classify`` makes a
    ``KernelResourceError``; without strict, at the default, the ladder
    shrinks the tile and re-raises, leaving no quarantine; opted in, it
    shrinks, quarantines and demotes to its floor; then, the memory freed
    and the quarantine cleared, the call on ``cuda`` is bitwise right and
    launches its kernels: an out-of-memory leaves the context alive. The
    counters of both parts are kept out of :data:`STRICT_STATS`."""
    import torch

    from repro_torch import ops
    from repro_torch.core.pipeline import clear_tile_cache, set_autotune
    from repro_torch.runtime import FaultInjector
    from repro_torch.runtime import resilience as rz
    from repro_torch.serving import ServerLoop, closed_loop, synthetic_requests

    run_dir = os.environ["REPRO_AUTOTUNE_DIR"]
    set_autotune(cache_dir=run_dir)          # an earlier phase pointed it elsewhere
    fields = ("keys", "values", "bucket_starts", "bucket_counts", "permutation")
    n = N_MAIN
    keys = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=dev,
                         generator=gen).view(torch.uint32)
    values = torch.randint(-2**31, 2**31, (n,), dtype=torch.int32, device=dev, generator=gen)
    spec, spec1 = ops.DeltaSpec(256, 1 << 32), ops.DeltaSpec(32, 1 << 32)
    flat = functools.partial(ops.multisplit_key_value, keys, values, spec, device=dev)
    seg = functools.partial(ops.segmented_multisplit, keys, spec1, s1_starts, values, device=dev)
    want_flat, want_seg = flat(), seg()            # strict
    torch.cuda.synchronize()

    # ---- (a) chaos, not strict, the fallback opted in
    ops.set_strict(False)
    rz.set_fallback(True)
    settle_stats()
    inj = FaultInjector(rate=0.01, dispatch_rate=0.05, seed=CHAOS_SEED)
    rz.set_fault_injector(inj)
    t0 = time.perf_counter()
    for what, call, want in (("flat kv bms 2^25", flat, want_flat), ("S1 kv bms", seg, want_seg)):
        for trial in range(8):
            got = call()
            for f in fields:
                if max_err(getattr(got, f), getattr(want, f)):
                    raise AssertionError(f"chaos {what} trial {trial}: {f} differs from strict")
    del got
    calls_s = time.perf_counter() - t0
    op_stats = rz.stats()
    cfg = serving_config(dev)
    reqs = synthetic_requests(512, cfg.num_experts, seed=SEED + 2, mean_len=SERVE_MEAN_LEN,
                              max_len=SERVE_MAX_LEN)
    rz.set_verify(2)
    loop = ServerLoop(cfg, fault_injector=inj)
    before = inj.injected
    summ = closed_loop(loop, reqs)
    rz.set_verify(None)
    if summ["dropped_by_bug"] or summ["verify_mismatches"] or summ["completed"] != (
            summ["submitted"] - summ["shed"] - summ["failed"]) or inj.injected == before:
        raise AssertionError(f"chaos serving ({inj.injected - before} faults): {summ}")
    rz.set_fault_injector(None)
    rz.set_fallback(None)
    s = settle_stats(deliberate=True)
    log("resilience", f"chaos (FaultInjector(rate=0.01, dispatch_rate=0.05, seed={CHAOS_SEED}), "
                      f"not strict, set_fallback(True)): 8 flat kv bms calls at 2^25 (m = 256) and 8 S1 kv bms calls "
                      f"in {calls_s:.2f} s, each bitwise the strict run; ladder on those calls: "
                      f"injected {inj.dispatch_injected}, transient_retries "
                      f"{op_stats['transient_retries']}, tile_shrinks {op_stats['tile_shrinks']}, "
                      f"backend_demotions {op_stats['backend_demotions']}, breaker_trips "
                      f"{op_stats['breaker_trips']}; then a closed serving loop of 512 requests "
                      f"under the same injector ({inj.injected - before} faults, "
                      f"{summ['steps']} steps): completed {summ['completed']}, failed "
                      f"{summ['failed']}, retries {summ['retries']}, requeued {summ['requeued']}, "
                      f"degradations {summ['degradations']}, dropped_by_bug 0, every step "
                      f"verified (level 2, no mismatch); injected in all {inj.injected}; counters "
                      f"{s} [{smi}]")
    if not (op_stats["transient_retries"] and op_stats["tile_shrinks"]
            and op_stats["backend_demotions"]):
        raise AssertionError(f"the chaos seed did not reach every rung: {op_stats}")
    rz.clear_quarantine(disk=True)
    clear_tile_cache()

    # ---- (b) a real out-of-memory
    ops.set_strict(True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(dev)[0]
    hog = fill_memory(dev)
    try:
        flat()
        raise AssertionError("the flat call ran on a full card")
    except torch.OutOfMemoryError as err:
        kind = rz.classify(err, backend="cuda")
        if not isinstance(kind, rz.KernelResourceError):
            raise AssertionError(f"classify made the out-of-memory a {type(kind).__name__}")
        strict_msg = str(err).splitlines()[0][:160]
    ops.set_strict(False)
    try:                                     # the default on the card: no fallback
        flat()
        raise AssertionError("the flat call ran on a full card")
    except torch.OutOfMemoryError:
        pass
    plain_events = [f"{e['kind']} tile {e['tile']}" for e in rz.events() if "tile" in e]
    plain = settle_stats(deliberate=True)
    if (plain["tile_shrinks"] == 0 or plain["backend_demotions"] or plain["breaker_trips"]
            or rz.quarantine_snapshot() or os.path.exists(rz.quarantine_path())):
        raise AssertionError(f"the default out-of-memory ladder on the card left the kernels or "
                             f"kept a quarantine: {plain}, {rz.quarantine_snapshot()}")
    rz.set_fallback(True)
    floor = None
    try:
        flat()
    except torch.OutOfMemoryError as err:
        floor = type(err).__name__
    rz.set_fallback(None)
    ladder = rz.stats()
    events = [e["kind"] + (f" {e.get('frm')}->{e.get('to')}" if "frm" in e else "")
              + (f" tile {e['tile']}" if "tile" in e else "") for e in rz.events()]
    sidecar = sorted(rz.quarantine_snapshot())
    on_disk = os.path.exists(rz.quarantine_path())
    n_blocks = len(hog)
    del hog
    torch.cuda.empty_cache()
    log("resilience", f"out-of-memory: the card filled through the caching allocator "
                      f"({free / 2**30:.2f} GiB free before, {n_blocks} blocks of 256, 16 and "
                      f"1 MiB); strict: "
                      f"torch.OutOfMemoryError ({strict_msg}) classified "
                      f"{type(kind).__name__}; not strict, at the default (no fallback off the "
                      f"card): {plain_events}, then the out-of-memory re-raised, tile_shrinks "
                      f"{plain['tile_shrinks']}, backend_demotions 0, no quarantine; opted in "
                      f"(set_fallback(True)), the ladder: {events}, ending in "
                      f"{floor or 'a result'}; counters tile_shrinks {ladder['tile_shrinks']}, "
                      f"backend_demotions {ladder['backend_demotions']}, quarantine_skips "
                      f"{ladder['quarantine_skips']}, breaker_trips {ladder['breaker_trips']}; "
                      f"the sidecar ({'on disk' if on_disk else 'in memory'}) holds "
                      f"{len(sidecar)} entries: {sidecar} [{smi}]")
    if ladder["tile_shrinks"] == 0 or ladder["breaker_trips"] == 0:
        raise AssertionError(f"the out-of-memory ladder neither shrank nor tripped: {ladder}")
    settle_stats(deliberate=True)
    rz.clear_quarantine(disk=True)
    clear_tile_cache()
    ops.set_strict(True)
    torch.cuda.synchronize()
    registry.reset_launches()
    got = flat()
    torch.cuda.synchronize()
    counts = {k: v for k, v in registry.launch_counts().items() if v}
    for f in fields:
        if max_err(getattr(got, f), getattr(want_flat, f)):
            raise AssertionError(f"after the out-of-memory: {f} differs")
    if counts != {"spec_tile_histograms": 1, "spec_fused_postscan_reorder": 1}:
        raise AssertionError(f"after the out-of-memory the call launched {counts}")
    log("resilience", f"after the out-of-memory, memory freed and the quarantine cleared: the "
                      f"flat kv call on cuda is bitwise the strict run and launched {counts}: "
                      f"the context is alive")
    rz.set_fault_injector(None)
    rz.clear_quarantine(disk=True)
    return counts


# ---------------------------------------------------------------------------
# The distributed stage (A12) and the model serving path (A13, dense and
# MoE), each a phase of its own; main() calls them after the resilience layer
# ---------------------------------------------------------------------------

N_SHARDS = 8                   # multisplit_all_shards: (8, 2^22), an 8-shard split
N_SHARD = 1 << 22
DIST_WORLD = 4                 # gloo ranks on the one card
DIST_N = 1 << 23               # keys a rank
DIST_M = 256
DBRX_LAYERS = 2                # dbrx-132b at full width, depth cut to 2 layers (see model_phase)
DBRX_BATCH, DBRX_SEQ = 2, 2048
DBRX_DECODE_STEPS = 16
# float32 logits, kernels against plain versions. The init's fan_in of wq
# (d, h, hd) is h = 48, so q and k reach about 60 and 150 and a score sums
# products of up to about 9000: 3xTF32 keeps about 2^-21 of each, and the
# attention outputs part by a few 1e-4 of their largest, the logits by a
# few 1e-3 after two layers (tools/dbrx_fp32_gap.py measures each stage)
DBRX_LOGIT_RTOL = 1e-2
DECODE_RTOL = 2e-2             # decode against forward: tests/test_models.py's limit


def event_ms(fn, reps=5, inner=2) -> float:
    """Median ms of ``fn`` on the card: CUDA events around ``inner`` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def bits_equal(a, b) -> bool:
    import torch

    if a is None or b is None:
        return a is None and b is None
    return a.shape == b.shape and torch.equal(a.reshape(-1).view(torch.int32),
                                              b.reshape(-1).view(torch.int32))


def dist_inputs(dev):
    """The keys and values of all ranks, from :data:`SEED` on the card (every
    rank draws the same)."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 1)
    keys = torch.randint(-2**31, 2**31, (DIST_WORLD * DIST_N,), dtype=torch.int32, device=dev,
                         generator=g).view(torch.uint32)
    return keys, torch.arange(DIST_WORLD * DIST_N, dtype=torch.int32, device=dev)


def bucket_oracle(flat, rank: int, capacity: int, n_dev: int, world: int):
    """JAX's drop rule on the flat result: rank ``rank`` gets the elements
    of its bucket group in src-major order (source rank, then its
    bucket-major order), keeps the first ``capacity`` and puts them back
    bucket-major, zeros after them. Returns (keys, values, count)."""
    import torch

    dev = flat.keys.device
    mb = flat.bucket_counts.shape[0] // world
    lo = int(flat.bucket_starts[rank * mb])
    hi = lo + int(flat.bucket_counts[rank * mb:(rank + 1) * mb].sum())
    n = flat.keys.shape[0]
    src_of = torch.empty(n, dtype=torch.int64, device=dev)
    src_of[flat.permutation.long()] = torch.arange(n, device=dev) // n_dev   # source of a slot
    order = torch.sort(src_of[lo:hi], stable=True).indices          # the src-major order
    src_major = torch.empty_like(order)
    src_major[order] = torch.arange(hi - lo, device=dev)
    kept = src_major < capacity
    count = int(kept.sum())
    out = []
    for x in (flat.keys, flat.values):
        o = torch.zeros(capacity, dtype=torch.int32, device=dev)
        o[:count] = x[lo:hi].view(torch.int32)[kept]
        out.append(o)
    return out[0], out[1], count


def distributed_rank(rank: int, world: int, store: str, report: str, device: str) -> None:
    """One gloo rank of ``distributed_phase`` on the one card (a
    ``torch.multiprocessing.spawn`` target): ``multisplit_sharded`` and
    ``multisplit_bucket_sharded`` (ragged and dense, a capacity that drops
    nothing and one that drops), each bitwise its oracle from the flat
    multisplit of all ranks' keys; then the local stage's and the whole
    call's times. Rank 0 writes the report."""
    import torch
    import torch.distributed as dist

    from repro_torch import ops
    from repro_torch.core import distributed as D
    import repro_torch.kernels as registry

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        spec = ops.DeltaSpec(DIST_M, 1 << 32)
        keys, vals = dist_inputs(dev)
        flat = ops.multisplit(keys, spec, vals, device=dev)
        sl = slice(rank * DIST_N, (rank + 1) * DIST_N)
        mine, my_vals = keys[sl], vals[sl]
        registry.reset_launches()
        got = D.multisplit_sharded(mine, spec, my_vals, device=dev)
        torch.cuda.synchronize()
        sharded_launches = {k: v for k, v in registry.launch_counts().items() if v}
        for name, a, b in (("keys", got.keys, flat.keys[sl]),
                           ("values", got.values, flat.values[sl]),
                           ("bucket_starts", got.bucket_starts, flat.bucket_starts),
                           ("bucket_counts", got.bucket_counts, flat.bucket_counts)):
            if not bits_equal(a, b):
                raise AssertionError(f"rank {rank}: multisplit_sharded {name} differs from the "
                                     f"flat result's slice")
        capacities = {"no drop": 2 * DIST_N, "drop": DIST_N // 2}
        dropped, bucket_launches = {}, {}
        for transport in ("ragged", "dense"):
            for what, cap in capacities.items():
                registry.reset_launches()
                b = D.multisplit_bucket_sharded(mine, spec, my_vals, capacity=cap,
                                                transport=transport, device=dev)
                torch.cuda.synchronize()
                bucket_launches[transport] = {k: v for k, v in registry.launch_counts().items()
                                              if v}
                wk, wv, count = bucket_oracle(flat, rank, cap, DIST_N, world)
                mb = DIST_M // world
                checks = (("keys", b.keys.view(torch.int32), wk), ("values", b.values, wv),
                          ("count", b.count, torch.tensor([count], dtype=torch.int32, device=dev)),
                          ("group_counts", b.group_counts,
                           flat.bucket_counts[rank * mb:(rank + 1) * mb]),
                          ("bucket_counts", b.bucket_counts, flat.bucket_counts))
                for name, x, y in checks:
                    if not bits_equal(x, y):
                        raise AssertionError(f"rank {rank}: multisplit_bucket_sharded "
                                             f"({transport}, {what}) {name} differs from the "
                                             f"oracle of JAX's drop rule")
                dropped[f"{transport}, {what}"] = int(b.group_counts.sum()) - count
        if dropped["ragged, drop"] <= 0 or dropped["ragged, no drop"] != 0:
            raise AssertionError(f"rank {rank}: the capacities did not drop as meant: {dropped}")

        # times: the local stage alone on the card (CUDA events), the whole
        # call on the host's clock (every rank in step)
        local_ms = event_ms(lambda: D._local_plan(mine, spec, my_vals, "bms", None, None))

        def wall_ms(fn, reps=3):
            times = []
            for _ in range(reps):
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(times)

        call_ms = {
            "sharded (dense)": wall_ms(lambda: D.multisplit_sharded(mine, spec, my_vals,
                                                                    device=dev)),
            "bucket_sharded ragged": wall_ms(lambda: D.multisplit_bucket_sharded(
                mine, spec, my_vals, capacity=2 * DIST_N, transport="ragged", device=dev)),
            "bucket_sharded dense": wall_ms(lambda: D.multisplit_bucket_sharded(
                mine, spec, my_vals, capacity=2 * DIST_N, transport="dense", device=dev)),
        }
        if rank == 0:
            with open(report, "w") as f:
                json.dump({"local_ms": local_ms, "call_ms": call_ms, "dropped": dropped,
                           "sharded_launches": sharded_launches,
                           "bucket_launches": bucket_launches}, f)
    finally:
        dist.destroy_process_group()


def distributed_phase(dev, registry, log, smi):
    """The distributed stage (A12) on the card. ``multisplit_all_shards`` at
    (8, 2^22) uint32 keys with int32 values, ``DeltaSpec(256, 2^32)``, bms:
    bitwise the flat ``ops.multisplit`` of the concatenation (keys, values,
    starts, counts, permutation), one K1 and one K2 for all shards. Then
    :data:`DIST_WORLD` gloo ranks on the one card (``torch.multiprocessing``,
    the kernels built here first, so the ranks only load them), 2^23 keys a
    rank, m = 256 (:func:`distributed_rank`). Returns the launch counts of
    the single-process call."""
    import torch
    import torch.multiprocessing as tmp

    from repro_torch import ops
    from repro_torch.core import distributed as D

    torch.cuda.empty_cache()              # the ranks' contexts and inputs need room
    spec = ops.DeltaSpec(DIST_M, 1 << 32)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 2)
    keys = torch.randint(-2**31, 2**31, (N_SHARDS, N_SHARD), dtype=torch.int32, device=dev,
                         generator=g).view(torch.uint32)
    vals = torch.arange(N_SHARDS * N_SHARD, dtype=torch.int32, device=dev).view(N_SHARDS, N_SHARD)
    registry.reset_launches()
    got = D.multisplit_all_shards(keys, spec, vals, device=dev)
    torch.cuda.synchronize()
    counts = {k: v for k, v in registry.launch_counts().items() if v}
    want = ops.multisplit(keys.reshape(-1), spec, vals.reshape(-1), device=dev)
    for field in ("keys", "values", "bucket_starts", "bucket_counts", "permutation"):
        if not bits_equal(getattr(got, field), getattr(want, field)):
            raise AssertionError(f"multisplit_all_shards {field} differs from the flat multisplit")
    if counts != {"spec_tile_histograms": 1, "spec_fused_postscan_reorder": 1}:
        raise AssertionError(f"multisplit_all_shards launched {counts}, not one K1 and one K2")
    ms_all = event_ms(lambda: D.multisplit_all_shards(keys, spec, vals, device=dev))
    ms_flat = event_ms(lambda: ops.multisplit(keys.reshape(-1), spec, vals.reshape(-1),
                                              device=dev))
    log("distributed", f"multisplit_all_shards ({N_SHARDS}, 2^{N_SHARD.bit_length() - 1}) uint32 "
                       f"kv, DeltaSpec({DIST_M}, 2^32), bms: keys, values, starts, counts and "
                       f"permutation bitwise the flat multisplit of the concatenation; launches "
                       f"{counts}; {ms_all:.4f} ms against the flat call's {ms_flat:.4f} ms "
                       f"[CUDA events; {smi}]")
    del keys, vals, got, want
    torch.cuda.empty_cache()

    store = os.path.join(ROOT, "build", "dist_store")
    report = os.path.join(ROOT, "build", "dist_report.json")
    for path in (store, report):
        if os.path.exists(path):
            os.remove(path)
    t0 = time.perf_counter()
    tmp.spawn(distributed_rank, args=(DIST_WORLD, store, report, str(dev)), nprocs=DIST_WORLD,
              join=True)
    with open(report) as f:
        rep = json.load(f)
    log("distributed", f"{DIST_WORLD} gloo ranks on one card, 2^{DIST_N.bit_length() - 1} keys a "
                       f"rank, m = {DIST_M}, {time.perf_counter() - t0:.1f} s in all: "
                       f"multisplit_sharded bitwise each rank's slice of the flat result; "
                       f"multisplit_bucket_sharded ragged and dense, capacity 2^"
                       f"{(2 * DIST_N).bit_length() - 1} (no drop) and 2^"
                       f"{(DIST_N // 2).bit_length() - 1} (rank 0 dropped {rep['dropped']}), "
                       f"bitwise the oracle of JAX's drop rule on every rank; rank 0's launches: "
                       f"sharded {rep['sharded_launches']}, bucket-sharded "
                       f"{rep['bucket_launches']}")
    log("distributed", f"rank 0: the local stage (one flat kv bms plan over its shard) "
                       f"{rep['local_ms']:.4f} ms on the card [CUDA events]; whole calls on the "
                       f"host's clock, median of 3: " + "; ".join(
                           f"{k} {v:.2f} ms" for k, v in rep["call_ms"].items())
                       + f" — the gloo transport's time is the host's (device to host, the "
                       f"collective over loopback, host to device), not the card's [{smi}]")
    for path in (store, report):
        if os.path.exists(path):
            os.remove(path)
    return counts


def decode_step_trace(dev, log, smi) -> None:
    """One decode step of tinyllama-1.1b's full config (bfloat16, batch 4,
    the demo's shape) traced by ``torch.profiler``: its kernels, its device
    time and the card's idle share of the step's host span."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import init_params

    cfg = get_config("tinyllama-1.1b")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    params = init_params(M.decl_model(cfg), g, torch.bfloat16)
    tok = torch.ones((4, 1), dtype=torch.int32, device=dev)
    with torch.inference_mode():
        cache = M.init_cache(params, cfg, 4, 64)
        for t in range(3):                                   # warm
            M.decode_step(params, cfg, cache, tok, t)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            M.decode_step(params, cfg, cache, tok, 3)
            torch.cuda.synchronize()
            span_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernels = sum(e.count for e in events)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    ops = sum(e.count for e in prof.key_averages()
              if e.device_type == DeviceType.CPU and e.key.startswith("aten::"))
    log("model", f"one decode step of tinyllama-1.1b (bfloat16, batch 4) traced: {kernels} "
                 f"kernels ({kernels / cfg.n_layers:.1f} a layer), {ops} aten calls, device busy "
                 f"{busy_ms:.3f} ms of a {span_ms:.2f} ms step (idle {1 - busy_ms / span_ms:.3f}; "
                 f"the host span runs under the profiler) [torch.profiler; {smi}]")
    del params, cache


def model_trace_phase(dev, log, smi) -> None:
    """The model path under ``torch.profiler``, after SDPA's read (a
    session before that one leaves it no kernels): one decode step of the
    demo (:func:`decode_step_trace`), and dbrx's bfloat16 forward (the
    same 2 layers, parameters and tokens as ``model_phase``) by kernel
    kind: B11, K1, K3, the matmuls and the rest."""
    import dataclasses

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import init_params

    decode_step_trace(dev, log, smi)
    cfg = dataclasses.replace(get_config("dbrx-132b"), n_layers=DBRX_LAYERS)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    params = init_params(M.decl_model(cfg), g, torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab, (DBRX_BATCH, DBRX_SEQ), device=dev, generator=g,
                           dtype=torch.int32)
    with torch.inference_mode():
        M.forward(params, cfg, tokens=tokens)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            M.forward(params, cfg, tokens=tokens)
            torch.cuda.synchronize()
    kinds = {"B11": 0.0, "K1": 0.0, "K3": 0.0, "matmuls": 0.0, "other": 0.0}
    others = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us, key = e.self_device_time_total, e.key.lower()
        if "flash_sm90_kernel" in key or "flash_f32_sm90_kernel" in key:
            kinds["B11"] += us
        elif "tile_histograms_kernel" in key:
            kinds["K1"] += us
        elif "tile_positions_kernel" in key:
            kinds["K3"] += us
        elif any(w in key for w in ("gemm", "xmma", "cutlass", "nvjet", "matmul")):
            kinds["matmuls"] += us
        else:
            kinds["other"] += us
            others[e.key[:60]] = others.get(e.key[:60], 0.0) + us
    busy = sum(kinds.values())
    if not (busy and kinds["B11"] and kinds["K1"] and kinds["K3"]):
        raise AssertionError(f"torch.profiler read no device time of B11, K1 or K3 in the dbrx "
                             f"forward: {kinds}")
    log("model", f"dbrx forward bfloat16 device time by kind (torch.profiler, {busy / 1e3:.2f} ms "
                 f"busy): " + ", ".join(f"{k} {v / 1e3:.3f} ms ({v / busy:.1%})"
                                       for k, v in kinds.items())
                 + "; the largest others: " + ", ".join(
                     f"{k} {v / 1e3:.3f} ms" for k, v in sorted(others.items(),
                                                                key=lambda kv: -kv[1])[:4])
                 + f" [{smi}]")
    del params, tokens
    torch.cuda.empty_cache()


def family_inputs(cfg, batch: int, seq: int, g, dtype=None):
    """The model's inputs drawn from ``g`` on its device: ``{"tokens": ...}``,
    or ``{"embeds": ...}`` (frame embeddings) for a frontend-stub arch, and
    the patch embeddings (batch, n_vis_tokens, d_model) for a vlm, else
    None."""
    import torch

    dev = g.device
    dtype = dtype or getattr(torch, cfg.dtype)
    if cfg.embed_frontend_stub:
        x = {"embeds": torch.randn((batch, seq, cfg.d_model), device=dev, generator=g).to(dtype)}
    else:
        x = {"tokens": torch.randint(0, cfg.vocab, (batch, seq), device=dev, generator=g,
                                     dtype=torch.int32)}
    vis = (torch.randn((batch, cfg.n_vis_tokens, cfg.d_model), device=dev, generator=g).to(dtype)
           if cfg.n_vis_tokens else None)
    return x, vis


def decode_matches_forward(arch: str, dev) -> float:
    """A small float32 check of the cache on the card: ``arch``'s smoke
    config, 24 single-token decode steps (tokens, or frame embeddings for a
    frontend-stub arch; a vlm's cross K/V from ``init_cache``) against one
    forward. Returns the relative error of the logits."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import init_params

    cfg = get_config(arch).smoke()
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    params = init_params(M.decl_model(cfg), g)
    x, vis = family_inputs(cfg, 2, 24, g)
    (key, inp), = x.items()
    with torch.inference_mode():
        full, _, _ = M.forward(params, cfg, vis_embeds=vis, **x)
        cache = M.init_cache(params, cfg, 2, 24, vis_embeds=vis)
        dec = torch.cat([M.decode_step(params, cfg, cache, inp[:, t:t + 1], t)[0]
                         for t in range(24)], dim=1)
    err = float((dec - full).abs().max() / full.abs().max())
    if not err < DECODE_RTOL:
        raise AssertionError(f"{arch} smoke on the card: decode against forward {err:.3e}")
    return err


def model_phase(dev, registry, log, smi):
    """The model serving path (A13, dense and MoE) on the card.

    (a) The decode demo, ``launch.serve.main``, at tinyllama-1.1b's full
    config (22 layers, d_model 2048, 32 heads, kv 4, vocab 32000, bfloat16):
    batch 4, prompt 32, gen 32; and the smoke configs of tinyllama and dbrx
    in float32, decode against forward.
    (b) dbrx-132b at full width, its depth cut to :data:`DBRX_LAYERS` layers:
    its 40 layers are 132B parameters, 264 GB in bfloat16, and one card
    holds 80 GB; two layers are about 7.8B parameters (15.5 GB). Every width
    stays (d_model 6144, 48 heads, kv 8, d_ff 10752, 16 experts top-4,
    vocab 100352, ``dispatch="multisplit"``). ``forward`` on 2 x 2048 tokens
    in bfloat16 launches B11, K1 and K3 (counted), and each layer's MoE
    ranks and counts are bitwise the plain multisplit's (``vmap``) and the
    stable sort's on the same expert ids; 16 decode steps from
    ``init_cache`` (the device time by kernel kind is
    :func:`model_trace_phase`'s). Then, after the bfloat16 run has freed
    its memory, ``forward`` in float32 from the same parameters, once on the
    kernels and once on their plain versions (backend ``vmap``,
    ``flash_attention_plain``): the share of tokens whose top-4 experts agree
    in both layers, and the logits of the tokens before the first that
    differs in their sequence held to :data:`DBRX_LOGIT_RTOL`.
    Returns the launch counts of the demo and of the bfloat16 forward and
    decode."""
    import contextlib
    import dataclasses
    import io

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.parallel.sharding import init_params, param_count, tree_map

    torch.cuda.empty_cache()              # dbrx's float32 run holds about 46 GiB
    counts = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    # ---- (a) the decode demo at tinyllama-1.1b's full config
    registry.reset_launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        gen_tokens = serve.main(["--arch", "tinyllama-1.1b", "--batch", "4", "--prompt-len", "32",
                                 "--gen-len", "32", "--seed", str(SEED)])
    torch.cuda.synchronize()
    demo = {k: v for k, v in registry.launch_counts().items() if v}
    add(demo)
    text = out.getvalue()
    step = re.search(r"([\d.]+) ms/step, ([\d.]+) tok/s", text)
    in_vocab = bool(((gen_tokens >= 0) & (gen_tokens < 32000)).all())
    if gen_tokens.shape != (4, 32) or not step or not in_vocab:
        raise AssertionError(f"the decode demo's output is wrong: {tuple(gen_tokens.shape)}\n"
                             f"{text}")
    for line in text.strip().splitlines():
        log("model", line)
    log("model", f"decode demo tinyllama-1.1b full config, bfloat16, batch 4, prompt 32, gen 32 "
                 f"(63 decode steps, eager): {step.group(1)} ms/step, {step.group(2)} tok/s "
                 f"[host clock around the steps; {smi}]; kernel launches {demo or 'none'} (a "
                 f"dense model's decode step runs no kernel of the port)")
    launcher_mesh(text, "model", float(step.group(1)),
                  "decode demo tinyllama-1.1b ms/step, three runs before the mesh layer")
    errs = {arch: decode_matches_forward(arch, dev) for arch in ("tinyllama-1.1b", "dbrx-132b")}
    log("model", f"smoke configs on the card, float32, 24 decode steps against one forward: "
                 + ", ".join(f"{a} {e:.2e}" for a, e in errs.items())
                 + f" (relative, limit {DECODE_RTOL})")

    # ---- (b) dbrx-132b at full width, 2 layers
    cfg = dataclasses.replace(get_config("dbrx-132b"), n_layers=DBRX_LAYERS)
    decls = M.decl_model(cfg)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params(decls, g, torch.bfloat16)
    torch.cuda.synchronize()
    log("model", f"dbrx-132b at {DBRX_LAYERS} layers (full: 40), every width kept: "
                 f"{param_count(decls) / 1e9:.3f}B parameters, "
                 f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card in bfloat16, drawn "
                 f"in {time.perf_counter() - t0:.2f} s")
    tokens = torch.randint(0, cfg.vocab, (DBRX_BATCH, DBRX_SEQ), device=dev, generator=g,
                           dtype=torch.int32)

    routed = []                                  # (flat expert ids, ranks, counts) a layer
    ranks_fn = moe_mod._ranks_multisplit

    def recording(ids, e, *a, **kw):
        r = ranks_fn(ids, e, *a, **kw)
        routed.append((ids.clone(), r[0].clone(), r[1].clone()))
        return r

    moe_mod._ranks_multisplit = recording
    try:
        with torch.inference_mode():
            registry.reset_launches()
            logits, _, aux = M.forward(params, cfg, tokens=tokens)
            torch.cuda.synchronize()
            fwd = {k: v for k, v in registry.launch_counts().items() if v}
    finally:
        moe_mod._ranks_multisplit = ranks_fn
    add(fwd)
    for name in ("flash_attention", "spec_tile_histograms", "spec_tile_positions"):
        if not fwd.get(name):
            raise AssertionError(f"dbrx forward did not launch {name}: {fwd}")
    if logits.shape != (DBRX_BATCH, DBRX_SEQ, cfg.vocab) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"dbrx forward: logits {tuple(logits.shape)}, not all finite")
    for layer, (ids, ranks, cnt) in enumerate(routed):
        for backend_ranks, what in ((ranks_fn(ids, cfg.moe.num_experts, backend="vmap",
                                              device=dev), "the plain multisplit (vmap)"),
                                    (moe_mod._ranks_sort(ids, cfg.moe.num_experts, device=dev),
                                     "the stable sort")):
            if not (bits_equal(ranks, backend_ranks[0]) and bits_equal(cnt, backend_ranks[1])):
                raise AssertionError(f"dbrx layer {layer}: MoE ranks or counts differ from {what}")
    with torch.inference_mode():
        fwd_ms = event_ms(lambda: M.forward(params, cfg, tokens=tokens), reps=3, inner=1)
    log("model", f"dbrx forward bfloat16, {DBRX_BATCH} x {DBRX_SEQ} tokens: {fwd_ms:.2f} ms "
                 f"[CUDA events, median of 3; {smi}]; launches {fwd}; load balance "
                 f"{float(aux.load_balance):.4f}, drop {float(aux.drop_fraction):.4f}; MoE ranks "
                 f"and counts of both layers bitwise the plain multisplit and the stable sort")

    with torch.inference_mode():
        cache = M.init_cache(params, cfg, DBRX_BATCH, DBRX_DECODE_STEPS)
        registry.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(DBRX_DECODE_STEPS):
            step_logits, cache = M.decode_step(params, cfg, cache, tokens[:, t:t + 1], t)
        torch.cuda.synchronize()
        dec_ms = (time.perf_counter() - t0) * 1e3 / DBRX_DECODE_STEPS
        dec = {k: v for k, v in registry.launch_counts().items() if v}
    add(dec)
    if (step_logits.shape != (DBRX_BATCH, 1, cfg.vocab)
            or not bool(torch.isfinite(step_logits).all())):
        raise AssertionError("dbrx decode: logits not finite or of the wrong shape")
    log("model", f"dbrx {DBRX_DECODE_STEPS} decode steps from init_cache, bfloat16, batch "
                 f"{DBRX_BATCH}: {dec_ms:.2f} ms/step [host clock; {smi}]; launches {dec}")
    del logits, cache, step_logits, routed

    # ---- float32: the kernels against their plain versions, same parameters
    params = tree_map(lambda t: t.float(), params)
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    experts = {}
    router = moe_mod._router

    def keep_experts(tag):
        def fn(p, xn, c, **kw):
            out = router(p, xn, c, **kw)
            experts.setdefault(tag, []).append(out[1].sort(-1).values.clone())
            return out
        return fn

    got = {}
    try:
        with torch.inference_mode():
            for tag, backend in (("kernels", "cuda"), ("plain", "vmap")):
                moe_mod._router = keep_experts(tag)
                got[tag] = M.forward(params, cfg32, tokens=tokens, backend=backend)[0]
                torch.cuda.synchronize()
    finally:
        moe_mod._router = router
    same = torch.stack([(a == b).all(-1)
                        for a, b in zip(experts["kernels"], experts["plain"])]).all(0)
    same = same.view(DBRX_BATCH, DBRX_SEQ)
    share = float(same.float().mean())
    # a token whose experts differ changes what later tokens of its row read
    # in the next layer's attention: hold the tokens before the first such
    prefix = torch.cumprod(same.int(), dim=1).bool()
    a, b = got["kernels"][prefix], got["plain"][prefix]
    err = float((a - b).abs().max() / b.abs().max())
    log("model", f"dbrx forward float32 ({torch.cuda.memory_allocated() / 2**30:.1f} GiB held "
                 f"after both), kernels (B11 3xTF32, K1, K3) against their plain versions "
                 f"(vmap, flash_attention_plain): top-4 experts agree for {share:.6f} of "
                 f"{DBRX_BATCH * DBRX_SEQ} tokens in both layers; logits of the "
                 f"{int(prefix.sum())} tokens before the first that differs in their row: "
                 f"max abs err {float((a - b).abs().max()):.3e}, relative {err:.3e} (limit "
                 f"{DBRX_LOGIT_RTOL})")
    if not err < DBRX_LOGIT_RTOL or int(prefix.sum()) < DBRX_BATCH * DBRX_SEQ // 2:
        raise AssertionError(f"dbrx float32: kernels against plain versions {err:.3e} over "
                             f"{int(prefix.sum())} tokens")
    del params, got, experts
    torch.cuda.empty_cache()
    return counts


FAMILY_BATCH, FAMILY_SEQ = 2, 2048
FAMILY_DECODE_STEPS = 16
VISION_LAYERS = 10             # llama-3.2-vision-90b at full width, depth cut (see families_phase)
# B11 launches in one full forward: one a causal self-attention layer
# (zamba2's six shared occurrences, the 8 of vision's 10 layers that are not
# cross-attention, musicgen's 48); xlstm has no attention and no kernel
FAMILY_B11 = {"zamba2-1.2b": 6, "xlstm-350m": 0, "llama-3.2-vision-90b": 8,
              "musicgen-large": 48}
# zamba2 in float32, kernels against plain versions. Its 38 layers magnify
# rounding: each of the six shared attention occurrences multiplies the
# gap between two runs by about 8, and a relative 2^-21 perturbation of
# every parameter (about what 3xTF32 keeps of a product) moves the plain
# run's logits by 0.40 of their largest (tools/zamba2_fp32_gap.py). So the
# logits are held to what that perturbation does in the same run, and each
# B11 call, on the plain run's q, k, v (which reach 46: a score sums
# products of up to 2100), to ZAMBA_ATTN_RTOL of its largest output
# (measured 3.8e-5 to 4.4e-5)
ZAMBA_PERTURB = 2.0 ** -21
ZAMBA_ATTN_RTOL = 1e-3


def family_config(arch: str):
    """``arch``'s full config; the vision model's depth cut to
    :data:`VISION_LAYERS` (two super-blocks of 4 attn + 1 cross)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if arch == "llama-3.2-vision-90b":
        cfg = dataclasses.replace(cfg, n_layers=VISION_LAYERS)
    return cfg


def families_phase(dev, registry, log, smi):
    """The hybrid, ssm, vlm and audio families (A13a) on the card.

    (a) The decode demo, ``launch.serve.main``, in bfloat16 at the full
    configs of zamba2-1.2b and xlstm-350m (batch 4, prompt 32, gen 32) and
    musicgen-large (batch 4, prompt 32 frame embeddings, ``--gen-len 1``:
    the demo generates nothing for a frontend-stub arch, and ``--gen-len
    2`` exits); llama-3.2-vision-90b through ``--smoke`` (its full config
    is 175 GB). (b) The smoke configs of all four in float32, 24 decode
    steps against one forward. (c) ``forward`` in bfloat16 on 2 x 2048
    tokens (musicgen: seeded frame embeddings) at zamba2's, xlstm's and
    musicgen's full configs and the vision model's full width at
    :data:`VISION_LAYERS` layers with (2, 256, 8192) patch embeddings: B11
    launched :data:`FAMILY_B11` times and no other kernel, logits finite;
    CUDA-event ms; then 16 decode steps from ``init_cache``. (d) zamba2 at
    its full config in float32, ``forward`` on the kernels (B11's 3xTF32
    route) against their plain versions: each B11 call on the plain run's
    inputs within :data:`ZAMBA_ATTN_RTOL`, the logits within what a
    relative 2^-21 perturbation of the parameters moves the plain run.
    Returns the launch counts of the forwards and decodes of (c)."""
    import contextlib
    import dataclasses
    import io

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import init_params, param_count, tree_map

    torch.cuda.empty_cache()
    counts = {}

    def launched():
        return {k: v for k, v in registry.launch_counts().items() if v}

    # ---- (a) the decode demos
    demos = (("zamba2-1.2b", [], 32), ("xlstm-350m", [], 32), ("musicgen-large", [], 1),
             ("llama-3.2-vision-90b", ["--smoke"], 32))
    for arch, extra, gen_len in demos:
        argv = ["--arch", arch, *extra, "--batch", "4", "--prompt-len", "32", "--gen-len",
                str(gen_len), "--seed", str(SEED)]
        registry.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            gen_tokens = serve.main(argv)
        torch.cuda.synchronize()
        demo = launched()
        text = out.getvalue()
        step = re.search(r"([\d.]+) ms/step, ([\d.]+) tok/s", text)
        cfg = get_config(arch).smoke() if extra else get_config(arch)
        in_vocab = bool(((gen_tokens >= 0) & (gen_tokens < cfg.vocab)).all())
        if gen_tokens.shape != (4, gen_len) or not step or not in_vocab:
            raise AssertionError(f"the {arch} decode demo's output is wrong: "
                                 f"{tuple(gen_tokens.shape)}\n{text}")
        for line in text.strip().splitlines():
            log("families", line)
        n_steps = 32 + gen_len - 1
        log("families", f"decode demo {arch} {'smoke config, float32' if extra else 'full config, bfloat16'}, "
                        f"batch 4, prompt 32, gen {gen_len} ({n_steps} decode steps, eager): "
                        f"{step.group(1)} ms/step, {step.group(2)} tok/s [host clock around the "
                        f"steps; {smi}]; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
                        f"kernel launches {demo or 'none'}")
        del gen_tokens
        torch.cuda.empty_cache()
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            serve.main(["--arch", "musicgen-large", "--batch", "4", "--prompt-len", "32",
                        "--gen-len", "2", "--seed", str(SEED)])
    except SystemExit as exc:
        log("families", f"musicgen-large with --gen-len 2 exits as the JAX demo does: {exc}")
    else:
        raise AssertionError("musicgen-large's demo generated past the prompt: it has no token "
                             "table to feed generation back through")
    torch.cuda.empty_cache()

    # ---- (b) the smoke configs in float32: decode against forward
    errs = {arch: decode_matches_forward(arch, dev) for arch in FAMILY_B11}
    log("families", f"smoke configs on the card, float32, 24 decode steps against one forward: "
                    + ", ".join(f"{a} {e:.2e}" for a, e in errs.items())
                    + f" (relative, limit {DECODE_RTOL})")

    # ---- (c) full width, bfloat16: forward on 2 x 2048 tokens, 16 decode steps
    for arch in FAMILY_B11:
        cfg = family_config(arch)
        decls = M.decl_model(cfg)
        g = torch.Generator(device=dev)
        g.manual_seed(SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = init_params(decls, g, torch.bfloat16)
        torch.cuda.synchronize()
        drawn_s = time.perf_counter() - t0
        held = torch.cuda.memory_allocated() / 2**30
        if arch == "llama-3.2-vision-90b":
            full = param_count(M.decl_model(get_config(arch)))
            log("families", f"{arch} at {VISION_LAYERS} layers (full: {get_config(arch).n_layers}, "
                            f"{full / 1e9:.3f}B parameters, {2 * full / 1e9:.0f} GB in bfloat16: no "
                            f"card of 80 GB holds it), every width kept (d_model 8192, 64 heads, "
                            f"kv 8, d_ff 28672, vocab 128256, 256 patch embeddings)")
        x, vis = family_inputs(cfg, FAMILY_BATCH, FAMILY_SEQ, g)
        (key, inp), = x.items()
        with torch.inference_mode():
            registry.reset_launches()
            t0 = time.perf_counter()
            logits, _, _ = M.forward(params, cfg, vis_embeds=vis, **x)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            fwd = launched()
        for name, n in fwd.items():
            counts[name] = counts.get(name, 0) + n
        if fwd != ({"flash_attention": FAMILY_B11[arch]} if FAMILY_B11[arch] else {}):
            raise AssertionError(f"{arch} forward launched {fwd}, not B11 "
                                 f"{FAMILY_B11[arch]} times and nothing else")
        if (logits.shape != (FAMILY_BATCH, FAMILY_SEQ, cfg.vocab)
                or not bool(torch.isfinite(logits).all())):
            raise AssertionError(f"{arch} forward: logits {tuple(logits.shape)}, not all finite")
        del logits
        reps = 1 if arch == "xlstm-350m" else 3
        with torch.inference_mode():
            times = []
            for _ in range(reps):
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                M.forward(params, cfg, vis_embeds=vis, **x)
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            fwd_ms = statistics.median(times)
        peak = torch.cuda.max_memory_allocated() / 2**30
        log("families", f"{arch} forward bfloat16, {FAMILY_BATCH} x {FAMILY_SEQ} "
                        f"{'frame embeddings' if key == 'embeds' else 'tokens'}"
                        f"{', (2, 256, 8192) patch embeddings' if vis is not None else ''}, "
                        f"{cfg.n_layers} layers, {param_count(decls) / 1e9:.3f}B parameters "
                        f"({held:.1f} GiB, drawn in {drawn_s:.2f} s): {fwd_ms:.2f} ms [CUDA events, "
                        f"median of {reps} after the first, which took {first_s:.2f} s; {smi}]; "
                        f"launches {fwd or 'none'}; peak {peak:.2f} GiB")

        with torch.inference_mode():
            cache = M.init_cache(params, cfg, FAMILY_BATCH, FAMILY_DECODE_STEPS, vis_embeds=vis)
            registry.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for t in range(FAMILY_DECODE_STEPS):
                step_logits, cache = M.decode_step(params, cfg, cache, inp[:, t:t + 1], t)
            torch.cuda.synchronize()
            dec_ms = (time.perf_counter() - t0) * 1e3 / FAMILY_DECODE_STEPS
            dec = launched()
        for name, n in dec.items():
            counts[name] = counts.get(name, 0) + n
        if (step_logits.shape != (FAMILY_BATCH, 1, cfg.vocab)
                or not bool(torch.isfinite(step_logits).all())):
            raise AssertionError(f"{arch} decode: logits not finite or of the wrong shape")
        log("families", f"{arch} {FAMILY_DECODE_STEPS} decode steps from init_cache, bfloat16, "
                        f"batch {FAMILY_BATCH}: {dec_ms:.2f} ms/step [host clock; {smi}]; "
                        f"launches {dec or 'none'}")
        del params, cache, step_logits, x, vis, inp
        torch.cuda.empty_cache()

    # ---- (d) zamba2 at its full config in float32: kernels against plain versions
    cfg = dataclasses.replace(get_config("zamba2-1.2b"), dtype="float32")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    params = init_params(M.decl_model(cfg), g)
    x, _ = family_inputs(cfg, FAMILY_BATCH, FAMILY_SEQ, g)
    calls = {}
    b11 = L._attention_b11

    def recording(q, k, v, backend):
        out = b11(q, k, v, backend)
        calls.setdefault(backend, []).append((q.clone(), k.clone(), v.clone()))
        return out

    got = {}
    L._attention_b11 = recording
    try:
        with torch.inference_mode():
            for tag, backend in (("kernels", "cuda"), ("plain", "vmap")):
                got[tag] = M.forward(params, cfg, backend=backend, **x)[0]
                torch.cuda.synchronize()
    finally:
        L._attention_b11 = b11
    with torch.inference_mode():
        attn = []
        for q, k, v in calls["vmap"]:
            a, b = b11(q, k, v, "cuda"), b11(q, k, v, "vmap")
            attn.append(float((a - b).abs().max() / b.abs().max()))
        pg = torch.Generator(device=dev)
        pg.manual_seed(SEED + 1)
        moved = tree_map(lambda t: t * (1 + ZAMBA_PERTURB * torch.randn(
            t.shape, device=dev, generator=pg)), params)
        got["perturbed"] = M.forward(moved, cfg, backend="vmap", **x)[0]
    a, b = got["kernels"], got["plain"]
    err = float((a - b).abs().max() / b.abs().max())
    cond = float((got["perturbed"] - b).abs().max() / b.abs().max())
    log("families", f"zamba2-1.2b forward float32, full config, {FAMILY_BATCH} x {FAMILY_SEQ} "
                    f"tokens, kernels (B11 3xTF32) against their plain versions "
                    f"(flash_attention_plain): the {len(attn)} B11 calls on the plain run's q, k, "
                    f"v part by at most {max(attn):.3e} of their largest output (limit "
                    f"{ZAMBA_ATTN_RTOL}); logits max abs err {float((a - b).abs().max()):.3e}, "
                    f"relative {err:.3e}, against {cond:.3e} that the plain run moves when every "
                    f"parameter is perturbed by a relative 2^-21 (the limit; DBRX_LOGIT_RTOL "
                    f"{DBRX_LOGIT_RTOL} {'met' if err < DBRX_LOGIT_RTOL else 'missed'}: the 38 "
                    f"layers magnify rounding, tools/zamba2_fp32_gap.py)")
    if len(attn) != FAMILY_B11["zamba2-1.2b"] or not max(attn) < ZAMBA_ATTN_RTOL:
        raise AssertionError(f"zamba2 float32: B11 against its plain version on the same inputs "
                             f"{attn}")
    if not err < cond:
        raise AssertionError(f"zamba2 float32: kernels against plain versions {err:.3e}, more "
                             f"than a 2^-21 perturbation of the parameters moves them ({cond:.3e})")
    del params, moved, got, a, b, x, calls
    torch.cuda.empty_cache()
    return counts


def family_trace_phase(dev, log, smi) -> None:
    """zamba2-1.2b under ``torch.profiler``, after SDPA's read: its
    bfloat16 prefill on 2 x 2048 tokens by kernel kind (B11, the matmuls,
    the scans, the elementwise kernels, the rest), with the device time
    under the chunked SSD and the causal conv (``record_function`` ranges
    around ``models.ssm._ssd_chunked`` and ``_causal_conv``), and one
    decode step's kernels a layer and idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import model as M
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.parallel.sharding import init_params

    cfg = family_config("zamba2-1.2b")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    params = init_params(M.decl_model(cfg), g, torch.bfloat16)
    x, _ = family_inputs(cfg, FAMILY_BATCH, FAMILY_SEQ, g)
    ranges = {"ssd_chunked": ssm_mod._ssd_chunked, "causal_conv": ssm_mod._causal_conv}

    def ranged(name, fn):
        def run(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return run

    try:
        ssm_mod._ssd_chunked = ranged("ssd_chunked", ranges["ssd_chunked"])
        ssm_mod._causal_conv = ranged("causal_conv", ranges["causal_conv"])
        with torch.inference_mode():
            M.forward(params, cfg, **x)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                M.forward(params, cfg, **x)
                torch.cuda.synchronize()
    finally:
        ssm_mod._ssd_chunked = ranges["ssd_chunked"]
        ssm_mod._causal_conv = ranges["causal_conv"]
    kinds = {"B11": 0.0, "matmuls": 0.0, "scans": 0.0, "elementwise": 0.0, "other": 0.0}
    others, under, n_kernels = {}, {name: 0.0 for name in ranges}, 0
    for e in prof.key_averages():
        if e.key in under:                   # the range's kernels, not its span
            if e.device_type == DeviceType.CPU:
                under[e.key] = e.device_time_total
            continue
        if e.device_type != DeviceType.CUDA:
            continue
        us, key = e.self_device_time_total, e.key.lower()
        n_kernels += e.count
        if "flash_sm90_kernel" in key or "flash_f32_sm90_kernel" in key:
            kinds["B11"] += us
        elif any(w in key for w in ("gemm", "xmma", "cutlass", "nvjet", "matmul")):
            kinds["matmuls"] += us
        elif "scan" in key:
            kinds["scans"] += us
        elif "elementwise" in key:
            kinds["elementwise"] += us
        else:
            kinds["other"] += us
            others[e.key[:60]] = others.get(e.key[:60], 0.0) + us
    busy = sum(kinds.values())
    if not (busy and kinds["B11"] and kinds["matmuls"]):
        raise AssertionError(f"torch.profiler read no device time of B11 or the matmuls in the "
                             f"zamba2 forward: {kinds}")
    log("families", f"zamba2-1.2b forward bfloat16 ({FAMILY_BATCH} x {FAMILY_SEQ}) device time by "
                    f"kind (torch.profiler, {busy / 1e3:.2f} ms busy, {n_kernels} kernels, "
                    f"{n_kernels / cfg.n_layers:.1f} a layer): "
                    + ", ".join(f"{k} {v / 1e3:.3f} ms ({v / busy:.1%})" for k, v in kinds.items())
                    + "; kernels under the ranges: " + ", ".join(
                        f"{k} {v / 1e3:.3f} ms" for k, v in under.items())
                    + "; the largest others: " + ", ".join(
                        f"{k} {v / 1e3:.3f} ms" for k, v in sorted(others.items(),
                                                                   key=lambda kv: -kv[1])[:4])
                    + f" [{smi}]")

    tok = x["tokens"][:, :1]
    with torch.inference_mode():
        cache = M.init_cache(params, cfg, FAMILY_BATCH, 8)
        for t in range(3):                                   # warm
            M.decode_step(params, cfg, cache, tok, t)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            M.decode_step(params, cfg, cache, tok, 3)
            torch.cuda.synchronize()
            span_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernels = sum(e.count for e in events)
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    log("families", f"one decode step of zamba2-1.2b (bfloat16, batch {FAMILY_BATCH}) traced: "
                    f"{kernels} kernels ({kernels / cfg.n_layers:.1f} a layer), device busy "
                    f"{busy_ms:.3f} ms of a {span_ms:.2f} ms step (idle {1 - busy_ms / span_ms:.3f}; "
                    f"the host span runs under the profiler) [torch.profiler; {smi}]")
    del params, cache, x
    torch.cuda.empty_cache()


# training (A13b): tinyllama-1.1b's full config under the launcher
TRAIN_ARGV = ["--arch", "tinyllama-1.1b", "--steps", "8", "--batch", "4", "--seq", "2048",
              "--ckpt-every", "4"]
TRAIN_TOKENS = 4 * 2048
# the gradient check: tinyllama at full width, depth cut, float32, kernels
# against plain versions; each leaf's gradient to GRAD_RTOL of its largest.
# Then DESCENT_STEPS AdamW steps on that one batch, each of which must lower
# its loss: at 22 layers the JAX init's gradient norm is about 1e17 (it grows
# by orders of magnitude with depth, in JAX's model as in the port's:
# tests/test_torch_train.py, tools/grad_norm_depth.py), the clip at 1.0
# scales every gradient by about 1e-17, and 8 steps on fresh batches do not
# lower the loss beyond the batches' spread; at 2 layers the norm is about
# 200 and the steps descend
GRAD_LAYERS, GRAD_BATCH, GRAD_SEQ = 2, 2, 512
# the same ill-conditioning magnifies rounding in the gradients: at 2 layers
# a relative 2^-21 perturbation of every parameter moves the plain run's
# gradients by 2.5e-3 to 4.6e-3 of their largest, and the kernels part from
# the plain by 1.0e-3 to 5.0e-3 (PERF.md). So the limit is fixed at twice
# the worst of those readings; B11's own error on the run's q, k, v is held
# to ATTN_TOL["float32"]; and a control whose forward is B11's 16-bit route
# (q, k, v rounded to bfloat16) must break the limit, which shows that the
# limit tells a worse forward from B11's
GRAD_RTOL = 1e-2
LOSS_RTOL = 1e-4
DESCENT_STEPS, DESCENT_LR = 4, 1e-4
# dbrx-132b at full width, one layer, JAX's setting for memory-bound
# architectures (bfloat16 params and moments, a float32 master), 1 x 2048
# tokens a step
DBRX_TRAIN_LAYERS, DBRX_TRAIN_STEPS, DBRX_TRAIN_SEQ = 1, 4, 2048
# the supervisor on the card: dbrx's smoke config, a transient fault at
# step 5 and a persistent one at step 6 (three failures: past the two
# retries), which restores the step-4 checkpoint and replays steps 4 and 5
SUP_STEPS, SUP_FAULTS, SUP_REPLAY_RTOL = 8, {5: 1, 6: 3}, 1e-3


def _step_recorder(registry, make, log_to):
    """``make`` (``launch.steps.make_train_step``) whose steps record, each,
    (loss, ms on the host clock around a synchronised step, the launches of
    the step alone)."""
    import torch

    def recording_make(cfg, tc, **kw):
        step = make(cfg, tc, **kw)

        def run(state, batch):
            before = registry.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            after = registry.launch_counts()
            log_to.append((float(metrics["loss"]), ms,
                           {k: after[k] - before[k] for k in after if after[k] != before[k]},
                           float(metrics["grad_norm"])))
            return state, metrics
        return run
    return recording_make


def training_phase(dev, registry, log, smi):
    """Training on the card (A13b), after the families have freed their
    memory.

    (a) ``launch.train.main`` at tinyllama-1.1b's full config (22 layers at
    full width, bfloat16 compute, float32 params and moments, remat): 8
    AdamW steps of 4 x 2048 tokens under the supervisor, checkpoints every
    4 steps: ms/step (the median of steps 2-8), tokens/s, peak memory, B11
    launched 2 x 22 times a step (forward and the remat recompute) and no
    other kernel in a step; the losses and gradient norms finite (the
    loss does not fall in 8 steps at this depth: see :data:`GRAD_LAYERS`).
    (b) tinyllama at full width, depth cut to :data:`GRAD_LAYERS`,
    float32, 2 x 512 tokens: the loss and every parameter's gradient on
    ``backend="cuda"`` (B11's 3xTF32 forward) against ``backend="vmap"``
    (``flash_attention_plain``) within :data:`LOSS_RTOL` and
    :data:`GRAD_RTOL` of each leaf's largest; B11's own error on the run's
    q, k, v within ``ATTN_TOL["float32"]``; a control run whose forward is
    B11's 16-bit route breaking :data:`GRAD_RTOL`; every wq / wk / wv
    gradient nonzero; then :data:`DESCENT_STEPS` steps of
    ``make_train_step`` on that batch, on the kernels, each lowering its
    loss. (c) dbrx-132b at full width cut to one layer, bfloat16 params and
    moments with the float32 master: :data:`DBRX_TRAIN_STEPS`
    ``make_train_step`` steps of 1 x 2048
    tokens; K1, K3 and B11 launched twice a step what one forward launches;
    every step's ranks (forward and recompute) bitwise each other, the plain
    multisplit's (``vmap``) and the stable sort's on the same expert ids.
    (d) The supervisor on the card (dbrx's smoke config, the multisplit
    dispatch, the port's data pipeline on the card) under
    :data:`SUP_FAULTS`: its retries and restores, the history's replayed
    steps, and each replayed loss within :data:`SUP_REPLAY_RTOL` of the
    first run's (the MoE gather's backward adds with atomics). Returns the
    launch counts of (a), (c) and (d); (b)'s are a comparison."""
    import contextlib
    import dataclasses
    import io
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import DataPipeline
    from repro_torch.launch import steps as S
    from repro_torch.launch import train
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.sharding import init_params, tree_leaves, tree_leaves_with_path
    from repro_torch.runtime import FaultInjector, Supervisor, TrainLoopConfig

    torch.cuda.empty_cache()
    counts = {}

    def add(before):
        after = registry.launch_counts()
        for k in after:
            if after[k] != before[k]:
                counts[k] = counts.get(k, 0) + after[k] - before[k]

    work = tempfile.mkdtemp(prefix="train_", dir=os.path.join(ROOT, "build"))
    try:
        # ---- (a) the launcher at tinyllama-1.1b's full config
        steps_log = []
        make = S.make_train_step
        S.make_train_step = _step_recorder(registry, make, steps_log)
        torch.cuda.reset_peak_memory_stats()
        before = registry.launch_counts()
        out = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                sup = train.main(TRAIN_ARGV + ["--ckpt-dir", os.path.join(work, "tinyllama"),
                                               "--seed", str(SEED)])
        finally:
            S.make_train_step = make
        run_s = time.perf_counter() - t0
        add(before)
        peak = torch.cuda.max_memory_allocated() / 2**30
        for line in out.getvalue().strip().splitlines():
            log("training", line)
        cfg = get_config("tinyllama-1.1b")
        losses = [loss for loss, *_ in steps_log]
        norms = [norm for *_, norm in steps_log]
        step_ms = statistics.median(ms for _, ms, *_ in steps_log[1:])
        per_step = [launches for _, _, launches, _ in steps_log]
        b11 = 2 * cfg.n_layers
        log("training", f"tinyllama-1.1b full config (22 layers, bfloat16 compute, float32 "
                        f"params and moments, remat), 8 steps of 4 x 2048 tokens under the "
                        f"supervisor, checkpoints at steps 4 and 8: {step_ms:.2f} ms/step "
                        f"(median of steps 2-8; steps {[round(s[1], 2) for s in steps_log]}), "
                        f"{TRAIN_TOKENS / step_ms * 1e3:.0f} tokens/s [host clock around "
                        f"synchronised steps; {smi}]; peak {peak:.2f} GiB; launcher {run_s:.1f} s "
                        f"with its checkpoint writes; losses {[round(x, 4) for x in losses]}, "
                        f"gradient norms {[f'{x:.3e}' for x in norms]}; "
                        f"launches a step {per_step[0]} (the remat rule: B11 {b11}); stats "
                        f"{sup.stats}")
        launcher_mesh(out.getvalue(), "training", step_ms,
                      "train tinyllama-1.1b ms/step, the last run before the mesh layer")
        if len(steps_log) != 8 or sup.ckpt.latest_step() != 8:
            raise AssertionError(f"the launcher ran {len(steps_log)} steps, last checkpoint "
                                 f"{sup.ckpt.latest_step()}")
        if any(launches != {"flash_attention": b11} for launches in per_step):
            raise AssertionError(f"a tinyllama step launched {per_step}, not B11 {b11} times "
                                 f"and nothing else")
        if not all(math.isfinite(x) for x in losses + norms):
            raise AssertionError(f"tinyllama's losses or gradient norms: {losses}, {norms}")
        del sup
        torch.cuda.empty_cache()

        # ---- (b) gradients, kernels against plain versions
        cfg = dataclasses.replace(get_config("tinyllama-1.1b"), n_layers=GRAD_LAYERS,
                                  dtype="float32")
        g = torch.Generator(device=dev)
        g.manual_seed(SEED)
        params = init_params(M.decl_model(cfg), g)
        tokens = torch.randint(0, cfg.vocab, (GRAD_BATCH, GRAD_SEQ + 1), device=dev,
                               generator=g, dtype=torch.int32)
        batch = {"tokens": tokens[:, :-1].contiguous(), "labels": tokens[:, 1:].contiguous()}
        got, calls = {}, []
        b11 = L._attention_b11

        def recording(q, k, v, backend):
            calls.append((q.detach().clone(), k.detach().clone(), v.detach().clone()))
            return b11(q, k, v, backend)

        def sixteen_bit(q, k, v, backend):                 # the control's forward
            return b11(q.to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16),
                       backend).to(q.dtype)

        for name, door, backend in (("cuda", recording, "cuda"), ("vmap", b11, "vmap"),
                                    ("control", sixteen_bit, "cuda")):
            L._attention_b11 = door
            try:
                (loss, _), grads = S.grads_of(params, cfg, batch, backend=backend)
            finally:
                L._attention_b11 = b11
            got[name] = (float(loss), grads)
        rel = lambda a, b: float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        with torch.no_grad():
            kernel_err = max(rel(b11(q, k, v, "cuda"), b11(q, k, v, "vmap")) for q, k, v in calls)
        del calls

        def held(run):
            """(loss's relative error, [(leaf, error)], the worst leaf) of a run
            against the plain one"""
            errs = [(path, rel(a, b)) for (path, a), b in
                    zip(tree_leaves_with_path(got[run][1]), tree_leaves(got["vmap"][1]))]
            return (abs(got[run][0] - got["vmap"][0]) / abs(got["vmap"][0]), errs,
                    max(errs, key=lambda e: e[1]))

        loss_err, errs, worst = held("cuda")
        control_loss, _, control_worst = held("control")
        attn = got["cuda"][1]["blocks"][0]["attn"]
        zero = [f"{w}[{i}]" for w in ("wq", "wk", "wv") for i in range(GRAD_LAYERS)
                if not bool(attn[w][i].abs().amax() > 0)]
        log("training", f"gradients, tinyllama at full width and {GRAD_LAYERS} layers, float32, "
                        f"{GRAD_BATCH} x {GRAD_SEQ} tokens, B11 (3xTF32) against "
                        f"flash_attention_plain: loss {got['cuda'][0]:.6f} against "
                        f"{got['vmap'][0]:.6f} (relative {loss_err:.3e}, limit {LOSS_RTOL}); "
                        f"B11's own relative error on the run's q, k, v {kernel_err:.3e} (limit "
                        f"{ATTN_TOL['float32']}); each leaf's error against its largest "
                        f"gradient (limit {GRAD_RTOL}): "
                        f"{[(p, f'{e:.3e}') for p, e in errs]}, the worst {worst[1]:.3e} "
                        f"({worst[0]}); the control (B11's 16-bit route in the forward): loss "
                        f"{control_loss:.3e}, the worst leaf {control_worst[1]:.3e} "
                        f"({control_worst[0]}); wq / wk / wv gradients zero in {zero or 'none'}")
        if not (loss_err <= LOSS_RTOL and worst[1] <= GRAD_RTOL
                and kernel_err <= ATTN_TOL["float32"]) or zero:
            raise AssertionError(f"training gradients: loss {loss_err:.3e}, {worst[0]} at "
                                 f"{worst[1]:.3e}, B11 {kernel_err:.3e}, zero attention "
                                 f"gradients {zero}")
        if not control_worst[1] > GRAD_RTOL:
            raise AssertionError(f"the gradient limit {GRAD_RTOL} passes the control: the 16-bit "
                                 f"route's worst leaf {control_worst[1]:.3e}")
        del got, grads, attn, worst, control_worst
        tc = TrainConfig(lr=DESCENT_LR, warmup_steps=1, total_steps=100)
        state = S.TrainState(params, adamw_init(params, tc))
        step_fn = S.make_train_step(cfg, tc)
        descent = []
        for _ in range(DESCENT_STEPS + 1):           # the first step's rate is the warmup's 0
            state, metrics = step_fn(state, batch)
            descent.append(float(metrics["loss"]))
        log("training", f"{DESCENT_STEPS + 1} steps on that batch (lr {DESCENT_LR}, B11 in the "
                        f"forward): losses {[round(x, 5) for x in descent]}, gradient norm at the "
                        f"last {float(metrics['grad_norm']):.3e}")
        if not all(b < a for a, b in zip(descent[1:], descent[2:])) or not descent[-1] < descent[0]:
            raise AssertionError(f"steps along the port's gradient did not lower the loss: "
                                 f"{descent}")
        del params, state, metrics
        torch.cuda.empty_cache()

        # ---- (c) dbrx-132b at full width, one layer
        _dbrx_training(dev, registry, log, smi, add)
        # ---- (d) the supervisor on the card
        cfg = get_config("dbrx-132b").smoke()
        tc = TrainConfig(global_batch=4, seq_len=256, lr=3e-3, total_steps=SUP_STEPS,
                         warmup_steps=2, seed=SEED)
        g = torch.Generator(device=dev)
        g.manual_seed(SEED)
        params = init_params(M.decl_model(cfg), g)
        pipeline = DataPipeline(vocab=cfg.vocab, seq_len=tc.seq_len, batch_per_host=4,
                                seed=SEED, device=dev)

        def batch_fn(step):
            return {k: torch.from_numpy(v).to(dev) for k, v in pipeline.batch_at(step).items()}

        before = registry.launch_counts()
        sup = Supervisor(S.make_train_step(cfg, tc), batch_fn,
                         TrainLoopConfig(total_steps=SUP_STEPS, checkpoint_every=4,
                                         checkpoint_dir=os.path.join(work, "supervisor"),
                                         log_every=1, max_retries_per_step=2),
                         fault_injector=FaultInjector(fail_at=dict(SUP_FAULTS)),
                         sleep_fn=lambda s: None)
        sup.run(S.TrainState(params, adamw_init(params, tc)))
        add(before)
        hist = [(h["step"], h["loss"]) for h in sup.history]
        first = {}
        replay = []
        for step, loss in hist:
            if step in first:
                replay.append((step, loss, first[step], abs(loss - first[step]) / abs(first[step])))
            else:
                first[step] = loss
        log("training", f"supervisor on the card (dbrx-132b smoke, multisplit, 4 x 256 tokens, "
                        f"faults {SUP_FAULTS}): stats {sup.stats}; history steps "
                        f"{[s for s, _ in hist]}; replayed steps (step, loss, first run's, "
                        f"relative): "
                        f"{[(s, round(a, 6), round(b, 6), f'{r:.2e}') for s, a, b, r in replay]}")
        want_steps = [0, 1, 2, 3, 4, 5, 4, 5, 6, 7]
        if (sup.stats["retries"] != 4 or sup.stats["restores"] != 1
                or [s for s, _ in hist] != want_steps
                or any(r > SUP_REPLAY_RTOL for *_, r in replay) or len(replay) != 2):
            raise AssertionError(f"the supervisor on the card: stats {sup.stats}, history {hist}")
        del sup, params, pipeline
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return counts


def _dbrx_training(dev, registry, log, smi, add):
    """Part (c) of :func:`training_phase`: dbrx-132b at full width and
    :data:`DBRX_TRAIN_LAYERS` layer, trained by ``make_train_step``."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.sharding import init_params, param_count

    cfg = dataclasses.replace(get_config("dbrx-132b"), n_layers=DBRX_TRAIN_LAYERS)
    decls = M.decl_model(cfg)
    seq = DBRX_TRAIN_SEQ
    tc = TrainConfig(global_batch=1, seq_len=seq, lr=3e-4, warmup_steps=1,
                     total_steps=DBRX_TRAIN_STEPS, params_dtype="bfloat16",
                     moments_dtype="bfloat16", seed=SEED)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    params = init_params(decls, g, torch.bfloat16)
    state = S.TrainState(params, adamw_init(params, tc))
    held = torch.cuda.memory_allocated() / 2**30
    tokens = torch.randint(0, cfg.vocab, (DBRX_TRAIN_STEPS, 1, seq + 1), device=dev,
                           generator=g, dtype=torch.int32)
    batches = [{"tokens": t[:, :-1].contiguous(), "labels": t[:, 1:].contiguous()}
               for t in tokens]
    with torch.inference_mode():                     # one forward: what the remat rule doubles
        before = registry.launch_counts()
        M.forward(state.params, cfg, tokens=batches[0]["tokens"])
        torch.cuda.synchronize()
        after = registry.launch_counts()
        fwd = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    routed = []
    ranks_fn = moe_mod._ranks_multisplit

    def recording(ids, e, *a, **kw):
        r = ranks_fn(ids, e, *a, **kw)
        routed.append((ids.clone(), r[0].clone(), r[1].clone()))
        return r

    steps_log = []
    step_fn = _step_recorder(registry, S.make_train_step, steps_log)(cfg, tc)
    moe_mod._ranks_multisplit = recording
    try:
        before = registry.launch_counts()
        for b in batches:
            state, metrics = step_fn(state, b)
        add(before)
    finally:
        moe_mod._ranks_multisplit = ranks_fn
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {k: 2 * v for k, v in fwd.items()}
    if any(launches != want for _, _, launches, _ in steps_log):
        raise AssertionError(f"dbrx steps launched {[s[2] for s in steps_log]}, not twice a "
                             f"forward's {fwd}")
    if len(routed) != 2 * DBRX_TRAIN_STEPS * DBRX_TRAIN_LAYERS:
        raise AssertionError(f"dbrx routed {len(routed)} times in {DBRX_TRAIN_STEPS} steps")
    for i, (ids, ranks, cnt) in enumerate(routed):
        twin = routed[i ^ 1]                             # the forward's and the recompute's
        if not (bits_equal(ids, twin[0]) and bits_equal(ranks, twin[1])):
            raise AssertionError(f"dbrx step {i // 2}: the recompute routed otherwise")
        for other, what in ((ranks_fn(ids, cfg.moe.num_experts, backend="vmap", device=dev),
                             "the plain multisplit (vmap)"),
                            (moe_mod._ranks_sort(ids, cfg.moe.num_experts, device=dev),
                             "the stable sort")):
            if not (bits_equal(ranks, other[0]) and bits_equal(cnt, other[1])):
                raise AssertionError(f"dbrx step {i // 2}: ranks or counts differ from {what}")
    losses = [loss for loss, *_ in steps_log]
    ms = [ms for _, ms, *_ in steps_log]
    log("training", f"dbrx-132b at {DBRX_TRAIN_LAYERS} layer (full: 40), every width kept, "
                    f"{param_count(decls) / 1e9:.3f}B parameters, bfloat16 params and moments, "
                    f"float32 master ({held:.1f} GiB of state), {DBRX_TRAIN_STEPS} steps of 1 x "
                    f"{seq} tokens: {statistics.median(ms[1:]):.2f} ms/step (median of steps 2-"
                    f"{DBRX_TRAIN_STEPS}; steps {[round(x, 2) for x in ms]}) [host clock around "
                    f"synchronised steps; {smi}]; peak {peak:.2f} GiB; losses "
                    f"{[round(x, 4) for x in losses]}; launches a step {steps_log[0][2]} (a "
                    f"forward: {fwd}); every step's ranks and counts, forward and recompute, "
                    f"bitwise each other, the plain multisplit and the stable sort")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"dbrx losses {losses}")
    for name in ("flash_attention", "spec_tile_histograms", "spec_tile_positions"):
        if not fwd.get(name):
            raise AssertionError(f"dbrx's forward launched no {name}: {fwd}")
    del state, params, batches, routed
    torch.cuda.empty_cache()


def training_trace_phase(dev, log, smi) -> None:
    """One training step of tinyllama-1.1b's full config (4 x 2048 tokens,
    as :func:`training_phase` (a)) under ``torch.profiler``, after SDPA's
    read: device time by kind (B11, the plain attention backward under
    ``models.layers._b11_backward``, the optimizer under
    ``launch.steps.adamw_update``, K1/K3, the matmuls, the elementwise
    kernels, the rest; a kernel under a range counts for the range) and the
    card's idle share of the step's host span."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import steps as S
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.sharding import init_params

    cfg = get_config("tinyllama-1.1b")
    tc = TrainConfig(global_batch=4, seq_len=2048)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    params = init_params(M.decl_model(cfg), g)
    state = S.TrainState(params, adamw_init(params, tc))
    tokens = torch.randint(0, cfg.vocab, (4, 2049), device=dev, generator=g, dtype=torch.int32)
    batch = {"tokens": tokens[:, :-1].contiguous(), "labels": tokens[:, 1:].contiguous()}
    ranges = {"attention backward": ("_b11_backward", L), "optimizer": ("adamw_update", S)}
    originals = {name: getattr(mod, fn) for name, (fn, mod) in ranges.items()}

    def ranged(name, fn):
        def run(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return run

    step = S.make_train_step(cfg, tc)
    try:
        for name, (fn, mod) in ranges.items():
            setattr(mod, fn, ranged(name, originals[name]))
        state, _ = step(state, batch)                          # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            span_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for name, (fn, mod) in ranges.items():
            setattr(mod, fn, originals[name])
    kinds = {k: 0.0 for k in ("B11", "attention backward", "optimizer", "K1/K3", "matmuls",
                              "elementwise", "other")}
    n_kernels = [0]

    def by_name(key):
        key = key.lower()
        if "flash_sm90_kernel" in key or "flash_f32_sm90_kernel" in key:
            return "B11"
        if "tile_histograms_kernel" in key or "tile_positions_kernel" in key:
            return "K1/K3"
        if any(w in key for w in ("gemm", "xmma", "cutlass", "nvjet", "matmul")):
            return "matmuls"
        return "elementwise" if "elementwise" in key else "other"

    def walk(ev, kind):
        kind = ev.name if ev.name in ranges else kind
        for k in ev.kernels:
            n_kernels[0] += 1
            kinds[kind or by_name(k.name)] += k.duration
        for child in ev.cpu_children:
            walk(child, kind)

    for ev in prof.events():
        if ev.device_type == DeviceType.CPU and ev.cpu_parent is None:
            walk(ev, None)
    busy = sum(kinds.values())
    if not (busy and kinds["B11"] and kinds["matmuls"]):
        raise AssertionError(f"torch.profiler read no device time of B11 or the matmuls in a "
                             f"training step: {kinds}")
    log("training", f"one training step of tinyllama-1.1b (full config, 4 x 2048) traced: "
                    f"{n_kernels[0]} kernels, device busy {busy / 1e3:.2f} ms of a "
                    f"{span_ms:.2f} ms step (idle {1 - busy / 1e3 / span_ms:.3f}; the host span "
                    f"runs under the profiler); by kind: "
                    + ", ".join(f"{k} {v / 1e3:.3f} ms ({v / busy:.1%})" for k, v in kinds.items())
                    + f" [torch.profiler; {smi}]")
    del state, params, batch
    torch.cuda.empty_cache()


SUBNORMAL_TINY = (1e-38, -1e-38, 1e-39, -1e-39, 1.4e-45, -1.4e-45, 5e-39, -5e-39, 0.0, -0.0)
SUBNORMAL_N = 1 << 20


def subnormal_phase(dev, registry, log, smi):
    """Subnormal float32 keys on the card (``ROADMAP.md`` §C, §C 4): XLA
    flushes them, the port keeps IEEE subnormals (the CPU tests hold
    ``reference`` and ``vmap`` to numpy's answer). Here the ``cuda`` labels
    (``RangeSpec((-2.0, -0.0, 0.5, 1.0, 4.0))`` and ``EvenSpec(-1e-38,
    1e-38, 4)``, whose width 5e-39 is subnormal, computed in K1-K3, K1s-K3s
    and K2/K2s) against ``vmap`` on 2^20 keys holding every probe (±1e-38,
    ±5e-39, ±1e-39, ±1.4e-45, ±0) 4096 times: flat and segmented, every
    method and mode, key-value, bitwise; and ``histogram``."""
    import numpy as np
    import torch

    from repro_torch import ops

    rng = np.random.RandomState(SEED + 31)
    keys = rng.uniform(-3, 5, SUBNORMAL_N).astype(np.float32)
    at = rng.choice(SUBNORMAL_N, 4096 * len(SUBNORMAL_TINY), replace=False)
    keys[at] = np.tile(np.asarray(SUBNORMAL_TINY, np.float32), 4096)
    keys = torch.from_numpy(keys).to(dev)
    vals = torch.arange(SUBNORMAL_N, dtype=torch.int32, device=dev)
    starts = torch.tensor([0, 1000, 1000, SUBNORMAL_N // 3, SUBNORMAL_N * 3 // 4],
                          dtype=torch.int64, device=dev)
    specs = {"range": ops.RangeSpec((-2.0, -0.0, 0.5, 1.0, 4.0)),
             "even": ops.EvenSpec(-1e-38, 1e-38, 4)}
    registry.reset_launches()
    cases = 0
    for name, spec in specs.items():
        for seg in (False, True):
            for method in ("dms", "wms", "bms"):
                for mode in ("reorder", "counts_only", "positions_only"):
                    v = vals if mode == "reorder" else None
                    got = {}
                    for backend in ("cuda", "vmap"):
                        kw = dict(method=method, mode=mode, backend=backend, device=dev)
                        got[backend] = (ops.segmented_multisplit(keys, spec, starts, v, **kw)
                                        if seg else ops.multisplit(keys, spec, v, **kw))
                    for field in ("keys", "values", "bucket_starts", "bucket_counts",
                                  "permutation"):
                        a, b = getattr(got["cuda"], field), getattr(got["vmap"], field)
                        if not bits_equal(a, b):
                            raise AssertionError(f"subnormal keys, {name} "
                                                 f"{'segmented' if seg else 'flat'} {method} "
                                                 f"{mode}: {field} differs from vmap")
                    cases += 1
        hist = {b: ops.histogram(keys, spec, backend=b, device=dev) for b in ("cuda", "vmap")}
        if not bits_equal(hist["cuda"], hist["vmap"]):
            raise AssertionError(f"subnormal keys, {name}: histogram differs from vmap")
        neg = int(hist["cuda"][1]) if name == "range" else None
        if name == "range":
            log("subnormal", f"RangeSpec((-2, -0.0, 0.5, 1, 4)) histogram on the card "
                             f"{hist['cuda'].tolist()}: -1e-38, -5e-39, -1e-39, -1.4e-45 counted "
                             f"in bucket 1 ({neg} keys), as numpy does (XLA flushes them into "
                             f"bucket 2)")
    torch.cuda.synchronize()
    counts = {k: v for k, v in registry.launch_counts().items() if v}
    log("subnormal", f"{cases} cases (2 specs x flat/segmented x 3 methods x 3 modes, key-value "
                     f"in reorder) and both histograms: the cuda labels bitwise vmap's on "
                     f"{SUBNORMAL_N} float32 keys with every subnormal probe 4096 times; launches "
                     f"{counts} [{smi}]")
    return counts


MESH_WORLD = 4                 # gloo ranks on the one card: a (2, 2) (data, model) mesh
MESH_SHAPE = (2, 2)
MESH_BATCH, MESH_SEQ = 2, 2048
MESH_DECODE_STEPS = 4
MESH_MOE_RTOL = 1e-4           # multisplit_ep against the one-process dispatch (JAX's criterion)
MESH_CAPACITY_FACTORS = (1.25, 1.0)   # the config's, and one whose local capacity drops
MESH_F32_LAYERS = 1            # the float32 run that holds the sharded logits to a limit
MESH_PERTURB = 2.0 ** -21      # float32: the one-process run's movement, reported beside the gap
MESH_TIE = 1e-3                # a routing that differs is a near-tie: top-k gap under this
MESH_MS_BEFORE = {"decode demo tinyllama-1.1b ms/step, three runs before the mesh layer": (50.6, 43.4, 76.8),
                  "train tinyllama-1.1b ms/step, the last run before the mesh layer": (1028.89,)}


def launcher_mesh(text: str, phase: str, ms: float, before: str) -> None:
    """(c) of the mesh layer: a one-card launcher printed its ``(1,)``
    ``data`` mesh of one nccl rank first, and its time beside the figure
    of the PRs before the mesh (``MESH_MS_BEFORE``; ±10 % is the end-to-end
    spread)."""
    first = text.strip().splitlines()[0]
    if "mesh {'data': 1} over 1 rank(s), nccl on cuda" not in first:
        raise AssertionError(f"the launcher's first line is not its one-card mesh: {first}")
    was = MESH_MS_BEFORE[before]
    log(phase, f"(c) through the launcher's mesh ({first.split('] ', 1)[-1]}): {ms:.2f} ms a "
               f"step beside {before} {list(was)}: {ms / statistics.median(was):.3f}x of their "
               f"median")


def _mesh_cfg(layers=None, capacity_factor=None, dtype=None):
    """dbrx-132b at full width with ``dispatch="multisplit_ep"``."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config("dbrx-132b")
    moe = dataclasses.replace(cfg.moe, dispatch="multisplit_ep",
                              capacity_factor=capacity_factor or cfg.moe.capacity_factor)
    return dataclasses.replace(cfg, n_layers=layers or cfg.n_layers, moe=moe,
                               dtype=dtype or cfg.dtype)


def _mesh_x(dev, cfg):
    """The MoE block's input: (2, 2048, d_model) float32 from the seed."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 41)
    return torch.randn((MESH_BATCH, MESH_SEQ, cfg.d_model), generator=g, device=dev)


def _mesh_tokens(dev, cfg):
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 42)
    return torch.randint(0, cfg.vocab, (MESH_BATCH, MESH_SEQ), generator=g, device=dev,
                         dtype=torch.int32)


def _recording_router(moe_mod, out):
    """``moe._router`` recording each call's top-k experts, whole, in the
    router's order."""
    from repro_torch.parallel.sharding import gather_full

    router = moe_mod._router

    def fn(p, xn, cfg, **kw):
        r = router(p, xn, cfg, **kw)
        out.append(gather_full(r[1]).clone())
        return r

    return router, fn


def _forced_router(moe_mod, experts):
    """``moe._router`` that routes every call to the next recorded experts
    (gates from this run's probabilities at them): a run routed as another
    was, so the two differ by their rounding alone."""
    import torch

    router = moe_mod._router
    calls = iter(experts)

    def fn(p, xn, cfg, **kw):
        _, own, lb, z = router(p, xn, cfg, **kw)
        chosen = next(calls).to(xn.device)
        probs = torch.softmax(torch.einsum("nd,de->ne", xn, p["router"].to(xn.dtype)).float(), -1)
        # where this run's own top-k differs from the recorded one, its gap
        # between the k-th and (k+1)-th probability: a near-tie, or a fault
        k = chosen.shape[-1]
        differ = (own.sort(-1).values != chosen.sort(-1).values).any(-1)
        top = probs.topk(k + 1, dim=-1).values
        gap = (top[:, k - 1] - top[:, k])[differ]
        diffs.append((int(differ.sum()), float(gap.max()) if gap.numel() else 0.0))
        gates = probs.gather(-1, chosen.long())
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        return gates, chosen, lb, z

    diffs = []
    return router, fn, diffs


def _recording_b11(layers_mod, calls, fault_rank=None):
    """``layers._b11_sharded`` keeping each call's DTensor q, k, v and
    output in ``calls``. With ``fault_rank``, the rank at that ``model``
    coordinate hands B11 its kv heads rolled by one, so its q heads meet the
    wrong kv heads: the control that the logits' limit must catch."""
    from torch.distributed.tensor import DTensor

    fn = layers_mod._b11_sharded

    def rec(q, k, v, backend, chunk):
        mesh = k.device_mesh
        if (fault_rank is not None
                and mesh.get_coordinate()[mesh.mesh_dim_names.index("model")] == fault_rank):
            k, v = (DTensor.from_local(x.to_local().roll(1, 2), x.device_mesh, x.placements,
                                       run_check=False) for x in (k, v))
        out = fn(q, k, v, backend, chunk)
        calls.append((q, k, v, out))
        return out

    return fn, rec


def _local_index(x):
    """The global indices, a dimension each, of the slice of DTensor ``x``
    that this rank holds: each mesh dimension that shards a tensor
    dimension splits it evenly, in the mesh's order."""
    import torch

    mesh, coord = x.device_mesh, x.device_mesh.get_coordinate()
    idx = [torch.arange(n, device=x.device) for n in x.shape]
    for i, pl in enumerate(x.placements):
        if pl.is_shard():
            idx[pl.dim] = idx[pl.dim].tensor_split(mesh.size(i))[coord[i]]
    return idx


def _assemble(parts, shape):
    """The whole tensor from (global indices, local slice) pairs, one a
    rank (:func:`_local_index`)."""
    import torch

    full = torch.full(shape, float("nan"), dtype=parts[0][1].dtype, device=parts[0][1].device)
    for idx, local in parts:
        n = len(idx)
        full[tuple(i.view([-1 if d == j else 1 for d in range(n)]).to(full.device)
                   for j, i in enumerate(idx))] = local
    return full


def _b11_against_plain(q, k, v, out):
    """One sharded B11 call on the whole q, k and v, the rank's slice of
    each dimension taken from the output's placements: bitwise against B11
    on the whole tensors in one call (the heads' layout: each (head, q
    block) is computed alike in both), and against ``flash_attention_plain``
    with the rank's q heads meeting kv heads by the global rule (q head h
    reads kv head h // g). The plain version's limit is ``ATTN_TOL`` in
    bfloat16 (``limit``). In float32 no limit is set: dbrx's scores reach
    about 9000, and B11's 3xTF32 products part from the plain version by
    about what a relative 2^-21 move of q, k and v moves the plain version
    (``moved``), above ``ATTN_TOL``'s 2e-4 for unit-scale inputs; both are
    reported. Returns a dict of the errors, over the largest |value| of the
    rank's slice."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers as L
    from repro_torch.parallel.sharding import gather_full

    qf, kf, vf = (gather_full(x) for x in (q, k, v))
    idx = _local_index(out)
    if len(idx[1]) != qf.shape[1] or len(idx[3]) != qf.shape[3]:
        raise AssertionError(f"B11's output is sharded over time or the head dim: "
                             f"{out.placements}")
    g = qf.shape[2] // kf.shape[2]
    bi, hi = idx[0], idx[2]
    got = out.to_local()
    whole = L._attention_b11(qf, kf, vf, "cuda")[bi][:, :, hi]
    qs, ks, vs = qf[bi][:, :, hi], kf[bi][:, :, hi // g], vf[bi][:, :, hi // g]
    b, s, h, hd = qs.shape
    fold = lambda x: x.transpose(1, 2).reshape(b * h, s, hd).contiguous()
    blk = 256 if s % 256 == 0 else s
    plain = lambda *a: fa.flash_attention_plain(*map(fold, a), True, blk, blk).view(
        b, h, s, hd).transpose(1, 2)
    want = plain(qs, ks, vs)
    top = want.abs().max()
    dt = str(qf.dtype).split(".")[1]
    rep = {"dtype": dt, "same_as_whole": bool(torch.equal(got, whole)),
           "err": float((got.float() - want).abs().max() / top)}
    if dt == "float32":
        gen = torch.Generator(device=qs.device)
        gen.manual_seed(SEED + 45)
        moved = plain(*(x * (1 + 2.0 ** -21 * torch.randn(x.shape, generator=gen,
                                                           device=x.device))
                        for x in (qs, ks, vs)))
        rep["moved"] = float((moved - want).abs().max() / top)
    else:
        rep["limit"] = ATTN_TOL[dt]
    return rep


def draw_in_turn(rank: int, world: int, decls, seed: int, dtype, shardings, dev):
    """``init_params(..., shardings=)`` one rank at a time (a leaf's whole
    float32 draw is 4.2 GB for dbrx's experts, 8.5 GB for two stacked
    layers), the rank's cache of freed blocks returned after its turn."""
    import torch
    import torch.distributed as dist

    from repro_torch.parallel.sharding import init_params

    params = None
    for r in range(world):
        if r == rank:
            g = torch.Generator(device=dev)
            g.manual_seed(seed)
            params = init_params(decls, g, dtype, shardings=shardings)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        dist.barrier()
    return params


def mesh_rank(rank: int, world: int, store: str, work: str, device: str) -> None:
    """One gloo rank of ``mesh_phase`` (a ``torch.multiprocessing.spawn``
    target) on a (2, 2) ``(data, model)`` mesh over the one card.

    (a) dbrx-132b's MoE block at full width in float32, ``multisplit_ep``,
    on 2 x 2048 tokens: at capacity factor 8 the output against the
    one-process ``multisplit`` dispatch (``work/moe_ref.pt``) and drop 0; at
    the config's 1.25 and at 1.0 (which drops) every rank's kept slots
    against an oracle of JAX's
    local-capacity rule (a stable sort of the rank's sub-ids) and its ranks
    against the ``vmap`` backend's, bitwise; K1 and K3 counted on each rank.
    (b) dbrx-132b at full width, 2 layers, bfloat16, parameters placed by
    ``decl_to_sharding`` (drawn one rank at a time), ``multisplit_ep`` at
    capacity factor 8: a prefill of 2 x 2048 tokens and 4 decode steps on
    caches placed by ``cache_shardings``; times, peak memory and the
    collectives a prefill and a decode step issue (``CommDebugMode``); the
    first B11 call's output on the rank's heads against B11 on the whole q,
    k and v and ``flash_attention_plain`` (:func:`_b11_against_plain`).
    (b32) The same model at :data:`MESH_F32_LAYERS` layer in float32: each
    rank's slice of the prefill's logits (``work/sharded32_r{r}.pt``), and
    4 decode steps' logits and the routing from rank 0
    (``work/sharded32.pt``), for the one-process comparison; B11 checked as
    in (b); a control prefill whose model rank 1 hands B11 its kv heads
    rolled by one, its parting from the good run on each rank's slice. Each
    rank writes ``work/rank{r}.json``."""
    import json as _json

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.debug import CommDebugMode

    import repro_torch.kernels as registry
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.parallel.sharding import (
        decl_to_sharding, distribute_input, gather_full, set_mesh)

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    rep = {"rank": rank}
    launched = lambda: {k: v for k, v in registry.launch_counts().items() if v}
    try:
        mesh = init_device_mesh(dev.type, MESH_SHAPE, mesh_dim_names=("data", "model"))
        coord = tuple(mesh.get_coordinate())
        rep["coordinate"] = coord
        pcfg = ParallelConfig()

        # ---- (a) the MoE block, float32, full width
        cfg = _mesh_cfg(capacity_factor=8.0, dtype="float32")
        decls = moe_mod.moe_decl(cfg)
        p = draw_in_turn(rank, world, decls, SEED + 40, torch.float32,
                         decl_to_sharding(decls, pcfg, mesh), dev)
        x = _mesh_x(dev, cfg)
        n = MESH_BATCH * MESH_SEQ
        with torch.no_grad(), set_mesh(mesh):
            xd = distribute_input(x, "dp", None, None)
            registry.reset_launches()
            y, aux = moe_mod.moe_block(p, xd, cfg)
            torch.cuda.synchronize()
            rep["moe_launches"] = launched()
            y = gather_full(y).view(n, -1)
            ref = torch.load(f"{work}/moe_ref.pt", map_location=dev)
            rep["moe_rel"] = float((y - ref["y"]).abs().max() / ref["y"].abs().max())
            rep["moe_drop"] = float(aux.drop_fraction)
            del y, ref
            # the config's capacity factor (and 1.0, which drops): the rank's
            # slots against the rule
            rep["slots_bitwise"], rep["kept_dropped"], rep["drop_c"] = [], [], []
            for factor in MESH_CAPACITY_FACTORS:
                cfg_c = _mesh_cfg(capacity_factor=factor, dtype="float32")
                xn = moe_mod.constrain(moe_mod.apply_norm(p["norm"], xd, cfg_c).reshape(n, -1),
                                       "dp", None)
                _, experts, _, _ = moe_mod._router(p, xn, cfg_c)
                experts_l = experts.to_local()
                cap = moe_mod._capacity(n, cfg_c)
                e_loc = cfg_c.moe.num_experts // MESH_SHAPE[1]
                cap_loc = max(8, ((-(-cap // MESH_SHAPE[0]) + 7) // 8) * 8)
                got = moe_mod._ep_slots(experts_l, coord[1], e_loc, cap_loc, backend="cuda",
                                        device=dev)
                plain = moe_mod._ep_slots(experts_l, coord[1], e_loc, cap_loc, backend="vmap",
                                          device=dev)
                # the oracle: JAX's rule by a stable sort of the sub-ids
                flat = experts_l.reshape(-1).long()
                lo = coord[1] * e_loc
                in_group = (flat >= lo) & (flat < lo + e_loc)
                sub = torch.where(in_group, flat - lo, e_loc)
                order = torch.sort(sub, stable=True).indices
                counts = torch.bincount(sub, minlength=e_loc + 1)
                starts = torch.cumsum(counts, 0) - counts
                ranks = torch.empty_like(sub)
                ranks[order] = torch.arange(sub.numel(), device=dev) - starts[sub[order]]
                keep = in_group & (ranks < cap_loc)
                slot = torch.where(keep, sub * cap_loc + ranks, e_loc * cap_loc)
                rep["slots_bitwise"].append(bool(
                    torch.equal(got[1], keep) and torch.equal(got[2], slot.to(got[2].dtype))
                    and torch.equal(got[0], plain[0])))
                rep["kept_dropped"].append([int(keep.sum()), int((in_group & ~keep).sum())])
                rep["drop_c"].append(float(moe_mod.moe_block(p, xd, cfg_c)[1].drop_fraction))
        del p, x, xd, xn, experts, experts_l, got, plain
        torch.cuda.empty_cache()
        dist.barrier()

        # ---- (b) dbrx-132b, 2 layers, bfloat16: times, memory, collectives,
        # and B11 on the rank's heads against its plain version
        cfg = _mesh_cfg(layers=DBRX_LAYERS, capacity_factor=8.0)
        decls = M.decl_model(cfg)
        torch.cuda.reset_peak_memory_stats()
        params = draw_in_turn(rank, world, decls, SEED, torch.bfloat16,
                              decl_to_sharding(decls, pcfg, mesh), dev)
        rep["params_gib"] = torch.cuda.memory_allocated() / 2**30
        tokens = _mesh_tokens(dev, cfg)
        b11 = []
        b11_fn, b11_rec = _recording_b11(L, b11)
        with torch.no_grad(), set_mesh(mesh):
            registry.reset_launches()
            L._b11_sharded = b11_rec
            try:
                logits, _, _ = M.forward(params, cfg, tokens=tokens)
            finally:
                L._b11_sharded = b11_fn
            torch.cuda.synchronize()
            rep["forward_launches"] = launched()
            rep["finite"] = bool(torch.isfinite(logits.to_local()).all())
            del logits
            rep["b11_calls"] = len(b11)
            rep["b11_shape"] = list(b11[0][0].to_local().shape)
            rep["b11"] = _b11_against_plain(*b11[0])
            del b11
            comm = CommDebugMode()
            with comm:
                M.forward(params, cfg, tokens=tokens)
            rep["forward_comms"] = {str(k): v for k, v in comm.get_comm_counts().items()}
            times = []
            for _ in range(3):
                dist.barrier()
                a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                a.record()
                M.forward(params, cfg, tokens=tokens)
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b))
            rep["prefill_ms"] = sorted(times)[1]
            cache = M.init_cache(params, cfg, MESH_BATCH, MESH_DECODE_STEPS)
            rep["cache_placements"] = [str(pl) for pl in cache["pattern"][0]["k"].placements]
            registry.reset_launches()
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for t in range(MESH_DECODE_STEPS):
                comm = CommDebugMode()
                with comm:
                    step_logits, cache = M.decode_step(params, cfg, cache, tokens[:, t:t + 1], t)
                rep["finite"] &= bool(torch.isfinite(step_logits.to_local()).all())
            torch.cuda.synchronize()
            rep["decode_ms"] = (time.perf_counter() - t0) * 1e3 / MESH_DECODE_STEPS
            rep["decode_launches"] = launched()
            rep["decode_comms"] = {str(k): v for k, v in comm.get_comm_counts().items()}
        rep["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del params, cache, step_logits
        torch.cuda.empty_cache()
        dist.barrier()

        # ---- (b32) dbrx-132b, 1 layer, float32: the sharded logits against
        # the one-process run's (work/sharded32.pt), and a control whose
        # model rank 1 groups its q heads with the wrong kv heads
        cfg = _mesh_cfg(layers=MESH_F32_LAYERS, capacity_factor=8.0, dtype="float32")
        decls = M.decl_model(cfg)
        torch.cuda.reset_peak_memory_stats()
        params = draw_in_turn(rank, world, decls, SEED + 44, torch.float32,
                              decl_to_sharding(decls, pcfg, mesh), dev)
        experts, b11 = [], []
        router, rec = _recording_router(moe_mod, experts)
        b11_fn, b11_rec = _recording_b11(L, b11)
        with torch.no_grad(), set_mesh(mesh):
            registry.reset_launches()
            moe_mod._router, L._b11_sharded = rec, b11_rec
            try:
                logits = M.forward(params, cfg, tokens=tokens)[0]
                cache = M.init_cache(params, cfg, MESH_BATCH, MESH_DECODE_STEPS)
                dec = []
                for t in range(MESH_DECODE_STEPS):
                    step_logits, cache = M.decode_step(params, cfg, cache, tokens[:, t:t + 1], t)
                    dec.append(gather_full(step_logits)[:, 0])
                dec = torch.stack(dec, 1)
            finally:
                moe_mod._router, L._b11_sharded = router, b11_fn
            torch.cuda.synchronize()
            rep["f32_launches"] = launched()
            rep["b11_f32"] = _b11_against_plain(*b11[0])
            local = logits.to_local()
            rep["finite"] &= bool(torch.isfinite(local).all() and torch.isfinite(dec).all())
            del b11, cache
            _, faulty = _recording_b11(L, [], fault_rank=1)
            L._b11_sharded = faulty
            try:
                control = M.forward(params, cfg, tokens=tokens)[0].to_local()
            finally:
                L._b11_sharded = b11_fn
            # the control's parting from the good run on this rank's slice;
            # each rank saves its slice of the logits, and mesh_phase
            # assembles them (no gather of the whole logits through gloo)
            rep["control_part"] = float((control - local).abs().max())
            torch.save({"index": [i.cpu() for i in _local_index(logits)], "logits": local.cpu(),
                        "shape": list(logits.shape)}, f"{work}/sharded32_r{rank}.pt")
            if rank == 0:
                torch.save({"decode": dec, "experts": experts}, f"{work}/sharded32.pt")
        rep["peak32_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del params, logits, local, dec, control
        with open(f"{work}/rank{rank}.json", "w") as f:
            _json.dump(rep, f)
    finally:
        dist.destroy_process_group()


def mesh_phase(dev, registry, log, smi):
    """The mesh layer (A13c) on the card: :data:`MESH_WORLD` gloo ranks on
    the one card (NCCL refuses two ranks on one device) as a (2, 2)
    ``(data, model)`` mesh, built with ``init_device_mesh``; the rank's work
    is :func:`mesh_rank`. The one-process references run here, before the
    spawn or after it, never beside the ranks: dbrx's MoE block in float32
    with the ``multisplit`` dispatch (before); the float32 model of (b32),
    its forward and 4 decode steps (after), routed as the ranks routed
    (:func:`_forced_router`; where its own top-4 differs, the gap must be a
    near-tie under :data:`MESH_TIE`). The sharded prefill and decode logits
    are held to ``DBRX_LOGIT_RTOL`` of their largest, with the decode argmax
    equal, and the control (q heads grouped with the wrong kv heads on one
    rank) must break that limit. The same run with every parameter moved by
    a relative :data:`MESH_PERTURB` is reported beside the gap, not used as
    its limit: a rank's float32 matmuls have other shapes and sum in another
    order, which dbrx's attention (scores to about 9000) magnifies about as
    much as a 2^-21 move of the parameters. Each rank's B11 on its heads is
    bitwise B11 on the whole q, k and v, and held to its plain version at
    ``ATTN_TOL`` in bfloat16. Returns the ranks' summed launch counts."""
    import dataclasses

    import torch
    import torch.multiprocessing as tmp

    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.parallel.sharding import init_params, tree_leaves

    work = os.path.join(ROOT, "build", "mesh_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2**30    # what this process keeps beside the ranks

    # ---- the MoE block's reference, one process, before the ranks
    cfg = _mesh_cfg(capacity_factor=8.0, dtype="float32")
    one = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch="multisplit"))
    decls = moe_mod.moe_decl(cfg)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 40)
    p = init_params(decls, g, torch.float32)
    with torch.inference_mode():
        y, aux = moe_mod.moe_block(p, _mesh_x(dev, cfg), one)
    if float(aux.drop_fraction) != 0.0:
        raise AssertionError("the one-process MoE reference dropped tokens at capacity 8")
    torch.save({"y": y.reshape(MESH_BATCH * MESH_SEQ, -1)}, os.path.join(work, "moe_ref.pt"))
    del p, y
    torch.cuda.empty_cache()

    # ---- the ranks
    store = os.path.join(work, "store")
    t0 = time.perf_counter()
    tmp.spawn(mesh_rank, args=(MESH_WORLD, store, work, str(dev)), nprocs=MESH_WORLD, join=True)
    wall = time.perf_counter() - t0
    reps = []
    for r in range(MESH_WORLD):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            reps.append(json.load(f))
    r0 = reps[0]
    counts = {}
    for rep in reps:
        for part in ("moe_launches", "forward_launches", "decode_launches", "f32_launches"):
            for k, v in rep[part].items():
                counts[k] = counts.get(k, 0) + v
        if rep["moe_launches"].get("spec_tile_histograms", 0) < 2 or not rep["moe_launches"].get(
                "spec_tile_positions"):
            raise AssertionError(f"rank {rep['rank']}: multisplit_ep launched "
                                 f"{rep['moe_launches']}, not K1 (router, ranks) and K3")
        for part in ("forward_launches", "f32_launches"):
            if not rep[part].get("flash_attention"):
                raise AssertionError(f"rank {rep['rank']}: the sharded forward launched "
                                     f"{rep[part]}, no B11")
        for part in ("b11", "b11_f32"):
            b11 = rep[part]
            if not (b11["same_as_whole"] and b11["err"] <= b11.get("limit", math.inf)):
                raise AssertionError(f"rank {rep['rank']}: B11 on the rank's heads: bitwise B11 "
                                     f"on the whole q, k, v {b11['same_as_whole']}; against "
                                     f"flash_attention_plain {b11['err']:.3e} of the largest "
                                     f"({b11['dtype']}, limit {b11.get('limit')})")
        if not (rep["moe_rel"] < MESH_MOE_RTOL and rep["moe_drop"] == 0.0):
            raise AssertionError(f"rank {rep['rank']}: multisplit_ep against the one-process "
                                 f"dispatch {rep['moe_rel']:.3e}, drop {rep['moe_drop']}")
        if not all(rep["slots_bitwise"]):
            raise AssertionError(f"rank {rep['rank']}: the kept slots at capacity factors "
                                 f"{MESH_CAPACITY_FACTORS} are not JAX's local-capacity rule, or "
                                 f"the ranks not vmap's: {rep['slots_bitwise']}")
        if not rep["finite"]:
            raise AssertionError(f"rank {rep['rank']}: logits not finite")
        for what in ("forward_comms", "decode_comms"):
            if any("all_gather" in k and "functional" in k for k in rep[what]):
                raise AssertionError(f"rank {rep['rank']}: {what} issued a functional "
                                     f"all-gather: {rep[what]}")

    # ---- (b32)'s references, one process, after the ranks
    sharded = torch.load(os.path.join(work, "sharded32.pt"), map_location=dev)
    parts = [torch.load(os.path.join(work, f"sharded32_r{r}.pt")) for r in range(MESH_WORLD)]
    sharded["logits"] = _assemble([(p["index"], p["logits"]) for p in parts],
                                  parts[0]["shape"]).to(dev)
    del parts
    cfg = _mesh_cfg(layers=MESH_F32_LAYERS, capacity_factor=8.0, dtype="float32")
    one = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch="multisplit"))
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 44)
    params = init_params(M.decl_model(cfg), g, torch.float32)
    tokens = _mesh_tokens(dev, cfg)
    runs, routing = {}, {}
    for tag in ("ref", "perturbed"):
        if tag == "perturbed":
            pg = torch.Generator(device=dev)
            pg.manual_seed(SEED + 43)
            for t in tree_leaves(params):
                t.mul_(1 + MESH_PERTURB * torch.randn(t.shape, device=dev, generator=pg))
        router, forced, routing[tag] = _forced_router(moe_mod, sharded["experts"])
        moe_mod._router = forced
        try:
            with torch.inference_mode():
                logits = M.forward(params, one, tokens=tokens)[0]
                cache = M.init_cache(params, one, MESH_BATCH, MESH_DECODE_STEPS)
                dec = torch.stack([M.decode_step(params, one, cache, tokens[:, t:t + 1], t)[0][:, 0]
                                   for t in range(MESH_DECODE_STEPS)], 1)
        finally:
            moe_mod._router = router
        runs[tag] = (logits, dec)
        del cache, logits, dec
    rel = lambda x, y: float((x - y).abs().max() / y.abs().max())
    (ref, ref_dec), (pert, pert_dec) = runs["ref"], runs["perturbed"]
    err, moved = rel(sharded["logits"], ref), rel(pert, ref)
    dec_err, dec_moved = rel(sharded["decode"], ref_dec), rel(pert_dec, ref_dec)
    # |control - ref| >= |control - sharded| - |sharded - ref|, on the ranks' slices
    control = max(rep["control_part"] for rep in reps) / float(ref.abs().max()) - err
    argmax = float((sharded["decode"].argmax(-1) == ref_dec.argmax(-1)).float().mean())
    flips = sum(c for c, _ in routing["ref"])
    flip_gap = max(gap for _, gap in routing["ref"])
    del params, runs, ref, pert, ref_dec, pert_dec, sharded
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    if not flip_gap < MESH_TIE:
        raise AssertionError(f"the one-process run's own routing differs from the ranks' at "
                             f"{flips} tokens, one with a top-k gap of {flip_gap:.3e} (near-tie "
                             f"limit {MESH_TIE})")
    if not (err < DBRX_LOGIT_RTOL and dec_err < DBRX_LOGIT_RTOL and argmax == 1.0):
        raise AssertionError(f"the sharded float32 dbrx logits part from the one-process run by "
                             f"{err:.3e}, decode {dec_err:.3e} (limit {DBRX_LOGIT_RTOL}), decode "
                             f"argmax agrees for {argmax}")
    if not control > DBRX_LOGIT_RTOL:
        raise AssertionError(f"the control (q heads grouped with the wrong kv heads on model "
                             f"rank 1) parts by at least {control:.3e}, within the limit "
                             f"{DBRX_LOGIT_RTOL}")

    log("mesh", f"{MESH_WORLD} gloo ranks on one card, a {MESH_SHAPE} (data, model) mesh, "
                f"{wall:.1f} s in all, beside the {held:.2f} GiB this process holds [{smi}]")
    log("mesh", f"(a) dbrx-132b MoE block, full width, float32, multisplit_ep on {MESH_BATCH} x "
                f"{MESH_SEQ} tokens ({MESH_SEQ} a data shard, half the experts a model rank): "
                f"capacity factor 8 against the one-process multisplit dispatch, relative "
                + ", ".join(f"{rep['moe_rel']:.3e}" for rep in reps)
                + f" by rank (limit {MESH_MOE_RTOL}), drop 0 on every rank; at capacity factors "
                f"{MESH_CAPACITY_FACTORS} (the config's, and one that drops; drop fractions "
                f"{r0['drop_c']}) every rank's kept slots bitwise JAX's local-capacity rule "
                f"(kept, dropped by rank: " + ", ".join(str(rep["kept_dropped"]) for rep in reps)
                + f") and its ranks bitwise vmap's; launches by rank "
                + ", ".join(str(rep["moe_launches"]) for rep in reps))
    log("mesh", f"(b) dbrx-132b {DBRX_LAYERS} layers bfloat16, multisplit_ep at capacity factor "
                f"8: parameters {r0['params_gib']:.2f} GiB a rank (decl_to_sharding); prefill "
                f"{MESH_BATCH} x {MESH_SEQ}: " + ", ".join(f"{rep['prefill_ms']:.2f}"
                                                          for rep in reps)
                + f" ms by rank [CUDA events, median of 3; {smi}]; {MESH_DECODE_STEPS} decode "
                f"steps on caches placed {r0['cache_placements']}: "
                + ", ".join(f"{rep['decode_ms']:.2f}" for rep in reps)
                + " host ms a step by rank; peak " + ", ".join(f"{rep['peak_gib']:.2f}"
                                                              for rep in reps)
                + f" GiB a rank; B11 on a rank's heads {r0['b11_shape']} ({r0['b11_calls']} calls "
                f"a forward), the first bitwise B11 on the whole q, k, v in one call on every "
                f"rank, and against flash_attention_plain "
                + ", ".join(f"{rep['b11']['err']:.3e}" for rep in reps)
                + f" of the largest by rank (limit ATTN_TOL {ATTN_TOL['bfloat16']})")
    log("mesh", f"(b32) dbrx-132b {MESH_F32_LAYERS} layer float32, peak "
                + ", ".join(f"{rep['peak32_gib']:.2f}" for rep in reps)
                + f" GiB a rank; B11 on a rank's heads bitwise B11 on the whole, and against "
                f"its plain version " + ", ".join(f"{rep['b11_f32']['err']:.3e}" for rep in reps)
                + " (no limit: a relative 2^-21 move of q, k and v moves the plain version by "
                + ", ".join(f"{rep['b11_f32']['moved']:.3e}" for rep in reps)
                + f", ATTN_TOL is {ATTN_TOL['float32']}); against the one-process multisplit run "
                f"routed as the ranks routed (its own top-4 differs at {flips} tokens, largest "
                f"gap {flip_gap:.3e}, near-tie limit {MESH_TIE}): logits {err:.3e} of their "
                f"largest, decode {dec_err:.3e} (limit DBRX_LOGIT_RTOL {DBRX_LOGIT_RTOL}; the "
                f"same run with every parameter moved by a relative 2^-21 moves them {moved:.3e} "
                f"and {dec_moved:.3e}), decode argmax agrees for {argmax:.4f}; the control "
                f"(model rank 1's q heads on the wrong kv heads) parts by at least {control:.3e}, "
                f"over the limit")
    log("mesh", f"(b) collectives of a prefill (CommDebugMode, rank 0): {r0['forward_comms']}; "
                f"of a decode step: {r0['decode_comms']}; launches a rank: forward "
                f"{r0['forward_launches']}, {MESH_DECODE_STEPS} decode steps "
                f"{r0['decode_launches']}")
    return counts


TM_WORLD = 4                   # gloo ranks on the one card for (a) and (d)
TM_LAYERS, TM_BATCH, TM_SEQ, TM_STEPS = 2, 4, 2048, 2   # (a): tinyllama at full width
TM_LR = 1e-4
TM_PERTURB = 2.0 ** -21
# (a)'s limit: each figure of the sharded run against the one-process run's
# may part by TM_MULT times what a relative 2^-21 perturbation of every
# parameter moves the one-process run's own figure (a fixed multiple of
# that movement)
TM_MULT = 4.0
TM_LAUNCH_ARGV = ["--arch", "tinyllama-1.1b", "--steps", "4", "--batch", "4", "--seq", "2048",
                  "--ckpt-every", "2"]
TM_ONE_PROCESS = "train tinyllama-1.1b ms/step, the last run before the mesh layer"
TM_RESUME_STEPS = 3             # (b)'s resume from step 2 replays step 2 alone
TM_DBRX_STEPS, TM_DBRX_SEQ = 3, 2048   # (c): dbrx-132b at full width, 1 layer, (1, 2) mesh
TM_MOE_GRAD_RTOL = 1e-4        # (c) the MoE block's gradients against one process (JAX's)
TM_PSUM_N = 1 << 20            # (d) compressed_psum's gradient, a rank


def _tm_cfg(arch: str, **kw):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    moe = cfg.moe
    if moe.num_experts:
        moe = dataclasses.replace(moe, dispatch="multisplit_ep")
    return dataclasses.replace(cfg, moe=moe, **kw)


def _tm_batches(dev, cfg, n, batch, seq, seed):
    """``n`` batches of (batch, seq) tokens and their labels from ``seed``."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    t = torch.randint(0, cfg.vocab, (n, batch, seq + 1), device=dev, generator=g,
                      dtype=torch.int32)
    return [{"tokens": x[:, :-1].contiguous(), "labels": x[:, 1:].contiguous()} for x in t]


def _tm_one_process(dev, perturb=False):
    """(a)'s reference: the one-process ``make_train_step`` on the card,
    :data:`TM_STEPS` steps; (metrics a step, the state's leaves)."""
    import torch

    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import steps as S
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.sharding import init_params, tree_leaves

    cfg = _tm_cfg("tinyllama-1.1b", n_layers=TM_LAYERS, dtype="float32")
    tc = TrainConfig(lr=TM_LR, warmup_steps=1, total_steps=100)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 60)
    params = init_params(M.decl_model(cfg), g)
    if perturb:
        pg = torch.Generator(device=dev)
        pg.manual_seed(SEED + 61)
        for t in tree_leaves(params):
            t.mul_(1 + TM_PERTURB * torch.randn(t.shape, device=dev, generator=pg))
    state = S.TrainState(params, adamw_init(params, tc))
    step = S.make_train_step(cfg, tc)
    metrics = []
    for b in _tm_batches(dev, cfg, TM_STEPS, TM_BATCH, TM_SEQ, SEED + 62):
        state, m = step(state, b)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return metrics, tree_leaves(state)


def train_mesh_rank(rank: int, world: int, store: str, work: str, device: str) -> None:
    """One gloo rank of :func:`train_mesh_phase` (a ``spawn`` target).

    On all four ranks: (d) ``compressed_psum`` over the ``pod`` and ``data``
    groups of a (2, 2) ``(pod, data)`` mesh on CUDA tensors and on CPU
    tensors; (a) tinyllama-1.1b at full width and :data:`TM_LAYERS` layers
    in float32 on a (2, 2) ``(data, model)`` mesh: :data:`TM_STEPS` steps
    of ``make_train_step`` with ``fsdp`` off, on, and a control on which
    rank 0 keeps its own gradients over ``data`` (its all-reduce runs, its
    result is dropped); each run's metrics, and the largest difference of
    each leaf of its state from the one-process run's (``work/ref.pt``) on
    the rank's slice; the collectives of a step. Then ranks 2 and 3 leave,
    and ranks 0 and 1 start a world of two: (c) dbrx-132b at full width, 1
    layer, bfloat16 with its float32 master, ``multisplit_ep`` on a (1, 2)
    mesh: :data:`TM_DBRX_STEPS` steps of 1 x :data:`TM_DBRX_SEQ`, times,
    peak memory, launches, every route's ranks and counts against ``vmap``'s;
    then dbrx's MoE block alone in float32, its gradients against the
    one-process ``multisplit`` dispatch's (``work/moe_grads.pt``); (b)
    ``launch.train.main`` at tinyllama-1.1b's full config on a (2,) data
    mesh, 4 steps with checkpoints every 2, then a resume from the step-2
    checkpoint replaying step 2, its gradient reductions timed apart. Each
    rank writes
    ``work/rank{r}.json``."""
    import contextlib
    import io
    import json as _json

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.debug import CommDebugMode

    import repro_torch.kernels as registry
    from repro_torch.configs.base import ParallelConfig, TrainConfig
    from repro_torch.launch import steps as S
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.models import moe as moe_mod
    from repro_torch.optim import adamw_init
    from repro_torch.optim.compress import compressed_psum
    from repro_torch.parallel import sharding as sh

    dev = torch.device(device)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    rep = {"rank": rank, "seconds": {}}
    t_part = [time.perf_counter()]

    def stamp(part):
        now = time.perf_counter()
        rep["seconds"][part] = now - t_part[0]
        t_part[0] = now

    launched = lambda: {k: v for k, v in registry.launch_counts().items() if v}
    comms = lambda mode: {str(k): v for k, v in mode.get_comm_counts().items()}
    try:
        # ---- (d) compressed_psum over the mesh's pod and data groups
        pod = init_device_mesh("cuda", (2, 2), mesh_dim_names=("pod", "data"))
        g = torch.Generator().manual_seed(SEED + 70 + rank)
        grad = torch.randn(TM_PSUM_N, generator=g) * 3.0
        err = torch.randn(TM_PSUM_N, generator=g) * 1e-2
        groups = dict(fast_group=pod.get_group("data"), slow_group=pod.get_group("pod"))
        on_card = compressed_psum(grad.to(dev), err.to(dev), **groups)
        on_host = compressed_psum(grad, err, **groups)
        rep["psum"] = [bits_equal(a.cpu(), b) for a, b in zip(on_card, on_host)]
        rep["psum_err"] = [float((a.cpu() - b).abs().max() / b.abs().max())
                           for a, b in zip(on_card, on_host)]
        del on_card, on_host
        stamp("d")

        # ---- (a) tinyllama, float32, (2, 2) (data, model)
        mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
        coord = tuple(mesh.get_coordinate())
        cfg = _tm_cfg("tinyllama-1.1b", n_layers=TM_LAYERS, dtype="float32")
        decls = M.decl_model(cfg)
        tc = TrainConfig(lr=TM_LR, warmup_steps=1, total_steps=100)
        ref = torch.load(f"{work}/ref.pt", mmap=True)
        batches = _tm_batches(dev, cfg, TM_STEPS, TM_BATCH, TM_SEQ, SEED + 62)
        layout = S.grad_layout
        for run in ("plain", "fsdp", "control"):
            shard = S.state_shardings(decls, ParallelConfig(fsdp=run == "fsdp"), mesh, tc)
            gen = torch.Generator(device=dev)
            gen.manual_seed(SEED + 60)
            params = sh.init_params(decls, gen, shardings=shard.params)
            state = sh.place(S.TrainState(params, adamw_init(params, tc)), shard)
            step = S.make_train_step(cfg, tc)

            def keeps_own(grad, placements):
                """Rank 0 of the control: the all-reduce over data runs (its
                peer waits in it), its own partial gradient is kept."""
                out = layout(grad, placements)
                if isinstance(grad, DTensor) and grad.placements[0].is_partial():
                    return DTensor.from_local(grad.to_local(), mesh, out.placements,
                                              run_check=False)
                return out

            if run == "control" and rank == 0:
                S.grad_layout = keeps_own
            metrics = []
            registry.reset_launches()
            try:
                with sh.set_mesh(mesh):
                    for t, b in enumerate(batches):
                        mode = CommDebugMode()
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        with mode:
                            placed = sh.place(b, S.batch_sharding(cfg, mesh, b))
                            state, m = step(state, placed)
                        torch.cuda.synchronize()
                        metrics.append((float(m["loss"]), float(m["grad_norm"]),
                                        (time.perf_counter() - t0) * 1e3))
            finally:
                S.grad_layout = layout
            leaf_err = []
            for x, want in zip(sh.tree_leaves(state), ref):
                local, _ = sh.local_shard(x)
                cut = (sh.shard_slices(x.shape, mesh, x.placements, coord)
                       if isinstance(x, DTensor) else ())
                leaf_err.append(float((local.float() - want[cut].to(dev).float()).abs().max()))
            rep[run] = {"metrics": metrics, "leaf_err": leaf_err, "comms": comms(mode),
                        "launches": launched()}
            del state, params, m
            torch.cuda.empty_cache()
        del ref
        dist.barrier()
        stamp("a")
        dist.destroy_process_group()
        if rank >= 2:
            return

        # ---- a world of two: (c) dbrx on (1, 2), then (b) the launcher on (2,)
        dist.init_process_group("gloo", init_method=f"file://{store}_two", rank=rank,
                                world_size=2)
        mesh = init_device_mesh("cuda", (1, 2), mesh_dim_names=("data", "model"))
        cfg = _tm_cfg("dbrx-132b", n_layers=1)
        decls = M.decl_model(cfg)
        tc = TrainConfig(global_batch=1, seq_len=TM_DBRX_SEQ, lr=3e-4, warmup_steps=1,
                         total_steps=TM_DBRX_STEPS, params_dtype="bfloat16",
                         moments_dtype="bfloat16")
        shard = S.state_shardings(decls, ParallelConfig(), mesh, tc)
        torch.cuda.reset_peak_memory_stats()
        params = draw_in_turn(rank, 2, decls, SEED, torch.bfloat16, shard.params, dev)
        state = sh.place(S.TrainState(params, adamw_init(params, tc)), shard)
        rep["dbrx_state_gib"] = torch.cuda.memory_allocated() / 2**30
        routed, loads = [], []
        ranks_fn, loads_fn = moe_mod._ranks_multisplit, moe_mod.expert_load_stats

        def rec_ranks(ids, e, *a, **kw):
            r = ranks_fn(ids, e, *a, **kw)
            routed.append((ids.clone(), e, r[0].clone(), r[1].clone()))
            return r

        def rec_loads(ids, e, *a, **kw):
            r = loads_fn(ids, e, *a, **kw)
            loads.append((ids.clone(), e, r[0].clone()))
            return r

        steps_log = []
        step = _step_recorder(registry, S.make_train_step, steps_log)(cfg, tc)
        moe_mod._ranks_multisplit, moe_mod.expert_load_stats = rec_ranks, rec_loads
        registry.reset_launches()
        try:
            with sh.set_mesh(mesh):
                for b in _tm_batches(dev, cfg, TM_DBRX_STEPS, 1, TM_DBRX_SEQ, SEED + 63):
                    state, m = step(state, sh.place(b, S.batch_sharding(cfg, mesh, b)))
        finally:
            moe_mod._ranks_multisplit, moe_mod.expert_load_stats = ranks_fn, loads_fn
        rep["dbrx_launches"] = launched()
        rep["dbrx_steps"] = [(loss, ms, launches) for loss, ms, launches, _ in steps_log]
        rep["dbrx_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        rep["dbrx_routes"] = [len(routed), len(loads)]
        rep["dbrx_bitwise"] = all(
            bits_equal(r, p[0]) and bits_equal(c, p[1])
            for ids, e, r, c in routed
            for p in [ranks_fn(ids, e, backend="vmap", device=dev)]) and all(
            bits_equal(c, loads_fn(ids, e, backend="vmap", device=dev)[0])
            for ids, e, c in loads)
        del state, params, m, routed, loads
        torch.cuda.empty_cache()
        stamp("c")

        # dbrx's MoE block alone, float32: gradients against one process's
        cfg32 = _tm_cfg("dbrx-132b", n_layers=1, dtype="float32")
        mdecls = moe_mod.moe_decl(cfg32)
        p = draw_in_turn(rank, 2, mdecls, SEED + 64, torch.float32,
                         sh.decl_to_sharding(mdecls, ParallelConfig(), mesh), dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 65)
        x = torch.randn((1, TM_DBRX_SEQ, cfg32.d_model), generator=gen, device=dev)
        for leaf in sh.tree_leaves(p):
            leaf.requires_grad_()
        x.requires_grad_()
        registry.reset_launches()
        with sh.set_mesh(mesh):
            y, _ = moe_mod.moe_block(p, sh.distribute_input(x, "dp", None, None), cfg32)
            whole = sh.replicate(y)
            (whole * whole).sum().to_local().backward()
        rep["moe_launches"] = launched()
        want = torch.load(f"{work}/moe_grads.pt", mmap=True)
        errs = []
        for leaf, w in zip(sh.tree_leaves(p) + [x], want):
            gl = leaf.grad
            local = gl.to_local() if isinstance(gl, DTensor) else gl
            cut = (sh.shard_slices(gl.shape, mesh, gl.placements, tuple(mesh.get_coordinate()))
                   if isinstance(gl, DTensor) else ())
            errs.append(float((local - w[cut].to(dev)).abs().max() / w.abs().max()))
        rep["moe_grad_err"] = errs
        del p, x, y, whole, want
        torch.cuda.empty_cache()
        stamp("c, MoE block")

        # ---- (b) the launcher at tinyllama-1.1b's full config on two ranks:
        # TM_LAUNCH_ARGV's steps as they run; then a resume from the step-2
        # checkpoint that replays TM_RESUME_STEPS - 2 steps, in which the host
        # time inside grads_of's gradient reductions (grad_layout: gloo's
        # all-reduces through the host) is kept apart, each call between two
        # synchronisations (which the timed steps do not pay)
        ckpt = os.path.join(work, "launch")
        steps_log, reduce_ms = [], []
        make = S.make_train_step
        S.make_train_step = _step_recorder(registry, make, steps_log)

        def timed_layout(grad, placements):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = layout(grad, placements)
            torch.cuda.synchronize()
            reduce_ms.append((len(steps_log), (time.perf_counter() - t0) * 1e3))
            return out

        torch.cuda.reset_peak_memory_stats()
        out = io.StringIO()
        registry.reset_launches()
        try:
            with contextlib.redirect_stdout(out):
                t0 = time.perf_counter()
                sup = train.main(TM_LAUNCH_ARGV + ["--ckpt-dir", ckpt, "--seed", str(SEED)])
                first_s = time.perf_counter() - t0
                first_latest = sup.ckpt.latest_step()
                rep["launch_files"] = sorted(os.listdir(os.path.join(ckpt, "step_00000002")))
                dist.barrier()
                if rank == 0:          # the resume starts from the step-2 checkpoint
                    shutil.rmtree(os.path.join(ckpt, "step_00000004"))
                dist.barrier()
                S.grad_layout = timed_layout
                again = train.main(TM_LAUNCH_ARGV + ["--ckpt-dir", ckpt, "--seed", str(SEED),
                                                     "--steps", str(TM_RESUME_STEPS)])
        finally:
            S.make_train_step, S.grad_layout = make, layout
        n_first = int(TM_LAUNCH_ARGV[TM_LAUNCH_ARGV.index("--steps") + 1])
        rep["launch_reduce_ms"] = [sum(ms for i, ms in reduce_ms if i == k)
                                   for k in range(n_first, len(steps_log))]
        rep["launch_launches"] = launched()
        rep["launch_text"] = out.getvalue()
        rep["launch_steps"] = [(loss, ms, launches) for loss, ms, launches, _ in steps_log]
        rep["launch_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        rep["launch_s"] = first_s
        rep["launch_latest"] = [first_latest, again.ckpt.latest_step()]
        del sup, again
        torch.cuda.empty_cache()
        stamp("b")
        dist.barrier()
        dist.destroy_process_group()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        with open(f"{work}/rank{rank}.json", "w") as f:
            _json.dump(rep, f)


def train_mesh_phase(dev, registry, log, smi):
    """The sharded training step (A13d) on the card, after the mesh phase:
    :data:`TM_WORLD` gloo ranks on the one card (:func:`train_mesh_rank`).
    The one-process references run here before the spawn: (a)'s
    ``make_train_step`` (and the same with every parameter moved by a
    relative :data:`TM_PERTURB`, whose movement sets each limit:
    :data:`TM_MULT` times it), and (c)'s MoE block with the ``multisplit``
    dispatch and its gradients. Checks: (a) every metric and leaf within its
    limit with ``fsdp`` off and on, the control over it; no functional
    all-gather in a step; (b) the launcher's first line its (2,) mesh, the
    resume replaying step 2 to the first run's loss
    (:data:`SUP_REPLAY_RTOL`), both runs ending at step 4; (c) K1, K3 and
    B11 launched on each rank, every route's ranks and counts bitwise
    ``vmap``'s, the block's gradients within :data:`TM_MOE_GRAD_RTOL`;
    (d) ``compressed_psum`` on CUDA tensors bitwise its CPU answer. Returns
    the summed launch counts of the ranks' main-path drives ((a)'s plain
    and fsdp runs, (c)'s steps, (b)'s launcher)."""
    import torch
    import torch.multiprocessing as tmp

    from repro_torch.configs.base import ParallelConfig
    from repro_torch.models import moe as moe_mod
    from repro_torch.parallel.sharding import init_params, tree_leaves

    work = os.path.join(ROOT, "build", "train_mesh_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()

    # ---- (a)'s references
    ref_metrics, ref = _tm_one_process(dev)
    torch.save([t.detach().cpu() for t in ref], os.path.join(work, "ref.pt"))
    pert_metrics, pert = _tm_one_process(dev, perturb=True)
    tops = [float(t.float().abs().max()) for t in ref]
    moved = [float((a.float() - b.float()).abs().max()) for a, b in zip(pert, ref)]
    del pert, ref
    torch.cuda.empty_cache()

    # ---- (c)'s MoE block reference: one process, the multisplit dispatch
    import dataclasses
    cfg32 = _tm_cfg("dbrx-132b", n_layers=1, dtype="float32")
    one = dataclasses.replace(cfg32, moe=dataclasses.replace(cfg32.moe, dispatch="multisplit"))
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 64)
    p = init_params(moe_mod.moe_decl(cfg32), g, torch.float32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 65)
    x = torch.randn((1, TM_DBRX_SEQ, cfg32.d_model), generator=gen, device=dev)
    leaves = tree_leaves(p) + [x]
    for leaf in leaves:
        leaf.requires_grad_()
    y, _ = moe_mod.moe_block(p, x, one)
    grads = torch.autograd.grad((y * y).sum(), leaves)
    torch.save([gr.cpu() for gr in grads], os.path.join(work, "moe_grads.pt"))
    del p, x, y, grads, leaves
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t_phase

    store = os.path.join(work, "store")
    t0 = time.perf_counter()
    tmp.spawn(train_mesh_rank, args=(TM_WORLD, store, work, str(dev)), nprocs=TM_WORLD,
              join=True)
    wall = time.perf_counter() - t0
    reps = []
    for r in range(TM_WORLD):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            reps.append(json.load(f))
    shutil.rmtree(work, ignore_errors=True)

    counts = {}
    for rep in reps:
        for part in ([rep["plain"]["launches"], rep["fsdp"]["launches"]]
                     + ([rep["dbrx_launches"], rep["launch_launches"]] if rep["rank"] < 2
                        else [])):
            for k, v in part.items():
                counts[k] = counts.get(k, 0) + v

    failed = []
    # (d)
    for rep in reps:
        if not all(rep["psum"]):
            failed.append(f"rank {rep['rank']}: compressed_psum on CUDA tensors parts "
                          f"from its CPU answer by {rep['psum_err']}")
    # (a): each figure against TM_MULT x the perturbation's movement
    metric_moved = [max(abs(a - b) / abs(b) for a, b in zip(pm, rm))
                    for pm, rm in zip(zip(*pert_metrics), zip(*ref_metrics))]
    report = {}
    for run in ("plain", "fsdp", "control"):
        metric_err = [max(abs(m[i] - r[i]) / abs(r[i]) for rep in reps
                          for m, r in zip(rep[run]["metrics"], ref_metrics)) for i in (0, 1)]
        leaf_err = [max(rep[run]["leaf_err"][i] for rep in reps) / max(tops[i], 1e-30)
                    for i in range(len(tops))]
        leaf_lim = [TM_MULT * mv / max(top, 1e-30) for mv, top in zip(moved, tops)]
        over = [i for i, (e, lim) in enumerate(zip(leaf_err, leaf_lim)) if e > lim]
        over_m = [i for i in (0, 1) if metric_err[i] > TM_MULT * metric_moved[i]]
        report[run] = (metric_err, max(leaf_err), over, over_m,
                       max(e / lim if lim else (math.inf if e else 0.0)
                           for e, lim in zip(leaf_err, leaf_lim)))
        if run != "control" and (over or over_m):
            failed.append(f"(a) {run}: the sharded step parts from the one-process step "
                          f"beyond {TM_MULT} x the 2^-21 movement: leaves {over}, "
                          f"metrics {over_m} (loss, grad_norm errors {metric_err} against "
                          f"movements {metric_moved})")
        if run == "control" and not (over or over_m):
            failed.append("(a) the control (rank 0 keeps its own gradients over data) "
                          "stays within the limit")
        for rep in reps:
            if any("functional" in k and "gather" in k for k in rep[run]["comms"]):
                failed.append(f"(a) {run}: rank {rep['rank']} issued a functional "
                              f"all-gather: {rep[run]['comms']}")
    # (c)
    for rep in reps[:2]:
        steps = rep["dbrx_steps"]
        for name in ("flash_attention", "spec_tile_histograms", "spec_tile_positions"):
            if not all(launches.get(name) for _, _, launches in steps):
                failed.append(f"(c) rank {rep['rank']}: a dbrx step launched no {name}: "
                              f"{[s[2] for s in steps]}")
        if not rep["dbrx_bitwise"] or not all(rep["dbrx_routes"]):
            failed.append(f"(c) rank {rep['rank']}: the routes' ranks or counts are not "
                          f"vmap's ({rep['dbrx_routes']} recorded)")
        if not all(math.isfinite(loss) for loss, *_ in steps):
            failed.append(f"(c) dbrx losses {[s[0] for s in steps]}")
        if not max(rep["moe_grad_err"]) <= TM_MOE_GRAD_RTOL:
            failed.append(f"(c) rank {rep['rank']}: the MoE block's gradients part from "
                          f"one process's by {rep['moe_grad_err']}")
    # (b)
    r0 = reps[0]
    lines = r0["launch_text"].strip().splitlines()
    if not lines or "mesh {'data': 2} over 2 rank(s), gloo on cuda" not in lines[0]:
        failed.append(f"(b) the launcher's first line: {lines[:1]}")
    if reps[1]["launch_text"].strip():
        failed.append(f"(b) rank 1 printed {reps[1]['launch_text'][:200]!r}")
    replay = []
    for rep in reps[:2]:
        ls = [loss for loss, *_ in rep["launch_steps"]]
        n_first = int(TM_LAUNCH_ARGV[TM_LAUNCH_ARGV.index("--steps") + 1])
        if len(ls) != n_first + TM_RESUME_STEPS - 2 or rep["launch_latest"] != [
                n_first, TM_RESUME_STEPS]:
            failed.append(f"(b) rank {rep['rank']}: {len(ls)} steps, latest "
                          f"{rep['launch_latest']}")
        replay.append([(a, b, abs(a - b) / abs(b))
                       for a, b in zip(ls[n_first:], ls[2:TM_RESUME_STEPS])])
        if not replay[-1] or any(r > SUP_REPLAY_RTOL for *_, r in replay[-1]):
            failed.append(f"(b) rank {rep['rank']}: the resume's losses {ls[n_first:]} "
                          f"against the first run's {ls[2:TM_RESUME_STEPS]}")
    # the first run's steps after its first, none of them paying the timing
    # synchronisations of the resume's
    ms = statistics.median(s for rep in reps[:2] for _, s, _ in rep["launch_steps"][1:n_first])
    ms_timed = [round(s, 1) for rep in reps[:2] for _, s, _ in rep["launch_steps"][n_first:]]

    log("train-mesh", f"{TM_WORLD} gloo ranks on one card, {wall:.1f} s (the one-process "
                      f"references before: {ref_s:.1f} s; rank 0's parts in s: "
                      f"{ {k: round(v, 1) for k, v in r0['seconds'].items()} }) [{smi}]")
    log("train-mesh", f"(a) tinyllama-1.1b full width, {TM_LAYERS} layers, float32, (2, 2) "
                      f"(data, model), {TM_STEPS} steps of {TM_BATCH} x {TM_SEQ}: one process "
                      f"(loss, grad_norm) {[(round(a, 6), round(b, 4)) for a, b in ref_metrics]}; "
                      f"the 2^-21 perturbation moves them {metric_moved} and the leaves by up "
                      f"to {max(mv / max(t, 1e-30) for mv, t in zip(moved, tops)):.3e} of their "
                      f"largest; limit {TM_MULT} x that movement, a figure each: "
                      + "; ".join(f"{run}: loss, grad_norm errors "
                                  f"{[f'{e:.3e}' for e in report[run][0]]}, worst leaf "
                                  f"{report[run][1]:.3e} ({report[run][4]:.3f} of its limit), "
                                  f"over the limit: leaves {report[run][2][:8]}, metrics "
                                  f"{report[run][3]}" for run in report)
                      + f"; ms a step by rank (host clock, plain / fsdp): "
                      + ", ".join(f"{rep['plain']['metrics'][-1][2]:.1f} / "
                                  f"{rep['fsdp']['metrics'][-1][2]:.1f}" for rep in reps))
    log("train-mesh", f"(a) collectives of a step (CommDebugMode, rank 0): plain "
                      f"{r0['plain']['comms']}; fsdp {r0['fsdp']['comms']}")
    log("train-mesh", f"(b) launch.train --arch tinyllama-1.1b (full config) on 2 ranks, "
                      f"{lines[0].split('] ', 1)[-1]}: {ms:.2f} ms/step (median of the first "
                      f"run's steps 2-{n_first} on both ranks; steps by rank, the last the "
                      f"resume's "
                      + "; ".join(str([round(s, 1) for _, s, _ in rep["launch_steps"]])
                                  for rep in reps[:2])
                      + f") beside one process's {MESH_MS_BEFORE[TM_ONE_PROCESS][0]} ms/step "
                      f"({TM_ONE_PROCESS}), "
                      f"{TM_BATCH * TM_SEQ / ms * 1e3:.0f} tokens/s; peak "
                      + ", ".join(f"{rep['launch_peak_gib']:.2f}" for rep in reps[:2])
                      + f" GiB a rank; the resume's step, timed apart: the gradients' "
                      f"reduction over data (gloo, through the host; host ms between "
                      f"synchronisations, rank 0) {[round(x, 1) for x in r0['launch_reduce_ms']]}"
                      f" of {ms_timed} ms (both ranks, the synchronisations included); first run "
                      f"{r0['launch_s']:.1f} s with its checkpoints "
                      f"(step 2 holds {r0['launch_files']}); the resume from step 2 replays "
                      f"(loss, first run's, relative) "
                      f"{[(round(a, 6), round(b, 6), f'{r:.1e}') for a, b, r in replay[0]]}; "
                      f"launches a step {r0['launch_steps'][0][2]} [{smi}]")
    log("train-mesh", f"(c) dbrx-132b full width, 1 of 40 layers, bfloat16 with a float32 "
                      f"master, multisplit_ep on (1, 2), {TM_DBRX_STEPS} steps of 1 x "
                      f"{TM_DBRX_SEQ}: ms/step by rank "
                      + "; ".join(str([round(s, 1) for _, s, _ in rep["dbrx_steps"]])
                                  for rep in reps[:2])
                      + "; state " + ", ".join(f"{rep['dbrx_state_gib']:.2f}" for rep in reps[:2])
                      + " GiB and peak " + ", ".join(f"{rep['dbrx_peak_gib']:.2f}"
                                                    for rep in reps[:2])
                      + " GiB a rank; launches a step by rank "
                      + "; ".join(str(rep["dbrx_steps"][0][2]) for rep in reps[:2])
                      + f"; {reps[0]['dbrx_routes']} routes (K3 ranks, K1 loads) a rank bitwise "
                      f"vmap's; losses {[round(s[0], 4) for s in r0['dbrx_steps']]}; the MoE block "
                      f"alone in float32, gradients against one process (norm, router, w_down, "
                      f"w_gate, w_up, x) "
                      + "; ".join(str([f"{e:.2e}" for e in rep["moe_grad_err"]])
                                  for rep in reps[:2])
                      + f" (limit {TM_MOE_GRAD_RTOL}) [{smi}]")
    log("train-mesh", f"(d) compressed_psum over the pod and data groups of a (2, 2) mesh on "
                      f"{TM_PSUM_N} float32 a rank, CUDA tensors against the CPU answer, (reduced, "
                      f"residual) bitwise by rank {[rep['psum'] for rep in reps]}, relative "
                      f"{[rep['psum_err'] for rep in reps]}")
    log("train-mesh", f"phase {time.perf_counter() - t_phase:.1f} s")
    if failed:
        raise AssertionError("; ".join(failed))
    return counts


# (b) of the dry-run phase: tinyllama-1.1b at full width, depth cut to 2,
# a train step of 4 x 2048 tokens; the step's time is the median of
# DRYRUN_REPS steps after a warm one
DRYRUN_LAYERS, DRYRUN_BATCH, DRYRUN_SEQ, DRYRUN_REPS = 2, 4, 2048, 3
DRYRUN_CELL = ("tinyllama-1.1b", "decode_32k", "single")


def dryrun_phase(dev, registry, log, smi):
    """The dry-run and its accounting (A17) on the card, after the sharded
    training step (no process group may be running in this process).

    (a) ``launch.dryrun.lower_cell`` of :data:`DRYRUN_CELL` on fake CUDA
    tensors over a fake world of 256 ranks, and the same cell on fake CPU
    tensors: their flops, bytes and collectives equal; B11's, K1's and K3's
    launch counts unchanged. (b) tinyllama at full width, depth cut to
    :data:`DRYRUN_LAYERS`: ``make_train_step`` on a (1,) mesh of one gloo
    rank on the card, :data:`DRYRUN_BATCH` x :data:`DRYRUN_SEQ` tokens, once
    under ``launch.hlo_analysis.CountingMode`` and timed without it (the
    median of :data:`DRYRUN_REPS` synchronised steps after a warm one),
    against ``launch.dryrun.trace_step`` of the same step on fake CUDA
    tensors: flops and argument bytes equal; the dry-run's peak printed
    beside ``torch.cuda.max_memory_allocated`` of the counted step; the
    roofline's ``max(compute_s, memory_s)`` from the dry-run's counts no
    more than the measured step. Returns the launch counts of (b)'s steps
    on the card."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch import steps as S
    from repro_torch.launch.hlo_analysis import CountingMode, roofline_terms
    from repro_torch.launch.mesh import launch_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.sharding import init_params, set_mesh

    if dist.is_initialized():
        raise AssertionError("the dry-run phase starts its own process groups; one is running")
    t_phase = time.perf_counter()
    doors = ("flash_attention", "spec_tile_histograms", "spec_tile_positions")

    # ---- (a) one production cell on fake CUDA tensors and on fake CPU ones
    before = registry.launch_counts()
    recs = {d: dryrun.lower_cell(*DRYRUN_CELL, device=d) for d in (dev.type, "cpu")}
    moved = {k: registry.launch_counts()[k] - before[k] for k in doors}
    # the peaks differ: an allocation on the card is rounded to its block
    keys = ("per_device", "collectives_full_graph")
    gpu, cpu = recs[dev.type], recs["cpu"]
    log("dryrun", f"(a) {' '.join(DRYRUN_CELL)} on fake {dev.type} tensors over "
                  f"{gpu['n_chips']} fake ranks: {gpu['per_device']['flops']:.6g} flops, "
                  f"{gpu['per_device']['bytes']:.6g} bytes, collectives "
                  f"{gpu['collectives_full_graph']} a device; traced in {gpu['trace_s']} s "
                  f"({cpu['trace_s']} s on fake cpu tensors); roofline (H100 data sheet, an "
                  f"estimate) {gpu['roofline']}, dominant {gpu['dominant']}; doors' launches "
                  f"{moved}")
    if any(gpu[k] != cpu[k] for k in keys) or gpu["status"] != "ok":
        raise AssertionError(f"the dry-run on fake {dev.type} tensors parts from fake cpu: "
                             + "; ".join(f"{k}: {gpu[k]} vs {cpu[k]}" for k in keys
                                         if gpu[k] != cpu[k]))
    if any(moved.values()):
        raise AssertionError(f"a door launched its kernel in a dry-run: {moved}")

    # ---- (b) a train step on the card against its dry-run
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), n_layers=DRYRUN_LAYERS)
    tc = TrainConfig(global_batch=DRYRUN_BATCH, seq_len=DRYRUN_SEQ)
    torch.cuda.empty_cache()
    mesh, started, _ = launch_mesh(dev)
    counts = {}
    try:
        before = registry.launch_counts()
        fake = dryrun.trace_step(cfg, "train", DRYRUN_BATCH, DRYRUN_SEQ, mesh, tc,
                                 device=dev.type)
        moved = {k: registry.launch_counts()[k] - before[k] for k in doors}
        if any(moved.values()):
            raise AssertionError(f"a door launched its kernel in the dry-run of (b): {moved}")
        g = torch.Generator(device=dev)
        g.manual_seed(SEED)
        params = init_params(M.decl_model(cfg), g)
        state = S.TrainState(params, adamw_init(params, tc))
        tokens = torch.randint(0, cfg.vocab, (DRYRUN_BATCH, DRYRUN_SEQ + 1), device=dev,
                               generator=g, dtype=torch.int32)
        batch = {"tokens": tokens[:, :-1].contiguous(), "labels": tokens[:, 1:].contiguous()}
        arg_bytes = dryrun.local_bytes((state, batch))
        step = S.make_train_step(cfg, tc)
        before = registry.launch_counts()
        times = []
        with set_mesh(mesh):
            for i in range(DRYRUN_REPS + 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.reset_peak_memory_stats()
            with CountingMode() as real:
                state, metrics = step(state, batch)
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        after = registry.launch_counts()
        counts = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        loss = float(metrics["loss"])
        del state, params, batch, tokens, metrics
    finally:
        if started:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    ms = statistics.median(times[1:])
    terms = roofline_terms(fake["flops"], fake["bytes"], fake["collective_bytes"], 1)
    bound_ms = max(terms["compute_s"], terms["memory_s"]) * 1e3
    log("dryrun", f"(b) tinyllama-1.1b at full width, {DRYRUN_LAYERS} layers, a train step of "
                  f"{DRYRUN_BATCH} x {DRYRUN_SEQ} on a (1,) mesh: on the card "
                  f"{real.flops:.6g} flops (B11 {real.door_work['flash_attention']}), "
                  f"{real.bytes:.6g} bytes, argument bytes {arg_bytes}, "
                  f"max_memory_allocated {peak / 2**30:.3f} GiB, {ms:.2f} ms a step "
                  f"(median of {[round(t, 2) for t in times[1:]]} after a warm "
                  f"{times[0]:.2f}), loss {loss:.4f}; the dry-run on fake {dev.type} tensors "
                  f"{fake['flops']:.6g} flops, {fake['bytes']:.6g} bytes, argument bytes "
                  f"{fake['memory']['argument_size_in_bytes']}, peak "
                  f"{fake['memory']['peak_size_in_bytes'] / 2**30:.3f} GiB, traced in "
                  f"{fake['trace_s']} s; roofline (H100 data sheet, an estimate) compute "
                  f"{terms['compute_s'] * 1e3:.3f} ms, memory {terms['memory_s'] * 1e3:.3f} ms: "
                  f"{bound_ms / ms:.1%} of the step [{smi}]")
    if real.flops != fake["flops"]:
        raise AssertionError(f"the card's step counts {real.flops} flops, its dry-run "
                             f"{fake['flops']}")
    if arg_bytes != fake["memory"]["argument_size_in_bytes"]:
        raise AssertionError(f"the card's step takes {arg_bytes} argument bytes, its dry-run "
                             f"{fake['memory']['argument_size_in_bytes']}")
    if not bound_ms <= ms:
        raise AssertionError(f"the roofline's {bound_ms:.3f} ms exceeds the measured step's "
                             f"{ms:.3f} ms: a count or a constant is wrong")
    if not counts.get("flash_attention"):
        raise AssertionError(f"the card's train steps launched no B11: {counts}")
    log("dryrun", f"phase {time.perf_counter() - t_phase:.1f} s")
    return counts


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    try:
        from repro_torch import ops
        from repro_torch.core.pipeline import stages as st
        from repro_torch.core.sort import rb_sort_multisplit
        import repro_torch.kernels as registry
        from repro_torch.kernels import build
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import multisplit_tile as mst
        from repro_torch.kernels import ops as kops
    except ImportError as err:
        print(f"chip_smoke: cannot import the port from {ROOT}/src: {err}", file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    # strict everywhere but the chaos parts; the autotune file and the
    # quarantine sidecar in a directory of this run, not the user's cache
    from repro_torch.runtime import resilience as rz

    run_dir = os.path.join(ROOT, "build", "smoke_cache")
    shutil.rmtree(run_dir, ignore_errors=True)
    atexit.register(shutil.rmtree, run_dir, True)
    os.environ["REPRO_AUTOTUNE_DIR"] = run_dir
    ops.set_strict(True)

    # ---- 1. device
    smi = smi_line()
    log("device", f"nvidia-smi: {smi}")
    log("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
                  f"{torch.cuda.get_device_name(0)} sm_{''.join(map(str, torch.cuda.get_device_capability(0)))} "
                  f"count {torch.cuda.device_count()}")

    # ---- 2. build
    t0 = time.perf_counter()
    paths = build.build_all()
    log("build", f"{len(paths)} libraries in {time.perf_counter() - t0:.1f} s "
                 f"(nvcc seconds each: { {k: round(v, 1) for k, v in build.BUILD_SECONDS.items()} })")
    for name in build.PTXAS_LOG:
        for line in build.ptxas_summary(name):
            log("build", f"{name}: {line}")
    # K3, K2s, K1s, K3s, K2p, K2f, K1p, K3f and B10 hold their keys or ranks
    # in registers: no instance may spill
    redesigned = [(name, line) for name in ("tile_positions", "seg_fused_postscan_reorder",
                                            "seg_tile_histograms", "seg_tile_positions",
                                            "packed_fused_postscan_reorder",
                                            "fused2_fused_postscan_reorder",
                                            "packed_tile_histograms", "fused2_tile_positions",
                                            "tile_reorder")
                  for line in build.ptxas_summary(name) if "spill stores" in line]
    spilled = [f"{name}: {line}" for name, line in redesigned
               if "spill stores 0 B, loads 0 B" not in line]
    if spilled:
        raise AssertionError("K3 / K2s / K1s / K3s / K2p / K2f / K1p / K3f / B10 instances "
                             "spill:\n" + "\n".join(spilled))
    log("build", f"K3, K2s, K1s, K3s, K2p, K2f, K1p, K3f and B10: {len(redesigned)} instances, "
                 f"none spills" if redesigned else "K3, K2s, K1s, K3s, K2p, K2f, K1p, K3f and B10: "
                                                   "libraries current, not rebuilt, so no ptxas "
                                                   "lines")
    # K3p's shift and clamp forms spill a few words at four blocks an SM,
    # which ran faster than three blocks without a spill
    # (tools/k3pb10_variants.py): reported, not refused
    k3p_spills = sorted({int(m_) for line in build.ptxas_summary("packed_tile_positions")
                         for m_ in re.findall(r"spill stores (\d+) B", line)})
    log("build", f"K3p: spill stores of its instances {k3p_spills} B (four blocks an SM, chosen "
                 f"by time)" if k3p_spills else "K3p: library current, no ptxas lines")

    # ---- helpers
    def rand_i32(shape):
        return torch.randint(-2**31, 2**31, shape, dtype=torch.int32, device=dev, generator=gen)

    def bits(x):
        return x.view(torch.int32)

    def max_err(a, b) -> int:
        """0 when bitwise equal; else the largest |difference| of the int32
        bit patterns."""
        if a is None or b is None:
            assert a is None and b is None, "one side is missing an output"
            return 0
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
        if torch.equal(bits(a), bits(b)):
            return 0
        return int((bits(a).long() - bits(b).long()).abs().max().item())

    def main_spec(m):
        """The main path's buckets: equal widths over all 2^32 keys."""
        return ops.DeltaSpec(m, 1 << 32)

    # ---- 3. kernels against their plain versions
    errs = {fn.__name__: 0 for fn in registry.KERNELS}
    n_checks = n_ids_paths = 0

    def check_case(what, keys_tiled, spec, values_tiled, g_offset=0):
        nonlocal n_checks
        h_plain = mst.spec_tile_histograms_plain(keys_tiled, spec)
        h = mst.spec_tile_histograms(keys_tiled, spec)
        e1 = max_err(h, h_plain)
        g = st.global_scan(h_plain) + g_offset
        p = mst.spec_tile_positions(keys_tiled, g, spec)
        e3 = max_err(p, mst.spec_tile_positions_plain(keys_tiled, g, spec))
        e2 = 0
        for vals in (None, values_tiled):
            got = mst.spec_fused_postscan_reorder(keys_tiled, g, vals, spec)
            want = mst.spec_fused_postscan_reorder_plain(keys_tiled, g, vals, spec)
            e2 = max(e2, *(max_err(a, b) for a, b in zip(got, want)))
        torch.cuda.synchronize()
        errs["spec_tile_histograms"] = max(errs["spec_tile_histograms"], e1)
        errs["spec_tile_positions"] = max(errs["spec_tile_positions"], e3)
        errs["spec_fused_postscan_reorder"] = max(errs["spec_fused_postscan_reorder"], e2)
        n_checks += 1
        if e1 or e2 or e3:
            raise AssertionError(f"kernel != plain for {what}: K1 {e1}, K2 {e2}, K3 {e3}")
        check_ids_path(what, keys_tiled, spec, values_tiled, g)

    def check_ids_path(what, keys_tiled, spec, values_tiled, g):
        """The labels written out by spec_bucket_ids (held against its plain
        version) through the ids kernels equal the fused kernels' result."""
        nonlocal n_ids_paths
        m = spec.num_buckets
        ids = mst.spec_bucket_ids(keys_tiled, spec)
        e0 = max_err(ids, mst.spec_bucket_ids_plain(keys_tiled, spec))
        errs["spec_bucket_ids"] = max(errs["spec_bucket_ids"], e0)
        d = [max_err(mst.tile_histograms(ids, m), mst.spec_tile_histograms(keys_tiled, spec)),
             max_err(mst.tile_positions(ids, g, m), mst.spec_tile_positions(keys_tiled, g, spec))]
        got = mst.fused_postscan_reorder(ids, g, keys_tiled, values_tiled, m)
        want = mst.spec_fused_postscan_reorder(keys_tiled, g, values_tiled, spec)
        d.append(max(max_err(a, b) for a, b in zip(got, want)))
        torch.cuda.synchronize()
        n_ids_paths += 1
        if e0 or any(d):
            raise AssertionError(f"ids path != fused path for {what}: spec_bucket_ids {e0} "
                                 f"(vs plain), K1/K3/K2 on ids vs fused {d}")

    t0 = time.perf_counter()
    # the main path's shapes: 8192 tiles of 4096 keys, G up to 2^25
    l_main, t_main = N_MAIN // 4096, 4096
    keys_main = rand_i32((l_main, t_main)).view(torch.uint32)
    vals_main = rand_i32((l_main, t_main))
    for spec in (main_spec(2), main_spec(32), main_spec(256), ops.DeltaSpec(256),
                 ops.BitfieldSpec(0, 8), ops.BitfieldSpec(24, 8)):
        check_case(f"main shape {spec.name}", keys_main, spec, vals_main)
    log("kernels", f"main-path shapes ({l_main} x {t_main}): K1-K3 bitwise equal to plain "
                   f"({time.perf_counter() - t0:.1f} s)")

    def keys_for(dtype, shape, lo, hi):
        if dtype == torch.float32:
            return (torch.rand(shape, device=dev, generator=gen) * (hi - lo) + lo).float()
        if dtype == torch.int32:
            return torch.randint(int(lo), int(hi), shape, dtype=torch.int64, device=dev,
                                 generator=gen).to(torch.int32)
        return torch.randint(int(lo), int(hi), shape, dtype=torch.int64, device=dev,
                             generator=gen).to(torch.int32).view(torch.uint32)

    np_rng = np.random.default_rng(SEED)
    spans = {torch.int32: (-2**31, 2**31), torch.uint32: (0, 2**32), torch.float32: (-1e9, 5e9)}
    for shape in ((64, 4096), (3, 1000), (5, 100)):
        for dtype in (torch.int32, torch.uint32, torch.float32):
            lo, hi = spans[dtype]
            for m in (2, 32, 256):
                vals = rand_i32(shape)
                k_full = keys_for(dtype, shape, lo, hi)
                specs = [ops.DeltaSpec(m), ops.EvenSpec(-3.7, 11.3, m)]
                if dtype != torch.float32:
                    specs.append(ops.BitfieldSpec({2: 31, 32: 7, 256: 24}[m], m.bit_length() - 1))
                if dtype == torch.float32:
                    sp = np_rng.uniform(lo, hi, m - 1).astype(np.float32).tolist()
                else:
                    sp = np_rng.integers(lo, hi, m - 1).tolist()
                specs.append(ops.RangeSpec(tuple(sp)))
                if dtype == torch.int32:
                    specs.append(ops.RangeSpec(tuple(s + 0.5 for s in sp)))
                for spec in specs:
                    keys = k_full
                    if isinstance(spec, ops.EvenSpec):
                        keys = keys_for(dtype, shape, -5, 14)
                        if dtype == torch.float32:
                            flat = keys.view(-1)
                            edges = torch.tensor([float("nan"), float("inf"), -float("inf"), -3.7, 11.3],
                                                 device=dev)
                            flat[: edges.numel()] = edges
                    check_case(f"{spec.name} {dtype} {shape}", keys, spec, vals)
                    check_case(f"{spec.name} {dtype} {shape} G+2^24", keys, spec, vals,
                               g_offset=(1 << 24) + 1)
                ident = keys_for(dtype, shape, 0, m)
                check_case(f"identity{m} {dtype} {shape}", ident, ops.IdentitySpec(m), vals)
    fvals = torch.rand((64, 4096), device=dev, generator=gen)
    check_case("float32 values", keys_for(torch.uint32, (64, 4096), 0, 2**32), ops.DeltaSpec(32), fvals)
    log("kernels", f"{n_checks} cases over every spec kind, m in (2, 32, 256), int32/uint32/"
                   f"float32 keys, key-only and key-value, G above 2^24: all bitwise equal "
                   f"({time.perf_counter() - t0:.1f} s)")
    log("kernels", f"{n_ids_paths} of them through the ids path as well: spec_bucket_ids equal "
                   f"to its plain version, then tile_histograms / tile_positions / "
                   f"fused_postscan_reorder on those ids equal to K1 / K3 / K2")

    # ---- 3b. the segmented kernels K1s-K3s against their plain versions
    def ragged_starts(n, s, rng, empty=(), fixed=None):
        """s start offsets over n: the segments in ``empty`` hold no key,
        those in ``fixed`` the given number, the others random shares."""
        fixed = dict(fixed or {})
        lens = np.zeros(s, np.int64)
        free = [i for i in range(s) if i not in empty and i not in fixed]
        for i, k in fixed.items():
            lens[i] = k
        w = rng.random(len(free)) + 0.05
        share = np.floor(w / w.sum() * (n - lens.sum())).astype(np.int64)
        share[-1] += n - lens.sum() - share.sum()
        lens[free] = share
        assert lens.min() >= 0 and lens.sum() == n
        return (np.cumsum(lens) - lens).astype(np.int32)

    def seg_strip(starts, shape):
        return st.segment_ids_from_starts(torch.from_numpy(starts).to(dev), shape[0] * shape[1]).view(shape)

    def check_seg_case(what, keys_tiled, seg_tiled, s, spec, values_tiled, g_offset=0):
        nonlocal n_checks
        h_plain = mst.seg_spec_tile_histograms_plain(keys_tiled, seg_tiled, spec, s)
        e1 = max_err(mst.seg_spec_tile_histograms(keys_tiled, seg_tiled, spec, s), h_plain)
        g = st.global_scan(h_plain) + g_offset
        del h_plain
        e3 = max_err(mst.seg_spec_tile_positions(keys_tiled, seg_tiled, g, spec, s),
                     mst.seg_spec_tile_positions_plain(keys_tiled, seg_tiled, g, spec, s))
        e2 = 0
        for vals in (None, values_tiled):
            got = mst.seg_spec_fused_postscan_reorder(keys_tiled, seg_tiled, g, vals, spec, s)
            want = mst.seg_spec_fused_postscan_reorder_plain(keys_tiled, seg_tiled, g, vals, spec, s)
            e2 = max(e2, *(max_err(a, b) for a, b in zip(got, want)))
        torch.cuda.synchronize()
        errs["seg_spec_tile_histograms"] = max(errs["seg_spec_tile_histograms"], e1)
        errs["seg_spec_tile_positions"] = max(errs["seg_spec_tile_positions"], e3)
        errs["seg_spec_fused_postscan_reorder"] = max(errs["seg_spec_fused_postscan_reorder"], e2)
        n_checks += 1
        if e1 or e2 or e3:
            raise AssertionError(f"segmented kernel != plain for {what}: K1s {e1}, K2s {e2}, K3s {e3}")

    t0, n0 = time.perf_counter(), n_checks
    # (a) the segmented main path's shapes: S1 (m = 32, s = 64), S2 (radix
    # digits, s = 16) and S3 (IdentitySpec(64), s = 256 over 2^20 keys)
    s1_starts = ragged_starts(N_MAIN, 64, np_rng, empty=(0, 31, 63), fixed={7: 1, 40: 1000})
    s2_starts = ragged_starts(N_MAIN, 16, np_rng, empty=(5,))
    n3 = 1 << 20
    s3_starts = ragged_starts(n3, 256, np_rng, empty=tuple(range(0, 256, 37)),
                              fixed={3: 1, 100: 17})
    seg_main = seg_strip(s1_starts, (l_main, t_main))
    check_seg_case("S1 shape", keys_main, seg_main, 64, main_spec(32), vals_main)
    seg2_main = seg_strip(s2_starts, (l_main, t_main))
    for shift in (0, 24):
        check_seg_case(f"S2 shape digit {shift}", keys_main, seg2_main, 16,
                       ops.BitfieldSpec(shift, 8), vals_main)
    del seg2_main
    ids3 = torch.randint(0, 64, (n3 // 4096, 4096), dtype=torch.int32, device=dev, generator=gen)
    check_seg_case("S3 shape", ids3, seg_strip(s3_starts, (n3 // 4096, 4096)), 256,
                   ops.IdentitySpec(64), None)
    # (b) every spec kind, m in (2, 32, 256), every key type, ragged strips
    for shape, s in (((64, 4096), 37), ((3, 1000), 5), ((5, 100), 9)):
        for dtype in (torch.int32, torch.uint32, torch.float32):
            lo, hi = spans[dtype]
            for m in (2, 32, 256):
                starts = ragged_starts(shape[0] * shape[1], s, np_rng, empty=(1, s - 1),
                                       fixed={2: 1})
                seg = seg_strip(starts, shape)
                vals = rand_i32(shape)
                specs = [(ops.DeltaSpec(m), keys_for(dtype, shape, lo, hi)),
                         (ops.EvenSpec(-3.7, 11.3, m), keys_for(dtype, shape, -5, 14)),
                         (ops.IdentitySpec(m), keys_for(dtype, shape, 0, m))]
                if dtype != torch.float32:
                    specs.append((ops.BitfieldSpec({2: 31, 32: 7, 256: 24}[m], m.bit_length() - 1),
                                  keys_for(dtype, shape, lo, hi)))
                sp = (np_rng.uniform(lo, hi, m - 1).astype(np.float32).tolist()
                      if dtype == torch.float32 else np_rng.integers(lo, hi, m - 1).tolist())
                specs.append((ops.RangeSpec(tuple(sp)), keys_for(dtype, shape, lo, hi)))
                for spec, keys in specs:
                    check_seg_case(f"{spec.name} {dtype} {shape} s={s}", keys, seg, s, spec, vals)
                # (c) bases past 2^24
                check_seg_case(f"{specs[0][0].name} {dtype} {shape} G+2^24", specs[0][1], seg, s,
                               specs[0][0], vals, g_offset=(1 << 24) + 1)
    # (d) one- to eight-key segments: hundreds of runs in every tile
    for shape, m in (((64, 4096), 2), ((16, 4096), 256)):
        lens = np_rng.integers(1, 9, shape[0] * shape[1])
        starts = (np.cumsum(lens) - lens)
        starts = starts[starts < shape[0] * shape[1]].astype(np.int32)
        keys = keys_for(torch.uint32, shape, 0, 2**32)
        check_seg_case(f"{starts.size} tiny segments m={m}", keys, seg_strip(starts, shape),
                       starts.size, ops.DeltaSpec(m, 1 << 32), rand_i32(shape))
        log("kernels", f"{starts.size} segments of 1-8 keys over {shape}, m = {m}: K1s-K3s "
                       f"bitwise equal")
    del ids3, seg_main
    log("kernels", f"{n_checks - n0} segmented cases (main shapes of S1-S3, every spec kind, "
                   f"m in (2, 32, 256), int32/uint32/float32 keys, empty segments, G above "
                   f"2^24, tiny segments): K1s-K3s all bitwise equal "
                   f"({time.perf_counter() - t0:.1f} s)")

    # ---- 3c. the ids kernels (materialised labels) against their plain versions
    def check_ids_case(what, ids, keys_tiled, values_tiled, m, seg=None, s=1, g_offset=0):
        """The six ids wrappers on one (L, T) ids strip (labels outside
        [0, m) included: both clamp), flat and, with a strip, segmented."""
        nonlocal n_checks
        e = {}
        h_plain = mst.tile_histograms_plain(ids, m)
        e["tile_histograms"] = max_err(mst.tile_histograms(ids, m), h_plain)
        g = st.global_scan(h_plain) + g_offset
        del h_plain
        e["tile_positions"] = max_err(mst.tile_positions(ids, g, m),
                                      mst.tile_positions_plain(ids, g, m))
        e["fused_postscan_reorder"] = 0
        for vals in (None, values_tiled):
            got = mst.fused_postscan_reorder(ids, g, keys_tiled, vals, m)
            want = mst.fused_postscan_reorder_plain(ids, g, keys_tiled, vals, m)
            e["fused_postscan_reorder"] = max(e["fused_postscan_reorder"],
                                              *(max_err(a, b) for a, b in zip(got, want)))
        del g
        if seg is not None:
            h_plain = mst.seg_tile_histograms_plain(ids, seg, m, s)
            e["seg_tile_histograms"] = max_err(mst.seg_tile_histograms(ids, seg, m, s), h_plain)
            g = st.global_scan(h_plain) + g_offset
            del h_plain
            e["seg_tile_positions"] = max_err(mst.seg_tile_positions(ids, seg, g, m, s),
                                              mst.seg_tile_positions_plain(ids, seg, g, m, s))
            e["seg_fused_postscan_reorder"] = 0
            for vals in (None, values_tiled):
                got = mst.seg_fused_postscan_reorder(ids, seg, g, keys_tiled, vals, m, s)
                want = mst.seg_fused_postscan_reorder_plain(ids, seg, g, keys_tiled, vals, m, s)
                e["seg_fused_postscan_reorder"] = max(e["seg_fused_postscan_reorder"],
                                                      *(max_err(a, b) for a, b in zip(got, want)))
        torch.cuda.synchronize()
        n_checks += 1
        for name, err in e.items():
            errs[name] = max(errs[name], err)
        if any(e.values()):
            raise AssertionError(f"ids kernel != plain for {what}: {e}")

    t0, n0 = time.perf_counter(), n_checks
    # the main paths' shapes: 8192 tiles of 4096 ids, labels of m = 10 (the
    # delta-stepping buckets) and 256, segmented as S1, G up to 2^25
    seg_main = seg_strip(s1_starts, (l_main, t_main))
    for m in (10, 256):
        ids = torch.randint(0, m, (l_main, t_main), dtype=torch.int32, device=dev, generator=gen)
        check_ids_case(f"main shape m={m}", ids, keys_main, vals_main, m, seg_main, 64)
    del ids, seg_main
    # every m, tails and tiles up to MAX_TILE, labels outside [0, m) (they
    # clamp), bases above 2^24, ragged strips with empty segments
    for shape, s in (((64, 4096), 37), ((3, mst.MAX_TILE), 5), ((5, 100), 9), ((7, 33), 3),
                     ((2, 1), 2)):
        for i, m in enumerate((1, 2, 7, 32, 255, 256)):
            starts = ragged_starts(shape[0] * shape[1], s, np_rng, empty=(1, s - 1))
            ids = torch.randint(-3, m + 3, shape, dtype=torch.int32, device=dev, generator=gen)
            dtype = (torch.int32, torch.uint32, torch.float32)[i % 3]     # the moved keys' type
            keys = keys_for(dtype, shape, *spans[dtype])
            check_ids_case(f"ids m={m} {dtype} {shape} s={s}", ids, keys, rand_i32(shape), m,
                           seg_strip(starts, shape), s, g_offset=(1 << 24) + 1 if i % 2 else 0)
    # one- to eight-key segments: hundreds of runs in every tile
    for shape, m in (((64, 4096), 2), ((16, 4096), 256)):
        lens = np_rng.integers(1, 9, shape[0] * shape[1])
        starts = np.cumsum(lens) - lens
        starts = starts[starts < shape[0] * shape[1]].astype(np.int32)
        ids = torch.randint(-1, m + 1, shape, dtype=torch.int32, device=dev, generator=gen)
        check_ids_case(f"ids {starts.size} tiny segments m={m}", ids,
                       keys_for(torch.uint32, shape, 0, 2**32), rand_i32(shape), m,
                       seg_strip(starts, shape), starts.size)
    del ids
    log("kernels", f"{n_checks - n0} ids cases (the main shapes at m = 10 and 256, m in (1, 2, 7, "
                   f"32, 255, 256), tiles up to {mst.MAX_TILE}, labels outside [0, m), G above "
                   f"2^24, empty and tiny segments): the six ids kernels all bitwise equal to "
                   f"their plain versions ({time.perf_counter() - t0:.1f} s)")

    # ---- 3c'. the cases the Hopper designs of K1 and K2 (persistent blocks,
    # staged rows, order-free counts) make new, each through K1-K3 with
    # labels in the kernel and through the ids kernels, against the plain
    # versions: every key of a full tile in one bucket, tile counts below and
    # off a multiple of the persistent grid (a few blocks an SM on the
    # card's SMs), rows of T % 4 != 0 and planes off 16 bytes (the scalar
    # path), MAX_TILE key-value with the ids entry
    def check_k1k2_case(what, keys_tiled, spec, values_tiled, g_offset=(1 << 24) + 1):
        check_case(what, keys_tiled, spec, values_tiled, g_offset)
        check_ids_case(f"{what}, ids", mst.spec_bucket_ids_plain(keys_tiled, spec), keys_tiled,
                       values_tiled, spec.num_buckets, g_offset=g_offset)

    t0, n0 = time.perf_counter(), n_checks
    for shape in ((64, 4096), (3, mst.MAX_TILE)):
        # bucket 0 of 1, 1 of 2 (the all-ones key), 127 of 256
        for spec, word in ((ops.DeltaSpec(1), 0x12345678), (main_spec(2), -1),
                           (main_spec(256), 0x7F000000)):
            keys = torch.full(shape, word, dtype=torch.int32, device=dev).view(torch.uint32)
            check_k1k2_case(f"one bucket {spec.name} {shape}", keys, spec, rand_i32(shape))
    for shape in ((1, 4096), (3, 4096), (997, 4096), (4, 4095), (7, 37), (1, 37),
                  (3, mst.MAX_TILE), (3, mst.MAX_TILE - 1)):
        for spec in (main_spec(2), main_spec(256), ops.DeltaSpec(7), ops.BitfieldSpec(24, 8)):
            check_k1k2_case(f"{spec.name} {shape}", rand_i32(shape).view(torch.uint32), spec,
                            rand_i32(shape))
    for shape in ((5, 4096), (3, mst.MAX_TILE)):
        n_ = shape[0] * shape[1]
        keys = rand_i32((n_ + 1,))[1:].view(shape).view(torch.uint32)    # 4 bytes past 16
        vals = rand_i32((n_ + 3,))[3:].view(shape)                       # 12 bytes past 16
        check_k1k2_case(f"planes off 16 bytes {shape}", keys, main_spec(256), vals)
    del keys, vals
    log("kernels", f"{n_checks - n0} K1 / K2 design cases (one-bucket full tiles at m = 1, 2 "
                   f"and 256, L = 1, 3 and 997, T = 4095, 37 and {mst.MAX_TILE - 1}, planes "
                   f"off 16 bytes, {mst.MAX_TILE} key-value, labels in the kernel and from "
                   f"the ids entry): all bitwise equal to the plain versions "
                   f"({time.perf_counter() - t0:.1f} s)")

    # ---- 3c''. the cases the Hopper design of K2s (persistent staged tiles,
    # K2's path for a tile of one run, chunk flags, one warp a short run,
    # long runs listed) makes new, through K1s-K3s with labels in the kernel
    # and through the ids kernels, against the plain versions, bases above
    # 2^24; each in the shift (DeltaSpec over 2^k), general (DeltaSpec(7))
    # and clamp (IdentitySpec) label forms. K3's cases are 3c''s, which run
    # K3 and K3 on ids too.
    def off16(x, k):
        """x copied to a view k words past a 16-byte boundary."""
        buf = torch.empty((x.numel() + k,), dtype=x.dtype, device=dev)
        view = buf[k:].view(x.shape)
        view.copy_(x)
        return view

    def check_k2s_case(what, keys_tiled, starts, spec, values_tiled, shift=0):
        starts = np.asarray(starts, np.int32)
        seg = seg_strip(starts, tuple(keys_tiled.shape))
        if shift:                                    # the strip off 16 bytes too
            seg = off16(seg, shift)
        check_seg_case(what, keys_tiled, seg, starts.size, spec, values_tiled,
                       g_offset=(1 << 24) + 1)
        check_ids_case(f"{what}, ids", mst.spec_bucket_ids_plain(keys_tiled, spec), keys_tiled,
                       values_tiled, spec.num_buckets, seg, starts.size, g_offset=(1 << 24) + 1)

    def one_run_a_tile(shape):
        return np.arange(0, shape[0] * shape[1], shape[1])

    def k2s_specs(shape):
        """A spec of each label form with keys for it."""
        return ((main_spec(256), rand_i32(shape).view(torch.uint32)),
                (ops.DeltaSpec(7), rand_i32(shape).view(torch.uint32)),
                (ops.IdentitySpec(32), keys_for(torch.int32, shape, 0, 32)))

    t0, n0 = time.perf_counter(), n_checks
    for shape in ((64, 4096), (3, mst.MAX_TILE)):
        # bucket 0 of 1, 1 of 2 (the all-ones key), 127 of 256; one run a tile
        # and ragged runs
        n_ = shape[0] * shape[1]
        for spec, word in ((ops.DeltaSpec(1), 0x12345678), (main_spec(2), -1),
                           (main_spec(256), 0x7F000000)):
            keys = torch.full(shape, word, dtype=torch.int32, device=dev).view(torch.uint32)
            for starts in (one_run_a_tile(shape), ragged_starts(n_, 9, np_rng, empty=(1,))):
                check_k2s_case(f"K2s one bucket {spec.name} {shape} s={starts.size}", keys, starts,
                               spec, rand_i32(shape))
    for shape in ((1, 4096), (3, 4096), (997, 4096), (4, 4095), (7, 37), (3, mst.MAX_TILE - 1),
                  (3, mst.MAX_TILE)):
        n_ = shape[0] * shape[1]
        for i, (spec, keys) in enumerate(k2s_specs(shape)):
            starts = (one_run_a_tile(shape), ragged_starts(n_, 5, np_rng, empty=(2,)),
                      ragged_starts(n_, 256, np_rng, empty=tuple(range(0, 256, 37))))[i]
            check_k2s_case(f"K2s {spec.name} {shape} s={starts.size}", keys, starts, spec,
                           rand_i32(shape))
    # planes off 16 bytes: keys 4 bytes past, values 12, the segment strip 8
    for shape in ((5, 4096), (3, mst.MAX_TILE)):
        n_ = shape[0] * shape[1]
        keys = off16(rand_i32(shape), 1).view(torch.uint32)
        vals = off16(rand_i32(shape), 3)
        for starts in (one_run_a_tile(shape), ragged_starts(n_, 6, np_rng, empty=(3,))):
            check_k2s_case(f"K2s planes off 16 bytes {shape} s={starts.size}", keys, starts,
                           main_spec(256), vals, shift=2)
    # two runs a tile, the boundary inside a 32-key round (45) or on one
    # (64, 2048); runs of exactly 32 and 33 keys (one warp alone and the
    # block), between long ones; empty segments among them
    shape = (8, 4096)
    n_ = shape[0] * shape[1]
    inside = [0] + [l * 4096 + 45 for l in range(0, 8, 2)] + [l * 4096 + 2048 for l in range(1, 8, 2)]
    on_round = [0] + [l * 4096 + 64 for l in range(8)]
    lens = np.tile([32, 33, 32, 33, 1000, 33, 32], n_ // 1195 + 1)
    runs_32_33 = (np.cumsum(lens) - lens)
    runs_32_33 = runs_32_33[runs_32_33 < n_]
    empties = np.sort(np.concatenate([[0, 0], ragged_starts(n_, 40, np_rng), [n_ - 1, n_, n_]]))
    for what, starts in (("boundary inside a round", sorted(set(inside))),
                         ("boundary on a round", sorted(set(on_round))),
                         ("runs of 32 and 33", runs_32_33), ("empty segments", empties)):
        for spec, keys in k2s_specs(shape):
            check_k2s_case(f"K2s {what} {spec.name} s={len(starts)}", keys, starts, spec,
                           rand_i32(shape))
    del keys, vals
    log("kernels", f"{(n_checks - n0) // 2} K2s design cases (one-bucket tiles at m = 1, 2 and 256, "
                   f"L = 1, 3 and 997, T = 4095, 37 and {mst.MAX_TILE - 1}, planes off 16 "
                   f"bytes, {mst.MAX_TILE} key-value, tiles of one run, boundaries inside a "
                   f"round and on one, runs of 32 and 33 keys, empty segments, s up to 256; "
                   f"shift, general and clamp label forms; labels in the kernel and from the "
                   f"ids entry; G above 2^24): K1s-K3s and the ids kernels all bitwise equal "
                   f"to the plain versions ({time.perf_counter() - t0:.1f} s); the strip of "
                   f"one- to eight-key segments is 3b (d)'s and 3c's")

    # ---- 3c'''. the cases the Hopper designs of K1s and K3s make new (K1s:
    # order-free counts over the tile's window of segments, the strip read at
    # a one-run tile's two ends only; K3s: K3's path on a one-run tile, the
    # staged strip and K2s's run split on any other), through K1s-K3s with
    # labels in the kernel and through the ids kernels, against the plain
    # versions, bases above 2^24
    window = int(re.search(r"kSetWords = (\d+);",
                           (build.CSRC / "seg_tile_histograms.cu").read_text()).group(1))

    def tile_strip(shape, per_tile):
        """Starts that give tile l of ``shape`` per_tile[l] segment ids (its
        first key starts one; repeated starts make empty segments)."""
        n_tiles_, t_ = shape
        starts = []
        for l, k in enumerate(per_tile):
            inner = np.sort(np_rng.integers(1, t_, k - 1)) if k > 1 else np.zeros(0, np.int64)
            starts.extend([l * t_] + (l * t_ + inner).tolist())
        return np.asarray(starts, np.int64)

    def two_runs_a_tile(shape):
        return tile_strip(shape, [2] * shape[0])

    t0, n0 = time.perf_counter(), n_checks
    # full tiles of one run and of two runs, each label form, tile counts
    # below and off a multiple of the persistent grid, ragged and full rows
    for shape in ((1, 4096), (3, 4096), (997, 4096), (4, 4095), (7, 37), (3, mst.MAX_TILE - 1),
                  (3, mst.MAX_TILE)):
        for spec, keys in k2s_specs(shape):
            for starts in (one_run_a_tile(shape), two_runs_a_tile(shape)):
                check_k2s_case(f"K1s/K3s {spec.name} {shape} s={starts.size}", keys, starts, spec,
                               rand_i32(shape))
    # one-bucket tiles of one run: bucket 0 of 1, 1 of 2, 127 of 256
    shape = (997, 4096)
    for spec, word in ((ops.DeltaSpec(1), 0x12345678), (main_spec(2), -1),
                       (main_spec(256), 0x7F000000)):
        keys = torch.full(shape, word, dtype=torch.int32, device=dev).view(torch.uint32)
        check_k2s_case(f"K1s/K3s one bucket {spec.name} {shape}", keys, one_run_a_tile(shape),
                       spec, rand_i32(shape))
    # the key plane 12 bytes past 16 and the strip 4 bytes past
    for shape in ((5, 4096), (3, mst.MAX_TILE)):
        n_ = shape[0] * shape[1]
        keys = off16(rand_i32(shape), 3).view(torch.uint32)
        for starts in (one_run_a_tile(shape), ragged_starts(n_, 7, np_rng, empty=(2,))):
            check_k2s_case(f"K1s/K3s planes off 16 bytes {shape} s={starts.size}", keys, starts,
                           main_spec(32), rand_i32(shape), shift=1)
    # rows of s·m % 4 != 0 in each label form: 5·7, 7·2, 3·5
    shape = (64, 4096)
    n_ = shape[0] * shape[1]
    for spec, keys, s_ in ((ops.DeltaSpec(7), rand_i32(shape).view(torch.uint32), 5),
                           (main_spec(2), rand_i32(shape).view(torch.uint32), 7),
                           (ops.IdentitySpec(5), keys_for(torch.int32, shape, 0, 5), 3)):
        for starts in (ragged_starts(n_, s_, np_rng, empty=(1,)), np.arange(s_) * (n_ // s_)):
            check_k2s_case(f"K1s/K3s s·m = {starts.size * spec.num_buckets} {spec.name}", keys,
                           starts, spec, rand_i32(shape))
    # K1s's window: a tile of exactly (window - 1) // m segment ids, one of
    # one id more (two windows), one of two windows and one more, and a tile
    # of one run; at m = 256 (16 a window), 32, 7 and, in tiles of MAX_TILE,
    # 1 (4111 a window)
    for spec, shape in ((main_spec(256), (4, 4096)), (main_spec(32), (4, 4096)),
                        (ops.IdentitySpec(32), (4, 4096)), (ops.DeltaSpec(7), (4, 4096)),
                        (ops.DeltaSpec(1), (3, mst.MAX_TILE))):
        per = (window - 1) // spec.num_buckets
        counts = [per, per + 1, 2 * per + 1, 1][: shape[0]]
        starts = tile_strip(shape, counts)
        keys = (keys_for(torch.int32, shape, 0, 32) if isinstance(spec, ops.IdentitySpec) else
                rand_i32(shape).view(torch.uint32))
        check_k2s_case(f"K1s window {spec.name}: {counts} segment ids a tile", keys, starts, spec,
                       rand_i32(shape))
    # tiles of hundreds of runs: one- to eight-key segments, many windows a
    # tile (28 at m = 64 in tiles of MAX_TILE) and one (m = 2)
    for spec, shape in ((ops.IdentitySpec(64), (8, mst.MAX_TILE)), (ops.DeltaSpec(7), (8, 4096)),
                        (main_spec(2), (8, 4096))):
        lens = np_rng.integers(1, 9, shape[0] * shape[1])
        starts = np.cumsum(lens) - lens
        starts = starts[starts < shape[0] * shape[1]]
        keys = (keys_for(torch.int32, shape, 0, 64) if isinstance(spec, ops.IdentitySpec) else
                rand_i32(shape).view(torch.uint32))
        check_k2s_case(f"K1s/K3s {starts.size} tiny segments {spec.name} {shape}", keys, starts,
                       spec, rand_i32(shape))
    # runs of 32 and 33 keys, boundaries inside a round and on one, empty
    # segments, in tiles of MAX_TILE (K3s's 32 rounds a warp)
    shape = (4, mst.MAX_TILE)
    n_ = shape[0] * shape[1]
    lens = np.tile([32, 33, 2000, 33, 32], n_ // 2130 + 1)
    runs_32_33 = (np.cumsum(lens) - lens)
    runs_32_33 = runs_32_33[runs_32_33 < n_]
    rounds = sorted({0, 45, 64, mst.MAX_TILE + 4000, mst.MAX_TILE + 4096, 2 * mst.MAX_TILE + 31,
                     3 * mst.MAX_TILE + 32})
    empties = np.sort(np.concatenate([[0, 0], ragged_starts(n_, 30, np_rng), [n_ - 1, n_, n_]]))
    for what, starts in (("runs of 32 and 33", runs_32_33), ("round boundaries", rounds),
                         ("empty segments", empties)):
        for spec, keys in k2s_specs(shape):
            check_k2s_case(f"K1s/K3s {what} {spec.name} s={len(starts)}", keys, starts, spec,
                           rand_i32(shape))
    del keys
    log("kernels", f"{(n_checks - n0) // 2} K1s / K3s design cases (full tiles of one run and of "
                   f"two in the shift, general and clamp label forms, one-bucket tiles at m = 1, "
                   f"2 and 256, L = 1, 3 and 997, T = 4095, 37, {mst.MAX_TILE - 1} and "
                   f"{mst.MAX_TILE}, the strip and the key plane off 16 bytes, s·m rows not a "
                   f"multiple of 4, tiles at K1s's window of {window} words and one segment past "
                   f"it, tiles of hundreds of runs, runs of 32 and 33 keys, boundaries inside a "
                   f"round and on one, empty segments; labels in the kernel and from the ids "
                   f"entry; G above 2^24): K1s-K3s and the ids kernels all bitwise equal to the "
                   f"plain versions ({time.perf_counter() - t0:.1f} s)")

    # ---- 3d. the packed kernels K1p-K3p against their plain versions and the
    # onehot kernels, in their four forms ({spec labels | ids strip} x {flat |
    # segmented})
    def onehot_stages(tiled, keys_tiled, spec, m, seg, s):
        """The onehot wrappers of the same form: (histograms, positions(g),
        reorder(g, vals))."""
        if spec is not None and seg is None:
            return (lambda: mst.spec_tile_histograms(tiled, spec),
                    lambda g: mst.spec_tile_positions(tiled, g, spec),
                    lambda g, v: mst.spec_fused_postscan_reorder(tiled, g, v, spec))
        if spec is not None:
            return (lambda: mst.seg_spec_tile_histograms(tiled, seg, spec, s),
                    lambda g: mst.seg_spec_tile_positions(tiled, seg, g, spec, s),
                    lambda g, v: mst.seg_spec_fused_postscan_reorder(tiled, seg, g, v, spec, s))
        if seg is None:
            return (lambda: mst.tile_histograms(tiled, m),
                    lambda g: mst.tile_positions(tiled, g, m),
                    lambda g, v: mst.fused_postscan_reorder(tiled, g, keys_tiled, v, m))
        return (lambda: mst.seg_tile_histograms(tiled, seg, m, s),
                lambda g: mst.seg_tile_positions(tiled, seg, g, m, s),
                lambda g, v: mst.seg_fused_postscan_reorder(tiled, seg, g, keys_tiled, v, m, s))

    packed_forms = set()

    def check_packed_case(what, tiled, values_tiled, spec=None, m=None, keys_tiled=None, seg=None,
                          s=1, g_offset=0, subtile=None):
        """K1p, K3p and K2p (key-only and key-value) on one form, each held
        bitwise against its plain version and against the onehot kernel of
        the same form."""
        nonlocal n_checks
        kw = dict(seg_tiled=seg, num_segments=s, subtile=subtile)
        kw.update(spec=spec) if spec is not None else kw.update(num_buckets=m)
        hist, positions, reorder = onehot_stages(tiled, keys_tiled, spec, m, seg, s)
        e = {}
        h_plain = mst.packed_tile_histograms_plain(tiled, **kw)
        h = mst.packed_tile_histograms(tiled, **kw)
        e["packed_tile_histograms"] = max(max_err(h, h_plain), max_err(h, hist()))
        g = st.global_scan(h_plain) + g_offset
        del h, h_plain
        p = mst.packed_tile_positions(tiled, g, **kw)
        e["packed_tile_positions"] = max(max_err(p, mst.packed_tile_positions_plain(tiled, g, **kw)),
                                         max_err(p, positions(g)))
        del p
        e["packed_fused_postscan_reorder"] = 0
        for vals in (None, values_tiled):
            got = mst.packed_fused_postscan_reorder(tiled, g, keys_tiled, vals, **kw)
            for want in (mst.packed_fused_postscan_reorder_plain(tiled, g, keys_tiled, vals, **kw),
                         reorder(g, vals)):
                e["packed_fused_postscan_reorder"] = max(
                    e["packed_fused_postscan_reorder"], *(max_err(a, b) for a, b in zip(got, want)))
        torch.cuda.synchronize()
        n_checks += 1
        packed_forms.add(("spec" if spec is not None else "ids", "flat" if seg is None else "segmented"))
        for name, err in e.items():
            errs[name] = max(errs[name], err)
        if any(e.values()):
            raise AssertionError(f"packed kernel != plain or onehot for {what}: {e}")

    t0, n0 = time.perf_counter(), n_checks
    # (a) the main shapes: 8192 tiles of 4096 keys at m = 8, 32, 256 and the
    # radix digits, flat; S1 (s = 64, m = 32) and S3 (s = 256, m = 64); the
    # ids forms beside them; G up to 2^25
    for spec in (main_spec(8), main_spec(32), main_spec(256), ops.BitfieldSpec(0, 8),
                 ops.BitfieldSpec(24, 8)):
        check_packed_case(f"main shape {spec.name}", keys_main, vals_main, spec=spec)
    ids = torch.randint(0, 256, (l_main, t_main), dtype=torch.int32, device=dev, generator=gen)
    check_packed_case("main shape ids m=256", ids, vals_main, m=256, keys_tiled=keys_main)
    seg_main = seg_strip(s1_starts, (l_main, t_main))
    check_packed_case("S1 shape", keys_main, vals_main, spec=main_spec(32), seg=seg_main, s=64)
    ids = torch.randint(0, 32, (l_main, t_main), dtype=torch.int32, device=dev, generator=gen)
    check_packed_case("S1 shape ids", ids, vals_main, m=32, keys_tiled=keys_main, seg=seg_main, s=64)
    del ids, seg_main
    shape3 = (n3 // 4096, 4096)
    ids3 = torch.randint(0, 64, shape3, dtype=torch.int32, device=dev, generator=gen)
    seg3 = seg_strip(s3_starts, shape3)
    check_packed_case("S3 shape", ids3, None, spec=ops.IdentitySpec(64), seg=seg3, s=256)
    check_packed_case("S3 shape ids", ids3, rand_i32(shape3), m=64, keys_tiled=rand_i32(shape3),
                      seg=seg3, s=256)
    del ids3, seg3
    log("kernels", f"packed, main shapes (flat {l_main} x {t_main} at m = 8, 32, 256 and two radix "
                   f"digits; S1; S3; spec and ids forms): K1p-K3p bitwise equal to their plain "
                   f"versions and to the onehot kernels ({time.perf_counter() - t0:.1f} s)")
    # (b) m in (1, 2, 7, 8, 255, 256), tiles of 128 to 8192 keys, every
    # subtile the kernels take on one shape, labels outside [0, m) (both
    # families clamp them), bases above 2^24, ragged strips with empty
    # segments; every form
    for shape, s in (((16, 128), 5), ((3, 1000), 9), ((8, 4096), 37), ((3, mst.MAX_TILE), 5),
                     ((7, 33), 3)):
        for i, m in enumerate((1, 2, 7, 8, 255, 256)):
            starts = ragged_starts(shape[0] * shape[1], s, np_rng, empty=(1, s - 1))
            seg = seg_strip(starts, shape)
            keys = keys_for(torch.uint32, shape, 0, 2**32)
            spec = main_spec(m) if m > 1 else ops.DeltaSpec(1)
            ids = torch.randint(-3, m + 3, shape, dtype=torch.int32, device=dev, generator=gen)
            vals = rand_i32(shape)
            off = (1 << 24) + 1 if i % 2 else 0
            for sub in ((None, 255, 32, 1) if shape == (3, 1000) else (None,)):
                tag = f"m={m} {shape} s={s} subtile={sub}"
                check_packed_case(f"spec {tag}", keys, vals, spec=spec, g_offset=off, subtile=sub)
                check_packed_case(f"spec seg {tag}", keys, vals, spec=spec, seg=seg, s=s,
                                  g_offset=off, subtile=sub)
                check_packed_case(f"ids {tag}", ids, vals, m=m, keys_tiled=keys, g_offset=off,
                                  subtile=sub)
                check_packed_case(f"ids seg {tag}", ids, vals, m=m, keys_tiled=keys, seg=seg, s=s,
                                  g_offset=off, subtile=sub)
    # (c) adversarial tiles: every key in one bucket, so a counter lane
    # reaches exactly the subtile cap of 255 keys (flat, and long runs)
    for sub in (255, None):
        keys = torch.full((8, 4096), 7, dtype=torch.int32, device=dev)
        seg = seg_strip(np.array([0, 5000, 5001, 20000], np.int32), (8, 4096))
        check_packed_case(f"one bucket subtile={sub}", keys, rand_i32((8, 4096)),
                          spec=ops.IdentitySpec(8), subtile=sub, g_offset=(1 << 24) + 1)
        check_packed_case(f"one bucket seg subtile={sub}", keys, rand_i32((8, 4096)),
                          spec=ops.IdentitySpec(8), seg=seg, s=4, subtile=sub)
        check_packed_case(f"one bucket ids subtile={sub}", keys, rand_i32((8, 4096)), m=256,
                          keys_tiled=rand_i32((8, 4096)), subtile=sub)
    # (d) one- to eight-key segments: hundreds of runs in every tile
    for shape, m in (((64, 4096), 2), ((16, 4096), 256)):
        lens = np_rng.integers(1, 9, shape[0] * shape[1])
        starts = np.cumsum(lens) - lens
        starts = starts[starts < shape[0] * shape[1]].astype(np.int32)
        seg = seg_strip(starts, shape)
        keys = keys_for(torch.uint32, shape, 0, 2**32)
        check_packed_case(f"{starts.size} tiny segments m={m}", keys, rand_i32(shape),
                          spec=main_spec(m), seg=seg, s=starts.size)
        ids = torch.randint(-1, m + 1, shape, dtype=torch.int32, device=dev, generator=gen)
        check_packed_case(f"ids {starts.size} tiny segments m={m}", ids, rand_i32(shape), m=m,
                          keys_tiled=keys, seg=seg, s=starts.size)
    del ids, seg, keys, vals
    if len(packed_forms) != 4:
        raise AssertionError(f"packed forms checked: {sorted(packed_forms)}")
    log("kernels", f"{n_checks - n0} packed cases (the main shapes, m in (1, 2, 7, 8, 255, 256), "
                   f"tiles of 128 to {mst.MAX_TILE}, subtiles 1, 32, 128 and 255, one-bucket tiles "
                   f"at the 255 cap, labels outside [0, m), G above 2^24, empty and tiny segments; "
                   f"all four forms): K1p-K3p all bitwise equal to their plain versions and to the "
                   f"onehot kernels ({time.perf_counter() - t0:.1f} s)")

    # (e) K3p in its Hopper design (persistent staged tiles, the packed rank
    # in registers, K3s's run split), against its plain version and the
    # onehot K3 / K3s of the same form: tiles of MAX_TILE (32 rounds a warp)
    # with every key in one bucket at subtile 255 (the lane cap), flat and
    # segmented with one-run and long-run tiles; planes off 16 bytes and
    # rows of 4095, 37 and MAX_TILE - 1 keys (the one-word path); S1- and
    # S3-like strips of one-run tiles, runs of 32 and 33 keys, one- to
    # eight-key segments and long runs; all four forms, G above 2^24
    k3p_forms = set()

    def check_k3p_case(what, tiled, spec=None, m=None, seg=None, s=1, subtile=None,
                       g_offset=0):
        nonlocal n_checks
        kw = dict(seg_tiled=seg, num_segments=s, subtile=subtile)
        kw.update(spec=spec) if spec is not None else kw.update(num_buckets=m)
        g = st.global_scan(mst.packed_tile_histograms_plain(tiled, **kw)) + g_offset
        p = mst.packed_tile_positions(tiled, g, **kw)
        e = max(max_err(p, mst.packed_tile_positions_plain(tiled, g, **kw)),
                max_err(p, onehot_stages(tiled, None, spec, m, seg, s)[1](g)))
        torch.cuda.synchronize()
        n_checks += 1
        k3p_forms.add(("spec" if spec is not None else "ids", "flat" if seg is None else "segmented"))
        errs["packed_tile_positions"] = max(errs["packed_tile_positions"], e)
        if e:
            raise AssertionError(f"packed_tile_positions != plain or onehot for {what}: {e}")

    def mixed_strip(shape):
        """A quarter of the tiles one run each, a quarter runs of 32 and 33
        keys, a quarter one- to eight-key segments over their first 512
        keys and then one long run, a quarter three ragged long runs."""
        n_tiles, t = shape
        q = n_tiles // 4
        lens = np.tile([32, 33], q * t // 65 + 1)
        parts = [np.arange(q) * t, q * t + (np.cumsum(lens) - lens)[np.cumsum(lens) - lens < q * t]]
        for tile in range(2 * q, 3 * q):
            tiny = np.cumsum(np_rng.integers(1, 9, 200))
            parts.append(tile * t + np.r_[0, tiny[tiny < 512]])
        for tile in range(3 * q, n_tiles):
            parts.append(tile * t + np.r_[0, np.sort(np_rng.choice(np.arange(1, t), 2, replace=False))])
        return np.unique(np.concatenate(parts)).astype(np.int32)

    t0, n0 = time.perf_counter(), n_checks
    for m in (1, 2, 256):
        shape = (8, mst.MAX_TILE)
        keys = torch.full(shape, m - 1, dtype=torch.int32, device=dev)
        seg = seg_strip(np.array([0, 5000, 5001, 20000], np.int32), shape)
        tag = f"one bucket {m - 1} of {m}, T = {mst.MAX_TILE}, subtile 255"
        check_k3p_case(f"K3p {tag}", keys, spec=ops.IdentitySpec(m), subtile=255,
                       g_offset=(1 << 24) + 1)
        check_k3p_case(f"K3p ids {tag}", keys, m=m, subtile=255)
        check_k3p_case(f"K3p seg {tag}", keys, spec=ops.IdentitySpec(m), seg=seg, s=4, subtile=255)
        check_k3p_case(f"K3p seg ids {tag}", keys, m=m, seg=seg, s=4, subtile=255,
                       g_offset=(1 << 24) + 1)
    # planes off 16 bytes (keys 4 bytes past, ids 8, the strip 8) and rows
    # of 4095, 37 and MAX_TILE - 1 keys: the one-word copies and stores
    for shape, shift in (((5, 4096), 1), ((4, 4095), 0), ((7, 37), 0),
                         ((3, mst.MAX_TILE - 1), 0), ((3, mst.MAX_TILE), 1)):
        keys = rand_i32(shape).view(torch.uint32)
        ids = torch.randint(-2, 34, shape, dtype=torch.int32, device=dev, generator=gen)
        seg = seg_strip(ragged_starts(shape[0] * shape[1], 5, np_rng, empty=(3,)), shape)
        if shift:
            keys, ids, seg = off16(keys, shift), off16(ids, 2 * shift), off16(seg, 2 * shift)
        tag = f"{shape}" + (" planes off 16 bytes" if shift else "")
        check_k3p_case(f"K3p {tag}", keys, spec=main_spec(256), g_offset=(1 << 24) + 1)
        check_k3p_case(f"K3p ids {tag}", ids, m=32, subtile=1)
        check_k3p_case(f"K3p seg m=7 {tag}", keys, spec=ops.DeltaSpec(7), seg=seg, s=5, subtile=32)
        check_k3p_case(f"K3p seg ids {tag}", ids, m=32, seg=seg, s=5, g_offset=(1 << 24) + 1)
    # S1-like (m = 32, labels in the kernel and ids) and S3-like (m = 64,
    # IdentitySpec and ids) strips of every run kind, subtiles 255 and 32
    for shape, m in (((32, 4096), 32), ((16, 4096), 64)):
        starts = mixed_strip(shape)
        seg = seg_strip(starts, shape)
        keys = rand_i32(shape).view(torch.uint32)
        spec = main_spec(32) if m == 32 else ops.IdentitySpec(64)
        labels = keys if m == 32 else torch.randint(0, 64, shape, dtype=torch.int32, device=dev,
                                                    generator=gen)
        ids = torch.randint(-1, m + 1, shape, dtype=torch.int32, device=dev, generator=gen)
        for sub in (255, 32):
            tag = f"{'S1' if m == 32 else 'S3'}-like strip, {starts.size} segments, subtile {sub}"
            check_k3p_case(f"K3p {tag}", labels, spec=spec, seg=seg, s=int(starts.size),
                           subtile=sub, g_offset=(1 << 24) + 1)
            check_k3p_case(f"K3p ids {tag}", ids, m=m, seg=seg, s=int(starts.size), subtile=sub)
    del keys, ids, seg, labels
    if len(k3p_forms) != 4:
        raise AssertionError(f"K3p forms checked: {sorted(k3p_forms)}")
    log("kernels", f"{n_checks - n0} K3p design cases (one-bucket tiles of {mst.MAX_TILE} at "
                   f"subtile 255, m = 1, 2, 256, flat and segmented; planes off 16 bytes, rows of "
                   f"4095, 37 and {mst.MAX_TILE - 1}; S1- and S3-like strips of one-run tiles, "
                   f"runs of 32 and 33, tiny segments and long runs at subtiles 255 and 32; all "
                   f"four forms, G above 2^24): K3p bitwise equal to its plain version and to K3 / "
                   f"K3s ({time.perf_counter() - t0:.1f} s)")

    # ---- 3e. the fused two-digit kernels K1f-K3f against their plain versions:
    # {flat | segmented} x {keys | key-value} x {onehot | packed stage rank} x
    # stage widths
    fused_forms = set()

    def check_fused2_case(what, keys_tiled, values_tiled, spec, split, seg=None, s=1, g_offset=0,
                          families=("onehot", "packed"), subs=(1, 3, 4, 8)):
        """K1f, then K3f and K2f (key-only and key-value) in each family and
        stage width, each held bitwise against its plain version."""
        nonlocal n_checks
        kw = dict(spec=spec, num_segments=s)
        e = {}
        h_plain = mst.fused2_tile_histograms_plain(keys_tiled, seg, **kw)
        e["fused2_tile_histograms"] = max_err(mst.fused2_tile_histograms(keys_tiled, seg, **kw),
                                              h_plain)
        g = st.global_scan(h_plain) + g_offset
        del h_plain
        e["fused2_tile_positions"] = e["fused2_fused_postscan_reorder"] = 0
        for fam in families:
            for sub in subs:
                kw2 = dict(kw, split=split, family=fam, sub_bits=sub)
                e["fused2_tile_positions"] = max(
                    e["fused2_tile_positions"],
                    max_err(mst.fused2_tile_positions(keys_tiled, g, seg, **kw2),
                            mst.fused2_tile_positions_plain(keys_tiled, g, seg, **kw2)))
                for vals in (None, values_tiled):
                    got = mst.fused2_fused_postscan_reorder(keys_tiled, g, vals, seg, **kw2)
                    want = mst.fused2_fused_postscan_reorder_plain(keys_tiled, g, vals, seg, **kw2)
                    e["fused2_fused_postscan_reorder"] = max(
                        e["fused2_fused_postscan_reorder"], *(max_err(a, b) for a, b in zip(got, want)))
                fused_forms.add(("flat" if seg is None else "segmented", fam))
        torch.cuda.synchronize()
        n_checks += 1
        for name, err in e.items():
            errs[name] = max(errs[name], err)
        if any(e.values()):
            raise AssertionError(f"fused2 kernel != plain for {what}: {e}")

    t0, n0 = time.perf_counter(), n_checks
    t_fused = mst.MAX_TILE                               # the cuda backend's fused-pair tile
    # (a) the fused paths' shapes: F1 (2^25 keys in 4096 tiles of 8192, both
    # pairs of r = 8), F2 (2^22 keys, the 14-bit pair of r = 7), F3 (2^22 keys
    # over 16 ragged segments, the 16-bit pair); G up to 2^25
    kt_f1, vt_f1 = keys_main.view(-1, t_fused), vals_main.view(-1, t_fused)
    check_fused2_case("F1 shape pair 0", kt_f1, vt_f1, ops.BitfieldSpec(0, 16), 8, subs=(None,))
    check_fused2_case("F1 shape pair 1", kt_f1, vt_f1, ops.BitfieldSpec(16, 16), 8,
                      families=("onehot",), subs=(4,))
    shape_small = (N_FUSED_SMALL // t_fused, t_fused)
    kt_small = keys_main.view(-1)[:N_FUSED_SMALL].view(shape_small)
    vt_small = vals_main.view(-1)[:N_FUSED_SMALL].view(shape_small)
    check_fused2_case("F2 shape", kt_small, vt_small, ops.BitfieldSpec(14, 14), 7, subs=(None,))
    f3_starts = ragged_starts(N_FUSED_SMALL, 16, np_rng, empty=(5,))
    check_fused2_case("F3 shape", kt_small, vt_small, ops.BitfieldSpec(0, 16), 8,
                      seg_strip(f3_starts, shape_small), 16, subs=(None,))
    del kt_f1, vt_f1, kt_small, vt_small
    log("kernels", f"fused2, main shapes (F1 {N_MAIN // t_fused} x {t_fused}, both 16-bit pairs; "
                   f"F2's 14-bit pair and F3's 16 segments over {shape_small}): K1f-K3f bitwise "
                   f"equal to their plain versions ({time.perf_counter() - t0:.1f} s)")
    # (b) every form: tiles of 128 to the fused tile and ragged ones, the
    # pairs (16, 8), (14, 7) and the uneven (6, 4), every stage width, int32
    # and uint32 keys, ragged strips with empty segments, bases past 2^24
    for shape, s in (((16, 128), 5), ((3, 1000), 9), ((8, 4096), 37), ((3, t_fused), 5),
                     ((7, 33), 3)):
        for i, (shift, pbits, split) in enumerate(((0, 16, 8), (14, 14, 7), (26, 6, 4))):
            dtype = (torch.int32, torch.uint32)[i % 2]
            keys = keys_for(dtype, shape, *spans[dtype])
            vals = rand_i32(shape)
            seg = seg_strip(ragged_starts(shape[0] * shape[1], s, np_rng, empty=(1, s - 1)), shape)
            off = (1 << 24) + 1 if i != 1 else 0
            spec = ops.BitfieldSpec(shift, pbits)
            check_fused2_case(f"{spec.name} {dtype} {shape}", keys, vals, spec, split, g_offset=off)
            check_fused2_case(f"{spec.name} {dtype} {shape} s={s}", keys, vals, spec, split, seg, s,
                              g_offset=off)
    # (c) one-cell tiles: every key of a tile in one (segment, pair) cell
    keys = torch.full((8, t_fused), 0x5A5A1234, dtype=torch.int32, device=dev)
    keys[4:] ^= rand_i32(tuple(keys[4:].shape)) & 0xFFFF0000       # one pair, other high bits
    seg = seg_strip(np.array([0, 5000, 5001, 20000], np.int32), (8, t_fused))
    check_fused2_case("one-cell tiles", keys, rand_i32((8, t_fused)), ops.BitfieldSpec(0, 16), 8,
                      g_offset=(1 << 24) + 1)
    check_fused2_case("one-cell tiles seg", keys, rand_i32((8, t_fused)), ops.BitfieldSpec(0, 16), 8,
                      seg, 4)
    # (c') what K1f's 16-bit counters, two cells to a word, make new: every
    # key of a full tile in one odd cell (a count of 8192 in a word's high
    # half), and half of a tile's keys in each cell of one word
    keys = torch.full((4, t_fused), 0x5A5A1235, dtype=torch.int32, device=dev)
    for r in (2, 3):
        keys[r, torch.randperm(t_fused, device=dev, generator=gen)[: t_fused // 2]] -= 1
    seg = seg_strip(np.array([0, t_fused, 2 * t_fused + 1], np.int32), (4, t_fused))
    for what, seg_, s_ in (("flat", None, 1), ("segmented", seg, 3)):
        check_fused2_case(f"a full tile in one odd cell, 4096 keys in each cell of a word, {what}",
                          keys, rand_i32((4, t_fused)), ops.BitfieldSpec(0, 16), 8, seg_, s_,
                          families=("onehot",), subs=(None,))
    # (d) one- to eight-key segments: thousands of runs of at most 32 keys
    for shape, (shift, pbits, split) in (((16, 4096), (8, 6, 4)), ((64, 4096), (30, 2, 1))):
        lens = np_rng.integers(1, 9, shape[0] * shape[1])
        starts = np.cumsum(lens) - lens
        starts = starts[starts < shape[0] * shape[1]].astype(np.int32)
        check_fused2_case(f"{starts.size} tiny segments pair {pbits}",
                          keys_for(torch.uint32, shape, 0, 2**32), rand_i32(shape),
                          ops.BitfieldSpec(shift, pbits), split, seg_strip(starts, shape),
                          int(starts.size), subs=(1, 8))
        log("kernels", f"{starts.size} segments of 1-8 keys over {shape}, a {pbits}-bit pair: "
                       f"K1f-K3f bitwise equal")
    del keys, vals, seg
    if len(fused_forms) != 4:
        raise AssertionError(f"fused2 forms checked: {sorted(fused_forms)}")
    log("kernels", f"{n_checks - n0} fused2 cases (the fused paths' shapes, tiles of 128 to {t_fused}, "
                   f"pairs (16, 8), (14, 7), (6, 4), stage widths 1, 3, 4 and 8, both families, "
                   f"one-cell tiles, a full tile in one odd cell, half a tile in each cell of a "
                   f"word, G above 2^24, empty and tiny segments; flat and segmented, "
                   f"keys and key-value): K1f-K3f all bitwise equal to their plain versions "
                   f"({time.perf_counter() - t0:.1f} s)")

    # ---- 3e'. the cases the Hopper designs of K2p (persistent staged tiles,
    # the packed rank in registers, K2s's run split) and K2f (persistent, two
    # blocks an SM, the sweep on the shared ranks, G once a cell run) make
    # new, each held bitwise against its plain version in all four forms,
    # key-only and key-value, bases above 2^24
    def check_k2p_case(what, tiled, values_tiled, spec=None, m=None, keys_tiled=None, seg=None,
                       s=1, subtile=None):
        nonlocal n_checks
        kw = dict(seg_tiled=seg, num_segments=s, subtile=subtile)
        kw.update(spec=spec) if spec is not None else kw.update(num_buckets=m)
        g = st.global_scan(mst.packed_tile_histograms_plain(tiled, **kw)) + (1 << 24) + 1
        e = 0
        for vals in (None, values_tiled):
            got = mst.packed_fused_postscan_reorder(tiled, g, keys_tiled, vals, **kw)
            want = mst.packed_fused_postscan_reorder_plain(tiled, g, keys_tiled, vals, **kw)
            e = max(e, *(max_err(a, b) for a, b in zip(got, want)))
        torch.cuda.synchronize()
        n_checks += 1
        packed_forms.add(("spec" if spec is not None else "ids", "flat" if seg is None else "segmented"))
        errs["packed_fused_postscan_reorder"] = max(errs["packed_fused_postscan_reorder"], e)
        if e:
            raise AssertionError(f"packed_fused_postscan_reorder != plain for {what}: {e}")

    def check_k2f_case(what, keys_tiled, values_tiled, spec, seg=None, s=1, subs=(None,)):
        nonlocal n_checks
        kw = dict(spec=spec, num_segments=s)
        g = st.global_scan(mst.fused2_tile_histograms_plain(keys_tiled, seg, **kw)) + (1 << 24) + 1
        e = 0
        for fam in ("onehot", "packed"):
            for sub in subs:
                kw2 = dict(kw, split=spec.bits // 2, family=fam, sub_bits=sub)
                for vals in (None, values_tiled):
                    got = mst.fused2_fused_postscan_reorder(keys_tiled, g, vals, seg, **kw2)
                    want = mst.fused2_fused_postscan_reorder_plain(keys_tiled, g, vals, seg, **kw2)
                    e = max(e, *(max_err(a, b) for a, b in zip(got, want)))
                fused_forms.add(("flat" if seg is None else "segmented", fam))
        torch.cuda.synchronize()
        n_checks += 1
        errs["fused2_fused_postscan_reorder"] = max(errs["fused2_fused_postscan_reorder"], e)
        if e:
            raise AssertionError(f"fused2_fused_postscan_reorder != plain for {what}: {e}")

    def k2fk2p_strips(shape):
        """A one-run-a-tile strip, a ragged one with an empty segment, and
        one of runs of 32 and 33 keys between long ones."""
        n_ = shape[0] * shape[1]
        lens = np.tile([32, 33, 700, 33, 32], n_ // 830 + 1)
        runs = np.cumsum(lens) - lens
        return (("one run a tile", one_run_a_tile(shape)),
                ("ragged", ragged_starts(n_, 7, np_rng, empty=(2,))),
                ("runs of 32 and 33", runs[runs < n_]))

    t0, n0 = time.perf_counter(), n_checks
    pair16 = ops.BitfieldSpec(0, 16)
    # tile counts below and off a multiple of the persistent grid, rows of 37,
    # 4095 and MAX_TILE - 1 keys (the scalar path), MAX_TILE key-value; every
    # strip kind in the segmented forms
    for shape in ((1, 4096), (3, 4096), (997, 4096), (4, 4095), (7, 37), (3, mst.MAX_TILE - 1),
                  (3, mst.MAX_TILE)):
        keys = rand_i32(shape).view(torch.uint32)
        vals = rand_i32(shape)
        ids = torch.randint(0, 256, shape, dtype=torch.int32, device=dev, generator=gen)
        check_k2p_case(f"K2p m=256 {shape}", keys, vals, spec=main_spec(256))
        check_k2p_case(f"K2p general m=7 {shape}", keys, vals, spec=ops.DeltaSpec(7), subtile=255)
        check_k2p_case(f"K2p ids m=256 {shape}", ids, vals, m=256, keys_tiled=keys, subtile=32)
        subs = (1, 8) if shape[0] < 100 else (None,)
        check_k2f_case(f"K2f pair 16 {shape}", keys, vals, pair16, subs=subs)
        for kind, starts in k2fk2p_strips(shape):
            # the segmented rows grow with s: K2f's G is (L, s·m²) int32 and
            # K2p's plain version builds s·m-wide planes a tile, so at L =
            # 997 (s = 997 for one run a tile, about 24,000 for runs of 32
            # and 33) only the ragged strip of 7 segments fits the card
            if shape[0] >= 100 and kind != "ragged":
                continue
            seg = seg_strip(starts, shape)
            check_k2p_case(f"K2p seg {kind} {shape}", keys, vals, spec=main_spec(32), seg=seg,
                           s=len(starts))
            check_k2p_case(f"K2p seg ids {kind} {shape}", ids, vals, m=256, keys_tiled=keys,
                           seg=seg, s=len(starts))
            check_k2f_case(f"K2f seg {kind} {shape}", keys, vals, pair16, seg, len(starts))
    # planes off 16 bytes: keys 4 bytes past, values 12, the strips 8
    for shape in ((5, 4096), (3, mst.MAX_TILE)):
        keys = off16(rand_i32(shape), 1).view(torch.uint32)
        vals = off16(rand_i32(shape), 3)
        ids = off16(torch.randint(0, 32, shape, dtype=torch.int32, device=dev, generator=gen), 2)
        seg = off16(seg_strip(ragged_starts(shape[0] * shape[1], 6, np_rng, empty=(3,)), shape), 2)
        check_k2p_case(f"K2p planes off 16 bytes {shape}", keys, vals, spec=main_spec(256))
        check_k2p_case(f"K2p ids seg planes off 16 bytes {shape}", ids, vals, m=32,
                       keys_tiled=keys, seg=seg, s=6)
        check_k2f_case(f"K2f planes off 16 bytes {shape}", keys, vals, pair16)
        check_k2f_case(f"K2f seg planes off 16 bytes {shape}", keys, vals, pair16, seg, 6)
    # one-bucket full tiles (a K2p lane at the 255 cap) and one-cell full tiles
    shape = (8, mst.MAX_TILE)
    for word in (7, 0x5A5A1234):
        keys = torch.full(shape, word, dtype=torch.int32, device=dev)
        seg = seg_strip(np.array([0, 5000, 5001, 20000], np.int32), shape)
        for sub in (255, None):
            check_k2p_case(f"K2p one bucket {word:#x} subtile={sub}", keys, rand_i32(shape),
                           spec=ops.IdentitySpec(8) if word == 7 else main_spec(256), subtile=sub)
            check_k2p_case(f"K2p one bucket seg {word:#x} subtile={sub}", keys, rand_i32(shape),
                           spec=ops.IdentitySpec(8) if word == 7 else main_spec(256), seg=seg, s=4,
                           subtile=sub)
        check_k2f_case(f"K2f one cell {word:#x}", keys, rand_i32(shape), pair16, subs=(4, None))
        check_k2f_case(f"K2f one cell seg {word:#x}", keys, rand_i32(shape), pair16, seg, 4)
    del keys, vals, ids, seg
    log("kernels", f"{n_checks - n0} K2p / K2f design cases (L = 1, 3 and 997, T = 37, 4095, "
                   f"{mst.MAX_TILE - 1} and {mst.MAX_TILE} key-value, planes off 16 bytes, "
                   f"one-bucket and one-cell full tiles, subtiles 32, 255 and the auto one, stage "
                   f"widths 1, 4 and 8 in both families, segmented tiles of one run, ragged and "
                   f"of runs of 32 and 33 keys, G above 2^24; all four forms of each): K2p and "
                   f"K2f bitwise equal to their plain versions ({time.perf_counter() - t0:.1f} s)")

    # ---- 3e''. the cases the Hopper designs of K1p (persistent, order-free
    # counts in packed 8-bit copies, two copies a lane at T > 4096, K1s's
    # window of segments) and K3f (K2f's body in its positions-only form)
    # make new, each held bitwise against its plain version in all four
    # forms, and K2f beside K3f (its body moved into the shared header)
    def check_k1p_case(what, tiled, spec=None, m=None, seg=None, s=1):
        nonlocal n_checks
        kw = dict(seg_tiled=seg, num_segments=s)
        kw.update(spec=spec) if spec is not None else kw.update(num_buckets=m)
        e = max_err(mst.packed_tile_histograms(tiled, **kw),
                    mst.packed_tile_histograms_plain(tiled, **kw))
        torch.cuda.synchronize()
        n_checks += 1
        k1p_forms.add(("spec" if spec is not None else "ids", "flat" if seg is None else "segmented"))
        errs["packed_tile_histograms"] = max(errs["packed_tile_histograms"], e)
        if e:
            raise AssertionError(f"packed_tile_histograms != plain for {what}: {e}")

    def check_k3f_case(what, keys_tiled, spec, seg=None, s=1, subs=(None,), with_k2f=False):
        nonlocal n_checks
        kw = dict(spec=spec, num_segments=s)
        g = st.global_scan(mst.fused2_tile_histograms_plain(keys_tiled, seg, **kw)) + (1 << 24) + 1
        e = e2 = 0
        for fam in ("onehot", "packed"):
            for sub in subs:
                kw2 = dict(kw, split=spec.bits // 2, family=fam, sub_bits=sub)
                e = max(e, max_err(mst.fused2_tile_positions(keys_tiled, g, seg, **kw2),
                                   mst.fused2_tile_positions_plain(keys_tiled, g, seg, **kw2)))
                if with_k2f:
                    got = mst.fused2_fused_postscan_reorder(keys_tiled, g, None, seg, **kw2)
                    want = mst.fused2_fused_postscan_reorder_plain(keys_tiled, g, None, seg, **kw2)
                    e2 = max(e2, *(max_err(a, b) for a, b in zip(got, want)))
                k3f_forms.add(("flat" if seg is None else "segmented", fam))
        torch.cuda.synchronize()
        n_checks += 1
        errs["fused2_tile_positions"] = max(errs["fused2_tile_positions"], e)
        errs["fused2_fused_postscan_reorder"] = max(errs["fused2_fused_postscan_reorder"], e2)
        if e or e2:
            raise AssertionError(f"K3f / K2f != plain for {what}: {e} / {e2}")

    def k1p_strips(shape):
        """A strip of one run a tile, a ragged one with empty segments, runs
        of 32 and 33 keys, and tiles of more segment ids than K1p's window
        holds (its window: 2 segments at m = 256 and T <= 4096, 1 above)."""
        n_ = shape[0] * shape[1]
        lens = np.tile([32, 33, 700, 33, 32], n_ // 830 + 1)
        runs = np.cumsum(lens) - lens
        wide = np.sort(np_rng.choice(np.arange(1, n_), min(n_ - 1, 5 * shape[0]), replace=False))
        return (("one run a tile", one_run_a_tile(shape)),
                ("ragged", ragged_starts(n_, 7, np_rng, empty=(2, 5))),
                ("runs of 32 and 33", runs[runs < n_]),
                ("about five segments a tile", np.r_[0, wide]))

    k1p_forms, k3f_forms = set(), set()
    t0, n0 = time.perf_counter(), n_checks
    # tile counts 1, 3 and 997 (below and off a multiple of the persistent
    # grid), rows of 37, 4095 and MAX_TILE - 1 keys (the scalar path),
    # MAX_TILE; every strip kind in the segmented forms; K3f's bases above
    # 2^24; K2f on the same tiles
    for shape in ((1, 4096), (3, 4096), (997, 4096), (4, 4095), (7, 37), (3, mst.MAX_TILE - 1),
                  (3, mst.MAX_TILE)):
        keys = rand_i32(shape).view(torch.uint32)
        for m in ((256, 7) if shape[0] < 100 else (256,)):
            spec = main_spec(m) if m == 256 else ops.DeltaSpec(m)
            ids = torch.randint(-2, m + 2, shape, dtype=torch.int32, device=dev, generator=gen)
            check_k1p_case(f"K1p m={m} {shape}", keys, spec=spec)
            check_k1p_case(f"K1p ids m={m} {shape}", ids, m=m)
            for kind, starts in k1p_strips(shape):
                # L = 997 takes the ragged strip alone: one run a tile is 997
                # segments, whose plain version builds s·m-wide planes a tile
                if shape[0] >= 100 and kind != "ragged":
                    continue
                seg = seg_strip(starts, shape)
                check_k1p_case(f"K1p seg {kind} m={m} {shape}", keys, spec=spec, seg=seg,
                               s=len(starts))
                check_k1p_case(f"K1p seg ids {kind} m={m} {shape}", ids, m=m, seg=seg,
                               s=len(starts))
        subs = (1, 8) if shape[0] < 100 else (None,)
        check_k3f_case(f"K3f pair 16 {shape}", keys, pair16, subs=subs, with_k2f=True)
        check_k3f_case(f"K3f pair 6 {shape}", keys, ops.BitfieldSpec(26, 6), subs=(3, 4))
        for kind, starts in k2fk2p_strips(shape):
            if shape[0] >= 100 and kind != "ragged":
                continue
            check_k3f_case(f"K3f seg {kind} {shape}", keys, pair16, seg_strip(starts, shape),
                           len(starts), with_k2f=True)
    # planes off 16 bytes: keys 4 bytes past, ids 8, the strip 8; rows of s·m
    # % 4 != 0 (m = 7, s = 5)
    for shape in ((5, 4096), (3, mst.MAX_TILE)):
        keys = off16(rand_i32(shape), 1).view(torch.uint32)
        ids = off16(torch.randint(0, 32, shape, dtype=torch.int32, device=dev, generator=gen), 2)
        seg = off16(seg_strip(ragged_starts(shape[0] * shape[1], 5, np_rng, empty=(3,)), shape), 2)
        check_k1p_case(f"K1p planes off 16 bytes {shape}", keys, spec=main_spec(256))
        check_k1p_case(f"K1p ids planes off 16 bytes {shape}", ids, m=32)
        check_k1p_case(f"K1p seg m=7 planes off 16 bytes {shape}", keys, spec=ops.DeltaSpec(7),
                       seg=seg, s=5)
        check_k1p_case(f"K1p seg ids planes off 16 bytes {shape}", ids, m=32, seg=seg, s=5)
        check_k3f_case(f"K3f planes off 16 bytes {shape}", keys, pair16)
        check_k3f_case(f"K3f seg planes off 16 bytes {shape}", keys, pair16, seg, 5)
    # the lane cap: every key of a full tile in one bucket (128 adds a lane,
    # at T = MAX_TILE with two copies a lane), flat and as one-run segmented
    # tiles, at m = 1, 2 and 256; one-cell full tiles for K3f
    for t in (4096, mst.MAX_TILE):
        shape = (8, t)
        seg = seg_strip(np.array([0, 5000, 5001, 20000], np.int32), shape)
        for m in (1, 2, 256):
            keys = torch.full(shape, m - 1, dtype=torch.int32, device=dev)
            spec = ops.IdentitySpec(m)
            check_k1p_case(f"K1p one bucket {m - 1} of {m}, T = {t}", keys, spec=spec)
            check_k1p_case(f"K1p ids one bucket {m - 1} of {m}, T = {t}", keys, m=m)
            check_k1p_case(f"K1p seg one bucket {m - 1} of {m}, T = {t}", keys, spec=spec, seg=seg,
                           s=4)
            check_k1p_case(f"K1p seg ids one bucket {m - 1} of {m}, T = {t}", keys, m=m, seg=seg,
                           s=4)
        keys = torch.full(shape, 0x5A5A1234, dtype=torch.int32, device=dev)
        keys[4:] ^= rand_i32(tuple(keys[4:].shape)) & 0xFFFF0000       # one pair, other high bits
        check_k3f_case(f"K3f one cell, T = {t}", keys, pair16, subs=(4, None), with_k2f=True)
        check_k3f_case(f"K3f one cell seg, T = {t}", keys, pair16, seg, 4)
    # tiles of hundreds of runs: one- to eight-key segments, a few K1p
    # windows a tile (m = 2, tiles of 4096) and hundreds (m = 64 in tiles of
    # MAX_TILE, four segments a window); phase 3d drives m = 256 in tiles
    # of 4096 (two a window)
    for shape, m in (((64, 4096), 2), ((3, mst.MAX_TILE), 64)):
        lens = np_rng.integers(1, 9, shape[0] * shape[1])
        starts = np.cumsum(lens) - lens
        starts = starts[starts < shape[0] * shape[1]].astype(np.int32)
        seg = seg_strip(starts, shape)
        keys = rand_i32(shape).view(torch.uint32)
        ids = torch.randint(-1, m + 1, shape, dtype=torch.int32, device=dev, generator=gen)
        check_k1p_case(f"K1p {starts.size} tiny segments m={m} {shape}", keys, spec=main_spec(m),
                       seg=seg, s=int(starts.size))
        check_k1p_case(f"K1p ids {starts.size} tiny segments m={m} {shape}", ids, m=m, seg=seg,
                       s=int(starts.size))
        if m == 64:
            check_k3f_case(f"K3f {starts.size} tiny segments {shape}", keys,
                           ops.BitfieldSpec(8, 6), seg, int(starts.size), subs=(1, 8))
    del keys, ids, seg
    if len(k1p_forms) != 4 or len(k3f_forms) != 4:
        raise AssertionError(f"K1p / K3f forms checked: {sorted(k1p_forms)}, {sorted(k3f_forms)}")
    log("kernels", f"{n_checks - n0} K1p / K3f design cases (L = 1, 3 and 997, T = 37, 4095, "
                   f"{mst.MAX_TILE - 1} and {mst.MAX_TILE}, planes off 16 bytes, one-bucket full "
                   f"tiles at m = 1, 2 and 256 (the lane cap, T = 4096 and {mst.MAX_TILE}), "
                   f"one-cell full tiles, segmented tiles of one run, ragged, of runs of 32 and 33 "
                   f"keys and of more segments than K1p's window, one- to eight-key segments, s·m "
                   f"% 4 != 0, stage widths 1, 3, 4 and 8 in both families, G above 2^24; all four "
                   f"forms of each, K2f beside K3f): K1p, K3f and K2f bitwise equal to their plain "
                   f"versions ({time.perf_counter() - t0:.1f} s)")

    # ---- 3f. B10, the standalone tile reorder of the unfused baseline, against
    # its plain version: key-only (null values) and key-value
    def check_reorder_case(what, ids, keys_tiled, values_tiled, m):
        nonlocal n_checks
        e = 0
        for vals in (None, values_tiled):
            got = mst.tile_reorder(ids, keys_tiled, vals, m)
            want = mst.tile_reorder_plain(ids, keys_tiled, vals, m)
            e = max(e, *(max_err(a, b) for a, b in zip(got, want)))
        torch.cuda.synchronize()
        n_checks += 1
        errs["tile_reorder"] = max(errs["tile_reorder"], e)
        if e:
            raise AssertionError(f"tile_reorder != plain for {what}: {e}")

    t0, n0 = time.perf_counter(), n_checks
    # (a) the main shape: 8192 tiles of 4096, the labels of the unfused
    # baseline's m = 256 pass; the destinations riding as the values, as
    # pass 2 of multisplit_unfused takes them
    ids = mst.spec_bucket_ids_plain(keys_main, main_spec(256))
    check_reorder_case("main shape m=256", ids, keys_main, vals_main, 256)
    check_reorder_case("main shape m=256, destinations as values", ids, keys_main,
                       mst.tile_positions_plain(ids, st.global_scan(mst.tile_histograms_plain(ids, 256)),
                                                256), 256)
    del ids
    # (b) m in (1, 2, 7, 32, 255, 256), tiles of 1 to MAX_TILE keys, ragged
    # ones among them, int32 / uint32 / float32 keys with NaN and inf, ids
    # outside [0, m) (both sides clamp them)
    for shape in ((64, 4096), (64, 1024), (3, mst.MAX_TILE), (5, 4095), (3, 1023), (5, 1000),
                  (7, 33), (9, 100), (4, 1)):
        for i, m in enumerate((1, 2, 7, 32, 255, 256)):
            dtype = (torch.int32, torch.uint32, torch.float32)[i % 3]
            keys = keys_for(dtype, shape, *spans[dtype])
            if dtype == torch.float32:
                flat = keys.view(-1)
                edges = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0], device=dev)
                flat[: min(4, flat.numel())] = edges[: min(4, flat.numel())]
            lo, hi = (-3, m + 3) if i % 2 else (0, m)
            ids = torch.randint(lo, hi, shape, dtype=torch.int32, device=dev, generator=gen)
            check_reorder_case(f"m={m} {dtype} {shape} ids in [{lo}, {hi})", ids, keys,
                               rand_i32(shape), m)
    # (c) B10 in its Hopper design (persistent staged tiles, K2's ballot rank
    # on the ids, the moves into the dead planes): planes off 16 bytes (the
    # one-word copies and stores) at the tiles multisplit_unfused launches
    # (1024 and 4096) and at MAX_TILE, float32 keys with NaN and inf
    for shape in ((64, 1024), (5, 4096), (3, mst.MAX_TILE)):
        keys = keys_for(torch.float32, shape, *spans[torch.float32])
        keys.view(-1)[:4] = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0],
                                         device=dev)
        ids = torch.randint(0, 256, shape, dtype=torch.int32, device=dev, generator=gen)
        check_reorder_case(f"{shape} ids off 16 bytes", off16(ids, 1), keys, rand_i32(shape), 256)
        check_reorder_case(f"{shape} keys and values off 16 bytes", ids, off16(keys, 2),
                           off16(rand_i32(shape), 3), 7)
    del ids, keys
    log("kernels", f"{n_checks - n0} tile_reorder cases (the main shape at m = 256, m in (1, 2, 7, "
                   f"32, 255, 256), tiles of 1 to {mst.MAX_TILE} keys, the unfused tiles of 1024 "
                   f"and 4096, ragged and odd ones (4095, 1023), planes off 16 bytes, int32/uint32/"
                   f"float32 keys with NaN and inf, ids outside [0, m), key-only and key-value): B10 "
                   f"bitwise equal to its plain version ({time.perf_counter() - t0:.1f} s)")

    # ---- 3h. B11, flash attention, against its plain version in the working
    # dtype, within one unit in the last place (ATTN_TOL, ATTN_ULP, ATTN_ATOL)
    def attn_inputs(shape, dtype):
        return [torch.randn(shape, device=dev, generator=gen).to(dtype) for _ in range(3)]

    def attn_err(what, got, q, k, v, causal, block_q=256, block_k=256):
        """Log the max abs error of ``got`` against the plain version and
        its worst share of the limit; raise where an element passes its limit
        or on a wrong shape, dtype or a non-finite value."""
        want = fa.flash_attention_plain(q, k, v, causal, block_q, block_k)
        torch.cuda.synchronize()
        if got.shape != q.shape or got.dtype != q.dtype or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"flash_attention {what}: {got.dtype} {tuple(got.shape)} or "
                                 f"non-finite values")
        g, w = got.float(), want.float()
        diff = (g - w).abs()
        dt = str(q.dtype).split(".")[1]
        limit = torch.clamp(ATTN_ULP[dt] * torch.maximum(g.abs(), w.abs()) + ATTN_ATOL[dt],
                            max=ATTN_TOL[dt])
        err = diff.max().item()
        share = (diff / limit).max().item()
        errs["flash_attention"] = max(errs["flash_attention"], err)
        attn_max[dt] = max(attn_max.get(dt, 0.0), err)
        attn_share[dt] = round(max(attn_share.get(dt, 0.0), share), 4)
        rule = (f"{ATTN_TOL[dt]:g}" if not ATTN_ULP[dt] else
                f"2^{round(math.log2(ATTN_ULP[dt]))}·|value| + {ATTN_ATOL[dt]:g}, at most "
                f"{ATTN_TOL[dt]:g}")
        log("kernels", f"flash_attention {what}: max abs err {err:.3g}, worst {share:.3f} of "
                       f"the limit ({rule})")
        if not share <= 1.0:
            raise AssertionError(f"flash_attention != plain for {what}: an element differs by "
                                 f"{share:.3f} times its limit ({rule}); max abs err {err}")

    attn_max = {}                        # dtype -> max abs err over the cases
    attn_share = {}                      # dtype -> worst share of the limit over the cases

    def check_attn(what, shape, dtype, causal, block_q=256, block_k=256):
        nonlocal n_checks
        q, k, v = attn_inputs(shape, dtype)
        attn_err(what, fa.flash_attention(q, k, v, causal, block_q, block_k), q, k, v, causal,
                 block_q, block_k)
        n_checks += 1

    t0, n0 = time.perf_counter(), n_checks
    for name, (shape, causal, _, dtypes) in ATTN.items():
        for dt in dtypes:
            check_attn(f"{name} {shape} {dt}{'' if causal else ' not causal'}", shape,
                       getattr(torch, dt), causal)
    # the JAX tests' shapes and block pairs (tests/test_kernels.py:136-160) in
    # every dtype; ragged S and other head widths: S not a multiple of the
    # kernel's 64-row tile, one row, hd from 8 to 256
    small = [((3, 256, 64), True, 64, 64), ((3, 512, 128), True, 128, 64),
             ((3, 256, 64), False, 64, 128), ((3, 512, 32), True, 256, 256)]
    for shape, causal, bq, bk in small:
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            check_attn(f"{shape} {dt} causal={causal} blocks ({bq}, {bk})", shape, dt, causal,
                       bq, bk)
    ragged = [((3, 200, 8), torch.float16, True, 8, 40), ((2, 72, 256), torch.float32, False, 8, 8),
              ((1, 1, 8), torch.float32, True, 1, 1), ((3, 100, 40), torch.bfloat16, True, 20, 25),
              ((2, 130, 256), torch.bfloat16, True, 2, 2), ((2, 96, 80), torch.float32, True, 32, 32),
              ((2, 4100, 96), torch.float32, True, 4100, 100),
              ((2, 320, 136), torch.float16, False, 64, 64)]
    for shape, dt, causal, bq, bk in ragged:
        check_attn(f"{shape} {dt} causal={causal} blocks ({bq}, {bk})", shape, dt, causal, bq, bk)
    # the tensor-core routes' edges in all three dtypes: hd of one to eight
    # 32-column chunks (float32) and one to four 64-column chunks (16 bits)
    # with zero fill past hd, S of one row, one tile less or more than a row
    # and a ragged long one, causal and not
    edges = [((4, 1, 8), True, 1, 1), ((3, 63, 8), False, 63, 63), ((2, 65, 16), True, 65, 13),
             ((2, 256, 16), False, 256, 256), ((2, 65, 40), True, 65, 65),
             ((2, 130, 72), True, 130, 130), ((2, 65, 72), False, 65, 65),
             ((2, 130, 128), False, 130, 130), ((2, 63, 136), True, 63, 63),
             ((2, 320, 136), False, 64, 64), ((2, 63, 176), True, 63, 63),
             ((1, 130, 224), False, 130, 130), ((2, 65, 256), True, 65, 13),
             ((4, 1, 256), False, 1, 1), ((2, 4100, 72), True, 4100, 100),
             ((1, 4100, 136), False, 100, 4100)]
    for shape, causal, bq, bk in edges:
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            check_attn(f"{shape} {dt} causal={causal} blocks ({bq}, {bk})", shape, dt, causal,
                       bq, bk)
    # q, k and v as contiguous views at an odd element offset: not 16-byte
    # aligned, which TMA refuses, so the wrapper copies them in every dtype;
    # the result must equal the aligned call's bitwise
    shape = (3, 200, 72)
    n_el = math.prod(shape)
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        buf = torch.randn(3 * n_el + 1, device=dev, generator=gen).to(dt)
        q, k, v = (buf[1 + i * n_el:1 + (i + 1) * n_el].view(shape) for i in range(3))
        if not all(x.is_contiguous() and x.data_ptr() % 16 for x in (q, k, v)):
            raise AssertionError("the offset views are not contiguous and misaligned")
        got = fa.flash_attention(q, k, v, True, 200, 200)
        if not torch.equal(got, fa.flash_attention(q.clone(), k.clone(), v.clone(), True, 200, 200)):
            raise AssertionError(f"flash_attention of misaligned {dt} views differs from the "
                                 f"aligned call")
        attn_err(f"{shape} {dt} causal=True, views at element offset 1 (data_ptr % 16 = "
                 f"{q.data_ptr() % 16})", got, q, k, v, True, 200, 200)
        n_checks += 1
    del buf, q, k, v, got
    log("kernels", f"{n_checks - n0} flash_attention cases (A1-A3 at full width, the JAX tests' "
                   f"shapes in float32/bfloat16/float16, ragged S, hd 8 to 256, the tensor-core "
                   f"routes' edges in all three dtypes, misaligned views) within the limit of the "
                   f"plain version; max abs err {attn_max}, worst share of the limit {attn_share} "
                   f"({time.perf_counter() - t0:.1f} s)")

    # ---- 4. main path at the paper's size, with the launch counts of that run alone
    keys = rand_i32((N_MAIN,)).view(torch.uint32)
    values = rand_i32((N_MAIN,))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    registry.reset_launches()
    runs = {}
    t0 = time.perf_counter()
    for m in (2, 32, 256):
        spec = main_spec(m)
        for method in ("bms", "dms"):
            runs[(m, method, False)] = ops.multisplit(keys, spec, method=method, device=dev)
            runs[(m, method, True)] = ops.multisplit(keys, spec, values, method=method, device=dev)
        runs[(m, "hist")] = ops.histogram(keys, spec, device=dev)
    runs["sort"] = ops.radix_sort(keys, device=dev)
    runs["sort_kv"] = ops.radix_sort(keys, values, device=dev)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = registry.launch_counts()
    peak_main = torch.cuda.max_memory_allocated() - base_mem
    log("main", f"n = {N_MAIN}: 12 multisplits, 3 histograms, 2 radix sorts in {main_s:.2f} s "
                f"(first calls); peak device memory above the inputs {peak_main / 2**30:.2f} GiB")

    fields = ("keys", "values", "bucket_starts", "bucket_counts", "permutation")
    for m in (2, 32, 256):
        spec = main_spec(m)
        want = rb_sort_multisplit(keys, spec, values)
        for method in ("bms", "dms"):
            for kv in (False, True):
                got = runs[(m, method, kv)]
                for f in fields:
                    w = getattr(want, f)
                    if f == "values" and not kv:
                        w = None
                    if max_err(getattr(got, f), w):
                        raise AssertionError(f"multisplit m={m} {method} kv={kv}: {f} differs")
        if max_err(runs[(m, "hist")], want.bucket_counts):
            raise AssertionError(f"histogram m={m} differs")
        del want
    # stable sort of uint32 keys: flip the sign bit so signed order is unsigned order
    _, order = torch.sort(bits(keys) ^ torch.iinfo(torch.int32).min, stable=True)
    want_keys, want_vals = bits(keys)[order].view(torch.uint32), values[order]
    if max_err(runs["sort"][0], want_keys) or runs["sort"][1] is not None:
        raise AssertionError("radix_sort keys differ")
    if max_err(runs["sort_kv"][0], want_keys) or max_err(runs["sort_kv"][1], want_vals):
        raise AssertionError("radix_sort key-value differs")
    del runs, order, want_keys, want_vals
    log("main", "every multisplit, histogram and radix sort is bitwise equal to the "
                "stable-sort oracle")

    # ---- 5. launches
    for name, count in launches.items():
        log("launches", f"flat path: {name}: {count}")
    # per run: a multisplit launches K1 once and K2 (bms) or K3 (dms) once; a
    # histogram K1 once; a radix sort K1 and K2 once a pass, 4 passes; no
    # other kernel
    expect = {name: 0 for name in launches}
    expect.update({"spec_tile_histograms": 12 + 3 + 8, "spec_fused_postscan_reorder": 6 + 8,
                   "spec_tile_positions": 6})
    if launches != expect:
        raise AssertionError(f"launch counts {launches} != expected {expect}")

    # ---- 5b. the segmented main path, with its own launch counts
    def seg_oracle(keys, starts, spec, values=None):
        """Stable torch.sort of the int64 combined key seg·m + label."""
        m = spec.num_buckets
        n = keys.shape[0]
        starts_t = torch.from_numpy(starts).to(dev)
        seg = st.segment_ids_from_starts(starts_t, n)
        cid = seg.long() * m + spec.emit(keys).long()
        _, order = torch.sort(cid, stable=True)
        counts = torch.bincount(cid, minlength=len(starts) * m).to(torch.int32).view(-1, m)
        dest = torch.empty(n, dtype=torch.int32, device=dev)
        dest[order] = torch.arange(n, dtype=torch.int32, device=dev)
        return ops.MultisplitResult(
            bits(keys)[order].view(keys.dtype),
            None if values is None else bits(values)[order].view(values.dtype),
            st.exclusive_rows(counts), counts, dest - starts_t.index_select(0, seg))

    def check_result(what, got, want, fields):
        for f in fields:
            if max_err(getattr(got, f), getattr(want, f)):
                raise AssertionError(f"{what}: {f} differs from the stable-sort oracle")

    def seg_sort_oracle(keys, starts, values=None):
        seg = st.segment_ids_from_starts(torch.from_numpy(starts).to(dev), keys.shape[0])
        _, order = torch.sort((seg.long() << 32) | (bits(keys).long() & 0xFFFFFFFF), stable=True)
        return bits(keys)[order].view(keys.dtype), None if values is None else values[order]

    spec1 = main_spec(32)
    ids3_flat = torch.randint(0, 64, (n3,), dtype=torch.int32, device=dev, generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    registry.reset_launches()
    t0 = time.perf_counter()
    seg_runs = {}
    for method in ("bms", "dms"):
        seg_runs[(method, False)] = ops.segmented_multisplit(keys, spec1, s1_starts, method=method,
                                                             device=dev)
        seg_runs[(method, True)] = ops.segmented_multisplit(keys, spec1, s1_starts, values,
                                                            method=method, device=dev)
    seg_runs["positions_only"] = ops.segmented_multisplit(keys, spec1, s1_starts,
                                                          mode="positions_only", device=dev)
    seg_runs["counts_only"] = ops.segmented_multisplit(keys, spec1, s1_starts,
                                                       mode="counts_only", device=dev)
    seg_runs["S2"] = ops.segmented_radix_sort(keys, s2_starts, device=dev)
    seg_runs["S2 kv"] = ops.segmented_radix_sort(keys, s2_starts, values, device=dev)
    seg_runs["S3"] = ops.segmented_multisplit(ids3_flat, ops.IdentitySpec(64), s3_starts,
                                              method="dms", mode="positions_only", device=dev)
    torch.cuda.synchronize()
    seg_s = time.perf_counter() - t0
    seg_launches = registry.launch_counts()
    peak_seg = torch.cuda.max_memory_allocated() - base_mem
    log("segmented", f"S1 4 multisplits + positions_only + counts_only (n = 2^25, s = 64, m = 32), "
                     f"S2 2 radix sorts (s = 16), S3 routing (n = 2^20, s = 256, m = 64) in "
                     f"{seg_s:.2f} s (first calls); peak device memory above the inputs "
                     f"{peak_seg / 2**30:.2f} GiB")
    want = seg_oracle(keys, s1_starts, spec1, values)
    for (method, kv), got in [(k, v) for k, v in seg_runs.items() if isinstance(k, tuple)]:
        check_result(f"S1 {method} kv={kv}", got, want if kv else want._replace(values=None),
                     ("keys", "values", "bucket_starts", "bucket_counts", "permutation"))
    check_result("S1 positions_only", seg_runs["positions_only"],
                 want._replace(keys=None, values=None),
                 ("keys", "values", "bucket_starts", "bucket_counts", "permutation"))
    check_result("S1 counts_only", seg_runs["counts_only"],
                 want._replace(keys=None, values=None, permutation=None),
                 ("keys", "values", "bucket_starts", "bucket_counts", "permutation"))
    del want
    want_k, want_v = seg_sort_oracle(keys, s2_starts, values)
    if max_err(seg_runs["S2"][0], want_k) or seg_runs["S2"][1] is not None:
        raise AssertionError("S2 segmented_radix_sort keys differ")
    if max_err(seg_runs["S2 kv"][0], want_k) or max_err(seg_runs["S2 kv"][1], want_v):
        raise AssertionError("S2 segmented_radix_sort key-value differs")
    del want_k, want_v
    check_result("S3 routing", seg_runs["S3"],
                 seg_oracle(ids3_flat, s3_starts, ops.IdentitySpec(64))._replace(keys=None),
                 ("keys", "values", "bucket_starts", "bucket_counts", "permutation"))
    del seg_runs
    log("segmented", "S1 (bms, dms, key-only, key-value, positions_only, counts_only), S2 and S3 "
                     "are bitwise equal to the stable-sort oracle")
    for name, count in seg_launches.items():
        log("launches", f"segmented path: {name}: {count}")
    # S1: K1s in each of the 6 calls, K2s in the 2 bms calls, K3s in the 2
    # dms calls and positions_only; S2: K1s and K2s once a pass, 2 x 4
    # passes; S3: K1s and K3s once
    seg_expect = {name: 0 for name in expect}
    seg_expect.update({"seg_spec_tile_histograms": 6 + 8 + 1,
                       "seg_spec_fused_postscan_reorder": 2 + 8,
                       "seg_spec_tile_positions": 3 + 1})
    if seg_launches != seg_expect:
        raise AssertionError(f"segmented launch counts {seg_launches} != expected {seg_expect}")
    for name, count in seg_launches.items():
        launches[name] = launches.get(name, 0) + count

    # ---- 5c. the flat callable path: a programmer's bucket functions (and
    # off-width keys in the partial modes) at n = 2^25, through the ids kernels
    def sssp_fn(floor, delta, m):
        """The delta-stepping bucket of examples/sssp.py: clip((u - floor) //
        delta, 0, m - 1), returned as int64 as a user's function may."""
        return lambda u: torch.clamp((u.long() - floor) // delta, 0, m - 1)

    def hash_fn(bits_):
        """A multiplicative (Fibonacci) hash of the 32-bit word into 2^bits
        buckets, which no declarative spec expresses."""
        return lambda u: (((bits(u).long() & 0xFFFFFFFF) * 2654435761) & 0xFFFFFFFF) >> (32 - bits_)

    # int32 distances around the delta-stepping window, vertex ids as values
    floor, delta, m_sssp = 1 << 20, 1 << 16, 10
    dist = torch.randint(floor - (1 << 18), floor + delta * (m_sssp + 2), (N_MAIN,),
                         dtype=torch.int32, device=dev, generator=gen)
    verts = torch.randperm(N_MAIN, dtype=torch.int32, device=dev, generator=gen)
    sssp = ops.from_fn(sssp_fn(floor, delta, m_sssp), m_sssp, "sssp")
    hashes = {m: ops.from_fn(hash_fn(m.bit_length() - 1), m, f"hash{m}") for m in (2, 32, 256)}
    keys16 = (keys.view(torch.int32) >> 16).to(torch.int16)
    keys64 = keys.view(torch.int32).long() * 3
    spec16, spec64 = ops.DeltaSpec(16, 1 << 15), ops.DeltaSpec(256, 1 << 32)
    torch.cuda.synchronize()
    registry.reset_launches()
    t0 = time.perf_counter()
    cruns = {}
    for method in ("wms", "bms"):
        cruns[("sssp", method)] = ops.multisplit(dist, sssp, verts, method=method, device=dev)
    for m, spec in hashes.items():
        for method in ("bms", "dms"):
            cruns[(m, method, False)] = ops.multisplit(keys, spec, method=method, device=dev)
            cruns[(m, method, True)] = ops.multisplit(keys, spec, values, method=method, device=dev)
        cruns[(m, "counts_only")] = ops.multisplit(keys, spec, mode="counts_only", device=dev)
        cruns[(m, "positions_only")] = ops.multisplit(keys, spec, mode="positions_only",
                                                      device=dev)
    for name, k, spec in (("int16", keys16, spec16), ("int64", keys64, spec64)):
        cruns[(name, "hist")] = ops.histogram(k, spec, device=dev)
        cruns[(name, "positions_only")] = ops.multisplit(k, spec, mode="positions_only",
                                                         device=dev)
    # the kernel doors: even-width labels written out, then their histogram
    from repro_torch.kernels import ops as kops

    even = ops.EvenSpec(0.0, float(1 << 32), 256)
    cruns["door"] = kops.device_histogram(kops.even_bucket_ids(keys.view(l_main, t_main), 0.0,
                                                               float(1 << 32), 256), 256)
    torch.cuda.synchronize()
    callable_s = time.perf_counter() - t0
    call_launches = registry.launch_counts()
    log("callable", f"n = 2^25: 2 delta-stepping multisplits (m = 10, int32 distances, vertex-id "
                    f"values), 18 hash multisplits (m = 2, 32, 256), int16 and int64 keys through "
                    f"histogram and positions_only, the even-ids door: {callable_s:.2f} s "
                    f"(first calls)")
    for method in ("wms", "bms"):
        check_result(f"sssp {method}", cruns[("sssp", method)],
                     rb_sort_multisplit(dist, sssp, verts), fields)
    for m, spec in hashes.items():
        want = rb_sort_multisplit(keys, spec, values)
        for method in ("bms", "dms"):
            check_result(f"hash{m} {method}", cruns[(m, method, False)],
                         want._replace(values=None), fields)
            check_result(f"hash{m} {method} kv", cruns[(m, method, True)], want, fields)
        check_result(f"hash{m} counts_only", cruns[(m, "counts_only")],
                     want._replace(keys=None, values=None, permutation=None), fields)
        check_result(f"hash{m} positions_only", cruns[(m, "positions_only")],
                     want._replace(keys=None, values=None), fields)
        del want
    for name, k, spec in (("int16", keys16, spec16), ("int64", keys64, spec64)):
        want = rb_sort_multisplit(k, spec)
        if max_err(cruns[(name, "hist")], want.bucket_counts):
            raise AssertionError(f"{name} keys: histogram differs")
        check_result(f"{name} positions_only", cruns[(name, "positions_only")],
                     want._replace(keys=None, values=None), fields)
        del want
    if max_err(cruns["door"], torch.bincount(even.emit(keys).long(), minlength=256).to(torch.int32)):
        raise AssertionError("device_histogram(even_bucket_ids) differs from bincount")
    del cruns, keys16, keys64
    log("callable", "every callable multisplit (bms, wms, dms, key-only, key-value, counts_only, "
                    "positions_only), the off-width keys and the door are bitwise equal to the "
                    "stable-sort oracle")
    for name, count in call_launches.items():
        log("launches", f"flat callable path: {name}: {count}")
    # sssp: K1 and K2 on ids twice; each hash m: K1 on ids 6 times, K2 twice
    # (bms), K3 3 times (dms twice, positions_only); each off-width type: K1
    # twice, K3 once; the door: spec_bucket_ids and K1 on ids once
    call_expect = {name: 0 for name in call_launches}
    call_expect.update({"tile_histograms": 2 + 3 * 6 + 2 * 2 + 1,
                        "fused_postscan_reorder": 2 + 3 * 2,
                        "tile_positions": 3 * 3 + 2, "spec_bucket_ids": 1})
    if call_launches != call_expect:
        raise AssertionError(f"callable launch counts {call_launches} != expected {call_expect}")
    for name, count in call_launches.items():
        launches[name] += count


    # ---- 5d. the segmented callable path at S1's shape: 2^25 keys, 64 ragged
    # segments, a hash into 32 buckets (m_eff = 2048)
    hash32 = hashes[32]
    torch.cuda.synchronize()
    registry.reset_launches()
    t0 = time.perf_counter()
    sruns = {}
    for method in ("bms", "dms"):
        sruns[(method, False)] = ops.segmented_multisplit(keys, hash32, s1_starts, method=method,
                                                          device=dev)
        sruns[(method, True)] = ops.segmented_multisplit(keys, hash32, s1_starts, values,
                                                         method=method, device=dev)
    sruns["positions_only"] = ops.segmented_multisplit(keys, hash32, s1_starts,
                                                       mode="positions_only", device=dev)
    sruns["counts_only"] = ops.segmented_multisplit(keys, hash32, s1_starts, mode="counts_only",
                                                    device=dev)
    torch.cuda.synchronize()
    seg_call_s = time.perf_counter() - t0
    seg_call_launches = registry.launch_counts()
    want = seg_oracle(keys, s1_starts, hash32, values)
    for (method, kv), got in [(k, v) for k, v in sruns.items() if isinstance(k, tuple)]:
        check_result(f"S1 callable {method} kv={kv}", got,
                     want if kv else want._replace(values=None), fields)
    check_result("S1 callable positions_only", sruns["positions_only"],
                 want._replace(keys=None, values=None), fields)
    check_result("S1 callable counts_only", sruns["counts_only"],
                 want._replace(keys=None, values=None, permutation=None), fields)
    del want, sruns
    log("callable", f"S1 shape with the hash into 32 buckets: 4 segmented multisplits + "
                    f"positions_only + counts_only in {seg_call_s:.2f} s (first calls), bitwise "
                    f"equal to the stable-sort oracle")
    for name, count in seg_call_launches.items():
        log("launches", f"segmented callable path: {name}: {count}")
    # K1s on ids in each of the 6 calls, K2s on ids in the 2 bms calls, K3s on
    # ids in the 2 dms calls and positions_only
    seg_call_expect = {name: 0 for name in seg_call_launches}
    seg_call_expect.update({"seg_tile_histograms": 6, "seg_fused_postscan_reorder": 2,
                            "seg_tile_positions": 3})
    if seg_call_launches != seg_call_expect:
        raise AssertionError(f"segmented callable launch counts {seg_call_launches} != "
                             f"expected {seg_call_expect}")
    for name, count in seg_call_launches.items():
        launches[name] += count

    # ---- 5e. the packed family's paths (family="packed"), one form each, each
    # with its own launch counts and held bitwise against the stable-sort
    # oracle and against the same call on the default (onehot) family
    sort_key = bits(keys) ^ torch.iinfo(torch.int32).min        # unsigned order as signed
    _, order = torch.sort(sort_key, stable=True)
    sorted_kv = (bits(keys)[order].view(torch.uint32), values[order])
    del order, sort_key
    ref_ms = {}                                  # what -> (packed call, its onehot twin)

    def packed_path(path, calls, expect, oracles):
        """Run ``calls`` (label -> a function of the family) with the packed
        family alone, check the launch counts, then every result against
        its oracle and the onehot family's result."""
        torch.cuda.synchronize()
        registry.reset_launches()
        t0 = time.perf_counter()
        got = {what: fn("packed") for what, fn in calls.items()}
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = registry.launch_counts()
        want = {name: 0 for name in counts}
        want.update(expect)
        if counts != want:
            raise AssertionError(f"packed {path} launch counts {counts} != expected {want}")
        for name, count in counts.items():
            launches[name] += count
            if count:
                log("launches", f"packed {path} path: {name}: {count}")
        for what, fn in calls.items():
            res, onehot = got.pop(what), fn(None)
            if isinstance(res, tuple) and not hasattr(res, "_fields"):        # a sort
                for a, b, c in zip(res, onehot, oracles[what]()):
                    if max_err(a, b) or max_err(a, c):
                        raise AssertionError(f"packed {what} differs from onehot or the oracle")
            elif isinstance(res, torch.Tensor):                                # a histogram
                if max_err(res, onehot) or max_err(res, oracles[what]()):
                    raise AssertionError(f"packed {what} differs from onehot or the oracle")
            else:
                check_result(f"packed {what}", res, onehot, fields)
                check_result(f"packed {what}", res, oracles[what](), fields)
            ref_ms[what] = fn
        log("packed", f"{path}: {len(calls)} calls in {secs:.2f} s (first calls), every one bitwise "
                      f"equal to the onehot family and to the stable-sort oracle")

    flat_calls, flat_oracles = {}, {}
    for m in (8, 32, 256):
        spec_m = main_spec(m)
        want_m = functools.lru_cache(None)(lambda spec_m=spec_m: rb_sort_multisplit(keys, spec_m, values))
        flat_calls[f"multisplit kv bms m={m}"] = (
            lambda fam, spec_m=spec_m: ops.multisplit(keys, spec_m, values, method="bms", family=fam,
                                                      device=dev))
        flat_oracles[f"multisplit kv bms m={m}"] = want_m
        flat_calls[f"multisplit dms m={m}"] = (
            lambda fam, spec_m=spec_m: ops.multisplit(keys, spec_m, method="dms", family=fam,
                                                      device=dev))
        flat_oracles[f"multisplit dms m={m}"] = lambda want_m=want_m: want_m()._replace(values=None)
        flat_calls[f"histogram m={m}"] = (
            lambda fam, spec_m=spec_m: ops.histogram(keys, spec_m, family=fam, device=dev))
        flat_oracles[f"histogram m={m}"] = lambda want_m=want_m: want_m().bucket_counts
    flat_calls["radix_sort kv r=8"] = lambda fam: ops.radix_sort(keys, values, family=fam, device=dev)
    flat_oracles["radix_sort kv r=8"] = lambda: sorted_kv
    # per m: K1p in 3 calls, K2p in the bms call, K3p in the dms call; the
    # sort: K1p and K2p once a pass, 4 passes
    packed_path("flat (labels in the kernels)", flat_calls,
                {"packed_tile_histograms": 3 * 3 + 4, "packed_fused_postscan_reorder": 3 + 4,
                 "packed_tile_positions": 3}, flat_oracles)
    del flat_calls, flat_oracles

    s1_want = functools.lru_cache(None)(lambda: seg_oracle(keys, s1_starts, spec1, values))
    seg_calls = {
        "S1 segmented_multisplit kv bms": lambda fam: ops.segmented_multisplit(
            keys, spec1, s1_starts, values, method="bms", family=fam, device=dev),
        "S2 segmented_radix_sort kv": lambda fam: ops.segmented_radix_sort(
            keys, s2_starts, values, family=fam, device=dev),
        "S3 routing positions_only": lambda fam: ops.segmented_multisplit(
            ids3_flat, ops.IdentitySpec(64), s3_starts, method="dms", mode="positions_only",
            family=fam, device=dev),
    }
    seg_oracles = {
        "S1 segmented_multisplit kv bms": s1_want,
        "S2 segmented_radix_sort kv": lambda: seg_sort_oracle(keys, s2_starts, values),
        "S3 routing positions_only": lambda: seg_oracle(ids3_flat, s3_starts, ops.IdentitySpec(64))._replace(keys=None),
    }
    # S1: K1p, K2p; S2: K1p and K2p once a pass; S3: K1p, K3p
    packed_path("segmented (labels in the kernels)", seg_calls,
                {"packed_tile_histograms": 1 + 4 + 1, "packed_fused_postscan_reorder": 1 + 4,
                 "packed_tile_positions": 1}, seg_oracles)
    del seg_calls, seg_oracles

    h32_want = functools.lru_cache(None)(lambda: rb_sort_multisplit(keys, hash32, values))
    call_calls = {
        "hash32 multisplit kv bms": lambda fam: ops.multisplit(keys, hash32, values, method="bms",
                                                               family=fam, device=dev),
        "hash32 multisplit dms": lambda fam: ops.multisplit(keys, hash32, method="dms", family=fam,
                                                            device=dev),
        "hash32 histogram": lambda fam: ops.histogram(keys, hash32, family=fam, device=dev),
    }
    call_oracles = {
        "hash32 multisplit kv bms": h32_want,
        "hash32 multisplit dms": lambda: h32_want()._replace(values=None),
        "hash32 histogram": lambda: h32_want().bucket_counts,
    }
    packed_path("flat callable (ids strip)", call_calls,
                {"packed_tile_histograms": 3, "packed_fused_postscan_reorder": 1,
                 "packed_tile_positions": 1}, call_oracles)
    del call_calls, call_oracles, h32_want

    s1h_want = functools.lru_cache(None)(lambda: seg_oracle(keys, s1_starts, hash32, values))
    segc_calls = {
        "S1 hash32 segmented_multisplit kv bms": lambda fam: ops.segmented_multisplit(
            keys, hash32, s1_starts, values, method="bms", family=fam, device=dev),
        "S1 hash32 positions_only": lambda fam: ops.segmented_multisplit(
            keys, hash32, s1_starts, method="dms", mode="positions_only", family=fam, device=dev),
    }
    segc_oracles = {
        "S1 hash32 segmented_multisplit kv bms": s1h_want,
        "S1 hash32 positions_only": lambda: s1h_want()._replace(keys=None, values=None),
    }
    packed_path("segmented callable (ids strip)", segc_calls,
                {"packed_tile_histograms": 2, "packed_fused_postscan_reorder": 1,
                 "packed_tile_positions": 1}, segc_oracles)
    del segc_calls, segc_oracles, s1h_want, s1_want, sorted_kv

    # ---- 5f. the fused two-digit paths (fuse_digits=True), each call with its
    # own launch counts, each result held bitwise against the unfused sort and
    # a stable torch.sort: F1 radix_sort r = 8 at n = 2^25 (two 16-bit pairs:
    # key-value bms, key-only dms, the packed family), F2 r = 7 at 2^22 (two
    # 14-bit pairs and a 4-bit single pass), F3 segmented_radix_sort over 16
    # ragged segments at 2^22
    def h_bytes(n_keys, s_, bits_):
        """The size of one pair's H: L tiles of the fused tile, s·m² columns."""
        return 4 * (-(-n_keys // t_fused)) * s_ * (1 << bits_)

    def fused_call(path, fn, expect, oracles, h_size):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        registry.reset_launches()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = registry.launch_counts()
        want = {name: 0 for name in counts}
        want.update(expect)
        if counts != want:
            raise AssertionError(f"{path} launch counts {counts} != expected {want}")
        for name, count in counts.items():
            launches[name] += count
            if count:
                log("launches", f"{path}: {name}: {count}")
        for what, oracle in oracles.items():
            for a, b in zip(res, oracle):
                if max_err(a, b):
                    raise AssertionError(f"{path} differs from {what}")
        log("fused", f"{path}: {secs:.2f} s (first call); H {h_size / 2**30:.2f} GiB a pair; peak "
                     f"device memory above its inputs {(torch.cuda.max_memory_allocated() - before) / 2**30:.2f} "
                     f"GiB; bitwise equal to {' and '.join(oracles)}")
        return res

    def stable_sort(k, v=None):
        _, order = torch.sort(bits(k) ^ torch.iinfo(torch.int32).min, stable=True)
        return bits(k)[order].view(k.dtype), None if v is None else v[order]

    want_sort = stable_sort(keys, values)
    unfused = ops.radix_sort(keys, values, device=dev)
    k1f, k2f, k3f = "fused2_tile_histograms", "fused2_fused_postscan_reorder", "fused2_tile_positions"
    h_f1 = h_bytes(N_MAIN, 1, 16)
    fused_call("F1 radix_sort kv bms r=8, fuse_digits", lambda: ops.radix_sort(
        keys, values, radix_bits=8, fuse_digits=True, device=dev), {k1f: 2, k2f: 2},
        {"the unfused radix_sort": unfused, "a stable torch.sort": want_sort}, h_f1)
    fused_call("F1 radix_sort dms r=8, fuse_digits, key-only", lambda: ops.radix_sort(
        keys, method="dms", fuse_digits=True, device=dev), {k1f: 2, k3f: 2},
        {"the unfused radix_sort": (unfused[0], None), "a stable torch.sort": (want_sort[0], None)},
        h_f1)
    fused_call("F1 radix_sort kv bms r=8, fuse_digits, family=packed", lambda: ops.radix_sort(
        keys, values, fuse_digits=True, family="packed", device=dev), {k1f: 2, k2f: 2},
        {"the unfused radix_sort": unfused, "a stable torch.sort": want_sort}, h_f1)
    del unfused, want_sort
    keys_s, values_s = keys[:N_FUSED_SMALL], values[:N_FUSED_SMALL]
    fused_call("F2 radix_sort kv bms r=7, fuse_digits, n=2^22", lambda: ops.radix_sort(
        keys_s, values_s, radix_bits=7, fuse_digits=True, device=dev),
        {k1f: 2, k2f: 2, "spec_tile_histograms": 1, "spec_fused_postscan_reorder": 1},
        {"the unfused radix_sort": ops.radix_sort(keys_s, values_s, radix_bits=7, device=dev),
         "a stable torch.sort": stable_sort(keys_s, values_s)}, h_bytes(N_FUSED_SMALL, 1, 14))
    fused_call("F3 segmented_radix_sort kv bms r=8 s=16, fuse_digits, n=2^22",
               lambda: ops.segmented_radix_sort(keys_s, f3_starts, values_s, fuse_digits=True,
                                                device=dev), {k1f: 2, k2f: 2},
               {"the unfused segmented_radix_sort": ops.segmented_radix_sort(
                   keys_s, f3_starts, values_s, device=dev),
                "a stable torch.sort": seg_sort_oracle(keys_s, f3_starts, values_s)},
               h_bytes(N_FUSED_SMALL, 16, 16))
    # ---- 5g. the batched layout: (b, n) rows, each multisplit or sorted on its
    # own in one launch a stage for the whole batch (B1 8 rows of 2^22, the
    # local step of an 8-shard split; B2 256 short rows with ragged tails; B3
    # the batched radix sort), torch.vmap of the ops, one packed and one
    # callable batch; each call with its own launch counts, each row held
    # bitwise against the stable-sort oracle and, for B1, the flat op on it
    from repro_torch.core import multisplit as core_ms
    from repro_torch.core import sort as core_sort

    def counted(what, fn, expect):
        """Run ``fn`` alone with the counts at 0; its launches must be
        ``expect`` exactly. They add to the paths' counts."""
        torch.cuda.synchronize()
        registry.reset_launches()
        res = fn()
        torch.cuda.synchronize()
        counts = registry.launch_counts()
        want = {name: 0 for name in counts}
        want.update(expect)
        if counts != want:
            raise AssertionError(f"{what}: launch counts {counts} != expected {want}")
        for name, count in counts.items():
            launches[name] += count
        return res

    def batch_oracle(kb_, spec_, vb_=None):
        """Every row's multisplit at once: a stable torch.sort of the int64
        key row·m + label; (b, n) data, (b, m) counts, row-local perm."""
        b_, n_ = kb_.shape
        m_ = spec_.num_buckets
        row = torch.arange(b_, device=dev, dtype=torch.int64)[:, None]
        cid = (row * m_ + spec_.emit(kb_).long()).view(-1)
        _, order = torch.sort(cid, stable=True)
        counts = torch.bincount(cid, minlength=b_ * m_).to(torch.int32).view(b_, m_)
        dest = torch.empty(b_ * n_, dtype=torch.int64, device=dev)
        dest[order] = torch.arange(b_ * n_, device=dev)

        def take(x):
            return bits(x).reshape(-1)[order].view(b_, n_).view(x.dtype)

        return ops.MultisplitResult(take(kb_), None if vb_ is None else take(vb_),
                                    st.exclusive_rows(counts), counts,
                                    (dest.view(b_, n_) - row * n_).to(torch.int32))

    def batch_sort_oracle(kb_, vb_):
        b_, n_ = kb_.shape
        row = torch.arange(b_, device=dev, dtype=torch.int64)[:, None]
        _, order = torch.sort(((row << 32) | (bits(kb_).long() & 0xFFFFFFFF)).view(-1), stable=True)
        return tuple(bits(x).reshape(-1)[order].view(b_, n_).view(x.dtype) for x in (kb_, vb_))

    b1 = 8
    kb, vb = keys.view(b1, -1), values.view(b1, -1)
    n_b2 = (1 << 17) + 37
    kb2, vb2 = rand_i32((256, n_b2)).view(torch.uint32), rand_i32((256, n_b2))
    vmap_kv = torch.vmap(ops.multisplit_key_value, in_dims=(0, 0, None))
    vmap_ms = torch.vmap(ops.multisplit, in_dims=(0, None), out_dims=ops.vmap_out_dims())
    vmap_hist = torch.vmap(ops.histogram, in_dims=(0, None))
    k1, k2, k3 = "spec_tile_histograms", "spec_fused_postscan_reorder", "spec_tile_positions"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    n_batched = 0
    for m_ in (32, 256):
        sp = main_spec(m_)
        want = batch_oracle(kb, sp, vb)
        for r in range(b1):
            check_result(f"B1 m={m_} flat op on row {r}", ops.multisplit(kb[r], sp, vb[r], device=dev),
                         ops.MultisplitResult(*(x[r] for x in want)), fields)
        b_calls = [
            ("torch.vmap(multisplit_key_value) bms", lambda: vmap_kv(kb, vb, sp, method="bms",
                                                                      device=dev), {k1: 1, k2: 1}, want),
            ("torch.vmap(multisplit) dms", lambda: vmap_ms(kb, sp, method="dms", device=dev),
             {k1: 1, k3: 1}, want._replace(values=None)),
            ("batched_multisplit kv bms", lambda: core_ms.batched_multisplit(
                kb, sp, vb, method="bms", device=dev), {k1: 1, k2: 1}, want),
            ("batched_multisplit kv dms", lambda: core_ms.batched_multisplit(
                kb, sp, vb, method="dms", device=dev), {k1: 1, k3: 1}, want),
            ("batched_multisplit bms", lambda: core_ms.batched_multisplit(
                kb, sp, method="bms", device=dev), {k1: 1, k2: 1}, want._replace(values=None)),
            ("batched_multisplit dms", lambda: core_ms.batched_multisplit(
                kb, sp, method="dms", device=dev), {k1: 1, k3: 1}, want._replace(values=None)),
            ("batched_multisplit counts_only", lambda: core_ms.batched_multisplit(
                kb, sp, mode="counts_only", device=dev), {k1: 1},
             want._replace(keys=None, values=None, permutation=None)),
            ("batched_multisplit positions_only", lambda: core_ms.batched_multisplit(
                kb, sp, method="dms", mode="positions_only", device=dev), {k1: 1, k3: 1},
             want._replace(keys=None, values=None)),
        ]
        for what, fn, expect, want_ in b_calls:
            check_result(f"B1 m={m_} {what}", counted(f"B1 m={m_} {what}", fn, expect), want_, fields)
            n_batched += 1
        hist_b = counted(f"B1 m={m_} torch.vmap(histogram)", lambda: vmap_hist(kb, sp, device=dev),
                         {k1: 1})
        if max_err(hist_b, want.bucket_counts):
            raise AssertionError(f"B1 m={m_} torch.vmap(histogram) differs")
        n_batched += 1
        del want, hist_b
    want = batch_oracle(kb2, main_spec(32), vb2)
    check_result("B2 batched_multisplit kv bms", counted(
        "B2 batched_multisplit kv bms", lambda: core_ms.batched_multisplit(
            kb2, main_spec(32), vb2, device=dev), {k1: 1, k2: 1}), want, fields)
    check_result("B2 torch.vmap(multisplit) dms", counted(
        "B2 torch.vmap(multisplit) dms", lambda: vmap_ms(kb2, main_spec(32), method="dms", device=dev),
        {k1: 1, k3: 1}), want._replace(values=None), fields)
    del want
    want_sort_b = batch_sort_oracle(kb, vb)
    for what, fn, expect in (
            ("B3 radix_sort kv r=8", lambda: ops.radix_sort(kb, vb, device=dev), {k1: 4, k2: 4}),
            ("B3 radix_sort kv r=8, fuse_digits", lambda: ops.radix_sort(
                kb, vb, fuse_digits=True, device=dev),
             {"fused2_tile_histograms": 2, "fused2_fused_postscan_reorder": 2})):
        for a, b_ in zip(counted(what, fn, expect), want_sort_b):
            if max_err(a, b_):
                raise AssertionError(f"{what} differs from a stable torch.sort of each row")
    del want_sort_b
    check_result("batched packed kv bms", counted(
        "batched packed kv bms", lambda: core_ms.batched_multisplit(
            kb, main_spec(32), vb, family="packed", device=dev),
        {"packed_tile_histograms": 1, "packed_fused_postscan_reorder": 1}),
        batch_oracle(kb, main_spec(32), vb), fields)
    check_result("batched callable kv bms", counted(
        "batched callable kv bms", lambda: core_ms.batched_multisplit(kb, hashes[32], vb, device=dev),
        {"tile_histograms": 1, "fused_postscan_reorder": 1}),
        batch_oracle(kb, hashes[32], vb), fields)
    log("batched", f"B1 (8, 2^22) at m = 32 and 256: {n_batched} batched calls (torch.vmap of "
                   f"multisplit_key_value, multisplit and histogram; batched_multisplit bms and dms, "
                   f"key-only and key-value, counts_only, positions_only), each one K1 and one K2 or "
                   f"K3 for all 8 rows, each row bitwise equal to the flat op on it and to the "
                   f"stable-sort oracle; B2 (256, 2^17 + 37) m = 32, every row with pads; B3 batched "
                   f"radix_sort r = 8, unfused (K1, K2 4 times) and fused (K1f, K2f twice); a packed "
                   f"and a callable batch: all bitwise equal ({time.perf_counter() - t0:.1f} s with "
                   f"the oracles; peak device memory above the inputs "
                   f"{(torch.cuda.max_memory_allocated() - before) / 2**30:.2f} GiB)")

    # ---- 5h. the unfused baselines: multisplit_unfused (K1 and K3 on the ids,
    # then B10 for pass 2 and, key-value, pass 3) and radix_sort_per_pass (one
    # plan round trip a pass), each against the fused plan or radix_sort
    spec256 = main_spec(256)
    u_calls = [
        ("multisplit_unfused kv bms m=256", lambda: core_ms.multisplit_unfused(
            keys, spec256, values, method="bms", device=dev),
         {"tile_histograms": 1, "tile_positions": 1, "tile_reorder": 2},
         lambda: ops.multisplit(keys, spec256, values, method="bms", device=dev)),
        ("multisplit_unfused bms key-only m=256", lambda: core_ms.multisplit_unfused(
            keys, spec256, method="bms", device=dev),
         {"tile_histograms": 1, "tile_positions": 1, "tile_reorder": 1},
         lambda: ops.multisplit(keys, spec256, method="bms", device=dev)),
        ("multisplit_unfused kv dms m=256", lambda: core_ms.multisplit_unfused(
            keys, spec256, values, method="dms", device=dev),
         {"tile_histograms": 1, "tile_positions": 1},
         lambda: ops.multisplit(keys, spec256, values, method="dms", device=dev)),
    ]
    want = rb_sort_multisplit(keys, spec256, values)
    for what, fn, expect, fused_fn in u_calls:
        got = counted(what, fn, expect)
        check_result(f"{what} against the fused plan", got, fused_fn(), fields)
        check_result(what, got, want if got.values is not None else want._replace(values=None), fields)
        del got
    del want
    for what, fn, ref_fn in (
            ("radix_sort_per_pass kv r=8, n=2^25", lambda: core_sort.radix_sort_per_pass(
                keys, values, device=dev), lambda: ops.radix_sort(keys, values, device=dev)),
            ("radix_sort_per_pass kv r=8, (8, 2^22)", lambda: core_sort.radix_sort_per_pass(
                kb, vb, device=dev), lambda: ops.radix_sort(kb, vb, device=dev))):
        for a, b_ in zip(counted(what, fn, {k1: 4, k2: 4}), ref_fn()):
            if max_err(a, b_):
                raise AssertionError(f"{what} differs from radix_sort")
    log("unfused", "multisplit_unfused at n = 2^25, m = 256 (kv bms: K1 and K3 on the ids once, B10 "
                   "twice; key-only bms: B10 once; kv dms: B10 never) and radix_sort_per_pass flat "
                   "and batched: bitwise equal to the fused plan, the stable-sort oracle and "
                   "radix_sort")

    # ---- 5i. attention: the kernel door at the full widths A1-A5, door
    # defaults (blocks of 256), its launches counted alone (one B11 a call, no
    # other kernel); each result against the plain version
    torch.cuda.synchronize()
    registry.reset_launches()
    attn_runs = []
    t0 = time.perf_counter()
    for name, (shape, causal, _, dtypes) in ATTN.items():
        for dt in dtypes:
            q, k, v = attn_inputs(shape, getattr(torch, dt))
            attn_runs.append((f"{name} {dt}", q, k, v, causal,
                              kops.flash_attention(q, k, v, causal=causal)))
    torch.cuda.synchronize()
    attn_s = time.perf_counter() - t0
    counts = registry.launch_counts()
    launches["flash_attention"] = counts.pop("flash_attention")
    if any(counts.values()) or launches["flash_attention"] != len(attn_runs):
        raise AssertionError(f"attention path: flash_attention launched "
                             f"{launches['flash_attention']} times for {len(attn_runs)} calls, "
                             f"other kernels {counts}")
    log("launches", f"attention path: flash_attention: {launches['flash_attention']}")
    for what, q, k, v, causal, out in attn_runs:
        attn_err(f"door, {what}", out, q, k, v, causal)
    del attn_runs, q, k, v, out
    log("attention", f"kernels.ops.flash_attention at A1 (float32, bfloat16), A1n, A2 (bfloat16, "
                     f"float32), A3 (bfloat16, float32), A4 and A5 (bfloat16): {len(ATTN)} shapes, "
                     f"{launches['flash_attention']} calls in {attn_s:.2f} s (first calls), each "
                     f"within the limit of the plain version; max abs err over phases 3h and 5i "
                     f"{attn_max}, worst share of the limit {attn_share}")

    # ---- 5j. the consumers: MoE routing and length bucketing, each with its
    # own launch counts (where S3's host time goes is traced after the times:
    # a torch.profiler session before SDPA's would leave that one no kernels)
    for name, count in consumers_phase(dev, gen, s3_starts, registry, max_err, log).items():
        launches[name] += count

    # ---- 5k. the autotune layer: its searches, its file, its model against
    # the launchers (its launches are search trials, logged apart)
    autotune_phase(dev, gen, registry, max_err, log, smi)

    # ---- 5l. the serving slice at full size, with its own launch counts; 5m.
    # the resilience layer (chaos and a real out-of-memory, not counted)
    serve_counts = serving_phase(dev, registry, max_err, log, smi)
    for name, count in serve_counts.items():
        launches[name] += count
    resilience_phase(dev, gen, s1_starts, registry, max_err, log, smi)

    # ---- 5n. the distributed stage (A12), 5o. the model serving path (A13,
    # dense and MoE), 5p. the other families (A13a, after dbrx has freed
    # its memory) and 5q. training (A13b, after the families have freed
    # theirs), each with its own launch counts
    # 5r. subnormal float32 keys (ROADMAP §C), 5s. the mesh layer (A13c:
    # four gloo ranks on the card, after training has freed its memory) and
    # 5t. the sharded training step (A13d: gloo ranks on the card again)
    # 5u. the dry-run (A17: fake process groups and fake tensors in this
    # process, then a train step on the card against its dry-run)
    for phase in (distributed_phase, model_phase, families_phase, training_phase,
                  subnormal_phase, mesh_phase, train_mesh_phase, dryrun_phase):
        for name, count in phase(dev, registry, log, smi).items():
            launches[name] += count

    for name in launches:
        if launches[name] == 0:
            raise AssertionError(f"{name} was launched on none of the paths")

    # ---- 6. times
    def cuda_ms(fn, reps=7, inner=3) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(inner):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / inner)
        return statistics.median(times)

    spec = main_spec(256)
    m = spec.num_buckets
    kt, vt = keys.view(l_main, t_main), values.view(l_main, t_main)
    g = st.global_scan(mst.spec_tile_histograms_plain(kt, spec))
    cid = (torch.arange(l_main, device=dev, dtype=torch.int32)[:, None] * m + spec.emit(kt)).view(-1)
    n = N_MAIN
    gbytes = 4 * l_main * m
    sort_cid_ms = cuda_ms(lambda: torch.sort(cid, stable=True))
    bincount_ms = cuda_ms(lambda: torch.bincount(cid, minlength=l_main * m))
    # the ids kernels on the same labels, materialised: what the ids path adds
    ids = mst.spec_bucket_ids_plain(kt, spec)
    even = ops.EvenSpec(0.0, float(1 << 32), 256)
    rows = [
        ("spec_tile_histograms", "tile_histograms.cu",
         lambda: mst.spec_tile_histograms(kt, spec),
         lambda: mst.spec_tile_histograms_plain(kt, spec),
         4 * n + gbytes, bincount_ms),
        ("spec_fused_postscan_reorder", "fused_postscan_reorder.cu",
         lambda: mst.spec_fused_postscan_reorder(kt, g, vt, spec),
         lambda: mst.spec_fused_postscan_reorder_plain(kt, g, vt, spec),
         8 * n + gbytes + 16 * n, sort_cid_ms),
        ("spec_tile_positions", "tile_positions.cu",
         lambda: mst.spec_tile_positions(kt, g, spec),
         lambda: mst.spec_tile_positions_plain(kt, g, spec),
         4 * n + gbytes + 4 * n, sort_cid_ms),
        ("tile_histograms", "tile_histograms.cu",
         lambda: mst.tile_histograms(ids, m), lambda: mst.tile_histograms_plain(ids, m),
         4 * n + gbytes, bincount_ms),
        ("fused_postscan_reorder", "fused_postscan_reorder.cu",
         lambda: mst.fused_postscan_reorder(ids, g, kt, vt, m),
         lambda: mst.fused_postscan_reorder_plain(ids, g, kt, vt, m),
         4 * n + 8 * n + gbytes + 16 * n, sort_cid_ms),
        ("tile_positions", "tile_positions.cu",
         lambda: mst.tile_positions(ids, g, m), lambda: mst.tile_positions_plain(ids, g, m),
         4 * n + gbytes + 4 * n, sort_cid_ms),
        # no single PyTorch call computes a spec's labels: library_ms is null
        ("spec_bucket_ids", "spec_bucket_ids.cu",
         lambda: mst.spec_bucket_ids(kt, even), lambda: mst.spec_bucket_ids_plain(kt, even),
         4 * n + 4 * n, None),
        # the packed family: the bytes of K1, K2 and K3 at the same shapes
        ("packed_tile_histograms", "packed_tile_histograms.cu",
         lambda: mst.packed_tile_histograms(kt, spec=spec),
         lambda: mst.packed_tile_histograms_plain(kt, spec=spec), 4 * n + gbytes, bincount_ms),
        ("packed_fused_postscan_reorder", "packed_fused_postscan_reorder.cu",
         lambda: mst.packed_fused_postscan_reorder(kt, g, None, vt, spec=spec),
         lambda: mst.packed_fused_postscan_reorder_plain(kt, g, None, vt, spec=spec),
         8 * n + gbytes + 16 * n, sort_cid_ms),
        ("packed_tile_positions", "packed_tile_positions.cu",
         lambda: mst.packed_tile_positions(kt, g, spec=spec),
         lambda: mst.packed_tile_positions_plain(kt, g, spec=spec), 4 * n + gbytes + 4 * n,
         sort_cid_ms),
        # B10 key-value: ids, keys and values read; keys_r, vals_r and dest
        # written, 24 bytes a key; the yardstick is the postscans' sort
        ("tile_reorder", "tile_reorder.cu",
         lambda: mst.tile_reorder(ids, kt, vt, m), lambda: mst.tile_reorder_plain(ids, kt, vt, m),
         24 * n, sort_cid_ms),
    ]
    kernels = []
    for name, src, kern, plain, nbytes, lib_ms in rows:
        ms_k = cuda_ms(kern)
        ms_p = cuda_ms(plain, reps=3, inner=1)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": registry.replaces(name), "launches": launches[name], "max_abs_err": errs[name],
            "bitwise": errs[name] == 0, "ms": ms_k, "plain_ms": ms_p, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": lib_ms,
        })
        before = f"when added: {FLAT_MS_BEFORE[name]:.4f} ms; " if name in FLAT_MS_BEFORE else ""
        first = {**K1K2_MS_BEFORE, **K3K2S_MS_BEFORE, **K2FK2P_MS_BEFORE, **K1PK3F_MS_BEFORE,
                 **K3PB10_MS_BEFORE}
        if name in first:
            before += f"first design: {first[name]:.4f} ms, now {ms_k / first[name]:.3f}x of it; "
        library = f"{lib_ms:.4f} ms" if lib_ms is not None else "none (no single PyTorch call)"
        label = even if name == "spec_bucket_ids" else spec
        log("times", f"{name}: {ms_k:.4f} ms ({before}bound {bound:.4f} ms = {nbytes / 2**20:.0f} "
                     f"MiB / 3.35 TB/s, {bound / ms_k:.1%} of it), plain {ms_p:.2f} ms, library "
                     f"{library}; {launches[name]} launches on the main paths [n = 2^25, {label}, "
                     f"tiles 8192 x 4096; {smi}]")

    # B10 key-only, as pass 3 of multisplit_unfused launches it: ids, keys
    # read, keys_r and dest written, 16 bytes a key
    b10_ms = cuda_ms(lambda: mst.tile_reorder(ids, vt, None, m))
    b10_bound = 16 * n / HBM_BYTES_PER_S * 1e3
    log("times", f"tile_reorder key-only: {b10_ms:.4f} ms (bound {b10_bound:.4f} ms = "
                 f"{16 * n / 2**20:.0f} MiB / 3.35 TB/s, {b10_bound / b10_ms:.1%} of it) [n = 2^25, "
                 f"m = 256, tiles 8192 x 4096; {smi}]")
    # A8 weighs the families by their kernels in one call
    k3_ms = cuda_ms(lambda: mst.spec_tile_positions(kt, g, spec))
    k3p_ms = cuda_ms(lambda: mst.packed_tile_positions(kt, g, spec=spec))
    log("times", f"K3p / K3 in one call (A8): {k3p_ms:.4f} / {k3_ms:.4f} ms = "
                 f"{k3p_ms / k3_ms:.3f}x [n = 2^25, {spec}, tiles 8192 x 4096; {smi}]")
    k2_ms = next(row["ms"] for row in kernels if row["name"] == "spec_fused_postscan_reorder")
    log("times", f"spec_fused_postscan_reorder with the rank it shares with K3 and K2s "
                 f"(sm90::warp_rank): {k2_ms:.4f} ms, {k2_ms / K2_MS_OWN_RANK:.3f}x its "
                 f"{K2_MS_OWN_RANK:.4f} ms with its own copy (within 5 %: "
                 f"{abs(k2_ms / K2_MS_OWN_RANK - 1) <= 0.05}) [n = 2^25, {spec}, key-value; {smi}]")

    # K1 and K2 key-value where buckets collide: uniform keys at small m,
    # and every key of every tile in one bucket (K1's atomics on one
    # counter a copy, K2's rank all in one run)
    one_bucket = torch.full(kt.shape, 0x7F000000, dtype=torch.int32, device=dev).view(kt.dtype)
    parts = []
    for what, keys_, m_ in (("uniform", kt, 2), ("uniform", kt, 32), ("uniform", kt, 256),
                            ("one bucket", one_bucket, 256)):
        spec_ = main_spec(m_)
        g_ = st.global_scan(mst.spec_tile_histograms(keys_, spec_))
        a = cuda_ms(lambda: mst.spec_tile_histograms(keys_, spec_))
        b = cuda_ms(lambda: mst.spec_fused_postscan_reorder(keys_, g_, vt, spec_))
        parts.append(f"{what} m = {m_}: K1 {a:.4f}, K2 {b:.4f}")
    del one_bucket, g_
    log("times", "K1 / K2 key-value by key spread: " + "; ".join(parts) +
        f" ms [n = 2^25, DeltaSpec(m, 2^32), tiles 8192 x 4096; {smi}]")

    # the two families side by side, kernel by kernel, on the same inputs
    def family_pair(label, onehot_fn, packed_fn) -> str:
        a, b = cuda_ms(onehot_fn), cuda_ms(packed_fn)
        return f"{label} {a:.4f} / {b:.4f} ms ({b / a:.3f}x)"

    for m_ in (8, 32, 256):
        spec_ = main_spec(m_)
        g_ = st.global_scan(mst.spec_tile_histograms(kt, spec_))
        log("times", f"onehot / packed, flat m = {m_}, labels in the kernels: " + "; ".join([
            family_pair("K1 / K1p", lambda: mst.spec_tile_histograms(kt, spec_),
                        lambda: mst.packed_tile_histograms(kt, spec=spec_)),
            family_pair("K3 / K3p", lambda: mst.spec_tile_positions(kt, g_, spec_),
                        lambda: mst.packed_tile_positions(kt, g_, spec=spec_)),
            family_pair("K2 / K2p key-value",
                        lambda: mst.spec_fused_postscan_reorder(kt, g_, vt, spec_),
                        lambda: mst.packed_fused_postscan_reorder(kt, g_, None, vt, spec=spec_)),
        ]) + f" [n = 2^25, tiles 8192 x 4096; {smi}]")
    del g_
    log("times", "onehot / packed, flat m = 256, labels from the ids strip: " + "; ".join([
        family_pair("K1 / K1p", lambda: mst.tile_histograms(ids, m),
                    lambda: mst.packed_tile_histograms(ids, num_buckets=m)),
        family_pair("K3 / K3p", lambda: mst.tile_positions(ids, g, m),
                    lambda: mst.packed_tile_positions(ids, g, num_buckets=m)),
        family_pair("K2 / K2p key-value", lambda: mst.fused_postscan_reorder(ids, g, kt, vt, m),
                    lambda: mst.packed_fused_postscan_reorder(ids, g, kt, vt, num_buckets=m)),
    ]) + f" [n = 2^25, tiles 8192 x 4096; {smi}]")
    del g, cid, ids

    # the segmented kernels at S1's shape: 8192 tiles of 4096, s = 64, m = 32
    s, m1 = 64, spec1.num_buckets
    seg_main = seg_strip(s1_starts, (l_main, t_main))
    hist1 = mst.seg_spec_tile_histograms_plain(kt, seg_main, spec1, s)
    g1 = st.global_scan(hist1)
    # K1s writes its whole (L, s·m) row; K2s and K3s need only the bases
    # their keys hit, one for each distinct (tile, cid): the nonzeros of H.
    # K1s and K3s need a tile's whole strip only where it holds more than one
    # segment run, else its two end ids; K2s stages every strip
    hbytes = 4 * l_main * s * m1
    gbytes_hit = 4 * int(torch.count_nonzero(hist1))
    del hist1
    multi_run = int((seg_main[:, 0] != seg_main[:, -1]).sum())
    strip_bytes = 4 * t_main * multi_run + 8 * (l_main - multi_run)
    log("times", f"S1 strip: {multi_run} of {l_main} tiles hold more than one segment run; "
                 f"K1s and K3s need {strip_bytes / 2**20:.2f} MiB of its {4 * n / 2**20:.0f} MiB")
    cid1 = (torch.arange(l_main, device=dev, dtype=torch.int32)[:, None] * (s * m1)
            + seg_main * m1 + spec1.emit(kt)).view(-1)
    sort1_ms = cuda_ms(lambda: torch.sort(cid1, stable=True))
    log("times", f"G bases the S1 keys hit: {gbytes_hit // 4} of {hbytes // 4} "
                 f"({gbytes_hit / 2**20:.2f} of {hbytes / 2**20:.0f} MiB)")
    bincount1_ms = cuda_ms(lambda: torch.bincount(cid1, minlength=l_main * s * m1))
    ids1 = mst.spec_bucket_ids_plain(kt, spec1)
    seg_rows = [
        ("seg_spec_tile_histograms", "seg_tile_histograms.cu",
         lambda: mst.seg_spec_tile_histograms(kt, seg_main, spec1, s),
         lambda: mst.seg_spec_tile_histograms_plain(kt, seg_main, spec1, s),
         4 * n + strip_bytes + hbytes, bincount1_ms),
        ("seg_spec_fused_postscan_reorder", "seg_fused_postscan_reorder.cu",
         lambda: mst.seg_spec_fused_postscan_reorder(kt, seg_main, g1, vt, spec1, s),
         lambda: mst.seg_spec_fused_postscan_reorder_plain(kt, seg_main, g1, vt, spec1, s),
         4 * n + 4 * n + gbytes_hit + 4 * n + 16 * n, sort1_ms),
        ("seg_spec_tile_positions", "seg_tile_positions.cu",
         lambda: mst.seg_spec_tile_positions(kt, seg_main, g1, spec1, s),
         lambda: mst.seg_spec_tile_positions_plain(kt, seg_main, g1, spec1, s),
         4 * n + strip_bytes + gbytes_hit + 4 * n, sort1_ms),
        # the ids kernels on the same labels, materialised
        ("seg_tile_histograms", "seg_tile_histograms.cu",
         lambda: mst.seg_tile_histograms(ids1, seg_main, m1, s),
         lambda: mst.seg_tile_histograms_plain(ids1, seg_main, m1, s),
         4 * n + strip_bytes + hbytes, bincount1_ms),
        ("seg_fused_postscan_reorder", "seg_fused_postscan_reorder.cu",
         lambda: mst.seg_fused_postscan_reorder(ids1, seg_main, g1, kt, vt, m1, s),
         lambda: mst.seg_fused_postscan_reorder_plain(ids1, seg_main, g1, kt, vt, m1, s),
         4 * n + 4 * n + 4 * n + gbytes_hit + 4 * n + 16 * n, sort1_ms),
        ("seg_tile_positions", "seg_tile_positions.cu",
         lambda: mst.seg_tile_positions(ids1, seg_main, g1, m1, s),
         lambda: mst.seg_tile_positions_plain(ids1, seg_main, g1, m1, s),
         4 * n + strip_bytes + gbytes_hit + 4 * n, sort1_ms),
    ]
    for name, src, kern, plain, nbytes, lib_ms in seg_rows:
        ms_k = cuda_ms(kern)
        ms_p = cuda_ms(plain, reps=3, inner=1)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": registry.replaces(name), "launches": launches[name], "max_abs_err": errs[name],
            "bitwise": errs[name] == 0, "ms": ms_k, "plain_ms": ms_p, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": lib_ms,
        })
        first = {**K3K2S_MS_BEFORE, **K1SK3S_MS_BEFORE}
        before = (f"first design: {first[name]:.4f} ms, now {ms_k / first[name]:.3f}x of it; "
                  if name in first else "")
        if name in K1SK3S_MS_BEFORE:
            # the bound of the first design's table: the whole strip read
            whole = (nbytes - strip_bytes + 4 * n) / HBM_BYTES_PER_S * 1e3
            before += (f"with the whole strip read the bound would be {whole:.4f} ms, "
                       f"{whole / ms_k:.1%} of it; ")
        log("times", f"{name}: {ms_k:.4f} ms ({before}bound {bound:.4f} ms = {nbytes / 2**20:.0f} "
                     f"MiB / 3.35 TB/s, {bound / ms_k:.1%} of it), plain {ms_p:.2f} ms, library "
                     f"{lib_ms:.4f} ms; {launches[name]} launches on the segmented paths "
                     f"[S1: n = 2^25, s = 64, {spec1}, m_eff = 2048, tiles 8192 x 4096; {smi}]")
    # K2s where a tile holds hundreds of runs: one- to eight-key segments, one
    # warp a run
    tshape = (64, 4096)
    tlens = np_rng.integers(1, 9, tshape[0] * tshape[1])
    tstarts = np.cumsum(tlens) - tlens
    tstarts = tstarts[tstarts < tshape[0] * tshape[1]].astype(np.int32)
    tseg, tk, tv = seg_strip(tstarts, tshape), kt[: tshape[0]], vt[: tshape[0]]
    tspec = main_spec(256)
    thist = mst.seg_spec_tile_histograms_plain(tk, tseg, tspec, tstarts.size)
    tg = st.global_scan(thist)
    tiny_ms = cuda_ms(lambda: mst.seg_spec_fused_postscan_reorder(tk, tseg, tg, tv, tspec,
                                                                  tstarts.size))
    # the bytes of S1's row: 28 a key-value pair and the G bases the keys hit
    tiny_bound = (28 * tk.numel() + 4 * int(torch.count_nonzero(thist))) / HBM_BYTES_PER_S * 1e3
    log("times", f"seg_spec_fused_postscan_reorder key-value over {tstarts.size} one- to "
                 f"eight-key segments ({tshape[0]} x {tshape[1]}, {tspec}, about "
                 f"{tstarts.size // tshape[0]} runs a tile): {tiny_ms:.4f} ms (bound "
                 f"{tiny_bound:.4f} ms, {tiny_bound / tiny_ms:.1%} of it) [{smi}]")
    del thist, tseg, tg
    # the flat kernels at S1's m and keys: what the segment layer adds
    g32 = st.global_scan(mst.spec_tile_histograms_plain(kt, spec1))
    same_m = {
        "K1": cuda_ms(lambda: mst.spec_tile_histograms(kt, spec1)),
        "K2 key-value": cuda_ms(lambda: mst.spec_fused_postscan_reorder(kt, g32, vt, spec1)),
        "K3": cuda_ms(lambda: mst.spec_tile_positions(kt, g32, spec1)),
    }
    log("times", "flat kernels at S1's m = 32 on the same keys: " + "; ".join(
        f"{k} {v:.4f} ms" for k, v in same_m.items()) + f" [{smi}]")
    seg_kw = dict(seg_tiled=seg_main, num_segments=s)
    log("times", "onehot / packed at S1, labels in the kernels: " + "; ".join([
        family_pair("K1s / K1p", lambda: mst.seg_spec_tile_histograms(kt, seg_main, spec1, s),
                    lambda: mst.packed_tile_histograms(kt, spec=spec1, **seg_kw)),
        family_pair("K3s / K3p", lambda: mst.seg_spec_tile_positions(kt, seg_main, g1, spec1, s),
                    lambda: mst.packed_tile_positions(kt, g1, spec=spec1, **seg_kw)),
        family_pair("K2s / K2p key-value",
                    lambda: mst.seg_spec_fused_postscan_reorder(kt, seg_main, g1, vt, spec1, s),
                    lambda: mst.packed_fused_postscan_reorder(kt, g1, None, vt, spec=spec1,
                                                              **seg_kw)),
    ]) + f" [S1: n = 2^25, s = 64, m = 32, tiles 8192 x 4096; {smi}]")
    log("times", "onehot / packed at S1, labels from the ids strip: " + "; ".join([
        family_pair("K1s / K1p", lambda: mst.seg_tile_histograms(ids1, seg_main, m1, s),
                    lambda: mst.packed_tile_histograms(ids1, num_buckets=m1, **seg_kw)),
        family_pair("K3s / K3p", lambda: mst.seg_tile_positions(ids1, seg_main, g1, m1, s),
                    lambda: mst.packed_tile_positions(ids1, g1, num_buckets=m1, **seg_kw)),
        family_pair("K2s / K2p key-value",
                    lambda: mst.seg_fused_postscan_reorder(ids1, seg_main, g1, kt, vt, m1, s),
                    lambda: mst.packed_fused_postscan_reorder(ids1, g1, kt, vt, num_buckets=m1,
                                                              **seg_kw)),
    ]) + f" [S1: n = 2^25, s = 64, m = 32, tiles 8192 x 4096; {smi}]")
    # K3p at S1 against the bytes its contract forces, as K3s's bound counts
    # them (a one-run tile's strip read at its two end ids), and K3s in the
    # same call (A8)
    k3s_ms = cuda_ms(lambda: mst.seg_spec_tile_positions(kt, seg_main, g1, spec1, s))
    k3p1_ms = cuda_ms(lambda: mst.packed_tile_positions(kt, g1, spec=spec1, **seg_kw))
    k3p1_bound = (4 * n + strip_bytes + gbytes_hit + 4 * n) / HBM_BYTES_PER_S * 1e3
    k3p1_whole = (4 * n + 4 * n + gbytes_hit + 4 * n) / HBM_BYTES_PER_S * 1e3
    log("times", f"packed_tile_positions at S1: {k3p1_ms:.4f} ms (bound {k3p1_bound:.4f} ms with a "
                 f"one-run tile's strip read at its two ends, {k3p1_bound / k3p1_ms:.1%} of it; "
                 f"with the whole strip {k3p1_whole:.4f} ms); K3p / K3s in one call (A8): "
                 f"{k3p1_ms:.4f} / {k3s_ms:.4f} ms = {k3p1_ms / k3s_ms:.3f}x [S1: n = 2^25, s = 64, "
                 f"m = 32, tiles 8192 x 4096; {smi}]")
    del cid1, g1, g32, ids1, seg_kw

    # the fused two-digit kernels at F1's shapes: 2^25 keys in 4096 tiles of
    # 8192, the pair (0, 16, 8), G of (4096, 65536)
    kt8, vt8 = keys.view(-1, t_fused), values.view(-1, t_fused)
    l8, spec16 = kt8.shape[0], ops.BitfieldSpec(0, 16)
    hist16 = mst.fused2_tile_histograms_plain(kt8, spec=spec16)
    g16 = st.global_scan(hist16)
    h16_bytes = 4 * hist16.numel()
    nnz16 = int(torch.count_nonzero(hist16))             # the G bases the keys hit
    del hist16
    cid16 = (torch.arange(l8, device=dev, dtype=torch.int64)[:, None] * 65536
             + spec16.emit(kt8).long()).view(-1)
    # at sector grain: the 32-byte sectors of the G rows (8 bases each, rows
    # of 65536 bases) that the keys hit
    sectors16 = int(torch.unique(cid16 >> 3).numel())
    sort16_ms = cuda_ms(lambda: torch.sort(cid16, stable=True))
    bincount16_ms = cuda_ms(lambda: torch.bincount(cid16, minlength=l8 * 65536))
    del cid16
    log("times", f"fused2 at F1's shape: H {h16_bytes / 2**30:.2f} GiB, {nnz16} of its "
                 f"{h16_bytes // 4} bases hit by the keys, in {sectors16} of its "
                 f"{h16_bytes // 32} 32-byte sectors ({sectors16 / l8:.1f} of a row's 8192)")
    fkw = dict(spec=spec16, split=8)
    # K1f segmented at F3's shape too: 2^22 keys over 16 ragged segments,
    # the keys, their segment ids and the (512, 16·65536) H moved once
    kt_f3, seg_f3 = keys.view(-1)[:N_FUSED_SMALL].view(shape_small), seg_strip(f3_starts, shape_small)
    k1f_f3_ms = cuda_ms(lambda: mst.fused2_tile_histograms(kt_f3, seg_f3, spec=spec16,
                                                           num_segments=16))
    k1f_f3_bound = (8 * N_FUSED_SMALL + 4 * shape_small[0] * 16 * 65536) / HBM_BYTES_PER_S * 1e3
    del kt_f3, seg_f3
    fused_rows = [
        ("fused2_tile_histograms", "fused2_tile_histograms.cu",
         lambda: mst.fused2_tile_histograms(kt8, spec=spec16),
         lambda: mst.fused2_tile_histograms_plain(kt8, spec=spec16), 4 * n + h16_bytes,
         bincount16_ms),
        ("fused2_fused_postscan_reorder", "fused2_fused_postscan_reorder.cu",
         lambda: mst.fused2_fused_postscan_reorder(kt8, g16, vt8, **fkw),
         lambda: mst.fused2_fused_postscan_reorder_plain(kt8, g16, vt8, **fkw),
         8 * n + 4 * nnz16 + 16 * n, sort16_ms),
        ("fused2_tile_positions", "fused2_tile_positions.cu",
         lambda: mst.fused2_tile_positions(kt8, g16, **fkw),
         lambda: mst.fused2_tile_positions_plain(kt8, g16, **fkw), 4 * n + 4 * nnz16 + 4 * n,
         sort16_ms),
    ]
    for name, src, kern, plain, nbytes, lib_ms in fused_rows:
        ms_k = cuda_ms(kern)
        ms_p = cuda_ms(plain, reps=3, inner=1)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": registry.replaces(name), "launches": launches[name], "max_abs_err": errs[name],
            "bitwise": errs[name] == 0, "ms": ms_k, "plain_ms": ms_p, "bound_ms": bound,
            "bound_by": "bytes", "library_ms": lib_ms,
        })
        extra = ""
        if name in ("fused2_fused_postscan_reorder", "fused2_tile_positions"):
            # the G reads at sector grain: 32 bytes a sector the keys hit,
            # beside the keys read (and values) and the outputs written
            sector_bytes = nbytes - 4 * nnz16 + 32 * sectors16
            kernels[-1]["sector_bound_ms"] = sector_bytes / HBM_BYTES_PER_S * 1e3
            before = {**K2FK2P_MS_BEFORE, **K1PK3F_MS_BEFORE}[name]
            extra = (f"; first design {before:.4f} ms, now {ms_k / before:.3f}x of it; bound at "
                     f"sector grain {kernels[-1]['sector_bound_ms']:.4f} ms = "
                     f"{sector_bytes / 2**20:.0f} MiB / 3.35 TB/s, "
                     f"{kernels[-1]['sector_bound_ms'] / ms_k:.1%} of it")
        log("times", f"{name}: {ms_k:.4f} ms (bound {bound:.4f} ms = {nbytes / 2**20:.0f} MiB "
                     f"/ 3.35 TB/s, {bound / ms_k:.1%} of it{extra}), plain {ms_p:.2f} ms, library "
                     f"{lib_ms:.4f} ms ({ms_k / lib_ms:.3f}x of it); {launches[name]} launches on "
                     f"the fused paths [F1: n = 2^25, pair (0, 16, 8), sub_bits {mst.CUDA_SUB_BITS}, "
                     f"onehot, tiles {l8} x {t_fused}; {smi}]")
    k1f_f1_ms = next(row["ms"] for row in kernels if row["name"] == "fused2_tile_histograms")
    log("times", f"fused2_tile_histograms against before (global atomics): F1 {k1f_f1_ms:.4f} ms "
                 f"(before {K1F_MS_BEFORE['F1']:.4f} ms, {k1f_f1_ms / K1F_MS_BEFORE['F1']:.3f}x of "
                 f"it); segmented at F3 (2^22 keys, 16 segments, tiles {shape_small[0]} x {t_fused}) "
                 f"{k1f_f3_ms:.4f} ms (before {K1F_MS_BEFORE['F3']:.4f} ms, "
                 f"{k1f_f3_ms / K1F_MS_BEFORE['F3']:.3f}x of it; bound {k1f_f3_bound:.4f} ms, "
                 f"{k1f_f3_bound / k1f_f3_ms:.1%} of it) [{smi}]")
    # the stage width and the family, K2f and K3f on the same inputs
    for fam in ("onehot", "packed"):
        parts = []
        for label, fn in (("K2f key-value", lambda sb: mst.fused2_fused_postscan_reorder(
                                 kt8, g16, vt8, family=fam, sub_bits=sb, **fkw)),
                          ("K3f", lambda sb: mst.fused2_tile_positions(
                                 kt8, g16, family=fam, sub_bits=sb, **fkw))):
            a, b = cuda_ms(lambda: fn(4)), cuda_ms(lambda: fn(8))
            parts.append(f"{label} {a:.4f} / {b:.4f} ms ({b / a:.3f}x)")
        log("times", f"fused2 sub_bits 4 / 8, {fam}: " + "; ".join(parts)
            + f" [F1: n = 2^25, tiles {l8} x {t_fused}; {smi}]")
    del g16

    top8 = ops.from_fn(lambda u: (bits(u) >> 24) & 255, 256, "top8")
    check_result("top-byte callable against DeltaSpec(256, 2^32)",
                 ops.multisplit(keys, top8, values, device=dev),
                 ops.multisplit(keys, spec, values, device=dev), fields)
    e2e = {
        "multisplit kv bms m=256": (lambda: ops.multisplit(keys, spec, values, method="bms", device=dev),
                                    lambda: rb_sort_multisplit(keys, spec, values)),
        "multisplit bms m=256": (lambda: ops.multisplit(keys, spec, method="bms", device=dev),
                                 lambda: rb_sort_multisplit(keys, spec)),
        "multisplit dms m=32": (lambda: ops.multisplit(keys, main_spec(32), method="dms", device=dev),
                                lambda: rb_sort_multisplit(keys, main_spec(32))),
        "multisplit kv dms m=256": (lambda: ops.multisplit(keys, spec, values, method="dms", device=dev),
                                    lambda: rb_sort_multisplit(keys, spec, values)),
        "multisplit positions_only m=256": (
            lambda: ops.multisplit(keys, spec, mode="positions_only", device=dev),
            lambda: rb_sort_multisplit(keys, spec)),
        "histogram m=256": (lambda: ops.histogram(keys, spec, device=dev),
                            lambda: torch.bincount(spec.emit(keys).long(), minlength=m)),
        "radix_sort r=8": (lambda: ops.radix_sort(keys, device=dev),
                           lambda: torch.sort(bits(keys) ^ torch.iinfo(torch.int32).min, stable=True)),
        "radix_sort kv r=8": (lambda: ops.radix_sort(keys, values, device=dev),
                              lambda: torch.sort(bits(keys) ^ torch.iinfo(torch.int32).min, stable=True)),
        # the escape hatch: DeltaSpec(256, 2^32)'s labels (the top byte) as a callable
        "multisplit kv bms m=256, the same labels as a callable": (
            lambda: ops.multisplit(keys, top8, values, method="bms", device=dev),
            lambda: rb_sort_multisplit(keys, spec, values)),
        "multisplit kv bms m=256, hash callable": (
            lambda: ops.multisplit(keys, hashes[256], values, method="bms", device=dev),
            lambda: rb_sort_multisplit(keys, hashes[256], values)),
        "delta-stepping multisplit kv wms m=10 (callable)": (
            lambda: ops.multisplit(dist, sssp, verts, method="wms", device=dev),
            lambda: rb_sort_multisplit(dist, sssp, verts)),
        "histogram m=256, hash callable": (
            lambda: ops.histogram(keys, hashes[256], device=dev),
            lambda: torch.bincount(hashes[256].emit(keys).long(), minlength=256)),
    }
    s1_t = torch.from_numpy(s1_starts).to(dev)
    s2_t = torch.from_numpy(s2_starts).to(dev)
    s3_t = torch.from_numpy(s3_starts).to(dev)

    def combined_sort(k, starts_t, spec_):
        seg = st.segment_ids_from_starts(starts_t, k.shape[0])
        return torch.sort(seg.long() * spec_.num_buckets + spec_.emit(k).long(), stable=True)

    def seg_key_sort(k, starts_t):
        seg = st.segment_ids_from_starts(starts_t, k.shape[0])
        return torch.sort((seg.long() << 32) | (bits(k).long() & 0xFFFFFFFF), stable=True)

    e2e.update({
        "S1 segmented_multisplit kv bms s=64 m=32": (
            lambda: ops.segmented_multisplit(keys, spec1, s1_t, values, method="bms", device=dev),
            lambda: combined_sort(keys, s1_t, spec1)),
        "S1 segmented_multisplit kv dms s=64 m=32": (
            lambda: ops.segmented_multisplit(keys, spec1, s1_t, values, method="dms", device=dev),
            lambda: combined_sort(keys, s1_t, spec1)),
        "S1 segmented_multisplit kv bms s=64 m=32, hash callable": (
            lambda: ops.segmented_multisplit(keys, hash32, s1_t, values, method="bms", device=dev),
            lambda: combined_sort(keys, s1_t, hash32)),
        "S2 segmented_radix_sort s=16 r=8": (
            lambda: ops.segmented_radix_sort(keys, s2_t, device=dev),
            lambda: seg_key_sort(keys, s2_t)),
        "S2 segmented_radix_sort kv s=16 r=8": (
            lambda: ops.segmented_radix_sort(keys, s2_t, values, device=dev),
            lambda: seg_key_sort(keys, s2_t)),
        "S3 routing positions_only s=256 m=64 n=2^20": (
            lambda: ops.segmented_multisplit(ids3_flat, ops.IdentitySpec(64), s3_t, method="dms",
                                             mode="positions_only", device=dev),
            lambda: combined_sort(ids3_flat, s3_t, ops.IdentitySpec(64))),
        # the serving step's own input: starts as a host numpy array
        "S3 routing, host starts": (
            lambda: ops.segmented_multisplit(ids3_flat, ops.IdentitySpec(64), s3_starts,
                                             method="dms", mode="positions_only", device=dev),
            lambda: combined_sort(ids3_flat, s3_t, ops.IdentitySpec(64))),
    })
    torch.cuda.reset_peak_memory_stats()
    for what, (fn, lib) in e2e.items():
        ms_e, ms_l = cuda_ms(fn, reps=5, inner=1), cuda_ms(lib, reps=5, inner=1)
        n_keys = n3 if what.startswith("S3") else n
        log("times", f"end to end {what}: {ms_e:.3f} ms = {n_keys / ms_e / 1e6:.2f} Gkeys/s; "
                     f"library (stable torch.sort / bincount; for S1-S3 the oracle's sort of the "
                     f"combined key) {ms_l:.3f} ms [{smi}]")
    # the two families end to end, in turns on the same inputs
    for what, fn in ref_ms.items():
        ms_o = cuda_ms(lambda: fn(None), reps=5, inner=1)
        ms_p = cuda_ms(lambda: fn("packed"), reps=5, inner=1)
        n_keys = n3 if what.startswith("S3") else n
        log("times", f"end to end onehot / packed, {what}: {ms_o:.3f} / {ms_p:.3f} ms "
                     f"({ms_p / ms_o:.3f}x) = {n_keys / ms_o / 1e6:.2f} / {n_keys / ms_p / 1e6:.2f} "
                     f"Gkeys/s [{smi}]")
    # where the time of one key-value bms multisplit (m = 256) goes, stage by stage
    from repro_torch.core.pipeline import make_plan

    plan = make_plan(n, m, method="bms", key_value=True, backend="cuda", bucket_fn=spec)
    hist = plan.prescan(kt, None)
    g = st.global_scan(hist)
    src_k, src_v, pos, _ = plan.postscan(g, kt, None, vt)
    stage_ms = {
        "prescan K1": cuda_ms(lambda: plan.prescan(kt, None)),
        "global scan": cuda_ms(lambda: st.global_scan(hist)),
        "postscan K2": cuda_ms(lambda: plan.postscan(g, kt, None, vt)),
        "scatter (int64 index + 2 index_copy_)": cuda_ms(lambda: (
            lambda idx: (st.scatter(src_k, idx, n), st.scatter(src_v, idx, n)))(pos.reshape(-1).long())),
    }
    log("times", "stages of multisplit kv bms m=256: " + "; ".join(
        f"{k} {v:.4f} ms" for k, v in stage_ms.items()) + f" [{smi}]")
    del hist, g, src_k, src_v, pos
    # the same labels through the escape hatch: the user's function, the
    # int32 strip, then K1 and K2 on the ids
    plan = make_plan(n, m, method="bms", key_value=True, backend="cuda", bucket_fn=top8)
    ids_t = plan._host_labels(keys).view(-1, plan.tile)
    hist = plan.prescan(None, ids_t)
    g = st.global_scan(hist)
    src_k, src_v, pos, _ = plan.postscan(g, kt, ids_t, vt)
    stage_ms = {
        "the user's function": cuda_ms(lambda: top8.fn(keys)),
        "labels as an int32 strip (function + cast)": cuda_ms(lambda: plan._host_labels(keys)),
        "prescan K1 on ids": cuda_ms(lambda: plan.prescan(None, ids_t)),
        "global scan": cuda_ms(lambda: st.global_scan(hist)),
        "postscan K2 on ids": cuda_ms(lambda: plan.postscan(g, kt, ids_t, vt)),
        "scatter (int64 index + 2 index_copy_)": cuda_ms(lambda: (
            lambda idx: (st.scatter(src_k, idx, n), st.scatter(src_v, idx, n)))(pos.reshape(-1).long())),
    }
    log("times", "stages of multisplit kv bms m=256, the top-byte callable: " + "; ".join(
        f"{k} {v:.4f} ms" for k, v in stage_ms.items()) + f" [{smi}]")
    del ids_t, hist, g, src_k, src_v, pos
    # where the time of one S1 key-value bms segmented multisplit goes
    plan = make_plan(n, m1, method="bms", key_value=True, backend="cuda", bucket_fn=spec1,
                     segments=s)
    hist = plan.prescan(kt, None, seg_main)
    g = st.global_scan(hist)
    src_k, src_v, pos, _ = plan.postscan(g, kt, None, vt, seg_main)
    stage_ms = {
        "segment ids (prefix sum of start marks)": cuda_ms(lambda: st.segment_ids_from_starts(s1_t, n)),
        "prescan K1s": cuda_ms(lambda: plan.prescan(kt, None, seg_main)),
        "global scan (8192 x 2048)": cuda_ms(lambda: st.global_scan(hist)),
        "postscan K2s": cuda_ms(lambda: plan.postscan(g, kt, None, vt, seg_main)),
        "scatter (int64 index + 2 index_copy_)": cuda_ms(lambda: (
            lambda idx: (st.scatter(src_k, idx, n), st.scatter(src_v, idx, n)))(pos.reshape(-1).long())),
    }
    log("times", "stages of S1 segmented multisplit kv bms s=64 m=32: " + "; ".join(
        f"{k} {v:.4f} ms" for k, v in stage_ms.items()) + f" [{smi}]")
    # the same call in dms: K3s writes element-order destinations, which the
    # scatter takes with the keys and values as they are
    plan = make_plan(n, m1, method="dms", key_value=True, backend="cuda", bucket_fn=spec1,
                     segments=s)
    hist = plan.prescan(kt, None, seg_main)
    g = st.global_scan(hist)
    src_k, src_v, pos, _ = plan.postscan(g, kt, None, vt, seg_main)
    stage_ms = {
        "segment ids (prefix sum of start marks)": cuda_ms(lambda: st.segment_ids_from_starts(s1_t, n)),
        "prescan K1s": cuda_ms(lambda: plan.prescan(kt, None, seg_main)),
        "global scan (8192 x 2048)": cuda_ms(lambda: st.global_scan(hist)),
        "postscan K3s": cuda_ms(lambda: plan.postscan(g, kt, None, vt, seg_main)),
        "scatter (int64 index + 2 index_copy_)": cuda_ms(lambda: (
            lambda idx: (st.scatter(src_k, idx, n), st.scatter(src_v, idx, n)))(pos.reshape(-1).long())),
    }
    log("times", "stages of S1 segmented multisplit kv dms s=64 m=32: " + "; ".join(
        f"{k} {v:.4f} ms" for k, v in stage_ms.items()) + f" [{smi}]")
    del hist, g, src_k, src_v, pos, seg_main
    # the device stages of one S3 routing launch, each timed alone: their
    # sum against the end-to-end calls above is what the host adds
    spec3 = ops.IdentitySpec(64)
    plan = make_plan(n3, 64, method="dms", backend="cuda", bucket_fn=spec3, segments=256,
                     mode="positions_only")
    seg3 = st.segment_ids_from_starts(s3_t, n3)
    ids3_t, seg3_t = ids3_flat.view(-1, plan.tile), seg3.view(-1, plan.tile)
    hist = plan.prescan(ids3_t, None, seg3_t)
    g = st.global_scan(hist)
    pos = plan.postscan(g, ids3_t, None, None, seg3_t)[2]
    stage_ms = {
        "segment ids": cuda_ms(lambda: st.segment_ids_from_starts(s3_t, n3)),
        "prescan K1s": cuda_ms(lambda: plan.prescan(ids3_t, None, seg3_t)),
        "global scan (256 x 16384)": cuda_ms(lambda: st.global_scan(hist)),
        "postscan K3s": cuda_ms(lambda: plan.postscan(g, ids3_t, None, None, seg3_t)),
        "counts, starts, segment-local perm": cuda_ms(lambda: (
            st.exclusive_rows(hist.sum(0, dtype=torch.int32).view(256, 64)),
            pos.reshape(-1) - s3_t.index_select(0, seg3))),
    }
    log("times", "device stages of S3 routing (each alone): " + "; ".join(
        f"{k} {v:.4f} ms" for k, v in stage_ms.items())
        + f"; sum {sum(stage_ms.values()):.4f} ms [{smi}]")
    del hist, g, pos, seg3
    # fused against unfused, end to end in turns on the same inputs, and the
    # stages of one fused pair against those of one single-digit pass
    from repro_torch.core.pipeline import RadixPipeline

    f3_t = torch.from_numpy(f3_starts).to(dev)
    keys_s, values_s = keys[:N_FUSED_SMALL], values[:N_FUSED_SMALL]
    pairs = [
        ("F1 radix_sort kv bms r=8", N_MAIN,
         lambda: ops.radix_sort(keys, values, device=dev),
         lambda: ops.radix_sort(keys, values, fuse_digits=True, device=dev)),
        ("F1 radix_sort dms r=8, key-only", N_MAIN,
         lambda: ops.radix_sort(keys, method="dms", device=dev),
         lambda: ops.radix_sort(keys, method="dms", fuse_digits=True, device=dev)),
        ("F1 radix_sort kv bms r=8, family=packed", N_MAIN,
         lambda: ops.radix_sort(keys, values, family="packed", device=dev),
         lambda: ops.radix_sort(keys, values, family="packed", fuse_digits=True, device=dev)),
        ("F2 radix_sort kv bms r=7, n=2^22", N_FUSED_SMALL,
         lambda: ops.radix_sort(keys_s, values_s, radix_bits=7, device=dev),
         lambda: ops.radix_sort(keys_s, values_s, radix_bits=7, fuse_digits=True, device=dev)),
        ("F3 segmented_radix_sort kv bms r=8 s=16, n=2^22", N_FUSED_SMALL,
         lambda: ops.segmented_radix_sort(keys_s, f3_t, values_s, device=dev),
         lambda: ops.segmented_radix_sort(keys_s, f3_t, values_s, fuse_digits=True, device=dev)),
    ]
    for what, n_keys, plain_fn, fused_fn in pairs:
        ms_u, ms_f = cuda_ms(plain_fn, reps=5, inner=1), cuda_ms(fused_fn, reps=5, inner=1)
        ms_u2 = cuda_ms(plain_fn, reps=5, inner=1)
        log("times", f"end to end unfused / fused, {what}: {ms_u:.3f} (again {ms_u2:.3f}) / "
                     f"{ms_f:.3f} ms ({ms_f / ms_u:.3f}x) = {n_keys / ms_u / 1e6:.2f} / "
                     f"{n_keys / ms_f / 1e6:.2f} Gkeys/s [{smi}]")
    variants = {
        "sub_bits 4": RadixPipeline(N_MAIN, key_value=True, backend="cuda", fuse_digits=True,
                                    sub_bits=4),
        f"sub_bits 8 (the default)": RadixPipeline(N_MAIN, key_value=True, backend="cuda",
                                                   fuse_digits=True),
        "tile 4096": RadixPipeline(N_MAIN, key_value=True, backend="cuda", fuse_digits=True,
                                   tile=4096),
    }
    log("times", "end to end F1 radix_sort kv bms r=8, fused: " + "; ".join(
        f"{k} {cuda_ms(lambda p=p: p(keys, values), reps=5, inner=1):.3f} ms"
        for k, p in variants.items()) + f" [{smi}]")
    del variants

    def pair_stages(plan, kt_, vt_, seg_=None):
        """Each stage of one sweep of ``plan`` timed alone."""
        hist_ = plan.prescan(kt_, None, seg_)
        g_ = st.global_scan(hist_)
        src_k_, src_v_, pos_, _ = plan.postscan(g_, kt_, None, vt_, seg_)
        n_ = kt_.numel()
        out = {
            "prescan": cuda_ms(lambda: plan.prescan(kt_, None, seg_), reps=5),
            f"global scan ({hist_.shape[0]} x {hist_.shape[1]}, {4 * hist_.numel() / 2**30:.3f} GiB)":
                cuda_ms(lambda: st.global_scan(hist_), reps=5),
            "postscan": cuda_ms(lambda: plan.postscan(g_, kt_, None, vt_, seg_), reps=5),
            "scatter (int64 index + 2 index_copy_)": cuda_ms(lambda: (
                lambda idx: (st.scatter(src_k_, idx, n_), st.scatter(src_v_, idx, n_)))(
                    pos_.reshape(-1).long()), reps=5),
        }
        del hist_, g_, src_k_, src_v_, pos_
        return out

    for what, pipe, kk, vv, seg_t in (
        ("F1 unfused, one 8-bit pass (K1, K2)",
         RadixPipeline(N_MAIN, key_value=True, backend="cuda"), keys, values, None),
        ("F1 fused, one 16-bit pair (K1f, K2f)",
         RadixPipeline(N_MAIN, key_value=True, backend="cuda", fuse_digits=True), keys, values, None),
        ("F3 unfused, one 8-bit pass (K1s, K2s)",
         RadixPipeline(N_FUSED_SMALL, key_value=True, backend="cuda", segments=16),
         keys_s, values_s, f3_t),
        ("F3 fused, one 16-bit pair (K1f, K2f)",
         RadixPipeline(N_FUSED_SMALL, key_value=True, backend="cuda", segments=16, fuse_digits=True),
         keys_s, values_s, f3_t),
    ):
        t_ = pipe.tile
        seg_tiled = None
        if seg_t is not None:
            seg_tiled = st.segment_ids_from_starts(seg_t, kk.shape[0]).view(-1, t_)
        stage_ms = pair_stages(pipe.plans[0], kk.view(-1, t_), vv.view(-1, t_), seg_tiled)
        log("times", f"stages of {what}, tiles of {t_}: " + "; ".join(
            f"{k} {v:.4f} ms" for k, v in stage_ms.items())
            + f"; sum {sum(stage_ms.values()):.4f} ms, {pipe.n_sweeps} sweeps a sort [{smi}]")
    del keys_s, values_s
    # the batched layout and the unfused baselines end to end, each in turns
    # with what it is measured against (a, b, a) on the same inputs
    turns = [
        ("B1 batched_multisplit kv bms m=256, (8, 2^22)", N_MAIN,
         lambda: core_ms.batched_multisplit(kb, spec, vb, device=dev),
         "the loop of 8 flat ops.multisplit",
         lambda: [ops.multisplit(kb[r], spec, vb[r], device=dev) for r in range(b1)]),
        ("B1 torch.vmap(ops.multisplit_key_value) bms m=256, (8, 2^22)", N_MAIN,
         lambda: vmap_kv(kb, vb, spec, device=dev), "batched_multisplit",
         lambda: core_ms.batched_multisplit(kb, spec, vb, device=dev)),
        ("B1 torch.vmap(ops.multisplit) dms m=32, (8, 2^22)", N_MAIN,
         lambda: vmap_ms(kb, main_spec(32), method="dms", device=dev),
         "the loop of 8 flat ops.multisplit",
         lambda: [ops.multisplit(kb[r], main_spec(32), method="dms", device=dev) for r in range(b1)]),
        ("B2 batched_multisplit kv bms m=32, (256, 2^17 + 37)", 256 * n_b2,
         lambda: core_ms.batched_multisplit(kb2, main_spec(32), vb2, device=dev),
         "the loop of 256 flat ops.multisplit",
         lambda: [ops.multisplit(kb2[r], main_spec(32), vb2[r], device=dev) for r in range(256)]),
        ("B3 batched radix_sort kv r=8, (8, 2^22)", N_MAIN,
         lambda: ops.radix_sort(kb, vb, device=dev), "the loop of 8 flat ops.radix_sort",
         lambda: [ops.radix_sort(kb[r], vb[r], device=dev) for r in range(b1)]),
        ("multisplit_unfused kv bms m=256, n=2^25", N_MAIN,
         lambda: core_ms.multisplit_unfused(keys, spec, values, device=dev),
         "the fused plan (ops.multisplit)", lambda: ops.multisplit(keys, spec, values, device=dev)),
        ("multisplit_unfused bms key-only m=256, n=2^25", N_MAIN,
         lambda: core_ms.multisplit_unfused(keys, spec, device=dev),
         "the fused plan (ops.multisplit)", lambda: ops.multisplit(keys, spec, device=dev)),
        ("radix_sort_per_pass kv r=8, n=2^25", N_MAIN,
         lambda: core_sort.radix_sort_per_pass(keys, values, device=dev), "radix_sort",
         lambda: ops.radix_sort(keys, values, device=dev)),
    ]
    for what, n_keys, fn, other_what, other in turns:
        ms_a, ms_b = cuda_ms(fn, reps=5, inner=1), cuda_ms(other, reps=5, inner=1)
        ms_a2 = cuda_ms(fn, reps=5, inner=1)
        log("times", f"end to end {what}: {ms_a:.3f} (again {ms_a2:.3f}) ms = "
                     f"{n_keys / ms_a / 1e6:.2f} Gkeys/s; {other_what} {ms_b:.3f} ms "
                     f"({ms_a / ms_b:.3f}x) [{smi}]")
    # where the time of one B1 batched key-value bms multisplit goes (m =
    # 256): its grid is the flat call's 8192 tiles; beside the row scan, the
    # same scan as a cumsum along the 8 rows
    from repro_torch.core.pipeline import make_batched_plan

    bplan = make_batched_plan(b1, N_MAIN // b1, m, method="bms", key_value=True, backend="cuda",
                              bucket_fn=spec)
    hist_b = bplan.prescan(kt, None)
    g_b = st.global_scan(hist_b, b1)
    src_k, src_v, pos_b, _ = bplan.postscan(g_b, kt, None, vt)
    h_rows = hist_b.view(b1, -1, m).transpose(1, 2).reshape(b1, -1)
    stage_ms = {
        "prescan K1": cuda_ms(lambda: bplan.prescan(kt, None)),
        "row scan (one cumsum, less each row's base)": cuda_ms(lambda: st.global_scan(hist_b, b1)),
        "beside it: torch.cumsum along the 8 rows": cuda_ms(
            lambda: torch.cumsum(h_rows, 1, dtype=torch.int32)),
        "postscan K2": cuda_ms(lambda: bplan.postscan(g_b, kt, None, vt)),
        "row index + scatter": cuda_ms(lambda: (
            lambda idx: (st.scatter(src_k, idx, n), st.scatter(src_v, idx, n)))(
                st.row_index(pos_b, b1))),
    }
    log("times", "stages of B1 batched_multisplit kv bms m=256, (8, 2^22): " + "; ".join(
        f"{k} {v:.4f} ms" for k, v in stage_ms.items()) + f" [{smi}]")
    del hist_b, g_b, src_k, src_v, pos_b, h_rows
    # where the time of one unfused key-value bms multisplit goes (m = 256,
    # tiles of 4096: the bms tile)
    ids_u = spec(keys).to(torch.int32).view(-1, 4096)
    hist_u = mst.tile_histograms(ids_u, m)
    g_u = st.global_scan(hist_u)
    pos_u = mst.tile_positions(ids_u, g_u, m)
    src_u, pos_r_u, _ = mst.tile_reorder(ids_u, kt, pos_u, m)
    stage_ms = {
        "labels (the spec on the keys, as int32)": cuda_ms(lambda: spec(keys).to(torch.int32)),
        "prescan K1 on ids": cuda_ms(lambda: mst.tile_histograms(ids_u, m)),
        "global scan": cuda_ms(lambda: st.global_scan(hist_u)),
        "pass 1 K3 on ids": cuda_ms(lambda: mst.tile_positions(ids_u, g_u, m)),
        "pass 2 B10 (keys, destinations as values)": cuda_ms(lambda: mst.tile_reorder(ids_u, kt, pos_u, m)),
        "pass 3 B10 (values, key-only)": cuda_ms(lambda: mst.tile_reorder(ids_u, vt, None, m)),
        "scatter (int64 index + 2 index_copy_)": cuda_ms(lambda: (
            lambda idx: (st.scatter(src_u, idx, n), st.scatter(src_u, idx, n)))(
                pos_r_u.reshape(-1).long())),
    }
    log("times", "stages of multisplit_unfused kv bms m=256: " + "; ".join(
        f"{k} {v:.4f} ms" for k, v in stage_ms.items())
        + f"; sum {sum(stage_ms.values()):.4f} ms [{smi}]")
    del ids_u, hist_u, g_u, pos_u, src_u, pos_r_u, kb2, vb2

    # the CUDA kernels SDPA runs for float32 at A1, read once with
    # torch.profiler: the yardstick the float32 route is held against
    def library_kernels(fn):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        kernels_ = [e.key for e in events if e.device_type == DeviceType.CUDA]
        ops_ = [e.key for e in events if "attention" in e.key and e.key.startswith("aten::")]
        return kernels_, ops_

    # B11 at A1-A5, door defaults: the kernel of each route, its
    # plain version and scaled_dot_product_attention on the (B, H, S, hd)
    # view; the operations bound counts the function's 4·hd flops a (q, k)
    # pair the mask keeps at the tensor cores' peak for the input type (495
    # TFLOP/s TF32 for float32, 989 bf16 / fp16), for float32 with the share
    # of the three TF32 products' 12·hd flops at 495 and of 4·hd on the fp32
    # CUDA cores beside it; the bytes bound q, k, v and o moved once
    attn_ms, attn_routes = {}, []
    for name, dt in (("A1", "float32"), ("A1n", "float32"), ("A1", "bfloat16"),
                     ("A1", "float16"), ("A2", "bfloat16"), ("A2", "float32"),
                     ("A3", "bfloat16"), ("A3", "float32"), ("A4", "bfloat16"),
                     ("A5", "bfloat16")):
        (bh, s_len, hd), causal, (b_, h_), _ = ATTN[name]
        q, k, v = attn_inputs((bh, s_len, hd), getattr(torch, dt))
        q4, k4, v4 = (x.view(b_, h_, s_len, hd) for x in (q, k, v))
        pairs = bh * (s_len * (s_len + 1) // 2 if causal else s_len * s_len)
        nbytes = 4 * q.numel() * q.element_size()
        ms_k = cuda_ms(lambda: kops.flash_attention(q, k, v, causal=causal))
        ms_p = cuda_ms(lambda: fa.flash_attention_plain(q, k, v, causal), reps=3, inner=1)
        sdpa = functools.partial(torch.nn.functional.scaled_dot_product_attention, q4, k4, v4,
                                 is_causal=causal)
        ms_lib = cuda_ms(sdpa)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        if dt == "float32":
            flops, rate, unit = 4 * hd * pairs, TF32_FLOPS_PER_S, "495 TFLOP/s TF32 tensor cores"
            tf32x3_ms = 3 * flops / TF32_FLOPS_PER_S * 1e3
            cores_ms = flops / FP32_FLOPS_PER_S * 1e3
            cores = (f"; {tf32x3_ms / ms_k:.1%} of the three TF32 products' time {tf32x3_ms:.4f} "
                     f"ms ({3 * flops / 1e9:.1f} GFLOP / 495 TFLOP/s); {cores_ms / ms_k:.1%} of "
                     f"the fp32 CUDA cores' bound {cores_ms:.4f} ms ({flops / 1e9:.1f} GFLOP / "
                     f"67 TFLOP/s)")
            source = "flash_attention_f32_sm90.cu"
        else:
            flops, rate, unit = 4 * hd * pairs, TENSOR_FLOPS_PER_S, "989 TFLOP/s bf16/fp16 tensor cores"
            cores, source = "", "flash_attention_sm90.cu"
        ops_ms = flops / rate * 1e3
        attn_ms[(name, dt)] = ms_k
        before = ATTN_MS_BEFORE.get((name, dt))
        was = (f"; before {before:.4f} ms ({ms_k / before:.3f}x of it)" if before
               else "; before: not measured")
        log("times", f"flash_attention {name} {dt} ({source}): {ms_k:.4f} ms{was}; bounds: "
                     f"operations {ops_ms:.4f} ms ({flops / 1e9:.1f} GFLOP / {unit}, "
                     f"{ops_ms / ms_k:.1%} of it){cores}, bytes {bytes_ms:.4f} ms "
                     f"({nbytes / 2**20:.0f} MiB / 3.35 TB/s); plain {ms_p:.2f} ms; "
                     f"scaled_dot_product_attention {ms_lib:.4f} ms ({ms_k / ms_lib:.2f}x of it) "
                     f"[(BH, S, hd) = {(bh, s_len, hd)}, {'causal' if causal else 'not causal'}, "
                     f"blocks 256; {smi}]")
        if name == "A1" and dt == "float32":
            sdpa_f32 = library_kernels(sdpa)
            if not sdpa_f32[0]:
                raise AssertionError("torch.profiler read no CUDA kernel of "
                                     "scaled_dot_product_attention")
            log("times", f"scaled_dot_product_attention float32 at A1 runs the CUDA kernels "
                         f"{sdpa_f32[0]} (aten ops {sdpa_f32[1]}) [torch.profiler; {smi}]")
        if name == "A1" and causal:
            attn_routes.append({
                "dtype": dt, "source": f"src/repro_torch/kernels/csrc/{source}",
                "max_abs_err": attn_max[dt], "ms": ms_k, "plain_ms": ms_p,
                "bound_ms": max(ops_ms, bytes_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "library_ms": ms_lib, "shape": f"A1 {ATTN['A1'][0]} {dt} causal"})
            if dt == "float32":
                attn_routes[-1]["library_kernels"] = sdpa_f32[0]
    # one entry for the wrapper: its A1 float32 route at the top level, every
    # route at A1 under "routes"
    top = attn_routes[0]
    kernels.append({
        "name": "flash_attention", "route": "cuda", "source": top["source"],
        "replaces": registry.replaces("flash_attention"),
        "launches": launches["flash_attention"],
        "max_abs_err": errs["flash_attention"], "bitwise": errs["flash_attention"] == 0,
        **{key: top[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                     "shape")},
        "routes": attn_routes,
    })
    del q, k, v, q4, k4, v4
    ratio = attn_ms[("A1", "float32")] / attn_ms[("A1n", "float32")]
    s_a1 = ATTN["A1"][0][1]
    log("times", f"flash_attention causal / not causal at A1 float32: {ratio:.3f} (the causal "
                 f"pairs are {(s_a1 + 1) / (2 * s_a1):.3f} of all; below 0.65 shows the diagonal "
                 f"skip) [{smi}]")
    if not ratio < 0.65:
        raise AssertionError(f"causal / non-causal time at A1 is {ratio:.3f}, not below 0.65")
    s3_host_phase(dev, gen, s3_starts, log, smi)
    serving_trace_phase(dev, log, smi)
    model_trace_phase(dev, log, smi)
    family_trace_phase(dev, log, smi)
    training_trace_phase(dev, log, smi)
    log("times", f"peak device memory of the timed runs above the inputs: "
                 f"{(torch.cuda.max_memory_allocated() - base_mem) / 2**30:.2f} GiB")

    settle_stats()
    left = {k: STRICT_STATS.get(k, 0) for k in (
        "backend_demotions", "degradations", "tile_shrinks", "transient_retries",
        "quarantine_skips", "breaker_trips", "verify_mismatches", "reference_reruns")}
    if any(left.values()) or rz.quarantine_snapshot():
        raise AssertionError(f"a strict phase left its kernels or quarantined: {left}, "
                             f"{rz.quarantine_snapshot()}")
    log("resilience", f"outside the deliberate faults, over the whole run: {STRICT_STATS} "
                      f"(no demotion, shrink, retry or quarantine)")
    wrappers = sorted(fn.__name__ for fn in registry.KERNELS)
    if sorted(row["name"] for row in kernels) != wrappers:
        raise AssertionError(f"the kernels line lists {sorted(r['name'] for r in kernels)}, "
                             f"not the {len(wrappers)} wrappers {wrappers}")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
