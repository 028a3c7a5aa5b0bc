#!/usr/bin/env python3
"""Smoke test of paddle_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught), in this
order except that the kernel phases 6, 8 and 10 run right after phase 3,
before any main path:
1. device  — the card's name and power limit.
2. build   — builds every hand-written kernel from paddle_tpu_torch/csrc/
             (one nvcc per source, all started together).
3. kernel  — each kernel against its plain PyTorch version on the card, at
             the main path's shapes (BERT-base: B=8, nh=12, d=64,
             T in {128, 512}, the [B,1,T] mask) and at edge cases: the
             flash forward and backward, in f32 and bf16, with and without
             attention dropout (same seed as the plain version), dbias in
             both forms, causal, ragged T, d=128, the dropout keep rate and
             seed dependence; two backward calls bitwise equal; the
             backward's delta kernel (f32 and bf16) at d = 64 to 256, and
             the f32 one timed beside the plain chain it replaced;
             B·nh = 65,600 (the
             flat grid); d=32 through the op (the plain route, counted) and
             d=320 (one launch of the wide kernel). Head dims 192 and 256
             through every flash kernel family (dense forward and backward, sparse forward and
             backward; f32 and bf16, dropout 0.1; B=2, nh=2, T=256): the
             kernels, not the plain route, within the main tolerances, with
             their times; head dims 320 and 512 through the wide kernels'
             four entries (dense with the mask and dropout, with a
             per-query bias and causal; sparse causal with dropout and
             not causal; f32 and bf16), each one wide launch, the
             backwards bitwise repeatable, then at d = 512 at every shape
             the wide path runs (dense T = 128/512 with and without
             dropout; sparse T = 128/256 encoder self, decoder self and
             cross), the bf16 forward at B·nh = 65,600 (d = 320) and
             where a cluster splits its walk (T = 512, per-query bias
             and causal; sparse decoder self), the bf16 backward at a
             ragged T = 200 and at d = 1024 (dense and sparse),
             timed at d = 512 beside their plain versions, SDPA,
             their bounds (f32: 3xTF32, the FMA bound beside it) and
             their launches' CTAs; the f32 per-query dbias is held to
             the plain formula in f64 (flash_attention_ds_f64), the plain f32
             version's
             own error beside it. Times each kernel, its
             plain version and one
             PyTorch library call, with each kernel's ratio to that call and
             share of its bound (the f32 forward's and backward's bound
             is their 3xTF32 one, the FMA bound beside it); logs the bf16
             flash kernels' registers, spills, dynamic shared memory and
             HGMMA count (the sparse forward's and backward's too), and the
             f32 tensor-core flash kernels' (dense and sparse forwards and
             backwards) and K2's registers and spills and the f32
             flash kernels' HMMA count, the f32 sparse forward's shared
             memory and CTAs an SM; the wide kernels' registers,
             spills, HGMMA, HMMA and UTMALDG counts and dynamic shared
             memory.
4. serve   — main path 1: BERT-base at full width (vocab 30522, hidden 768,
             12 layers, 12 heads, ffn 3072) built with the port's DSL from a
             seed, saved with io.save_inference_model, served by
             inference.create_predictor(Config(dir)).run_padded. Checks the
             outputs, the kernel launch counts, GPU-vs-CPU agreement and a
             bf16 predictor against f32.
5. train   — main path 2: BERT-base pretraining at full width with
             hidden and attention dropout 0.1 through
             bert.build_pretrain_program → Executor(CUDAPlace(0)).run:
             4 Adam steps in f32 (B=8, T=128) and 4 in bf16 AMP (B=8,
             T=512). Checks the losses, 12 forward and 12 backward flash
             launches per step and no plain-route flash call (nor a call of
             the plain delta), GPU-vs-CPU
             agreement at dropout 0 and bf16 against f32; prints the step
             time, device-busy share, the flash kernels' device ms, top
             kernels and peak memory.
6. bn kernels — the fused batch-norm kernels (K1 stats, K2 apply, K3
             backward reduce + dx, K4 1x1-conv GEMM with the statistics of
             its stored output) against their plain versions, f32 and bf16,
             at ResNet-50 B=128 shapes; times each kernel, its plain version
             and one PyTorch library call where one computes the same
             function; K4 at four bottleneck shapes beside torch.matmul and
             its bound (f32: 3xTF32, the FMA bound beside it; the kernels
             line quotes all four), two calls bitwise equal; K4's registers,
             spills and HGMMA/HMMA counts; K3's reduce and dx passes
             timed apart as well as together; K2 at the stem (C=64, relu),
             stage 2 .sc (C=512, no relu or residual: the library's shape)
             and stage 4 (C=2048, residual and relu), each with its bound.
7. resnet  — main path 3: ResNet-50 training at full width (B=128,
             3x224x224, 1000 classes) with PDTPU_CONV_BN_FUSION=pallas and
             PDTPU_BN_MODE=pallas, built with the port's DSL from seed 2024
             under mixed_precision.decorate(Momentum(0.1, 0.9), "bfloat16")
             and run by Executor(CUDAPlace(0)) for 13 steps (2; 1 + 4
             profiled; 6 warm) on one repeated batch: losses, step time, img/s, device
             busy share, device ms by kernel kind, peak memory, and the
             fused-BN launches per step (36 conv+stats, 36 + 17 apply, 17
             stats, 53 backward reduce, 53 dx). Then the same in f32 at B=32,
             and one f32 step at 64x64, B=16 (every fused-BN kernel launches
             there) against CPUPlace() from the same weights: the loss within
             1e-5, the gradients within twice the spread a one-ulp change of
             the input makes on the CPU.
8. sparse kernels — the block-sparse packed-segment attention kernels
             (forward, dq, dk/dv) against their plain versions at the NMT
             shapes (B=16, nh=16, d=64, T=256, segment rows packed by
             reader.pack_by_tokens from the JAX bench's seeded WMT-like
             stream): encoder self (one all-pad row: exact zeros),
             decoder causal self, cross, and cross at Tq=192 != Tk=256; f32
             and bf16, dropout 0 and 0.1; two backward calls bitwise equal;
             the kernels with an all-ones tile table bitwise equal to them
             with the computed one (dropout on); times each kernel, its
             plain version and F.scaled_dot_product_attention with the dense
             boolean mask (and the backward's delta kernel alone), and
             the bound over the visible (i, j) pairs (the f32 kernels' in
             3xTF32, the FMA bound beside it), at every case. Then the f32
             kernels at d = 64 to 256 (B=2, nh=2, T=256; the same checks)
             and the f32 forward's entry at Tq=192 != Tk=256 (its CTAs,
             out's chunks bitwise equal where V's are copies). Then the
             sparse route:
             B·nh = 65,600 through the kernels (flat grids), T = 96 and
             d = 32 through the counted plain route.
9. nmt     — main path 4: Transformer-big (d_model 1024, 16 heads, d_ff
             4096, 6+6 layers, vocab 32000, dropout 0.1) packed-sparse
             training, nmt.build_train_program(cfg, 256, 256, packed=True,
             attn="sparse") under mixed_precision.decorate(Adam(1e-4),
             "bfloat16") by Executor(CUDAPlace(0)) from seed 2024: 10 steps
             (2; 1 + 1 profiled; 6 timed) over 3 packed batches of B=16 rows
             in turn. Checks finite losses that start near ln 32000 and
             fall on a repeated batch, 18 forward and 18 backward sparse
             launches a step and no plain-route sparse call; prints whether
             the segment rows reach pack_se contiguous, step time, non-pad
             target tokens/s,
             device busy share, device ms by kernel kind and peak memory.
             Then the same model in f32 (no AMP) for three steps (one; one
             unprofiled and one profiled): a finite first loss near
             ln 32000, 18 forward and 18 backward sparse launches a step,
             no plain call; its step time, device busy share and the
             sparse kernels' ms. Then one f32 step at 2+2 layers (full width, B=4, T=128,
             dropout 0) on CUDAPlace(0) and CPUPlace() from the same
             weights: the loss within 1e-5, every gradient within 1e-4
             relative L2 (or twice the CPU's own one-ulp spread where that
             is larger); its sparse launches and the full-depth run's are
             the f32 kernels' count, and one more step on the card is
             profiled (device ms by
             kind, the f32 sparse kernels' among them). Inside the
             full-depth f32 run, FLAGS_matmul_precision="float32": one
             TF32-off step, then two TF32 steps from the same state and
             generator (step time, cuBLAS ms, the loss's relative
             difference, within 1e-2), then "default" again, which must
             turn TF32 off before the GPU-vs-CPU check.
9b. wide    — main path 7: the wide flash kernels (d > 256) through
             Executor.run: BERT pretraining at hidden 1024 cut to 2 heads
             (d = 512) and 2 layers (f32 B=4 T=128, bf16 AMP B=4 T=512, 2
             Adam steps each, dropout 0.1), then Transformer-big (d_model
             1024) cut to 2 heads and 2+2 layers, packed-sparse (bf16 AMP
             B=4 T=256, f32 B=4 T=128, 2 steps each): finite losses, one
             wide launch per attention layer and step each way, no
             plain-route call.
10. sparse adagrad kernels — rows 12-14 against their plain versions, bit
             for bit, at the main paths' shapes: the sparse-Adagrad update
             on the [33,554,432, 128] u16 DeepFM table with one step's
             106,496 merged slots (uniform ids: a few duplicates, so a
             SENTINEL tail; spare lanes zeroed; the all-sentinel call leaves
             the table as it was), the row gather and scatter at n = 65,536
             on the [368,640, 128] hot-cache slab with a padded duplicate
             tail; times each kernel, its plain version and
             index_select / index_copy_ with the L2 cache flushed before
             each call.
11. deepfm  — main path 5: DeepFM at the JAX bench's TPU shape (vocab
             33,554,432, 26 fields, embed 16, hidden 400x3, B=4096) with
             fm_t packed on exact Adagrad (an 8.59 GB u16 table) and the
             dense net on Adam, deepfm.build_train_program(...,
             packed_rows=...) → Executor(CUDAPlace(0)) from seed 2024: 2 +
             1 profiled + 6 timed steps on one repeated batch of uniform ids
             (finite losses that fall, one row-12 launch a step; examples/s,
             step ms, device busy share, kernels by kind, peak memory).
             Then 2 steps from one state fused and {"fused": False}, and
             fused twice: equal losses and bit-equal tables.
12. ps hot cache — main path 6: the same model through
             ps.PsEmbeddingTier over ShardedTable.build_in_process on
             RangeSpec.even(33,554,432, 4), 24 Zipf(1.5) batches
             (RandomState(11)), the first 4 warm-up, push_depth 1: the
             streaming arm (hot_rows 0) and the hot arm (hot_rows 2^18, a
             [368,640, 128] slab). Prints the steady lookup hit rate,
             examples/s of both arms and the speedup, evictions and
             write-back bytes; requires equal losses in both arms and row
             13/14 launches in the hot arm.
13. deepfm GPU vs CPU — the JAX bench's CPU shape (vocab 10,000, B=64,
             f32) 3 steps on the card and on CPUPlace() from one state: the
             losses within 1e-5, untouched table rows bit for bit, the dense
             parameters and the touched payloads within twice the CPU's own
             spread under a one-ulp change of the dense input.
14. step surface — the executor's step surface at full width, one JSON
             line: BERT-base bf16 AMP (B=8, T=512, Adam, 12 layers) three
             steps from one state under BuildStrategy.remat_policy "none",
             "minimal" and "full" through CompiledProgram(...)
             .with_data_parallel on the one card (peak memory, step median
             and range; "minimal" and "full" bitwise equal at dropout
             0.1, the flash kernels launched once more a layer in the
             recompute; "none" and "full" within 1e-5 at dropout 0,
             bitwise reported; "full" peaking below "none"); the
             FLAGS_check_nan_inf probe's cost on that step, a NaN feed
             raising FloatingPointError on a small program, NaN and Inf
             found in 16 M-element f32 and bf16 tensors; four steps
             with return_handle=True bitwise equal to return_numpy (host
             ms a dispatch both ways); ResNet-50 bf16 AMP (B=128,
             Momentum(0.1, 0.9)) three steps under PDTPU_FUSE_UPDATES
             0, 1 and auto from one state: parameters and velocities
             bitwise equal, device events a step (profiled), fused groups
             and ops, step median and range.
15. training surface — one JSON line, the card's name and power limit in
             it: each of the six new update ops (LarsMomentum, Adamax,
             DecayedAdagrad, Adadelta, RMSProp plain and centered, Ftrl at
             lr_power -0.5 and -0.3) and conditional_block (under
             GradientMerge and Lookahead) three steps of a small fc
             program from one state on the card and the CPU, every
             parameter and accumulator within rtol 1e-5, atol 1e-7 or
             within twice the CPU's own spread under a one-ulp change of
             the input; the eight schedule kinds (and warmup over a
             polynomial decay) 12 steps, within 1e-6 of the CPU's, and a
             warm step profiled: no host-to-device copy, the ops' device
             time; layers.auc over three B=4096 batches, the stat buffers
             bitwise equal to the CPU's and to metrics.Auc; LeNet-5 on
             synthetic digits, 12 epochs of 4 batches of 64 (the loss
             halves, accuracy over 0.9). Then the full-width recipes, each
             with its launches counted from 0: ResNet-50 bf16 AMP B=128 on
             LarsMomentum over linear warmup + polynomial decay (2 + 4
             steps, one profiled: finite losses, the lr sequence against
             the CPU's, rows 7-11 a step, device events a step, step
             median and range); Transformer-big bf16 packed-sparse B=16
             T=256 on Adam over noam_decay(1024, 4000), 4 steps (rows 5-6
             a step, the lr sequence); BERT-base bf16 AMP B=8 T=512 on
             GradientMergeOptimizer(Lamb(warmup + linear decay), k_steps=2),
             6 steps: parameters and LAMB accumulators bitwise unchanged on
             the steps that skip, every parameter moving on the steps that
             apply, the merge buffers and the counters changing every
             step, rows 1-4 launches, the ms of both kinds of step.
16. input pipeline and checkpoints — one JSON line, the card's name and
             power limit in it: BERT-base bf16 AMP (B=8, T=512, 12 layers,
             dropout 0.1, Adam) 8 steps from one state on 8 seeded
             batches: plain Executor.run on numpy feeds twice (whether
             the two are bitwise equal sets the rule: bitwise, else 4x
             their measured spread, the differing tensors printed), then
             through a DeviceLoader (pinned memory, side stream),
             train_scanned(scan_steps=4) and train_from_dataset over an
             InMemoryDataset-shaped source, each held to the plain run
             with 12 + 12 flash launches a step. The first plain run
             saves a Checkpointer bundle after step 4 without blocking
             (with the loader cursor as @dataio@ extras): the bundle must
             equal the state after step 4; a fresh scope and executor
             restore it (the CUDA generator too), a DeviceLoader resumes
             at the cursor, and steps 5-8 must equal the plain run's.
             BERT-base served at B=8, T=128 from a reference-format
             directory (save_inference_model(format="reference")) must
             equal the native format's bitwise, and
             tests/data/ref_mnist_model must predict within 1e-5 of its
             expected.npz on the card. Phase 12's hot arm again with
             pull_ahead=1: losses and the final table bitwise equal to
             pull_ahead=0, rows 12-14 launched. Prints the plain and
             loader-fed median step, dataio/h2d_ms, busy shares, the ms
             save() holds the loop, the background write's ms, bundle
             bytes, restore ms and the phase's wall time. The native
             library must have built.
17. deferred rows and the A6 paths — one JSON line, the card's name and
             power limit in it: full-width DeepFM (the JAX bench's
             config, V = 33,554,432, B = 4096, Adagrad) on the
             deferred-row log (rows_per_step 106,496, 16 segments: a
             [V, 34] f32 table and two [1,703,936, 128] logs), 34 steps
             from one seeded state twice (bitwise equal; folds after
             steps 16 and 32), held to the plain sparse path from the
             same values within twice what a one-ulp change of the dense
             input does to the sparse path's losses; train_scanned(4)
             bitwise equal to plain runs over 13 steps; train_scanned(17)
             refused; the median step of each arm, the fold's device ms,
             the host reads of every step (torch.cuda's sync debug mode:
             the counter's seed on step 1, none after) and their sites,
             peak memory. The small config (V = 10,000, B = 64, 4
             segments) 9 steps on the card and the CPU for SGD, Adagrad
             and Adam, and a Checkpointer resume mid-window (bitwise, on
             the fold cadence). ResNet-50 on the space-to-depth stem:
             bf16 AMP B=128 at 224², Momentum, both switches on, 4 steps
             (fused-BN launches a step, the median beside phase 7's 7x7
             stem), and one f32 step at 64x64 against the CPU. ResNet-50
             (s2d stem, is_test) served by create_predictor with
             conv_bn_fuse at batches 8 and 32 against the unfused program
             (relative L2 1e-4), ms a request. Transformer-big (6+6,
             d_model 1024, 16 heads, dense masks, bf16 AMP, Adam, dropout
             0.1) over seeded lengths uniform in 8-256, bucketed into
             [64, 128, 256] at batch sizes [64, 32, 16], 2 steps a bucket
             (step ms, padding waste), and padding invariance in f32
             is_test (one batch padded to 64 and to 128: relative 1e-5).
             The 17 sequence ops and the two beam ops on the card against
             the CPU (max |diff| 1e-5).
18. inference and serving — one JSON line, the card's name and power
             limit in it. BERT-base f32 (phase 4's model, T = 128) behind
             serving.InferenceServer (buckets 1/2/4/8, 2 ms batch delay,
             queue 256, warmed): 64 seeded requests of 1-8 rows from 8
             client threads, each answer within relative L2 1e-5 of the
             Predictor's run of that request alone, no error, 12 flash
             launches a dispatch; p50/p99 ms, requests/s, the bucket
             histogram (the batcher's record_event spans), /healthz
             through a live IntrospectionServer, peak memory. BERT-base
             int8 (Config.enable_int8 on 8 seeded B=8 feeds): the gate's
             decision and delta beside the JAX package's, quant_meta;
             quantized_fc on the card against the CPU at the FFN shape
             (M = 1024, K = 768, N = 3072) and at M = 1: int32
             accumulators equal, outputs within 1e-6 of the largest;
             ms a request at bucket 8 in f32, bf16 and int8; state
             bytes by dtype. The fleet at the JAX bench's width (MLP 512
             -> 2048 -> 2048 -> 16, 256 batch-1 requests, 16 clients):
             one served replica against 3 ThreadReplicas; a rollout
             v1 -> v2 under load (no error, the longest completion gap);
             ab_split serving both versions; three tenants 2:1:1 on 4
             int8 replicas (p99 each); 2 ProcessReplicas serving on the
             card, one SIGKILLed under load (nothing lost, every answer
             right, the dead one ejected). PS-backed CTR serving at
             DeepFM's vocabulary (V = 33,554,432, 16 id fields, packed
             [V, 128] u16 rows with 8 visible f32, fc 16 softmax) on 3
             in-process shards in host memory through a 65,536-row
             cache: 32 uniform and 32 Zipf(1.5) batches of 8 bitwise
             equal to Executor.run of the serving program with the whole
             table in a scope on the card; hit rate, ms a request (local
             and PS), the cache table's upload ms, resident bytes; the
             int8-resident variant (pinned table scale) whose cache
             equals requantize_packed_rows after apply_delta. The
             phase's wall time.
19. the PS tier and streaming — one JSON line, the card's name and power
             limit in it. DeepFM (hidden 64, B = 4096, packed Adagrad on
             106,496 rows a step) over 8 in-thread loopback socket shards
             of a 2,097,152-row table, 18 steps (3 warm-up), arms
             (pull_ahead, push_depth) = (0,0), (2,0), (2,1), (2,1) with a
             212,992-row hot cache (its first 6 steps: the arm's host
             planning loop takes 5-7 s a step), (2,1)
             under a 1 Hz FederatedScraper:
             each arm's losses and final shard bytes bitwise equal to an
             in-process run on the same feeds; examples/s, median step
             ms, bytes pulled and pushed a shard, prefetch hits/misses,
             the device busy share of the last (profiled) step, row-12
             launches (one a step) and rows 13-14 in the hot arm. In the
             hot arm, PS checkpoints: save(ps_tables=) before step 2
             with dirty slab rows (flushed through the row-13 gather),
             deltas before steps 3 and 5, the chain restored onto 3
             in-process shards bitwise equal to the live table; the ms
             save holds the loop, bytes, restore ms. The aggregate
             67,108,864-row (17.18 GB) table over 8 socket shards at
             (2,1): finite losses, examples/s, RSS. A pserver SIGKILLed
             mid-run (B = 1024, V = 262,144, 2 runner processes, 6
             steps, killed before step 3, restarted after 0.25 s; with
             and without a 53,248-row hot cache): losses bitwise equal to
             the uninterrupted run, one recovery, RPC retries, the
             recovery pause, journal bytes, /healthz through a
             ShardMonitor ok -> degraded -> ok with the times. Online
             learning (the JAX bench's cell: 200,000-id stream, 2 dynamic
             shards of 16,384 rows, 225 steps of 256, a PsLookupPredictor
             on the card fed by a DeltaPublisher with a 1 s budget): AUC
             rises, rows materialized past the capacity while live rows
             stay within it, staleness p99 within the budget, the serving
             cache bitwise equal to the shards, a delta chain restored
             bitwise. Serving from socket shards: phase 18's CTR model at
             2,097,152 rows loaded over the wire into 2 runner pservers,
             2 ProcessReplicas (--ps-endpoints, on the card) answering 64
             batches of 8 bitwise like a ThreadReplica over an in-process
             table; ps_admin stats, dump-health and fleet exit 0 where
             torch cannot be imported. The phase's wall time. Cut for
             phase 26's time: the socket arms from 36 steps to 18, the
             recovery runs from 12 steps to 6 (53.3 s → 38.4 s at 8), the
             online cell from 375 steps to 225 (25.6 s → 13.2 s; two runs
             on the H100, the second on a slower host).
20. parallel — data and sequence parallelism on an NCCL group of
             torch.cuda.device_count() ranks (at most 8; this process is
             rank 0, the others run this script with --p20-rank): every
             collective round-tripped and checked; BERT-base (12 layers,
             hidden 768, 12 heads, T = 512, B = 8 a rank, bf16 AMP, Adam,
             dropout 0) 4 steps under the plain executor (one rank only)
             and with_data_parallel at ZeRO stages off, 1, 2, 3, and
             ResNet-50 (bf16, B = 128 a rank, Momentum) 3 steps plain,
             off and stage 3: losses and final parameters bitwise equal
             across the runs, step ms, peak memory and the state bytes a
             rank; the flash and fused-BN kernels launched on the mesh
             runs, none plain. The ring's per-hop code driven over every
             (rank, hop) in this process: bf16, B = 1, 12 heads, d = 64,
             T = 32,768 over sp = 8, causal and dense, forward and
             backward against one whole-T call of the same kernels, with
             both timed; f32 at T = 4,096 over sp = 4 against the plain
             per-block versions; then the public ring_self_attention
             (impl "auto": the kernels) and ulysses_attention on the
             group against the whole-T call.
21. model_parallel — tensor and expert parallelism on a group of two
             ranks (this process is rank 0, the other runs this script
             with --p21-rank): NCCL on two cards when there are two, else
             gloo with both ranks on the one card (NCCL refuses two ranks
             of a communicator on one device), first recording which
             collectives the backend takes on CUDA tensors. On a
             {"dp": 1, "tp": 2} mesh: BERT-base (6 layers, hidden 768, 12
             heads, T = 512, B = 8, Adam, dropout 0, the Megatron specs of
             tp_axis="tp") 3 f32 steps (TF32 off), saved as a tp-sharded
             checkpoint, one more step; 2 bf16 AMP steps; Transformer-big
             NMT (packed, sparse attention, annotate_tp(NMT_RULES)) 2 bf16
             AMP steps at full depth and 2 f32 steps at 2+2 layers;
             DeepFM (shard_axis="tp", V = 33,554,432 packed rows on the
             fused sparse-Adagrad update, B = 4096) 3 steps. On an
             {"ep": 2} mesh: layers.moe_ffn (8 experts, d 1024, hidden
             4096, k 2, 8,192 tokens a rank, f32, Adam) 2 steps. Then, in
             this process alone, the plain executor on the same programs
             and the checkpoint restored into it: the losses (f32 BERT,
             NMT, DeepFM, MoE, the restored step) within 1e-4 relative,
             BERT's parameter changes within 1e-3 relative L2, every
             replicated parameter bitwise equal across the tp ranks after
             every step, the attention kernels launched on this rank's
             heads (6 of 12, 8 of 16) the expected number of times, row
             12 once a step a rank, no plain call on the card; step ms,
             peak memory and the state bytes a rank beside the plain
             run's. Cut for phase 26's time: BERT-base from 12 layers to
             6, its bf16 run from 4 steps to 2, the NMT runs from 3 to 2
             (the phase took 65.4 s at 12 layers on the H100; 95.9 s at
             6 layers on a slower host, where gloo's steps ran 1.5-2x
             longer).
22. pipelines — pipelines, the sequence axis and attention dropout on a
             slice, on gloo groups on the one card (NCCL where there are
             enough cards; ranks 1.. run this script with --p22-rank):
             (a) gloo's native isend/irecv and send/recv on CUDA tensors
             in two fresh processes (--p22-probe), and the host-staged
             exchange the port uses; the four flash kernels' dropout bits
             at a head and row offset (heads 6.. of 12, 8.. of 16; rows
             256.. of 512) against the plain versions, f32 and bf16,
             forward and backward; on two ranks: (b) BERT-base (6
             layers, B = 8, T = 512, Adam) cut by PipelineOptimizer into
             2 stages of 3 layers, 4 microbatches, f32 for 3 steps (and a
             pp checkpoint, then a 4th step) and bf16 AMP at dropout 0.1
             for 4 steps, and the microbatches' masks of a dropout-only
             pipeline; (c) BERT-base f32 at tp = 2 with attention and
             hidden dropout 0.1 for 2 steps, Transformer-big NMT bf16 at
             tp = 2 with dropout 0.1 for 2 steps; (d) BERT-base f32 at
             sp = 2 (256 queries a rank) at dropout 0 and 0.1, 2 steps
             each; on four ranks (e) BERT-base at 4 layers over tp2×pp2,
             f32, 3 steps; in this process the plain runs and (f) the pp
             checkpoint restored into the plain executor. Checks: losses
             within 1e-5 relative of the plain run's (e: 1e-4) and
             parameter changes within 1e-3 relative L2 (b, e), the
             restored step's loss, every replicated parameter bitwise
             equal across the ranks after every step, the launches of
             rows 1-6 (12 a direction a step a rank in the pipeline, none
             plain) at the heads and lengths each run gives them, masks
             that differ between microbatches. Step ms, peak memory,
             state bytes a rank, the schedule's ticks and bubble.
23. model_parallel_rest — the rest of model parallelism, on gloo groups
             on the one card as phase 22 runs them: on two ranks (a)
             BERT-base f32 (6 layers, B = 8, T = 512, Adam) cut into 2
             stages of 3 layers (4 microbatches) under
             GradientClipByGlobalNorm(0.05), 3 steps (each rank brings the
             other stage's squared norms in one all-gather over pp), and
             the same in bf16 AMP at dropout 0.1 for 2 steps; (b)
             layers.moe_ffn's dense path (8 experts, d 1024, hidden 4096,
             k 2, cf 1.25, 8,192 tokens a rank) at dp = 2, routing the
             gathered whole batch; (c) a 4-layer BERT-base encoder under a
             sequence_unpad → sequence_pool head whose rows are weighted by
             their softmax along dim 0 (rule A: gathered over dp), Adam, 2
             steps at dp = 2; on four ranks (d) BERT-base f32 on tp2×sp2
             (6 of 12 heads, 256 of 512 query rows a rank) with attention
             and hidden dropout 0.1, 2 steps, every rank fed the whole
             batch; (e) the moe block on {"dp": 2, "ep": 2}. In this
             process the plain runs. Checks: the clip factor below 1 in
             every step (printed); pp + clip losses within 1e-5 relative
             of the plain run's and parameter changes within 1e-3
             relative L2; bf16 finite; tp×sp losses within 1e-6; the moe
             Out, AuxLoss and every gradient within 1e-5 of the largest
             value of the whole-batch run's (both meshes); the head's
             losses within 1e-5 and changes within 1e-3 (parameters on
             both sides of the softmax); replicated parameters bitwise
             across the ranks after every step; rows 1-4 launched the
             expected number of times at the shapes each run gives them,
             none plain. Step ms, peak memory, state bytes a rank.
24. fleet_cluster — fleet and cluster: (1) distributed.launch's env for
             one trainer, fleet.init(PaddleCloudRoleMaker()) on an NCCL
             group of one, fleet.distributed_optimizer(Adam,
             DistributedStrategy()).minimize on BERT-base f32 (12 layers,
             B = 8, T = 512, dropout 0) and 6 steps of fleet.main_program:
             the first 3 losses bitwise the plain executor's, rows 1-2
             and 3-4 (f32) launched 12 times a step, none plain; (2)
             ResNet-50 bf16 AMP at B = 128, 224², under
             DGCMomentumOptimizer (rampup_begin_step 2, sparsity 0.999), 4
             steps: the 2 dense steps bitwise Momentum's (losses and every
             parameter), in each sparse step every parameter changes in
             exactly its kept count of entries; the step ms of both,
             torch.topk's device ms a sparse step, rows 7-11's launches;
             (3) a gloo pair on the one card (CUDA tensors): local SGD on
             an MLP at k = 3 (the replicas differ between syncs and are
             equal after each, the mean loss falls), dgc_allreduce and
             sparse_allgather_exchange of a 4 Mi-element gradient at
             ratio 0.001 against the dense
             sum of both ranks' top-k, the bytes each form puts on the
             wire; (4) run_elastic over the BERT-base fleet step in a
             child process, SIGTERMed after step 3 and relaunched to step
             6: the stitched losses bitwise (1)'s uninterrupted run's, the
             final checkpoint's and the restore's ms (the relaunch runs
             beside (6) and hbm_plan's process); (5), before (4) and with
             the card to itself, planner.plan_for on (1)'s program: the
             card's budget picks stage 0, no remat, K = 1; a budget a byte
             under that estimate escalates; at B = 112, whose stage-0
             step runs out of the card's memory, the ladder marks it as
             not fitting and escalates to a plan whose step fits; each
             measured estimate beside torch.cuda.max_memory_allocated of
             the same candidate's steps (0.97-1.0); python -m
             paddle_tpu_torch.tools.hbm_plan --json once; (6) DeepFM (vocab
             1,000,000, B = 4096) on the deferred-row log through
             with_data_parallel on an NCCL group of one across 2 folds:
             losses within 1e-5 of the plain executor's, the log count 0.
25. root_cause — the root-cause loop, in a process of its own
             (`chip_smoke.py --p25`: torch.profiler loses kernel records
             in a process after other processes or threads used the
             card): (1) the card's floors measured
             into a fresh calibration cache (ten dependent 8192² bf16
             matmuls, a 256 Mi-element bf16 multiply-add chain of 20, from
             torch.profiler's kernel events; neither above the datasheet's
             989 TFLOP/s and 3,350 GB/s); (2) BERT-base bf16 AMP training
             (B = 8, T = 512, 12 layers) through Executor.run: one counted
             perf-ledger entry, its flops beside the analytic walk's, 22
             warm steps whose records carry achieved_tflops and mfu, the
             perf/mfu and perf/roofline_fraction gauges in (0, 1.05], 12
             flash launches a step each way; (3) profiler.profiler()
             around 2 steps: the roofline table of the session's trace
             (24 launches of each flash kernel, their declared counts
             joined, no hand-kernel row over 1.05 of its datasheet bound,
             a launch's ms beside rows 1-4's standalone times, the rows
             against the measured floors too), timeline's summary and a
             fleet merge; (4) a golden table, one 400 ms delay_ms fault at
             exec.dispatch, the StepProfiler's slow_step arming the
             ProfileTrigger, whose capture (from its own thread) holds
             the trainer's flash launches and names culprit kernels
             against the golden; exactly one slow_step capture; a
             TrainStepTime page (budget half the warm median) enriched
             with them and dumped; /alerts and /history 200;
             postmortem --url and ops_console --once; (5) op_bench's
             fused conv+BN and block-sparse attention cells at the JAX
             package's defaults (f32) and at ResNet-50 stage-1 .c and the
             NMT encoder (bf16), each kernel arm held to its plain arm.
26. dygraph — the dygraph mode, in a process of its own (`chip_smoke.py
             --p26`, as phase 25): (a) ResNet-50 built from dygraph.nn
             Conv2D / BatchNorm / Pool2D / Linear at full width (64 to
             2,048 channels, 224², 1,000 classes, 53 BatchNorms; the
             reference's test_imperative_resnet.py pattern) trained in
             f32 at B = 32 under PDTPU_BN_MODE=pallas with
             Momentum(0.01, 0.9) for 4 steps on a seeded batch: rows 7,
             8 and 9 (reduce and dx) launched 53 times a step each, none
             through K4 (every batch_norm call takes the kernels); the
             same network in the static DSL (layers.conv2d / batch_norm /
             pool2d / fc, no fused conv+BN) from the same weights on the
             static executor: the first 3 losses within 1e-4 relative,
             each parameter's change within 1e-3 relative L2, the last
             BatchNorm's running mean and variance within 1e-4; the warm
             step ms of both, their ratio, a profiled dygraph step's
             device ms and busy share, peak memory; (b) dygraph.jit of
             the trained model in eval mode against its eager eval
             forward, within 1e-6 relative; (c) profiler.op_profiler
             around one training step: its calls equal the ops the
             network traces, its top rows printed; (d)
             tools.op_bench.bench_dygraph_mlp at the JAX package's
             defaults (50 steps, batch 64, width 256, depth 4): the
             cached and uncached step ms and their spread; (e)
             DataParallel on a gloo pair on the one card (CUDA tensors;
             rank 1 runs this script with --p26-rank; NCCL refuses two
             ranks on one card): tests/torch_dist_dygraph_runner.py's
             MLP for 5 steps, the same batch on both ranks, each rank's
             losses within 1e-5 of one process's, the all-reduce bytes
             a step.
27. recurrent — control flow, recurrent nets and the CRF, in a process of
             its own (`chip_smoke.py --p27`): (a) the reference book's
             semantic-role-labelling db_lstm (models.label_semantic_roles)
             at conll05's widths (44,068 words, 3,162 predicates, 59
             labels; word_dim 32, 8 LSTMs of H = 128 with peepholes,
             relu candidates, sigmoid cells, directions alternating;
             linear_chain_crf, crf_decoding, chunk_eval IOB), B = 10 f32,
             lengths uniform in 8–64: 5 SGD steps on the card and 3 on
             the CPU from the same weights and feeds, the 3 losses within
             1e-4 relative; after step 3 both decode one batch, the
             paths equal (a differing row must be a tie: its two paths'
             Viterbi scores on the CPU's emission within 1e-5 relative)
             and chunk_eval's three counts equal (also on the card over
             the CPU's path); no host read inside the recurrent ops
             (torch.cuda sync debug mode over one step); the warm step on
             a cached plan, each new length's first run, the decode,
             one profiled step's launches, device ms, busy share and
             peak memory (no hand kernel: unchecked), the CUDA-event
             span; (b) tests/test_control_flow_rnn.py's loops at width
             512 on the card against the CPU: a While filling a tensor
             array (bitwise), a bounded While(max_iters=8) and its input
             gradient (within 1e-6, no host read inside the ops),
             DynamicRNN against StaticRNN over lengths 12, 9, 5, 1
             (within 1e-6, zeros past each length), array writes and
             reads at i = max_len + 3 and i < 0 (wrapped once, clamped;
             no device assert); (c) tools.serving_bench at its defaults
             (the MLP 512 → 2048 → 2048 → 16, 256 closed-loop requests at
             concurrency 32): the served outputs against the sequential
             Predictor's within rtol = atol = 1e-6, then fp32, int8 and
             `--models ads:2,feed:1 --replicas 3 --slo-p99-ms 500`, each
             exit code the tool's contract for its rows; (d)
             tools.pipeline_bench at its defaults (30 steps, batch 256,
             dim 512, depth 4): outputs identical, both arms' steps/s.
Profiler sessions. torch.profiler loses kernel records in a process after
other processes or threads used the card (in the H100 runs from phase 6
on when it ran after the first main paths; phases 19-24 run after phase
18's process fleet). So every session here (`profile_device` and the helpers on it,
`p19_profile_once`) reads the hand-kernel wrappers' launch counters before
and after it and holds the session's records of each hand kernel to what
those counts give (`check_session`: K1 colsum + finish, K2 apply, K3
colsum + dx, K4 conv + finish, a flash forward one kernel, a flash
backward delta + main, bf16's main dq + dk/dv; the sparse-Adagrad and row
kernels one each). A short session is taken again: `device_ms` up to six
sessions for a good one (three when the first three are all short),
`profile_record` up to six, phase 24's DGC step and `p19_profile_once`
never (a session of the DGC step takes ~9 s to read; `p19_profile_once`
profiles a training step, which another session would change).
One still short prints its reading as incomplete, with no device numbers;
a kernel's timing then comes from CUDA events around back-to-back calls
instead, said so in its session's record. A session with no hand kernel
in it is unchecked. The line "profile sessions" counts them at the end,
by phase.
The last lines are the kernels' JSON record, the card's name and power
limit, and {"ok": true, "device": {...}}; the line before them gives the
script's wall seconds. Exits non-zero without a result when torch sees no
CUDA device or the port is not beside this script.

"""
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

B, NH, D = 8, 12, 64
HIDDEN = NH * D
SEQS = (128, 512)
WIDE_D = (192, 256)   # head dims past the models' d = 64: shape checks only
WIDER_D = (320, 512)  # above the tuned kernels' head dims: the wide kernels
# the wide path: BERT-large's hidden 1024 and NMT's d_model 1024 cut to two
# heads (d = 512), two layers (NMT 2+2)
WIDE_HEADS, WIDE_HIDDEN, WIDE_B = 2, 1024, 4
FAW_SOURCE = "paddle_tpu_torch/csrc/flash_attention_wide.cu"
# forward out/lse: rtol = atol
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# backward dq/dk/dv/dbias. f32: rtol = atol = 2e-5 (tighter than 1e-4: the
# kernel sums in the order cuBLAS's f32 FMA path does, measured within
# 1e-6 relative of the plain version). bf16: max |err| <= 1e-2 · max |plain|
# (tighter than 3e-2: p and ds are rounded to bf16 at other places than in
# the plain version's batched products, measured within 5e-3).
BWD_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
DROPOUT = 0.1
# H100 SXM data sheet peaks (dense): bf16 tensor cores, f32 FMA, HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TF32_PEAK_FLOPS = 495e12
PEAK_BYTES = 3.35e12
FA_SOURCE = "paddle_tpu_torch/csrc/flash_attention_fwd.cu"
FA_REPLACES = ("paddle_tpu/ops/pallas_kernels/flash_attention.py:172 "
               "(_flash_fwd_pallas -> _fwd_kernel :106, "
               "_fwd_kernel_onepass :279)")
FA_BWD_SOURCE = "paddle_tpu_torch/csrc/flash_attention_bwd.cu"
FA_BWD_REPLACES = ("paddle_tpu/ops/pallas_kernels/flash_attention.py:648 "
                   "(_flash_bwd_pallas -> _bwd_dq_kernel :511, "
                   "_bwd_dkv_kernel :574; _bwd_kernel_onepass :350)")
BN_SOURCE = "paddle_tpu_torch/csrc/fused_bn.cu"
BN_REPLACES = {
    "fused_bn_stats": "paddle_tpu/ops/pallas_kernels/fused_bn.py:129 "
                      "(bn_stats -> _stats_kernel :116)",
    "fused_bn_apply": "paddle_tpu/ops/pallas_kernels/fused_bn.py:176, :454 "
                      "(bn_apply, _apply2d -> _apply_kernel :162)",
    "fused_bn_bwd": "paddle_tpu/ops/pallas_kernels/fused_bn.py:279 "
                    "(_bn_bwd_2d -> _bwd_reduce_kernel :210, "
                    "_bwd_dx_kernel :232)",
    "fused_conv_stats": "paddle_tpu/ops/pallas_kernels/fused_bn.py:430 "
                        "(_conv_stats -> _conv_stats_kernel :409)"}
# y, dx, dres: max |err| <= tol * max |plain| (f32: the kernels sum in other
# orders; bf16: a differently summed f32 may round to the neighbouring bf16).
# mean/var: per channel |err| <= 1e-5 * E[x^2] (var) and 1e-5 * sqrt(E[x^2])
# (mean): a one-pass var is E[x^2] - mean^2, so its rounding scales with
# E[x^2], not with var. dgamma/dbeta: max |err| <= 1e-5 * max |plain|.
BN_TOL = {"float32": 2e-5, "bfloat16": 1e-2}
BN_STAT_TOL = 1e-5
RESNET_B, RESNET_HW = 128, 224
RESNET_PER_STEP = {"conv_stats": 36, "apply2d": 36, "bn_apply": 17,
                   "bn_stats": 17, "bn_bwd_reduce": 53, "bn_bwd_dx": 53}
FAS_SOURCE = "paddle_tpu_torch/csrc/flash_attention_sparse.cu"
FAS_REPLACES = ("paddle_tpu/ops/pallas_kernels/flash_attention.py:1249 "
                "(_flash_fwd_pallas_sparse -> _fwd_kernel_sparse :1196)")
FAS_BWD_REPLACES = ("paddle_tpu/ops/pallas_kernels/flash_attention.py:1402 "
                    "(_flash_bwd_pallas_sparse -> _bwd_dq_kernel_sparse "
                    ":1299, _bwd_dkv_kernel_sparse :1346)")
# the JAX bench's first packed NMT shape (bench.py:1180): B rows of T tokens
NMT_B, NMT_T, NMT_NH = 16, 256, 16
NMT_PER_STEP = 18    # 6 encoder self + 6 decoder causal self + 6 cross
LN_NMT_VOCAB = 10.3735   # ln 32000
LN_VOCAB = 10.3260   # ln 30522: the loss of a uniform prediction
LR = 1e-4            # the JAX package's bench recipe; the loss falls by
#                      ~0.3 a step on a repeated batch at full width
SA_SOURCE = "paddle_tpu_torch/csrc/sparse_adagrad.cu"
SA_REPLACES = {
    "sparse_adagrad_update": "paddle_tpu/ops/pallas_kernels/sparse_adagrad.py"
                             ":160 (fused_adagrad_update -> _kernel :130)",
    "sparse_row_gather": "paddle_tpu/ops/pallas_kernels/sparse_adagrad.py:231 "
                         "(fused_row_gather -> _copy_row_kernel :226)",
    "sparse_row_scatter": "paddle_tpu/ops/pallas_kernels/sparse_adagrad.py"
                          ":263 (fused_row_scatter -> _scatter_row_kernel "
                          ":258)"}
# the JAX bench's DeepFM TPU shape (bench.py:467-488): Criteo-scale vocab,
# 26 fields, embed_dim 16 + 1 first-order column, B = 4096
DEEPFM_VOCAB, DEEPFM_VIS, DEEPFM_B = 33_554_432, 17, 4096
DEEPFM_ROWS = DEEPFM_B * 26          # rows_per_step
# its hot-cache arm (bench.py:514-612): hot_rows = 2^18, 24 Zipf steps,
# the first 4 warm-up; the slab is [hot_rows + rows_per_step, 128]
HOT_ROWS, HOT_STEPS, HOT_WARMUP = 1 << 18, 24, 4
HOT_SLAB_ROWS = HOT_ROWS + DEEPFM_ROWS
HOT_ROW_SLOTS = 65536                # rows 13-14 at a power-of-two bucket


def log(msg):
    print(msg, flush=True)


def ratio(a, b):
    """a / b, or None where a reading is incomplete (None)."""
    return None if a is None or b is None or not b else a / b


def cuda_ms(fn, iters=20, warmup=3):
    """ms per call between CUDA events around back-to-back calls: the
    device time, or the host's launch time where that is longer."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(evt):
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, attr):
            return getattr(evt, attr)
    return 0.0


# -- profiler sessions held to the hand kernels' launch counters --------------
# torch.profiler loses kernel records in a process after other processes or
# threads have used the card. Every session here reads the hand-kernel
# wrappers' launch counters before and after it: each wrapper launches a
# fixed set of kernels a call (K1 is colsum + finish, K3 reduce + dx, K4
# conv + finish, a flash backward delta + main, bf16's main being dq + dk/dv),
# so the session's records of each hand kernel must equal what the counters'
# delta gives. A session with no hand kernel in it is "unchecked".
SESSIONS = []   # every session's check: {"label", "phase", "status", ...}
PHASE = ["1"]   # the phase main is in (each session records it)

_COUNTERS = (
    # (key, module, wrapper, counter)
    ("fwd", "flash_attention", "flash_attention_fwd", "launches"),
    ("fwd_wide", "flash_attention", "flash_attention_fwd", "wide_launches"),
    ("bwd", "flash_attention", "flash_attention_bwd", "launches"),
    ("bwd_wide", "flash_attention", "flash_attention_bwd", "wide_launches"),
    ("delta", "flash_attention", "flash_attention_delta", "launches"),
    ("sfwd", "flash_attention_sparse", "flash_attention_sparse_fwd",
     "launches"),
    ("sfwd_wide", "flash_attention_sparse", "flash_attention_sparse_fwd",
     "wide_launches"),
    ("sbwd", "flash_attention_sparse", "flash_attention_sparse_bwd",
     "launches"),
    ("sbwd_wide", "flash_attention_sparse", "flash_attention_sparse_bwd",
     "wide_launches"),
    ("bn_stats", "fused_bn", "bn_stats", "launches"),
    ("bn_apply", "fused_bn", "bn_apply", "launches"),
    ("apply2d", "fused_bn", "apply2d", "launches"),
    ("bn_bwd_reduce", "fused_bn", "bn_bwd_reduce", "launches"),
    ("bn_bwd_dx", "fused_bn", "bn_bwd_dx", "launches"),
    ("conv_stats", "fused_bn", "conv_stats", "launches"),
    ("adagrad", "sparse_adagrad", "fused_adagrad_update", "launches"),
    ("gather", "sparse_adagrad", "fused_row_gather", "launches"),
    ("scatter", "sparse_adagrad", "fused_row_scatter", "launches"))


def hand_launches():
    """Every hand-kernel wrapper's launch counter now (0 for a kernel
    module the run has not imported)."""
    out = {}
    for key, mod, fn, attr in _COUNTERS:
        m = sys.modules.get(f"paddle_tpu_torch.ops.kernels.{mod}")
        out[key] = getattr(getattr(m, fn, None), attr, 0) if m else 0
    return out


def expected_records(d):
    """[(kernel base names, least, most records)] that the counter deltas
    `d` give (one group a kernel family; a wide f32 backward launches
    its three roles apart or together, so its group is a range)."""
    dense_bwd, sparse_bwd = d["bwd"] - d["bwd_wide"], d["sbwd"] - d["sbwd_wide"]
    wide_bwd = d["bwd_wide"] + d["sbwd_wide"]

    def exact(names, n):
        return (names, n, n)

    return [
        exact(("flash_fwd_f32_kernel", "flash_fwd_bf16_kernel"),
              d["fwd"] - d["fwd_wide"]),
        exact(("sparse_fwd_f32_kernel", "sparse_fwd_bf16_kernel"),
              d["sfwd"] - d["sfwd_wide"]),
        exact(("wide_fwd_f32_kernel", "wide_fwd_bf16_kernel"),
              d["fwd_wide"] + d["sfwd_wide"]),
        exact(("flash_bwd_delta_kernel",), d["bwd"] + d["sbwd"] + d["delta"]),
        exact(("flash_bwd_f32_kernel", "flash_bwd_dq_bf16_kernel"),
              dense_bwd),
        exact(("sparse_bwd_f32_kernel", "sparse_bwd_bf16_kernel"),
              sparse_bwd),
        (("wide_bwd_bf16_kernel", "wide_bwd_f32_kernel",
          "wide_role_f32_kernel"), wide_bwd, 3 * wide_bwd),
        exact(("colsum_kernel",), d["bn_stats"] + d["bn_bwd_reduce"]),
        exact(("finish_kernel",),
              d["bn_stats"] + d["bn_bwd_reduce"] + d["conv_stats"]),
        exact(("apply_kernel",), d["bn_apply"] + d["apply2d"]),
        exact(("bwd_dx_kernel",), d["bn_bwd_dx"]),
        exact(("conv_stats_f32_kernel", "conv_stats_bf16_kernel"),
              d["conv_stats"]),
        exact(("adagrad_kernel",), d["adagrad"]),
        exact(("gather_kernel",), d["gather"]),
        exact(("scatter_kernel",), d["scatter"])]


def check_session(before, after, records):
    """A session's check: `records` {kernel base name: records} of its
    trace against the counters' delta. Returns {"status": "checked" |
    "short" | "over" | "unchecked", "want", "got"}: "short" where a group
    has fewer records than the counters launched, "over" where it has
    more (a launch no counter saw)."""
    d = {k: after[k] - before[k] for k in after}
    want, got, status = {}, {}, "checked"
    for names, lo, hi in expected_records(d):
        n = sum(records.get(k, 0) for k in names)
        if lo == hi == n == 0:
            continue
        key = "|".join(names)
        want[key], got[key] = (lo if lo == hi else [lo, hi]), n
        if n < lo:
            status = "short"
        elif n > hi and status != "short":
            status = "over"
    dq, dkv = (records.get("flash_bwd_dq_bf16_kernel", 0),
               records.get("flash_bwd_dkv_bf16_kernel", 0))
    if dq or dkv:
        want["flash_bwd_dkv_bf16_kernel"], got[
            "flash_bwd_dkv_bf16_kernel"] = dq, dkv
        if dkv < dq:
            status = "short"
        elif dkv > dq and status != "short":
            status = "over"
    if not want:
        status = "unchecked"
    return {"status": status, "want": want, "got": got}


def session_records(prof):
    """{hand kernel base name: records} of a torch.profiler session."""
    from paddle_tpu_torch.observability.kernel_counts import (HAND_KERNELS,
                                                               base_name)

    out = {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) is None \
                or "cuda" not in str(evt.device_type).lower():
            continue
        b = base_name(evt.key)
        if b in HAND_KERNELS:
            out[b] = out.get(b, 0) + evt.count
    return out


def note_session(label, chk, tries):
    """Keep a session's check; print it when it is not a clean one."""
    rec = {"label": label, "phase": PHASE[0], "status": chk["status"],
           "tries": tries}
    if chk["status"] not in ("checked", "unchecked"):
        rec.update(want=chk["want"], got=chk["got"])
        log("profile session " + json.dumps(rec))
    SESSIONS.append(rec)
    return rec


def _profile_once(fn, iters):
    """One torch.profiler session over `iters` calls of fn: (prof, wall us
    per call, its check)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    before = hand_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6 / iters
    return prof, wall, check_session(before, hand_launches(),
                                     session_records(prof))


def profile_device(fn, iters=10, counts=None, tries=1, label=None):
    """Device time by kernel name over `iters` calls of fn, from
    torch.profiler: ({name: us per call}, wall us per call, device
    events per call). `counts`, if given, gets {name: launches per call}.
    The session is held to the launch counters (`check_session`); a short
    one is taken again, up to `tries` sessions in all, and one still short
    returns no device numbers ({}, wall, 0): the reading is incomplete."""
    import torch

    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        prof, wall, chk = _profile_once(fn, iters)
        if chk["status"] in ("checked", "unchecked"):
            break
    code = getattr(fn, "__code__", None)
    rec = note_session(label or (f"{fn.__name__}:{code.co_firstlineno}"
                                 if code else "session"), chk, attempt + 1)
    profile_device.last = rec
    if rec["status"] not in ("checked", "unchecked"):
        log(f"profile {rec['label']}: incomplete after {attempt + 1} "
            f"sessions; no device numbers")
        return {}, wall, 0
    per, events = {}, 0
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and getattr(evt, "device_type", None) is not None \
                and "cuda" in str(evt.device_type).lower():
            per[evt.key] = per.get(evt.key, 0.0) + us / iters
            events += evt.count
            if counts is not None:
                counts[evt.key] = counts.get(evt.key, 0) + evt.count / iters
    return per, wall, events / iters


profile_device.last = None


def device_ms(fn):
    """ms of device time per call of fn, summed over its kernels, from the
    first profiler session that passes the launch-counter check and
    reports device events, of at most six (three, when the first three
    all come back short: a process that drops records keeps dropping
    them). It was the median of three sessions, a guard against sessions
    that came back with none or a fraction of their kernels, which the
    check now catches. When none passes, the profile
    is incomplete and the time comes from CUDA events around 20
    back-to-back calls instead (`cuda_ms`: the device time, or the host's
    launch time where that is longer), said so in the session's record."""
    for i in range(6):
        per, _, _ = profile_device(fn)
        if per:
            return sum(per.values()) / 1e3
        if i == 2 and profile_device.last["status"] not in (
                "checked", "unchecked"):
            break
    ms = cuda_ms(fn)
    profile_device.last["cuda_event_ms"] = ms
    log(f"profile {profile_device.last['label']}: CUDA-event ms {ms:.6f} "
        f"in place of the incomplete profile")
    return ms


def cold_device_ms(fn, iters=10):
    """ms of device time per call of fn with the L2 cache flushed before
    each call (a 64 MB in-place bitwise_not, whose own kernel is left out of
    the sum): a row kernel called back to back on the same rows would
    otherwise find them in the 50 MB L2 and beat the HBM bound. At most
    three sessions; CUDA events in their place when none passes the
    launch-counter check (as `device_ms`)."""
    import torch

    buf = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")

    def call():
        buf.bitwise_not_()
        fn()

    per = {}
    for _ in range(3):
        per, _, _ = profile_device(call, iters)
        per = {k: v for k, v in per.items() if "bitwise_not" not in k}
        if per:
            break
    if per:
        return sum(per.values()) / 1e3
    # an incomplete profile: CUDA events around the flushed calls, less
    # the flush's own time
    ms = cuda_ms(call, iters) - cuda_ms(buf.bitwise_not_, iters)
    profile_device.last["cuda_event_ms"] = ms
    log(f"profile {profile_device.last['label']}: CUDA-event ms {ms:.6f} "
        f"(cold) in place of the incomplete profile")
    return ms


def category(name):
    """The kind of a kernel, from its name."""
    n = name.lower()
    if "::adagrad_kernel(" in n:
        return "sparse adagrad row 12 (hand kernel)"
    if "::gather_kernel(" in n or "::scatter_kernel(" in n:
        return "row gather/scatter 13-14 (hand kernels)"
    if "segment_reduce" in n:
        return "duplicate merge: segment sums"
    if "sparse_fwd" in n:
        return "flash sparse fwd (hand kernel)"
    if "sparse_bwd" in n or "sparse_dq" in n or "sparse_dkv" in n:
        return "flash sparse bwd (hand kernels)"
    if "bwd_delta" in n:   # the backwards' delta kernel, dense and sparse
        return "flash bwd delta (hand kernel)"
    if "flash_fwd" in n:
        return "flash fwd (hand kernel)"
    if "flash_bwd" in n:
        return "flash bwd (hand kernels)"
    if "conv_stats_" in n:
        return "fused conv+stats K4 (hand kernel)"
    if "colsum_kernel" in n:
        # template flag BWD: colsum_kernel<T, false, ...> is K1
        return ("fused BN bwd reduce K3 (hand kernel)"
                if "colsum_kernel<" in n and ", true," in n.split(">")[0]
                else "fused BN stats K1 (hand kernel)")
    if "finish_kernel" in n:
        return "fused BN partial sums K1/K3/K4 (hand kernel)"
    if "multi_tensor_apply" in n:   # torch._foreach_* (fused updates)
        return "multi-tensor updates (foreach)"
    if "apply_kernel" in n:
        return "fused BN apply K2 (hand kernel)"
    if "bwd_dx_kernel" in n:
        return "fused BN bwd dx K3 (hand kernel)"
    if any(k in n for k in ("fprop", "dgrad", "wgrad", "conv", "cudnn",
                            "implicit")):
        return "convolutions (cuDNN)"
    if "nchwtonhwc" in n or "nhwctonchw" in n:
        return "layout transforms"
    if "pool" in n:
        return "pooling"
    if "gemm" in n or "xmma" in n or "nvjet" in n:
        return "GEMMs (cuBLAS)"
    if "memcpy" in n or "memset" in n:
        return "memcpy/memset"
    if "copy" in n:
        return "dtype casts and copies"
    if "reduce" in n:
        return "reductions"
    if "elementwise" in n:
        return "elementwise"
    # kinds named since the DeepFM phase; before it, these kernels (BERT's
    # and NMT's embedding-grad sorts, NMT's searchsorted) counted as other
    if "radix" in n or "sort" in n:
        return "sorts"
    if "index" in n and ("select" in n or "put" in n):
        return "indexed gathers/stores"
    return "other"


def profile_record(label, fn, iters):
    """One JSON-able breakdown of a warm call of fn on the card: device ms
    per call by kind of kernel, the top kernels overall and the top ones
    the kinds above do not name."""
    import torch

    counts = {}
    per, wall_us, events = profile_device(fn, iters=iters, counts=counts,
                                          tries=6, label=label)
    if profile_device.last["status"] not in ("checked", "unchecked"):
        return {"call": label, "wall_ms": wall_us / 1e3,
                "profile": "incomplete", "device_busy_ms": None,
                "device_busy_share": None, "device_events": None,
                "peak_memory_MiB": torch.cuda.max_memory_allocated() / 2**20,
                "by_category_ms": {}, "by_category_events": {},
                "top_kernels_ms": [], "top_other_kernels_ms": [],
                "copy_kernels_per_call": []}
    busy = sum(per.values())
    ranked = sorted(per.items(), key=lambda kv: -kv[1])
    cats, cat_n = {}, {}
    for name, us in per.items():
        cats[category(name)] = cats.get(category(name), 0.0) + us / 1e3
        cat_n[category(name)] = cat_n.get(category(name), 0) + counts[name]
    return {"call": label, "wall_ms": wall_us / 1e3,
            "profile": profile_device.last["status"],
            "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / wall_us if wall_us else None,
            "device_events": events,
            "peak_memory_MiB": torch.cuda.max_memory_allocated() / 2**20,
            "by_category_ms": dict(sorted(cats.items(),
                                          key=lambda kv: -kv[1])),
            "by_category_events": cat_n,
            "top_kernels_ms": [[k[:90], us / 1e3] for k, us in ranked[:10]],
            "top_other_kernels_ms": [[k[:90], us / 1e3] for k, us in ranked
                                     if category(k) == "other"][:5],
            "copy_kernels_per_call": [
                [k[:90], counts[k], us / 1e3] for k, us in ranked
                if category(k) == "dtype casts and copies"][:6]}


def max_err(got, want, tol):
    """max |got - want| and whether every element is within
    atol + rtol·|want| (rtol = atol = tol)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    return float(diff.max()), bool((diff <= tol + tol * w.abs()).all())


def heads(x, nh):
    return x.unflatten(-1, (nh, x.shape[-1] // nh)).transpose(1, 2)


def qkv_inputs(b, nh, t, d, dtype, gen):
    """q, k, v as the main path hands them over: [B, nh, T, d] views of the
    q/k/v thirds of one fused [B, T, 3·nh·d] projection."""
    import torch

    qkv = torch.randn(b, t, 3 * nh * d, generator=gen, device="cuda").to(dtype)
    return [heads(x, nh) for x in qkv.split(nh * d, dim=-1)]


def bert_mask(b, t, dtype):
    """The BERT [B,1,1,T] additive mask, last quarter padded, read per
    batch by the kernels."""
    import torch

    mask = torch.zeros(b, 1, 1, t, device="cuda", dtype=dtype)
    mask[..., 3 * t // 4:] = -10000.0
    return mask


def bound(flops, nbytes, name, peak=None):
    t_ops = flops / (peak or PEAK_FLOPS[name]) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


# the f32 kernels whose products run on the tensor cores in 3xTF32
F32_TC_KERNELS = ("flash_fwd_f32", "flash_bwd_f32", "sparse_fwd_f32",
                  "sparse_bwd_f32", "conv_stats_f32")


def log_wgmma_build(build):
    """ptxas's registers, shared memory and spills for each bf16 flash
    kernel by name (the dense ones, the sparse forward and backward), the
    f32 flash kernels on the tensor cores (the dense and sparse forwards and
    backwards: each backward's dk/dv and dq CTAs in one kernel; the f32
    sparse forward's dynamic shared memory and the CTAs an SM it allows),
    K2's apply_kernel, K3's bwd_dx_kernel, K4's conv_stats_f32_kernel and
    conv_stats_bf16_kernel and the wide flash kernels; where the toolkit
    has cuobjdump, the count of HGMMA (wgmma) and UTMALDG (TMA load)
    instructions in each flash library and in each bf16 sparse kernel, of
    HMMA (mma.sync) instructions in each f32 tensor-core flash kernel, of
    HGMMA, HMMA and UTMALDG in each wide kernel (the bf16 wide forward's
    products on wgmma), and of HGMMA and HMMA in K4."""
    import ctypes
    import re

    from paddle_tpu_torch.observability.kernel_counts import kernel_label

    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "cuobjdump")
    for lib in ("flash_attention_fwd", "flash_attention_bwd",
                "flash_attention_sparse", "fused_bn", "flash_attention_wide"):
        fn = None
        for line in build.build_log(lib).splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?(\w+)'?", line)
            if m:
                fn = kernel_label(m.group(1)) or m.group(1)
            elif fn and ("bf16" in fn or fn.startswith(F32_TC_KERNELS)
                         or "apply_kernel" in fn or "bwd_dx_kernel" in fn
                         or "wide_" in fn) \
                    and ("Used" in line or "spill" in line
                         or "Performance" in line):
                log(f"build {lib} {fn}: {line.split(':', 1)[-1].strip()}")
        if lib in ("fused_bn", "flash_attention_wide"):
            # K4's wgmma (HGMMA) and the wide kernels' mma.sync (HMMA)
            if os.path.exists(cuobjdump):
                sass = subprocess.run(
                    [cuobjdump, "-sass", build._target(lib)],
                    capture_output=True, text=True, check=True).stdout
                for section in sass.split("Function : ")[1:]:
                    name = kernel_label(section.split(None, 1)[0]) or ""
                    if "conv_stats_" in name or "wide_" in name:
                        log(f"build {lib} {name}: {section.count('HGMMA')} "
                            f"HGMMA, {section.count('HMMA')} HMMA and "
                            f"{section.count('UTMALDG')} UTMALDG "
                            f"instructions (cuobjdump)")
            if lib == "flash_attention_wide":
                smem = build.load(lib).flash_attention_wide_smem
                smem.argtypes = [ctypes.c_int] * 2
                smem.restype = ctypes.c_int
                log(f"build {lib}: dynamic shared memory f32 {smem(0, 0)}, "
                    f"bf16 forward {smem(1, 0)}, bf16 backward {smem(1, 1)} "
                    f"bytes a CTA at every head dim")
            continue
        lib_so = build.load(lib)
        sparse = lib == "flash_attention_sparse"
        query = getattr(lib_so, f"{lib}_bwd_bf16_smem" if sparse
                        else f"{lib}_bf16_smem")
        query.argtypes = [ctypes.c_int] * (1 if sparse else 2
                                           if lib.endswith("fwd") else 3)
        query.restype = ctypes.c_int
        if sparse:
            fwd_query = lib_so.flash_attention_sparse_fwd_bf16_smem
            f32_query = lib_so.flash_attention_sparse_fwd_smem
            for fn in (fwd_query, f32_query):
                fn.argtypes = [ctypes.c_int]
                fn.restype = ctypes.c_int
        for d in (64, 128) + WIDE_D:   # bias mode 1 = the mask, 2 = per q
            if sparse:
                smem = {"fwd": fwd_query(d), "bwd": query(d)}
                # 228 KB of shared memory an SM, 1 KB of it reserved a CTA
                log(f"build {lib}: f32 fwd d={d} dynamic shared memory "
                    f"{f32_query(d)} bytes a CTA, "
                    f"{233472 // (f32_query(d) + 1024)} CTAs an SM by it")
            elif lib == "flash_attention_fwd":
                smem = {f"fwd mode {m}": query(d, m) for m in (1, 2)}
            else:
                smem = {f"{k} mode {m}": query(i, d, m)
                        for i, k in enumerate(("dq", "dkv")) for m in (1, 2)}
            log(f"build {lib}: bf16 d={d} dynamic shared memory {smem} "
                f"bytes a CTA")
        if os.path.exists(cuobjdump):
            sass = subprocess.run([cuobjdump, "-sass", build._target(lib)],
                                  capture_output=True, text=True,
                                  check=True).stdout
            log(f"build {lib}: {sass.count('HGMMA')} HGMMA and "
                f"{sass.count('UTMALDG')} UTMALDG instructions (cuobjdump)")
            for section in sass.split("Function : ")[1:]:
                name = kernel_label(section.split(None, 1)[0]) or ""
                if name.startswith(F32_TC_KERNELS):
                    log(f"build {lib} {name}: {section.count('HMMA')} HMMA "
                        f"instructions (cuobjdump)")
                elif sparse and "bf16" in name:
                    log(f"build {lib} {name}: {section.count('HGMMA')} HGMMA "
                        f"and {section.count('UTMALDG')} UTMALDG "
                        f"instructions (cuobjdump)")
        else:
            log(f"build {lib}: no cuobjdump in the toolkit, HGMMA not counted")


def ratios(rec):
    """Each kernel time against its library call and its bound, from the
    same run: ms / library_ms, and bound_ms / ms (the share of the bound)."""
    for key in ("ms", "dropout_ms"):
        rec[f"{key}_vs_library"] = rec[key] / rec["library_ms"]
        rec[f"{key}_bound_share"] = rec["bound_ms"] / rec[key]
    return rec


def phase_kernel(fa):
    """Flash forward against its plain version, without and with dropout;
    returns the record of the main-path shapes per (dtype, T)."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator("cuda").manual_seed(0)
    records = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        tol = TOL[name]
        for t in SEQS:
            q, k, v = qkv_inputs(B, NH, t, D, dtype, gen)
            bias = bert_mask(B, t, dtype)
            out, lse = fa.flash_attention_fwd(q, k, v, bias)
            ref_out, ref_lse = fa.flash_attention_fwd_plain(q, k, v, bias)
            torch.cuda.synchronize()
            e_out, ok_out = max_err(out, ref_out, tol)
            e_lse, ok_lse = max_err(lse, ref_lse, tol)
            # dropout: the same seed gives the plain version the same mask
            d_out, d_lse = fa.flash_attention_fwd(q, k, v, bias, False, None,
                                                  DROPOUT, 77)
            rd_out, rd_lse = fa.flash_attention_fwd_plain(q, k, v, bias,
                                                          False, None,
                                                          DROPOUT, 77)
            other, _ = fa.flash_attention_fwd(q, k, v, bias, False, None,
                                              DROPOUT, 78)
            torch.cuda.synchronize()
            e_dout, ok_dout = max_err(d_out, rd_out, tol)
            e_dlse, ok_dlse = max_err(d_lse, rd_lse, tol)
            if torch.equal(other, d_out) or torch.equal(d_out, out):
                raise AssertionError(f"flash_attention_fwd {name} T={t}: "
                                     f"dropout output does not depend on "
                                     f"the seed")
            launch_ms = cuda_ms(lambda: fa.flash_attention_fwd(q, k, v, bias))
            sdpa_mask = bias.expand(B, NH, t, t)
            ms, drop_ms, plain_ms, library_ms = (device_ms(fn) for fn in (
                lambda: fa.flash_attention_fwd(q, k, v, bias),
                lambda: fa.flash_attention_fwd(q, k, v, bias, False, None,
                                               DROPOUT, 77),
                lambda: fa.flash_attention_fwd_plain(q, k, v, bias),
                lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=sdpa_mask)))
            flops, nbytes = fa.fwd_counts(q, k, bias)
            bound_ms, bound_by = bound(flops, nbytes, name)
            extra = {}
            if name == "float32":
                # 3xTF32 on the tensor cores, as the f32 backward: that is
                # its least time; the CUDA-core FMA bound stays beside it
                extra["bound_fma_ms"] = bound_ms
                bound_ms, bound_by = bound(3 * flops, nbytes, name,
                                           TF32_PEAK_FLOPS)
            rec = {"dtype": name, "B": B, "nh": NH, "T": t, "d": D,
                   "max_abs_err_out": e_out, "max_abs_err_lse": e_lse,
                   "max_abs_err_dropout": max(e_dout, e_dlse),
                   "tol": tol, "ms": ms, "dropout_ms": drop_ms,
                   "launch_ms": launch_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "flops": flops, "bytes": nbytes,
                   "bound_ms": bound_ms, "bound_by": bound_by, **extra}
            log("kernel fwd " + json.dumps(ratios(rec)))
            if not (ok_out and ok_lse and ok_dout and ok_dlse):
                raise AssertionError(f"flash_attention_fwd {name} T={t} "
                                     f"disagrees with its plain version: {rec}")
            records[(name, t)] = rec

        # edge cases at small shapes: causal, a per-q bias, ragged T, d=128,
        # one and four key tiles with the mask, d=128 causal with dropout
        for label, (b, nh, tq, d), causal, kind, rate in (
                ("causal", (2, 3, 200, 64), True, None, 0.0),
                ("per_q_bias", (2, 3, 128, 64), False, "per_q", 0.0),
                ("ragged_T", (2, 2, 100, 64), False, None, 0.0),
                ("d128_causal_ragged", (2, 2, 130, 128), True, "per_q", 0.0),
                ("T64_mask", (2, 3, 64, 64), False, "mask", 0.0),
                ("T256_mask_dropout", (2, 3, 256, 64), False, "mask",
                 DROPOUT),
                ("ragged_T130_mask", (2, 3, 130, 64), False, "mask", 0.0),
                ("d128_causal_dropout0.2", (2, 3, 130, 128), True, None,
                 0.2)):
            q, k, v = qkv_inputs(b, nh, tq, d, dtype, gen)
            bias = None
            if kind == "per_q":
                bias = torch.randn(b, nh, tq, tq, generator=gen,
                                   device="cuda").to(dtype)
            elif kind == "mask":
                bias = bert_mask(b, tq, dtype)
            out, lse = fa.flash_attention_fwd(q, k, v, bias, causal, None,
                                              rate, 13)
            ref_out, ref_lse = fa.flash_attention_fwd_plain(q, k, v, bias,
                                                            causal, None,
                                                            rate, 13)
            torch.cuda.synchronize()
            e_out, ok_out = max_err(out, ref_out, tol)
            e_lse, ok_lse = max_err(lse, ref_lse, tol)
            log(f"kernel fwd edge {name} {label} B={b} nh={nh} T={tq} d={d} "
                f"dropout={rate}: max_abs_err out {e_out:.3e} lse "
                f"{e_lse:.3e} (tol {tol})")
            if not (ok_out and ok_lse):
                raise AssertionError(f"flash_attention_fwd {name} {label} "
                                     f"disagrees with its plain version")

    # the keep rate over B·nh·T² draws of the mask the kernels draw (the
    # dropout checks above hold the kernels to this plain mask bit for bit)
    keep = fa.dropout_keep_mask(77, DROPOUT, B, NH, 512, 512, "cuda")
    n = keep.numel()
    rate = keep.float().mean().item()
    sigma = ((1 - DROPOUT) * DROPOUT / n) ** 0.5
    log(f"kernel dropout keep rate {rate:.6f} over {n} draws "
        f"(expected {1 - DROPOUT}, 5 sigma = {5 * sigma:.2e})")
    if abs(rate - (1 - DROPOUT)) > 5 * sigma:
        raise AssertionError("dropout keep rate is off")
    return records


def bwd_errs(got, want, name):
    """Max |err| of each backward output and whether each is within the
    tolerance of its dtype."""
    errs, ok = {}, True
    for label, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        if w is None:
            continue
        tol = BWD_TOL[name if label != "dbias" else "float32"]
        if name == "bfloat16" and label != "dbias":
            e = float((g.float() - w.float()).abs().max())
            ok &= e <= tol * float(w.float().abs().max())
        else:
            e, good = max_err(g, w, tol)
            ok &= good
        errs[label] = e
    return errs, ok


def phase_kernel_bwd(fa):
    """Flash backward against its plain version at the main path's shapes
    (f32 and bf16, without and with dropout) and at edge cases with dbias;
    returns the record of the main-path shapes per (dtype, T)."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator("cuda").manual_seed(1)
    records = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for t in SEQS:
            q, k, v = qkv_inputs(B, NH, t, D, dtype, gen)
            bias = bert_mask(B, t, dtype)
            dout = heads(torch.randn(B, t, HIDDEN, generator=gen,
                                     device="cuda").to(dtype), NH)
            errs = {}
            for rate in (0.0, DROPOUT):
                out, lse = fa.flash_attention_fwd(q, k, v, bias, False, None,
                                                  rate, 91)
                got = fa.flash_attention_bwd(q, k, v, out, lse, dout, bias,
                                             False, None, rate, 91)
                want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                                    bias, False, None, rate,
                                                    91)
                torch.cuda.synchronize()
                e, ok = bwd_errs(got, want, name)
                errs[f"dropout={rate}"] = e
                if not ok:
                    raise AssertionError(f"flash_attention_bwd {name} T={t} "
                                         f"dropout={rate} disagrees with its "
                                         f"plain version: {e}")
                # every output is written by one CTA: a second call gives
                # the same bits
                again = fa.flash_attention_bwd(q, k, v, out, lse, dout, bias,
                                               False, None, rate, 91)
                if not all(torch.equal(a, b) for a, b in zip(got[:3],
                                                              again[:3])):
                    raise AssertionError(f"flash_attention_bwd {name} T={t} "
                                         f"dropout={rate}: two calls differ")
            out, lse = fa.flash_attention_fwd(q, k, v, bias)
            ms, drop_ms, plain_ms = (device_ms(fn) for fn in (
                lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout, bias),
                lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout, bias,
                                               False, None, DROPOUT, 91),
                lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                                     bias)))
            # yardstick: the backward of PyTorch's SDPA with the same mask
            lq, lk, lv = (x.detach().requires_grad_() for x in (q, k, v))
            lout = F.scaled_dot_product_attention(
                lq, lk, lv, attn_mask=bias.expand(B, NH, t, t))
            library_ms = device_ms(lambda: torch.autograd.grad(
                lout, (lq, lk, lv), dout, retain_graph=True))
            flops, nbytes = fa.bwd_counts(q, k, bias)
            bound_ms, bound_by = bound(flops, nbytes, name)
            extra = {}
            if name == "float32":
                # the f32 kernels run three TF32 products per product on
                # the tensor cores (3xTF32): that is their least time; the
                # CUDA-core FMA bound stays beside it
                extra["bound_fma_ms"] = bound_ms
                bound_ms, bound_by = bound(3 * flops, nbytes, name,
                                           TF32_PEAK_FLOPS)
            rec = {"dtype": name, "B": B, "nh": NH, "T": t, "d": D,
                   "max_abs_err": errs, "ms": ms, "dropout_ms": drop_ms,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "flops": flops, "bytes": nbytes, "bound_ms": bound_ms,
                   "bound_by": bound_by, **extra}
            log("kernel bwd " + json.dumps(ratios(rec)))
            records[(name, t)] = rec

        # edge cases: causal, per-q bias (dbias per query), ragged T with
        # the mask (column-sum dbias), d=128 causal ragged with dropout
        for label, (b, nh, tq, d), causal, kind, rate in (
                ("causal", (2, 3, 200, 64), True, None, 0.0),
                ("per_q_bias", (2, 3, 128, 64), False, "per_q", 0.0),
                ("ragged_T_mask", (2, 2, 100, 64), False, "col", 0.0),
                ("d128_causal_ragged", (2, 2, 130, 128), True, "per_q",
                 DROPOUT),
                ("T64_mask", (2, 3, 64, 64), False, "col", 0.0),
                ("T256_mask_dropout", (2, 3, 256, 64), False, "col",
                 DROPOUT),
                ("ragged_T130_mask", (2, 3, 130, 64), False, "col", 0.0),
                ("d128_causal_dropout0.2", (2, 3, 128, 128), True, None,
                 0.2)):
            q, k, v = qkv_inputs(b, nh, tq, d, dtype, gen)
            bias = None
            if kind == "per_q":
                bias = torch.randn(b, nh, tq, tq, generator=gen,
                                   device="cuda").to(dtype)
            elif kind == "col":
                bias = bert_mask(b, tq, dtype)
            dout = torch.randn(b, nh, tq, d, generator=gen,
                               device="cuda").to(dtype)
            out, lse = fa.flash_attention_fwd(q, k, v, bias, causal, None,
                                              rate, 5)
            got = fa.flash_attention_bwd(q, k, v, out, lse, dout, bias,
                                         causal, None, rate, 5, kind)
            want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, bias,
                                                causal, None, rate, 5, kind)
            torch.cuda.synchronize()
            e, ok = bwd_errs(got, want, name)
            again = fa.flash_attention_bwd(q, k, v, out, lse, dout, bias,
                                           causal, None, rate, 5, kind)
            same = all(a is None or torch.equal(a, c)
                       for a, c in zip(got, again))
            log(f"kernel bwd edge {name} {label} B={b} nh={nh} T={tq} d={d} "
                f"dropout={rate}: max_abs_err {json.dumps(e)}; a second call "
                f"bitwise equal: {same}")
            if not ok or not same:
                raise AssertionError(f"flash_attention_bwd {name} {label} "
                                     f"disagrees with its plain version")
    return records


def phase_kernel_routes(fa):
    """The delta kernel against its plain version (d = 64 to 512); the flat
    grid at B·nh = 65,600 (forward and backward against the plain
    versions); d = 32 through the flash_attention op takes the plain route
    on the card (counted, as the JAX package takes its XLA path), d = 320
    launches the wide kernel once."""
    import torch
    from paddle_tpu_torch.core.executor import ExecContext
    from paddle_tpu_torch.core.registry import get_op

    gen = torch.Generator("cuda").manual_seed(2)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for d in (D, 128) + WIDE_D + WIDER_D:
            out, dout, _ = qkv_inputs(B, NH, 512, d, dtype, gen)
            e, ok = max_err(fa.flash_attention_delta(out, dout),
                            fa.flash_attention_delta_plain(out, dout), 1e-4)
            log(f"kernel delta {name} B={B} nh={NH} T=512 d={d}: max_abs_err"
                f" {e:.3e} (tol 1e-4)")
            if not ok:
                raise AssertionError(f"the delta kernel disagrees with its "
                                     f"plain version at {name} d = {d}")
    # the f32 delta kernel beside the plain chain (multiply, sum) it
    # replaced on the f32 backward's path, at BERT f32's shapes; L2 flushed
    # before each call, since out and dO (25 MB at T=512) would stay in it
    for t in SEQS:
        out, dout, _ = qkv_inputs(B, NH, t, D, torch.float32, gen)
        ms, plain_ms = (cold_device_ms(fn) for fn in (
            lambda: fa.flash_attention_delta(out, dout),
            lambda: fa.flash_attention_delta_plain(out, dout)))
        nbytes = 2 * out.numel() * 4 + B * NH * t * 4
        log("kernel delta " + json.dumps({
            "dtype": "float32", "B": B, "nh": NH, "T": t, "d": D, "ms": ms,
            "plain_ms": plain_ms, "bytes": nbytes,
            "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes"}))

    b, nh, t = 50, 1312, 64        # B·nh = 65,600 > 65,535
    q, k, v = qkv_inputs(b, nh, t, D, torch.bfloat16, gen)
    o, lse = fa.flash_attention_fwd(q, k, v)
    ro, rl = fa.flash_attention_fwd_plain(q, k, v)
    g = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    errs, ok = bwd_errs(fa.flash_attention_bwd(q, k, v, o, lse, g),
                        fa.flash_attention_bwd_plain(q, k, v, o, lse, g),
                        "bfloat16")
    e_o, ok_o = max_err(o, ro, TOL["bfloat16"])
    e_l, ok_l = max_err(lse, rl, TOL["bfloat16"])
    log(f"kernel grid B·nh={b * nh} T={t} bf16: fwd max_abs_err out "
        f"{e_o:.3e} lse {e_l:.3e}; bwd {json.dumps(errs)}")
    if not (ok and ok_o and ok_l):
        raise AssertionError("the flat grid at B·nh = 65,600 disagrees")
    del q, k, v, o, lse, ro, rl, g

    # BERT with hidden 384 and 12 heads: d = 32 through the op
    x = torch.randn(2, 128, 384, generator=gen, device="cuda").to(
        torch.bfloat16)
    before = (fa.flash_attention_fwd.launches,
              fa.flash_attention_fwd.plain_on_cuda)
    y = get_op("flash_attention").fn(
        ExecContext("cuda", is_test=True), {"Q": [x], "K": [x], "V": [x]},
        {"num_heads": 12})["Out"][0]
    ref = fa.flash_attention_fwd_plain(heads(x, 12), heads(x, 12),
                                       heads(x, 12))[0]
    e, ok = max_err(heads(y, 12), ref, 0.0)
    after = (fa.flash_attention_fwd.launches,
             fa.flash_attention_fwd.plain_on_cuda)
    log(f"op flash_attention d=32 on the card: plain route, launches "
        f"{after[0] - before[0]}, plain-route calls {after[1] - before[1]}, "
        f"max_abs_err to the plain version {e:.3e}")
    if after != (before[0], before[1] + 1) or not ok:
        raise AssertionError("d = 32 did not take the counted plain route")
    # hidden 640 and 2 heads: d = 320 through the op, on the wide kernel
    x = torch.randn(2, 128, 640, generator=gen, device="cuda").to(
        torch.bfloat16)
    fwd = fa.flash_attention_fwd
    before = (fwd.launches, fwd.wide_launches, fwd.plain_on_cuda)
    y = get_op("flash_attention").fn(
        ExecContext("cuda", is_test=True), {"Q": [x], "K": [x], "V": [x]},
        {"num_heads": 2})["Out"][0]
    torch.cuda.synchronize()
    after = (fwd.launches, fwd.wide_launches, fwd.plain_on_cuda)
    ref = fa.flash_attention_fwd_plain(heads(x, 2), heads(x, 2),
                                       heads(x, 2))[0]
    e, ok = max_err(heads(y, 2), ref, TOL["bfloat16"])
    log(f"op flash_attention d=320 on the card: (launches, wide launches, "
        f"plain-route calls) {before} -> {after}, max_abs_err to the plain "
        f"version {e:.3e}")
    if after != (before[0] + 1, before[1] + 1, before[2]) or not ok:
        raise AssertionError("d = 320 did not run once on the wide kernel")


def flash_counts(fa, fas):
    """Launches and plain-route calls of the four flash wrappers."""
    return [(f.launches, f.plain_on_cuda) for f in (
        fa.flash_attention_fwd, fa.flash_attention_bwd,
        fas.flash_attention_sparse_fwd, fas.flash_attention_sparse_bwd)]


def phase_kernel_wide(fa, fas):
    """Head dims 192 and 256 (which the JAX package sends to Pallas)
    through every flash kernel family, f32 and bf16, with dropout, against
    the plain versions at B=2, nh=2, T=256: the dense forward and backward
    with the [B,1,1,T] mask (column-sum dbias), the sparse forward and
    backward on two packed NMT rows, causal; each call one kernel launch
    and no plain-route call; the sparse backward bitwise repeatable.
    Returns the records with the kernels' and plain versions' times."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator("cuda").manual_seed(6)
    b, nh, t = 2, 2, 256
    ((stack, _),) = nmt_batches(b, t, 1)
    seg = torch.tensor(stack["tgt_seg"], device="cuda")
    se = fas.pack_se(seg, seg)
    vis = fas.compute_block_vis(se, t, t, causal=True)
    mask = fas._mask(se, None, t, t, True)
    records = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for d in WIDE_D:
            q, k, v = qkv_inputs(b, nh, t, d, dtype, gen)
            dout = heads(torch.randn(b, t, nh * d, generator=gen,
                                     device="cuda").to(dtype), nh)
            bias = bert_mask(b, t, dtype)
            before = flash_counts(fa, fas)
            out, lse = fa.flash_attention_fwd(q, k, v, bias, False, None,
                                              DROPOUT, 17)
            ref = fa.flash_attention_fwd_plain(q, k, v, bias, False, None,
                                               DROPOUT, 17)
            got = fa.flash_attention_bwd(q, k, v, out, lse, dout, bias, False,
                                         None, DROPOUT, 17, "col")
            want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, bias,
                                                False, None, DROPOUT, 17,
                                                "col")
            s_out, s_lse = fas.flash_attention_sparse_fwd(
                q, k, v, se, vis, True, None, DROPOUT, 17)
            s_ref = fas.flash_attention_sparse_fwd_plain(
                q, k, v, se, vis, True, None, DROPOUT, 17)
            s_got = fas.flash_attention_sparse_bwd(
                q, k, v, s_out, s_lse, dout, se, vis, True, None, DROPOUT, 17)
            s_want = fas.flash_attention_sparse_bwd_plain(
                q, k, v, s_out, s_lse, dout, se, vis, True, None, DROPOUT, 17)
            s_again = fas.flash_attention_sparse_bwd(
                q, k, v, s_out, s_lse, dout, se, vis, True, None, DROPOUT, 17)
            torch.cuda.synchronize()
            after = flash_counts(fa, fas)
            errs, ok = {}, True
            for label, (gt, wt) in (("fwd", ((out, lse), ref)),
                                    ("sparse_fwd", ((s_out, s_lse), s_ref))):
                e = [max_err(x, y, TOL[name]) for x, y in zip(gt, wt)]
                errs[label] = max(x[0] for x in e)
                ok &= all(x[1] for x in e)
            for label, gt, wt in (("bwd", got, want),
                                  ("sparse_bwd", s_got, s_want)):
                e, good = bwd_errs(gt, wt, name)
                errs[label] = max(e.values())
                ok &= good
            same = all(torch.equal(x, y) for x, y in zip(s_got, s_again))
            # launches: dense fwd and bwd once, sparse fwd once, sparse bwd
            # twice; no plain-route call
            want_counts = [(n + add, p) for (n, p), add in
                           zip(before, (1, 1, 1, 2))]
            times = {}
            for label, fn in (
                    ("fwd_ms", lambda: fa.flash_attention_fwd(q, k, v, bias)),
                    ("fwd_plain_ms",
                     lambda: fa.flash_attention_fwd_plain(q, k, v, bias)),
                    ("bwd_ms", lambda: fa.flash_attention_bwd(
                        q, k, v, out, lse, dout, bias)),
                    ("bwd_plain_ms", lambda: fa.flash_attention_bwd_plain(
                        q, k, v, out, lse, dout, bias)),
                    ("sparse_fwd_ms", lambda: fas.flash_attention_sparse_fwd(
                        q, k, v, se, vis, True)),
                    ("sparse_fwd_plain_ms",
                     lambda: fas.flash_attention_sparse_fwd_plain(
                         q, k, v, se, vis, True)),
                    ("sparse_bwd_ms", lambda: fas.flash_attention_sparse_bwd(
                        q, k, v, s_out, s_lse, dout, se, vis, True)),
                    ("sparse_bwd_plain_ms",
                     lambda: fas.flash_attention_sparse_bwd_plain(
                         q, k, v, s_out, s_lse, dout, se, vis, True)),
                    ("sdpa_fwd_ms", lambda: F.scaled_dot_product_attention(
                        q, k, v, attn_mask=mask))):
                times[label] = device_ms(fn)
            rec = {"dtype": name, "B": b, "nh": nh, "T": t, "d": d,
                   "max_abs_err": errs, "tol_fwd": TOL[name],
                   "tol_bwd": BWD_TOL[name], "sparse_bwd_repeatable": same,
                   "counts_before": before, "counts_after": after, **times}
            log("kernel wide " + json.dumps(rec))
            if not ok or not same or after != want_counts:
                raise AssertionError(f"head dim {d} {name}: the kernels "
                                     f"disagree with their plain versions or "
                                     f"did not launch: {rec}")
            records.append(rec)
    return records


def wide_counts(fa, fas):
    """Wide-kernel launches of the four flash wrappers."""
    return [f.wide_launches for f in (
        fa.flash_attention_fwd, fa.flash_attention_bwd,
        fas.flash_attention_sparse_fwd, fas.flash_attention_sparse_bwd)]


def wider_case(fa, fas, kind, q, k, v, dout, name, bias=None, se=None,
               vis=None, causal=False, rate=0.0, dbias=None):
    """One head dim above 256 on the wide kernels against the plain
    versions: forward and backward (dense with `bias` and `dbias`, or
    sparse on se/vis), the backward twice (bitwise equal), and for sparse
    with dropout every tile processed (bitwise equal to the skipping walk).
    Each call must be one wide launch and no plain-route call. The
    per-query dbias (f32 in both dtypes) is held to
    fa.flash_attention_ds_f64, the plain formula in f64 (the plain
    version's own error, dp and delta summed in f32, is logged beside it:
    at d = 1024 it exceeds the tolerance). Returns the max abs errors;
    raises on a disagreement."""
    import torch

    before, wide_before = flash_counts(fa, fas), wide_counts(fa, fas)
    if kind == "dense":
        args = (bias, causal, None, rate, 17)
        out, lse = fa.flash_attention_fwd(q, k, v, *args)
        ref = fa.flash_attention_fwd_plain(q, k, v, *args)
        got = fa.flash_attention_bwd(q, k, v, out, lse, dout, *args, dbias)
        again = fa.flash_attention_bwd(q, k, v, out, lse, dout, *args, dbias)
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, dout, *args,
                                            dbias)
        slots = (0, 1)
    else:
        args = (se, vis, causal, None, rate, 17)
        out, lse = fas.flash_attention_sparse_fwd(q, k, v, *args)
        ref = fas.flash_attention_sparse_fwd_plain(q, k, v, *args)
        got = fas.flash_attention_sparse_bwd(q, k, v, out, lse, dout, *args)
        again = fas.flash_attention_sparse_bwd(q, k, v, out, lse, dout,
                                               *args)
        want = fas.flash_attention_sparse_bwd_plain(q, k, v, out, lse, dout,
                                                    *args)
        slots = (2, 3)
    torch.cuda.synchronize()
    after, wide_after = flash_counts(fa, fas), wide_counts(fa, fas)
    add = {slots[0]: 1, slots[1]: 2}
    want_counts = [(n + add.get(i, 0), p) for i, (n, p) in enumerate(before)]
    want_wide = [n + add.get(i, 0) for i, n in enumerate(wide_before)]
    e = [max_err(x, y, TOL[name]) for x, y in zip((out, lse), ref)]
    plain_ds_err = None
    if dbias == "per_q":
        exact = fa.flash_attention_ds_f64(q, k, v, out, lse, dout, bias,
                                          causal, None, rate, 17)
        plain_ds_err = float((want[3].double() - exact).abs().max())
        want = (*want[:3], exact)
    errs, ok = bwd_errs(got, want, name)
    if plain_ds_err is not None:
        errs["dbias_plain_f32"] = plain_ds_err
    errs.update(out=e[0][0], lse=e[1][0])
    ok &= e[0][1] and e[1][1]
    same = all(torch.equal(x, y) for x, y in zip(got, again)
               if x is not None)
    skip_same = True
    if kind == "sparse" and rate > 0.0:
        ones = torch.ones_like(vis)
        o1, l1 = fas.flash_attention_sparse_fwd(q, k, v, se, ones, causal,
                                                None, rate, 17)
        g1 = fas.flash_attention_sparse_bwd(q, k, v, o1, l1, dout, se, ones,
                                            causal, None, rate, 17)
        torch.cuda.synchronize()
        skip_same = all(torch.equal(x, y) for x, y in
                        zip((out, lse) + tuple(got), (o1, l1) + tuple(g1)))
    if not (ok and same and skip_same) or after != want_counts \
            or wide_after != want_wide:
        peaks = {label: float(w.float().abs().max()) for label, w in
                 zip(("dq", "dk", "dv", "dbias"), want) if w is not None}
        raise AssertionError(
            f"wide {kind} {name} d={q.shape[-1]} causal={causal} "
            f"dropout={rate}: errors {errs} (ok {ok}; max |plain| "
            f"{peaks}), backward repeatable "
            f"{same}, skipping invisible {skip_same}, counts {before} -> "
            f"{after}, wide {wide_before} -> {wide_after}")
    return errs


def phase_kernel_wider(fa, fas):
    """Head dims 320 and 512, which the JAX package sends to Pallas and the
    tuned kernels do not take, through the four wide entries, f32 and bf16,
    against their plain versions at B=2, nh=2, T=256: dense with the
    [B,1,1,T] mask (column-sum dbias, dropout 0.1) and with a per-query
    bias, causal (per-query dbias, no dropout); sparse on two packed NMT
    rows, causal with dropout 0.1 and not causal without. Then at d = 512
    every shape the wide path (`phase_wide_path`) runs, checked the same
    way: dense B=4, nh=2 with the mask at T = 128 and 512, with and without
    dropout; sparse NMT rows B=4, nh=2 at T = 128 and 256, encoder self,
    decoder self and cross; the bf16 forward's flat grid at B·nh = 65,600
    (d = 320) and its split walk (wide_split_walk); the bf16 backward at a
    ragged T and at d = 1024 (wide_bwd_edges). Each entry is timed on
    the inputs of one of
    those checks (dense T=512; sparse encoder self T=256) beside its plain
    version, PyTorch's SDPA and its bound (wide_times), with its CTAs
    (wide_ctas), and its
    max_abs_err is that check's. Returns {(entry, dtype): record}."""
    import torch

    gen = torch.Generator("cuda").manual_seed(9)
    b, nh, t = 2, 2, 256
    ((stack, _),) = nmt_batches(b, t, 1)
    seg = torch.tensor(stack["tgt_seg"], device="cuda")
    se = fas.pack_se(seg, seg)
    tables = {c: fas.compute_block_vis(se, t, t, causal=c)
              for c in (False, True)}
    records = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        errs = {}
        for d in WIDER_D:
            q, k, v = qkv_inputs(b, nh, t, d, dtype, gen)
            dout = packed_heads(b, t, nh, d, dtype, gen)
            per_q = torch.randn(b, nh, t, t, generator=gen,
                                device="cuda").to(dtype)
            for label, kind, kw in (
                    ("dense mask dropout", "dense",
                     dict(bias=bert_mask(b, t, dtype), rate=DROPOUT,
                          dbias="col")),
                    ("dense per-query bias causal", "dense",
                     dict(bias=per_q, causal=True, dbias="per_q")),
                    ("sparse causal dropout", "sparse",
                     dict(se=se, vis=tables[True], causal=True,
                          rate=DROPOUT)),
                    ("sparse", "sparse", dict(se=se, vis=tables[False]))):
                errs[f"d={d} {label}"] = wider_case(fa, fas, kind, q, k, v,
                                                    dout, name, **kw)
        log(f"kernel wider {name} B={b} nh={nh} T={t}: max_abs_err "
            f"{json.dumps(errs)}")

        # the wide path's shapes at d = 512: dense B=4, nh=2 with the mask
        # at T = 128 and 512, with and without dropout; sparse on NMT rows
        # B=4 at T = 128 and NMT_T, encoder self, decoder self (causal) and
        # cross, dropout 0.1 on the last two
        d = 512
        path_errs, dense_at, sparse_at = {}, {}, {}
        for tp in (128, 512):
            q, k, v = qkv_inputs(WIDE_B, WIDE_HEADS, tp, d, dtype, gen)
            dout = packed_heads(WIDE_B, tp, WIDE_HEADS, d, dtype, gen)
            mask = bert_mask(WIDE_B, tp, dtype)
            dense_at[tp] = (q, k, v, dout, mask)
            for rate in (0.0, DROPOUT):
                path_errs[f"dense T={tp} dropout={rate}"] = wider_case(
                    fa, fas, "dense", q, k, v, dout, name, bias=mask,
                    rate=rate)
        for tp in (128, NMT_T):
            ((stack, _),) = nmt_batches(WIDE_B, tp, 1)
            src, tgt = (torch.tensor(stack[key], device="cuda")
                        for key in ("src_seg", "tgt_seg"))
            q, k, v, dout = (packed_heads(WIDE_B, tp, WIDE_HEADS, d, dtype,
                                          gen) for _ in range(4))
            for label, (qs, ks), causal, rate in (
                    ("encoder self", (src, src), False, 0.0),
                    ("decoder self", (tgt, tgt), True, DROPOUT),
                    ("cross", (tgt, src), False, DROPOUT)):
                pse = fas.pack_se(qs, ks)
                pvis = fas.compute_block_vis(pse, tp, tp, causal=causal)
                if label == "encoder self":
                    sparse_at[tp] = (q, k, v, dout, pse, pvis)
                path_errs[f"sparse {label} T={tp}"] = wider_case(
                    fa, fas, "sparse", q, k, v, dout, name, se=pse,
                    vis=pvis, causal=causal, rate=rate)
        log(f"kernel wider {name} path shapes B={WIDE_B} nh={WIDE_HEADS} "
            f"d={d}: max_abs_err {json.dumps(path_errs)}")
        if dtype == torch.bfloat16:
            wide_grid_past_65535(fa, fas, gen)
            wide_split_walk(fa, fas, gen)
            wide_bwd_edges(fa, fas, gen)

        # times at d = 512, on the inputs checked above; each entry's
        # max_abs_err is that of the checks at the shape it names
        recs = wide_times(fa, fas, name, dense_at[512], sparse_at[NMT_T])
        for key, n in wide_ctas(name, WIDE_B, WIDE_HEADS, 512, NMT_T,
                                d).items():
            recs[key]["ctas"] = n
        dense_err = max(max(e.values()) for lab, e in path_errs.items()
                        if lab.startswith("dense T=512"))
        sparse_err = max(path_errs[f"sparse encoder self T={NMT_T}"].values())
        for key, rec in recs.items():
            rec["max_abs_err"] = sparse_err if key.startswith("sparse") \
                else dense_err
            records[(key, name)] = rec
            log(f"kernel wider {key} " + json.dumps(
                {"dtype": name, **ratios(rec)}))
    return records


def wide_grid_past_65535(fa, fas, gen):
    """The bf16 wide forward's flat grid at B·nh = 65,600 > 65,535 (d =
    320, T = 64) against the plain version: one wide launch, no plain
    call, out and lse within TOL."""
    import torch

    b, nh, t, d = 50, 1312, 64, 320
    qkv = torch.randn(b, t, 3 * nh * d, generator=gen, device="cuda",
                      dtype=torch.bfloat16)   # 8 GB: no f32 copy first
    q, k, v = (heads(x, nh) for x in qkv.split(nh * d, dim=-1))
    before, wide_before = flash_counts(fa, fas), wide_counts(fa, fas)
    out, lse = fa.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    after, wide_after = flash_counts(fa, fas), wide_counts(fa, fas)
    ref = fa.flash_attention_fwd_plain(q, k, v)
    (e_o, ok_o), (e_l, ok_l) = (max_err(x, y, TOL["bfloat16"])
                                for x, y in zip((out, lse), ref))
    log(f"kernel wider grid B·nh={b * nh} T={t} d={d} bf16: fwd max_abs_err "
        f"out {e_o:.3e} lse {e_l:.3e}")
    counted = (after[0] == (before[0][0] + 1, before[0][1])
               and wide_after[0] == wide_before[0] + 1)
    if not (ok_o and ok_l and counted):
        raise AssertionError(f"the wide forward's flat grid at B·nh = "
                             f"{b * nh} disagrees or did not launch once: "
                             f"{before} -> {after}")
    del qkv, q, k, v, out, lse, ref
    torch.cuda.empty_cache()


def wide_split_walk(fa, fas, gen):
    """The bf16 wide forward at B=4, nh=2, T=512, d=512, whose cells fill
    over half the SMs and at most all (on a 132-SM card a cluster of two
    CTAs then splits each key walk): a per-query bias, causal, dropout 0.1,
    and block-sparse decoder self (causal, dropout 0.1) on NMT rows,
    forward and backward held as wider_case holds them."""
    import torch

    b, nh, t, d = WIDE_B, WIDE_HEADS, 512, 512
    q, k, v = qkv_inputs(b, nh, t, d, torch.bfloat16, gen)
    dout = packed_heads(b, t, nh, d, torch.bfloat16, gen)
    per_q = torch.randn(b, nh, t, t, generator=gen, device="cuda").to(
        torch.bfloat16)
    errs = {"dense per-query causal dropout": wider_case(
        fa, fas, "dense", q, k, v, dout, "bfloat16", bias=per_q,
        causal=True, rate=DROPOUT, dbias="per_q")}
    ((stack, _),) = nmt_batches(b, t, 1)
    tgt = torch.tensor(stack["tgt_seg"], device="cuda")
    se = fas.pack_se(tgt, tgt)
    vis = fas.compute_block_vis(se, t, t, causal=True)
    errs["sparse decoder self"] = wider_case(
        fa, fas, "sparse", q, k, v, dout, "bfloat16", se=se, vis=vis,
        causal=True, rate=DROPOUT)
    ctas = wide_ctas("bfloat16", b, nh, t, t, d)["fwd"]
    log(f"kernel wider bfloat16 split walk B={b} nh={nh} T={t} d={d} "
        f"({ctas} forward CTAs): max_abs_err {json.dumps(errs)}")


def wide_bwd_edges(fa, fas, gen):
    """The bf16 wide backward where its walks end early or its chunks are
    many: a ragged T = 200 (dense, the mask with dropout at d = 512, a
    per-query bias, causal at d = 320) and d = 1024 (four 256-column chunks
    a role: a per-query bias, causal, dropout 0.1; sparse decoder self on
    NMT rows, dropout 0.1), forward and backward held as wider_case holds
    them."""
    import torch

    bf16 = torch.bfloat16
    errs = {}
    for d, t, label, kw in (
            (512, 200, "dense mask dropout",
             dict(bias=bert_mask(2, 200, bf16), rate=DROPOUT, dbias="col")),
            (320, 200, "dense per-query causal", dict(causal=True,
                                                      dbias="per_q")),
            (1024, 256, "dense per-query causal dropout",
             dict(causal=True, rate=DROPOUT, dbias="per_q"))):
        q, k, v = qkv_inputs(2, 2, t, d, bf16, gen)
        dout = packed_heads(2, t, 2, d, bf16, gen)
        if "bias" not in kw:
            kw["bias"] = torch.randn(2, 2, t, t, generator=gen,
                                     device="cuda").to(bf16)
        errs[f"d={d} T={t} {label}"] = wider_case(
            fa, fas, "dense", q, k, v, dout, "bfloat16", **kw)
    ((stack, _),) = nmt_batches(2, 256, 1)
    tgt = torch.tensor(stack["tgt_seg"], device="cuda")
    se = fas.pack_se(tgt, tgt)
    q, k, v, dout = (packed_heads(2, 256, 2, 1024, bf16, gen)
                     for _ in range(4))
    errs["d=1024 T=256 sparse decoder self"] = wider_case(
        fa, fas, "sparse", q, k, v, dout, "bfloat16", se=se,
        vis=fas.compute_block_vis(se, 256, 256, causal=True), causal=True,
        rate=DROPOUT)
    log(f"kernel wider bfloat16 backward edges B=2 nh=2: max_abs_err "
        f"{json.dumps(errs)}")


def wide_times(fa, fas, name, dense, sparse):
    """Device ms of the four wide entries at d = 512 (dense: B=4, nh=2,
    T=512 with the [B,1,1,T] mask; sparse: NMT encoder self, T = NMT_T),
    with and without dropout, beside their plain versions and SDPA, and
    their bounds (f32: 3xTF32, the FMA bound beside it). Returns {entry:
    record}."""
    import torch
    import torch.nn.functional as F

    q, k, v, dout, mask = dense
    b, nh, t, d = q.shape
    out, lse = fa.flash_attention_fwd(q, k, v, mask)
    calls = {"fwd": {
        "ms": lambda: fa.flash_attention_fwd(q, k, v, mask),
        "dropout_ms": lambda: fa.flash_attention_fwd(
            q, k, v, mask, False, None, DROPOUT, 91)}, "bwd": {
        "ms": lambda: fa.flash_attention_bwd(q, k, v, out, lse, dout, mask),
        "dropout_ms": lambda: fa.flash_attention_bwd(
            q, k, v, out, lse, dout, mask, False, None, DROPOUT, 91)}}
    lq, lk, lv = (x.detach().requires_grad_() for x in (q, k, v))
    sdpa_mask = mask.expand(b, nh, t, t)
    lout = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=sdpa_mask)
    calls["fwd"].update(
        plain_ms=lambda: fa.flash_attention_fwd_plain(q, k, v, mask),
        library_ms=lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=sdpa_mask))
    calls["bwd"].update(
        plain_ms=lambda: fa.flash_attention_bwd_plain(
            q, k, v, out, lse, dout, mask),
        library_ms=lambda: torch.autograd.grad(
            lout, (lq, lk, lv), dout, retain_graph=True))
    recs = {key: {k_: device_ms(fn) for k_, fn in c.items()}
            for key, c in calls.items()}
    for rec, (flops, nbytes) in ((recs["fwd"], fa.fwd_counts(q, k, mask)),
                                 (recs["bwd"], fa.bwd_counts(q, k, mask))):
        rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes, name)
        rec.update(flops=flops, bytes=nbytes,
                   shape=f"B={b} nh={nh} T={t} d={d}, [B,1,1,T] mask")

    q, k, v, dout, sse, svis = sparse
    ts = q.shape[2]
    smask = fas._mask(sse, None, ts, ts, False)
    stats = {"visible_pairs": int(smask.sum()) * nh}
    recs["sparse_fwd"], recs["sparse_bwd"] = sparse_timing(
        fas, name, (q, k, v, dout, sse, svis, smask, False), stats)
    for key in ("sparse_fwd", "sparse_bwd"):
        recs[key]["shape"] = f"encoder self B={b} nh={nh} T={ts} d={d}"
    if name == "float32":
        # every product in 3xTF32 on the tensor cores: the least time is
        # three TF32 products at 495 TFLOP/s; the CUDA-core FMA bound beside
        for key, rec in recs.items():
            if "flops" in rec and "bound_fma_ms" not in rec:
                rec["bound_fma_ms"] = rec["bound_ms"]
                rec["bound_ms"], rec["bound_by"] = bound(
                    3 * rec["flops"], rec["bytes"], name, TF32_PEAK_FLOPS)
    return recs


def wide_ctas(name, b, nh, t, ts, d):
    """CTAs of the four wide entries' launches (the backward's summed) at
    wide_times' shapes: dense T = t, sparse T = ts. Returns {entry: CTAs}."""
    import ctypes
    from paddle_tpu_torch.ops.kernels import build

    ctas = build.load("flash_attention_wide").flash_attention_wide_ctas
    ctas.argtypes = [ctypes.c_int] * 7
    ctas.restype = ctypes.c_longlong
    code = 0 if name == "float32" else 1
    return {key: ctas(bwd, code, b, nh, tq, tq, d)
            for key, (tq, bwd) in (("fwd", (t, 0)), ("bwd", (t, 1)),
                                   ("sparse_fwd", (ts, 0)),
                                   ("sparse_bwd", (ts, 1)))}


def build_bert(fluid, bert, seq_len):
    cfg = bert.BertConfig(vocab_size=30522, hidden_size=HIDDEN, num_layers=12,
                          num_heads=NH, ffn_size=3072, max_position=512,
                          hidden_dropout=0.1, attn_dropout=0.1)
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 2024
    with fluid.program_guard(main, startup):
        L = fluid.layers
        feeds = [L.data(n, [-1, seq_len], dtype=dt, append_batch_size=False)
                 for n, dt in (("src_ids", "int64"), ("pos_ids", "int64"),
                               ("sent_ids", "int64"),
                               ("input_mask", "float32"))]
        out = bert.bert_encoder(cfg, *feeds, is_test=True)
    return main, startup, [f.name for f in feeds], out


def bert_feed(n, t, rng):
    mask = np.ones((n, t), "float32")
    for i in range(n):
        mask[i, rng.randint(t // 2, t + 1):] = 0.0   # ragged true lengths
    return {"src_ids": rng.randint(0, 30522, (n, t)).astype("int64"),
            "pos_ids": np.tile(np.arange(t, dtype="int64"), (n, 1)),
            "sent_ids": (rng.rand(n, t) > 0.5).astype("int64"),
            "input_mask": mask}


def phase_serve(fluid, fa):
    """The main path: BERT-base served through create_predictor →
    run_padded. Returns the flash launches per dtype."""
    import torch
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.models import bert

    # the sequence dim is left free (-1) so one saved model serves both
    # buckets, T=128 and T=512
    main, startup, feed_names, out = build_bert(fluid, bert, -1)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(scope), tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        exe.run(startup)
        fluid.io.save_inference_model(d, feed_names, [out], exe,
                                      main_program=main)
        log(f"serve: startup + save {time.perf_counter() - t0:.1f} s")
        rng = np.random.RandomState(7)
        launches = {}

        fa.flash_attention_fwd.launches = 0          # main path starts
        fa.flash_attention_fwd.plain_on_cuda = 0
        pred = inference.create_predictor(inference.Config(d))
        names = [r["pass"] for r in pred.pass_report["passes"]]
        if names != inference.Config().pass_builder().all_passes():
            raise AssertionError(f"pass_report lists {names}")
        forwards = 0
        for n, t in ((1, 128), (3, 128), (8, 128), (5, 128), (4, 512)):
            feed = bert_feed(n, t, rng)
            t0 = time.perf_counter()
            (res,) = pred.run_padded(feed, 8)
            ms = (time.perf_counter() - t0) * 1e3
            forwards += 1
            if res.shape != (n, t, HIDDEN) or not np.isfinite(res).all():
                raise AssertionError(f"serve: bad output {res.shape} for "
                                     f"batch {n}, T={t}")
            log(f"serve request batch={n} bucket=8 T={t}: {ms:.2f} ms "
                f"(host clock, feed to numpy)")
        # where the time of one warm request goes (B=8, T=128)
        warm = bert_feed(8, 128, rng)
        log("serve profile " + json.dumps(profile_record(
            "request batch=8 T=128", lambda: pred.run_padded(warm, 8), 3)))
        forwards += 4
        launches["float32"] = fa.flash_attention_fwd.launches
        if launches["float32"] != 12 * forwards:
            raise AssertionError(f"flash kernel launched "
                                 f"{launches['float32']} times in {forwards} "
                                 f"forwards, expected 12 each")

        check = bert_feed(2, 128, rng)
        (gpu_out,) = pred.run(check)
        before = fa.flash_attention_fwd.launches
        bf16 = inference.create_predictor(inference.Config(d),
                                          precision="bfloat16")
        (bf16_out,) = bf16.run(check)                # main path ends
        launches["bfloat16"] = fa.flash_attention_fwd.launches - before
        launches["float32"] = before
        if fa.flash_attention_fwd.plain_on_cuda:
            raise AssertionError(f"serve: {fa.flash_attention_fwd.plain_on_cuda}"
                                 f" flash calls took the plain route")
        if launches["bfloat16"] != 12:
            raise AssertionError(f"bf16 forward launched the flash kernel "
                                 f"{launches['bfloat16']} times")

        cpu_cfg = inference.Config(d)
        cpu_cfg.disable_gpu()
        (cpu_out,) = inference.create_predictor(cpu_cfg).run(check)
        gpu_cpu = float(np.abs(gpu_out - cpu_out).max())
        log(f"serve: GPU vs CPU max abs diff {gpu_cpu:.3e} (tol 1e-3, f32, "
            f"TF32 off)")
        if gpu_cpu > 1e-3:
            raise AssertionError("GPU and CPU predictors disagree")
        rel = float(np.linalg.norm(bf16_out - gpu_out)
                    / np.linalg.norm(gpu_out))
        log(f"serve: bf16 vs f32 relative L2 error {rel:.3e} (tol 5e-2)")
        if not np.isfinite(bf16_out).all() or rel > 5e-2:
            raise AssertionError("bf16 predictor is off from f32")
        log(f"serve: flash launches on the main path {launches} "
            f"(12 per forward)")
        log(f"serve: peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB")
    return launches


def pretrain_feed(b, t, rng):
    """A masked-LM batch: 15 % of the positions carry a label, the rest
    are ignored (-100)."""
    labels = np.full((b, t, 1), -100, "int64")
    pick = rng.rand(b, t) < 0.15
    labels[pick, 0] = rng.randint(0, 30522, int(pick.sum()))
    feed = bert_feed(b, t, rng)
    feed["mlm_labels"] = labels
    return feed


def amp_wrapper(fluid, amp):
    """bf16 AMP decoration (no loss scaling) when `amp`, else identity."""
    def wrap(o):
        if amp:
            o = fluid.contrib.mixed_precision.decorate(
                o, dtype="bfloat16", use_dynamic_loss_scaling=False)
        return o
    return wrap


def build_pretrain(fluid, bert, b, t, amp, layers=12, dropout=DROPOUT,
                   hidden=HIDDEN, heads=NH, ffn=3072, optimizer=None):
    """BERT pretraining on Adam(LR), or on `optimizer(amp_wrap)` (built
    inside the program: a schedule's ops land there)."""
    cfg = bert.BertConfig(vocab_size=30522, hidden_size=hidden,
                          num_layers=layers, num_heads=heads, ffn_size=ffn,
                          max_position=512, hidden_dropout=dropout,
                          attn_dropout=dropout)
    wrap = amp_wrapper(fluid, amp)

    def opt():
        if optimizer is not None:
            return optimizer(wrap)
        return wrap(fluid.optimizer.Adam(LR))

    main, startup, _, loss = bert.build_pretrain_program(
        cfg, b, t, optimizer_factory=opt)
    main.random_seed = startup.random_seed = 2024
    return main, startup, loss


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def phase_train(fluid, fa):
    """Main path 2: BERT-base pretraining through Executor.run on the card.
    Returns the flash launches per kernel and dtype."""
    import torch
    from paddle_tpu_torch.models import bert

    rng = np.random.RandomState(11)
    launches = {}
    losses = {}
    exe = fluid.Executor(fluid.CUDAPlace(0))
    for name, t, amp in (("float32", 128, False), ("bfloat16", 512, True)):
        main, startup, loss = build_pretrain(fluid, bert, B, t, amp)
        feed = pretrain_feed(B, t, rng)
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            # delta comes from the delta kernel on the card: a call of its
            # plain version during the main path is counted here
            delta_plain, plain_delta_calls = fa.flash_attention_delta_plain, []
            fa.flash_attention_delta_plain = lambda *a: (
                plain_delta_calls.append(1), delta_plain(*a))[1]
            fa.flash_attention_fwd.launches = 0       # main path starts
            fa.flash_attention_bwd.launches = 0
            fa.flash_attention_fwd.plain_on_cuda = 0
            fa.flash_attention_bwd.plain_on_cuda = 0
            step_ms = []
            vals = []
            try:
                for _ in range(4):
                    t0 = time.perf_counter()
                    (lv,) = exe.run(main, feed=feed, fetch_list=[loss])
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    vals.append(float(lv))
            finally:
                fa.flash_attention_delta_plain = delta_plain
            launches[("fwd", name)] = fa.flash_attention_fwd.launches
            launches[("bwd", name)] = fa.flash_attention_bwd.launches
            plain = (fa.flash_attention_fwd.plain_on_cuda,
                     fa.flash_attention_bwd.plain_on_cuda,
                     len(plain_delta_calls))
            # main path ends
            if plain != (0, 0, 0):
                raise AssertionError(f"train {name}: flash calls took the "
                                     f"plain route (fwd, bwd, delta) "
                                     f"{plain}")
            losses[name] = vals
            log(f"train {name} B={B} T={t} amp={amp} dropout={DROPOUT} "
                f"lr={LR} ops/step={len(main.global_block().ops)}: losses "
                f"{vals}; step ms (host clock, ends in the loss fetch) "
                f"{[round(x, 2) for x in step_ms]}")
            if not all(np.isfinite(vals)) or abs(vals[0] - LN_VOCAB) > 0.5 \
                    or not vals[-1] < vals[0]:
                raise AssertionError(f"train {name}: losses {vals} (want "
                                     f"finite, the first within 0.5 of "
                                     f"{LN_VOCAB}, the last below the first)")
            for kind in ("fwd", "bwd"):
                if launches[(kind, name)] != 12 * 4:
                    raise AssertionError(
                        f"train {name}: flash {kind} launched "
                        f"{launches[(kind, name)]} times in 4 steps, "
                        f"expected 12 per step")
            # where the time of one warm step goes
            torch.cuda.reset_peak_memory_stats()
            rec = profile_record(f"step {name} B={B} T={t} amp={amp}",
                                 lambda: exe.run(main, feed=feed,
                                                 fetch_list=[loss]), 2)
            log("train profile " + json.dumps(rec))
            flash_ms = sum(ms for kind, ms in rec["by_category_ms"].items()
                           if kind.startswith("flash fwd")
                           or kind.startswith("flash bwd"))
            flash_ms = "incomplete" if rec["device_busy_ms"] is None \
                else f"{flash_ms:.4f}"
            log(f"train {name}: flash kernels {flash_ms} device ms a "
                f"step (PERF.md §5: 1.415 f32 and 7.027 bf16 with the "
                f"earlier mma.sync kernels)")
            # warm steps without the profiler, whose own host work inflates
            # the wall time of the profiled steps: the step time a user
            # sees, and the device-busy share against it
            warm = []
            for _ in range(6):
                t0 = time.perf_counter()
                exe.run(main, feed=feed, fetch_list=[loss])
                warm.append((time.perf_counter() - t0) * 1e3)
            med = float(np.median(warm))
            log("train warm " + json.dumps({
                "call": rec["call"], "step_ms": warm, "median_ms": med,
                "tokens_per_s": B * t / med * 1e3,
                "device_busy_share_of_median": ratio(rec["device_busy_ms"],
                                                     med)}))
        if amp:
            # bf16 against f32: the f32 program from the same startup and
            # generator (same init, same dropout masks), its step-0 loss
            f32_main, f32_startup, f32_loss = build_pretrain(
                fluid, bert, B, t, False)
            with fluid.scope_guard(fluid.Scope()):
                exe.run(f32_startup)
                (l32,) = exe.run(f32_main, feed=feed, fetch_list=[f32_loss])
            rel = abs(vals[0] - float(l32)) / abs(float(l32))
            log(f"train bf16 vs f32 step-0 loss: {vals[0]} vs {float(l32)}, "
                f"relative {rel:.3e} (tol 2e-2)")
            if rel > 2e-2:
                raise AssertionError("bf16 AMP step-0 loss is off from f32")

    # GPU against CPU at dropout 0: full width cut to 2 layers, one f32 step
    main, startup, loss = build_pretrain(fluid, bert, 2, 128, False, layers=2,
                                         dropout=0.0)
    feed = pretrain_feed(2, 128, rng)
    grads = ["encoder_0.qkv.w@GRAD", "word_embedding@GRAD", "mlm_out.w@GRAD"]
    gpu_scope, cpu_scope = fluid.Scope(), fluid.Scope()
    with fluid.scope_guard(gpu_scope):
        exe.run(startup)
    state = {v.name: gpu_scope.find_np(v.name) for v in main.list_vars()
             if v.persistable and gpu_scope.has_var(v.name)}
    fluid.io.load_params_from_numpy(state, scope=cpu_scope)
    gpu = exe.run(main, feed=feed, fetch_list=[loss] + grads, scope=gpu_scope)
    cpu = fluid.Executor(fluid.CPUPlace()).run(
        main, feed=feed, fetch_list=[loss] + grads, scope=cpu_scope)
    loss_rel = abs(float(gpu[0]) - float(cpu[0])) / abs(float(cpu[0]))
    grad_rel = {g: rel_l2(a, b) for g, a, b in zip(grads, gpu[1:], cpu[1:])}
    log(f"train GPU vs CPU (2 layers, B=2, T=128, f32, dropout 0): loss "
        f"{float(gpu[0])} vs {float(cpu[0])} relative {loss_rel:.3e} "
        f"(tol 1e-4); grads relative L2 {json.dumps(grad_rel)} (tol 1e-3)")
    if loss_rel > 1e-4 or max(grad_rel.values()) > 1e-3:
        raise AssertionError("GPU and CPU training steps disagree")
    return launches

# ---------------------------------------------------------------------------
# fused batch-norm kernels (ResNet-50)
# ---------------------------------------------------------------------------

def bn_errs(pairs, name):
    """Errors of kernel outputs against their plain versions. pairs: (label,
    got, want, kind) with kind "y" (max |err| / max |plain|, limit
    BN_TOL), "mean"/"var" (per channel, against E[x^2], given as a fifth
    element) or "sum" (max |err| / max |plain|, limit BN_STAT_TOL).
    Returns ({label: the normalized error}, {label: max |err|}, all
    within their limits)."""
    errs, abs_errs, ok = {}, {}, True
    for label, got, want, kind, *extra in pairs:
        g, w = got.float(), want.float()
        d = (g - w).abs()
        abs_errs[label] = float(d.max())
        if kind in ("mean", "var"):
            ex2 = extra[0]
            scale = ex2 if kind == "var" else ex2.sqrt()
            e = float((d / scale.clamp_min(1e-30)).max())
        else:
            e = float(d.max() / w.abs().max().clamp_min(1e-30))
        errs[label] = e
        ok &= e <= (BN_TOL[name] if kind == "y" else BN_STAT_TOL)
    return errs, abs_errs, ok


def nhwc_randn(shape, dtype, gen, offset=0.0, positive=False):
    """An NCHW tensor stored channels-last, as the port keeps activations:
    |randn| (post-relu) or randn + offset."""
    import torch

    x = torch.randn(shape, generator=gen, device="cuda")
    x = x.abs() if positive else x + offset
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


def k2_time(fb, label, x2, mean, inv, scale, bias, act, res2, name,
            library=None):
    """K2 (apply2d) at one (M, C) shape: its device ms beside its plain
    version's, its bound and, where one PyTorch call computes the same
    function (no relu, no residual), that call's (`library`)."""
    import torch

    m, c = x2.shape
    ms, plain_ms = (device_ms(fn) for fn in (
        lambda: fb.apply2d(x2, mean, inv, scale, bias, act, res2),
        lambda: fb.apply_plain(x2, mean, inv * scale, bias, act, res2)))
    has_res = res2 is not None
    flops, nbytes = fb.apply_counts(m, c, x2.element_size(), act, has_res)
    bound_ms, bound_by = bound(flops, nbytes, name)
    rec = {"kernel": "fused_bn_apply", "dtype": name,
           "shape": f"{label}: M={m} C={c}, act={act!r} res={has_res}",
           "geometry": fb.apply_geometry(
               m, c, x2.element_size(), torch.cuda.get_device_properties(
                   x2.device).multi_processor_count),
           "ms": ms, "plain_ms": plain_ms,
           "library_ms": device_ms(library) if library else None,
           "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_share": bound_ms / ms}
    log("kernel bn k2 " + json.dumps(rec))
    return rec


def phase_kernel_bn(fb):
    """Each fused-BN kernel against its plain version at ResNet-50 B=128
    shapes, f32 and bf16, with timings. Returns {(kernel, dtype): record}
    of the shape each kernel's JSON entry quotes."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator("cuda").manual_seed(3)
    records, conv_shapes = {}, {}
    B = RESNET_B
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        isz = torch.tensor([], dtype=dtype).element_size()
        peak = PEAK_FLOPS[name]

        # K4's channel gate: Co = 10 (2 mod 8) runs in f32 (Y stored in
        # pairs) and raises in bf16 (Y stored in 16-byte vectors)
        xg = nhwc_randn((2, 64, 14, 14), dtype, gen, positive=True)
        wg = (torch.randn(10, 64, 1, 1, generator=gen, device="cuda")
              * 0.2).to(dtype)
        try:
            got = fb.conv_stats(xg, wg)
        except ValueError as e:
            got, why = None, str(e)
        if (got is None) != (name == "bfloat16"):
            raise AssertionError(f"fused_conv_stats {name} Co=10: expected "
                                 f"{'a raise' if got is not None else 'a run'}")
        if got is None:
            log(f"kernel bn fused_conv_stats {name} Co=10 raises: {why}")
        else:
            want = fb.conv_stats_plain(xg, wg)
            errs, _, ok = bn_errs(
                [("y", got[0], want[0], "y"),
                 ("mean", got[1], want[1], "mean", want[2] + want[1] ** 2),
                 ("var", got[2], want[2], "var", want[2] + want[1] ** 2)],
                name)
            log(f"kernel bn fused_conv_stats {name} Co=10: {json.dumps(errs)}")
            if not ok:
                raise AssertionError(f"fused_conv_stats {name} Co=10 "
                                     f"disagrees: {errs}")

        # K4 (+ K2 apply2d, K3 on its output): 1x1 convs of the bottlenecks
        for label, ci, hw, co, st, res, quote in (
                ("stage1 .a 256->64 @56", 256, 56, 64, 1, False, True),
                ("stage1 .c 64->256 @56 +res", 64, 56, 256, 1, True, False),
                ("stage2 .sc 256->512 @56 s2", 256, 56, 512, 2, False,
                 False),
                ("stage4 .c 512->2048 @7 +res", 512, 7, 2048, 1, True,
                 False)):
            x = nhwc_randn((B, ci, hw, hw), dtype, gen, positive=True)
            w = (torch.randn(co, ci, 1, 1, generator=gen, device="cuda")
                 * (2.0 / ci) ** 0.5 + 0.01).to(dtype)
            xs = x[:, :, ::st, ::st]
            m = B * (hw // st) ** 2
            y2, mean, var = fb.conv_stats(xs, w)
            py2, pmean, pvar = fb.conv_stats_plain(xs, w)
            again = fb.conv_stats(xs, w)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip((y2, mean, var),
                                                         again))
            del again
            ex2 = pvar + pmean * pmean
            errs, abs_errs, ok = bn_errs([("y", y2, py2, "y"),
                                          ("mean", mean, pmean, "mean", ex2),
                                          ("var", var, pvar, "var", ex2)],
                                         name)
            x2 = fb.to2d(xs)
            ms, plain_ms, library_ms = (device_ms(fn) for fn in (
                lambda: fb.conv_stats(xs, w),
                lambda: fb.conv_stats_plain(xs, w),
                lambda: torch.matmul(x2, w.reshape(co, ci).t())))
            flops, nbytes = fb.conv_stats_counts(m, ci, co, isz)
            bound_ms, bound_by = bound(flops, nbytes, name)
            extra = {}
            if name == "float32":   # 3xTF32; the FMA bound beside it
                extra["bound_fma_ms"] = bound_ms
                bound_ms, bound_by = bound(3 * flops, nbytes, name,
                                           TF32_PEAK_FLOPS)
            rec = {"kernel": "fused_conv_stats", "dtype": name,
                   "shape": f"{label}: M={m} Ci={ci} Co={co}",
                   "max_err": errs, "max_abs_err": abs_errs, "ms": ms,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "library": "torch.matmul (GEMM alone)", "flops": flops,
                   "bytes": nbytes, "bound_ms": bound_ms,
                   "bound_by": bound_by, "bound_share": bound_ms / ms,
                   "vs_library": ms / library_ms, "repeatable": same,
                   **extra}
            log("kernel bn " + json.dumps(rec))
            conv_shapes.setdefault(name, []).append(
                {k: rec[k] for k in ("shape", "ms", "library_ms", "bound_ms",
                                     "bound_by", "vs_library", "bound_share")
                 } | extra)
            if not ok or not same:
                raise AssertionError(f"fused_conv_stats {name} {label} "
                                     f"disagrees with its plain version or "
                                     f"is not repeatable: {errs} {same}")
            if quote:
                records[("fused_conv_stats", name)] = rec

            # K2 on the conv output, and K3 on the same tensors
            inv = torch.rsqrt(var + 1e-5)
            scale = torch.rand(co, generator=gen, device="cuda") + 0.5
            bias = torch.randn(co, generator=gen, device="cuda") * 0.1
            res2 = (fb.to2d(nhwc_randn((B, co, hw // st, hw // st), dtype,
                                       gen)) if res else None)
            act = "" if label.startswith("stage2 .sc") else "relu"
            a2 = fb.apply2d(y2, mean, inv, scale, bias, act, res2)
            pa2 = fb.apply_plain(y2, mean, inv * scale, bias, act, res2)
            # dy correlated with the input, so that dgamma and dbeta are
            # sums without cancellation
            dy = (torch.randn(y2.shape, generator=gen, device="cuda") * 0.5
                  + 0.3 * y2.float()).to(dtype)
            ysave = a2 if act == "relu" else None
            db, dg = fb.bn_bwd_reduce(dy, y2, ysave, mean, inv)
            pdb, pdg = fb.bwd_reduce_plain(dy, y2, ysave, mean, inv)
            dx, dres = fb.bn_bwd_dx(dy, y2, ysave, mean, inv, inv * scale,
                                    pdb, pdg, float(m), res)
            pdx, pdres = fb.bwd_dx_plain(dy, y2, ysave, mean, inv,
                                         inv * scale, pdb, pdg, float(m), res)
            torch.cuda.synchronize()
            pairs = [("apply", a2, pa2, "y"), ("dbeta", db, pdb, "sum"),
                     ("dgamma", dg, pdg, "sum"), ("dx", dx, pdx, "y")]
            if res:
                pairs.append(("dres", dres, pdres, "y"))
            errs, abs_errs, ok = bn_errs(pairs, name)
            log(f"kernel bn {name} {label} apply/backward act={act!r} "
                f"res={res}: normalized {json.dumps(errs)} max abs "
                f"{json.dumps(abs_errs)}")
            if not ok:
                raise AssertionError(f"fused BN apply/backward {name} {label}"
                                     f" disagrees with its plain version")
            if label.startswith("stage4"):   # K2 with residual and relu
                k2_time(fb, label, y2, mean, inv, scale, bias, act, res2,
                        name)
            if act == "":
                # the shortcut BN: no relu, no residual, so one PyTorch call
                # computes each function (inference batch_norm; cuDNN's
                # training backward)
                a4 = fb.from2d(y2, (B, co, hw // st, hw // st))
                rec = k2_time(fb, f"{label} BN", y2, mean, inv, scale, bias,
                              "", None, name,
                              lambda: F.batch_norm(a4, mean, var, scale,
                                                   bias, False, 0.0, 1e-5))
                rec.update(max_err={"apply": errs["apply"]},
                           max_abs_err={"apply": abs_errs["apply"]},
                           library="F.batch_norm(training=False)")
                records[("fused_bn_apply", name)] = rec
                log("kernel bn " + json.dumps(rec))
                dy4 = fb.from2d(dy, a4.shape)

                def k3():
                    d_b, d_g = fb.bn_bwd_reduce(dy, y2, None, mean, inv)
                    return fb.bn_bwd_dx(dy, y2, None, mean, inv, inv * scale,
                                        d_b, d_g, float(m), False)

                def k3_plain():
                    d_b, d_g = fb.bwd_reduce_plain(dy, y2, None, mean, inv)
                    return fb.bwd_dx_plain(dy, y2, None, mean, inv,
                                           inv * scale, d_b, d_g, float(m),
                                           False)

                ms, plain_ms, library_ms, reduce_ms, dx_ms = (
                    device_ms(fn) for fn in (
                        k3, k3_plain,
                        lambda: torch.ops.aten.native_batch_norm_backward(
                            dy4, a4, scale, None, None, mean, inv, True,
                            1e-5, [True, True, True]),
                        lambda: fb.bn_bwd_reduce(dy, y2, None, mean, inv),
                        lambda: fb.bn_bwd_dx(dy, y2, None, mean, inv,
                                             inv * scale, pdb, pdg, float(m),
                                             False)))
                flops, nbytes = fb.bwd_counts(m, co, isz)
                bound_ms, bound_by = bound(flops, nbytes, name)
                # each pass alone: the reduce reads dy and x once, the dx
                # pass reads them again and writes dx; the two passes
                # together move 5 M·C elements (the two-pass floor)
                reduce_bound = bound(*fb.bwd_reduce_counts(m, co, isz),
                                     name)[0]
                dx_bound = bound(*fb.bwd_dx_counts(m, co, isz), name)[0]
                records[("fused_bn_bwd", name)] = rec = {
                    "kernel": "fused_bn_bwd", "dtype": name,
                    "shape": f"{label} BN: M={m} C={co}, no relu/res",
                    "max_err": {k: errs[k] for k in ("dbeta", "dgamma",
                                                     "dx")},
                    "max_abs_err": {k: abs_errs[k] for k in
                                    ("dbeta", "dgamma", "dx")},
                    "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                    "library": "aten.native_batch_norm_backward",
                    "bytes": nbytes, "bound_ms": bound_ms,
                    "bound_by": bound_by, "bound_share": bound_ms / ms,
                    "vs_library": ms / library_ms,
                    "two_pass_floor_ms": 5 * m * co * isz / PEAK_BYTES * 1e3,
                    "reduce_ms": reduce_ms, "reduce_bound_ms": reduce_bound,
                    "reduce_bound_share": reduce_bound / reduce_ms,
                    "dx_ms": dx_ms, "dx_bound_ms": dx_bound,
                    "dx_bound_share": dx_bound / dx_ms}
                log("kernel bn " + json.dumps(rec))

        # K1 stats and K2 bn_apply at the stem (C=64, 112^2) and stage 4
        # (.b, C=512, 7^2)
        for label, c, hw, quote in (("stem C=64 @112", 64, 112, True),
                                    ("stage4 .b C=512 @7", 512, 7, False)):
            x = nhwc_randn((B, c, hw, hw), dtype, gen, offset=0.5)
            mean, var = fb.bn_stats(x)
            pmean, pvar = fb.stats_plain(fb.to2d(x))
            inv = torch.rsqrt(var + 1e-5)
            scale = torch.rand(c, generator=gen, device="cuda") + 0.5
            bias = torch.randn(c, generator=gen, device="cuda") * 0.1
            y = fb.bn_apply(x, mean, inv, scale, bias, "relu")
            py = fb.apply_plain(fb.to2d(x), mean, inv * scale, bias, "relu")
            torch.cuda.synchronize()
            ex2 = pvar + pmean * pmean
            errs, abs_errs, ok = bn_errs(
                [("mean", mean, pmean, "mean", ex2),
                 ("var", var, pvar, "var", ex2),
                 ("apply", fb.to2d(y), py, "y")], name)
            m = B * hw * hw
            ms, plain_ms, library_ms = (device_ms(fn) for fn in (
                lambda: fb.bn_stats(x),
                lambda: fb.stats_plain(fb.to2d(x)),
                lambda: torch.var_mean(x, dim=(0, 2, 3), correction=0)))
            flops, nbytes = fb.stats_counts(m, c, isz)
            bound_ms, bound_by = bound(flops, nbytes, name)
            rec = {"kernel": "fused_bn_stats", "dtype": name,
                   "shape": f"{label}: M={m} C={c}", "max_err": errs,
                   "max_abs_err": abs_errs,
                   "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "library": "torch.var_mean", "bytes": nbytes,
                   "bound_ms": bound_ms, "bound_by": bound_by}
            log("kernel bn " + json.dumps(rec))
            if not ok:
                raise AssertionError(f"fused BN stats/apply {name} {label} "
                                     f"disagrees with its plain version: "
                                     f"{errs}")
            if quote:
                records[("fused_bn_stats", name)] = rec
                # K2 at the stem, with relu
                k2_time(fb, label, fb.to2d(x), mean, inv, scale, bias,
                        "relu", None, name)
    for name, shapes in conv_shapes.items():   # K4 at all four shapes
        records[("fused_conv_stats", name)]["all_shapes"] = shapes
    return records


def resnet_program(fluid, resnet, b, hw, amp, classes=1000, optimizer=None,
                   stem_s2d=False):
    """The JAX bench's ResNet-50 recipe (7x7 stem, or the space-to-depth
    stem with `stem_s2d`): resnet → softmax CE → mean → Momentum(0.1, 0.9)
    (or `optimizer()`, built inside the program), under bf16 AMP when
    `amp`. Built with PDTPU_CONV_BN_FUSION=pallas (36 fused_conv_bn ops)."""
    os.environ["PDTPU_CONV_BN_FUSION"] = "pallas"
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 2024
    with fluid.program_guard(main, startup):
        img = fluid.layers.data("img", [3, hw, hw])
        label = fluid.layers.data("label", [1], dtype="int64")
        logits = resnet.resnet(img, 50, classes, stem_s2d=stem_s2d)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        opt = (optimizer() if optimizer is not None
               else fluid.optimizer.Momentum(0.1, 0.9))
        amp_wrapper(fluid, amp)(opt).minimize(loss)
    return main, startup, loss


def resnet_feed(b, hw, seed=2024, classes=1000, device="cuda"):
    """One batch from `seed`, put on the card once (a loader that prefetches
    to the device hands the executor tensors already there)."""
    import torch

    rng = np.random.RandomState(seed)
    return {"img": torch.tensor(rng.randn(b, 3, hw, hw).astype("float32"),
                                device=device),
            "label": torch.tensor(rng.randint(0, classes, (b, 1)),
                                  dtype=torch.int64, device=device)}


def bn_counts(fb):
    return {k: getattr(fb, k).launches for k in RESNET_PER_STEP}


def reset_bn_counts(fb):
    for k in RESNET_PER_STEP:
        getattr(fb, k).launches = 0


def run_resnet(fluid, fb, b, amp, label):
    """One training run of the recipe: 2 steps, 1 + 4 profiled, 6 warm.
    Returns (the fused-BN launches of the run, the record)."""
    import torch
    from paddle_tpu_torch.models import resnet

    main, startup, loss = resnet_program(fluid, resnet, b, RESNET_HW, amp)
    feed = resnet_feed(b, RESNET_HW)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_bn_counts(fb)                        # main path starts
        losses = []

        def step():
            (lv,) = exe.run(main, feed=feed, fetch_list=[loss])
            losses.append(float(lv))

        first_ms = []
        for _ in range(2):
            t0 = time.perf_counter()
            step()
            first_ms.append((time.perf_counter() - t0) * 1e3)
        rec = profile_record(f"resnet50 {label} step B={b} {RESNET_HW}^2",
                             step, 4)
        warm = []
        for _ in range(6):
            t0 = time.perf_counter()
            step()
            warm.append((time.perf_counter() - t0) * 1e3)
        counts = bn_counts(fb)                     # main path ends
        peak = torch.cuda.max_memory_allocated() / 2**20
    steps = len(losses)
    med = float(np.median(warm))
    rec.update({"steps": steps, "losses": losses,
                "first_steps_ms": first_ms, "warm_step_ms": warm,
                "median_ms": med, "range_ms": [min(warm), max(warm)],
                "img_per_s": b / med * 1e3,
                "device_busy_share_of_median": ratio(rec["device_busy_ms"], med),
                "peak_memory_MiB_run": peak,
                "ops_per_step": len(main.global_block().ops),
                "fused_bn_launches": counts})
    log("resnet " + json.dumps(rec))
    if not np.isfinite(losses).all():
        raise AssertionError(f"resnet {label}: losses {losses}")
    per_step = {k: v / steps for k, v in counts.items()}
    if per_step != {k: float(v) for k, v in RESNET_PER_STEP.items()}:
        raise AssertionError(f"resnet {label}: fused-BN launches per step "
                             f"{per_step}, expected {RESNET_PER_STEP}")
    return counts, rec


# phase 7's bf16 AMP record (7x7 stem), beside which phase 17 puts the
# space-to-depth stem's
RESNET_7X7 = {}


def phase_resnet(fluid, fb):
    """Main path 3: ResNet-50 training with both switches on, bf16 AMP at
    B=128 and f32 at B=32; then GPU against CPU. Returns the launches of
    each run."""
    os.environ["PDTPU_BN_MODE"] = "pallas"
    launches = {}
    launches["bfloat16"], rec = run_resnet(fluid, fb, RESNET_B, True,
                                           "bf16 AMP")
    RESNET_7X7.update(rec)
    launches["float32"], _ = run_resnet(fluid, fb, 32, False, "f32")
    resnet_gpu_vs_cpu(fluid, fb)
    return launches


def resnet_gpu_vs_cpu(fluid, fb, stem_s2d=False):
    """One f32 ResNet-50 step at 64x64, B=16, on the card against the CPU
    from the same weights: every fused-BN gate of stages 1-2 and the stem
    passes there, so each kernel launches on the card. The gradients of a
    depth-50 net at random init are chaotic: on the CPU alone, multiplying
    the input by (1 + 1e-7 * randn), about one ulp, moves them by ~2 %
    (relative L2). So the card's gradients are held to the CPU's within
    twice what that one-ulp change of the input does to the CPU's own
    (median and worst over the parameters), and the loss within 1e-5."""
    from paddle_tpu_torch.models import resnet

    main, startup, loss = resnet_program(fluid, resnet, 16, 64, False,
                                         stem_s2d=stem_s2d)
    feed = {k: v.cpu().numpy() for k, v in resnet_feed(16, 64).items()}
    nudged = dict(feed, img=(feed["img"] * (1.0 + 1e-7 * np.random.RandomState(
        5).randn(*feed["img"].shape))).astype("float32"))
    grads = [p.name + "@GRAD" for p in main.all_parameters()]
    exe = fluid.Executor(fluid.CUDAPlace(0))
    gpu_scope = fluid.Scope()
    with fluid.scope_guard(gpu_scope):
        exe.run(startup)
    state = {v.name: gpu_scope.find_np(v.name) for v in main.list_vars()
             if v.persistable and gpu_scope.has_var(v.name)}
    reset_bn_counts(fb)
    gpu = exe.run(main, feed=feed, fetch_list=[loss] + grads,
                  scope=gpu_scope)
    on_card = bn_counts(fb)
    cpu_runs = []
    for f in (feed, nudged):
        cpu_scope = fluid.Scope()
        fluid.io.load_params_from_numpy(state, scope=cpu_scope)
        cpu_runs.append(fluid.Executor(fluid.CPUPlace()).run(
            main, feed=f, fetch_list=[loss] + grads, scope=cpu_scope))
    cpu, cpu_nudged = cpu_runs
    loss_rel = abs(float(gpu[0]) - float(cpu[0])) / abs(float(cpu[0]))
    card = [rel_l2(a, b) for a, b in zip(gpu[1:], cpu[1:])]
    ulp = [rel_l2(a, b) for a, b in zip(cpu_nudged[1:], cpu[1:])]
    worst = sorted(zip(card, grads), reverse=True)[:5]
    summary = {"card_vs_cpu": {"median": float(np.median(card)),
                               "max": max(card)},
               "cpu_one_ulp_input": {"median": float(np.median(ulp)),
                                     "max": max(ulp)},
               "worst_card_vs_cpu": worst}
    log(f"resnet GPU vs CPU (depth 50, {'s2d' if stem_s2d else '7x7'} "
        f"stem, 64x64, B=16, f32): loss "
        f"{float(gpu[0])} vs {float(cpu[0])} relative {loss_rel:.3e} (tol "
        f"1e-5); grads of {len(grads)} parameters, relative L2 "
        f"{json.dumps(summary)} (tol: 2x the CPU's one-ulp spread); "
        f"fused-BN launches on the card {json.dumps(on_card)}")
    if not all(on_card.values()):
        raise AssertionError("a fused-BN kernel did not launch in the GPU "
                             "vs CPU step")
    if loss_rel > 1e-5 or np.median(card) > 2 * np.median(ulp) \
            or max(card) > 2 * max(ulp):
        raise AssertionError("GPU and CPU ResNet-50 steps disagree")
    return {"loss_rel": loss_rel, **summary}

# ---------------------------------------------------------------------------
# block-sparse attention kernels and Transformer-big NMT
# ---------------------------------------------------------------------------

def wmt_stream(vocab, max_sent=128, n=200000, seed=0):
    """The JAX bench's seeded WMT14 en-de-like pair stream (bench.py:1199):
    log-normal lengths, mean about 26 tokens; nothing is downloaded."""
    def gen():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            ls = int(np.clip(rng.lognormal(3.1, 0.55), 4, max_sent))
            lt = int(np.clip(ls * rng.uniform(0.8, 1.25), 4, max_sent))
            yield (rng.randint(1, vocab, ls).astype("int32"),
                   rng.randint(1, vocab, lt).astype("int32"))
    return gen


def nmt_batches(b, t, n_batches, vocab=32000):
    """n_batches stacks of b rows packed by the port's reader.pack_by_tokens
    (Ts = Tt = t), each with its count of non-pad target tokens."""
    from paddle_tpu_torch import reader

    batches, rows = [], []
    for row in reader.pack_by_tokens(wmt_stream(vocab), t, t)():
        rows.append(row)
        if len(rows) == b:
            stack = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
            batches.append((stack, int((stack["lbl_ids"] != 0).sum())))
            rows = []
            if len(batches) == n_batches:
                return batches
    raise AssertionError("the stream ran out of pairs")


def packed_heads(b, t, nh, d, dtype, gen):
    """A [B, nh, T, d] view of one [B, T, nh·d] projection, as the NMT fc
    outputs reach the attention op."""
    import torch

    x = torch.randn(b, t, nh * d, generator=gen, device="cuda").to(dtype)
    return heads(x, nh)


def sparse_case(fas, name, q_seg, k_seg, causal, dtype, gen, pad_row):
    """One block-sparse case against the plain versions, at dropout 0 and
    0.1, with two backward calls bitwise equal, the bitwise skip check at
    0.1 and exact zeros on the pad row. Returns (inputs for timing, {check:
    max abs err}, skip and fill statistics)."""
    import torch

    dt = str(dtype).split(".")[1]
    b, tq = q_seg.shape
    tk = k_seg.shape[1]
    se = fas.pack_se(q_seg, k_seg)
    vis = fas.compute_block_vis(se, tq, tk, causal=causal)
    q = packed_heads(b, tq, NMT_NH, D, dtype, gen)
    k, v = (packed_heads(b, tk, NMT_NH, D, dtype, gen) for _ in range(2))
    dout = packed_heads(b, tq, NMT_NH, D, dtype, gen)
    errs = {}
    for rate in (0.0, DROPOUT):
        out, lse = fas.flash_attention_sparse_fwd(q, k, v, se, vis, causal,
                                                  None, rate, 91)
        ref_out, ref_lse = fas.flash_attention_sparse_fwd_plain(
            q, k, v, se, vis, causal, None, rate, 91)
        got = fas.flash_attention_sparse_bwd(q, k, v, out, lse, dout, se, vis,
                                             causal, None, rate, 91)
        want = fas.flash_attention_sparse_bwd_plain(
            q, k, v, out, lse, dout, se, vis, causal, None, rate, 91)
        torch.cuda.synchronize()
        e_out, ok_out = max_err(out, ref_out, TOL[dt])
        e_lse, ok_lse = max_err(lse, ref_lse, TOL[dt])
        e_bwd, ok_bwd = bwd_errs(got, want, dt)
        errs[f"dropout={rate}"] = dict(out=e_out, lse=e_lse, **e_bwd)
        if not (ok_out and ok_lse and ok_bwd):
            raise AssertionError(f"sparse {name} {dt} dropout={rate} "
                                 f"disagrees with its plain version: {errs}")
        again = fas.flash_attention_sparse_bwd(q, k, v, out, lse, dout, se,
                                               vis, causal, None, rate, 91)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"sparse {name} {dt} dropout={rate}: two "
                                 f"backward calls differ")
        if pad_row is not None:
            if (out[pad_row].any() or (lse[pad_row] != -1e30).any()
                    or any(g[pad_row].any() for g in got)):
                raise AssertionError(f"sparse {name} {dt}: the all-pad row "
                                     f"is not exactly zero")
        if rate > 0.0:
            # every tile processed: bitwise the same as skipping
            ones = torch.ones_like(vis)
            out1, lse1 = fas.flash_attention_sparse_fwd(
                q, k, v, se, ones, causal, None, rate, 91)
            got1 = fas.flash_attention_sparse_bwd(q, k, v, out1, lse1, dout,
                                                  se, ones, causal, None,
                                                  rate, 91)
            torch.cuda.synchronize()
            same = [torch.equal(a, b) for a, b in
                    zip((out, lse) + tuple(got), (out1, lse1) + tuple(got1))]
            if not all(same):
                raise AssertionError(f"sparse {name} {dt}: skipping tiles is "
                                     f"not bitwise invisible "
                                     f"(out, lse, dq, dk, dv: {same})")
    mask = fas._mask(se, None, tq, tk, causal)
    stats = {"visible_pairs": int(mask.sum()) * NMT_NH,
             "pair_density": float(mask.float().mean()),
             "tiles_skipped": 1.0 - float(vis.float().mean()),
             "q_fill": float((q_seg > 0).float().mean()),
             "k_fill": float((k_seg > 0).float().mean())}
    return (q, k, v, dout, se, vis, mask, causal), errs, stats


def sparse_timing(fas, dt, inputs, stats):
    """Device ms of the kernels, their plain versions and SDPA with the
    dense boolean mask (and of the backward's delta kernel alone), and the
    bound over the visible pairs."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    q, k, v, dout, se, vis, mask, causal = inputs
    out, lse = fas.flash_attention_sparse_fwd(q, k, v, se, vis, causal)
    fwd = dict(zip(("ms", "dropout_ms", "plain_ms", "library_ms"), (
        device_ms(fn) for fn in (
            lambda: fas.flash_attention_sparse_fwd(q, k, v, se, vis, causal),
            lambda: fas.flash_attention_sparse_fwd(q, k, v, se, vis, causal,
                                                   None, DROPOUT, 91),
            lambda: fas.flash_attention_sparse_fwd_plain(q, k, v, se, vis,
                                                         causal),
            lambda: F.scaled_dot_product_attention(q, k, v,
                                                   attn_mask=mask)))))
    lq, lk, lv = (x.detach().requires_grad_() for x in (q, k, v))
    lout = F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask)
    bwd = dict(zip(("ms", "dropout_ms", "plain_ms", "library_ms",
                    "library_fwd_bwd_ms"), (device_ms(fn) for fn in (
        lambda: fas.flash_attention_sparse_bwd(q, k, v, out, lse, dout, se,
                                               vis, causal),
        lambda: fas.flash_attention_sparse_bwd(q, k, v, out, lse, dout, se,
                                               vis, causal, None, DROPOUT,
                                               91),
        lambda: fas.flash_attention_sparse_bwd_plain(q, k, v, out, lse, dout,
                                                     se, vis, causal),
        lambda: torch.autograd.grad(lout, (lq, lk, lv), dout,
                                    retain_graph=True),
        lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask),
            (lq, lk, lv), dout)))))
    bwd["delta_ms"] = device_ms(lambda: fa.flash_attention_delta(out, dout))
    pairs = stats["visible_pairs"]
    for rec, (flops, nbytes) in (
            (fwd, fas.fwd_counts(q, k, se, vis, pairs)),
            (bwd, fas.bwd_counts(q, k, se, vis, pairs))):
        rec["bound_ms"], rec["bound_by"] = bound(flops, nbytes, dt)
        rec.update(flops=flops, bytes=nbytes)
    if dt == "float32":
        # the f32 kernels run three TF32 products per product on the tensor
        # cores (3xTF32): that is their least time; the CUDA-core FMA bound
        # stays beside it
        for rec in (fwd, bwd):
            rec["bound_fma_ms"] = rec["bound_ms"]
            rec["bound_ms"], rec["bound_by"] = bound(
                3 * rec["flops"], rec["bytes"], dt, TF32_PEAK_FLOPS)
    return fwd, bwd


def phase_kernel_sparse(fas):
    """The block-sparse kernels against their plain versions at the NMT
    shapes, f32 and bf16. Returns {(kernel, dtype): record} of the encoder
    self-attention shape the JSON entries quote."""
    import torch

    gen = torch.Generator("cuda").manual_seed(4)
    ((stack, _),) = nmt_batches(NMT_B, NMT_T, 1)
    src = torch.tensor(stack["src_seg"], device="cuda")
    tgt = torch.tensor(stack["tgt_seg"], device="cuda")
    src_pad = src.clone()
    src_pad[-1] = 0                       # one all-pad row
    cases = (("encoder self", src_pad, src_pad, False, NMT_B - 1),
             ("decoder causal self", tgt, tgt, True, None),
             ("cross", tgt, src, False, None),
             (f"cross Tq={NMT_T - 64} Tk={NMT_T}", tgt[:, :NMT_T - 64], src,
              False, None))
    records = {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).split(".")[1]
        for name, q_seg, k_seg, causal, pad_row in cases:
            inputs, errs, stats = sparse_case(fas, name, q_seg, k_seg, causal,
                                              dtype, gen, pad_row)
            rec = {"case": name, "dtype": dt, "B": NMT_B, "nh": NMT_NH,
                   "Tq": q_seg.shape[1], "Tk": k_seg.shape[1], "d": D,
                   "causal": causal, "max_abs_err": errs, **stats}
            fwd, bwd = sparse_timing(fas, dt, inputs, stats)
            rec.update(fwd=fwd, bwd=bwd)
            if name == "encoder self":
                for kname, r, keys in (("fwd", fwd, ("out", "lse")),
                                       ("bwd", bwd, ("dq", "dk", "dv"))):
                    e = max(x[key] for x in errs.values() for key in keys)
                    records[(kname, dt)] = dict(r, max_abs_err=e)
            log("kernel sparse " + json.dumps(rec))
    return records


def phase_sparse_f32_head_dims(fas):
    """The f32 sparse kernels at every head dim they take (d = 64 to 256;
    B=2, nh=2, T=256, two packed NMT rows, the encoder's second row all
    pad): encoder self at d = 64, 128 and 256, decoder causal self at d = 64
    and 192, dropout 0 or 0.1 as test_cuda_kernels_match_plain takes them:
    out and lse within TOL, dq, dk and dv within BWD_TOL fed the kernel's
    lse, two backward calls bitwise equal, the all-ones tile table bitwise
    equal to the computed one, the pad row exactly zero, one launch a call.
    Then the forward's entry at cross attention Tq=192 != Tk=256 with
    dropout at each head dim (test_cuda_f32_forward_entry): its CTAs (one
    per output chunk, q tile and b·h), out and lse within TOL, a pad query
    row exactly 0 and -1e30, and out's 64-wide chunks bitwise equal where
    V's are copies of one another (every chunk CTA forms the same softmax,
    so the lse chunk 0 writes is every chunk's)."""
    import torch

    gen = torch.Generator("cuda").manual_seed(15)
    b, nh, t = 2, 2, NMT_T
    ((stack, _),) = nmt_batches(b, t, 1)
    src = torch.tensor(stack["src_seg"], device="cuda")
    tgt = torch.tensor(stack["tgt_seg"], device="cuda")
    src[-1] = 0
    fwd, bwd = fas.flash_attention_sparse_fwd, fas.flash_attention_sparse_bwd
    for d, causal, rate in ((64, False, 0.0), (64, True, DROPOUT),
                            (128, False, DROPOUT), (192, True, 0.0),
                            (256, False, DROPOUT)):
        seg = tgt if causal else src
        se = fas.pack_se(seg, seg)
        vis = fas.compute_block_vis(se, t, t, causal=causal)
        q, k, v, dout = (packed_heads(b, t, nh, d, torch.float32, gen)
                         for _ in range(4))
        before = (fwd.launches, bwd.launches, fwd.plain_on_cuda,
                  bwd.plain_on_cuda)
        out, lse = fwd(q, k, v, se, vis, causal, None, rate, 23)
        got = bwd(q, k, v, out, lse, dout, se, vis, causal, None, rate, 23)
        again = bwd(q, k, v, out, lse, dout, se, vis, causal, None, rate, 23)
        ones = torch.ones_like(vis)
        out1, lse1 = fwd(q, k, v, se, ones, causal, None, rate, 23)
        got1 = bwd(q, k, v, out1, lse1, dout, se, ones, causal, None, rate,
                   23)
        after = (fwd.launches, bwd.launches, fwd.plain_on_cuda,
                 bwd.plain_on_cuda)
        ref = fas.flash_attention_sparse_fwd_plain(q, k, v, se, vis, causal,
                                                   None, rate, 23)
        want = fas.flash_attention_sparse_bwd_plain(
            q, k, v, out, lse, dout, se, vis, causal, None, rate, 23)
        torch.cuda.synchronize()
        e = [max_err(x, y, TOL["float32"]) for x, y in zip((out, lse), ref)]
        e_bwd, ok_bwd = bwd_errs(got, want, "float32")
        checks = {
            "fwd_within_tol": all(x[1] for x in e),
            "bwd_within_tol": ok_bwd,
            "bwd_repeatable": all(torch.equal(x, y)
                                  for x, y in zip(got, again)),
            "skip_invisible": all(torch.equal(x, y) for x, y in zip(
                (out, lse) + tuple(got), (out1, lse1) + tuple(got1))),
            "pad_row_zero": causal or not (
                out[-1].any() or (lse[-1] != -1e30).any()
                or any(g_[-1].any() for g_ in got)),
            "launches": after == (before[0] + 2, before[1] + 3, before[2],
                                  before[3])}
        log(f"kernel sparse f32 d={d} causal={causal} dropout={rate}: "
            f"max_abs_err out {e[0][0]:.3e} lse {e[1][0]:.3e}, bwd "
            f"{json.dumps(e_bwd)}; {json.dumps(checks)}")
        if not all(checks.values()):
            raise AssertionError(f"f32 sparse kernels at d={d}: {checks}")

    tq = t - 64
    q_seg = tgt[:, :tq].clone()
    q_seg[0] = 0                          # a pad query row
    se = fas.pack_se(q_seg, src)
    vis = fas.compute_block_vis(se, tq, t)
    ctas = fas._lib().flash_attention_sparse_fwd_ctas
    for d in (64, 128) + WIDE_D:
        q = packed_heads(b, tq, nh, d, torch.float32, gen)
        k = packed_heads(b, t, nh, d, torch.float32, gen)
        v = heads(torch.randn(b, t, nh, 64, generator=gen, device="cuda")
                  .repeat(1, 1, 1, d // 64).flatten(2), nh)
        before = fwd.launches
        out, lse = fwd(q, k, v, se, vis, False, None, DROPOUT, 29)
        launched = fwd.launches - before
        ref = fas.flash_attention_sparse_fwd_plain(q, k, v, se, vis, False,
                                                   None, DROPOUT, 29)
        torch.cuda.synchronize()
        e = [max_err(x, y, TOL["float32"]) for x, y in zip((out, lse), ref)]
        want_ctas = b * nh * (tq // 64) * (d // 64 if d > 128 else 1)
        checks = {
            "ctas": ctas(b, nh, tq, d) == want_ctas,
            "within_tol": all(x[1] for x in e),
            "pad_row": not out[0].any() and bool((lse[0] == -1e30).all()),
            "chunks_equal": all(
                torch.equal(out[..., 64 * c:64 * (c + 1)], out[..., :64])
                for c in range(1, d // 64)),
            "one_launch": launched == 1}
        log(f"kernel sparse f32 fwd entry d={d} Tq={tq} Tk={t} dropout="
            f"{DROPOUT}: {ctas(b, nh, tq, d)} CTAs; max_abs_err out "
            f"{e[0][0]:.3e} lse {e[1][0]:.3e}; {json.dumps(checks)}")
        if not all(checks.values()):
            raise AssertionError(f"f32 sparse forward entry d={d}: {checks}")


def phase_sparse_routes(fas):
    """The sparse route on the card: B·nh = 65,600 through the kernels
    (flat grids: forward and both backward kernels against the plain
    versions, bf16), and T = 96 and d = 32 through the plain versions,
    counted in .plain_on_cuda, with no launch (the JAX package's XLA path
    there)."""
    import torch

    gen = torch.Generator("cuda").manual_seed(7)
    rng = np.random.RandomState(7)

    def case(b, nh, t, d):
        seg = np.zeros((b, t), np.int32)
        for i in range(1, b):   # row 0 all pad; two to four segments a row
            cuts = np.sort(rng.choice(np.arange(4, t - 4), rng.randint(1, 4),
                                      replace=False))
            seg[i] = np.searchsorted(cuts, np.arange(t), side="right") + 1
            seg[i, t - rng.randint(0, 8):] = 0
        seg = torch.tensor(seg, device="cuda")
        se = fas.pack_se(seg, seg)
        vis = fas.compute_block_vis(se, t, t)
        q, k, v, dout = (packed_heads(b, t, nh, d, torch.bfloat16, gen)
                         for _ in range(4))
        return q, k, v, dout, se, vis

    def counts():
        return [(f.launches, f.plain_on_cuda) for f in (
            fas.flash_attention_sparse_fwd, fas.flash_attention_sparse_bwd)]

    b, nh, t = 4100, 16, 64          # B·nh = 65,600 > 65,535
    q, k, v, dout, se, vis = case(b, nh, t, D)
    before = counts()
    out, lse = fas.flash_attention_sparse_fwd(q, k, v, se, vis)
    got = fas.flash_attention_sparse_bwd(q, k, v, out, lse, dout, se, vis)
    after = counts()
    ref_out, ref_lse = fas.flash_attention_sparse_fwd_plain(q, k, v, se, vis)
    want = fas.flash_attention_sparse_bwd_plain(q, k, v, out, lse, dout, se,
                                                vis)
    torch.cuda.synchronize()
    e_o, ok_o = max_err(out, ref_out, TOL["bfloat16"])
    e_l, ok_l = max_err(lse, ref_lse, TOL["bfloat16"])
    errs, ok = bwd_errs(got, want, "bfloat16")
    log(f"kernel sparse grid B·nh={b * nh} T={t} bf16: fwd max_abs_err out "
        f"{e_o:.3e} lse {e_l:.3e}; bwd {json.dumps(errs)}; (launches, plain "
        f"calls) {before} -> {after}")
    if not (ok and ok_o and ok_l) or after != [(n + 1, p) for n, p in
                                               before]:
        raise AssertionError("the sparse kernels at B·nh = 65,600 disagree "
                             "or did not launch")
    del q, k, v, dout, out, lse, got, want, ref_out, ref_lse

    for t, d in ((96, D), (128, 32)):
        q, k, v, dout, se, vis = case(4, 2, t, d)
        before = counts()
        out, lse = fas.flash_attention_sparse_fwd(q, k, v, se, vis)
        got = fas.flash_attention_sparse_bwd(q, k, v, out, lse, dout, se, vis)
        after = counts()
        ref = fas.flash_attention_sparse_fwd_plain(q, k, v, se, vis)
        want = fas.flash_attention_sparse_bwd_plain(q, k, v, out, lse, dout,
                                                    se, vis)
        same = all(torch.equal(a, b) for a, b in
                   zip((out, lse) + tuple(got), tuple(ref) + tuple(want)))
        log(f"sparse route T={t} d={d} on the card: (launches, plain calls) "
            f"{before} -> {after}; equal to the plain versions: {same}")
        if after != [(n, p + 1) for n, p in before] or not same:
            raise AssertionError(f"sparse T={t} d={d} did not take the "
                                 f"counted plain route")


def nmt_program(fluid, nmt, cfg, t, amp, optimizer=None):
    """The JAX bench's NMT recipe: packed-sparse rows, Adam(1e-4) (or
    `optimizer()`, built inside the program), under bf16 AMP when `amp`."""
    def opt():
        return amp_wrapper(fluid, amp)(
            optimizer() if optimizer is not None
            else fluid.optimizer.Adam(LR))

    main, startup, _, loss = nmt.build_train_program(
        cfg, t, t, packed=True, attn="sparse", optimizer_factory=opt)
    main.random_seed = startup.random_seed = 2024
    return main, startup, loss


def nmt_feed(stack, device):
    """A packed batch as the program's feeds, put on `device` once (a loader
    that prefetches to the device hands the executor tensors already
    there)."""
    import torch

    ints = {"src_ids": torch.int64, "tgt_ids": torch.int64,
            "src_pos": torch.int64, "tgt_pos": torch.int64,
            "src_seg": torch.int32, "tgt_seg": torch.int32}
    feed = {k: torch.tensor(stack[k], dtype=dt, device=device)
            for k, dt in ints.items()}
    feed["lbl_ids"] = torch.tensor(stack["lbl_ids"][..., None],
                                   dtype=torch.int64, device=device)
    return feed


def sparse_counts(fas):
    return {"fwd": fas.flash_attention_sparse_fwd.launches,
            "bwd": fas.flash_attention_sparse_bwd.launches,
            "plain_fwd": fas.flash_attention_sparse_fwd.plain_on_cuda,
            "plain_bwd": fas.flash_attention_sparse_bwd.plain_on_cuda}


def reset_sparse_counts(fas):
    for fn in (fas.flash_attention_sparse_fwd,
               fas.flash_attention_sparse_bwd):
        fn.launches = fn.plain_on_cuda = 0


def nmt_tf32_steps(fluid, exe, main, loss, feed):
    """FLAGS_matmul_precision="float32" on the full-depth f32 step: one
    step with TF32 off, then, from the same state and generator, two with
    TF32 allowed (the second profiled); then "default" again, which must
    turn TF32 off. Returns their record."""
    import torch

    scope = fluid.global_scope()
    snap = host_state(scope, main)
    gen = scope.find_var("@RNG_STATE@")
    gen_state = gen.get_state()

    def one(out):
        t0 = time.perf_counter()
        lv = float(exe.run(main, feed=feed, fetch_list=[loss])[0])
        out.append((lv, (time.perf_counter() - t0) * 1e3))

    off, on = [], []
    one(off)
    for n, v in snap.items():
        scope.set_var(n, v.to(exe.device))
    gen.set_state(gen_state)
    fluid.set_flags({"FLAGS_matmul_precision": "float32"})
    try:
        prof = profile_record("nmt f32 step, TF32 allowed", lambda: one(on),
                              1)
    finally:
        fluid.set_flags({"FLAGS_matmul_precision": "default"})
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 still on after matmul_precision default")
    rel = abs(on[0][0] - off[0][0]) / abs(off[0][0])
    if not np.isfinite([lv for lv, _ in on]).all() or rel > 1e-2:
        raise AssertionError(f"nmt f32 with TF32: losses {on} against "
                             f"{off} (relative {rel:.3e}, tol 1e-2)")
    return {"tf32_off": off, "tf32_steps": on, "loss_rel_diff": rel,
            "cublas_ms_tf32": prof["by_category_ms"].get("GEMMs (cuBLAS)"),
            "device_busy_ms_tf32": prof["device_busy_ms"],
            "wall_ms_profiled_tf32": prof["wall_ms"],
            "allow_tf32_after_default": bool(
                torch.backends.cuda.matmul.allow_tf32)}


def phase_nmt(fluid, fas):
    """Main path 4: Transformer-big packed-sparse bf16 AMP training, three
    f32 steps at full depth, then one f32 step at 2+2 layers against the
    CPU. Returns the sparse launches per dtype (f32: both f32 runs)."""
    import torch
    from paddle_tpu_torch.models import transformer_nmt as nmt

    cfg = nmt.TransformerConfig()
    main, startup, loss = nmt_program(fluid, nmt, cfg, NMT_T, True)
    batches = [(nmt_feed(stack, "cuda"), non_pad)
               for stack, non_pad in nmt_batches(NMT_B, NMT_T, 3)]
    exe = fluid.Executor(fluid.CUDAPlace(0))
    losses, step_ms, tokens = [], [], []
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_sparse_counts(fas)                   # main path starts

        def step():
            i = len(losses) % len(batches)
            feed, non_pad = batches[i]
            t0 = time.perf_counter()
            (lv,) = exe.run(main, feed=feed, fetch_list=[loss])
            step_ms.append((time.perf_counter() - t0) * 1e3)
            tokens.append(non_pad)
            losses.append((i, float(lv)))

        # the first step records whether the segment rows reach pack_se
        # contiguous (searchsorted copies a non-contiguous input per call)
        contiguous, pack_se = [], fas.pack_se

        def recording(q_seg, k_seg):
            contiguous.append((q_seg.is_contiguous(), k_seg.is_contiguous()))
            return pack_se(q_seg, k_seg)

        fas.pack_se = recording
        try:
            step()
        finally:
            fas.pack_se = pack_se
        log(f"nmt: pack_se inputs contiguous (q_seg, k_seg) in step 1: "
            f"{sorted(set(contiguous))} over {len(contiguous)} calls")
        step()
        rec = profile_record(f"nmt transformer-big bf16 step B={NMT_B} "
                             f"T={NMT_T}", step, 1)
        for _ in range(6):
            step()
        counts = sparse_counts(fas)                # main path ends
        peak = torch.cuda.max_memory_allocated() / 2**20
    steps = len(losses)
    warm, warm_tok = step_ms[-6:], tokens[-6:]
    med = float(np.median(warm))
    rec.update({"steps": steps, "losses": losses, "first_steps_ms":
                step_ms[:2], "warm_step_ms": warm, "median_ms": med,
                "range_ms": [min(warm), max(warm)],
                "non_pad_target_tokens_per_s": sum(warm_tok) / sum(warm)
                * 1e3, "non_pad_target_tokens_per_batch": [
                    n for _, n in batches],
                "target_fill": [n / (NMT_B * NMT_T) for _, n in batches],
                "device_busy_share_of_median": ratio(rec["device_busy_ms"], med),
                "peak_memory_MiB_run": peak,
                "ops_per_step": len(main.global_block().ops),
                "sparse_launches": counts})
    log("nmt " + json.dumps(rec))
    vals = [lv for _, lv in losses]
    first0 = next(lv for i, lv in losses if i == 0)
    last0 = [lv for i, lv in losses if i == 0][-1]
    if not np.isfinite(vals).all() or abs(vals[0] - LN_NMT_VOCAB) > 0.5 \
            or not last0 < first0:
        raise AssertionError(f"nmt: losses {losses} (want finite, the first "
                             f"within 0.5 of {LN_NMT_VOCAB}, batch 0's loss "
                             f"falling when it comes again)")
    if counts != {"fwd": NMT_PER_STEP * steps, "bwd": NMT_PER_STEP * steps,
                  "plain_fwd": 0, "plain_bwd": 0}:
        raise AssertionError(f"nmt: sparse launches {counts} in {steps} "
                             f"steps, expected {NMT_PER_STEP} each a step "
                             f"and no plain-route call")
    launches = {"bfloat16": counts}

    # f32 at full depth (6+6 layers, B=16, T=256, dropout 0.1, Adam): one
    # step, then profile_record's unprofiled and profiled ones; the f32
    # sparse kernels' launches a step and their share of the step
    main, startup, loss = nmt_program(fluid, nmt, cfg, NMT_T, False)
    f32_ms, f32_losses = [], []
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        torch.cuda.synchronize()
        reset_sparse_counts(fas)                   # f32 main path starts

        def f32_step():
            feed, _ = batches[len(f32_losses) % len(batches)]
            t0 = time.perf_counter()
            (lv,) = exe.run(main, feed=feed, fetch_list=[loss])
            f32_ms.append((time.perf_counter() - t0) * 1e3)
            f32_losses.append(float(lv))

        f32_step()
        rec = profile_record(f"nmt transformer-big f32 step B={NMT_B} "
                             f"T={NMT_T}", f32_step, 1)
        f32_counts = sparse_counts(fas)            # f32 main path ends
        tf32 = nmt_tf32_steps(fluid, exe, main, loss,
                              batches[len(f32_losses) % len(batches)][0])
    cats = rec["by_category_ms"]
    sparse_ms = {k: v for k, v in cats.items() if "flash sparse" in k
                 or "bwd delta" in k}
    rec.update({"losses": f32_losses, "step_ms": f32_ms,
                "warm_unprofiled_step_ms": f32_ms[1],
                "device_busy_share_of_warm_step":
                    ratio(rec["device_busy_ms"], f32_ms[1]),
                "sparse_flash_ms": sparse_ms,
                "sparse_flash_share_of_busy":
                    ratio(sum(sparse_ms.values()), rec["device_busy_ms"]),
                "sparse_launches": f32_counts})
    tf32["cublas_ms_tf32_off"] = rec["by_category_ms"].get("GEMMs (cuBLAS)")
    log("nmt f32 full depth " + json.dumps(rec))
    log("nmt f32 full depth matmul_precision float32 " + json.dumps(tf32))
    steps = len(f32_losses)
    if not np.isfinite(f32_losses).all() \
            or abs(f32_losses[0] - LN_NMT_VOCAB) > 0.5:
        raise AssertionError(f"nmt f32: losses {f32_losses} (want finite, "
                             f"the first within 0.5 of {LN_NMT_VOCAB})")
    if f32_counts != {"fwd": NMT_PER_STEP * steps,
                      "bwd": NMT_PER_STEP * steps, "plain_fwd": 0,
                      "plain_bwd": 0}:
        raise AssertionError(f"nmt f32: sparse launches {f32_counts} in "
                             f"{steps} steps, expected {NMT_PER_STEP} each "
                             f"a step and no plain-route call")

    # GPU against CPU: f32, full width cut to 2+2 layers, B=4, T=128,
    # dropout 0. Held to 1e-4 relative L2 a gradient, or to twice what a
    # one-ulp change of the source embedding does to the CPU's own
    # gradients where that spread is larger.
    small = nmt.TransformerConfig(n_enc=2, n_dec=2, dropout=0.0)
    main, startup, loss = nmt_program(fluid, nmt, small, 128, False)
    ((stack, _),) = nmt_batches(4, 128, 1)
    feed = {k: v.numpy() for k, v in nmt_feed(stack, "cpu").items()}
    grads = [p.name + "@GRAD" for p in main.all_parameters()]
    gpu_scope = fluid.Scope()
    with fluid.scope_guard(gpu_scope):
        exe.run(startup)
    state = {v.name: gpu_scope.find_np(v.name) for v in main.list_vars()
             if v.persistable and gpu_scope.has_var(v.name)}
    reset_sparse_counts(fas)                       # f32 path starts
    gpu = exe.run(main, feed=feed, fetch_list=[loss] + grads,
                  scope=gpu_scope)
    small_counts = sparse_counts(fas)              # f32 path ends
    nudged = dict(state)
    emb = state["src_embedding"]
    nudged["src_embedding"] = (emb * (1.0 + 1e-7 * np.random.RandomState(
        5).randn(*emb.shape))).astype("float32")
    cpu_runs = []
    for st in (state, nudged):
        cpu_scope = fluid.Scope()
        fluid.io.load_params_from_numpy(st, scope=cpu_scope)
        cpu_runs.append(fluid.Executor(fluid.CPUPlace()).run(
            main, feed=feed, fetch_list=[loss] + grads, scope=cpu_scope))
    cpu, cpu_nudged = cpu_runs
    loss_rel = abs(float(gpu[0]) - float(cpu[0])) / abs(float(cpu[0]))
    card = [rel_l2(a, b) for a, b in zip(gpu[1:], cpu[1:])]
    ulp = [rel_l2(a, b) for a, b in zip(cpu_nudged[1:], cpu[1:])]
    limit = max(1e-4, 2 * max(ulp))
    summary = {"card_vs_cpu": {"median": float(np.median(card)),
                               "max": max(card)},
               "cpu_one_ulp_embedding": {"median": float(np.median(ulp)),
                                         "max": max(ulp)},
               "limit": limit,
               "worst_card_vs_cpu": sorted(zip(card, grads),
                                           reverse=True)[:5]}
    log(f"nmt GPU vs CPU (2+2 layers, full width, B=4, T=128, f32, dropout "
        f"0): loss {float(gpu[0])} vs {float(cpu[0])} relative "
        f"{loss_rel:.3e} (tol 1e-5); grads of {len(grads)} parameters, "
        f"relative L2 {json.dumps(summary)}; sparse launches on the card "
        f"{json.dumps(small_counts)}")
    if small_counts != {"fwd": 6, "bwd": 6, "plain_fwd": 0, "plain_bwd": 0}:
        raise AssertionError("the f32 step did not launch the sparse kernels "
                             "6 + 6 times")
    launches["float32"] = {k: f32_counts[k] + n
                           for k, n in small_counts.items()}
    if loss_rel > 1e-5 or max(card) > limit:
        raise AssertionError("GPU and CPU NMT steps disagree")
    rec = profile_record("nmt f32 2+2 layers step B=4 T=128", lambda: exe.run(
        main, feed=feed, fetch_list=[loss], scope=gpu_scope), 1)
    log("nmt f32 " + json.dumps(rec))
    return launches


# ---------------------------------------------------------------------------
# sparse-Adagrad and row kernels, DeepFM and the PS hot-row cache
# ---------------------------------------------------------------------------


def phase_wide_path(fluid, fa, fas):
    """Main path 7: the wide kernels (head dims above 256) through the entry
    points a user calls. BERT pretraining at BERT-large's hidden 1024 cut to
    2 heads (d = 512) and 2 layers, from seed 2024: 2 Adam steps in f32
    (B=4, T=128) and 2 in bf16 AMP (B=4, T=512), dropout 0.1; then
    Transformer-big (d_model 1024) cut to 2 heads and 2+2 layers,
    packed-sparse: 2 steps in bf16 AMP (B=4, T=256) and 2 in f32 (B=4,
    T=128). Checks finite losses and, in each run, one wide launch per
    attention layer and step in each direction and no plain-route call (nor
    a call of the plain delta). Returns {(entry, dtype): wide launches}."""
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.models import transformer_nmt as nmt

    rng = np.random.RandomState(13)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    fns = (fa.flash_attention_fwd, fa.flash_attention_bwd,
           fas.flash_attention_sparse_fwd, fas.flash_attention_sparse_bwd)
    keys = ("fwd", "bwd", "sparse_fwd", "sparse_bwd")
    launches = {}
    cfg = nmt.TransformerConfig(n_heads=WIDE_HEADS, n_enc=2, n_dec=2)
    runs = (("bert", "float32", 128), ("bert", "bfloat16", 512),
            ("nmt", "bfloat16", NMT_T), ("nmt", "float32", 128))
    for model, name, t in runs:
        amp = name == "bfloat16"
        if model == "bert":
            main, startup, loss = build_pretrain(
                fluid, bert, WIDE_B, t, amp, layers=2, hidden=WIDE_HIDDEN,
                heads=WIDE_HEADS, ffn=4096)
            feeds = [pretrain_feed(WIDE_B, t, rng)] * 2
            per_step = {"fwd": 2, "bwd": 2}
        else:
            main, startup, loss = nmt_program(fluid, nmt, cfg, t, amp)
            feeds = [nmt_feed(stack, "cuda")
                     for stack, _ in nmt_batches(WIDE_B, t, 2)]
            per_step = {"sparse_fwd": 6, "sparse_bwd": 6}
        delta_plain, plain_delta_calls = fa.flash_attention_delta_plain, []
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            fa.flash_attention_delta_plain = lambda *a: (
                plain_delta_calls.append(1), delta_plain(*a))[1]
            for fn in fns:                       # main path starts
                fn.launches = fn.wide_launches = fn.plain_on_cuda = 0
            try:
                vals = [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
                        for feed in feeds]
            finally:
                fa.flash_attention_delta_plain = delta_plain
            counts = {k: (fn.launches, fn.wide_launches, fn.plain_on_cuda)
                      for k, fn in zip(keys, fns)}   # main path ends
        want = {k: (per_step.get(k, 0) * 2,) * 2 + (0,) for k in keys}
        log(f"wide path {model} {name} B={WIDE_B} T={t} heads={WIDE_HEADS} "
            f"d={WIDE_HIDDEN // WIDE_HEADS}: losses {vals}; (launches, wide "
            f"launches, plain-route calls) {json.dumps(counts)}; plain "
            f"delta calls {len(plain_delta_calls)}")
        if not np.isfinite(vals).all() or counts != want \
                or plain_delta_calls:
            raise AssertionError(f"wide path {model} {name}: losses {vals}, "
                                 f"counts {counts}, expected {want}")
        for k in per_step:
            launches[(k, name)] = counts[k][1]
    return launches


def packed_table(fsa, v, vis, gen, chunk=1 << 20):
    """A [v, 128] packed table on the card with payload [p | G] from `gen`
    (p ~ N(0, 1), G = |N(0, 1)|), built in row chunks."""
    import torch

    table = torch.empty((v, fsa.PACK_LANES), dtype=torch.int16, device="cuda")
    for start in range(0, v, chunk):
        n = min(chunk, v - start)
        rows = torch.randn(n, 2 * vis, generator=gen, device="cuda")
        rows[:, vis:] = rows[:, vis:].abs()
        table[start:start + n] = fsa.i16(fsa.pack_rows(rows))
    return table.view(torch.uint16)


def equal16(a, b):
    """Bitwise equality of two packed tensors (through int16 views)."""
    import torch

    return torch.equal(a.view(torch.int16), b.view(torch.int16))


def phase_kernel_sparse_adagrad(fsa, dr):
    """Rows 12–14 against their plain versions on the card at the main
    path's shapes, bit for bit. Returns {kernel: record}."""
    import torch

    gen = torch.Generator("cuda").manual_seed(12)
    records = {}
    # row 12: the DeepFM table and one step's ids (uniform over the vocab:
    # ~170 duplicates, so a SENTINEL tail), merged as the op merges them
    table = packed_table(fsa, DEEPFM_VOCAB, DEEPFM_VIS, gen)
    ids = torch.tensor(np.random.RandomState(0).randint(
        0, DEEPFM_VOCAB, DEEPFM_ROWS), device="cuda")
    grows = torch.randn(DEEPFM_ROWS, DEEPFM_VIS, generator=gen, device="cuda")
    uids, utot, _ = dr.uniq_merge(ids, grows, DEEPFM_ROWS)
    nu = int((uids != fsa.SENTINEL).sum())
    lr = torch.tensor(0.05, device="cuda")
    # spare lanes nonzero on the touched rows, so their zeroing shows
    valid = uids[:nu]
    fsa.i16(table)[valid, 4 * DEEPFM_VIS:] = 7
    plain = table.clone()
    fsa.fused_adagrad_update(table, uids, utot, lr, vis=DEEPFM_VIS, eps=1e-6)
    fsa.fused_adagrad_update_plain(plain, uids, utot, lr, DEEPFM_VIS, 1e-6)
    torch.cuda.synchronize()
    same = equal16(table, plain)
    spare_zero = not bool(fsa.i16(table)[valid, 4 * DEEPFM_VIS:].any())
    del plain
    # the all-sentinel call leaves the table as it was
    before = table.clone()
    fsa.fused_adagrad_update(
        table, torch.full_like(uids, fsa.SENTINEL), utot, lr,
        vis=DEEPFM_VIS, eps=1e-6)
    torch.cuda.synchronize()
    untouched = equal16(table, before)
    ms, plain_ms = (cold_device_ms(fn) for fn in (
        lambda: fsa.fused_adagrad_update(table, uids, utot, lr,
                                         vis=DEEPFM_VIS, eps=1e-6),
        lambda: fsa.fused_adagrad_update_plain(table, uids, utot, lr,
                                               DEEPFM_VIS, 1e-6)))
    # each valid slot reads its id, its summed gradient and the payload of
    # its row and writes the whole row; a SENTINEL slot reads its id
    flops, nbytes = fsa.adagrad_counts(nu, DEEPFM_ROWS, DEEPFM_VIS)
    bound_ms, bound_by = bound(flops, nbytes, "float32")
    records["sparse_adagrad_update"] = rec = {
        "shape": f"table [{DEEPFM_VOCAB}, 128] u16, {DEEPFM_ROWS} slots "
                 f"({nu} valid), vis {DEEPFM_VIS}",
        "bitwise_equal_plain": same, "spare_lanes_zero": spare_zero,
        "all_sentinel_untouched": untouched, "max_abs_err": 0.0 if same
        else None, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
        "library": None, "bytes": nbytes, "bound_ms": bound_ms,
        "bound_by": bound_by}
    log("kernel sparse_adagrad " + json.dumps(rec))
    if not (same and spare_zero and untouched):
        raise AssertionError(f"sparse_adagrad_update disagrees with its "
                             f"plain version: {rec}")
    del table, before

    # rows 13 and 14: the hot cache's slab, n = 65,536 slots padded by
    # repeating the last one (the cache's bucket rule)
    slab = torch.randint(-2 ** 15, 2 ** 15, (HOT_SLAB_ROWS, fsa.PACK_LANES),
                         generator=gen, device="cuda",
                         dtype=torch.int16).view(torch.uint16)
    n = HOT_ROW_SLOTS
    perm = torch.randperm(HOT_SLAB_ROWS, generator=gen, device="cuda")
    slots = perm[:n].clone()
    slots[n - n // 8:] = slots[n - n // 8 - 1]        # padded duplicate tail
    src = torch.arange(n, device="cuda")
    src[n - n // 8:] = n - n // 8 - 1
    got = fsa.fused_row_gather(slab, slots)
    want = fsa.fused_row_gather_plain(slab, slots)
    rows = torch.randint(-2 ** 15, 2 ** 15, (n, fsa.PACK_LANES),
                         generator=gen, device="cuda",
                         dtype=torch.int16).view(torch.uint16)
    a, b = slab.clone(), slab.clone()
    fsa.fused_row_scatter(a, slots, rows, src)
    fsa.fused_row_scatter_plain(b, slots, rows, src)
    torch.cuda.synchronize()
    checks = {"sparse_row_gather": equal16(got, want),
              "sparse_row_scatter": equal16(a, b)}
    del a, b
    # the padded tail repeats one slot (and one src): a row is read (and
    # written) once per distinct slot, the gather's output once per slot,
    # and every slot's ids are read
    n_slots, n_src = int(slots.unique().numel()), int(src.unique().numel())
    s16 = fsa.i16(slab)
    for kname, fn, plain_fn, lib_fn, lib, nbytes in (
            ("sparse_row_gather",
             lambda: fsa.fused_row_gather(slab, slots),
             lambda: fsa.fused_row_gather_plain(slab, slots),
             lambda: s16.index_select(0, slots), "Tensor.index_select",
             fsa.gather_counts(n_slots, n)[1]),
            ("sparse_row_scatter",
             lambda: fsa.fused_row_scatter(slab, slots, rows, src),
             lambda: fsa.fused_row_scatter_plain(slab, slots, rows, src),
             lambda: s16.index_copy_(0, slots, fsa.i16(rows)),
             "Tensor.index_copy_", fsa.scatter_counts(n_src, n_slots, n)[1])):
        ms, plain_ms, library_ms = (cold_device_ms(f) for f in (
            fn, plain_fn, lib_fn))
        bound_ms, bound_by = bound(0.0, nbytes, "float32")
        records[kname] = rec = {
            "shape": f"slab [{HOT_SLAB_ROWS}, 128] u16, n={n} (last "
                     f"{n // 8} repeat the last slot)",
            "bitwise_equal_plain": checks[kname],
            "max_abs_err": 0.0 if checks[kname] else None, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, "library": lib,
            "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by}
        log("kernel sparse_rows " + json.dumps({kname: rec}))
    if not all(checks.values()):
        raise AssertionError(f"row kernels disagree with their plain "
                             f"versions: {checks}")
    return records


def deepfm_program(fluid, deepfm, vocab, rows, fused=True):
    """The JAX bench's DeepFM recipe: one fm_t table of 17 visible columns
    on exact Adagrad in the packed layout, the dense net on Adam."""
    from paddle_tpu_torch.core import unique_name

    with unique_name.guard():
        main, startup, _, loss, _ = deepfm.build_train_program(
            vocab_size=vocab, is_sparse=True, fused_table=True,
            embedding_optimizer="adagrad",
            packed_rows={"rows_per_step": rows, "fused": fused})
    main.random_seed = startup.random_seed = 2024
    return main, startup, loss


def deepfm_feed(rng, b, vocab, device=None, zipf=None):
    """One batch: uniform ids (or Zipf(`zipf`) ids folded into the vocab,
    as the JAX bench draws them), dense features and 0/1 labels."""
    import torch

    ids = (rng.randint(0, vocab, (b, 26)) if zipf is None
           else (rng.zipf(zipf, (b, 26)) - 1) % vocab).astype("int64")
    feed = {"sparse_ids": ids, "dense": rng.rand(b, 13).astype("float32"),
            "label": rng.randint(0, 2, (b, 1)).astype("float32")}
    if device is None:
        return feed
    return {k: torch.tensor(v, device=device) for k, v in feed.items()}


def clone_state(scope, names):
    return {n: scope.find_var(n).clone() for n in names
            if scope.find_var(n) is not None}


def run_from(fluid, exe, main, loss, state, feed, steps):
    """`steps` steps of `main` from a copy of `state`; (losses, scope)."""
    scope = fluid.Scope()
    for n, t in state.items():
        scope.set_var(n, t.clone())
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(steps)]
    return losses, scope


def phase_deepfm(fluid, fsa):
    """Main path 5: full-width DeepFM on packed-row exact Adagrad, 2 + 1
    profiled + 6 timed steps on one repeated batch; then fused against
    unfused and two fused runs from one state, 2 steps each. Returns the
    row-12 launches of the main run."""
    import torch
    from paddle_tpu_torch.models import deepfm

    main, startup, loss = deepfm_program(fluid, deepfm, DEEPFM_VOCAB,
                                         DEEPFM_ROWS)
    feed = deepfm_feed(np.random.RandomState(0), DEEPFM_B, DEEPFM_VOCAB,
                       "cuda")
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    persist = [v.name for v in main.list_vars() if v.persistable]
    state = clone_state(scope, persist)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []

    def step():
        t1 = time.perf_counter()
        (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        losses.append(float(lv))
        step_ms.append((time.perf_counter() - t1) * 1e3)

    fsa.fused_adagrad_update.launches = 0          # main path starts
    for _ in range(2):
        step()
    rec = profile_record(f"deepfm step B={DEEPFM_B} vocab={DEEPFM_VOCAB}",
                         step, 1)
    for _ in range(6):
        step()
    launches = fsa.fused_adagrad_update.launches   # main path ends
    peak = torch.cuda.max_memory_allocated() / 2**20
    steps = len(losses)
    warm = step_ms[-6:]
    med = float(np.median(warm))
    table = scope.find_var("fm_t")
    rec.update({"steps": steps, "losses": losses, "startup_s": startup_s,
                "table": f"{tuple(table.shape)} {table.dtype}, "
                         f"{table.numel() * 2 / 1e9:.2f} GB",
                "first_steps_ms": step_ms[:2], "warm_step_ms": warm,
                "median_ms": med, "range_ms": [min(warm), max(warm)],
                "examples_per_s": DEEPFM_B / med * 1e3,
                "device_busy_share_of_median": ratio(rec["device_busy_ms"], med),
                "peak_memory_MiB_run": peak,
                "ops_per_step": len(main.global_block().ops),
                "sparse_adagrad_launches": launches})
    log("deepfm " + json.dumps(rec))
    del scope, table
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise AssertionError(f"deepfm: losses {losses} (want finite and "
                             f"falling on the repeated batch)")
    if launches != steps:
        raise AssertionError(f"deepfm: {launches} sparse-Adagrad launches in "
                             f"{steps} steps, expected one a step")

    # fused against unfused, and two fused runs, from one state
    unfused_main, _, unfused_loss = deepfm_program(
        fluid, deepfm, DEEPFM_VOCAB, DEEPFM_ROWS, fused=False)
    la, sa = run_from(fluid, exe, main, loss, state, feed, 2)
    lu, su = run_from(fluid, exe, unfused_main, unfused_loss, state, feed, 2)
    fused_eq = la == lu and equal16(sa.find_var("fm_t"), su.find_var("fm_t"))
    del su
    lb, sb = run_from(fluid, exe, main, loss, state, feed, 2)
    repeat_eq = la == lb and equal16(sa.find_var("fm_t"),
                                     sb.find_var("fm_t"))
    del sa, sb, state
    log(f"deepfm fused vs unfused (2 steps from one state): losses {la} vs "
        f"{lu}, tables equal: {fused_eq}; two fused runs: losses {la} vs "
        f"{lb}, tables equal: {repeat_eq}")
    if not (fused_eq and repeat_eq):
        raise AssertionError("deepfm: fused and unfused (or two fused runs) "
                             "differ")
    return launches


def ps_arm(fluid, deepfm, exe, feeds, hot_rows, pull_ahead=0, keep=None):
    """One arm of the JAX bench's hot-cache A/B: the DeepFM step through
    PsEmbeddingTier over four in-process shards of the full vocab, 4
    warm-up steps then timed ones. Returns (ms per step, losses, cache
    stats with the steady-state lookup hit rate). With a dict `keep`, the
    final table (every shard's rows, after the flush) lands in
    keep["table"]."""
    import torch
    from paddle_tpu_torch.ps import (PsEmbeddingTier, PsTableBinding,
                                     RangeSpec, ShardedTable)

    table = ShardedTable.build_in_process(
        "fm_t", RangeSpec.even(DEEPFM_VOCAB, 4))
    main, startup, loss = deepfm_program(
        fluid, deepfm, hot_rows + DEEPFM_ROWS if hot_rows else DEEPFM_ROWS,
        DEEPFM_ROWS)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    tier = PsEmbeddingTier(main, [PsTableBinding("fm_t", table,
                                                 ["sparse_ids"])],
                           pull_ahead=pull_ahead, push_depth=1,
                           hot_rows=hot_rows, place=fluid.CUDAPlace(0))
    losses, st_warm, t0 = [], None, None
    try:
        for i, prep in enumerate(tier.steps(lambda: iter(feeds))):
            (lv,) = tier.run_step(exe, prep, fetch_list=[loss], scope=scope)
            losses.append(float(lv))
            if i + 1 == HOT_WARMUP:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                st_warm = tier.stats()["fm_t"].get("hot_cache")
        tier.flush()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / (len(feeds) - HOT_WARMUP)
        st = tier.stats()["fm_t"].get("hot_cache")
        if keep is not None:
            keep["table"] = table.dump_full()
    finally:
        tier.close()
    if st is not None:
        dh = st["lookup_hits"] - st_warm["lookup_hits"]
        dm = st["lookup_misses"] - st_warm["lookup_misses"]
        st = dict(st, steady_lookup_hit_rate=dh / (dh + dm) if dh + dm
                  else None)
    return ms, losses, st


# phase 12's hot arm (pull_ahead=0): its feeds, losses and final table,
# the baseline of phase 16's prefetched arm
PS_PULL_AHEAD_0 = {}


def phase_ps_hot_cache(fluid, fsa):
    """Main path 6: the PS tier's device-resident hot-row cache against
    the streaming tier on a Zipf(1.5) id stream (the JAX bench's arm).
    Returns the row-kernel launches of the hot arm."""
    from paddle_tpu_torch.models import deepfm

    rng = np.random.RandomState(11)
    feeds = [deepfm_feed(rng, DEEPFM_B, DEEPFM_VOCAB, zipf=1.5)
             for _ in range(HOT_STEPS)]
    exe = fluid.Executor(fluid.CUDAPlace(0))
    ms_stream, losses_stream, _ = ps_arm(fluid, deepfm, exe, feeds, 0)
    for k in fsa.KERNELS:                            # hot path starts
        k.launches = 0
    ms_hot, losses_hot, st = ps_arm(fluid, deepfm, exe, feeds, HOT_ROWS,
                                    keep=PS_PULL_AHEAD_0)
    launches = {k.__name__: k.launches for k in fsa.KERNELS}  # ends
    PS_PULL_AHEAD_0.update(losses=losses_hot, feeds=feeds, ms=ms_hot)
    rec = {"hot_rows": HOT_ROWS, "zipf_a": 1.5, "steps": HOT_STEPS,
           "warmup": HOT_WARMUP, "push_depth": 1, "pull_ahead": 0,
           "hit_rate": st["steady_lookup_hit_rate"],
           "cold_hit_rate": st["lookup_hit_rate"],
           "row_hit_rate": st["hit_rate"], "evictions": st["evictions"],
           "writeback_bytes": st["writeback_bytes"],
           "examples_per_s": DEEPFM_B / ms_hot * 1e3,
           "streaming_examples_per_s": DEEPFM_B / ms_stream * 1e3,
           "step_ms": ms_hot, "streaming_step_ms": ms_stream,
           "speedup_vs_streaming": ms_stream / ms_hot,
           "bitwise_equal": losses_stream == losses_hot,
           "losses": losses_hot, "launches": launches}
    log("ps hot cache " + json.dumps(rec))
    if not rec["bitwise_equal"]:
        raise AssertionError(f"ps hot cache: losses differ from the "
                             f"streaming arm: {losses_hot} vs "
                             f"{losses_stream}")
    if not (launches["fused_row_gather"] and launches["fused_row_scatter"]
            and launches["fused_adagrad_update"] == HOT_STEPS):
        raise AssertionError(f"ps hot cache: row kernels launched "
                             f"{launches}")
    return launches


def phase_deepfm_gpu_vs_cpu(fluid):
    """DeepFM at the JAX bench's CPU shape (vocab 10,000, B=64, f32), 3
    steps on CUDAPlace(0) and on CPUPlace() from the same state. The
    table's touched payloads and the dense parameters are held to the CPU's
    within twice what a one-ulp change of the dense input does to the
    CPU's own; untouched rows bit for bit."""
    import torch
    from paddle_tpu_torch.models import deepfm

    vocab, b = 10_000, 64
    main, startup, loss = deepfm_program(fluid, deepfm, vocab, b * 26)
    rng = np.random.RandomState(3)
    feeds = [deepfm_feed(rng, b, vocab) for _ in range(3)]
    nudged = [dict(f, dense=(f["dense"] * (1.0 + 1e-7 * np.random.RandomState(
        5).randn(*f["dense"].shape))).astype("float32")) for f in feeds]
    gpu_scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=gpu_scope)
    names = [v.name for v in main.list_vars() if v.persistable
             and gpu_scope.has_var(v.name)]
    state = {n: gpu_scope.find_np(n) for n in names}
    gpu_losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                                scope=gpu_scope)[0]) for f in feeds]
    runs = []
    for fs in (feeds, nudged):
        cpu_scope = fluid.Scope()
        fluid.io.load_params_from_numpy(state, scope=cpu_scope)
        cpu_exe = fluid.Executor(fluid.CPUPlace())
        runs.append(([float(cpu_exe.run(main, feed=f, fetch_list=[loss],
                                        scope=cpu_scope)[0]) for f in fs],
                     {n: cpu_scope.find_np(n) for n in names}))
    (cpu_losses, cpu), (_, cpu_nudged) = runs
    gpu = {n: gpu_scope.find_np(n) for n in names}
    touched = np.unique(np.concatenate([f["sparse_ids"].ravel()
                                        for f in feeds]))
    untouched = np.setdiff1d(np.arange(vocab), touched)

    def payload(t):
        return t[touched, :68].copy().view(np.float32)

    dense = [n for n in names if n != "fm_t" and gpu[n].dtype == np.float32
             and gpu[n].size > 1]
    card = {n: rel_l2(gpu[n], cpu[n]) for n in dense}
    card["fm_t payload"] = rel_l2(payload(gpu["fm_t"]), payload(cpu["fm_t"]))
    spread = {n: rel_l2(cpu_nudged[n], cpu[n]) for n in dense}
    spread["fm_t payload"] = rel_l2(payload(cpu_nudged["fm_t"]),
                                    payload(cpu["fm_t"]))
    limit = 2 * max(spread.values())
    loss_rel = max(abs(g - c) / abs(c) for g, c in zip(gpu_losses,
                                                       cpu_losses))
    same_untouched = bool((gpu["fm_t"][untouched]
                           == cpu["fm_t"][untouched]).all())
    rec = {"vocab": vocab, "B": b, "steps": 3, "gpu_losses": gpu_losses,
           "cpu_losses": cpu_losses, "loss_rel_max": loss_rel,
           "untouched_rows_bitwise": same_untouched,
           "card_vs_cpu_rel_l2_max": max(card.values()),
           "touched_payload_rel_l2": card["fm_t payload"],
           "cpu_one_ulp_spread_max": max(spread.values()),
           "touched_payload_one_ulp_spread": spread["fm_t payload"],
           "limit": limit,
           "worst": sorted(card.items(), key=lambda kv: -kv[1])[:4]}
    log("deepfm GPU vs CPU " + json.dumps(rec))
    del gpu_scope
    torch.cuda.empty_cache()
    if loss_rel > 1e-5 or not same_untouched or max(card.values()) > limit:
        raise AssertionError("GPU and CPU DeepFM steps disagree")


# ---------------------------------------------------------------------------
# the executor's step surface
# ---------------------------------------------------------------------------

def host_state(scope, main):
    """Every persistable of `main` in `scope`, copied to the host."""
    return {v.name: scope.find_var(v.name).detach().cpu()
            for v in main.list_vars()
            if v.persistable and scope.has_var(v.name)}


def scope_from(fluid, state):
    """A fresh scope holding `state`'s tensors (each step's first run moves
    them to the card); no generator, so each copy draws from the program's
    seed as a fresh run does."""
    scope = fluid.Scope()
    for n, t in state.items():
        scope.set_var(n, t.clone())
    return scope


def state_diff(a, b):
    """(names that differ bitwise, largest max|a-b| / max|b| over them);
    compared as bytes, so a NaN equals itself."""
    import torch

    bad, rel = [], 0.0
    for n in sorted(a):
        if a[n].shape != b[n].shape or not torch.equal(
                a[n].contiguous().view(-1).view(torch.uint8),
                b[n].contiguous().view(-1).view(torch.uint8)):
            bad.append(n)
            x, y = a[n].double(), b[n].double()
            rel = max(rel, float((x - y).abs().max()
                                 / y.abs().max().clamp_min(1e-30)))
    return bad, rel


def timed_steps(run, n):
    """`n` calls of run (each ends in a host read of the loss): (losses,
    host ms each)."""
    losses, ms = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        losses.append(run())
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms


def med_range(ms):
    """The first call's ms apart (it prepares the executor's plan and warms
    the libraries), then the median and range of the rest."""
    return {"first_ms": ms[0], "median_ms": float(np.median(ms[1:])),
            "range_ms": [min(ms[1:]), max(ms[1:])]}


def bert_remat_runs(fluid, main, loss, init, policies, steps=4):
    """`steps` steps of `main` from `init` per remat policy, through
    CompiledProgram.with_data_parallel on the one card: {policy: (losses as
    bytes, host state after, peak MiB, step ms)}."""
    import torch

    out = {}
    exe = fluid.Executor(fluid.CUDAPlace(0))
    for policy in policies:
        bs = fluid.BuildStrategy()
        bs.remat_policy = policy
        prog = fluid.CompiledProgram(main).with_data_parallel(
            loss_name=loss.name, build_strategy=bs)
        scope = scope_from(fluid, init)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        losses, ms = timed_steps(lambda: exe.run(
            prog, feed=STEP_FEED, fetch_list=[loss], scope=scope)[0], steps)
        peak = torch.cuda.max_memory_allocated() / 2**20
        out[policy] = ([x.tobytes() for x in losses], host_state(scope, main),
                       peak, ms, [float(x) for x in losses])
        del scope
    return out


STEP_FEED = None
STEP_T = 512


def phase_step_surface(fluid, fa, fb):
    """The executor's step surface at full width: remat policies on
    BERT-base bf16 (CompiledProgram), the update fusion on ResNet-50 bf16,
    FLAGS_check_nan_inf, return_handle. Prints one JSON line."""
    global STEP_FEED
    import torch
    from paddle_tpu_torch.core import executor as texec
    from paddle_tpu_torch.models import bert, resnet
    from paddle_tpu_torch.observability import get_registry

    rec = {}
    t = STEP_T
    rng = np.random.RandomState(13)
    STEP_FEED = pretrain_feed(B, t, rng)

    # remat: "none" / "minimal" / "full" from one state at dropout 0.1,
    # then "none" / "full" at dropout 0
    main, startup, loss = build_pretrain(fluid, bert, B, t, True)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        init = host_state(fluid.global_scope(), main)
    fa.flash_attention_fwd.launches = 0            # remat path starts
    fa.flash_attention_bwd.launches = 0
    runs = bert_remat_runs(fluid, main, loss, init,
                           ("none", "minimal", "full"))
    flash = (fa.flash_attention_fwd.launches,
             fa.flash_attention_bwd.launches)       # remat path ends
    mf_bad, _ = state_diff(runs["minimal"][1], runs["full"][1])
    nf_bad, nf_rel = state_diff(runs["none"][1], runs["full"][1])
    rec["bert_remat_dropout_0.1"] = {
        p: {"losses": r[4], "peak_memory_MiB": r[2], **med_range(r[3])}
        for p, r in runs.items()}
    rec["bert_remat_dropout_0.1"].update({
        "minimal_vs_full_bitwise": runs["minimal"][0] == runs["full"][0]
        and not mf_bad,
        "none_vs_full_bitwise": runs["none"][0] == runs["full"][0]
        and not nf_bad, "flash_launches_fwd_bwd": flash})
    if not rec["bert_remat_dropout_0.1"]["minimal_vs_full_bitwise"]:
        raise AssertionError(f"remat minimal and full differ at dropout "
                             f"0.1: losses {runs['minimal'][4]} vs "
                             f"{runs['full'][4]}, state {mf_bad[:5]}")
    # 12 layers x 4 steps x 3 policies, each way; the recompute of
    # "minimal" and "full" runs the forward kernel once more a layer
    if flash != (12 * 4 * 3 + 12 * 4 * 2, 12 * 4 * 3):
        raise AssertionError(f"remat: flash launches (fwd, bwd) {flash}")
    if not runs["full"][2] < runs["none"][2]:
        raise AssertionError(f"remat full peak {runs['full'][2]} MiB is not "
                             f"below none's {runs['none'][2]} MiB")
    peaks = {p: r[2] for p, r in runs.items()}
    del runs
    main0, startup0, loss0 = build_pretrain(fluid, bert, B, t, True,
                                            dropout=0.0)
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup0)
        init0 = host_state(fluid.global_scope(), main0)
    runs0 = bert_remat_runs(fluid, main0, loss0, init0, ("none", "full"))
    bad0, rel0 = state_diff(runs0["none"][1], runs0["full"][1])
    lrel0 = max(abs(a - b) / abs(b) for a, b in zip(runs0["full"][4],
                                                     runs0["none"][4]))
    rec["bert_remat_dropout_0"] = {
        "none_vs_full_bitwise": runs0["none"][0] == runs0["full"][0]
        and not bad0, "loss_max_rel": lrel0, "state_max_rel": rel0,
        "state_vars_differing": len(bad0), "tolerance": 1e-5,
        "losses": {p: r[4] for p, r in runs0.items()}}
    if max(lrel0, rel0) > 1e-5:
        raise AssertionError(f"remat none and full differ at dropout 0 past "
                             f"1e-5: {rec['bert_remat_dropout_0']}")
    del runs0, init0

    # FLAGS_check_nan_inf: the probe's cost on the BERT step, then a NaN
    # on a small program and in large tensors on the card
    scope = scope_from(fluid, init)
    step = (lambda: exe.run(main, feed=STEP_FEED, fetch_list=[loss],
                            scope=scope)[0])
    _, off_ms = timed_steps(step, 7)
    fluid.set_flags({"FLAGS_check_nan_inf": True})
    try:
        _, on_ms = timed_steps(step, 7)
        small, small_startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(small, small_startup):
            x = fluid.layers.data("x", [64])
            y = fluid.layers.fc(x, 32)
            sloss = fluid.layers.mean(y)
            fluid.optimizer.SGD(0.1).minimize(sloss)
        with fluid.scope_guard(fluid.Scope()):
            exe.run(small_startup)
            xs = np.ones((4, 64), "float32")
            exe.run(small, feed={"x": xs}, fetch_list=[sloss])
            xs[2, 17] = np.nan
            try:
                exe.run(small, feed={"x": xs}, fetch_list=[sloss])
                raised = None
            except FloatingPointError as e:
                raised = str(e)
        big = torch.ones(1 << 24, device="cuda")
        probes = {}
        for label, bad in (("nan", float("nan")), ("inf", float("inf"))):
            for dt in (torch.float32, torch.bfloat16):
                b = big.to(dt, copy=True)
                b[(1 << 23) + 7] = bad
                try:
                    texec._check_finite([("ok", big), ("bad", b)])
                    probes[f"{label}_{dt}"] = None
                except FloatingPointError as e:
                    probes[f"{label}_{dt}"] = str(e)
        texec._check_finite([("ok", big), ("ok16", big.bfloat16())])
    finally:
        fluid.set_flags({"FLAGS_check_nan_inf": False})
    rec["check_nan_inf"] = {
        "bert_step_off": med_range(off_ms), "bert_step_on": med_range(on_ms),
        "probe_ms": float(np.median(on_ms[1:]) - np.median(off_ms[1:])),
        "small_program_nan_feed": raised, "large_tensor_probes": probes}
    if raised is None or "NaN/Inf detected in variable" not in raised:
        raise AssertionError(f"check_nan_inf: a NaN feed raised {raised!r}")
    if any(v is None or "'bad'" not in v for v in probes.values()):
        raise AssertionError(f"check_nan_inf: large-tensor probes {probes}")
    del scope

    # return_handle: four steps dispatched with handles, .numpy() after
    # each, against four return_numpy steps from the same state
    out = {}
    for handle in (True, False):
        scope = scope_from(fluid, init)
        vals, dispatch = [], []
        for _ in range(4):
            t0 = time.perf_counter()
            got = exe.run(main, feed=STEP_FEED, fetch_list=[loss],
                          scope=scope, return_handle=handle)
            dispatch.append((time.perf_counter() - t0) * 1e3)
            vals.append((got.numpy() if handle else got)[0].tobytes())
        out[handle] = (vals, dispatch)
        del scope
    rec["return_handle"] = {
        "bitwise_equal": out[True][0] == out[False][0],
        "host_ms_per_dispatch_handle": out[True][1],
        "host_ms_per_dispatch_numpy": out[False][1]}
    if out[True][0] != out[False][0]:
        raise AssertionError("return_handle losses differ from return_numpy")
    del init
    torch.cuda.empty_cache()

    # update fusion: ResNet-50 bf16 AMP, Momentum(0.1, 0.9), B=128, three
    # steps per PDTPU_FUSE_UPDATES setting from one state (a new executor
    # each: the setting is read when a plan is prepared)
    os.environ["PDTPU_BN_MODE"] = "pallas"
    rmain, rstartup, rloss = resnet_program(fluid, resnet, RESNET_B,
                                            RESNET_HW, True)
    feed = resnet_feed(RESNET_B, RESNET_HW)
    with fluid.scope_guard(fluid.Scope()):
        fluid.Executor(fluid.CUDAPlace(0)).run(rstartup)
        rinit = host_state(fluid.global_scope(), rmain)
    reg = get_registry()
    counters = ("executor/fused_update_groups", "executor/fused_update_ops")
    fused = {}
    old = os.environ.get("PDTPU_FUSE_UPDATES")
    try:
        for mode in ("0", "1", "auto"):
            os.environ["PDTPU_FUSE_UPDATES"] = mode
            rexe = fluid.Executor(fluid.CUDAPlace(0))
            scope = scope_from(fluid, rinit)
            c0 = [reg.counter(c).value for c in counters]
            rstep = (lambda: rexe.run(rmain, feed=feed, fetch_list=[rloss],
                                      scope=scope)[0])
            losses, ms = timed_steps(rstep, 3)
            state = host_state(scope, rmain)
            prof = profile_record(f"resnet50 bf16 B={RESNET_B} fuse={mode}",
                                  rstep, 2)
            _, warm = timed_steps(rstep, 5)
            fused[mode] = {
                "losses": [float(x) for x in losses], **med_range(ms),
                "warm_after_profile": med_range(warm),
                "device_events_per_step": prof["device_events"],
                "device_busy_ms": prof["device_busy_ms"],
                "device_events_by_category": prof["by_category_events"],
                "device_ms_by_category": prof["by_category_ms"],
                "fused_groups": reg.counter(counters[0]).value - c0[0],
                "fused_ops": reg.counter(counters[1]).value - c0[1],
                "_state": state, "_losses": [x.tobytes() for x in losses]}
            del scope, rexe
    finally:
        if old is None:
            os.environ.pop("PDTPU_FUSE_UPDATES", None)
        else:
            os.environ["PDTPU_FUSE_UPDATES"] = old
    moved = [p.name for p in rmain.all_parameters()]
    for mode in ("1", "auto"):
        bad, _ = state_diff(fused["0"]["_state"], fused[mode]["_state"])
        fused[mode]["bitwise_vs_per_op"] = (
            not bad and fused[mode]["_losses"] == fused["0"]["_losses"])
        if not fused[mode]["bitwise_vs_per_op"]:
            raise AssertionError(f"fused updates ({mode}) differ from the "
                                 f"per-op path: {bad[:5]}")
    n_vel = sum(1 for n in fused["0"]["_state"] if "velocity" in n)
    for r in fused.values():
        del r["_state"], r["_losses"]
    rec["resnet_update_fusion"] = dict(
        fused, parameters=len(moved), velocities=n_vel)
    if fused["1"]["fused_ops"] != len(moved) or n_vel != len(moved):
        raise AssertionError(f"fusion: {fused['1']['fused_ops']} fused ops, "
                             f"{len(moved)} parameters, {n_vel} velocities")
    rec["bert_peak_memory_MiB"] = peaks
    log("step surface " + json.dumps(rec))
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 15. the training surface: schedules, the remaining optimizers,
# conditional_block, auc, LeNet
# ---------------------------------------------------------------------------

SURFACE_STEPS = 3      # per-op GPU-vs-CPU steps
SCHEDULE_STEPS = 12
AUC_B = 4096
LARS_PEAK = 0.4        # LARS peak rate at B=128
SURFACE_OPTS = {
    "lars_momentum": lambda f: f.optimizer.LarsMomentum(0.1, 0.9),
    "adamax": lambda f: f.optimizer.Adamax(0.05),
    "decayed_adagrad": lambda f: f.optimizer.DecayedAdagrad(0.05),
    "adadelta": lambda f: f.optimizer.Adadelta(1.0, rho=0.9),
    "rmsprop": lambda f: f.optimizer.RMSProp(0.01, momentum=0.5),
    "rmsprop_centered": lambda f: f.optimizer.RMSProp(
        0.01, momentum=0.5, centered=True),
    "ftrl": lambda f: f.optimizer.Ftrl(0.1, l1=1e-3, l2=1e-3),
    "ftrl_power": lambda f: f.optimizer.Ftrl(0.1, l1=1e-3, l2=1e-3,
                                             lr_power=-0.3),
    "conditional_block/gradient_merge": lambda f:
        f.optimizer.GradientMergeOptimizer(f.optimizer.SGD(0.1), k_steps=2),
    "conditional_block/lookahead": lambda f: f.optimizer.LookaheadOptimizer(
        f.optimizer.SGD(0.1), alpha=0.5, k=2),
}
# the eight kinds, and warmup over a base decay
SCHEDULES = {
    "noam": lambda L: L.noam_decay(1024, 4, learning_rate=2.0),
    "exponential": lambda L: L.exponential_decay(0.1, 3, 0.5,
                                                 staircase=True),
    "natural_exp": lambda L: L.natural_exp_decay(0.1, 3, 0.5),
    "inverse_time": lambda L: L.inverse_time_decay(0.1, 3, 0.5),
    "polynomial": lambda L: L.polynomial_decay(0.1, 5, 1e-3, power=2.0,
                                               cycle=True),
    "piecewise": lambda L: L.piecewise_decay([3, 7], [0.1, 0.01, 0.001]),
    "cosine": lambda L: L.cosine_decay(0.1, 3, 5),
    "warmup": lambda L: L.linear_lr_warmup(0.05, 4, 0.0, 0.1),
    "warmup_over_polynomial": lambda L: L.linear_lr_warmup(
        L.polynomial_decay(0.1, 8, 1e-4, power=2.0), 3, 0.0, 0.1),
}


def lars_schedule(fluid):
    """The large-batch ResNet-50 LARS recipe's shape, cut to steps that
    take both branches: linear warmup over 2 steps, then polynomial decay
    (power 2) over 8."""
    L = fluid.layers
    return L.linear_lr_warmup(
        L.polynomial_decay(LARS_PEAK, decay_steps=8, end_learning_rate=1e-4,
                           power=2.0),
        warmup_steps=2, start_lr=0.0, end_lr=LARS_PEAK)


def bert_schedule(fluid):
    """BERT's linear warmup, then linear decay (cut to 2 + 10 steps)."""
    L = fluid.layers
    return L.linear_lr_warmup(
        L.polynomial_decay(1e-4, decay_steps=10, end_learning_rate=0.0,
                           power=1.0), 2, 0.0, 1e-4)


def noam_schedule(fluid):
    """Vaswani et al. 2017 §5.3: d_model^-0.5 · min(s^-0.5, s·4000^-1.5)."""
    return fluid.layers.noam_decay(d_model=1024, warmup_steps=4000)


def schedule_on_cpu(fluid, make, steps):
    """The lr sequence of `make(fluid)` over `steps` steps on the CPU."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        lr = make(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        return [float(exe.run(main, fetch_list=[lr])[0][0])
                for _ in range(steps)]


def rel_diff(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def state_close(a, b, rtol, atol, spread):
    """(names out of tolerance, {name: [max |a-b|, |b| at the worst
    element, largest |spread - b|]} of the float tensors past rtol/atol,
    worst |a-b| / (atol + rtol|b|)). Integer state must be equal; a float
    tensor past rtol/atol still passes when its largest |a-b| is within
    twice its largest difference in `spread` (the same run on the CPU from
    a one-ulp change of the input)."""
    import torch

    bad, past, worst = [], {}, 0.0
    for n in sorted(b):
        if not a[n].is_floating_point():
            if not torch.equal(a[n], b[n]):
                bad.append(n)
            continue
        x, y = a[n].double(), b[n].double()
        d = (x - y).abs()
        r = d / (atol + rtol * y.abs())
        worst = max(worst, float(r.max()))
        if float(r.max()) <= 1.0:
            continue
        sp = float((spread[n].double() - y).abs().max())
        past[n] = [float(d.max()), float(y.reshape(-1)[int(r.argmax())].abs()),
                   sp]
        if float(d.max()) > 2 * sp:
            bad.append(n)
    return bad, past, worst


def small_fc(fluid, opt):
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 2024
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [64])
        y = fluid.layers.data("y", [1])
        h = fluid.layers.fc(x, 32, act="tanh")
        pred = fluid.layers.fc(h, 1)
        loss = fluid.layers.reduce_mean(
            fluid.layers.square_error_cost(pred, y))
        opt(fluid).minimize(loss)
    return main, startup, loss


def surface_ops_gpu_vs_cpu(fluid):
    """Each new update op and conditional_block: SURFACE_STEPS steps of a
    small fc program from one state on the card and on the CPU (TF32 off):
    every parameter and accumulator within the CPU tests' tolerances
    (rtol 1e-5, atol 1e-7) or, where cuBLAS's last-bit gradient
    differences pass into an accumulator of sums near zero, within twice
    the CPU's own spread under a one-ulp change of the input."""
    rng = np.random.RandomState(2024)
    feed = {"x": rng.rand(256, 64).astype("float32"),
            "y": rng.rand(256, 1).astype("float32")}
    nudged = dict(feed, x=(feed["x"] * (1.0 + 1e-7 * rng.randn(256, 64)))
                  .astype("float32"))
    out = {}
    for name, opt in SURFACE_OPTS.items():
        main, startup, loss = small_fc(fluid, opt)
        with fluid.scope_guard(fluid.Scope()):
            fluid.Executor(fluid.CPUPlace()).run(startup)
            init = host_state(fluid.global_scope(), main)
        runs = {}
        for label, place, f in (("cpu", fluid.CPUPlace(), feed),
                                ("cpu_nudged", fluid.CPUPlace(), nudged),
                                ("cuda", fluid.CUDAPlace(0), feed)):
            exe = fluid.Executor(place)
            scope = scope_from(fluid, init)
            losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                                    scope=scope)[0])
                      for _ in range(SURFACE_STEPS)]
            runs[label] = (losses, host_state(scope, main))
        bad, past, worst = state_close(runs["cuda"][1], runs["cpu"][1],
                                       1e-5, 1e-7, runs["cpu_nudged"][1])
        out[name] = {"state_vars": len(runs["cpu"][1]), "out_of_tol": bad,
                     "past_rtol_atol": past, "worst_over_tol": worst,
                     "loss_rel": rel_diff(runs["cuda"][0], runs["cpu"][0])}
        if bad or out[name]["loss_rel"] > 1e-5:
            raise AssertionError(f"{name}: card against CPU {out[name]}")
    return out


def surface_schedules(fluid):
    """Every schedule kind for SCHEDULE_STEPS steps on the card against the
    CPU (1e-6 relative), then one warm step profiled: no host-to-device
    copy (the fetches' device-to-host copies show the profiler sees
    copies), the ops' device time and events."""
    import torch

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        lrs = {k: make(fluid.layers) for k, make in SCHEDULES.items()}
    n_ops = len(main.global_block().ops)
    fetch = list(lrs.values())
    seqs, scopes = {}, {}
    for place in (fluid.CPUPlace(), fluid.CUDAPlace(0)):
        exe = fluid.Executor(place)
        scope = scopes[place.kind] = fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            got = [exe.run(main, fetch_list=fetch)
                   for _ in range(SCHEDULE_STEPS)]
        seqs[place.kind] = {k: [float(g[i][0]) for g in got]
                            for i, k in enumerate(lrs)}
    rels = {k: rel_diff(seqs["cuda"][k], seqs["cpu"][k]) for k in lrs}
    if max(rels.values()) > 1e-6:
        raise AssertionError(f"schedules: card against CPU {rels}")

    def warm():   # the card's executor (the loop's last) and scope
        exe.run(main, fetch_list=fetch, scope=scopes["cuda"])
        torch.cuda.synchronize()

    counts = {}
    per, wall_us, events = profile_device(warm, iters=3, counts=counts)
    h2d = {k: v for k, v in counts.items() if "htod" in k.lower()}
    d2h = {k: v for k, v in counts.items() if "dtoh" in k.lower()}
    busy_us = sum(us for k, us in per.items() if "memcpy" not in k.lower())
    rec = {"kinds": list(lrs), "lr_ops": n_ops, "steps": SCHEDULE_STEPS,
           "card_vs_cpu_max_rel": rels, "card_bitwise_cpu": {
               k: seqs["cuda"][k] == seqs["cpu"][k] for k in lrs},
           "warm_step_h2d_copies": h2d, "warm_step_d2h_copies": d2h,
           "warm_step_device_events": events,
           "warm_step_kernel_us": busy_us,
           "kernel_us_per_schedule_op": busy_us / n_ops,
           "warm_step_wall_us": wall_us}
    if h2d or not d2h:
        raise AssertionError(f"schedules: a warm step copies to the card "
                             f"{h2d} (device-to-host seen: {d2h})")
    return rec


def surface_auc(fluid):
    """layers.auc over three B=AUC_B batches on the card and the CPU: stat
    buffers bitwise equal to each other and to metrics.Auc's."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        p = fluid.layers.data("p", [2])
        label = fluid.layers.data("label", [1], dtype="int64")
        auc, _, (pos, neg) = fluid.layers.auc(p, label)
    rng = np.random.RandomState(2024)
    feeds = []
    for _ in range(3):
        lab = rng.randint(0, 2, (AUC_B, 1))
        q = np.clip(lab * 0.3 + rng.rand(AUC_B, 1) * 0.7, 0, 1)
        feeds.append({"p": np.concatenate([1 - q, q], 1).astype("float32"),
                      "label": lab.astype("int64")})
    host = fluid.metrics.Auc()
    runs = {}
    for place in (fluid.CPUPlace(), fluid.CUDAPlace(0)):
        exe = fluid.Executor(place)
        with fluid.scope_guard(fluid.Scope()):
            exe.run(startup)
            runs[place.kind] = [exe.run(main, feed=f,
                                        fetch_list=[auc, pos, neg])
                                for f in feeds]
    bitwise, host_equal, aucs = [], [], []
    for f, c, g in zip(feeds, runs["cpu"], runs["cuda"]):
        host.update(f["p"], f["label"])
        bitwise.append(c[1].tobytes() == g[1].tobytes()
                       and c[2].tobytes() == g[2].tobytes())
        host_equal.append(bool(np.array_equal(g[1], host._stat_pos)
                               and np.array_equal(g[2], host._stat_neg)))
        aucs.append([float(g[0]), float(c[0]), host.eval()])
    rec = {"batches": 3, "batch": AUC_B, "buckets": 4096,
           "stat_bitwise_card_vs_cpu": bitwise,
           "stat_equal_metrics_Auc": host_equal,
           "auc_card_cpu_host": aucs}
    if not all(bitwise) or not all(host_equal):
        raise AssertionError(f"auc: {rec}")
    return rec


def lr_matches(seq, cpu):
    return {"lr": seq, "cpu_lr": cpu, "max_rel": rel_diff(seq, cpu),
            "bitwise": seq == cpu}


def surface_resnet_lars(fluid, fb):
    """ResNet-50 bf16 AMP at B=128 on LarsMomentum(lars_schedule, 0.9), 2 +
    4 steps (the fourth of them profiled): finite losses, the lr sequence
    against the CPU schedule's, rows 7-11 per step."""
    import torch
    from paddle_tpu_torch.models import resnet

    os.environ["PDTPU_BN_MODE"] = "pallas"
    box = {}

    def lars():
        box["lr"] = lars_schedule(fluid)
        return fluid.optimizer.LarsMomentum(box["lr"], 0.9)

    main, startup, loss = resnet_program(fluid, resnet, RESNET_B, RESNET_HW,
                                         True, optimizer=lars)
    feed = resnet_feed(RESNET_B, RESNET_HW)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    losses, lrs, ms = [], [], []

    def step():
        t0 = time.perf_counter()
        lv, lrv = exe.run(main, feed=feed, fetch_list=[loss, box["lr"]])
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(lv))
        lrs.append(float(lrv[0]))

    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        torch.cuda.synchronize()
        reset_bn_counts(fb)                        # main path starts
        step()
        step()
        prof = profile_record(f"resnet50 bf16 LARS B={RESNET_B}", step, 1)
        step()
        step()
        counts = bn_counts(fb)                     # main path ends
    steps = len(losses)
    per_step = {k: v / steps for k, v in counts.items()}
    warm = [ms[2], ms[4], ms[5]]   # ms[3] was profiled
    rec = {"steps": steps, "losses": losses,
           **lr_matches(lrs, schedule_on_cpu(fluid, lars_schedule, steps)),
           "fused_bn_launches_per_step": per_step, "step_ms": ms,
           "warm_median_ms": float(np.median(warm)),
           "warm_range_ms": [min(warm), max(warm)],
           "device_events_per_step": prof["device_events"],
           "device_busy_ms": prof["device_busy_ms"],
           "device_ms_by_category": prof["by_category_ms"],
           "device_events_by_category": prof["by_category_events"],
           "lars_ops": sum(op.type == "lars_momentum"
                           for op in main.global_block().ops),
           "momentum_device_events_phase14": 2049}
    if not np.isfinite(losses).all() or rec["max_rel"] > 1e-6:
        raise AssertionError(f"resnet LARS: {rec}")
    if per_step != {k: float(v) for k, v in RESNET_PER_STEP.items()}:
        raise AssertionError(f"resnet LARS: fused-BN launches per step "
                             f"{per_step}, expected {RESNET_PER_STEP}")
    return rec


def surface_nmt_noam(fluid, fas):
    """Transformer-big bf16 packed-sparse (B=16, T=256) on Adam (Vaswani
    et al.'s betas and epsilon) over noam_schedule, 4 steps: finite
    losses, rows 5-6 per step, the lr sequence against the CPU's."""
    import torch
    from paddle_tpu_torch.models import transformer_nmt as nmt

    box = {}

    def adam():
        box["lr"] = noam_schedule(fluid)
        return fluid.optimizer.Adam(box["lr"], beta1=0.9, beta2=0.98,
                                    epsilon=1e-9)

    main, startup, loss = nmt_program(fluid, nmt, nmt.TransformerConfig(),
                                      NMT_T, True, optimizer=adam)
    batches = [nmt_feed(stack, "cuda")
               for stack, _ in nmt_batches(NMT_B, NMT_T, 2)]
    exe = fluid.Executor(fluid.CUDAPlace(0))
    losses, lrs, ms = [], [], []
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        torch.cuda.synchronize()
        reset_sparse_counts(fas)                   # main path starts
        for i in range(4):
            t0 = time.perf_counter()
            lv, lrv = exe.run(main, feed=batches[i % 2],
                              fetch_list=[loss, box["lr"]])
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(lv))
            lrs.append(float(lrv[0]))
        counts = sparse_counts(fas)                # main path ends
    rec = {"steps": 4, "losses": losses,
           **lr_matches(lrs, schedule_on_cpu(fluid, noam_schedule, 4)),
           "sparse_launches": counts, "step_ms": ms,
           "warm_median_ms": float(np.median(ms[1:]))}
    if not np.isfinite(losses).all() or rec["max_rel"] > 1e-6 or \
            counts != {"fwd": NMT_PER_STEP * 4, "bwd": NMT_PER_STEP * 4,
                       "plain_fwd": 0, "plain_bwd": 0}:
        raise AssertionError(f"nmt noam: {rec}")
    return rec


def surface_bert_gradient_merge(fluid, fa):
    """BERT-base bf16 AMP (B=8, T=512) on GradientMergeOptimizer(Lamb(
    bert_schedule), k_steps=2), 6 steps: on the steps that do not apply
    (1, 3, 5) every parameter and LAMB accumulator is bitwise unchanged;
    on the others (2, 4, 6) every parameter moves; the @GradientMerge
    buffers, the merge counter and both schedule counters change every
    step. Checked on the card, from clones of the state after each step."""
    import torch
    from paddle_tpu_torch.models import bert

    box = {}

    def gm(wrap):
        box["lr"] = bert_schedule(fluid)
        return fluid.optimizer.GradientMergeOptimizer(
            wrap(fluid.optimizer.Lamb(box["lr"])), k_steps=2)

    t = 512
    main, startup, loss = build_pretrain(fluid, bert, B, t, True,
                                         optimizer=gm)
    feed = pretrain_feed(B, t, np.random.RandomState(17))
    names = [v.name for v in main.list_vars() if v.persistable]
    params = [p.name for p in main.all_parameters()]
    lamb = [n for n in names if "_LambOptimizer_" in n]
    merge = [n for n in names if n.endswith("@GradientMerge")]
    counters = [n for n in names if n.startswith(("gradient_merge_step_",
                                                  "@LR_DECAY_COUNTER@"))]
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    losses, lrs, ms, checks = [], [], [], []
    with fluid.scope_guard(scope):
        exe.run(startup)
        torch.cuda.synchronize()

        def snap():
            return {n: scope.find_var(n).detach().clone()
                    for n in params + lamb + merge + counters}

        prev = snap()
        fa.flash_attention_fwd.launches = 0        # main path starts
        fa.flash_attention_bwd.launches = 0
        for i in range(6):
            t0 = time.perf_counter()
            lv, lrv = exe.run(main, feed=feed, fetch_list=[loss, box["lr"]])
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(lv))
            lrs.append(float(lrv[0]))
            cur = snap()
            same = {n for n in cur if torch.equal(cur[n], prev[n])}
            applies = i % 2 == 1
            checks.append({
                "step": i + 1, "applies": applies,
                "params_unchanged": sum(n in same for n in params),
                "lamb_unchanged": sum(n in same for n in lamb),
                "merge_unchanged": sum(n in same for n in merge),
                "counters_unchanged": sum(n in same for n in counters)})
            prev = cur
        flash = (fa.flash_attention_fwd.launches,
                 fa.flash_attention_bwd.launches)  # main path ends
        del prev, cur
    apply_ms = [m for m, c in zip(ms, checks) if c["applies"]]
    skip_ms = [m for m, c in zip(ms, checks) if not c["applies"]]
    rec = {"steps": 6, "losses": losses,
           **lr_matches(lrs, schedule_on_cpu(fluid, bert_schedule, 6)),
           "parameters": len(params), "lamb_accumulators": len(lamb),
           "merge_buffers": len(merge), "counters": counters,
           "per_step": checks, "flash_launches_fwd_bwd": flash,
           "step_ms": ms, "apply_step_ms": apply_ms,
           "skip_step_ms": skip_ms}
    ok = all((c["params_unchanged"] == 0 and c["lamb_unchanged"] == 0)
             if c["applies"] else
             (c["params_unchanged"] == len(params)
              and c["lamb_unchanged"] == len(lamb))
             for c in checks)
    ok = ok and all(c["merge_unchanged"] == 0 and c["counters_unchanged"]
                    == 0 for c in checks)
    if not ok or not np.isfinite(losses).all() or rec["max_rel"] > 1e-6 \
            or flash != (12 * 6, 12 * 6):
        raise AssertionError(f"bert gradient merge: {rec}")
    del scope
    torch.cuda.empty_cache()
    return rec


def mnist_data(n, seed=0):
    """Synthetic 'digits': class k = template k + noise."""
    rng = np.random.RandomState(seed)
    templates = rng.rand(10, 1, 28, 28).astype("float32")
    labels = rng.randint(0, 10, size=n).astype("int64")
    imgs = templates[labels] + 0.1 * rng.randn(n, 1, 28, 28).astype(
        "float32")
    return imgs, labels.reshape(-1, 1)


def surface_lenet(fluid):
    """LeNet-5 on synthetic MNIST-shaped data, 12 epochs of 4 batches of
    64 on the card: the loss halves, accuracy passes 0.9."""
    from paddle_tpu_torch.models import lenet

    main, startup, _, loss, acc = lenet.build_train_program(lr=5e-3)
    main.random_seed = startup.random_seed = 2024
    imgs, labels = mnist_data(256)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    losses, accs = [], []
    t0 = time.perf_counter()
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        for _ in range(12):
            for i in range(0, 256, 64):
                lv, av = exe.run(main, feed={"img": imgs[i:i + 64],
                                             "label": labels[i:i + 64]},
                                 fetch_list=[loss, acc])
                losses.append(float(lv))
                accs.append(float(av))
    rec = {"steps": len(losses), "first_loss": float(np.mean(losses[:4])),
           "last_loss": float(np.mean(losses[-4:])),
           "last_accuracy": float(np.mean(accs[-4:])),
           "wall_s": time.perf_counter() - t0}
    if not rec["last_loss"] < 0.5 * rec["first_loss"] or \
            rec["last_accuracy"] <= 0.9:
        raise AssertionError(f"lenet: {rec}")
    return rec


def phase_training_surface(fluid, fa, fas, fb, smi):
    """Phase 15: the training surface (schedules, the remaining optimizers,
    conditional_block, auc, LeNet) per op against the CPU, then on the
    three full-width recipes. Prints one JSON line."""
    import torch

    t0 = time.perf_counter()
    rec = {"device": smi}
    rec["ops_gpu_vs_cpu"] = surface_ops_gpu_vs_cpu(fluid)
    rec["schedules"] = surface_schedules(fluid)
    rec["auc"] = surface_auc(fluid)
    rec["lenet"] = surface_lenet(fluid)
    rec["resnet50_bf16_lars"] = surface_resnet_lars(fluid, fb)
    torch.cuda.empty_cache()
    rec["nmt_big_bf16_noam"] = surface_nmt_noam(fluid, fas)
    torch.cuda.empty_cache()
    rec["bert_base_bf16_gradient_merge_lamb"] = surface_bert_gradient_merge(
        fluid, fa)
    rec["wall_s"] = time.perf_counter() - t0
    log("training surface " + json.dumps(rec))


# ---------------------------------------------------------------------------
# 16. the input pipeline and checkpoints
# ---------------------------------------------------------------------------

P16_STEPS = 8          # BERT-base bf16 AMP steps a run (B=8, T=512)
P16_SAVE_AT = 4        # the plain run saves after this step
P16_SERVE_T = 128
REF_MNIST = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                         "data", "ref_mnist_model")


def rel_t(a, b):
    """Relative L2 difference of two host tensors, in f64."""
    x, y = a.double(), b.double()
    return float((x - y).norm() / y.norm().clamp_min(1e-30))


class P16Rule:
    """The rule the drivers are held to: bitwise equality when two plain
    runs from one state are bitwise equal, else the measured spread of
    those two runs (the largest relative L2 difference over every
    persistable and the losses), times 4."""

    def __init__(self, losses1, state1, losses2, state2):
        bad, _ = state_diff(state1, state2)
        self.bitwise = not bad and losses1 == losses2
        self.differ = bad
        spread = [rel_t(state2[n], state1[n]) for n in bad]
        spread += [abs(a - b) / abs(b) for a, b in zip(losses2, losses1)
                   if a != b]
        self.spread = max(spread, default=0.0)
        self.tol = 4 * self.spread

    def check(self, what, losses, state, ref_losses, ref_state):
        if self.bitwise:
            bad, rel = state_diff(state, ref_state)
            ok = not bad and losses == ref_losses
            worst = rel
        else:
            worst = max([rel_t(state[n], ref_state[n]) for n in ref_state]
                        + [abs(a - b) / abs(b)
                           for a, b in zip(losses, ref_losses)])
            ok = worst <= self.tol
        log(f"input pipeline: {what} against the plain run: "
            f"{'bitwise' if self.bitwise else 'spread'} rule, worst "
            f"relative difference {worst:.3e} (tol {self.tol:.3e}) -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"input pipeline: {what} differs from the "
                                 f"plain run ({worst:.3e} > {self.tol:.3e})")
        return worst


def flash_reset(fa):
    for k in (fa.flash_attention_fwd, fa.flash_attention_bwd):
        k.launches = 0
        k.plain_on_cuda = 0


def flash_check(fa, what, steps):
    """Each of `steps` training steps launched the flash forward and
    backward kernels once a layer, and no call took the plain route."""
    got = (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches)
    plain = (fa.flash_attention_fwd.plain_on_cuda,
             fa.flash_attention_bwd.plain_on_cuda)
    if got != (12 * steps, 12 * steps) or plain != (0, 0):
        raise AssertionError(f"input pipeline: {what} launched flash "
                             f"(fwd, bwd) {got}, plain {plain}; expected "
                             f"{12 * steps} each and no plain call")
    return {"fwd": got[0], "bwd": got[1]}


def p16_plain(fluid, exe, main, loss, init, feeds, ck=None, keep_at=None):
    """8 plain Executor.run steps on numpy feeds from `init`: (losses,
    final host state, host ms a step, extra). With `ck`, save after step
    P16_SAVE_AT with the loader cursor a DeviceLoader over the same feeds
    would report, timing how long save() holds the loop."""
    import torch

    scope = scope_from(fluid, init)
    losses, ms, extra = [], [], {}
    for i, feed in enumerate(feeds):
        t0 = time.perf_counter()
        (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        losses.append(float(lv))
        ms.append((time.perf_counter() - t0) * 1e3)
        if i + 1 == P16_SAVE_AT:
            if ck is not None:
                cursor = {"version": 1, "epoch": 0, "cursor": i + 1}
                t0 = time.perf_counter()
                ck.save(i + 1, program=main, scope=scope,
                        extra={f"@dataio@{k}": v for k, v in cursor.items()})
                extra["save_block_ms"] = (time.perf_counter() - t0) * 1e3
            if keep_at is not None:
                keep_at.update(host_state(scope, main))
    torch.cuda.synchronize()
    if ck is not None:
        t0 = time.perf_counter()
        ck.wait()
        extra["wait_after_loop_ms"] = (time.perf_counter() - t0) * 1e3
    extra["scope"] = scope
    return losses, host_state(scope, main), ms, extra


class P16Dataset:
    """An InMemoryDataset-shaped source (batches() / set_thread()) over
    batches already in memory."""

    def __init__(self, data):
        self.data = data

    def set_thread(self, n):
        pass

    def batches(self):
        yield from self.data


def p16_bert(fluid, fa, rec):
    """Steps 1-2 of phase 16: BERT-base bf16 AMP training, plain twice,
    through a DeviceLoader, train_scanned, train_from_dataset, and resumed
    from the plain run's step-4 checkpoint."""
    import torch
    from paddle_tpu_torch import native
    from paddle_tpu_torch.dataio import DeviceLoader
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.observability import get_registry
    from paddle_tpu_torch.parallel import Checkpointer

    if not native.available():
        raise AssertionError(f"input pipeline: the native library did not "
                             f"build: {native.build_error()}")
    rng = np.random.RandomState(16)
    feeds = [pretrain_feed(B, STEP_T, rng) for _ in range(P16_STEPS)]
    main, startup, loss = build_pretrain(fluid, bert, B, STEP_T, True)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    sc0 = fluid.Scope()
    exe.run(startup, scope=sc0)
    init = host_state(sc0, main)
    del sc0
    cuda = fluid.CUDAPlace(0)

    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(os.path.join(d, "ck"))
        flash_reset(fa)                               # plain runs start
        l1, s1, ms1, ex1 = p16_plain(fluid, exe, main, loss, init, feeds,
                                     ck=ck)
        at4 = {}
        l2, s2, ms2, _ = p16_plain(fluid, exe, main, loss, init, feeds,
                                   keep_at=at4)
        rec["launches_plain"] = flash_check(fa, "two plain runs",
                                            2 * P16_STEPS)  # ends
        rule = P16Rule(l1, s1, l2, s2)
        rec["plain_twice_bitwise"] = rule.bitwise
        rec["plain_twice_spread"] = rule.spread
        rec["plain_twice_differ"] = rule.differ
        log(f"input pipeline: two plain runs bitwise equal: {rule.bitwise}"
            + ("" if rule.bitwise else
               f"; spread {rule.spread:.3e}; tensors that differ "
               f"{rule.differ}"))
        if not all(np.isfinite(l1)):
            raise AssertionError(f"input pipeline: plain losses {l1}")

        # 1. the DeviceLoader-fed loop, train_scanned, train_from_dataset
        flash_reset(fa)                               # loader run starts
        scope = scope_from(fluid, init)
        loader = DeviceLoader(lambda: iter(feeds), capacity=2, program=main,
                              place=cuda, name="p16")
        ll, msl = [], []
        it = iter(loader)
        while True:
            t0 = time.perf_counter()
            try:
                feed = next(it)
            except StopIteration:
                break
            (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
            ll.append(float(lv))
            msl.append((time.perf_counter() - t0) * 1e3)
        rec["launches_loader"] = flash_check(fa, "the loader-fed run",
                                             P16_STEPS)  # ends
        rule.check("DeviceLoader-fed run", ll, host_state(scope, main),
                   l1, s1)

        flash_reset(fa)                               # train_scanned starts
        scope = scope_from(fluid, init)
        (lsc,) = exe.train_scanned(main, reader=lambda: iter(feeds),
                                   scan_steps=4, fetch_list=[loss],
                                   scope=scope)
        rec["launches_train_scanned"] = flash_check(fa, "train_scanned",
                                                    P16_STEPS)  # ends
        rule.check("train_scanned(scan_steps=4)",
                   [float(v) for v in np.asarray(lsc).ravel()],
                   host_state(scope, main), l1, s1)

        flash_reset(fa)                          # train_from_dataset starts
        scope = scope_from(fluid, init)
        (lfd,) = exe.train_from_dataset(main, P16Dataset(feeds),
                                        scope=scope, fetch_list=[loss])
        rec["launches_train_from_dataset"] = flash_check(
            fa, "train_from_dataset", P16_STEPS)      # ends
        rule.check("train_from_dataset (last loss and state)",
                   [float(np.asarray(lfd).ravel()[0])],
                   host_state(scope, main), l1[-1:], s1)
        snap = get_registry().snapshot()
        rec["h2d_ms"] = {k: snap["dataio/h2d_ms"][k]
                         for k in ("count", "p50", "p95", "max")}
        rec["prefetch_queue_depth"] = snap["dataio/prefetch_queue_depth"]

        # 2. the checkpoint: what it holds, then a resume in a fresh scope
        path = ck._existing_path(P16_SAVE_AT)
        rec["bundle"] = os.path.basename(path)
        rec["bundle_bytes"] = os.path.getsize(path)
        rec["save_block_ms"] = ex1["save_block_ms"]
        rec["write_ms"] = ck.last_write_ms
        rec["wait_after_loop_ms"] = ex1["wait_after_loop_ms"]
        bundle = native.read_bundle(path)
        held = {n: (v if isinstance(v, torch.Tensor) else
                    torch.from_numpy(np.array(v))) for n, v in bundle.items()
                if n in at4}
        if sorted(held) != sorted(at4):
            raise AssertionError("input pipeline: the bundle does not hold "
                                 "every persistable")
        rule.check("checkpoint bundle (state after step 4)", [], held, [],
                   at4)
        later = sum(1 for n in held if torch.equal(held[n], s1[n]))
        rec["bundle_tensors_equal_to_step_8"] = later
        rec["bundle_tensors"] = len(held)
        log(f"input pipeline: the bundle equals the state after step 4; "
            f"{later} of {len(held)} of its tensors also equal step 8's "
            f"(the ones the steps do not change)")
        if later > len(held) // 2:
            raise AssertionError("input pipeline: the bundle holds a later "
                                 "step's values")

        flash_reset(fa)                               # resume starts
        exe2 = fluid.Executor(cuda)
        scope = fluid.Scope()
        t0 = time.perf_counter()
        ck2 = Checkpointer(os.path.join(d, "ck"))
        got = ck2.restore(program=main, scope=scope, place=cuda)
        torch.cuda.synchronize()
        rec["restore_ms"] = (time.perf_counter() - t0) * 1e3
        if got != P16_SAVE_AT:
            raise AssertionError(f"input pipeline: restored step {got}")
        cursor = {k[len("@dataio@"):]: int(np.asarray(v).reshape(-1)[0])
                  for k, v in ck2.last_extra.items()}
        loader = DeviceLoader(lambda: iter(feeds), capacity=2, program=main,
                              place=cuda, name="p16_resume")
        loader.restore_state(cursor)
        lr = [float(exe2.run(main, feed=f, fetch_list=[loss],
                             scope=scope)[0]) for f in loader]
        rec["launches_resume"] = flash_check(
            fa, "the resumed run", P16_STEPS - P16_SAVE_AT)  # ends
        rule.check("resumed run (steps 5-8, restored CUDA generator)", lr,
                   host_state(scope, main), l1[P16_SAVE_AT:], s1)
        rec["restored_generator"] = str(
            scope.find_var("@RNG_STATE@").device)

    # timings: median host ms a step (steps 2-8) and the busy share of a
    # profiled warm step, numpy feeds against DeviceLoader-fed
    scope = ex1["scope"]
    rec["plain_median_step_ms"] = float(np.median(ms2[1:]))
    rec["loader_median_step_ms"] = float(np.median(msl[1:]))
    prof_plain = profile_record(
        "plain step", lambda: exe.run(main, feed=feeds[0], fetch_list=[loss],
                                      scope=scope), 2)
    prof_loader = DeviceLoader(lambda: iter(feeds), capacity=2,
                               program=main, place=cuda, name="p16_profile")
    prof_it = iter(prof_loader)
    try:
        prof_loader_rec = profile_record(
            "loader-fed step", lambda: exe.run(main, feed=next(prof_it),
                                               fetch_list=[loss],
                                               scope=scope), 2)
    finally:
        prof_loader.close()
    prof_loader = prof_loader_rec
    rec["plain_busy_ms"] = prof_plain["device_busy_ms"]
    rec["loader_busy_ms"] = prof_loader["device_busy_ms"]
    rec["plain_busy_share"] = ratio(prof_plain["device_busy_ms"],
                                    rec["plain_median_step_ms"])
    rec["loader_busy_share"] = ratio(prof_loader["device_busy_ms"],
                                     rec["loader_median_step_ms"])
    rec["loader_h2d_copy_kernels"] = prof_loader["copy_kernels_per_call"]
    rec["plain_h2d_copy_kernels"] = prof_plain["copy_kernels_per_call"]
    rec["plain_losses"] = l1


def p16_serve(fluid, fa, rec):
    """Step 3 of phase 16: BERT-base served from the reference format
    against the same weights from the native format, and the checked-in
    reference MNIST model, on the card."""
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.models import bert

    main, startup, feed_names, out = build_bert(fluid, bert, -1)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    feed = bert_feed(B, P16_SERVE_T, np.random.RandomState(161))
    with fluid.scope_guard(fluid.Scope()), \
            tempfile.TemporaryDirectory() as d:
        exe.run(startup)
        nat, ref = os.path.join(d, "native"), os.path.join(d, "reference")
        fluid.io.save_inference_model(nat, feed_names, [out], exe,
                                      main_program=main)
        fluid.io.save_inference_model(ref, feed_names, [out], exe,
                                      main_program=main, format="reference")
        fa.flash_attention_fwd.launches = 0           # serving starts
        fa.flash_attention_fwd.plain_on_cuda = 0
        (a,) = inference.create_predictor(inference.Config(nat)).run(feed)
        (b,) = inference.create_predictor(inference.Config(ref)).run(feed)
        launches = fa.flash_attention_fwd.launches    # ends
    if launches != 24 or fa.flash_attention_fwd.plain_on_cuda:
        raise AssertionError(f"input pipeline: serving launched the flash "
                             f"forward {launches} times (expected 12 a "
                             f"predictor)")
    same = bool(np.array_equal(a, b))
    rec["serve_reference_vs_native_bitwise"] = same
    rec["serve_shape"] = list(b.shape)
    rec["launches_serve"] = launches
    if not same or not np.isfinite(b).all():
        raise AssertionError(f"input pipeline: reference-format serving "
                             f"differs from native (max abs "
                             f"{float(np.abs(a - b).max())})")
    exp = np.load(os.path.join(REF_MNIST, "expected.npz"))
    (prob,) = inference.create_predictor(
        inference.Config(REF_MNIST)).run({"img": exp["x"]})
    err = float(np.abs(prob - exp["prob"]).max())
    rec["ref_mnist_max_abs_err"] = err
    if err > 1e-5:
        raise AssertionError(f"input pipeline: ref_mnist_model prob off by "
                             f"{err:.3e} (tol 1e-5)")


def p16_ps(fluid, fsa, rec):
    """Step 4 of phase 16: phase 12's hot arm with pull_ahead=1 against
    its pull_ahead=0 run: losses and the final table bitwise equal."""
    from paddle_tpu_torch.models import deepfm

    base = PS_PULL_AHEAD_0
    exe = fluid.Executor(fluid.CUDAPlace(0))
    keep = {}
    for k in fsa.KERNELS:                             # prefetched arm starts
        k.launches = 0
    ms, losses, st = ps_arm(fluid, deepfm, exe, base["feeds"], HOT_ROWS,
                            pull_ahead=1, keep=keep)
    launches = {k.__name__: k.launches for k in fsa.KERNELS}  # ends
    same_losses = losses == base["losses"]
    same_table = bool(np.array_equal(keep["table"], base["table"]))
    rec["ps_pull_ahead_1"] = {
        "losses_bitwise": same_losses, "table_bitwise": same_table,
        "step_ms": ms, "pull_ahead_0_step_ms": base["ms"],
        "hit_rate": st["steady_lookup_hit_rate"], "launches": launches}
    if not (same_losses and same_table):
        raise AssertionError("input pipeline: the PS hot cache with "
                             "pull_ahead=1 differs from pull_ahead=0")
    if not (launches["fused_row_gather"] and launches["fused_row_scatter"]
            and launches["fused_adagrad_update"] == HOT_STEPS):
        raise AssertionError(f"input pipeline: row kernels launched "
                             f"{launches}")
    base.clear()


def phase_input_pipeline(fluid, fa, fsa, smi):
    """Phase 16: the input pipeline and checkpoints on CUDAPlace(0) at
    full width. Prints one JSON line."""
    import torch

    t0 = time.perf_counter()
    rec = {"device": smi}
    p16_bert(fluid, fa, rec)
    torch.cuda.empty_cache()
    p16_serve(fluid, fa, rec)
    p16_ps(fluid, fsa, rec)
    rec["wall_s"] = time.perf_counter() - t0
    log("input pipeline " + json.dumps(rec))


# ---------------------------------------------------------------------------
# phase 17: the deferred-row log and the A6 paths
# ---------------------------------------------------------------------------

P17_STEPS = 34            # folds fire after steps 16 and 32
P17_SEGMENTS = 16
P17_WINDOW = 13           # train_scanned(4) against plain runs, no fold
P17_SMALL = {"vocab": 10_000, "B": 64, "segments": 4, "steps": 9}
P17_SERVE_RTOL = 1e-4     # conv_bn_fuse against the unfused program
P17_PAD_RTOL = 1e-5       # f32 is_test loss, tokens padded to 64 and 128
P17_BUCKETS = ([64, 128, 256], [64, 32, 16])
P17_SEQ_TOL = 1e-5        # sequence and beam ops, card against CPU


# where the counted host reads came from: "file:line" -> count
P17_READ_SITES = {}


def count_host_reads(fn):
    """(fn's result, the synchronizing CUDA calls it made): each host read
    of device data (``int(t)``, ``.item()``, a D2H copy into pageable
    memory, a ``nonzero``) syncs, and torch.cuda's sync debug mode warns
    once a call, from the Python line that made it (kept in
    P17_READ_SITES). The mode's own one-time notice ("Synchronization
    debug mode is a prototype feature ...") is not a read."""
    import warnings

    import torch

    torch.cuda.set_sync_debug_mode("warn")  # its notice: before the count
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    reads = [w for w in caught if "synchroniz" in str(w.message)
             and "prototype" not in str(w.message)]
    for w in reads:
        site = f"{os.path.relpath(w.filename)}:{w.lineno}"
        P17_READ_SITES[site] = P17_READ_SITES.get(site, 0) + 1
    return out, len(reads)


def deferred_program(fluid, deepfm, vocab, rows, opt="adagrad",
                     segments=P17_SEGMENTS, deferred=True):
    """The JAX bench's DeepFM recipe on an f32 fused table: the table on
    `opt` through the deferred-row log (its state columns in the table's
    rows), or, with deferred=False, on the plain sparse path (an
    accumulator beside a [V, 17] table); the dense net on Adam."""
    from paddle_tpu_torch.core import unique_name

    with unique_name.guard():
        main, startup, _, loss, _ = deepfm.build_train_program(
            vocab_size=vocab, is_sparse=True, fused_table=True,
            embedding_optimizer=opt,
            deferred_rows=({"rows_per_step": rows, "segments": segments}
                           if deferred else None))
    main.random_seed = startup.random_seed = 2024
    return main, startup, loss


def device_equal(a, b, names):
    """The names whose tensors differ bitwise between scopes a and b,
    compared on the card."""
    import torch

    bad = []
    for n in names:
        x, y = a.find_var(n), b.find_var(n)
        if x.shape != y.shape or not torch.equal(
                x.contiguous().view(-1).view(torch.uint8),
                y.contiguous().view(-1).view(torch.uint8)):
            bad.append(n)
    return bad


def p17_deferred_steps(fluid, exe, main, loss, init, feeds, around_fold=None,
                       after_step=None):
    """Plain runs of `main` from a copy of `init`, each one step: (losses,
    host ms a step with a sync after it, host reads a step beyond the
    fetch, scope). `around_fold(fold, eprog, scope)` stands in for each
    fold; `after_step(i, scope)` runs after step i's timing and count."""
    import torch

    scope = scope_from(fluid, init)
    orig = exe._run_epilogue
    if around_fold is not None:
        exe._run_epilogue = lambda eprog, sc, *rest: around_fold(
            lambda e, s: orig(e, s, *rest), eprog, sc)
    out, ms, reads = [], [], []
    try:
        for i, f in enumerate(feeds):
            t0 = time.perf_counter()
            (lv,), n = count_host_reads(lambda: exe.run(
                main, feed=f, fetch_list=[loss], scope=scope,
                return_numpy=False))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            reads.append(n)
            out.append(lv)
            if after_step is not None:
                after_step(i, scope)
    finally:
        exe._run_epilogue = orig
    return [float(v) for v in out], ms, reads, scope


def p17_fold_device_ms(fold, eprog, scope):
    """Device ms of one fold of the live log at its real size. The state
    the fold changes (the logged rows of the table, log_ids, the count) is
    saved; each timed call restores it and folds, the restore alone is
    timed too and taken off. Leaves the state as it found it (the fold
    reads neither postab nor anything else it writes)."""
    import torch

    names = ("fm_t", "fm_t@log_ids", "fm_t@log_count")
    table, ids, count = (scope.find_var(n) for n in names)
    saved_ids, saved_count = ids.clone(), count.clone()
    live = saved_ids[(saved_ids >= 0) & (saved_ids < table.shape[0])].long()
    rows = torch.unique(live)
    saved_rows = table[rows]

    def restore():  # the fold may hand back new tensors: look them up
        scope.find_var(names[0]).index_copy_(0, rows, saved_rows)
        scope.find_var(names[1]).copy_(saved_ids)
        scope.find_var(names[2]).copy_(saved_count)

    def restore_and_fold():
        restore()
        fold(eprog, scope)

    both, alone = device_ms(restore_and_fold), device_ms(restore)
    restore()
    return {"fold_device_ms": both - alone, "restore_device_ms": alone,
            "log_entries": int(live.numel()), "rows": int(rows.numel())}


def p17_touched_rows(feeds, segments):
    """(every id the feeds look up, the ids looked up again within a fold
    segment after an earlier step of it logged them: where lookup_join
    answers from the log), each sorted, on the card."""
    import torch

    per = [torch.unique(f["sparse_ids"]) for f in feeds]
    again = []
    for s in range(0, len(per), segments):
        ids, n = torch.unique(torch.cat(per[s:s + segments]),
                              return_counts=True)
        again.append(ids[n > 1])
    return torch.unique(torch.cat(per)), torch.unique(torch.cat(again))


def delta_rel(a, b, base):
    """(a - base) against (b - base), in f64: {"l2": the rel L2, "median":
    the median over elements of |difference| / |b - base|}. A one-ulp
    change moves a few elements a lot (Adagrad's first step is about
    lr·sign(g), and a near-zero g can flip), which the L2 sees and the
    median does not."""
    import torch

    da, db = a.double() - base, b.double() - base
    d = (da - db).abs()
    each = torch.where(db != 0, d / db.abs(), torch.where(
        d == 0, torch.zeros_like(d), torch.full_like(d, float("inf"))))
    return {"l2": float(d.norm() / db.norm()),
            "median": float(each.reshape(-1).median())}


def p17_deepfm(fluid, rec):
    """Full-width deferred DeepFM (the JAX bench's config with the deferred
    log): two runs of P17_STEPS steps from one state, bitwise; the plain
    sparse path from the same values, its losses and, after the second
    fold, the rows the steps touched (table and Adagrad moment) against the
    deferred run's; train_scanned(4) against plain runs over a window with
    no fold; train_scanned(17) refused."""
    import torch
    from paddle_tpu_torch.models import deepfm

    vocab, b = DEEPFM_VOCAB, DEEPFM_B
    main, startup, loss = deferred_program(fluid, deepfm, vocab, DEEPFM_ROWS)
    rng = np.random.RandomState(17)
    np_feeds = [deepfm_feed(rng, b, vocab) for _ in range(P17_STEPS)]
    feeds = [{k: torch.tensor(v, device="cuda") for k, v in f.items()}
             for f in np_feeds]
    exe = fluid.Executor(fluid.CUDAPlace(0))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sc0 = fluid.Scope()
    exe.run(startup, scope=sc0)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    persist = [v.name for v in main.list_vars() if v.persistable
               and sc0.has_var(v.name)]
    init = {n: sc0.find_var(n) for n in persist}
    del sc0
    # the state compared after the second fold (step 2 * P17_SEGMENTS)
    at = 2 * P17_SEGMENTS - 1
    touched, again = p17_touched_rows(feeds[:at + 1], P17_SEGMENTS)
    sel = torch.searchsorted(touched, again)
    snaps = {}

    def snap_deferred(i, scope):
        if i == at:
            snaps["count"] = int(scope.find_var("fm_t@log_count")[0])
            snaps["deferred"] = scope.find_var("fm_t")[touched]

    folds = []

    def timed(fold, eprog, scope):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fold(eprog, scope)
        b.record()
        folds.append((a, b))

    la, ms_a, reads, sa = p17_deferred_steps(fluid, exe, main, loss, init,
                                             feeds, timed, snap_deferred)
    torch.cuda.synchronize()
    fold_event_ms = [a.elapsed_time(b) for a, b in folds]
    read_sites = dict(P17_READ_SITES)
    # the second run times its first fold (16 segments of the live log)
    fold_timing = {}

    def profiled(fold, eprog, scope):
        if not fold_timing:
            fold_timing.update(p17_fold_device_ms(fold, eprog, scope))
        fold(eprog, scope)

    lb, _, _, sb = p17_deferred_steps(fluid, exe, main, loss, init, feeds,
                                      profiled)
    differ = device_equal(sa, sb, persist)
    count_after = int(sa.find_var("fm_t@log_count")[0])
    del sb
    peak_deferred = torch.cuda.max_memory_allocated() / 2**20
    table = sa.find_var("fm_t")
    sizes = {n: f"{tuple(sa.find_var(n).shape)} {sa.find_var(n).dtype}, "
                f"{sa.find_var(n).numel() * sa.find_var(n).element_size() / 1e9:.3f} GB"
             for n in ("fm_t", "fm_t@pending_pos", "fm_t@log_raw",
                       "fm_t@log_cum", "fm_t@log_ids")}
    del sa, table

    # the plain sparse path from the same values (table columns [:17],
    # accumulator 0, the dense net's state)
    smain, sstartup, sloss = deferred_program(fluid, deepfm, vocab,
                                              DEEPFM_ROWS, deferred=False)
    ss = fluid.Scope()
    exe.run(sstartup, scope=ss)
    for v in smain.list_vars():
        if not (v.persistable and ss.has_var(v.name)):
            continue
        if v.name == "fm_t":
            ss.set_var("fm_t", init["fm_t"][:, :DEEPFM_VIS].clone())
        elif v.name in init and init[v.name].shape == ss.find_var(
                v.name).shape:
            ss.set_var(v.name, init[v.name].clone())
    sparse_init = {n: ss.find_var(n).clone() for n in ss.var_names()
                   if isinstance(ss.find_var(n), torch.Tensor)}
    del ss
    # the sparse path twice: on the feeds, and on the feeds with the dense
    # input multiplied by (1 + 1e-7·randn), about one ulp. Adam and Adagrad
    # divide near-zero gradients by their own size, so last-bit
    # differences grow step by step: the deferred path (whose reads
    # re-round base + cum) is held to the sparse one within twice what
    # that one-ulp change does to the sparse path's own losses and rows
    nrng = np.random.RandomState(18)
    nudged = [dict(f, dense=f["dense"] * (1.0 + 1e-7 * torch.tensor(
        nrng.randn(*f["dense"].shape), dtype=torch.float32, device="cuda")))
        for f in feeds]
    (moment,) = [v.name for v in smain.list_vars()
                 if v.name.startswith("fm_t_") and v.name.endswith("moment")]
    runs = []
    for fs in (feeds, nudged):
        ss = scope_from(fluid, sparse_init)
        ls, ms_s = [], []
        for i, f in enumerate(fs):
            t1 = time.perf_counter()
            ls.append(float(exe.run(smain, feed=f, fetch_list=[sloss],
                                    scope=ss)[0]))
            ms_s.append((time.perf_counter() - t1) * 1e3)
            if i == at:
                rows = (ss.find_var("fm_t")[touched],
                        ss.find_var(moment)[touched])
        runs.append((ls, ms_s, rows))
        del ss
    del sparse_init
    (ls, ms_s, (st, sm)), (ln, _, (nt, nm)) = runs
    rel = [abs(x - y) / abs(y) for x, y in zip(la, ls)]
    spread = [abs(x - y) / abs(y) for x, y in zip(ln, ls)]
    # the touched rows after the fold, and those read again within a
    # segment, as changes from init: the deferred table's [:17] and its
    # moment columns against the sparse path's table and moment
    base = init["fm_t"][touched].double()
    bt, bm = base[:, :DEEPFM_VIS], base[:, DEEPFM_VIS:]
    dt, dm = (snaps["deferred"][:, :DEEPFM_VIS],
              snaps["deferred"][:, DEEPFM_VIS:])
    rows_rel, rows_spread = {}, {}
    for part, k in (("touched", slice(None)), ("read_again", sel)):
        rows_rel[part] = {"table": delta_rel(dt[k], st[k], bt[k]),
                          "moment": delta_rel(dm[k], sm[k], bm[k])}
        rows_spread[part] = {"table": delta_rel(nt[k], st[k], bt[k]),
                             "moment": delta_rel(nm[k], sm[k], bm[k])}
    rows_bad = [f"{part}.{n}.{m}" for part, d in rows_rel.items()
                for n in d for m in d[n]
                if not d[n][m] <= 2 * rows_spread[part][n][m]]
    snaps_count = snaps["count"]
    del snaps, runs, rows, base, bt, bm, dt, dm, st, sm, nt, nm

    # train_scanned(4) against plain runs over P17_WINDOW steps (no fold)
    window = np_feeds[:P17_WINDOW]
    plain = scope_from(fluid, init)
    lp = [float(exe.run(main, feed=f, fetch_list=[loss], scope=plain)[0])
          for f in window]
    scan = scope_from(fluid, init)
    lq = [float(exe.run(main, feed=window[0], fetch_list=[loss],
                        scope=scan)[0])]
    (ys,) = exe.train_scanned(main, reader=lambda: iter(window[1:]),
                              scan_steps=4, fetch_list=[loss], scope=scan)
    lq += [float(v) for v in np.ravel(ys)]
    scan_differ = device_equal(plain, scan, persist)
    del plain
    try:
        exe.train_scanned(main, reader=lambda: iter(np_feeds[:17]),
                          scan_steps=17, fetch_list=[loss], scope=scan)
        refused = None
    except ValueError as e:
        refused = str(e)
    del scan, init
    torch.cuda.empty_cache()
    r = {"config": f"vocab {vocab}, 26 fields, embed_dim 16, fused_table, "
                   f"adagrad, B={b}, deferred_rows rows_per_step "
                   f"{DEEPFM_ROWS} segments {P17_SEGMENTS}",
         "state": sizes, "startup_s": startup_s, "steps": P17_STEPS,
         "deferred_losses_first_last": [la[0], la[-1]],
         "sparse_losses_first_last": [ls[0], ls[-1]],
         "loss_rel_max_vs_sparse": max(rel),
         "sparse_one_ulp_spread_max": max(spread),
         "loss_rel_by_step": rel, "spread_by_step": spread,
         "rows_compared": {"step": at + 1, "touched": int(touched.numel()),
                           "read_again": int(again.numel()),
                           "log_count": snaps_count},
         "rows_vs_sparse": rows_rel,
         "sparse_one_ulp_rows_spread": rows_spread,
         "two_runs_bitwise": la == lb and not differ,
         "state_differs": differ, "log_count_after": count_after,
         "deferred_median_ms": float(np.median(ms_a[1:])),
         "deferred_range_ms": [min(ms_a[1:]), max(ms_a[1:])],
         "deferred_first_ms": ms_a[0],
         "fold_steps_ms": [ms_a[15], ms_a[31]],
         "sparse_median_ms": float(np.median(ms_s[1:])),
         "sparse_range_ms": [min(ms_s[1:]), max(ms_s[1:])],
         "fold_event_ms": fold_event_ms, "fold_timing": fold_timing,
         "host_reads_by_step": reads,
         "host_read_sites": read_sites,
         "peak_memory_MiB": peak_deferred,
         "scan4_vs_plain_bitwise": lp == lq and not scan_differ,
         "scan_state_differs": scan_differ,
         "scan17_refused": refused}
    rec["deferred_deepfm"] = r
    log("deferred deepfm " + json.dumps(r))
    if max(rel) > 2 * max(spread) or not np.isfinite(la).all():
        raise AssertionError(f"deferred deepfm: losses against the sparse "
                             f"path differ by {max(rel):.3e} (twice the "
                             f"one-ulp spread: {2 * max(spread):.3e})")
    if rows_bad or snaps_count != 0:
        raise AssertionError(f"deferred deepfm: rows after the fold at step "
                             f"{at + 1} (log count {snaps_count}) against "
                             f"the sparse path: {rows_bad} over twice the "
                             f"one-ulp spread")
    if not r["two_runs_bitwise"] or not r["scan4_vs_plain_bitwise"]:
        raise AssertionError("deferred deepfm: runs from one state differ")
    if len(folds) != 2 or count_after != 2 * DEEPFM_ROWS:
        raise AssertionError(f"deferred deepfm: {len(folds)} folds, count "
                             f"{count_after} after {P17_STEPS} steps")
    if reads[0] != 1 or any(reads[1:]):
        raise AssertionError(f"deferred deepfm: host reads by step {reads} "
                             f"(want the seeding read on step 1, then none; "
                             f"sites {read_sites})")
    if refused is None or "epilogue interval" not in refused:
        raise AssertionError("deferred deepfm: train_scanned(17) ran")


def p17_small(fluid, rec):
    """The small deferred config on the card against the CPU for SGD,
    Adagrad and Adam (losses within 1e-5; the card's state within twice
    what a one-ulp change of the dense input does to the CPU's own; the
    log's integer state equal), and a mid-window resume through the
    Checkpointer on the card (bitwise, on the same fold cadence)."""
    from paddle_tpu_torch.models import deepfm
    from paddle_tpu_torch.parallel.checkpoint import Checkpointer

    cfg = P17_SMALL
    out = {}
    rng = np.random.RandomState(5)
    feeds = [deepfm_feed(rng, cfg["B"], cfg["vocab"])
             for _ in range(cfg["steps"])]
    nudged = [dict(f, dense=(f["dense"] * (1.0 + 1e-7 * np.random.RandomState(
        6).randn(*f["dense"].shape))).astype("float32")) for f in feeds]
    ints = ("fm_t@pending_pos", "fm_t@log_ids", "fm_t@log_count")
    for opt in ("sgd", "adagrad", "adam"):
        main, startup, loss = deferred_program(
            fluid, deepfm, cfg["vocab"], cfg["B"] * 26, opt,
            cfg["segments"])
        exe = fluid.Executor(fluid.CUDAPlace(0))
        gs = fluid.Scope()
        exe.run(startup, scope=gs)
        names = [v.name for v in main.list_vars() if v.persistable
                 and gs.has_var(v.name)]
        state = {n: gs.find_np(n) for n in names}
        gl = [float(exe.run(main, feed=f, fetch_list=[loss], scope=gs)[0])
              for f in feeds]
        gpu = {n: gs.find_np(n) for n in names}
        runs = []
        for fs in (feeds, nudged):
            cs = fluid.Scope()
            fluid.io.load_params_from_numpy(state, scope=cs)
            cexe = fluid.Executor(fluid.CPUPlace())
            runs.append(([float(cexe.run(main, feed=f, fetch_list=[loss],
                                         scope=cs)[0]) for f in fs],
                         {n: cs.find_np(n) for n in names}))
        (cl, cpu), (_, nud) = runs
        floats = [n for n in names if gpu[n].dtype == np.float32
                  and gpu[n].size > 1]
        card = {n: rel_l2(gpu[n], cpu[n]) for n in floats}
        spread = {n: rel_l2(nud[n], cpu[n]) for n in floats}
        loss_rel = max(abs(g - c) / abs(c) for g, c in zip(gl, cl))
        ints_equal = all((gpu[n] == cpu[n]).all() for n in ints)
        out[opt] = {"loss_rel_max": loss_rel,
                    "card_vs_cpu_rel_l2_max": max(card.values()),
                    "cpu_one_ulp_spread_max": max(spread.values()),
                    "log_state_equal": ints_equal,
                    "worst": sorted(card.items(), key=lambda kv: -kv[1])[:2]}
        if loss_rel > 1e-5 or not ints_equal \
                or max(card.values()) > 2 * max(spread.values()):
            raise AssertionError(f"deferred {opt}: GPU and CPU disagree "
                                 f"{json.dumps(out[opt])}")
        if opt != "adagrad":
            continue
        # a resume from a checkpoint saved mid-window (after step 6 of a
        # 4-step cadence: two steps pending)
        with tempfile.TemporaryDirectory() as d:
            rs = fluid.Scope()
            fluid.io.load_params_from_numpy(state, scope=rs)
            counts, ckl = [], []
            for i, f in enumerate(feeds):
                ckl.append(float(exe.run(main, feed=f, fetch_list=[loss],
                                         scope=rs)[0]))
                counts.append(int(rs.find_np("fm_t@log_count")[0]))
                if i == 5:
                    ck = Checkpointer(os.path.join(d, "ck"))
                    ck.save(6, program=main, scope=rs, blocking=True)
                    break
            fresh = fluid.Scope()
            ck.restore(6, program=main, scope=fresh,
                       place=fluid.CUDAPlace(0))
            for f in feeds[6:]:
                ckl.append(float(exe.run(main, feed=f, fetch_list=[loss],
                                         scope=fresh)[0]))
                counts.append(int(fresh.find_np("fm_t@log_count")[0]))
            resumed = {n: fresh.find_np(n) for n in names}
        same = ckl == gl and all(
            resumed[n].tobytes() == gpu[n].tobytes() for n in names)
        out["checkpoint_resume"] = {"bitwise": same, "counts": counts}
        if not same or 0 not in counts[6:]:
            raise AssertionError(f"deferred resume: {out}")
    rec["deferred_small_gpu_vs_cpu"] = out
    log("deferred small GPU vs CPU " + json.dumps(out))


def p17_resnet(fluid, fb, rec):
    """ResNet-50 on the space-to-depth stem: bf16 AMP, B=128 at 224^2,
    Momentum, both switches on, 4 steps; then one f32 step at 64x64
    against the CPU."""
    from paddle_tpu_torch.models import resnet

    os.environ["PDTPU_BN_MODE"] = "pallas"
    main, startup, loss = resnet_program(fluid, resnet, RESNET_B, RESNET_HW,
                                         True, stem_s2d=True)
    feed = resnet_feed(RESNET_B, RESNET_HW)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    reset_bn_counts(fb)
    losses, ms = timed_steps(lambda: float(exe.run(
        main, feed=feed, fetch_list=[loss], scope=scope)[0]), 4)
    per_step = {k: v / 4 for k, v in bn_counts(fb).items()}
    del scope
    stem = [op.type for op in main.global_block().ops[:4]]
    r = {"stem_ops": stem, "losses": losses, **med_range(ms),
         "img_per_s": RESNET_B / float(np.median(ms[1:])) * 1e3,
         "fused_bn_launches_per_step": per_step,
         "stem_7x7_median_ms": RESNET_7X7.get("median_ms"),
         "stem_7x7_range_ms": RESNET_7X7.get("range_ms")}
    if not np.isfinite(losses).all() or \
            per_step != {k: float(v) for k, v in RESNET_PER_STEP.items()}:
        raise AssertionError(f"resnet s2d: {json.dumps(r)}")
    r["gpu_vs_cpu_64x64"] = resnet_gpu_vs_cpu(fluid, fb, stem_s2d=True)
    rec["resnet_s2d"] = r
    log("resnet s2d " + json.dumps(r))


def p17_serve(fluid, rec):
    """ResNet-50 (space-to-depth stem, is_test) saved and served through
    create_predictor, whose conv_bn_fuse_pass folds the 53 batch norms:
    against the unfused program on the Executor, batches 8 and 32."""
    import torch
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.models import resnet

    saved = os.environ.pop("PDTPU_CONV_BN_FUSION", None)
    try:
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 2024
        with unique_name.guard(), fluid.program_guard(main, startup):
            img = fluid.layers.data("img", [3, RESNET_HW, RESNET_HW])
            out = resnet.resnet(img, 50, 1000, is_test=True, stem_s2d=True)
    finally:
        if saved is not None:
            os.environ["PDTPU_CONV_BN_FUSION"] = saved
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    gen = np.random.RandomState(9)
    for v in main.list_vars():
        if v.persistable and v.name.endswith(".bn.mean"):
            scope.set_var(v.name, torch.tensor(
                0.1 * gen.randn(*v.shape), dtype=torch.float32,
                device="cuda"))
        elif v.persistable and v.name.endswith(".bn.var"):
            scope.set_var(v.name, torch.tensor(
                0.5 + gen.rand(*v.shape), dtype=torch.float32,
                device="cuda"))
    feeds = {bsz: {"img": np.random.RandomState(bsz).randn(
        bsz, 3, RESNET_HW, RESNET_HW).astype("float32")} for bsz in (8, 32)}
    refs = {bsz: exe.run(main, feed=f, fetch_list=[out], scope=scope)[0]
            for bsz, f in feeds.items()}
    r = {}
    with tempfile.TemporaryDirectory() as d:
        with fluid.scope_guard(scope):
            fluid.io.save_inference_model(d, ["img"], [out], exe,
                                          main_program=main)
        pred = inference.create_predictor(inference.Config(d))
        ops = [op.type for op in pred._program.global_block().ops]
        for bsz, f in feeds.items():
            (got,) = pred.run(f)
            _, ms = timed_steps(lambda: pred.run(f), 6)
            r[f"B={bsz}"] = {"rel_l2_vs_unfused": rel_l2(got, refs[bsz]),
                             "max_abs": float(np.abs(got - refs[bsz]).max()),
                             "ms_per_request": med_range(ms)}
    r.update(conv2d=ops.count("conv2d"), batch_norm=ops.count("batch_norm"),
             rtol=P17_SERVE_RTOL)
    del scope
    rec["resnet_serving"] = r
    log("resnet s2d serving " + json.dumps(r))
    if r["batch_norm"] or r["conv2d"] != 53 or any(
            v["rel_l2_vs_unfused"] > P17_SERVE_RTOL
            for k, v in r.items() if k.startswith("B=")):
        raise AssertionError("resnet serving: the folded predictor and the "
                             "unfused program disagree")


def nmt_dense_feed(src, tgt):
    """Bucketed (non-packed) NMT feeds: ids, next-token labels and the
    additive pad / causal masks."""
    b, t = src.shape
    lbl = np.concatenate([tgt[:, 1:], np.zeros((b, 1), "int64")],
                         axis=1)[..., None]
    keep = (src != 0).astype("float32")
    tkeep = (tgt != 0).astype("float32")
    causal = np.tril(np.ones((t, t), "float32"))
    m = np.minimum(causal[None], tkeep[:, None, :])
    return {"src_ids": src, "tgt_ids": tgt, "lbl_ids": lbl,
            "src_mask": ((keep - 1.0) * 1e4).reshape(b, 1, 1, t),
            "tgt_mask": ((m - 1.0) * 1e4).reshape(b, 1, t, t)}


def p17_nmt(fluid, rec):
    """Bucketed Transformer-big training (6+6 layers, d_model 1024, 16
    heads, dense masks, bf16 AMP, Adam, dropout 0.1) over seeded lengths
    uniform in 8-256 (target as long as its source), bucketed by
    reader.bucket_by_sequence_length into [64, 128, 256] at batch sizes
    [64, 32, 16], 2 steps a bucket through one program a bucket sharing
    one scope. Then padding invariance in f32 is_test: one batch's tokens
    padded to 64 and to 128 give one loss."""
    import torch
    from paddle_tpu_torch import reader
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.models import transformer_nmt as nmt

    bounds, sizes = P17_BUCKETS
    cfg = nmt.TransformerConfig()

    def stream():
        rng = np.random.RandomState(17)
        for _ in range(2000):
            n = int(rng.randint(8, 257))
            yield (rng.randint(1, cfg.src_vocab, n).astype("int64"),
                   rng.randint(1, cfg.tgt_vocab, n).astype("int64"))

    got = {L: [] for L in bounds}
    for (src, tgt), lens in reader.bucket_by_sequence_length(
            stream, bounds, sizes)():
        L = src.shape[1]
        if len(got[L]) < 2 and len(lens) == sizes[bounds.index(L)]:
            got[L].append((src, tgt, lens))
        if all(len(v) == 2 for v in got.values()):
            break

    def build(L, amp, is_test=False):
        with unique_name.guard():
            main, startup, _, loss = nmt.build_train_program(
                cfg, L, L, is_test=is_test, optimizer_factory=lambda: (
                    amp_wrapper(fluid, amp)(fluid.optimizer.Adam(LR))))
        main.random_seed = startup.random_seed = 2024
        return main, startup, loss

    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    progs = {L: build(L, True) for L in bounds}
    exe.run(progs[bounds[0]][1], scope=scope)
    torch.cuda.reset_peak_memory_stats()
    r = {}
    for L in bounds:
        main, _, loss = progs[L]
        feeds = [nmt_dense_feed(s, t) for s, t, _ in got[L]]
        losses, ms = [], []
        for f in feeds:
            t0 = time.perf_counter()
            losses.append(float(exe.run(main, feed=f, fetch_list=[loss],
                                        scope=scope)[0]))
            ms.append((time.perf_counter() - t0) * 1e3)
        real = sum(int(lens.sum()) for _, _, lens in got[L])
        padded = sum(lens.size * L for _, _, lens in got[L])
        r[f"bucket {L} B={sizes[bounds.index(L)]}"] = {
            "losses": losses, "step_ms": ms,
            "median_ms": float(np.median(ms)),
            "padding_waste": 1.0 - real / padded}
    r["peak_memory_MiB"] = torch.cuda.max_memory_allocated() / 2**20
    state = {n: t.clone() for n, t in ((n, scope.find_var(n))
                                       for n in scope.var_names())
             if isinstance(t, torch.Tensor)}
    del scope
    # padding invariance: the first 64-bucket batch padded to 64 and 128
    src, tgt, _ = got[64][0]
    pad = {}
    for L in (64, 128):
        s = np.zeros((src.shape[0], L), "int64")
        t = np.zeros((src.shape[0], L), "int64")
        s[:, :64], t[:, :64] = src, tgt
        main, _, loss = build(L, False, is_test=True)
        pad[L] = float(exe.run(main, feed=nmt_dense_feed(s, t),
                               fetch_list=[loss],
                               scope=scope_from(fluid, state))[0])
    del state
    torch.cuda.empty_cache()
    rel = abs(pad[64] - pad[128]) / abs(pad[64])
    r["padding_invariance_f32"] = {"loss_64": pad[64], "loss_128": pad[128],
                                   "rel": rel, "rtol": P17_PAD_RTOL}
    rec["bucketed_nmt"] = r
    log("bucketed nmt " + json.dumps(r))
    if rel > P17_PAD_RTOL or not all(
            np.isfinite(v["losses"]).all() for k, v in r.items()
            if k.startswith("bucket")):
        raise AssertionError("bucketed nmt: padding changes the loss or a "
                             "loss is not finite")


def p17_sequence_ops(rec):
    """Each sequence op and both beam ops on the card against the CPU at a
    small shape: one line of max |card - CPU|."""
    import torch
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.core.executor import ExecContext

    g = np.random.RandomState(3)

    def r(*s):
        return g.randn(*s).astype("float32")

    ln = np.array([2, 5, 1], np.int32)
    seq = r(3, 5, 4)
    toks = np.array([[2, 1, 2, 3, 0], [5, 2, 2, 2, 1]], np.int32)
    cases = [
        ("sequence_mask", {"X": [ln]}, {"maxlen": 6, "out_dtype": "int32"}),
        ("sequence_pool", {"X": [seq], "Length": [ln]}, {"pooltype": "MAX"}),
        ("sequence_softmax", {"X": [r(3, 5)], "Length": [ln]}, {}),
        ("sequence_expand", {"X": [r(3, 4)], "Y": [r(3, 2, 4)]}, {}),
        ("sequence_reverse", {"X": [seq], "Length": [ln]}, {}),
        ("sequence_concat", {"X": [r(3, 2, 4), seq]}, {}),
        ("im2sequence", {"X": [r(2, 3, 7, 5)]},
         {"kernels": [3, 2], "strides": [2, 1], "paddings": [1, 0, 1, 0]}),
        ("sequence_pad", {"X": [seq], "PadValue": [np.array(-1, "f4")],
                          "Length": [ln]}, {"padded_length": 7}),
        ("sequence_unpad", {"X": [seq], "Length": [ln]}, {}),
        ("sequence_conv", {"X": [seq], "Filter": [r(12, 3)],
                           "Length": [ln]}, {"contextLength": 3}),
        ("sequence_slice", {"X": [seq], "Offset": [np.array([1, 0, 3],
                                                            np.int32)],
                            "Length": [ln]}, {}),
        ("sequence_erase", {"X": [toks], "Length": [np.array([4, 5],
                                                             np.int32)]},
         {"tokens": [2]}),
        ("sequence_expand_as", {"X": [r(3, 4)], "Y": [seq],
                                "Length": [ln]}, {}),
        ("sequence_enumerate", {"X": [toks]}, {"win_size": 3}),
        ("sequence_reshape", {"X": [seq], "Length": [ln]}, {"new_dim": 2}),
        ("sequence_scatter", {"X": [r(2, 6)], "Ids": [np.array(
            [[0, 2, 2], [5, 1, 0]], np.int32)], "Updates": [r(2, 3)]}, {}),
        ("sequence_topk_avg_pooling", {"X": [r(3, 2, 5)], "Length": [ln]},
         {"topks": [1, 3]}),
        ("beam_search", {"Scores": [r(2, 3, 7)], "PreScores": [r(2, 3)],
                         "PreFinished": [np.array([[0, 1, 0], [0, 0, 1]],
                                                  np.int32)]},
         {"beam_size": 3, "end_id": 0}),
        ("beam_search_decode", {
            "Ids": [g.randint(0, 7, (4, 2, 3)).astype("int64")],
            "ParentIdx": [g.randint(0, 3, (4, 2, 3)).astype("int64")],
            "Scores": [r(2, 3)]}, {}),
    ]
    diffs = {}
    for op, ins, attrs in cases:
        outs = []
        for dev in ("cuda", "cpu"):
            fn = registry.get_op(op).fn
            got = fn(ExecContext(dev), {s: [torch.tensor(a, device=dev)
                                            for a in v]
                                        for s, v in ins.items()}, attrs)
            outs.append({s: [t.detach().cpu() for t in v]
                         for s, v in got.items()})
        card, cpu = outs
        diffs[op] = max(float((a.double() - b.double()).abs().max())
                        if a.numel() else 0.0
                        for s in cpu for a, b in zip(card[s], cpu[s]))
    rec["sequence_and_beam_ops_max_abs"] = diffs
    log("sequence and beam ops, card vs CPU max |diff| " + json.dumps(diffs))
    if max(diffs.values()) > P17_SEQ_TOL:
        raise AssertionError("a sequence or beam op differs on the card")


def phase_deferred_and_a6(fluid, fb, smi):
    """Phase 17: the deferred-row log (full-width DeepFM, the small config
    against the CPU, a Checkpointer resume) and the A6 paths (the
    space-to-depth ResNet-50 stem in training and serving, bucketed
    Transformer-big NMT, the sequence and beam ops). Prints one JSON
    line."""
    import torch

    t0 = time.perf_counter()
    rec = {"device": smi}
    p17_deepfm(fluid, rec)
    p17_small(fluid, rec)
    torch.cuda.empty_cache()
    p17_resnet(fluid, fb, rec)
    p17_serve(fluid, rec)
    torch.cuda.empty_cache()
    p17_nmt(fluid, rec)
    p17_sequence_ops(rec)
    rec["wall_s"] = time.perf_counter() - t0
    log("deferred rows and the A6 paths " + json.dumps(rec))



# -- phase 18: inference and serving -----------------------------------------
P18_BUCKETS = (1, 2, 4, 8)
P18_REQUESTS, P18_CLIENTS = 64, 8   # BERT-base requests of 1-8 rows, T=128
P18_SERVE_RTOL = 1e-5      # a request served in a bucket against it alone
P18_CALIB = 8              # BERT int8 calibration feeds of B=8, seed 2024
# The JAX package's own int8 gate on BERT-base at full width (its seed-2024
# weights, the same 8 calibration feeds), measured on the CPU by
# scripts/bert_int8_gate_cpu.py: it passes, delta 0.033495 (budget 0.05).
P18_JAX_BERT_INT8 = {"passes": True, "accuracy_delta": 0.033495}
P18_QFC_RTOL = 1e-6        # quantized_fc on the card against the CPU
FLEET_MLP = (512, 2048, 16)          # bench.py:1503: in, hidden (two), out
FLEET_REQUESTS, FLEET_CONCURRENCY = 256, 16
FLEET_RTOL, FLEET_ATOL = 1e-5, 1e-6  # an answer against the unbatched run
FLEET_WORKER_DEVICE = None           # process replicas serve on CUDA 0
# bench.py:1595-1649 at DeepFM's vocabulary: 16 id fields, a packed
# [V, 128] u16 table with 8 visible f32 of 16, fc 16 softmax
CTR = {"vocab": 33_554_432, "dim": 8, "mult": 2, "fields": 16,
       "cache": 65536, "batches": 32, "batch": 8, "shards": 3}


def p18_load(call, feeds, clients, done=None):
    """Closed-loop load: `clients` threads, each sending the next feed when
    its last answer came back. (answers, ms each, errors, wall s,
    completion times). With an Event `done`, the feeds go round until it
    is set."""
    import threading

    outs, ms, errors, finished = {}, {}, [], []
    lock = threading.Lock()
    state = {"next": 0}

    def client():
        while True:
            with lock:
                i = state["next"]
                state["next"] += 1
            if (done is None and i >= len(feeds)) or (
                    done is not None and done.is_set()):
                return
            t0 = time.perf_counter()
            try:
                out = call(feeds[i % len(feeds)])
            except Exception as e:  # reported; the phase fails on any
                with lock:
                    errors.append(f"{type(e).__name__}: {e}")
                return
            t1 = time.perf_counter()
            with lock:
                outs[i] = out
                ms[i] = (t1 - t0) * 1e3
                finished.append(t1)

    threads = [threading.Thread(target=client) for _ in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return outs, ms, errors, time.perf_counter() - t0, sorted(finished)


def p18_latency(ms, wall):
    lat = np.asarray(list(ms.values()))
    return {"requests": len(lat), "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "requests_per_s": len(lat) / wall}


def p18_state_bytes(pred):
    out = {}
    for t in pred._state.values():
        k = str(t.dtype).replace("torch.", "")
        out[k] = out.get(k, 0) + t.numel() * t.element_size()
    return out


def p18_bert_served(fluid, fa, d, rec):
    """Arm 1: BERT-base f32 behind an InferenceServer (buckets 1/2/4/8,
    2 ms batch delay, queue 256), warmed, then 64 seeded requests of 1-8
    rows from 8 client threads; each answer against the Predictor's run of
    that request alone; /healthz through a live IntrospectionServer."""
    import urllib.request

    import torch
    from paddle_tpu_torch import inference, serving
    from paddle_tpu_torch.observability.http import IntrospectionServer
    from paddle_tpu_torch.observability.tracer import get_tracer

    pred = inference.create_predictor(inference.Config(d))
    rng = np.random.RandomState(18)
    feeds = [bert_feed(int(rng.randint(1, 9)), 128, rng)
             for _ in range(P18_REQUESTS)]
    torch.cuda.reset_peak_memory_stats()
    server = serving.InferenceServer(pred, buckets=P18_BUCKETS,
                                     max_batch_delay_ms=2.0,
                                     max_queue_size=256)
    t0 = time.perf_counter()
    warm = server.warmup(example_feed=feeds[0])
    warm_s = time.perf_counter() - t0
    tracer = get_tracer()
    tracer.clear()
    tracer.enabled = True
    introspect = IntrospectionServer(port=0).start()
    try:
        with server:
            fa.flash_attention_fwd.launches = 0          # main path starts
            fa.flash_attention_fwd.plain_on_cuda = 0
            outs, ms, errors, wall, _ = p18_load(
                lambda f: server.infer(f), feeds, P18_CLIENTS)
            launches = fa.flash_attention_fwd.launches   # main path ends
            plain = fa.flash_attention_fwd.plain_on_cuda
            with urllib.request.urlopen(introspect.url + "/healthz",
                                        timeout=10) as resp:
                health = {"http": resp.status,
                          **json.loads(resp.read().decode())}
    finally:
        introspect.stop()
        tracer.enabled = False
    hist = {}
    for e in tracer.export_chrome_trace()["traceEvents"]:
        if e.get("ph") == "B" and e["name"].startswith("serving/dispatch_b"):
            b = int(e["name"].rsplit("_b", 1)[1])
            hist[b] = hist.get(b, 0) + 1
    tracer.clear()
    peak = torch.cuda.max_memory_allocated() / 2**20
    snap = server.metrics.snapshot()
    dispatches = sum(hist.values())
    errs = [rel_l2(outs[i][0], pred.run(f)[0]) for i, f in enumerate(feeds)]
    r = {"requests": len(outs), "errors": len(errors),
         **p18_latency(ms, wall), "warmup": {**warm, "s": warm_s},
         "bucket_histogram": dict(sorted(hist.items())),
         "rows_per_dispatch": snap["serving/batch_rows"],
         "padded_rows": snap["serving/padded_rows"],
         "dispatches": dispatches, "flash_fwd_launches": launches,
         "flash_plain_calls": plain,
         "max_rel_l2_vs_alone": max(errs), "rtol": P18_SERVE_RTOL,
         "healthz": {"http": health["http"], "status": health["status"],
                     "checks": sorted(health["checks"])},
         "peak_mib": peak}
    rec["bert_f32_served"] = r
    log("serving: BERT-base f32 " + json.dumps(r))
    if errors or len(outs) != P18_REQUESTS:
        raise AssertionError(f"serving: {len(errors)} errors {errors[:3]}")
    if dispatches != snap["serving/bucket"]["count"] or \
            launches != 12 * dispatches or plain:
        raise AssertionError(f"serving: {launches} flash launches (plain "
                             f"{plain}) in {dispatches} dispatches, "
                             f"expected 12 each")
    if max(errs) > P18_SERVE_RTOL:
        raise AssertionError("serving: a batched answer is off from the "
                             "request run alone")
    if health["http"] != 200 or health["status"] != "ok":
        raise AssertionError(f"serving: /healthz {health}")
    return pred, launches


def p18_quantized_fc(pred8, rec):
    """quantized_fc on the card against the CPU at BERT's FFN shape (the
    int8 predictor's first gelu quantized_fc: M = 1024, K = 768, N = 3072)
    and at M = 1 (the padded _int_mm): int32 accumulators equal, outputs
    within P18_QFC_RTOL of the largest; times beside the f32 and bf16
    fused_fc of the same shape."""
    import torch
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.core.executor import ExecContext
    from paddle_tpu_torch.ops import quant_ops as tq

    op = next(o for o in pred8._program.global_block().ops
              if o.type == "quantized_fc"
              and o.attr("activation_type") == "gelu")
    ins = {s: [pred8._state[n] for n in names]
           for s, names in op.inputs.items() if s != "Input"}
    w = ins["W"][0]
    k = w.shape[0]
    scale = float(op.attr("act_scale"))
    gen = torch.Generator("cuda").manual_seed(18)
    fn = registry.get_op("quantized_fc").fn
    lead = (1,) * (int(op.attr("in_num_col_dims", 1)) - 1)
    r = {"op": op.output("Out")[0], "K": int(k), "N": int(w.shape[1])}
    for m in (1024, 1):
        x = torch.randn(lead + (m, k), generator=gen,
                        device="cuda") * (scale / 4)
        x2 = x.reshape(m, k)
        acc = tq.int8_matmul(tq.quantize_act(x2, scale), w)
        acc_cpu = tq.int8_matmul(tq.quantize_act(x2.cpu(), scale), w.cpu())
        out = fn(ExecContext("cuda", is_test=True),
                 {"Input": [x], **ins}, op.attrs)["Out"][0]
        out_cpu = fn(ExecContext("cpu", is_test=True),
                     {"Input": [x.cpu()],
                      **{s: [t.cpu() for t in v] for s, v in ins.items()}},
                     op.attrs)["Out"][0]
        o, oc = out.cpu().numpy(), out_cpu.numpy()
        r[f"M={m}"] = {"acc_equal": bool(torch.equal(acc.cpu(), acc_cpu)),
                       "rel_err": float(np.abs(o - oc).max()
                                        / np.abs(oc).max())}
        if m == 1024:
            wf = (w.float() * (ins["WScale"][0] / 127.0)).contiguous()
            b = ins["Bias"][0]
            r[f"M={m}"].update(
                ms=cuda_ms(lambda: fn(ExecContext("cuda", is_test=True),
                                      {"Input": [x], **ins}, op.attrs)),
                int_mm_ms=cuda_ms(lambda: tq.int8_matmul(
                    tq.quantize_act(x2, scale), w)),
                f32_addmm_ms=cuda_ms(lambda: torch.addmm(b, x2, wf)),
                bf16_addmm_ms=cuda_ms(lambda: torch.addmm(
                    b.bfloat16(), x2.bfloat16(), wf.bfloat16())))
    rec["quantized_fc"] = r
    log("serving: quantized_fc card vs CPU " + json.dumps(r))
    if not all(r[f"M={m}"]["acc_equal"]
               and r[f"M={m}"]["rel_err"] <= P18_QFC_RTOL
               for m in (1024, 1)):
        raise AssertionError("quantized_fc: the card disagrees with the CPU")


def p18_bert_int8(fluid, d, pred, rec):
    """Arm 2: BERT-base int8 (Config.enable_int8 on 8 seeded B=8 feeds):
    the gate's decision and delta beside the JAX package's, quant_meta,
    quantized_fc card vs CPU, ms a request at bucket 8 in f32, bf16 and
    int8, state bytes by dtype."""
    from paddle_tpu_torch import inference

    rng = np.random.RandomState(2024)
    calib = [bert_feed(8, 128, rng) for _ in range(P18_CALIB)]
    cfg = inference.Config(d)
    cfg.enable_int8(calib)
    t0 = time.perf_counter()
    pred8 = inference.create_predictor(cfg)   # calibrate, rewrite, gate
    meta = pred8.quant_meta
    r = {"calibrate_rewrite_gate_s": time.perf_counter() - t0,
         "passes": True, "accuracy_delta": meta["accuracy_delta"],
         "accuracy_budget": meta["accuracy_budget"],
         "samples": meta["samples"], "fc": len(meta["fc"]),
         "tables": len(meta["tables"]), "jax": P18_JAX_BERT_INT8}
    rec["bert_int8"] = r
    log("serving: BERT-base int8 gate " + json.dumps(r))
    if not P18_JAX_BERT_INT8["passes"] or len(meta["tables"]) != 3:
        raise AssertionError("int8: the gate's decision or the rewrite "
                             "differs from the JAX package's")
    p18_quantized_fc(pred8, rec)
    bf16 = inference.create_predictor(inference.Config(d),
                                      precision="bfloat16")
    feed8 = bert_feed(8, 128, rng)
    ref = pred.run(feed8)[0]
    timing = {}
    for name, p in (("float32", pred), ("bfloat16", bf16), ("int8", pred8)):
        _, ms = timed_steps(lambda: p.run_padded(feed8, 8), 6)
        timing[name] = {"request_b8": med_range(ms),
                        "rel_l2_vs_f32": rel_l2(p.run(feed8)[0], ref),
                        "state_bytes": p18_state_bytes(p)}
    rec["bert_by_precision"] = timing
    log("serving: BERT-base by precision " + json.dumps(timing))


def p18_mlp(fluid, d, seed):
    """The JAX bench's fleet model (512 → 2048 → 2048 → 16, relu, softmax)
    from `seed`, saved as an inference model in `d`."""
    from paddle_tpu_torch.core import unique_name

    in_dim, hidden, classes = FLEET_MLP
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [in_dim])
        h = x
        for _ in range(2):
            h = fluid.layers.fc(h, hidden, act="relu")
        out = fluid.layers.fc(h, classes, act="softmax")
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(d, ["x"], [out], exe,
                                      main_program=main)
    return d


def p18_check(outs, refs, what):
    bad = [i for i, o in outs.items()
           if not any(np.allclose(o[0], ref[i % len(ref)], rtol=FLEET_RTOL,
                                  atol=FLEET_ATOL) for ref in refs)]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} answers match no version")


def p18_fleet(fluid, d1, d2, rec):
    """Arm 3, at the JAX bench's fleet width: one served replica against a
    3-ThreadReplica fleet (256 batch-1 requests, 16 concurrent); a
    rollout v1 → v2 under load; ab_split; three tenants 2:1:1 on 4 int8
    replicas; a 2-ProcessReplica fleet serving on the card, one worker
    SIGKILLed under load."""
    import threading

    from paddle_tpu_torch import inference, serving
    from paddle_tpu_torch.serving import fleet

    in_dim = FLEET_MLP[0]
    rng = np.random.RandomState(0)
    rows = [{"x": rng.rand(1, in_dim).astype("float32")}
            for _ in range(FLEET_REQUESTS)]
    ref1 = inference.create_predictor(inference.Config(d1))
    ref2 = inference.create_predictor(inference.Config(d2))
    refs1 = [ref1.run(f)[0] for f in rows]
    refs2 = [ref2.run(f)[0] for f in rows]
    if np.allclose(refs1[0], refs2[0], rtol=FLEET_RTOL, atol=FLEET_ATOL):
        raise AssertionError("fleet: v1 and v2 are indistinguishable")
    kw = {"max_batch_delay_ms": 1.0, "max_queue_size": 1024}
    r = {}

    server = serving.InferenceServer(ref1.clone(), buckets=P18_BUCKETS,
                                     **kw)
    server.warmup()
    with server:
        outs, ms, errors, wall, _ = p18_load(lambda f: server.infer(f),
                                             rows, FLEET_CONCURRENCY)
    p18_check(outs, [refs1], "one replica")
    r["one_replica"] = {"errors": len(errors), **p18_latency(ms, wall)}

    reg = fleet.ModelRegistry()
    reg.register("v1", d1)
    reg.register("v2", d2)
    fl = fleet.ServingFleet(reg, "v1", replicas=3, buckets=P18_BUCKETS,
                            server_kwargs=kw, health_interval_s=0.5)
    with fl:
        outs, ms, ferrors, wall, _ = p18_load(fl.infer, rows,
                                              FLEET_CONCURRENCY)
        p18_check(outs, [refs1], "fleet of 3")
        r["fleet3"] = {"errors": len(ferrors), **p18_latency(ms, wall),
                       "per_replica": [
                           x._server.metrics.snapshot()["serving/requests"]
                           for x in fl.replicas]}
        r["fleet3"]["vs_one_replica"] = (r["fleet3"]["requests_per_s"]
                                         / r["one_replica"]["requests_per_s"])

        done = threading.Event()
        box = {}
        loader = threading.Thread(target=lambda: box.setdefault(
            "load", p18_load(fl.infer, rows, 4, done=done)))
        loader.start()
        time.sleep(0.2)
        report = fl.rollout("v2")
        time.sleep(0.2)
        done.set()
        loader.join()
        outs, ms, rerrors, wall, finished = box["load"]
        p18_check(outs, [refs1, refs2], "rollout")
        gaps = np.diff(finished) * 1e3
        r["rollout"] = {
            "errors": len(rerrors), "requests": len(outs),
            "max_completion_gap_ms": float(gaps.max()),
            "median_completion_gap_ms": float(np.median(gaps)),
            "wall_ms": report["wall_ms"],
            "rejected": sum(x["drained"]["rejected"]
                            for x in report["replicas"].values()),
            "versions_live": fl.versions_live()}
        if rerrors or r["rollout"]["rejected"] or \
                fl.versions_live() != {"v2": 3}:
            raise AssertionError(f"rollout: {r['rollout']} {rerrors[:3]}")

        ab = fl.ab_split("v1", weight_b=0.5, count=1)
        hits = {"v1": 0, "v2": 0}
        for i, f in enumerate(rows[:64]):
            out = fl.infer(f)[0]
            for v, refs in (("v1", refs1), ("v2", refs2)):
                if np.allclose(out, refs[i], rtol=FLEET_RTOL,
                               atol=FLEET_ATOL):
                    hits[v] += 1
                    break
            else:
                raise AssertionError("ab_split: an answer matches neither")
        fl.router.set_version_weights(None)
        r["ab_split"] = {"hits": hits, "versions_live": fl.versions_live(),
                         "errors": [x for x in ab["replicas"].values()
                                    if "error" in x]}
        if min(hits.values()) < 8 or r["ab_split"]["errors"]:
            raise AssertionError(f"ab_split: {r['ab_split']}")

    if errors or ferrors:
        raise AssertionError(f"fleet: failed requests "
                             f"{(errors + ferrors)[:3]}")
    r["tenants"] = p18_tenants(d1, rows, refs1)
    r["process_fleet"] = p18_process_fleet(d1, rows, refs1)
    rec["fleet"] = r
    log("serving: fleet " + json.dumps(r))


def p18_tenants(d, rows, refs):
    """Three tenants at 2:1:1 on 4 int8 replicas (bench.py:1915): each
    version through the registry's int8 gate with the calibration a probe
    predictor measured; mixed load drawn by weight; a throttled request
    backs off and is sent again."""
    import threading

    from paddle_tpu_torch import inference
    from paddle_tpu_torch.serving import fleet

    rng = np.random.RandomState(1)
    calib = [{"x": rng.rand(8, FLEET_MLP[0]).astype("float32")}
             for _ in range(8)]

    def int8_config(model_dir):
        cfg = inference.Config(model_dir)
        cfg.enable_int8(calib)
        return cfg

    qm = inference.create_predictor(int8_config(d)).quant_meta
    weights = {"ads": 2.0, "feed": 1.0, "search": 1.0}
    reg = fleet.ModelRegistry()
    for name in weights:
        reg.register(f"{name}-v1", d, precision="int8", calibration={
            k: qm[k] for k in ("accuracy_delta", "accuracy_budget",
                               "samples")})
    fl = fleet.ServingFleet(
        reg, replicas=4, buckets=P18_BUCKETS,
        predictor_factory=lambda m: inference.create_predictor(
            int8_config(m.model_dir)),
        server_kwargs={"max_batch_delay_ms": 1.0, "max_queue_size": 1024},
        tenants={n: {"version": f"{n}-v1", "weight": w}
                 for n, w in weights.items()})
    names = list(weights)
    pick = np.random.RandomState(2).choice(
        len(names), size=len(rows),
        p=np.asarray([weights[n] for n in names]) / sum(weights.values()))
    throttled = {n: 0 for n in names}
    lock = threading.Lock()

    def call(i):
        while True:
            try:
                return fl.infer(rows[i], tenant=names[pick[i]])
            except fleet.TenantThrottledError:
                with lock:
                    throttled[names[pick[i]]] += 1
                time.sleep(0.001)

    with fl:
        outs, ms, errors, wall, _ = p18_load(call, list(range(len(rows))),
                                             FLEET_CONCURRENCY)
        stats = fl.tenant_stats()
    int8_err = max(float(np.abs(outs[i][0] - refs[i]).max()) for i in outs)
    per = {}
    for j, n in enumerate(names):
        lat = [ms[i] for i in ms if pick[i] == j]
        per[n] = {"requests": len(lat), "throttled": throttled[n],
                  "p99_ms": float(np.percentile(lat, 99)),
                  "router_p99_ms": stats[n]["p99_ms"],
                  "replicas": sum(1 for x in fl.replicas if x.tenant == n)}
    out = {"errors": len(errors), "requests_per_s": len(outs) / wall,
           "accuracy_delta": qm["accuracy_delta"],
           "max_abs_vs_f32": int8_err, "tenants": per}
    if errors or len(outs) != len(rows) or \
            [per[n]["replicas"] for n in names] != [2, 1, 1]:
        raise AssertionError(f"tenants: {out} {errors[:3]}")
    return out


def p18_process_fleet(d, rows, refs):
    """A 2-ProcessReplica fleet (fresh worker interpreters serving on the
    card), 3 clients sending 128 requests; one worker SIGKILLed once 32
    answers are back: no request lost, every answer correct, the dead
    replica ejected."""
    import threading

    from paddle_tpu_torch.serving import fleet

    n = min(128, len(rows))
    reg = fleet.ModelRegistry()
    reg.register("v1", d)
    t0 = time.perf_counter()
    fl = fleet.ServingFleet(reg, "v1", replicas=2, mode="process",
                            buckets=P18_BUCKETS,
                            server_kwargs={"max_batch_delay_ms": 1.0},
                            health_interval_s=0.2,
                            device=FLEET_WORKER_DEVICE)
    ready_s = time.perf_counter() - t0
    answered = threading.Event()
    count = [0]
    lock = threading.Lock()

    def call(f):
        out = fl.infer(f)
        with lock:
            count[0] += 1
            if count[0] >= 32:
                answered.set()
        return out

    with fl:
        victim = fl.replicas[1]
        box = {}
        loader = threading.Thread(target=lambda: box.setdefault(
            "load", p18_load(call, rows[:n], 3)))
        loader.start()
        answered.wait(120)
        victim.kill()
        loader.join()
        outs, ms, errors, wall, _ = box["load"]
        fl.router.sweep()
        st = fl.router.stats()["replicas"][victim.name]
        live = fl.versions_live()
    p18_check(outs, [refs], "process fleet")
    out = {"ready_s": ready_s, "requests": len(outs), "errors": len(errors),
           **p18_latency(ms, wall), "victim_alive": st["alive"],
           "victim_ejected": st["ejected"], "versions_live": live,
           "retries": fl.router.metrics.counter("fleet/retries").value}
    if errors or len(outs) != n or st["alive"] or not st["ejected"] or \
            live != {"v1": 1}:
        raise AssertionError(f"process fleet: {out} {errors[:3]}")
    return out


def p18_ctr_models(fluid, d_ps):
    """The serving CTR model (bench.py:1595) saved with a CTR["cache"]-row
    zero table, from seed 2024; returns its fetch name."""
    import torch
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.initializer import RowPackInitializer
    from paddle_tpu_torch.param_attr import ParamAttr

    L = fluid.layers
    dim, mult, fields = CTR["dim"], CTR["mult"], CTR["fields"]
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 2024
    with unique_name.guard(), fluid.program_guard(main, startup):
        ids = L.data("ids", [fields], dtype="int64")
        emb = L.embedding(ids, [CTR["cache"], dim * mult], is_sparse=True,
                          row_pack=True, param_attr=ParamAttr(
                              name="tb", initializer=RowPackInitializer(
                                  dim, dim * mult, -1.0, 1.0)))
        emb = L.slice(emb, axes=[2], starts=[0], ends=[dim])
        out = L.fc(L.reshape(emb, [-1, fields * dim]), 16, act="softmax")
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    scope.set_var("tb", torch.zeros((CTR["cache"], 128), dtype=torch.int16,
                                    device="cuda").view(torch.uint16))
    with fluid.scope_guard(scope):
        fluid.io.save_inference_model(d_ps, ["ids"], [out], exe,
                                      main_program=main)
    return out.name


def p18_packed_rows(vis):
    """Packed [n, 128] u16 rows whose first 2·dim lanes are the bits of
    `vis` (f32 [n, dim]) and the rest zero: pack_rows of [vis | 0]."""
    n = vis.shape[0]
    rows = np.zeros((n, 128), np.uint16)
    rows[:, :2 * vis.shape[1]] = np.ascontiguousarray(vis).view(np.uint16)
    return rows


def p18_ctr(fluid, rec):
    """Arm 4: PS-backed CTR serving at DeepFM's vocabulary: a
    PsLookupPredictor over a 3-shard in-process ShardedTable of the full
    packed table (host memory), against Executor.run of the same serving
    program with the whole table in a scope on the card (bitwise); 32
    uniform then 32 Zipf(1.5) batches of 8; then the int8-resident
    variant (pinned table scale) and a delta push."""
    import torch
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.core.dtypes import from_numpy
    from paddle_tpu_torch.inference.quant import requantize_packed_rows
    from paddle_tpu_torch.ps import RangeSpec, ShardedTable

    v, dim, b, fields = CTR["vocab"], CTR["dim"], CTR["batch"], CTR["fields"]
    t0 = time.perf_counter()
    vis = np.random.RandomState(7).uniform(-1, 1, (v, dim)).astype("float32")
    host = p18_packed_rows(vis)
    scale = float(np.abs(vis).max())
    del vis
    table = ShardedTable.build_in_process("tb", RangeSpec.even(
        v, CTR["shards"]), full_rows=host)
    full = from_numpy(host, device="cuda")        # the whole table, 8.59 GB
    del host
    setup_s = time.perf_counter() - t0
    r = {"vocab": v, "table_gb": v * 128 * 2 / 1e9, "setup_s": setup_s}
    try:
        with tempfile.TemporaryDirectory() as d_ps:
            fetch = p18_ctr_models(fluid, d_ps)
            base = inference.create_predictor(inference.Config(d_ps))
            ref_scope = fluid.Scope()
            for n, t in base._state.items():
                ref_scope.set_var(n, full if n == "tb" else t)
            program = base._program
            ps = inference.PsLookupPredictor(
                base, [inference.PsLookupBinding("tb", table, ["ids"])],
                cache_rows_per_table=CTR["cache"])
            uploads = []
            apply = ps._apply

            def timed_apply(overrides):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                apply(overrides)
                torch.cuda.synchronize()
                uploads.append((time.perf_counter() - t1) * 1e3)

            ps._apply = timed_apply
            exe = fluid.Executor(fluid.CUDAPlace(0))
            rng = np.random.RandomState(3)
            for dist in ("uniform", "zipf"):
                batches = [(rng.randint(0, v, (b, fields)) if dist ==
                            "uniform" else (rng.zipf(1.5, (b, fields)) - 1)
                            % v).astype("int64")
                           for _ in range(CTR["batches"])]
                st0 = dict(ps.stats()["tb"])
                n_up = len(uploads)
                local_ms, ps_ms, equal = [], [], 0
                for ids in batches:
                    t1 = time.perf_counter()
                    (want,) = exe.run(program, feed={"ids": ids},
                                      fetch_list=[fetch], scope=ref_scope)
                    local_ms.append((time.perf_counter() - t1) * 1e3)
                    t1 = time.perf_counter()
                    (got,) = ps.run_padded({"ids": ids}, b)
                    ps_ms.append((time.perf_counter() - t1) * 1e3)
                    equal += int(np.array_equal(got, want))
                st = ps.stats()["tb"]
                hits = st["hits"] - st0["hits"]
                misses = st["misses"] - st0["misses"]
                r[dist] = {"bitwise_equal": f"{equal}/{len(batches)}",
                           "hit_rate": hits / max(hits + misses, 1),
                           "local_ms": med_range(local_ms),
                           "ps_ms": med_range(ps_ms),
                           "upload_ms": med_range(uploads[n_up:])}
                if equal != len(batches):
                    raise AssertionError(f"PS serving: {dist} batches not "
                                         f"bitwise equal ({equal})")
            r["resident_bytes"] = ps.resident_table_bytes()
            r["resident_fraction"] = ps.resident_table_bytes() / (
                v * 128 * 2)

            cfg = inference.Config(d_ps)
            cfg.enable_int8([{"ids": rng.randint(0, CTR["cache"],
                                                 (b, fields))}
                             for _ in range(4)], table_scales={"tb": scale})
            ps8 = inference.PsLookupPredictor(
                inference.create_predictor(cfg),
                [inference.PsLookupBinding("tb", table, ["ids"])],
                cache_rows_per_table=CTR["cache"])
            ids = batches[-1]
            err = float(np.abs(ps8.run_padded({"ids": ids}, b)[0]
                               - ps.run_padded({"ids": ids}, b)[0]).max())
            touched = np.unique(ids)
            nrows = p18_packed_rows(np.random.RandomState(9).uniform(
                -1, 1, (touched.size, dim)).astype("float32"))
            q = ps8._quant["tb"]
            refreshed = ps8.apply_delta("tb", touched, nrows)
            got, miss = ps8._caches["tb"].lookup(touched)
            same = bool(np.array_equal(got, requantize_packed_rows(
                nrows, q["dt"], q["scale"])))
            r["int8_resident"] = {
                "max_abs_vs_f32": err, "table_scale": scale,
                "refreshed": refreshed, "cache_equals_requantized": same,
                "resident_bytes": ps8.resident_table_bytes()}
            if refreshed != touched.size or miss.any() or not same:
                raise AssertionError(f"PS int8: {r['int8_resident']}")
    finally:
        table.close()
        del full
        torch.cuda.empty_cache()
    rec["ps_ctr"] = r
    log("serving: PS-backed CTR " + json.dumps(r))


def phase_inference_serving(fluid, fa, smi):
    """Phase 18: inference and serving (module docstring). Prints one JSON
    line; returns the flash forward launches of arm 1's served requests."""
    import torch

    t0 = time.perf_counter()
    rec = {"device": smi}
    from paddle_tpu_torch.models import bert

    with tempfile.TemporaryDirectory() as d:
        main, startup, feed_names, out = build_bert(fluid, bert, 128)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CUDAPlace(0))
        exe.run(startup, scope=scope)
        with fluid.scope_guard(scope):
            fluid.io.save_inference_model(d, feed_names, [out], exe,
                                          main_program=main)
        del scope
        pred, launches = p18_bert_served(fluid, fa, d, rec)
        p18_bert_int8(fluid, d, pred, rec)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        p18_fleet(fluid, p18_mlp(fluid, d1, 1), p18_mlp(fluid, d2, 2), rec)
    p18_ctr(fluid, rec)
    rec["wall_s"] = time.perf_counter() - t0
    log("inference and serving " + json.dumps(rec))
    return launches


# -- phase 19: the PS tier over sockets, recovery, PS checkpoints, streaming -

# bench.py:689-832 at its TPU sizes: DeepFM (hidden (64,), lr 0.05) over 8
# loopback socket shards of a zero 2,097,152-row table, B = 4096, packed
# Adagrad on 106,496 rows a step, 36 steps of which 3 warm up; the
# aggregate arm (bench.py:851) trains a 67,108,864-row table 6 steps
# the socket arms' depth: cut from 36 steps to 18 for phase 26's time
# (the four arms without the hot cache took 11.6-16.4 s each on a slower
# host, ~180-280 ms a step)
P19_B, P19_VOCAB, P19_SHARDS, P19_STEPS, P19_WARMUP = (
    4096, 2_097_152, 8, 18, 3)
P19_ROWS = P19_B * 26
P19_ARMS = ((0, 0, 0, False), (2, 0, 0, False), (2, 1, 0, False),
            (2, 1, 2 * P19_ROWS, False), (2, 1, 0, True))
P19_BIG_VOCAB, P19_BIG_STEPS, P19_BIG_WARMUP = 67_108_864, 6, 2
# PS checkpoints inside the hot arm: a full save before step 2 (dirty
# rows in the slab), deltas before steps 3 and 5
P19_SAVE_AT, P19_DELTAS_AT = 2, (3, 5)
# the hot arm's depth: its host planning loop takes ~5-7 s a step on
# these uniform ids (PERF.md §6), so it runs the first 6 of the 36 steps
# (past the last delta) against an in-process run of the same 6: at 26
# steps the script read 944 s on a slower host, near its 1200 s limit,
# and phase 22 (pipelines) took its 10 steps down to 6
P19_HOT_STEPS = 6
# bench.py:926-1070: B = 1024 over 2 runner pservers of a 262,144-row
# table, SIGKILL shard 1, restart it 0.25 s later; cut from 18 steps
# (kill before step 8) to 12 (kill before step 5) for phase 22's time, and
# to 6 (kill before step 3) for phase 26's: the hot-cache runs take
# ~1.7 s a step (the arm took 53.3 s at 12 steps on the H100, 39.4 s at
# 8)
P19_KILL = {"batch": 1024, "vocab": 262_144, "steps": 6, "kill_step": 3,
            "restart_s": 0.25}
P19_KNOBS = {"PDTPU_PS_RETRIES": "60", "PDTPU_PS_RETRY_BACKOFF_MS": "20",
             "PDTPU_PS_TIMEOUT": "10"}
# bench.py:1938-2095 at its TPU sizes, cut from 600 steps to 375 (five
# AUC evaluations) for phase 22's time, and to 225 (three; ~10 s of the
# arm's 25.6 s at ~68 ms a step) for phase 26's
P19_ONLINE = {"vocab": 200_000, "cap": 16_384, "steps": 225, "batch": 256,
              "fields": 8, "d": 8, "mult": 2, "hot_ids": 5000,
              "staleness_s": 1.0, "sweep_every": 60, "delta_every": 75,
              "compact_every": 4, "eval_every": 75, "resident_steps": 30}
# phase 18's CTR serving model at 2,097,152 rows over 2 runner pservers
P19_SERVE = {"vocab": 2_097_152, "batches": 64, "batch": 8}
P19_RUNNER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "torch_ps_server_runner.py")


def p19_program(fluid, deepfm, cap, hot_rows):
    """bench.py's socket-arm DeepFM, its cache param [hot_rows + cap]."""
    from paddle_tpu_torch.core import unique_name

    with unique_name.guard():
        main, startup, _, loss, _ = deepfm.build_train_program(
            vocab_size=cap + hot_rows, lr=0.05, is_sparse=True,
            fused_table=True, embedding_optimizer="adagrad",
            packed_rows={"rows_per_step": cap}, hidden_sizes=(64,))
    main.random_seed = startup.random_seed = 2024
    return main, startup, loss


def p19_feeds(seed, n, b, vocab):
    rng = np.random.RandomState(seed)
    return [{"sparse_ids": rng.randint(0, vocab, (b, 26)).astype("int64"),
             "dense": rng.rand(b, 13).astype("float32"),
             "label": rng.randint(0, 2, (b, 1)).astype("float32")}
            for _ in range(n)]


def p19_rss_mb():
    """This process's resident set now (MiB), from /proc/self/status."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return None


def p19_profile_once(fn):
    """(fn(), {wall, device busy ms and share}) of one profiled call, held
    to the launch counters (`check_session`). The call is a training step,
    which another session would change, so a short session is not taken
    again: its reading is incomplete and carries no device numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    before = hand_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rec = note_session("p19 step", check_session(
        before, hand_launches(), session_records(prof)), 1)
    if rec["status"] not in ("checked", "unchecked"):
        return out, {"wall_ms": wall, "profile": "incomplete",
                     "device_busy_ms": None, "device_busy_share": None}
    busy = 0.0
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) is not None \
                and "cuda" in str(evt.device_type).lower():
            busy += _device_us(evt) / 1e3
    return out, {"wall_ms": wall, "profile": rec["status"],
                 "device_busy_ms": busy,
                 "device_busy_share": busy / wall if wall else None}


def p19_train(fluid, deepfm, fsa, table, feeds, pull_ahead, push_depth,
              hot_rows, warmup, hook=None, hook_steps=(),
              profile_last=True, keep=None):
    """The B = 4096 DeepFM step through PsEmbeddingTier over `table` on
    the card. Returns (losses, record); the row kernels are counted from 0
    over the run. `hook(i, tier, main, scope)` runs before step i; the
    steps in `hook_steps` (where it works) and the profiled last step are
    left out of the timed window. With a dict `keep`, the final table
    (after the flush; closing the tier closes the table) lands in
    keep["table"]."""
    import torch
    from paddle_tpu_torch.observability.registry import get_registry
    from paddle_tpu_torch.ps import PsEmbeddingTier, PsTableBinding

    reg = get_registry()
    main, startup, loss = p19_program(fluid, deepfm, P19_ROWS, hot_rows)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    tier = PsEmbeddingTier(main, [PsTableBinding(table.name, table,
                                                 ["sparse_ids"])],
                           pull_ahead=pull_ahead, push_depth=push_depth,
                           hot_rows=hot_rows, place=fluid.CUDAPlace(0))
    hit0 = reg.counter("ps/prefetch_hit").value
    miss0 = reg.counter("ps/prefetch_miss").value
    losses, marks, busy = [], [], None
    n = len(feeds)
    for k in fsa.KERNELS:                       # the path starts
        k.launches = 0
    try:
        for i, prep in enumerate(tier.steps(lambda: iter(feeds))):
            if hook is not None:
                hook(i, tier, main, scope)

            def step():
                (lv,) = tier.run_step(exe, prep, fetch_list=[loss],
                                      scope=scope)
                return float(lv)

            if profile_last and i == n - 1:
                lv, busy = p19_profile_once(step)
            else:
                lv = step()
            losses.append(lv)
            marks.append(time.perf_counter())
        tier.flush()
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in fsa.KERNELS}  # ends
        st = tier.stats()[table.name]
        if keep is not None:
            keep["table"] = table.dump_full()
    finally:
        tier.close()
    end = n - 2 if profile_last else n - 1
    timed = np.array([marks[i] - marks[i - 1]
                      for i in range(warmup, end + 1)
                      if i not in hook_steps]) * 1e3
    rec = {"examples_per_s": P19_B * timed.size / (timed.sum() / 1e3),
           "median_step_ms": float(np.median(timed)),
           "prefetch_hits": reg.counter("ps/prefetch_hit").value - hit0,
           "prefetch_misses": reg.counter("ps/prefetch_miss").value - miss0,
           "per_shard_bytes": [{"pulled": s["bytes_pulled"],
                                "pushed": s["bytes_pushed"]}
                               for s in st["shards"]],
           "launches": launches, "warm_step": busy}
    if st.get("hot_cache") is not None:
        hc = st["hot_cache"]
        rec["hot_cache"] = {k: hc[k] for k in (
            "hit_rate", "lookup_hit_rate", "evictions", "writeback_bytes",
            "resident", "dirty")}
    return losses, rec


def p19_socket_table(name, vocab, n_shards):
    """`n_shards` in-thread loopback ShardServers of a zero table, with a
    second client set for pushes (bench.py's dual channel)."""
    from paddle_tpu_torch.ps import (RangeSpec, ShardServer, ShardedTable,
                                     SocketClient, make_shards)

    spec = RangeSpec.even(vocab, n_shards)
    servers = [ShardServer([sh]).serve_in_thread()
               for sh in make_shards(name, spec)]
    table = ShardedTable(
        name, spec, [SocketClient(s.endpoint) for s in servers],
        push_clients=[SocketClient(s.endpoint) for s in servers])
    return table, servers


def p19_scrape_hook(scraper, at, out):
    """A hook taking the scraper's last sweep (or one now) before step
    `at`, while the shards answer."""
    def hook(i, tier, main, scope):
        if i == at:
            out["scrape"] = scraper.last() or scraper.scrape_once()
    return hook


def p19_checkpoint_hook(fluid, fsa, table, ckdir, out):
    """Arm 3 inside the hot arm: save(ps_tables=) before P19_SAVE_AT with
    dirty slab rows (flushed through the row-13 gather), then a delta
    before each of P19_DELTAS_AT; keeps the live table after the last."""
    from paddle_tpu_torch.parallel import Checkpointer

    ck = Checkpointer(ckdir, keep=2)
    out["ck"] = ck

    def hook(i, tier, main, scope):
        if i == P19_SAVE_AT:
            dirty = tier.stats()[table.name]["hot_cache"]["dirty"]
            g0 = fsa.fused_row_gather.launches
            t0 = time.perf_counter()
            ck.save(i, program=main, scope=scope,
                    ps_tables={table.name: table})
            out["save_held_ms"] = (time.perf_counter() - t0) * 1e3
            out["dirty_rows_at_save"] = dirty
            out["save_gather_launches"] = (fsa.fused_row_gather.launches
                                           - g0)
        elif i in P19_DELTAS_AT:
            t0 = time.perf_counter()
            ck.save_delta(i, {table.name: table}, blocking=True)
            out.setdefault("delta_ms", []).append(
                (time.perf_counter() - t0) * 1e3)
            out.setdefault("delta_bytes", []).append(os.path.getsize(
                ck._delta_path(P19_SAVE_AT, i)))
            if i == P19_DELTAS_AT[-1]:
                out["live"] = table.dump_full()

    return hook


def p19_sockets(fluid, fsa, rec):
    """Arms 1 and 3: DeepFM over 8 socket shards in five arms, each
    bitwise equal to an in-process run on the same feeds; PS checkpoints
    in the hot arm; then the 67,108,864-row aggregate table."""
    import threading

    import torch
    from paddle_tpu_torch.models import deepfm
    from paddle_tpu_torch.observability.federate import (FederatedScraper,
                                                         ScrapeTarget)
    from paddle_tpu_torch.ps import RangeSpec, ShardedTable

    feeds = p19_feeds(3, P19_STEPS, P19_B, P19_VOCAB)
    ref_table = ShardedTable.build_in_process(
        "fm_t", RangeSpec.even(P19_VOCAB, P19_SHARDS))
    keep = {}
    t0 = time.perf_counter()
    ref_losses, ref_rec = p19_train(fluid, deepfm, fsa, ref_table, feeds,
                                    0, 0, 0, P19_WARMUP, profile_last=False,
                                    keep=keep)
    ref_final = keep.pop("table")
    ref_rec["wall_s"] = time.perf_counter() - t0
    rec["in_process_reference"] = {k: ref_rec[k] for k in (
        "examples_per_s", "median_step_ms", "wall_s")}
    log("ps tier: in-process reference "
        + json.dumps(rec["in_process_reference"]))
    # the hot arm's reference: the same in-process run cut to its depth
    hot_feeds = feeds[:P19_HOT_STEPS]
    hot_ref_losses, _ = p19_train(
        fluid, deepfm, fsa, ShardedTable.build_in_process(
            "fm_t", RangeSpec.even(P19_VOCAB, P19_SHARDS)), hot_feeds,
        0, 0, 0, P19_WARMUP, profile_last=False, keep=keep)
    hot_ref_final = keep.pop("table")
    arms, ck_out = [], {}
    for pull_ahead, push_depth, hot_rows, scrape in P19_ARMS:
        t_arm = time.perf_counter()
        arm_feeds, want_losses, want_final = (
            (hot_feeds, hot_ref_losses, hot_ref_final) if hot_rows
            else (feeds, ref_losses, ref_final))
        table, servers = p19_socket_table("fm_t", P19_VOCAB, P19_SHARDS)
        scraper = doc = None
        if scrape:
            scraper = FederatedScraper(
                [ScrapeTarget.local(name="trainer", role="trainer")]
                + [ScrapeTarget.ps(s.endpoint, shard=i)
                   for i, s in enumerate(servers)],
                interval_s=1.0).start()
        hook = None
        tmp = None
        if hot_rows:
            tmp = tempfile.TemporaryDirectory()
            hook = p19_checkpoint_hook(fluid, fsa, table, tmp.name, ck_out)
        try:
            if scraper is not None:
                # the tier closes the table; take the doc while it trains
                hook = p19_scrape_hook(scraper, P19_STEPS - 1, keep)
            losses, r = p19_train(fluid, deepfm, fsa, table, arm_feeds,
                                  pull_ahead, push_depth, hot_rows,
                                  P19_WARMUP, hook=hook,
                                  hook_steps=(P19_SAVE_AT,) + P19_DELTAS_AT
                                  if hot_rows else (), keep=keep)
            doc = keep.pop("scrape", None)
            final_equal = bool(np.array_equal(keep.pop("table"),
                                              want_final))
        finally:
            if scraper is not None:
                scraper.stop()
            for s in servers:
                s.stop()
        r.update(wall_s=time.perf_counter() - t_arm,
                 pull_ahead=pull_ahead, push_depth=push_depth,
                 hot_rows=hot_rows, scraper_hz=1.0 if scrape else 0.0,
                 steps=len(arm_feeds), losses_bitwise=losses == want_losses,
                 shards_bitwise=final_equal)
        if doc is not None:
            r["scrape"] = {"ok": doc["ok"], "targets": len(doc["targets"]),
                           "signals": doc["signals"]}
        launches = r["launches"]
        if not (r["losses_bitwise"] and final_equal):
            raise AssertionError(
                f"ps sockets arm {(pull_ahead, push_depth, hot_rows)}: not "
                f"bitwise ({losses[:3]} vs {want_losses[:3]})")
        if launches["fused_adagrad_update"] != len(arm_feeds):
            raise AssertionError(f"ps sockets: row 12 launched {launches}")
        if hot_rows and not (launches["fused_row_gather"]
                             and launches["fused_row_scatter"]):
            raise AssertionError(f"ps sockets hot arm: rows 13-14 launched "
                                 f"{launches}")
        if scrape and not (doc and doc["ok"]):
            raise AssertionError(f"ps sockets: the scrape failed {doc}")
        arms.append(r)
        log(f"ps tier: socket arm {(pull_ahead, push_depth, hot_rows, scrape)} "
            + json.dumps({k: v for k, v in r.items()
                          if k != "per_shard_bytes"}, default=str))
        if hot_rows:
            # arm 3: the chain restores bitwise onto 3 in-process shards
            fresh = ShardedTable.build_in_process(
                "fm_t", RangeSpec.even(P19_VOCAB, 3))
            t0 = time.perf_counter()
            got = ck_out["ck"].restore(program=fluid.Program(),
                                       scope=fluid.Scope(),
                                       ps_tables={"fm_t": fresh},
                                       place=fluid.CUDAPlace(0))
            restore_ms = (time.perf_counter() - t0) * 1e3
            same = bool(np.array_equal(fresh.dump_full(), ck_out["live"]))
            fresh.close()
            ck_out["full_bytes"] = sum(
                os.path.getsize(os.path.join(tmp.name, f))
                for f in os.listdir(tmp.name)
                if f.startswith(f"ckpt-{P19_SAVE_AT}."))
            tmp.cleanup()
            ck_rec = {k: v for k, v in ck_out.items()
                      if k not in ("ck", "live")}
            ck_rec.update(restored_step=got, restore_ms=restore_ms,
                          restore_bitwise=same)
            rec["ps_checkpoints"] = ck_rec
            log("ps tier: checkpoints " + json.dumps(ck_rec))
            if not (same and got == P19_SAVE_AT
                    and ck_rec["save_gather_launches"] > 0
                    and ck_rec["dirty_rows_at_save"] > 0):
                raise AssertionError(f"ps checkpoints: {ck_rec}")
            ck_out.clear()
        torch.cuda.empty_cache()
    rec["socket_arms"] = arms
    plain, scraped = arms[2]["median_step_ms"], arms[4]["median_step_ms"]
    rec["scraper_step_ms_vs_plain"] = {"scraped": scraped, "plain": plain,
                                       "ratio": scraped / plain}

    # the aggregate table, host memory only (rows touched commit pages)
    big_feeds = p19_feeds(5, P19_BIG_STEPS, P19_B, P19_BIG_VOCAB)
    rss = [p19_rss_mb()]
    stop = threading.Event()

    def sample():
        while not stop.wait(0.05):
            rss.append(p19_rss_mb())

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    table, servers = p19_socket_table("fm_t", P19_BIG_VOCAB, P19_SHARDS)
    try:
        losses, r = p19_train(fluid, deepfm, fsa, table, big_feeds, 2, 1, 0,
                              P19_BIG_WARMUP, profile_last=False)
    finally:
        stop.set()
        sampler.join()
        for s in servers:
            s.stop()
    import resource
    rec["aggregate"] = {
        "vocab": P19_BIG_VOCAB,
        "aggregate_gb": P19_BIG_VOCAB * 128 * 2 / 1e9,
        "losses_finite": bool(np.isfinite(losses).all()),
        "examples_per_s": r["examples_per_s"],
        "median_step_ms": r["median_step_ms"],
        "rss_mb_before": rss[0], "rss_mb_peak_during": max(rss),
        "process_peak_rss_mb": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1024.0}
    log("ps tier: aggregate " + json.dumps(rec["aggregate"]))
    if not rec["aggregate"]["losses_finite"]:
        raise AssertionError(f"ps aggregate table: losses {losses}")


def p19_launch_runner(tables, port=0):
    """One of the port's pserver runners (no torch): (process, endpoint)."""
    cmd = [sys.executable, P19_RUNNER, "--port", str(port)]
    for t in tables:
        cmd += ["--table", t]
    env = dict(os.environ)
    env.pop("PDTPU_FAULT_SPEC", None)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True, env=env)
    ep = proc.stdout.readline().strip()
    if not ep:
        proc.wait(timeout=30)
        raise AssertionError(f"pserver runner died at boot ({proc.returncode})")
    return proc, ep


def p19_stop_runners(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait(timeout=30)
        p.stdout.close()


def p19_kill_run(fluid, fsa, feeds, kill, hot_rows, ckdir):
    """Arm 2's run over 2 runner pservers with recovery armed (a full
    save at step 0); with `kill`, SIGKILL shard 1 before the kill step,
    restart it on its port 0.25 s later and watch /healthz through a
    ShardMonitor. Returns (losses, record)."""
    import threading

    from paddle_tpu_torch.models import deepfm
    from paddle_tpu_torch.observability.http import run_health_checks
    from paddle_tpu_torch.observability.registry import get_registry
    from paddle_tpu_torch.parallel import Checkpointer
    from paddle_tpu_torch.ps import (PsEmbeddingTier, PsTableBinding,
                                     RangeSpec, ShardMonitor, ShardedTable,
                                     SocketClient)

    v, b, ks = P19_KILL["vocab"], P19_KILL["batch"], P19_KILL["kill_step"]
    reg = get_registry()
    spec = RangeSpec.even(v, 2)
    procs, eps = [], []
    for i in range(2):
        lo, hi = spec.bounds(i)
        p, ep = p19_launch_runner([f"fm_t:{lo}:{hi}"])
        procs.append(p)
        eps.append(ep)
    table = ShardedTable("fm_t", spec, [SocketClient(ep) for ep in eps])
    main, startup, loss = p19_program(fluid, deepfm, b * 26, hot_rows)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    ck = Checkpointer(ckdir)
    ck.save(0, program=main, scope=scope, blocking=True,
            ps_tables={"fm_t": table})
    tier = PsEmbeddingTier(main, [PsTableBinding("fm_t", table,
                                                 ["sparse_ids"])],
                           pull_ahead=1, push_depth=0, hot_rows=hot_rows,
                           place=fluid.CUDAPlace(0))
    tier.attach_checkpointer(ck)
    rec0 = reg.counter("ps/recoveries").value
    retry0 = reg.counter("ps/rpc_retries").value
    mon = ShardMonitor.for_endpoints(eps, interval_s=0.05)
    seen, stop, t_kill = [], threading.Event(), [None]
    restarter = []

    def watch():
        last = None
        while not stop.wait(0.01):
            st = run_health_checks()[1].get("ps/shards", {}).get("status")
            if st != last:
                seen.append((st, time.perf_counter()))
                last = st

    watcher = threading.Thread(target=watch, daemon=True)
    losses, ms, journal = [], [], 0
    for k in fsa.KERNELS:                       # the path starts
        k.launches = 0
    try:
        with mon:
            watcher.start()
            for i, prep in enumerate(tier.steps(lambda: iter(feeds))):
                if kill and i == ks:
                    procs[1].kill()       # SIGKILL: a real preemption
                    procs[1].wait(timeout=30)
                    t_kill[0] = time.perf_counter()
                    lo1, hi1 = spec.bounds(1)
                    port1 = int(eps[1].rsplit(":", 1)[1])

                    def restart():
                        time.sleep(P19_KILL["restart_s"])
                        procs.append(p19_launch_runner(
                            [f"fm_t:{lo1}:{hi1}"], port=port1)[0])

                    t = threading.Thread(target=restart, daemon=True)
                    t.start()
                    restarter.append(t)
                t0 = time.perf_counter()
                (lv,) = tier.run_step(exe, prep, fetch_list=[loss],
                                      scope=scope)
                losses.append(float(lv))
                ms.append((time.perf_counter() - t0) * 1e3)
                journal = max(journal, table.journal_bytes())
            tier.flush()
            launches = {k.__name__: k.launches for k in fsa.KERNELS}
            time.sleep(0.2)
            stop.set()
            watcher.join()
    finally:
        tier.close()
        for t in restarter:
            t.join(timeout=30)
        p19_stop_runners(procs)
    healthy = [m for i, m in enumerate(ms) if i != ks]
    r = {"recoveries": reg.counter("ps/recoveries").value - rec0,
         "rpc_retries": reg.counter("ps/rpc_retries").value - retry0,
         "median_step_ms": float(np.median(healthy)),
         "recovery_pause_ms": ms[ks] - float(np.median(healthy)),
         "kill_step_ms": ms[ks], "journal_bytes_peak": journal,
         "launches": launches,
         "healthz": [(s, None if t_kill[0] is None
                      else (t - t_kill[0]) * 1e3) for s, t in seen]}
    return losses, r


def p19_recovery(fluid, fsa, rec):
    """Arm 2: a pserver SIGKILLed mid-run, with and without the hot
    cache: losses bitwise equal to the uninterrupted run, one recovery,
    /healthz ok -> degraded -> ok."""
    feeds = p19_feeds(7, P19_KILL["steps"], P19_KILL["batch"],
                      P19_KILL["vocab"])
    saved = {k: os.environ.get(k) for k in P19_KNOBS}
    os.environ.update(P19_KNOBS)
    out = {}
    try:
        for hot_rows in (0, 2 * P19_KILL["batch"] * 26):
            with tempfile.TemporaryDirectory() as d:
                base, rb = p19_kill_run(fluid, fsa, feeds, False, hot_rows,
                                        os.path.join(d, "base"))
                killed, rk = p19_kill_run(fluid, fsa, feeds, True, hot_rows,
                                          os.path.join(d, "kill"))
            states = [s for s, _ in rk["healthz"]]
            r = dict(rk, bitwise_equal=killed == base,
                     uninterrupted_median_step_ms=rb["median_step_ms"],
                     uninterrupted_recoveries=rb["recoveries"])
            out[f"hot_rows_{hot_rows}"] = r
            log(f"ps tier: recovery hot_rows {hot_rows} "
                + json.dumps(r, default=str))
            ok_seq = (states and states[0] == "ok" and "degraded" in states
                      and states[-1] == "ok"
                      and states.index("degraded") < len(states) - 1)
            if not (r["bitwise_equal"] and rk["recoveries"] == 1
                    and rb["recoveries"] == 0 and ok_seq):
                raise AssertionError(f"ps recovery (hot_rows {hot_rows}): "
                                     f"{r} {killed[:3]} vs {base[:3]}")
            if rk["launches"]["fused_adagrad_update"] != P19_KILL["steps"] \
                    or (hot_rows and not rk["launches"]["fused_row_gather"]):
                raise AssertionError(f"ps recovery: launches {rk}")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    rec["recovery"] = out


def p19_online(fluid, fsa, rec):
    """Arm 4: bench.py's online-learning cell on the card."""
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.initializer import RowPackInitializer
    from paddle_tpu_torch.param_attr import ParamAttr
    from paddle_tpu_torch.parallel import Checkpointer
    from paddle_tpu_torch.ps import (InProcessClient, PsEmbeddingTier,
                                     PsTableBinding, RangeSpec, ShardedTable,
                                     make_dynamic_shards)
    from paddle_tpu_torch.streaming import (DeltaPublisher, OnlineTrainer,
                                            StreamingDataset, eval_auc)

    o = P19_ONLINE
    vocab, cap, fields, d, mult = (o["vocab"], o["cap"], o["fields"],
                                   o["d"], o["mult"])
    rows_per_step = o["batch"] * fields
    w = np.random.RandomState(17).uniform(-1.0, 1.0, vocab)
    cfg = {"pool": None}

    def source():
        g = np.random.RandomState(18)
        while True:
            if cfg["pool"] is not None:
                ids = cfg["pool"][g.randint(0, cfg["pool"].size, fields)]
            elif g.uniform() < 0.9:
                ids = g.randint(0, o["hot_ids"], fields)
            else:
                ids = g.randint(0, vocab, fields)
            lbl = 1.0 if w[ids].sum() > 0 else 0.0
            yield {"ids": ids.astype("int64"),
                   "lbl": np.array([lbl], "float32")}

    def build(train):
        L = fluid.layers
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 2024
        with unique_name.guard(), fluid.program_guard(main, startup):
            ids = L.data("ids", [fields], dtype="int64")
            emb = L.embedding(
                ids, [rows_per_step, d * mult], is_sparse=True,
                row_pack=True, param_attr=ParamAttr(
                    name="ol_t", initializer=RowPackInitializer(
                        d, d * mult, -0.01, 0.01)))
            emb = L.slice(emb, axes=[2], starts=[0], ends=[d])
            score = L.reshape(L.reduce_sum(emb, dim=[1, 2]), [-1, 1])
            if not train:
                return main, startup, score
            lbl = L.data("lbl", [1], dtype="float32")
            loss = L.mean(L.square_error_cost(score, lbl))
            fluid.optimizer.Adagrad(
                0.1, packed_rows={"rows_per_step": rows_per_step}).minimize(
                loss)
        return main, startup, loss

    def shards_of():
        return make_dynamic_shards("ol_t", RangeSpec.even(vocab, 2),
                                   capacity_per_shard=cap,
                                   high_watermark=0.9, low_watermark=0.7,
                                   keep_freq=3)

    spec = RangeSpec.even(vocab, 2)
    shards = shards_of()
    table = ShardedTable("ol_t", spec, [InProcessClient([s])
                                        for s in shards])
    r = {}
    with tempfile.TemporaryDirectory() as work:
        imain, istart, iscore = build(False)
        iexe = fluid.Executor(fluid.CUDAPlace(0))
        isc = fluid.Scope()
        iexe.run(istart, scope=isc)
        with fluid.scope_guard(isc):
            fluid.io.save_inference_model(os.path.join(work, "m"), ["ids"],
                                          [iscore], iexe, main_program=imain)
        ps = inference.PsLookupPredictor(
            inference.create_predictor(inference.Config(
                os.path.join(work, "m"))),
            [inference.PsLookupBinding("ol_t", table, ["ids"])],
            cache_rows_per_table=2 * cap)
        pub = DeltaPublisher(table, staleness_s=o["staleness_s"])
        pub.attach_predictor(ps)
        ds = StreamingDataset(source, batch_size=o["batch"],
                              held_out_every=7, eval_window=64 * o["batch"])
        main, startup, loss = build(True)
        exe = fluid.Executor(fluid.CUDAPlace(0))
        sc = fluid.Scope()
        exe.run(startup, scope=sc)
        ckdir = os.path.join(work, "ck")
        ck = Checkpointer(ckdir, keep=4)
        ck.save(0, program=main, scope=sc, blocking=True,
                ps_tables={"ol_t": table})
        tier = PsEmbeddingTier(main, [PsTableBinding("ol_t", table,
                                                     ["ids"])],
                               pull_ahead=1, push_depth=0,
                               place=fluid.CUDAPlace(0))
        trainer = OnlineTrainer(
            exe, main, tier, ds, fetch_list=[loss], scope=sc,
            ps_tables={"ol_t": table}, checkpointer=ck, publishers=[pub],
            sweep_every=o["sweep_every"], delta_every=o["delta_every"],
            compact_every=o["compact_every"], eval_every=o["eval_every"],
            eval_fn=lambda: eval_auc(
                ds, lambda f: ps.run({"ids": f["ids"]})[0], "lbl"))
        for k in fsa.KERNELS:                   # the path starts
            k.launches = 0
        try:
            t0 = time.perf_counter()
            trainer.run(max_steps=o["steps"])
            trainer.finish()
            elapsed = time.perf_counter() - t0
            launches = {k.__name__: k.launches for k in fsa.KERNELS}
            sstats = [s.stats() for s in shards]
            # the serving cache against the shards, on the rows the
            # trainer pushed and the shards still hold: the publisher's
            # contract. A row a shard evicted keeps its last pushed bytes
            # in the cache; one the shard re-materialized without a push
            # since (a pull of the prefetched batch past the last step, or
            # a pull between an eviction and the next push) holds its
            # zero init row there. Pulling an evicted id would
            # re-materialize it, so only shard-resident ids are read.
            cache = ps._caches["ol_t"]
            res_uids, _ = cache._slots.residents()
            live = np.concatenate([s._slots.residents()[0] for s in shards])
            uids = np.sort(np.intersect1d(res_uids.astype(np.int64),
                                          live.astype(np.int64)))
            got, miss = cache.lookup(uids)
            want = table.pull(uids)
            pushed = want.any(axis=1)
            fresh = bool(uids.size and not miss.any() and np.array_equal(
                got[pushed], want[pushed]))
            cache_evicted = int(res_uids.size - uids.size)
            cache_init = int((~pushed).sum())
            cache_init_equal = int((got[~pushed] == want[~pushed]).all(
                axis=1).sum())
            stale = pub.staleness_percentiles()
            e2e = ps.staleness_e2e_percentiles()
            files = os.listdir(ckdir)
            full_b = [os.path.getsize(os.path.join(ckdir, f)) for f in files
                      if f.startswith("ckpt-") and ".shards-" in f]
            delta_b = [os.path.getsize(os.path.join(ckdir, f)) for f in files
                       if f.startswith("delta-") and f.endswith(".pkl")]
            # the delta chain: a compaction on the post-sweep state, then
            # steps over resident ids only (no admission, no eviction) and
            # a delta; its restore against the table dumped at that step
            tier.flush()
            ck.save(trainer.step, program=main, scope=sc, blocking=True,
                    ps_tables={"ol_t": table})
            base_step = trainer.step
            cfg["pool"] = np.sort(np.concatenate(
                [s._slots.residents()[0] for s in shards]).astype(np.int64))
            trainer.sweep_every = trainer.eval_every = 0
            trainer.delta_every = 0
            trainer.run(max_steps=o["resident_steps"])
            tier.flush()
            ck.save_delta(trainer.step, {"ol_t": table}, blocking=True)
            expected = table.dump_full()
            back = shards_of()
            back_t = ShardedTable("ol_t", spec, [InProcessClient([s])
                                                 for s in back])
            restored = ck.restore(program=main, scope=fluid.Scope(),
                                  ps_tables={"ol_t": back_t},
                                  place=fluid.CUDAPlace(0))
            chain_equal = bool(restored == base_step and np.array_equal(
                back_t.dump_full(), expected))
            loaded, _, _ = ck.load_ps_table("ol_t")
            chain_equal = chain_equal and bool(np.array_equal(loaded,
                                                              expected))
            chain_delta = os.path.getsize(ck._delta_path(base_step,
                                                         trainer.step))
        finally:
            tier.close()
            pub.close()
    mat = sum(s["materialized"] for s in sstats)
    evicted = sum(s["evicted"] for s in sstats)
    aucs = [(s, v) for s, v in trainer.history["eval"] if not np.isnan(v)]
    r.update({
        "steps": o["steps"], "examples_per_s": o["steps"] * o["batch"]
        / elapsed, "auc_trajectory": aucs, "materialized": mat,
        "evicted": evicted, "provisioned_rows": 2 * cap,
        "live_rows": [s["live_rows"] for s in sstats],
        "rows_materialized_per_min": mat * 60.0 / elapsed,
        "rows_evicted_per_min": evicted * 60.0 / elapsed,
        "full_bytes": float(np.mean(full_b)) if full_b else None,
        "delta_bytes": delta_b, "chain_delta_bytes": chain_delta,
        "staleness_ms": stale, "staleness_e2e_ms": e2e,
        "serving_cache_rows_checked": int(pushed.sum()),
        "serving_cache_rows_evicted_from_shards": cache_evicted,
        "serving_cache_rows_init_in_shards": cache_init,
        "of_which_equal": cache_init_equal,
        "serving_fresh": fresh,
        "chain_restore_bitwise": chain_equal,
        "launches": launches})
    rec["online"] = r
    log("ps tier: online " + json.dumps(r, default=str))
    ok = (len(aucs) >= 2 and aucs[-1][1] > aucs[0][1]
          and mat > 2 * cap and all(s["live_rows"] <= cap for s in sstats)
          and stale["p99"] is not None
          and stale["p99"] <= o["staleness_s"] * 1e3 and fresh
          and chain_equal
          and launches["fused_adagrad_update"] == o["steps"])
    if not ok:
        raise AssertionError(f"online learning: {r}")


def p19_serving(fluid, rec):
    """Arm 5: phase 18's CTR model at 2,097,152 rows, its seeded table
    loaded over the wire into 2 runner pservers; 2 ProcessReplicas with
    --ps-endpoints on the card against a ThreadReplica over an in-process
    table of the same bytes; then ps_admin against the live endpoints
    where torch cannot be imported."""
    import threading

    import torch
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.ps import RangeSpec, ShardedTable, SocketClient
    from paddle_tpu_torch.serving.fleet import ModelRegistry
    from paddle_tpu_torch.serving.fleet.replica import (ProcessReplica,
                                                        ThreadReplica)

    v, b, fields, dim = (P19_SERVE["vocab"], P19_SERVE["batch"],
                         CTR["fields"], CTR["dim"])
    vis = np.random.RandomState(7).uniform(-1, 1, (v, dim)).astype("float32")
    host = p18_packed_rows(vis)
    del vis
    spec = RangeSpec.even(v, 2)
    procs, eps = [], []
    r = {"vocab": v}
    local = reps = None
    with tempfile.TemporaryDirectory() as d_ps:
        try:
            for i in range(2):
                lo, hi = spec.bounds(i)
                p, ep = p19_launch_runner([f"tb:{lo}:{hi}"])
                procs.append(p)
                eps.append(ep)
            wire = ShardedTable("tb", spec, [SocketClient(ep) for ep in eps])
            t0 = time.perf_counter()
            wire.load_full(host)
            r["load_over_wire_s"] = time.perf_counter() - t0
            wire.close()
            local = ShardedTable.build_in_process("tb", spec,
                                                  full_rows=host)
            del host
            p18_ctr_models(fluid, d_ps)
            mv = ModelRegistry().register("ctr", d_ps)

            def factory(model):
                return inference.PsLookupPredictor(
                    inference.create_predictor(inference.Config(
                        model.model_dir)),
                    [inference.PsLookupBinding("tb", local, ["ids"])],
                    cache_rows_per_table=CTR["cache"])

            t0 = time.perf_counter()
            args = ["--ps-endpoints", ",".join(eps), "--ps-table",
                    f"tb=tb:{v}", "--ps-cache-rows", str(CTR["cache"])]
            reps = [ProcessReplica(f"ps{i}", mv, buckets=(b,),
                                   extra_args=args,
                                   server_kwargs={"max_batch_delay_ms": 1.0},
                                   device=FLEET_WORKER_DEVICE)
                    for i in range(2)]
            thread = ThreadReplica("t0", mv, buckets=(b,),
                                   predictor_factory=factory,
                                   server_kwargs={"max_batch_delay_ms": 1.0})
            reps.append(thread)
            for rp in reps[:2]:
                rp.wait_ready(600)
            r["replicas_ready_s"] = time.perf_counter() - t0
            rng = np.random.RandomState(3)
            batches = [(rng.randint(0, v, (b, fields)) if k < 32 else
                        (rng.zipf(1.5, (b, fields)) - 1) % v).astype("int64")
                       for k in range(P19_SERVE["batches"])]
            ms, equal = [], 0
            for k, ids in enumerate(batches):
                t0 = time.perf_counter()
                got = reps[k % 2].submit({"ids": ids}).result(timeout=120)
                ms.append((time.perf_counter() - t0) * 1e3)
                want = thread.submit({"ids": ids}).result(timeout=120)
                equal += int(len(got) == len(want) and all(
                    np.array_equal(x, y) for x, y in zip(got, want)))
            r.update(bitwise_equal=f"{equal}/{len(batches)}",
                     request_ms=med_range(ms))
            # ps_admin where torch (and JAX) cannot be imported
            poison = os.path.join(d_ps, "poison")
            for name in ("torch", "jax"):
                os.makedirs(os.path.join(poison, name))
                with open(os.path.join(poison, name, "__init__.py"),
                          "w") as f:
                    f.write(f"raise ImportError('{name} is not for "
                            "ps_admin')\n")
            root = os.path.dirname(os.path.abspath(__file__))
            env = dict(os.environ, PYTHONPATH=os.pathsep.join(
                [poison, root]))
            admin = {}
            for cmd in ("stats", "dump-health", "fleet"):
                res = subprocess.run(
                    [sys.executable, "-m", "paddle_tpu_torch.tools.ps_admin",
                     cmd, "--endpoints", ",".join(eps), "--json"],
                    cwd=d_ps, env=env, capture_output=True, text=True,
                    timeout=120)
                admin[cmd] = res.returncode
                if res.returncode != 0:
                    raise AssertionError(f"ps_admin {cmd}: rc "
                                         f"{res.returncode} {res.stderr}")
                if cmd == "dump-health":
                    doc = json.loads(res.stdout)
                    admin["status"] = doc["status"]
            r["ps_admin_rc"] = admin
        finally:
            for rp in reps or ():
                rp.stop()
            if local is not None:
                local.close()
            p19_stop_runners(procs)
            torch.cuda.empty_cache()
    rec["serving"] = r
    log("ps tier: serving " + json.dumps(r, default=str))
    if equal != len(batches):
        raise AssertionError(f"ps serving from sockets: {r}")


def phase_ps_tier_and_streaming(fluid, fsa, smi):
    """Phase 19: the PS tier over sockets, recovery, PS checkpoints,
    streaming and serving from socket shards (module docstring). Prints
    one JSON line."""
    import torch

    t0 = time.perf_counter()
    rec = {"device": smi, "arm_s": {}}
    for name, arm in (("sockets", lambda: p19_sockets(fluid, fsa, rec)),
                      ("recovery", lambda: p19_recovery(fluid, fsa, rec)),
                      ("online", lambda: p19_online(fluid, fsa, rec)),
                      ("serving", lambda: p19_serving(fluid, rec))):
        t1 = time.perf_counter()
        arm()
        rec["arm_s"][name] = time.perf_counter() - t1
        log(f"ps tier: {name} took {rec['arm_s'][name]:.1f} s")
        torch.cuda.empty_cache()
    rec["wall_s"] = time.perf_counter() - t0
    log("ps tier and streaming " + json.dumps(rec, default=str))


# -- phase 20: data and sequence parallelism on an NCCL group ---------------
# BERT-base bf16 AMP at T = 512, B = 8 a rank, Adam, dropout 0, 4 steps a
# run; ResNet-50 bf16 at B = 128 a rank, Momentum, 3 steps a run; the ring
# at B = 1, 12 heads, d = 64: bf16 at T = 32,768 over sp = 8 blocks, f32 at
# T = 4,096 over sp = 4
P20_BERT_STEPS, P20_RESNET_STEPS, P20_BERT_LAYERS = 4, 3, 12
P20_WARM = 6   # timed steps after the checked ones
P20_RING = (1, 12, 32768, 64, 8)
P20_RING_F32 = (1, 12, 4096, 64, 4)


def p20_free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def p20_rows(feed, rank, world):
    """This rank's rows of a global feed dict (numpy or tensors)."""
    out = {}
    for k, v in feed.items():
        n = v.shape[0] // world
        out[k] = v[rank * n:(rank + 1) * n]
    return out


def p20_collectives(rank, world):
    """A round-trip of every collective on the card, values checked."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from paddle_tpu_torch.parallel import (all_gather, all_reduce, all_to_all,
                                           barrier, broadcast, make_mesh,
                                           reduce_scatter)
    from paddle_tpu_torch.parallel import collective as C

    mesh = make_mesh({"dp": world})
    x = torch.arange(2 * world, dtype=torch.float32, device="cuda")
    xs = DTensor.from_local(x[2 * rank:2 * rank + 2].clone(), mesh,
                            [Shard(0)], run_check=False)
    ones = DTensor.from_local(torch.ones(2 * world, device="cuda"), mesh,
                              [Replicate()], run_check=False)
    got = {
        "all_reduce": all_reduce(xs, mesh, "dp").to_local(),
        "all_gather": all_gather(xs, mesh, "dp").to_local(),
        "broadcast": broadcast(xs, mesh, "dp", root=world - 1).to_local(),
        "reduce_scatter": reduce_scatter(ones, mesh, "dp").to_local(),
        "all_to_all": all_to_all(DTensor.from_local(
            torch.arange(world, dtype=torch.float32, device="cuda")
            .reshape(-1, 1) + 100 * rank, mesh, [Shard(0)],
            run_check=False), mesh, "dp", 0, 0).to_local().reshape(-1),
        "psum": C.psum(torch.full((2,), float(rank), device="cuda"),
                       (mesh, "dp")),
        "ppermute": C.ppermute(x[:2] + rank, (mesh, "dp"),
                               [(i, (i + 1) % world) for i in range(world)]),
    }
    barrier(mesh)
    want = {
        "all_reduce": x.reshape(world, 2).sum(0),
        "all_gather": x,
        "broadcast": x[2 * (world - 1):2 * world],
        "reduce_scatter": torch.full((2,), float(world), device="cuda"),
        "all_to_all": torch.tensor([rank + 100.0 * s for s in range(world)],
                                   device="cuda"),
        "psum": torch.full((2,), float(sum(range(world))), device="cuda"),
        "ppermute": x[:2] + (rank - 1) % world,
    }
    bad = [k for k in want if not torch.equal(got[k].float(), want[k])]
    if bad:
        raise AssertionError(f"collectives on the card disagree: {bad}")
    return sorted(want) + ["barrier"]


def p20_logical_params(main, scope):
    """The trainable parameters as one device sees them (a sharded one
    gathered whole, pad dropped)."""
    from paddle_tpu_torch.core.mesh_step import logical_value

    return {p.name: logical_value(main, p.name,
                                  scope.find_var(p.name)).clone()
            for p in main.all_parameters()}


def p20_run(fluid, build, feed, steps, stage, rank, world):
    """One run of `build()` from its startup: the plain Executor on the
    whole batch (stage None) or with_data_parallel at ZeRO `stage` on this
    rank's rows. Returns (loss bytes a step, final params, record)."""
    import torch

    from paddle_tpu_torch.observability.registry import get_registry

    main, startup, loss = build()
    exe = fluid.Executor(fluid.CUDAPlace(torch.cuda.current_device()))
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        prog, fd = main, feed
        if stage is not None:
            bs = fluid.BuildStrategy()
            bs.sharding_strategy = stage
            prog = fluid.CompiledProgram(main).with_data_parallel(
                loss_name=loss.name, build_strategy=bs)
            fd = p20_rows(feed, rank, world)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ms = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            (lv,) = exe.run(prog, feed=fd, fetch_list=[loss])
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(np.asarray(lv, np.float32).tobytes())
        peak = torch.cuda.max_memory_allocated() / 2**20
        params = p20_logical_params(main, scope)
        warm = []   # the step time: P20_WARM more steps, each synced
        for _ in range(P20_WARM):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            exe.run(prog, feed=fd, fetch_list=[loss])
            torch.cuda.synchronize()
            warm.append((time.perf_counter() - t0) * 1e3)
        state = None
        if stage is not None:  # the executor's gauge: bytes this rank holds
            state = get_registry().gauge(
                "memory/state_bytes_per_device").value
    rec = {"stage": "plain" if stage is None else stage,
           "losses": [float(np.frombuffer(b, np.float32)[0])
                      for b in losses],
           "step_ms": ms, "warm_ms": warm,
           "warm_median_ms": float(np.median(warm)),
           "peak_MiB": peak, "state_bytes_per_rank": state}
    return losses, params, rec


def p20_model_runs(fluid, label, build, feed, steps, rank, world,
                   counters):
    """The plain run (world 1 only) and stages off, 1, 2, 3 (or `stages`);
    losses and final parameters bitwise equal to the first. The counters
    are zeroed before the first mesh run and read after the last. Returns
    (records, counts)."""
    import torch

    stages = (0, 1, 2, 3) if label == "bert" else (0, 3)
    recs, ref = [], None
    if world == 1:
        losses, params, rec = p20_run(fluid, build, feed, steps, None, rank,
                                      world)
        ref = (losses, params)
        recs.append(rec)
    counters("reset")
    for stage in stages:
        losses, params, rec = p20_run(fluid, build, feed, steps, stage, rank,
                                      world)
        recs.append(rec)
        if ref is None:
            ref = (losses, params)
            continue
        same_params = all(torch.equal(params[k], ref[1][k])
                          for k in ref[1])
        if losses != ref[0] or not same_params:
            raise AssertionError(
                f"{label} stage {stage}: losses or final parameters differ "
                f"from the first run (losses {rec['losses']} vs "
                f"{[float(np.frombuffer(b, np.float32)[0]) for b in ref[0]]},"
                f" parameters equal: {same_params})")
        del params
        torch.cuda.empty_cache()
    return recs, counters("read")


def p20_flash_counters(fa):
    def counters(op):
        if op == "reset":
            for f in (fa.flash_attention_fwd, fa.flash_attention_bwd):
                f.launches = f.plain_on_cuda = 0
            return None
        return {"fwd": fa.flash_attention_fwd.launches,
                "bwd": fa.flash_attention_bwd.launches,
                "plain_on_cuda": fa.flash_attention_fwd.plain_on_cuda
                + fa.flash_attention_bwd.plain_on_cuda}
    return counters


def p20_bn_counters(fb):
    def counters(op):
        if op == "reset":
            reset_bn_counts(fb)
            return None
        return bn_counts(fb)
    return counters


def p20_mesh(fluid, fa, fb, rank, world):
    """What every rank runs, in one order: the collectives, BERT-base and
    ResNet-50 under with_data_parallel, the public ring and Ulysses
    attention on the group. Returns the record."""
    import torch
    from paddle_tpu_torch.models import bert

    rec = {"world": world, "collectives": p20_collectives(rank, world)}
    rng = np.random.RandomState(20)
    bert_feed_all = pretrain_feed(B * world, 512, rng)

    def build_bert():
        return build_pretrain(fluid, bert, B * world, 512, True,
                              layers=P20_BERT_LAYERS, dropout=0.0)

    rec["bert"], rec["bert_launches"] = p20_model_runs(
        fluid, "bert", build_bert, bert_feed_all, P20_BERT_STEPS, rank,
        world, p20_flash_counters(fa))
    want = 4 * (P20_BERT_STEPS + P20_WARM) * P20_BERT_LAYERS
    got = rec["bert_launches"]
    if got != {"fwd": want, "bwd": want, "plain_on_cuda": 0}:
        raise AssertionError(f"bert under with_data_parallel: flash "
                             f"launches {got}, expected {want} each and no "
                             f"plain call on the card")
    torch.cuda.empty_cache()
    from paddle_tpu_torch.models import resnet

    os.environ["PDTPU_BN_MODE"] = "pallas"
    img = resnet_feed(RESNET_B * world, RESNET_HW)

    def build_resnet():
        return resnet_program(fluid, resnet, RESNET_B * world, RESNET_HW,
                              True)

    rec["resnet"], rec["resnet_launches"] = p20_model_runs(
        fluid, "resnet", build_resnet, img, P20_RESNET_STEPS, rank, world,
        p20_bn_counters(fb))
    per_run = {k: v * (P20_RESNET_STEPS + P20_WARM) * 2
               for k, v in RESNET_PER_STEP.items()}
    if rec["resnet_launches"] != per_run:
        raise AssertionError(f"resnet under with_data_parallel: fused-BN "
                             f"launches {rec['resnet_launches']}, expected "
                             f"{per_run}")
    torch.cuda.empty_cache()
    rec["public_sp"] = p20_public_sp(fa, rank, world)
    return rec


def p20_public_sp(fa, rank, world):
    """ring_self_attention (impl "auto": the kernels) and ulysses_attention
    on the group's sp axis, against the whole sequence on one card."""
    import torch

    from paddle_tpu_torch.parallel import (make_mesh, ring_self_attention,
                                           ulysses_attention)

    mesh = make_mesh({"sp": world})
    b, h, t, d = 2, 12, 512 * world, 64
    gen = torch.Generator("cuda").manual_seed(7)
    q, k, v = (torch.randn(b, h, t, d, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    tl = t // world
    mine = [x[:, :, rank * tl:(rank + 1) * tl] for x in (q, k, v)]
    fwd_fn = fa.flash_attention_fwd
    before = (fwd_fn.launches, fwd_fn.plain_on_cuda)
    ring = ring_self_attention(*mine, mesh, "sp", causal=True)
    launched = fwd_fn.launches - before[0]
    plain = fwd_fn.plain_on_cuda - before[1]
    uly = ulysses_attention(*mine, mesh, "sp", causal=True)
    saved = fwd_fn.launches
    whole, _ = fwd_fn(q, k, v, None, True)
    fwd_fn.launches = saved   # a check, not the path
    want = whole[:, :, rank * tl:(rank + 1) * tl].float()

    def rel(got):
        return float(torch.linalg.vector_norm(got.float() - want)
                     / torch.linalg.vector_norm(want))

    e_ring, e_uly = rel(ring), rel(uly)
    # causal: rank r attends its own block and the r before it; Ulysses
    # attends with torch.matmul in bf16 (as the JAX package's einsum)
    if not (e_ring <= P20_OUT_REL["bfloat16"]
            and e_uly <= P20_OUT_REL["bfloat16"]
            and launched == rank + 1 and plain == 0):
        raise AssertionError(f"public ring/Ulysses on the card: relative "
                             f"errors {e_ring}, {e_uly}; ring launches "
                             f"{launched} (expected {rank + 1}), plain on "
                             f"the card {plain}")
    return {"shape": f"B={b} H={h} T={t} d={d} causal bf16",
            "ring_rel_norm_err": e_ring, "ulysses_rel_norm_err": e_uly,
            "ring_max_abs_err": float((ring.float() - want).abs().max()),
            "ulysses_max_abs_err": float((uly.float() - want).abs().max()),
            "ring_fwd_launches": launched}


# the ring's forward limits: out by the norm of its error relative to the
# reference's norm, lse by its largest absolute error. TOL's element-wise
# atol + rtol·|want| is too wide here: at T = 32,768 a row's |out| is about
# sqrt(e/T) ≈ 0.01, under bf16's atol of 2e-2, and lse ≈ 11 gets 0.24,
# while a ring that loses one of 8 K/V blocks moves lse by log(8/7) ≈ 0.13.
# A run with each rank's last hop lost is held to the same limits and must
# fail them (p20_drop_last_hop)
P20_OUT_REL = {"bfloat16": 1e-2, "float32": 2e-5}
P20_LSE_ABS = {"bfloat16": 1e-4, "float32": 2e-5}


def p20_check(outs, grads, ref, name):
    """The ring's (out, lse) a rank and (dq, dk, dv) a rank against `ref` =
    (out, lse, dq, dk, dv) over the whole sequence: the forward by
    P20_OUT_REL / P20_LSE_ABS, the gradients by BWD_TOL of their largest.
    Returns (errors, ok)."""
    import torch

    w_out, w_lse = ref[0].float(), ref[1].float()
    got_out = torch.cat([o for o, _ in outs], dim=2).float()
    got_lse = torch.cat([s for _, s in outs], dim=2).float()
    errs = {"out_max_abs": float((got_out - w_out).abs().max()),
            "out_rel_norm": float(torch.linalg.vector_norm(got_out - w_out)
                                  / torch.linalg.vector_norm(w_out)),
            "lse_max_abs": float((got_lse - w_lse).abs().max())}
    ok = (errs["out_rel_norm"] <= P20_OUT_REL[name]
          and errs["lse_max_abs"] <= P20_LSE_ABS[name])
    for i, label in enumerate(("dq", "dk", "dv")):
        want = ref[2 + i].float()
        got = torch.cat([gr[i] for gr in grads], dim=2).float()
        errs[label] = float((got - want).abs().max() / want.abs().max())
        ok = ok and errs[label] <= BWD_TOL[name]
    return errs, ok


def p20_ring(fa):
    """The ring's per-hop code driven over every (rank, hop) of sp ranks in
    this process, forward and backward, causal and dense: bf16 at T =
    32,768 (sp = 8) against one whole-T call of the same kernels and
    against the plain per-block versions, timed, and with each rank's last
    hop lost, which must fail the same checks; f32 at T = 4,096 (sp = 4)
    against the plain per-block versions. Each ring run launches the
    block kernels sp·(sp+1)/2 (causal) or sp² (dense) times a direction
    and takes no plain route on the card. Returns the record and the flash
    launches of the ring runs."""
    import torch

    from paddle_tpu_torch.parallel.ring_attention import (ring_simulate,
                                                          ring_simulate_bwd)

    fwd_fn, bwd_fn = fa.flash_attention_fwd, fa.flash_attention_bwd
    rec = {}
    launches = {"fwd": {}, "bwd": {}}
    for (b, h, t, d, sp), dtype in ((P20_RING, torch.bfloat16),
                                    (P20_RING_F32, torch.float32)):
        name = str(dtype).split(".")[1]
        gen = torch.Generator("cuda").manual_seed(9)
        q, k, v, g = (torch.randn(b, h, t, d, generator=gen, device="cuda")
                      .to(dtype) for _ in range(4))
        tl = t // sp
        blk = [[x[:, :, i * tl:(i + 1) * tl] for i in range(sp)]
               for x in (q, k, v, g)]

        def ring(causal):
            outs = ring_simulate(blk[0], blk[1], blk[2], causal, "kernel")
            return outs, ring_simulate_bwd(
                blk[0], blk[1], blk[2], [o for o, _ in outs],
                [lse for _, lse in outs], blk[3], causal)

        for causal in (True, False):
            counts = (fwd_fn.launches, bwd_fn.launches,
                      fwd_fn.plain_on_cuda + bwd_fn.plain_on_cuda)
            outs, grads = ring(causal)
            torch.cuda.synchronize()
            want = sp * (sp + 1) // 2 if causal else sp * sp
            got = (fwd_fn.launches - counts[0], bwd_fn.launches - counts[1],
                   fwd_fn.plain_on_cuda + bwd_fn.plain_on_cuda - counts[2])
            if got != (want, want, 0):
                raise AssertionError(
                    f"ring {name} causal={causal}: block launches fwd/bwd "
                    f"and plain calls on the card {got}, expected "
                    f"({want}, {want}, 0)")
            launches["fwd"][name] = launches["fwd"].get(name, 0) + want
            launches["bwd"][name] = launches["bwd"].get(name, 0) + want
            saved = (fwd_fn.launches, bwd_fn.launches)
            refs, times = {}, {}
            with p20_plain_entries(fa):
                p_outs, p_grads = ring(causal)
            refs["plain"] = (torch.cat([o for o, _ in p_outs], dim=2),
                             torch.cat([s for _, s in p_outs], dim=2),
                             *(torch.cat([gr[i] for gr in p_grads], dim=2)
                               for i in range(3)))
            del p_outs, p_grads
            dropped = None
            if name == "bfloat16":
                w_out, w_lse = fwd_fn(q, k, v, None, causal)
                refs["whole"] = (w_out, w_lse) + tuple(bwd_fn(
                    q, k, v, w_out, w_lse, g, None, causal)[:3])
                outs_l = [o for o, _ in outs]
                lses_l = [lse for _, lse in outs]
                times = {
                    "ring_fwd_ms": cuda_ms(lambda: ring_simulate(
                        blk[0], blk[1], blk[2], causal, "kernel"), 3, 1),
                    "whole_fwd_ms": cuda_ms(lambda: fwd_fn(
                        q, k, v, None, causal), 3, 1),
                    "ring_bwd_ms": cuda_ms(lambda: ring_simulate_bwd(
                        blk[0], blk[1], blk[2], outs_l, lses_l, blk[3],
                        causal), 3, 1),
                    "whole_bwd_ms": cuda_ms(lambda: bwd_fn(
                        q, k, v, w_out, w_lse, g, None, causal), 3, 1)}
                with p20_drop_last_hop(fa, blk[0], blk[1]):
                    dropped = ring(causal)
            fwd_fn.launches, bwd_fn.launches = saved  # checks, not the path
            key = f"{name} T={t} sp={sp} causal={causal}"
            rec[key] = {"launches_fwd_bwd": want, **times}
            ok = True
            for against, ref in refs.items():
                errs, good = p20_check(outs, grads, ref, name)
                rec[key][f"errors_vs_{against}"] = errs
                ok = ok and good
            if dropped is not None:
                errs, good = p20_check(*dropped, refs["whole"], name)
                rec[key]["last_hop_lost_vs_whole"] = errs
                if good:
                    raise AssertionError(
                        f"ring {key}: a ring that loses each rank's last "
                        f"hop passes the checks: {errs}")
            log("parallel ring " + json.dumps({key: rec[key]}))
            if not ok:
                raise AssertionError(f"ring {key} disagrees with its "
                                     f"references: {rec[key]}")
            del refs, dropped
    return rec, launches


@contextlib.contextmanager
def p20_plain_entries(fa):
    """The ring's per-block entries on their plain versions (the ring's
    reference: the same hops, each block's plain attention)."""
    fwd, bwd = fa.flash_block_fwd, fa.flash_block_bwd
    fa.flash_block_fwd = (lambda q, k, v, s=None, c=False:
                          fa.flash_attention_fwd_plain(q, k, v, None, c, s))
    fa.flash_block_bwd = (lambda q, k, v, g, lse, out, s=None, c=False:
                          fa.flash_attention_bwd_plain(q, k, v, out, lse, g,
                                                       None, c, s)[:3])
    try:
        yield
    finally:
        fa.flash_block_fwd, fa.flash_block_bwd = fwd, bwd


@contextlib.contextmanager
def p20_drop_last_hop(fa, qs, ks):
    """The ring with each rank's last hop lost (rank i never attends block
    i+1 mod sp: an off-by-one in the hop loop): that block's forward
    merges with weight 0 and its backward adds nothing. Under causal only
    the last rank loses a block (block 0); every other lost block is a
    future one."""
    import torch

    fwd, bwd = fa.flash_block_fwd, fa.flash_block_bwd
    n = len(qs)
    lost = {(id(qs[i]), id(ks[(i + 1) % n])) for i in range(n)}

    def drop_fwd(q, k, v, s=None, c=False):
        if (id(q), id(k)) in lost:
            return (torch.zeros_like(q),
                    torch.full(q.shape[:3], -1e9, device=q.device))
        return fwd(q, k, v, s, c)

    def drop_bwd(q, k, v, g, lse, out, s=None, c=False):
        if (id(q), id(k)) in lost:
            return torch.zeros_like(q), torch.zeros_like(k), \
                torch.zeros_like(v)
        return bwd(q, k, v, g, lse, out, s, c)

    fa.flash_block_fwd, fa.flash_block_bwd = drop_fwd, drop_bwd
    try:
        yield
    finally:
        fa.flash_block_fwd, fa.flash_block_bwd = fwd, bwd


def p20_worker(rank, world, addr):
    """Rank `rank` > 0 of phase 20 (a process of this script)."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.cuda.set_device(rank)
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops.kernels import build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_bn as fb
    from paddle_tpu_torch.parallel import init_parallel_env

    build.build_all()
    init_parallel_env(addr, world, rank, device="cuda", timeout=600)
    p20_mesh(fluid, fa, fb, rank, world)
    import torch.distributed as dist

    dist.destroy_process_group()


def phase_parallel(fluid, fa, fb, smi):
    """Phase 20 (module docstring): returns the flash launches of its main
    paths ({("fwd"|"bwd", dtype): n}) and the fused-BN ones (bf16)."""
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import init_parallel_env

    t0 = time.perf_counter()
    world = min(torch.cuda.device_count(), 8)
    addr = f"127.0.0.1:{p20_free_port()}"
    workers = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 "--p20-rank", str(r), "--p20-world",
                                 str(world), "--p20-addr", addr])
               for r in range(1, world)]
    try:
        init_parallel_env(addr, world, 0, device="cuda", timeout=600)
        rec = p20_mesh(fluid, fa, fb, 0, world)
        dist.destroy_process_group()
        for w in workers:
            if w.wait(timeout=600) != 0:
                raise AssertionError(f"phase 20 rank exited {w.returncode}")
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.wait()
    rec["ring"], ring_launches = p20_ring(fa)
    rec.update(device=smi, wall_s=time.perf_counter() - t0)
    log("parallel " + json.dumps(rec, default=str))
    flash = {("fwd", "bfloat16"): rec["bert_launches"]["fwd"]
             + ring_launches["fwd"]["bfloat16"]
             + rec["public_sp"]["ring_fwd_launches"],
             ("bwd", "bfloat16"): rec["bert_launches"]["bwd"]
             + ring_launches["bwd"]["bfloat16"],
             ("fwd", "float32"): ring_launches["fwd"]["float32"],
             ("bwd", "float32"): ring_launches["bwd"]["float32"]}
    return flash, rec["resnet_launches"]


# -- phase 21: model parallelism (tensor parallelism on a tp axis, vocab-
# sharded tables, MoE expert parallelism, a tp-sharded checkpoint) --------

P21_WORLD = 2
# BERT-base cut from 12 layers to 6 for phase 26's time, as phases 22-23
# were cut before (65.4 s for the phase at 12 layers on the H100)
P21_B, P21_T, P21_BERT_LAYERS = 8, 512, 6
# bf16 BERT cut from 4 steps to 2 and the NMT runs from 3 to 2 for phase
# 26's time (gloo at tp = 2 took 2.0-4.1 s a BERT step and 3.0-6.8 s an
# NMT bf16 step on a slower host)
P21_F32_STEPS, P21_BF16_STEPS = 3, 2
P21_NMT_F32_LAYERS, P21_NMT_STEPS = 2, 2
P21_DEEPFM_STEPS = 3
P21_MOE = {"experts": 8, "d": 1024, "hidden": 4096, "k": 2,
           "tokens": 8192, "cf": 2.0, "steps": 2}
# the f32 limits of phase_train's BERT GPU-vs-CPU check: losses by their
# relative difference, each parameter's change over the run by its
# relative L2 distance
P21_LOSS_REL, P21_DELTA_REL = 1e-4, 1e-3
P21_DEVICE = "cuda"


def p21_place(fluid):
    import torch

    return (fluid.CUDAPlace(torch.cuda.current_device())
            if P21_DEVICE == "cuda" else fluid.CPUPlace())


def p21_probe():
    """Which collectives the group's backend takes on the step's tensors
    (gloo on CUDA tensors: every one the mesh step uses was accepted on
    the H100 machine's torch 2.11, so parallel/collective.py composes
    none): {name: "accepted" | the error}. The phase's checks read their
    values."""
    import torch
    import torch.distributed as dist

    world = dist.get_world_size()
    x = torch.arange(4 * world, dtype=torch.float32, device=P21_DEVICE)
    out = {}
    for name, fn in (
            ("all_reduce", lambda: dist.all_reduce(x.clone())),
            ("broadcast", lambda: dist.broadcast(x.clone(), 0)),
            ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
                x.new_empty(world * x.numel()), x)),
            ("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
                x.new_empty(x.numel() // world), x)),
            ("all_to_all_single", lambda: dist.all_to_all_single(
                torch.empty_like(x), x))):
        try:
            fn()
            out[name] = "accepted"
        except Exception as e:  # recorded: the phase reads the outcome
            out[name] = f"refused: {type(e).__name__}: {str(e)[:160]}"
    return out


def p21_tp_bert(fluid, bert, amp, layers=None):
    """BERT-base pretraining with the Megatron specs (tp_axis="tp") at
    dropout 0, Adam."""
    cfg = bert.BertConfig(vocab_size=30522, hidden_size=HIDDEN,
                          num_layers=layers or P21_BERT_LAYERS, num_heads=NH,
                          ffn_size=3072, max_position=512,
                          hidden_dropout=0.0, attn_dropout=0.0, tp_axis="tp")
    wrap = amp_wrapper(fluid, amp)
    main, startup, _, loss = bert.build_pretrain_program(
        cfg, P21_B, P21_T, optimizer_factory=lambda: wrap(
            fluid.optimizer.Adam(LR)))
    main.random_seed = startup.random_seed = 2024
    return main, startup, loss


def p21_tp_nmt(fluid, nmt, amp, layers=None):
    """Transformer-big, packed-sparse, annotate_tp(main, NMT_RULES)."""
    from paddle_tpu_torch.parallel import NMT_RULES, annotate_tp

    cfg = nmt.TransformerConfig(dropout=0.0)
    if layers:
        cfg = nmt.TransformerConfig(dropout=0.0, n_enc=layers, n_dec=layers)
    main, startup, loss = nmt_program(fluid, nmt, cfg, NMT_T, amp)
    annotate_tp(main, NMT_RULES)
    return main, startup, loss


def p21_tp_deepfm(fluid, deepfm):
    """deepfm_program's recipe with the tables sharded over tp."""
    from paddle_tpu_torch.core import unique_name

    with unique_name.guard():
        main, startup, _, loss, _ = deepfm.build_train_program(
            vocab_size=DEEPFM_VOCAB, is_sparse=True, fused_table=True,
            embedding_optimizer="adagrad", shard_axis="tp",
            packed_rows={"rows_per_step": DEEPFM_ROWS})
    main.random_seed = startup.random_seed = 2024
    return main, startup, loss


def p21_moe(fluid):
    """layers.moe_ffn at P21_MOE's widths (gelu, Adam), f32."""
    m = P21_MOE
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [m["d"]])
        y = fluid.layers.data("y", [m["d"]])
        h, aux = fluid.layers.moe_ffn(x, num_experts=m["experts"],
                                      hidden_size=m["hidden"], k=m["k"],
                                      capacity_factor=m["cf"])
        mse = fluid.layers.reduce_mean(fluid.layers.square(
            fluid.layers.elementwise_sub(h, y)))
        loss = fluid.layers.elementwise_add(mse,
                                            fluid.layers.scale(aux, 0.01))
        fluid.optimizer.Adam(1e-3).minimize(loss)
    main.random_seed = startup.random_seed = 2024
    return main, startup, loss


def p21_moe_feed(world):
    import torch

    g = torch.Generator(P21_DEVICE).manual_seed(21)
    n = P21_MOE["tokens"] * world
    return {k: torch.randn((n, P21_MOE["d"]), generator=g,
                           device=P21_DEVICE) for k in ("x", "y")}


def p21_step_state(prog):
    return next(iter(prog._mesh_steps.values()))


def p21_params(main, scope, step=None):
    """The trainable parameters whole, on the host: a tp slice gathered
    over the tp group (a collective: every rank calls it)."""
    from paddle_tpu_torch.core.mesh_step import is_dtensor
    from paddle_tpu_torch.parallel.collective import gathered

    out = {}
    for p in main.all_parameters():
        v = scope.find_var(p.name)
        if is_dtensor(v):
            v = gathered(v.to_local(), step.tp_state[p.name],
                         step.tp_group)
        out[p.name] = v.detach().float().cpu().clone()
    return out


def p21_r_digests(main, scope, step):
    """sha1 of every replicated parameter's bytes on this rank."""
    import hashlib

    import torch

    return {p.name: hashlib.sha1(
        scope.find_var(p.name).detach().contiguous().view(-1)
        .view(torch.uint8).cpu().numpy().tobytes()).hexdigest()
        for p in main.all_parameters() if p.name not in step.tp_state}


def p21_run(fluid, build, feed, steps, axes=None, data_axis="dp",
            ckdir=None, params=True):
    """`steps` steps of `build()` from its startup: the plain Executor
    (`axes` None) or with_mesh(make_mesh(axes)). Returns (losses, params
    at the end, record); on a mesh the record holds the replicated
    parameters' digests a step and the checkpoint's next-step loss."""
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.observability.registry import get_registry
    from paddle_tpu_torch.parallel import Checkpointer, make_mesh

    main, startup, loss = build()
    exe = fluid.Executor(p21_place(fluid))
    scope = fluid.Scope()
    rec = {}
    with fluid.scope_guard(scope):
        exe.run(startup)
        prog = main
        if axes is not None:
            prog = fluid.CompiledProgram(main).with_mesh(
                make_mesh(axes), data_axis=data_axis)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ms, digests = [], [], []
        for i in range(steps):
            fd = feed[i % len(feed)] if isinstance(feed, list) else feed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (lv,) = exe.run(prog, feed=fd, fetch_list=[loss])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(np.asarray(lv, np.float32).reshape(-1)[0]))
            if axes is not None and "tp" in axes:
                digests.append(p21_r_digests(main, scope,
                                             p21_step_state(prog)))
        rec.update(losses=losses, step_ms=ms,
                   peak_MiB=torch.cuda.max_memory_allocated() / 2**20)
        step = p21_step_state(prog) if axes is not None else None
        if step is not None:
            rec["state_bytes_per_rank"] = get_registry().gauge(
                "memory/state_bytes_per_device").value
        else:
            rec["state_bytes_per_rank"] = sum(
                v.numel() * v.element_size() for v in (
                    scope.find_var(x.name) for x in main.list_vars()
                    if x.persistable) if isinstance(v, torch.Tensor))
        if digests:
            every = [None] * dist.get_world_size()
            dist.all_gather_object(every, digests)
            rec["r_params_bitwise_equal"] = all(d == every[0]
                                                for d in every)
            rec["r_params_checked"] = len(digests[0])
        out = p21_params(main, scope, step) if params else None
        if ckdir is not None:
            ck = Checkpointer(ckdir, keep=0)
            ck.save(steps, program=main, scope=scope, blocking=True)
            (lv,) = exe.run(prog, feed=feed[0] if isinstance(feed, list)
                            else feed, fetch_list=[loss])
            rec["next_loss"] = float(np.asarray(lv, np.float32).reshape(-1)[0])
        del scope
    torch.cuda.empty_cache()
    return losses, out, rec


def p21_heads(mod, names):
    """Wrap the flash wrappers `names` of `mod` to record each call's head
    count (dim 1 of q): the kernel code counts its launches on the module's
    object, so a wrapper carries its own counts while it is in place.
    Returns (seen, restore)."""
    seen = {n: [] for n in names}
    orig = {n: getattr(mod, n) for n in names}
    for n in names:
        def wrap(q, *a, _f=orig[n], _n=n, **kw):
            seen[_n].append(int(q.shape[1]))
            return _f(q, *a, **kw)
        wrap.launches = wrap.plain_on_cuda = wrap.wide_launches = 0
        setattr(mod, n, wrap)

    def restore():
        counts = {n: {"launches": getattr(mod, n).launches,
                      "plain_on_cuda": getattr(mod, n).plain_on_cuda}
                  for n in names}
        for n in names:
            setattr(mod, n, orig[n])
        return counts
    return seen, restore


def p21_counted(mod, names, fn):
    """fn() with the wrappers `names` of `mod` counting (p21_heads):
    (its result, {"fwd"|"bwd": launches}, plain calls on the card, the
    head counts seen)."""
    seen, restore = p21_heads(mod, names)
    try:
        got = fn()
    finally:
        counts = restore()
    launches = {n.rsplit("_", 1)[1]: c["launches"] for n, c in counts.items()}
    plain = sum(c["plain_on_cuda"] for c in counts.values())
    return got, launches, plain, sorted({h for v in seen.values()
                                         for h in v})


def p21_mesh(fluid, fa, fas, fsa, rank, world, ckdir):
    """What every rank runs, in one order (see phase_model_parallel).
    Returns (this rank's record, BERT f32's final parameters)."""
    import torch

    from paddle_tpu_torch.models import bert, deepfm
    from paddle_tpu_torch.models import transformer_nmt as nmt

    tp = {"dp": 1, "tp": world}
    rec = {"rank": rank, "probe": p21_probe(), "launches": {},
           "plain_on_cuda": 0, "heads": {}}
    bert_feed_all = pretrain_feed(P21_B, P21_T, np.random.RandomState(21))
    batches = [nmt_feed(stack, P21_DEVICE)
               for stack, _ in nmt_batches(NMT_B, NMT_T, 2)]
    params = None
    dense = ("flash_attention_fwd", "flash_attention_bwd")
    sparse = ("flash_attention_sparse_fwd", "flash_attention_sparse_bwd")
    for key, mod, names, run in (
            ("bert_f32", fa, dense, lambda: p21_run(
                fluid, lambda: p21_tp_bert(fluid, bert, False),
                bert_feed_all, P21_F32_STEPS, tp, ckdir=ckdir)),
            ("bert_bf16", fa, dense, lambda: p21_run(
                fluid, lambda: p21_tp_bert(fluid, bert, True), bert_feed_all,
                P21_BF16_STEPS, tp, params=False)),
            ("nmt_bf16", fas, sparse, lambda: p21_run(
                fluid, lambda: p21_tp_nmt(fluid, nmt, True), batches,
                P21_NMT_STEPS, tp, params=False)),
            ("nmt_f32", fas, sparse, lambda: p21_run(
                fluid, lambda: p21_tp_nmt(fluid, nmt, False,
                                          P21_NMT_F32_LAYERS),
                batches, P21_NMT_STEPS, tp, params=False))):
        t0 = time.perf_counter()
        (_, got, rec[key]), launches, plain, heads = p21_counted(
            mod, names, run)
        rec[key]["s"] = time.perf_counter() - t0
        rec["launches"][key] = launches
        rec["plain_on_cuda"] += plain
        rec["heads"][key] = heads
        if key == "bert_f32":
            params = got
    fsa.fused_adagrad_update.launches = 0
    dfeed = deepfm_feed(np.random.RandomState(0), DEEPFM_B, DEEPFM_VOCAB,
                        P21_DEVICE)
    t0 = time.perf_counter()
    _, _, rec["deepfm"] = p21_run(
        fluid, lambda: p21_tp_deepfm(fluid, deepfm), dfeed,
        P21_DEEPFM_STEPS, tp, params=False)
    rec["deepfm"]["s"] = time.perf_counter() - t0
    rec["launches"]["deepfm_row12"] = fsa.fused_adagrad_update.launches
    moe_all = p21_moe_feed(world)
    t0 = time.perf_counter()
    _, _, rec["moe"] = p21_run(
        fluid, lambda: p21_moe(fluid), p20_rows(moe_all, rank, world),
        P21_MOE["steps"], {"ep": world}, data_axis="ep", params=False)
    rec["moe"]["s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return rec, params


def p21_worker(rank, world, addr, backend, ckdir):
    """Rank `rank` > 0 of phase 21 (a process of this script)."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.cuda.set_device(rank if backend == "nccl" else 0)
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops.kernels import build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import flash_attention_sparse as fas
    from paddle_tpu_torch.ops.kernels import sparse_adagrad as fsa
    from paddle_tpu_torch.parallel import init_parallel_env

    build.build_all()
    init_parallel_env(addr, world, rank,
                      device="cuda" if backend == "nccl" else "cpu",
                      timeout=600)
    rec, _ = p21_mesh(fluid, fa, fas, fsa, rank, world, ckdir)
    every = [None] * world
    dist.all_gather_object(every, rec)
    dist.destroy_process_group()


def p21_delta_rel(got, want, init):
    """max over parameters of ‖Δgot − Δwant‖ / ‖Δwant‖, Δ = the change
    over the run."""
    worst = 0.0
    for k, w in want.items():
        dw = (w - init[k]).double()
        dg = (got[k] - init[k]).double()
        n = float(dw.norm())
        if n > 0:
            worst = max(worst, float((dg - dw).norm()) / n)
    return worst


def p21_rel(a, b):
    return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))


def phase_model_parallel(fluid, fa, fas, fsa, smi):
    """Phase 21 (module docstring). Returns the launches of its main paths:
    {"flash": {"fwd"|"bwd": n}, "sparse": {...}, "row12": n} over both
    ranks."""
    import tempfile

    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.models import transformer_nmt as nmt
    from paddle_tpu_torch.parallel import Checkpointer, init_parallel_env

    t_phase = time.perf_counter()
    world = P21_WORLD
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    ckdir = tempfile.mkdtemp(prefix="p21-ck-")
    addr = f"127.0.0.1:{p20_free_port()}"
    workers = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 "--p21-rank", str(r), "--p21-world",
                                 str(world), "--p21-addr", addr,
                                 "--p21-backend", backend, "--p21-ck",
                                 ckdir])
               for r in range(1, world)]
    try:
        init_parallel_env(addr, world, 0,
                          device="cuda" if backend == "nccl" else "cpu",
                          timeout=600)
        rec, tp_params = p21_mesh(fluid, fa, fas, fsa, 0, world, ckdir)
        every = [None] * world
        dist.all_gather_object(every, rec)
        dist.destroy_process_group()
        for w in workers:
            if w.wait(timeout=600) != 0:
                raise AssertionError(f"phase 21 rank exited {w.returncode}")
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.wait()
    out = {"backend": backend, "world": world, "ranks": every}
    t_mesh = time.perf_counter() - t_phase
    # the plain executor in this one process, on the same programs
    rng = np.random.RandomState(21)
    bert_feed_all = pretrain_feed(P21_B, P21_T, rng)

    def untp(build):
        def b():
            main, startup, loss = build()
            for p in main.all_parameters():
                p.shard_spec = None
            return main, startup, loss
        return b

    init = None

    def bert_init():
        nonlocal init
        main, startup, loss = untp(lambda: p21_tp_bert(fluid, bert,
                                                       False))()
        scope = fluid.Scope()
        fluid.Executor(p21_place(fluid)).run(startup, scope=scope)
        init = {p.name: scope.find_var(p.name).detach().float().cpu()
                .clone() for p in main.all_parameters()}

    bert_init()
    plain = {}
    _, ref_params, plain["bert_f32"] = p21_run(
        fluid, untp(lambda: p21_tp_bert(fluid, bert, False)), bert_feed_all,
        P21_F32_STEPS)
    _, _, plain["bert_bf16"] = p21_run(
        fluid, untp(lambda: p21_tp_bert(fluid, bert, True)), bert_feed_all,
        P21_BF16_STEPS, params=False)
    batches = [nmt_feed(stack, P21_DEVICE)
               for stack, _ in nmt_batches(NMT_B, NMT_T, 2)]
    _, _, plain["nmt_f32"] = p21_run(
        fluid, untp(lambda: p21_tp_nmt(fluid, nmt, False,
                                       P21_NMT_F32_LAYERS)),
        batches, P21_NMT_STEPS, params=False)
    from paddle_tpu_torch.models import deepfm

    dfeed = deepfm_feed(np.random.RandomState(0), DEEPFM_B, DEEPFM_VOCAB,
                        P21_DEVICE)
    _, _, plain["deepfm"] = p21_run(
        fluid, untp(lambda: p21_tp_deepfm(fluid, deepfm)), dfeed,
        P21_DEEPFM_STEPS, params=False)
    _, _, plain["moe"] = p21_run(
        fluid, lambda: p21_moe(fluid),
        p21_moe_feed(world), P21_MOE["steps"], params=False)
    # the tp-sharded checkpoint restored in one process: its next step
    main, startup, loss = untp(lambda: p21_tp_bert(fluid, bert, False))()
    exe = fluid.Executor(p21_place(fluid))
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        restored = Checkpointer(ckdir).restore(program=main, scope=scope,
                                               place=p21_place(fluid))
        (lv,) = exe.run(main, feed=bert_feed_all, fetch_list=[loss])
        ck_loss = float(np.asarray(lv, np.float32).reshape(-1)[0])
    del scope
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()
    r0 = every[0]
    checks = {
        "bert_f32_loss_rel": p21_rel(r0["bert_f32"]["losses"],
                                     plain["bert_f32"]["losses"]),
        "bert_f32_delta_rel": p21_delta_rel(tp_params, ref_params, init),
        "bert_bf16_loss_rel": p21_rel(r0["bert_bf16"]["losses"],
                                      plain["bert_bf16"]["losses"]),
        "nmt_f32_loss_rel": p21_rel(r0["nmt_f32"]["losses"],
                                    plain["nmt_f32"]["losses"]),
        "deepfm_loss_rel": p21_rel(r0["deepfm"]["losses"],
                                   plain["deepfm"]["losses"]),
        "moe_loss_rel": p21_rel(r0["moe"]["losses"],
                                plain["moe"]["losses"]),
        "ckpt_restored_step": restored,
        "ckpt_next_loss_rel": p21_rel([ck_loss],
                                      [r0["bert_f32"]["next_loss"]]),
        "r_params_bitwise_equal": all(
            r[k].get("r_params_bitwise_equal", True) for r in every
            for k in ("bert_f32", "bert_bf16", "nmt_bf16", "nmt_f32",
                      "deepfm")),
        "heads_a_rank": r0["heads"],
    }
    out.update(plain=plain, checks=checks, mesh_s=t_mesh, device=smi)
    launches = {k: {d: sum(r["launches"][k][d] for r in every)
                    for d in ("fwd", "bwd")}
                for k in ("bert_f32", "bert_bf16", "nmt_bf16", "nmt_f32")}
    row12 = sum(r["launches"]["deepfm_row12"] for r in every)
    plain_on_cuda = sum(r["plain_on_cuda"] for r in every)
    out.update(launches=launches, row12=row12, plain_on_cuda=plain_on_cuda,
               wall_s=time.perf_counter() - t_phase)
    log("model_parallel " + json.dumps(out, default=str))
    want = {"bert_f32": world * P21_BERT_LAYERS * (P21_F32_STEPS + 1),
            "bert_bf16": world * P21_BERT_LAYERS * P21_BF16_STEPS,
            "nmt_bf16": world * NMT_PER_STEP * P21_NMT_STEPS,
            "nmt_f32": world * 3 * P21_NMT_F32_LAYERS * P21_NMT_STEPS}
    bad = [f"{k} launches {launches[k]}, expected {n} each"
           for k, n in want.items() if launches[k] != {"fwd": n, "bwd": n}]
    for key, limit in (("bert_f32_loss_rel", P21_LOSS_REL),
                       ("bert_f32_delta_rel", P21_DELTA_REL),
                       ("nmt_f32_loss_rel", P21_LOSS_REL),
                       ("deepfm_loss_rel", P21_LOSS_REL),
                       ("moe_loss_rel", P21_LOSS_REL),
                       ("ckpt_next_loss_rel", P21_LOSS_REL)):
        if not checks[key] <= limit:
            bad.append(f"{key} {checks[key]} over {limit}")
    if checks["ckpt_restored_step"] != P21_F32_STEPS:
        bad.append(f"checkpoint restored step {checks['ckpt_restored_step']}")
    if not checks["r_params_bitwise_equal"]:
        bad.append("replicated parameters differ across the tp ranks")
    heads = {"bert_f32": NH // world, "bert_bf16": NH // world,
             "nmt_bf16": NMT_NH // world, "nmt_f32": NMT_NH // world}
    bad += [f"{k} attention ran at heads {r['heads'][k]}, expected "
            f"[{n}]" for r in every for k, n in heads.items()
            if r["heads"][k] != [n]]
    if row12 != world * P21_DEEPFM_STEPS or plain_on_cuda:
        bad.append(f"row 12 launches {row12} (expected "
                   f"{world * P21_DEEPFM_STEPS}), plain on the card "
                   f"{plain_on_cuda}")
    if not all(np.isfinite(x) for r in every for k in
               ("bert_bf16", "nmt_bf16", "deepfm", "moe")
               for x in r[k]["losses"]):
        bad.append("a loss is not finite")
    if bad:
        raise AssertionError(f"phase 21: {bad}")
    return out

# -- phase 22: pipelines, the sequence axis, attention dropout on a slice ---
P22_WORLD, P22_COMPOSED_WORLD = 2, 4
# 6 layers (12 before the script's time limit drew near; the pipelines
# and model-parallel steps of phases 22-23 are gloo host traffic that
# scales with the depth)
P22_B, P22_T, P22_LAYERS, P22_MICRO = 8, 512, 6, 4
P22_F32_STEPS, P22_BF16_STEPS, P22_DROP_STEPS = 3, 4, 2
P22_COMPOSED_LAYERS, P22_NMT_STEPS = 4, 2
P22_DROP = 0.1
# (b)-(d) and the checkpoint: losses within 1e-5 relative of the plain
# run's; (e) at phase 21's limits (losses 1e-4, parameter changes 1e-3
# relative L2, P21_LOSS_REL / P21_DELTA_REL)
P22_LOSS_REL = 1e-5
P22_DEVICE = "cuda"


def p22_place(fluid):
    import torch

    return (fluid.CUDAPlace(torch.cuda.current_device())
            if P22_DEVICE == "cuda" else fluid.CPUPlace())


def p22_probe_rank(rank, world, addr):
    """One rank of the native point-to-point probe (a process of this
    script, so that a backend that crashes on a CUDA pointer takes down
    only the probe): gloo's isend/irecv in one batch_isend_irecv, and
    send/recv, on CUDA tensors, then the host-staged exchange the port
    uses on gloo (collective.exchange) with its ms for a [2, 512, 768] f32
    payload each way. Prints {name: "accepted, bytes equal" | "accepted,
    bytes differ" | the error, ...} as one JSON line."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.parallel import init_parallel_env
    from paddle_tpu_torch.parallel.collective import exchange

    init_parallel_env(addr, world, rank, device="cpu", timeout=60)
    peer, back = (rank + 1) % world, (rank - 1) % world
    x = torch.arange(2 * 512 * 768, dtype=torch.float32,
                     device=P22_DEVICE).reshape(2, 512, 768) + rank
    want = x - rank + back
    out = {}

    def native_batch():
        y = torch.empty_like(x)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer),
                                           dist.P2POp(dist.irecv, y, back)]):
            req.wait()
        return y

    def native_pair():
        y = torch.empty_like(x)
        if rank % 2 == 0:
            dist.send(x, peer)
            dist.recv(y, back)
        else:
            dist.recv(y, back)
            dist.send(x, peer)
        return y

    y = torch.empty_like(x)
    t0 = time.perf_counter()
    exchange([(x, peer)], [(y, back)], dist.group.WORLD)
    if P22_DEVICE == "cuda":
        torch.cuda.synchronize()
    out["exchange_ms"] = (time.perf_counter() - t0) * 1e3
    out["exchange_bytes_equal"] = bool(torch.equal(y, want))
    for name, fn in (("batch_isend_irecv", native_batch),
                     ("send_recv", native_pair)):
        try:
            got = fn()
            if P22_DEVICE == "cuda":
                torch.cuda.synchronize()
            out[name] = ("accepted, bytes equal" if torch.equal(got, want)
                         else "accepted, bytes differ")
        except Exception as e:  # recorded: the phase reports the outcome
            out[name] = f"refused: {type(e).__name__}: {str(e)[:160]}"
    print(json.dumps(out), flush=True)
    dist.destroy_process_group()


def p22_probe(world):
    """(a) The probe of p22_probe_rank on `world` fresh processes, each
    given 120 s: rank 0's record, or how the probe ended."""
    addr = f"127.0.0.1:{p20_free_port()}"
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--p22-probe", str(r), "--p22-world",
                               str(world), "--p22-addr", addr],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    outs = []
    for p in procs:
        try:
            so, se = p.communicate(timeout=120)
            outs.append((p.returncode, so, se))
        except subprocess.TimeoutExpired:
            p.kill()
            so, se = p.communicate()
            outs.append(("timed out", so, se))
    rc, so, se = outs[0]
    lines = [x for x in so.splitlines() if x.startswith("{")]
    if rc == 0 and lines:
        return json.loads(lines[-1])
    return {"probe": f"ended {rc}: {se.strip()[-300:]}",
            "other_ranks": [str(o[0]) for o in outs[1:]]}


def p22_bert(fluid, bert, amp=False, layers=None, drop=0.0, stages=0,
             tp=False, micro=P22_MICRO, clip=None):
    """BERT-base pretraining (vocab 30522, hidden 768, 12 heads, ffn 3072;
    B = P22_B, T = P22_T), Adam(LR), bf16 AMP when `amp`; with `stages`
    > 0 cut by PipelineOptimizer into that many stages (cut_list = the
    embeddings and every (layers / stages)-th layer's output), with `tp`
    the Megatron specs (tp_axis="tp"); with `clip`, Adam clips by
    GradientClipByGlobalNorm(clip) and the global norm is returned fourth
    (fetched by p22_run)."""
    layers = layers or P22_LAYERS
    L = fluid.layers
    cfg = bert.BertConfig(vocab_size=30522, hidden_size=HIDDEN,
                          num_layers=layers, num_heads=NH, ffn_size=3072,
                          max_position=512, hidden_dropout=drop,
                          attn_dropout=drop, tp_axis="tp" if tp else None)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        src = L.data("src_ids", [P22_T], dtype="int64")
        pos = L.data("pos_ids", [P22_T], dtype="int64")
        sent = L.data("sent_ids", [P22_T], dtype="int64")
        mask = L.data("input_mask", [P22_T], dtype="float32")
        labels = L.data("mlm_labels", [P22_T, 1], dtype="int64")
        neg = L.scale(L.elementwise_add(
            mask, L.fill_constant([1], "float32", -1.0)), scale=10000.0)
        mask4 = L.unsqueeze(neg, [1])
        x = bert.embeddings(cfg, src, pos, sent)
        cuts = [x]
        for i in range(layers):
            x = bert.encoder_layer(cfg, x, mask4, i)
            if stages and (i + 1) % (layers // stages) == 0:
                cuts.append(x)
        loss = bert.bert_pretrain_loss(cfg, x, labels, mask)
        kw = ({} if clip is None else
              {"grad_clip": fluid.clip.GradientClipByGlobalNorm(clip)})
        opt = amp_wrapper(fluid, amp)(fluid.optimizer.Adam(LR, **kw))
        if stages:
            opt = fluid.optimizer.PipelineOptimizer(
                opt, cut_list=cuts, num_microbatches=micro)
        opt.minimize(loss)
    main.random_seed = startup.random_seed = 2024
    if clip is None:
        return main, startup, loss
    # the clip op's input: the global norm (its max with clip_norm divides)
    (gnorm,) = [op.inputs["X"][0] for op in main.global_block().ops
                if op.type == "clip" and op.attrs.get("min") == clip]
    return main, startup, loss, main.global_block().var(gnorm)


def p22_iso_dropout(fluid):
    """Two isomorphic scale + dropout 0.5 stages on an all-ones [B, 768]
    input, 4 microbatches: each microbatch's rows show its masks."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = L.data("x", [HIDDEN])
        cuts, h = [x], x
        for _ in range(2):
            h = L.dropout(L.scale(h, scale=1.0), 0.5,
                          dropout_implementation="upscale_in_train")
            cuts.append(h)
        loss = L.reduce_mean(h)
        fluid.optimizer.PipelineOptimizer(
            fluid.optimizer.SGD(0.0), cut_list=cuts,
            num_microbatches=P22_MICRO).minimize(loss)
    main.random_seed = startup.random_seed = 2024
    return main, startup, loss, cuts[-1]


def p22_params(main, scope):
    """The trainable parameters whole, on the host: a tp slice gathered, a
    pipeline stage's broadcast from its owner (collectives: every rank
    calls it)."""
    from paddle_tpu_torch.core.mesh_step import logical_value

    return {p.name: logical_value(main, p.name, scope.find_var(p.name))
            .detach().float().cpu().clone() for p in main.all_parameters()}


def p22_r_digests(main, scope):
    """sha1 of every parameter this rank holds whole that no axis splits
    (not a tp slice, not a pipeline stage's)."""
    import hashlib

    import torch

    from paddle_tpu_torch.core.mesh_step import StageValue, is_dtensor

    out = {}
    for p in main.all_parameters():
        v = scope.find_var(p.name)
        if is_dtensor(v) or isinstance(v, StageValue):
            continue
        out[p.name] = hashlib.sha1(v.detach().contiguous().view(-1).view(
            torch.uint8).cpu().numpy().tobytes()).hexdigest()
    return out


def p22_run(fluid, build, feed, steps, axes=None, data_axis=None,
            seq_axis=None, ckdir=None, params=True):
    """`steps` steps of `build()` from its startup: the plain Executor
    (`axes` None) or with_mesh(make_mesh(axes)). Returns (losses, params
    at the end, record); on a mesh the record holds whether the
    replicated parameters were bitwise equal across the ranks after every
    step, the state bytes a rank, and with `ckdir` the checkpoint's
    next-step loss; a fourth value `build()` returns is fetched at the
    last step."""
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.observability.registry import get_registry
    from paddle_tpu_torch.parallel import Checkpointer, make_mesh

    got = build()
    main, startup, loss = got[:3]
    fetch = got[3] if len(got) > 3 else None
    exe = fluid.Executor(p22_place(fluid))
    scope = fluid.Scope()
    rec = {}
    cuda = P22_DEVICE == "cuda"
    with fluid.scope_guard(scope):
        exe.run(startup)
        prog = main
        if axes is not None:
            prog = fluid.CompiledProgram(main).with_mesh(
                make_mesh(axes), data_axis=data_axis, seq_axis=seq_axis)
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        losses, ms, digests, last = [], [], [], None
        fl = [loss] + ([fetch] if fetch is not None else [])
        for _ in range(steps):
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            last = exe.run(prog, feed=feed, fetch_list=fl)
            if cuda:
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(np.asarray(last[0], np.float32)
                                .reshape(-1)[0]))
            if axes is not None:
                digests.append(p22_r_digests(main, scope))
            if fetch is not None:
                rec.setdefault("fetched_steps", []).append(
                    np.asarray(last[1], np.float32))
        rec.update(losses=losses, step_ms=ms, peak_MiB=(
            torch.cuda.max_memory_allocated() / 2**20 if cuda else None))
        if fetch is not None:
            rec["fetched"] = np.asarray(last[1], np.float32)
        if axes is not None:
            rec["state_bytes_per_rank"] = get_registry().gauge(
                "memory/state_bytes_per_device").value
            every = [None] * dist.get_world_size()
            dist.all_gather_object(every, digests)
            rec["r_params_bitwise_equal"] = all(d == every[0] for d in every)
            rec["r_params_checked"] = len(digests[0]) if digests else 0
        else:
            rec["state_bytes_per_rank"] = sum(
                v.numel() * v.element_size() for v in (
                    scope.find_var(x.name) for x in main.list_vars()
                    if x.persistable) if isinstance(v, torch.Tensor))
        out = p22_params(main, scope) if params else None
        if ckdir is not None:
            Checkpointer(ckdir, keep=0).save(steps, program=main,
                                             scope=scope, blocking=True)
            (lv,) = exe.run(prog, feed=feed, fetch_list=[loss])
            rec["next_loss"] = float(np.asarray(lv, np.float32)
                                     .reshape(-1)[0])
        del scope
    if cuda:
        torch.cuda.empty_cache()
    return losses, out, rec


def p22_seen(mod, names):
    """Wrap the flash wrappers `names` of `mod` (as p21_heads) to record
    each call's (heads, query length, key length) and count its launches.
    Returns (seen, restore)."""
    seen = []
    orig = {n: getattr(mod, n) for n in names}
    for n in names:
        def wrap(q, k, *a, _f=orig[n], **kw):
            seen.append((int(q.shape[1]), int(q.shape[2]), int(k.shape[2])))
            return _f(q, k, *a, **kw)
        wrap.launches = wrap.plain_on_cuda = wrap.wide_launches = 0
        setattr(mod, n, wrap)

    def restore():
        counts = {n.rsplit("_", 1)[1]: getattr(mod, n).launches
                  for n in names}
        plain = sum(getattr(mod, n).plain_on_cuda for n in names)
        for n in names:
            setattr(mod, n, orig[n])
        return counts, plain
    return seen, restore


def p22_counted(rec, key, mod, names, fn):
    """fn() with the wrappers counting: its result; rec[key] gets the
    launches a direction, the plain calls on the card and the (heads, Tq,
    Tk) shapes the kernels saw."""
    seen, restore = p22_seen(mod, names)
    t0 = time.perf_counter()
    try:
        got = fn()
    finally:
        counts, plain = restore()
    got[2].update(launches=counts, plain_on_cuda=plain,
                  shapes=sorted(set(seen)), s=time.perf_counter() - t0)
    rec[key] = got[2]
    return got


def p22_keep_bits(fa, fas):
    """The flash kernels' dropout bits at a head and row offset (rows 1-6):
    heads 6.. of 12 (8.. of 16 for the sparse pair, 2.. of 4 for the wide
    kernels at d = 320, dense and sparse) and query rows 256.. of 512, the
    key [seed, heads, head0, row0], against the plain versions on the same
    slices and the same key (f32 and bf16, forward and backward), and the
    plain slice against the whole run's plain output. On the card each
    wide case must launch the wide kernels. Returns {case: max abs error}
    and raises past the main tolerances."""
    import torch

    g = torch.Generator(P22_DEVICE).manual_seed(22)
    seed = torch.tensor([0x5EED_2022], dtype=torch.int64, device=P22_DEVICE)
    out = {}
    bad = []
    for dt, name in ((torch.float32, "float32"), (torch.bfloat16,
                                                  "bfloat16")):
        for kind in ("dense", "sparse", "wide", "wide_sparse"):
            H, h0 = {"dense": (NH, NH // 2), "sparse": (16, 8)}.get(
                kind, (4, 2))
            T, r0, b = 512, 256, 2
            d = WIDER_D[0] if kind.startswith("wide") else D
            wide0 = (fa.flash_attention_fwd.wide_launches
                     + fas.flash_attention_sparse_fwd.wide_launches)
            q, k, v, go = (torch.randn(b, H, T, d, generator=g,
                                       device=P22_DEVICE).to(dt)
                           for _ in range(4))
            key = fa.dropout_key(seed, H, h0, r0)
            ql, kl, vl, gl = (x[:, h0:, r0:].contiguous() if x is q or x is go
                              else x[:, h0:].contiguous()
                              for x in (q, k, v, go))
            if kind in ("dense", "wide"):
                bias = torch.zeros(b, 1, 1, T, device=P22_DEVICE, dtype=dt)
                bias[..., 3 * T // 4:] = -10000.0
                fwd = lambda *a, **kw: fa.flash_attention_fwd(  # noqa: E731
                    *a, bias, **kw)
                fwd_p = lambda *a, **kw: fa.flash_attention_fwd_plain(  # noqa: E731,E501
                    *a, bias, **kw)
                bwd = lambda *a, **kw: fa.flash_attention_bwd(  # noqa: E731
                    *a, bias, **kw)[:3]
                bwd_p = lambda *a, **kw: fa.flash_attention_bwd_plain(  # noqa: E731,E501
                    *a, bias, **kw)[:3]
                whole = fa.flash_attention_fwd_plain(
                    q, k, v, bias, dropout_rate=P22_DROP, seed=seed)[0]
            else:
                segq = torch.ones(b, T - r0, dtype=torch.int32,
                                  device=P22_DEVICE)
                segk = torch.ones(b, T, dtype=torch.int32, device=P22_DEVICE)
                segq[1, -64:] = segk[1, -64:] = 0
                se = fas.pack_se(segq, segk)
                vis = fas.compute_block_vis(se, T - r0, T, causal=False)
                se_w = fas.pack_se(torch.cat([segk[:, :r0], segq], 1), segk)
                fwd = lambda *a, **kw: fas.flash_attention_sparse_fwd(  # noqa: E731,E501
                    *a, se, vis, **kw)
                fwd_p = lambda *a, **kw: fas.flash_attention_sparse_fwd_plain(  # noqa: E731,E501
                    *a, se, vis, **kw)
                bwd = lambda *a, **kw: fas.flash_attention_sparse_bwd(  # noqa: E731,E501
                    *a, se, vis, **kw)[:3]
                bwd_p = lambda *a, **kw: fas.flash_attention_sparse_bwd_plain(  # noqa: E731,E501
                    *a, se, vis, **kw)[:3]
                whole = fas.flash_attention_sparse_fwd_plain(
                    q, k, v, se_w, None, dropout_rate=P22_DROP,
                    seed=seed)[0]
            o, lse = fwd(ql, kl, vl, dropout_rate=P22_DROP, seed=key)
            op, lsep = fwd_p(ql, kl, vl, dropout_rate=P22_DROP, seed=key)
            grads = bwd(ql, kl, vl, op, lsep, gl, dropout_rate=P22_DROP,
                        seed=key)
            grads_p = bwd_p(ql, kl, vl, op, lsep, gl, dropout_rate=P22_DROP,
                            seed=key)
            if P22_DEVICE == "cuda":
                torch.cuda.synchronize()
            e = {"fwd": float((o.float() - op.float()).abs().max()),
                 "bwd": max(float((a.float() - c.float()).abs().max())
                            for a, c in zip(grads, grads_p)),
                 "plain_vs_whole": float((op.float() - whole[:, h0:, r0:]
                                          .float()).abs().max())}
            out[f"{kind}[{name}]"] = e
            wide = (fa.flash_attention_fwd.wide_launches
                    + fas.flash_attention_sparse_fwd.wide_launches - wide0)
            if not (e["fwd"] <= TOL[name] and e["bwd"] <= BWD_TOL[name]
                    and e["plain_vs_whole"] <= TOL[name]):
                bad.append(f"{kind}[{name}] {e}")
            if (P22_DEVICE == "cuda" and kind.startswith("wide")
                    and wide < 1):
                bad.append(f"{kind}[{name}] ran no wide kernel")
    if bad:
        raise AssertionError(f"phase 22 keep bits: {bad}")
    return out


def p22_pair(fluid, fa, fas, rank, world, ckdir):
    """What the two ranks of (a)-(d) run, in one order. Returns (this
    rank's record, the pp run's final parameters)."""
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.models import transformer_nmt as nmt

    dense = ("flash_attention_fwd", "flash_attention_bwd")
    sparse = ("flash_attention_sparse_fwd", "flash_attention_sparse_bwd")
    feed = pretrain_feed(P22_B, P22_T, np.random.RandomState(22))
    rec = {"rank": rank}
    pp = {"pp": world}
    _, params, _ = p22_counted(rec, "pp_f32", fa, dense, lambda: p22_run(
        fluid, lambda: p22_bert(fluid, bert, stages=world), feed,
        P22_F32_STEPS, pp, ckdir=ckdir))
    p22_counted(rec, "pp_bf16", fa, dense, lambda: p22_run(
        fluid, lambda: p22_bert(fluid, bert, amp=True, drop=P22_DROP,
                                stages=world), feed, P22_BF16_STEPS, pp,
        params=False))
    ones = {"x": np.ones((P22_B, HIDDEN), "float32")}
    _, _, rec["pp_masks"] = p22_run(
        fluid, lambda: p22_iso_dropout(fluid), ones, 1, pp, params=False)
    tp = {"dp": 1, "tp": world}
    p22_counted(rec, "tp_f32_drop", fa, dense, lambda: p22_run(
        fluid, lambda: p22_bert(fluid, bert, drop=P22_DROP, tp=True), feed,
        P22_DROP_STEPS, tp, data_axis="dp", params=False))
    batches = [nmt_feed(stack, P22_DEVICE)
               for stack, _ in nmt_batches(NMT_B, NMT_T, 1)]

    def tp_nmt():
        from paddle_tpu_torch.parallel import NMT_RULES, annotate_tp

        main, startup, loss = nmt_program(
            fluid, nmt, nmt.TransformerConfig(dropout=P22_DROP), NMT_T, True)
        annotate_tp(main, NMT_RULES)
        return main, startup, loss

    p22_counted(rec, "tp_nmt_bf16_drop", fas, sparse, lambda: p22_run(
        fluid, tp_nmt, batches[0], P22_NMT_STEPS, tp, data_axis="dp",
        params=False))
    sp = {"dp": 1, "sp": world}
    for drop in (0.0, P22_DROP):
        p22_counted(rec, f"sp_f32_drop{drop}", fa, dense, lambda: p22_run(
            fluid, lambda: p22_bert(fluid, bert, drop=drop), feed,
            P22_DROP_STEPS, sp, data_axis="dp", seq_axis="sp",
            params=False))
    return rec, params



def p22_composed(fluid, fa, rank, world):
    """What the four ranks of (e) run: BERT-base at full width and
    P22_COMPOSED_LAYERS layers over tp2×pp2, f32."""
    from paddle_tpu_torch.models import bert

    feed = pretrain_feed(P22_B, P22_T, np.random.RandomState(22))
    rec = {"rank": rank}
    _, params, _ = p22_counted(
        rec, "composed_f32", fa, ("flash_attention_fwd",
                                  "flash_attention_bwd"),
        lambda: p22_run(fluid, lambda: p22_bert(
            fluid, bert, layers=P22_COMPOSED_LAYERS, stages=2, tp=True),
            feed, P22_F32_STEPS, {"tp": 2, "pp": 2}))
    return rec, params


def p22_job(fluid, fa, fas, job, rank, world, ckdir):
    if job == "pair":
        return p22_pair(fluid, fa, fas, rank, world, ckdir)
    if job == "rest_pair":
        return p23_pair(fluid, fa, rank, world)
    if job == "rest_quad":
        return p23_quad(fluid, fa, rank, world)
    return p22_composed(fluid, fa, rank, world)


def p22_worker(rank, world, addr, backend, job, ckdir):
    """Rank `rank` > 0 of a phase 22 world (a process of this script)."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.cuda.set_device(rank if backend == "nccl" else 0)
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.ops.kernels import build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import flash_attention_sparse as fas
    from paddle_tpu_torch.parallel import init_parallel_env

    build.build_all(["flash_attention_fwd", "flash_attention_bwd",
                     "flash_attention_sparse"])
    init_parallel_env(addr, world, rank,
                      device="cuda" if backend == "nccl" else "cpu",
                      timeout=600)
    rec, _ = p22_job(fluid, fa, fas, job, rank, world, ckdir)
    every = [None] * world
    dist.all_gather_object(every, rec)
    dist.destroy_process_group()


def p22_world(fluid, fa, fas, job, world, ckdir):
    """Run `job` on a group of `world` ranks: this process is rank 0,
    ranks 1.. are processes of this script (NCCL where there are enough
    cards, else a gloo group on the one card). Returns (every rank's
    record, rank 0's parameters, the backend)."""
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import init_parallel_env

    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    addr = f"127.0.0.1:{p20_free_port()}"
    workers = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 "--p22-rank", str(r), "--p22-world",
                                 str(world), "--p22-addr", addr,
                                 "--p22-backend", backend, "--p22-job", job,
                                 "--p22-ck", ckdir])
               for r in range(1, world)]
    try:
        init_parallel_env(addr, world, 0,
                          device="cuda" if backend == "nccl" else "cpu",
                          timeout=600)
        rec, params = p22_job(fluid, fa, fas, job, 0, world, ckdir)
        every = [None] * world
        dist.all_gather_object(every, rec)
        dist.destroy_process_group()
        for w in workers:
            if w.wait(timeout=600) != 0:
                raise AssertionError(f"phase 22 rank exited {w.returncode}")
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.wait()
    return every, params, backend


def phase_pipelines(fluid, fa, fas, smi):
    """Phase 22 (module docstring). Returns the launches of its main paths
    over every rank: {"dense": {("fwd"|"bwd", dtype): n}, "sparse":
    {dtype: {"fwd"|"bwd": n}}}."""
    import torch

    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel import Checkpointer
    from paddle_tpu_torch.parallel.pipeline import schedule_info

    t_phase = time.perf_counter()
    probe = p22_probe(P22_WORLD)
    log("pipelines: gloo point-to-point probe " + json.dumps(probe))
    keep_bits = p22_keep_bits(fa, fas)
    ckdir = tempfile.mkdtemp(prefix="p22-ck-")
    pair, pp_params, backend = p22_world(fluid, fa, fas, "pair", P22_WORLD,
                                         ckdir)
    t_pair = time.perf_counter() - t_phase
    comp, comp_params, _ = p22_world(fluid, fa, fas, "composed",
                                     P22_COMPOSED_WORLD, ckdir)
    t_mesh = time.perf_counter() - t_phase
    feed = pretrain_feed(P22_B, P22_T, np.random.RandomState(22))

    def init_of(build):
        main, startup, _ = build()
        scope = fluid.Scope()
        fluid.Executor(p22_place(fluid)).run(startup, scope=scope)
        return {p.name: scope.find_var(p.name).detach().float().cpu()
                .clone() for p in main.all_parameters()}

    plain = {}
    init = init_of(lambda: p22_bert(fluid, bert))
    _, ref_params, plain["f32"] = p22_run(
        fluid, lambda: p22_bert(fluid, bert), feed, P22_F32_STEPS)
    _, _, plain["bf16_drop"] = p22_run(
        fluid, lambda: p22_bert(fluid, bert, amp=True, drop=P22_DROP), feed,
        P22_BF16_STEPS, params=False)
    _, _, plain["f32_drop"] = p22_run(
        fluid, lambda: p22_bert(fluid, bert, drop=P22_DROP), feed,
        P22_DROP_STEPS, params=False)
    comp_init = init_of(lambda: p22_bert(fluid, bert,
                                         layers=P22_COMPOSED_LAYERS))
    _, comp_ref, plain["composed_f32"] = p22_run(
        fluid, lambda: p22_bert(fluid, bert, layers=P22_COMPOSED_LAYERS),
        feed, P22_F32_STEPS)
    # (f) the pp = 2 checkpoint restored into the plain executor
    main, startup, loss = p22_bert(fluid, bert)
    exe = fluid.Executor(p22_place(fluid))
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        restored = Checkpointer(ckdir).restore(program=main, scope=scope,
                                               place=p22_place(fluid))
        (lv,) = exe.run(main, feed=feed, fetch_list=[loss])
        ck_loss = float(np.asarray(lv, np.float32).reshape(-1)[0])
    del scope
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()
    r0, c0 = pair[0], comp[0]
    n = P22_WORLD
    masks = r0["pp_masks"]["fetched"]
    mb = P22_B // P22_MICRO
    checks = {
        "pp_f32_loss_rel": p21_rel(r0["pp_f32"]["losses"],
                                   plain["f32"]["losses"]),
        "pp_f32_delta_rel": p21_delta_rel(pp_params, ref_params, init),
        "pp_bf16_losses_finite": all(np.isfinite(x) for r in pair
                                     for x in r["pp_bf16"]["losses"]),
        "pp_bf16_drop_loss_rel_vs_plain": p21_rel(
            r0["pp_bf16"]["losses"], plain["bf16_drop"]["losses"]),
        "pp_masks_differ_between_microbatches": all(
            not np.array_equal(masks[i * mb:(i + 1) * mb],
                               masks[j * mb:(j + 1) * mb])
            for i in range(P22_MICRO) for j in range(i)),
        "pp_masks_zero_share": float((masks == 0).mean()),
        "tp_f32_drop_loss_rel": p21_rel(r0["tp_f32_drop"]["losses"],
                                        plain["f32_drop"]["losses"]),
        "sp_f32_loss_rel": p21_rel(r0["sp_f32_drop0.0"]["losses"],
                                   plain["f32"]["losses"][:P22_DROP_STEPS]),
        "sp_f32_drop_loss_rel": p21_rel(r0[f"sp_f32_drop{P22_DROP}"]
                                        ["losses"],
                                        plain["f32_drop"]["losses"]),
        "composed_f32_loss_rel": p21_rel(c0["composed_f32"]["losses"],
                                         plain["composed_f32"]["losses"]),
        "composed_f32_delta_rel": p21_delta_rel(comp_params, comp_ref,
                                                comp_init),
        "ckpt_restored_step": restored,
        "ckpt_next_loss_rel": p21_rel([ck_loss], [r0["pp_f32"]["next_loss"]]),
        "r_params_bitwise_equal": all(
            r[k].get("r_params_bitwise_equal", True)
            for rs, keys in ((pair, ("pp_f32", "pp_bf16", "tp_f32_drop",
                                     "tp_nmt_bf16_drop", "sp_f32_drop0.0",
                                     f"sp_f32_drop{P22_DROP}")),
                             (comp, ("composed_f32",)))
            for r in rs for k in keys),
        "keep_bits": keep_bits,
    }
    sched = {"gpipe": schedule_info("gpipe", n, P22_MICRO)}
    runs = {k: {f: r0[k][f] for f in ("losses", "step_ms", "peak_MiB",
                                      "state_bytes_per_rank", "launches",
                                      "plain_on_cuda", "shapes", "s")}
            for k in ("pp_f32", "pp_bf16", "tp_f32_drop", "tp_nmt_bf16_drop",
                      "sp_f32_drop0.0", f"sp_f32_drop{P22_DROP}")}
    runs["composed_f32"] = {f: c0["composed_f32"][f] for f in (
        "losses", "step_ms", "peak_MiB", "state_bytes_per_rank", "launches",
        "plain_on_cuda", "shapes", "s")}
    out = {"backend": backend, "probe": probe, "schedule": sched,
           "runs": runs, "plain": {k: {f: v[f] for f in (
               "losses", "step_ms", "peak_MiB", "state_bytes_per_rank")}
               for k, v in plain.items()},
           "checks": checks, "pair_s": t_pair, "mesh_s": t_mesh,
           "device": smi}
    plain_on_cuda = sum(r[k]["plain_on_cuda"] for r in pair
                        for k in runs if k in r) + sum(
        r["composed_f32"]["plain_on_cuda"] for r in comp)

    def total(rs, k):
        return {d: sum(r[k]["launches"][d] for r in rs)
                for d in ("fwd", "bwd")}

    launches = {k: total(pair, k) for k in runs if k != "composed_f32"}
    launches["composed_f32"] = total(comp, "composed_f32")
    out.update(launches=launches, plain_on_cuda=plain_on_cuda,
               wall_s=time.perf_counter() - t_phase)
    log("pipelines " + json.dumps(out, default=str))
    half = P22_LAYERS // n
    want = {"pp_f32": n * half * P22_MICRO * (P22_F32_STEPS + 1),
            "pp_bf16": n * half * P22_MICRO * P22_BF16_STEPS,
            "tp_f32_drop": n * P22_LAYERS * P22_DROP_STEPS,
            "tp_nmt_bf16_drop": n * NMT_PER_STEP * P22_NMT_STEPS,
            "sp_f32_drop0.0": n * P22_LAYERS * P22_DROP_STEPS,
            f"sp_f32_drop{P22_DROP}": n * P22_LAYERS * P22_DROP_STEPS,
            "composed_f32": P22_COMPOSED_WORLD
            * (P22_COMPOSED_LAYERS // 2) * P22_MICRO * P22_F32_STEPS}
    bad = [f"{k} launches {launches[k]}, expected {m} each"
           for k, m in want.items() if launches[k] != {"fwd": m, "bwd": m}]
    for key, limit in (("pp_f32_loss_rel", P22_LOSS_REL),
                       ("pp_f32_delta_rel", P21_DELTA_REL),
                       ("tp_f32_drop_loss_rel", P22_LOSS_REL),
                       ("sp_f32_loss_rel", P22_LOSS_REL),
                       ("sp_f32_drop_loss_rel", P22_LOSS_REL),
                       ("composed_f32_loss_rel", P21_LOSS_REL),
                       ("composed_f32_delta_rel", P21_DELTA_REL),
                       ("ckpt_next_loss_rel", P22_LOSS_REL)):
        if not checks[key] <= limit:
            bad.append(f"{key} {checks[key]} over {limit}")
    if checks["ckpt_restored_step"] != P22_F32_STEPS:
        bad.append(f"checkpoint restored step {checks['ckpt_restored_step']}")
    if not checks["r_params_bitwise_equal"]:
        bad.append("replicated parameters differ across the ranks")
    if not checks["pp_bf16_losses_finite"]:
        bad.append("a pp bf16 loss is not finite")
    if not (checks["pp_masks_differ_between_microbatches"]
            and 0.5 < checks["pp_masks_zero_share"] < 0.9):
        bad.append(f"pipeline dropout masks: {checks['pp_masks_zero_share']}")
    shapes = {"pp_f32": [(NH, P22_T, P22_T)],
              "tp_f32_drop": [(NH // n, P22_T, P22_T)],
              "sp_f32_drop0.0": [(NH, P22_T // n, P22_T)],
              f"sp_f32_drop{P22_DROP}": [(NH, P22_T // n, P22_T)],
              "composed_f32": [(NH // 2, P22_T, P22_T)]}
    bad += [f"{k} kernels saw {runs[k]['shapes']}, expected {v}"
            for k, v in shapes.items()
            if [tuple(x) for x in runs[k]["shapes"]] != v]
    if plain_on_cuda:
        bad.append(f"plain calls on the card: {plain_on_cuda}")
    if bad:
        raise AssertionError(f"phase 22: {bad}")
    return out


# -- phase 23: model parallelism, the rest (several axes at once, ops
# across the batch dim, moe_ffn off the data axis, a clip across stages) --
P23_PAIR, P23_QUAD = 2, 4
P23_CLIP = 0.05           # below the global norm in every step: printed
P23_CLIP_STEPS, P23_CLIP_BF16_STEPS, P23_TPSP_STEPS = 3, 2, 2
P23_HEAD_LAYERS, P23_HEAD_STEPS = 4, 2
P23_MOE = dict(P21_MOE, cf=1.25)
# pp + clip: losses within 1e-5 relative of the plain run's (each stage's
# gradient sums its microbatches, so the norm may differ in its last bits),
# parameter changes within P21_DELTA_REL; tp×sp with dropout within 1e-6;
# moe_ffn's Out, AuxLoss and gradients within 1e-5 of the largest value;
# the rule-A head's losses within 1e-5, changes within P21_DELTA_REL
P23_LOSS_REL, P23_TPSP_REL, P23_MOE_REL = 1e-5, 1e-6, 1e-5


def p23_head(fluid, bert, layers=P23_HEAD_LAYERS):
    """BERT-base's encoder (hidden 768, 12 heads, `layers` layers; B =
    P22_B, T = P22_T) → sequence_unpad → sequence_pool (average, row by
    row over each row's length) → the pooled rows weighted by their
    softmax along dim 0 (across the batch: rule A on a data axis) → fc →
    mean square; Adam(LR)."""
    L = fluid.layers
    cfg = bert.BertConfig(vocab_size=30522, hidden_size=HIDDEN,
                          num_layers=layers, num_heads=NH, ffn_size=3072,
                          max_position=512, hidden_dropout=0.0,
                          attn_dropout=0.0)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        src = L.data("src_ids", [P22_T], dtype="int64")
        pos = L.data("pos_ids", [P22_T], dtype="int64")
        sent = L.data("sent_ids", [P22_T], dtype="int64")
        mask = L.data("input_mask", [P22_T], dtype="float32")
        length = L.data("len", [], dtype="int64")
        neg = L.scale(L.elementwise_add(
            mask, L.fill_constant([1], "float32", -1.0)), scale=10000.0)
        mask4 = L.unsqueeze(neg, [1])
        x = bert.embeddings(cfg, src, pos, sent)
        for i in range(layers):
            x = bert.encoder_layer(cfg, x, mask4, i)
        pooled = L.sequence_pool(L.sequence_unpad(x, length), "average",
                                 length=length)
        p = L.elementwise_mul(L.softmax(pooled, axis=0), pooled)
        loss = L.mean(L.square(L.fc(p, 2)))
        fluid.optimizer.Adam(LR).minimize(loss)
    main.random_seed = startup.random_seed = 2024
    return main, startup, loss


def p23_head_feed():
    feed = pretrain_feed(P22_B, P22_T, np.random.RandomState(23))
    feed.pop("mlm_labels")
    feed["len"] = feed["input_mask"].sum(1).astype("int64")
    return feed


def p23_moe(fluid):
    """layers.moe_ffn at P23_MOE's widths (cf 1.25, gelu), f32, SGD(0):
    one step gives Out, AuxLoss and the gradients (fetched by name)."""
    m = P23_MOE
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [m["d"]])
        y = fluid.layers.data("y", [m["d"]])
        h, aux = fluid.layers.moe_ffn(x, num_experts=m["experts"],
                                      hidden_size=m["hidden"], k=m["k"],
                                      capacity_factor=m["cf"])
        mse = fluid.layers.reduce_mean(fluid.layers.square(
            fluid.layers.elementwise_sub(h, y)))
        loss = fluid.layers.elementwise_add(mse,
                                            fluid.layers.scale(aux, 0.01))
        fluid.optimizer.SGD(0.0).minimize(loss)
    main.random_seed = startup.random_seed = 2024
    return main, startup, loss, h, aux


def p23_moe_once(fluid, feed, axes=None, data_axis=None):
    """One step of p23_moe on `feed` (this rank's rows on a mesh of
    `axes`, or the whole batch on the plain executor): {"Out", "AuxLoss",
    every parameter's gradient} on the host, Out gathered in rank order."""
    import torch

    from paddle_tpu_torch.parallel import make_mesh

    main, startup, loss, h, aux = p23_moe(fluid)
    grads = [p.name + "@GRAD" for p in main.all_parameters()]
    exe = fluid.Executor(p22_place(fluid))
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)
        prog = main if axes is None else fluid.CompiledProgram(
            main).with_mesh(make_mesh(axes), data_axis=data_axis)
        got = exe.run(prog, feed=feed, fetch_list=[h, aux] + grads,
                      return_numpy=False)
    out = {k: torch.as_tensor(v).detach().float().cpu()
           for k, v in zip(["Out", "AuxLoss"] + grads, got)}
    del scope
    torch.cuda.empty_cache()
    return out


def p23_moe_rel(got, want):
    """max over the values of max|got − want| / max|want|."""
    return max(float((got[k] - w).abs().max()) / max(
        float(w.abs().max()), 1e-30) for k, w in want.items())


def p23_pair(fluid, fa, rank, world):
    """What the two ranks of (a)-(c) run, in one order. Returns (this
    rank's record, {run: final parameters})."""
    from paddle_tpu_torch.models import bert

    dense = ("flash_attention_fwd", "flash_attention_bwd")
    feed = pretrain_feed(P22_B, P22_T, np.random.RandomState(23))
    rec = {"rank": rank}
    pp = {"pp": world}
    _, clip_params, _ = p22_counted(rec, "pp_clip_f32", fa, dense,
                                    lambda: p22_run(
        fluid, lambda: p22_bert(fluid, bert, stages=world, clip=P23_CLIP),
        feed, P23_CLIP_STEPS, pp))
    p22_counted(rec, "pp_clip_bf16", fa, dense, lambda: p22_run(
        fluid, lambda: p22_bert(fluid, bert, amp=True, drop=P22_DROP,
                                stages=world, clip=P23_CLIP), feed,
        P23_CLIP_BF16_STEPS, pp, params=False))
    moe_feed = p21_moe_feed(world)
    rec["moe_dp"] = p23_moe_once(fluid, p20_rows(moe_feed, rank, world),
                                 {"dp": world}, "dp")
    head = p23_head_feed()
    _, head_params, rec["head_dp"] = p22_run(
        fluid, lambda: p23_head(fluid, bert), p20_rows(head, rank, world),
        P23_HEAD_STEPS, {"dp": world}, data_axis="dp")
    return rec, {"pp_clip_f32": clip_params, "head_dp": head_params}


def p23_quad(fluid, fa, rank, world):
    """What the four ranks of (d)-(e) run: BERT-base f32 on tp2×sp2 with
    attention and hidden dropout (every rank feeds the whole batch: the
    masks are the plain run's), and moe_ffn on {"dp": 2, "ep": 2}."""
    from paddle_tpu_torch.models import bert

    feed = pretrain_feed(P22_B, P22_T, np.random.RandomState(23))
    rec = {"rank": rank}
    p22_counted(rec, "tpsp_f32_drop", fa, ("flash_attention_fwd",
                                           "flash_attention_bwd"),
                lambda: p22_run(fluid, lambda: p22_bert(
                    fluid, bert, drop=P22_DROP, tp=True), feed,
                    P23_TPSP_STEPS, {"tp": 2, "sp": 2}, seq_axis="sp",
                    params=False))
    rec["moe_dp_ep"] = p23_moe_once(
        fluid, p20_rows(p21_moe_feed(world // 2), rank // 2, 2),
        {"dp": 2, "ep": 2}, "dp")
    return rec, {}


def phase_model_parallel_rest(fluid, fa, smi):
    """Phase 23 (module docstring). Returns the flash launches of its main
    paths over every rank: {run: {"fwd"|"bwd": n}} (dtype in the run's
    name)."""
    import torch

    from paddle_tpu_torch.models import bert

    t_phase = time.perf_counter()
    pair, pair_params, backend = p22_world(fluid, fa, None, "rest_pair",
                                           P23_PAIR, "")
    t_pair = time.perf_counter() - t_phase
    quad, _, _ = p22_world(fluid, fa, None, "rest_quad", P23_QUAD, "")
    t_mesh = time.perf_counter() - t_phase
    feed = pretrain_feed(P22_B, P22_T, np.random.RandomState(23))

    def init_of(build):
        main, startup = build()[:2]
        scope = fluid.Scope()
        fluid.Executor(p22_place(fluid)).run(startup, scope=scope)
        return {p.name: scope.find_var(p.name).detach().float().cpu()
                .clone() for p in main.all_parameters()}

    plain = {}
    clip_init = init_of(lambda: p22_bert(fluid, bert, clip=P23_CLIP))
    _, clip_ref, plain["clip_f32"] = p22_run(
        fluid, lambda: p22_bert(fluid, bert, clip=P23_CLIP), feed,
        P23_CLIP_STEPS)
    _, _, plain["tpsp_f32_drop"] = p22_run(
        fluid, lambda: p22_bert(fluid, bert, drop=P22_DROP, tp=True), feed,
        P23_TPSP_STEPS, params=False)
    head_init = init_of(lambda: p23_head(fluid, bert))
    _, head_ref, plain["head"] = p22_run(
        fluid, lambda: p23_head(fluid, bert), p23_head_feed(),
        P23_HEAD_STEPS)
    moe_ref = {"dp": p23_moe_once(fluid, p21_moe_feed(P23_PAIR)),
               "dp_ep": p23_moe_once(fluid, p21_moe_feed(P23_QUAD // 2))}
    torch.cuda.empty_cache()
    r0, q0 = pair[0], quad[0]
    factors = {k: [min(1.0, P23_CLIP / max(float(np.asarray(g).item()),
                                          P23_CLIP))
                   for g in v] for k, v in (
        ("pp_f32", r0["pp_clip_f32"]["fetched_steps"]),
        ("pp_bf16", r0["pp_clip_bf16"]["fetched_steps"]),
        ("plain_f32", plain["clip_f32"]["fetched_steps"]))}
    checks = {
        "clip_factors": factors,
        "pp_clip_f32_loss_rel": p21_rel(r0["pp_clip_f32"]["losses"],
                                        plain["clip_f32"]["losses"]),
        "pp_clip_f32_delta_rel": p21_delta_rel(
            pair_params["pp_clip_f32"], clip_ref, clip_init),
        "pp_clip_bf16_losses_finite": all(
            np.isfinite(x) for r in pair
            for x in r["pp_clip_bf16"]["losses"]),
        "tpsp_f32_drop_loss_rel": p21_rel(q0["tpsp_f32_drop"]["losses"],
                                          plain["tpsp_f32_drop"]["losses"]),
        "moe_dp_rel": max(p23_moe_rel(r["moe_dp"], moe_ref["dp"])
                          for r in pair),
        "moe_dp_ep_rel": max(p23_moe_rel(r["moe_dp_ep"], moe_ref["dp_ep"])
                             for r in quad),
        "head_loss_rel": p21_rel(r0["head_dp"]["losses"],
                                 plain["head"]["losses"]),
        "head_delta_rel": p21_delta_rel(pair_params["head_dp"], head_ref,
                                        head_init),
        "r_params_bitwise_equal": all(
            r[k].get("r_params_bitwise_equal", True)
            for rs, keys in ((pair, ("pp_clip_f32", "pp_clip_bf16",
                                     "head_dp")),
                             (quad, ("tpsp_f32_drop",)))
            for r in rs for k in keys),
    }
    fields = ("losses", "step_ms", "peak_MiB", "state_bytes_per_rank")
    runs = {k: {f: r0[k][f] for f in fields + ("launches", "plain_on_cuda",
                                               "shapes", "s")}
            for k in ("pp_clip_f32", "pp_clip_bf16")}
    runs["head_dp"] = {f: r0["head_dp"][f] for f in fields}
    runs["tpsp_f32_drop"] = {f: q0["tpsp_f32_drop"][f] for f in fields + (
        "launches", "plain_on_cuda", "shapes", "s")}
    out = {"backend": backend, "runs": runs,
           "plain": {k: {f: v[f] for f in fields} for k, v in plain.items()},
           "checks": checks, "pair_s": t_pair, "mesh_s": t_mesh,
           "device": smi}
    plain_on_cuda = sum(r[k]["plain_on_cuda"] for r in pair
                        for k in ("pp_clip_f32", "pp_clip_bf16")) + sum(
        r["tpsp_f32_drop"]["plain_on_cuda"] for r in quad)

    def total(rs, k):
        return {d: sum(r[k]["launches"][d] for r in rs)
                for d in ("fwd", "bwd")}

    launches = {k: total(pair, k) for k in ("pp_clip_f32", "pp_clip_bf16")}
    launches["tpsp_f32_drop"] = total(quad, "tpsp_f32_drop")
    out.update(launches=launches, plain_on_cuda=plain_on_cuda,
               wall_s=time.perf_counter() - t_phase)
    log("model_parallel_rest " + json.dumps(out, default=str))
    half = P22_LAYERS // P23_PAIR
    want = {"pp_clip_f32": P23_PAIR * half * P22_MICRO * P23_CLIP_STEPS,
            "pp_clip_bf16": P23_PAIR * half * P22_MICRO
            * P23_CLIP_BF16_STEPS,
            "tpsp_f32_drop": P23_QUAD * P22_LAYERS * P23_TPSP_STEPS}
    bad = [f"{k} launches {launches[k]}, expected {m} each"
           for k, m in want.items() if launches[k] != {"fwd": m, "bwd": m}]
    for key, limit in (("pp_clip_f32_loss_rel", P23_LOSS_REL),
                       ("pp_clip_f32_delta_rel", P21_DELTA_REL),
                       ("tpsp_f32_drop_loss_rel", P23_TPSP_REL),
                       ("moe_dp_rel", P23_MOE_REL),
                       ("moe_dp_ep_rel", P23_MOE_REL),
                       ("head_loss_rel", P23_LOSS_REL),
                       ("head_delta_rel", P21_DELTA_REL)):
        if not checks[key] <= limit:
            bad.append(f"{key} {checks[key]} over {limit}")
    if not all(f < 1.0 for v in factors.values() for f in v):
        bad.append(f"a clip factor is not below 1: {factors}")
    if not checks["r_params_bitwise_equal"]:
        bad.append("replicated parameters differ across the ranks")
    if not checks["pp_clip_bf16_losses_finite"]:
        bad.append("a pp bf16 loss is not finite")
    shapes = {"pp_clip_f32": [(NH, P22_T, P22_T)],
              "tpsp_f32_drop": [(NH // 2, P22_T // 2, P22_T)]}
    bad += [f"{k} kernels saw {runs[k]['shapes']}, expected {v}"
            for k, v in shapes.items()
            if [tuple(x) for x in runs[k]["shapes"]] != v]
    if plain_on_cuda:
        bad.append(f"plain calls on the card: {plain_on_cuda}")
    if bad:
        raise AssertionError(f"phase 23: {bad}")
    return out



# -- phase 24: fleet and cluster (the fleet API and role makers, DGC
# momentum, local SGD and the DGC exchanges, elastic training, the memory
# planner, the deferred fold on a mesh) -----------------------------------

P24_DEVICE = "cuda"
P24_B, P24_T = 8, 512            # BERT-base f32 on the fleet path
P24_STEPS, P24_PLAIN_STEPS = 6, 3  # fleet steps; the first 3 against plain
P24_DGC_STEPS, P24_DGC_BEGIN, P24_DGC_SPARSITY = 4, 2, [0.999]
P24_MLP = (64, 256, 16)          # local SGD: in, hidden, rows a rank
P24_SGD_K, P24_SGD_STEPS, P24_SGD_LR = 3, 6, 0.01
P24_EXCHANGE_N, P24_EXCHANGE_RATIO = 1 << 22, 0.001
P24_KILL_AFTER = 3               # SIGTERM once this many steps printed
P24_DEEPFM = {"vocab": 1_000_000, "B": 4096, "segments": 4, "steps": 8}
P24_FOLD_REL = 1e-5
P24_EXCHANGE_TOL = 1e-6
# the planner's measured bytes over the allocator's peak of the same steps:
# 0.9940-0.9963 over six candidates at B = 8 (two runs on an H100 80GB
# HBM3, 700 W); the allocator's rounding and cuBLAS's workspace are not
# ops' outputs, so the count stays under the peak
P24_PLAN_RATIO = (0.97, 1.0)
# BERT-base f32 at T = P24_T whose stage-0 step outgrows the card's 80 GB
# (about 0.96 GB of activations a sequence, 9.45 GB in all at B = 8) and
# whose remat "minimal" step (about 0.53 GB a sequence) fits its budget
P24_OOM_B = 112
P24_WORLD = 2


def p24_place(fluid):
    return fluid.CUDAPlace(0) if P24_DEVICE == "cuda" else fluid.CPUPlace()


def p24_sync():
    import torch

    if P24_DEVICE == "cuda":
        torch.cuda.synchronize()


def p24_fleet_program(fluid, bert):
    """BERT-base f32 (dropout 0) through the fleet path: Adam(LR) wrapped
    by ``fleet.distributed_optimizer(..., DistributedStrategy())``; the
    fleet must be initialised. Returns (main, startup, loss, the fleet's
    CompiledProgram)."""
    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.parallel.fleet import fleet
    from paddle_tpu_torch.parallel.mesh import DistributedStrategy

    with unique_name.guard():
        main, startup, loss = build_pretrain(
            fluid, bert, P24_B, P24_T, False, dropout=0.0,
            optimizer=lambda wrap: fleet.distributed_optimizer(
                fluid.optimizer.Adam(LR), DistributedStrategy()))
    return main, startup, loss, fleet.main_program


def p24_steps(fluid, prog, startup, loss, feed, steps, scope=None):
    """`steps` runs of `prog` from its startup (or from `scope`): (loss
    bytes a step, losses, host ms a step, the scope)."""
    exe = fluid.Executor(p24_place(fluid))
    if scope is None:
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
    raw, losses, ms = [], [], []
    for _ in range(steps):
        p24_sync()
        t0 = time.perf_counter()
        (lv,) = exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
        p24_sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        a = np.asarray(lv, np.float32).reshape(-1)
        raw.append(a.tobytes())
        losses.append(float(a[0]))
    return raw, losses, ms, scope


def p24_fleet(fluid, fa, bert, feed, port):
    """(1) The fleet path on an NCCL group of one: distributed.launch's
    env for one trainer, fleet.init(PaddleCloudRoleMaker()), minimize,
    P24_STEPS steps of fleet.main_program; the first P24_PLAIN_STEPS
    losses bitwise the plain executor's. Returns (record, the fleet
    losses, the fleet's main program and loss)."""
    import torch

    from paddle_tpu_torch.distributed import launch
    from paddle_tpu_torch.parallel.fleet import PaddleCloudRoleMaker, fleet

    env = launch.trainer_env(0, 1, port)
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        fleet.init(PaddleCloudRoleMaker())
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if not (fleet.is_worker() and fleet.is_first_worker()
            and fleet.worker_num() == 1):
        raise AssertionError("phase 24: the fleet is not one first worker")
    main, startup, loss, prog = p24_fleet_program(fluid, bert)
    with_mesh = prog._mesh is not None
    flash_reset(fa)                                  # main path starts
    raw, losses, ms, scope = p24_steps(fluid, prog, startup, loss, feed,
                                       P24_STEPS)
    launches = {"fwd": fa.flash_attention_fwd.launches,
                "bwd": fa.flash_attention_bwd.launches}
    plain_calls = (fa.flash_attention_fwd.plain_on_cuda
                   + fa.flash_attention_bwd.plain_on_cuda)  # main path ends
    del scope
    torch.cuda.empty_cache()
    from paddle_tpu_torch.core import unique_name
    with unique_name.guard():
        pmain, pstartup, ploss = build_pretrain(
            fluid, bert, P24_B, P24_T, False, dropout=0.0)
    praw, plosses, pms, pscope = p24_steps(fluid, pmain, pstartup, ploss,
                                           feed, P24_PLAIN_STEPS)
    del pscope
    torch.cuda.empty_cache()
    rec = {"losses": losses, "plain_losses": plosses,
           "bitwise_plain": raw[:P24_PLAIN_STEPS] == praw,
           "step_ms": ms, "plain_step_ms": pms, "mesh": with_mesh,
           "launches": launches, "plain_on_cuda": plain_calls}
    bad = []
    if not with_mesh:
        bad.append("fleet.main_program has no mesh on the group of one")
    if not rec["bitwise_plain"]:
        bad.append(f"fleet losses {losses[:P24_PLAIN_STEPS]} differ from "
                   f"the plain executor's {plosses}")
    want = 12 * P24_STEPS
    if launches != {"fwd": want, "bwd": want} or plain_calls:
        bad.append(f"fleet flash launches {launches}, plain {plain_calls}; "
                   f"expected {want} each")
    if bad:
        raise AssertionError(f"phase 24 fleet: {bad}")
    return rec, losses, main, loss


def p24_changed(before, after):
    """{name: entries that changed} of two {name: tensor} snapshots."""
    return {n: int((after[n] != before[n]).sum()) for n in before}


def p24_dgc(fluid, fb):
    """(2) ResNet-50 bf16 AMP at B=RESNET_B, 224², under DGC momentum
    (rampup_begin_step=2, sparsity [0.999]) against Momentum: the dense
    steps bitwise Momentum's (losses and every parameter), in the sparse
    steps each parameter changes in exactly its kept count of entries;
    the step ms of both, torch.topk's device ms a sparse step and the
    fused-BN launches of the DGC run."""
    import torch

    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.models import resnet

    os.environ["PDTPU_BN_MODE"] = "pallas"
    feed = resnet_feed(RESNET_B, RESNET_HW, device=P24_DEVICE)

    def build(dgc):
        opt = None
        if dgc:
            def opt():
                return fluid.optimizer.DGCMomentumOptimizer(
                    0.1, 0.9, rampup_begin_step=P24_DGC_BEGIN,
                    sparsity=P24_DGC_SPARSITY)
        with unique_name.guard():
            return resnet_program(fluid, resnet, RESNET_B, RESNET_HW, True,
                                  optimizer=opt)

    def params(main, scope):
        return {p.name: scope.find_var(p.name).detach().clone()
                for p in main.all_parameters()}

    exe = fluid.Executor(p24_place(fluid))
    main, startup, loss = build(False)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    mom_losses, mom_ms = [], []
    for _ in range(P24_DGC_BEGIN):
        p24_sync()
        t0 = time.perf_counter()
        (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        p24_sync()
        mom_ms.append((time.perf_counter() - t0) * 1e3)
        mom_losses.append(np.asarray(lv, np.float32).tobytes())
    mom_params = params(main, scope)
    del scope
    torch.cuda.empty_cache()

    main, startup, loss = build(True)
    if sum(op.type == "dgc_momentum" for op in main.global_block().ops) \
            != len(main.all_parameters()):
        raise AssertionError("phase 24: not one dgc_momentum op a parameter")
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    reset_bn_counts(fb)                              # main path starts
    losses, ms, snaps = [], [], [params(main, scope)]
    for _ in range(P24_DGC_STEPS):
        p24_sync()
        t0 = time.perf_counter()
        (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        p24_sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(np.asarray(lv, np.float32).tobytes())
        snaps.append(params(main, scope))
    counts = bn_counts(fb)                           # main path ends
    kept = {n: max(1, int(v.numel() * (1.0 - P24_DGC_SPARSITY[-1])))
            for n, v in snaps[0].items()}
    sparse_changed = [p24_changed(snaps[i], snaps[i + 1])
                      for i in range(P24_DGC_BEGIN, P24_DGC_STEPS)]
    dense_equal = all(bool(torch.equal(snaps[P24_DGC_BEGIN][n], v))
                      for n, v in mom_params.items())
    topk, per = {}, {}
    if P24_DEVICE == "cuda":
        # not retaken: a session of this step takes ~9 s to read
        per, _, _ = profile_device(lambda: exe.run(
            main, feed=feed, fetch_list=[loss], scope=scope), iters=2,
            label="p24 dgc step")
        topk = {k[:90]: v / 1e3 for k, v in per.items()
                if any(s in k.lower() for s in ("topk", "radix", "kthvalue"))}
    # an incomplete session gives no reading (None), not a zero
    topk_ms = sum(topk.values()) if per else None
    del scope, snaps
    torch.cuda.empty_cache()
    wrong = {n: (c, kept[n]) for changed in sparse_changed
             for n, c in changed.items() if c != kept[n]}
    rec = {"momentum_step_ms": mom_ms, "dgc_step_ms": ms,
           "dense_losses_bitwise": losses[:P24_DGC_BEGIN] == mom_losses,
           "dense_params_bitwise": dense_equal,
           "losses": [float(np.frombuffer(b, np.float32)[0])
                      for b in losses],
           "kept_total": sum(kept.values()),
           "changed_total": [sum(c.values()) for c in sparse_changed],
           "params": len(kept), "topk_device_ms_a_step": topk_ms,
           "topk_kernels_ms": topk, "fused_bn_launches": counts}
    bad = []
    if not (rec["dense_losses_bitwise"] and dense_equal):
        bad.append("the dense steps differ from Momentum's")
    if wrong:
        bad.append(f"changed entries differ from the kept counts: "
                   f"{dict(list(wrong.items())[:8])}")
    if not np.isfinite(rec["losses"]).all():
        bad.append(f"losses {rec['losses']}")
    per_step = {k: v / P24_DGC_STEPS for k, v in counts.items()}
    if per_step != {k: float(v) for k, v in RESNET_PER_STEP.items()}:
        bad.append(f"fused-BN launches per step {per_step}")
    if bad:
        raise AssertionError(f"phase 24 dgc: {bad}")
    return rec, counts


def p24_pair_job(rank, world):
    """(3) On each rank of the gloo pair (CUDA tensors): local SGD on an
    MLP at k=P24_SGD_K (every replica gathered after each step), and both
    DGC exchanges of a 4 Mi-element gradient against the dense sum of
    every rank's top-k (gathered)."""
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import (dgc_allreduce, local_sgd_step,
                                           replicate_params,
                                           sparse_allgather_exchange,
                                           top_k_sparsify)
    from paddle_tpu_torch.parallel.collective import all_gather_into

    dev = P24_DEVICE
    fin, hid, rows = P24_MLP
    rng = np.random.RandomState(40 + rank)
    x = torch.tensor(rng.rand(rows, fin).astype("float32"), device=dev)
    y = torch.tensor(rng.rand(rows, 1).astype("float32"), device=dev)
    init = np.random.RandomState(41)
    params = replicate_params({
        "w1": torch.tensor(init.randn(fin, hid).astype("float32") * 0.1,
                           device=dev),
        "w2": torch.tensor(init.randn(hid, 1).astype("float32") * 0.1,
                           device=dev)}, world)

    def grad_fn(p, batch):
        w1 = p["w1"].detach().requires_grad_()
        w2 = p["w2"].detach().requires_grad_()
        loss = torch.mean((torch.tanh(batch[0] @ w1) @ w2 - batch[1]) ** 2)
        g1, g2 = torch.autograd.grad(loss, [w1, w2])
        return loss.detach(), {"w1": g1, "w2": g2}

    def spread(p):
        flat = torch.cat([p["w1"].reshape(-1), p["w2"].reshape(-1)])
        every = flat.new_empty(world * flat.numel())
        all_gather_into(every, flat, None)
        every = every.view(world, -1)
        return float((every - every[0]).abs().max())

    step = local_sgd_step(grad_fn, k_steps=P24_SGD_K, lr=P24_SGD_LR)
    sgd_losses, spreads = [], []
    for i in range(P24_SGD_STEPS):
        params, loss = step(params, (x, y), i)
        sgd_losses.append(float(loss))
        spreads.append(spread(params))

    g = torch.tensor(np.random.RandomState(100 + rank).randn(
        P24_EXCHANGE_N).astype("float32"), device=dev)
    r = torch.zeros_like(g)
    mine, _ = top_k_sparsify(g, P24_EXCHANGE_RATIO)
    every = mine.new_empty(world * mine.numel())
    all_gather_into(every, mine.contiguous(), None)
    want = every.view(world, -1).sum(0)
    dense, dres = dgc_allreduce(g, r, ratio=P24_EXCHANGE_RATIO)
    sparse, sres = sparse_allgather_exchange(g, r, ratio=P24_EXCHANGE_RATIO)
    k = max(1, int(P24_EXCHANGE_N * P24_EXCHANGE_RATIO))
    out = {"sgd_losses": sgd_losses, "spreads": spreads,
           "dense_err": float((dense - want).abs().max()),
           "sparse_err": float((sparse - want).abs().max()),
           "residuals_equal": bool(torch.equal(dres, sres)),
           "residual_err": float((dres + mine - g).abs().max()),
           "dense_bytes_a_rank": P24_EXCHANGE_N * 4,
           "sparse_bytes_a_rank": k * (4 + 8)}
    if P24_DEVICE == "cuda":
        out["dense_ms"] = cuda_ms(lambda: dgc_allreduce(
            g, r, ratio=P24_EXCHANGE_RATIO), iters=5, warmup=1)
        out["sparse_ms"] = cuda_ms(lambda: sparse_allgather_exchange(
            g, r, ratio=P24_EXCHANGE_RATIO), iters=5, warmup=1)
    dist.barrier()
    return out


def p24_worker(rank, world, addr):
    """Rank `rank` > 0 of the phase 24 pair (a process of this script)."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if P24_DEVICE == "cuda":
        torch.cuda.set_device(0)
    from paddle_tpu_torch.parallel import init_parallel_env

    init_parallel_env(addr, world, rank, device="cpu", timeout=600)
    rec = p24_pair_job(rank, world)
    every = [None] * world
    dist.all_gather_object(every, rec)
    dist.destroy_process_group()


def p24_pair():
    """(3) The gloo pair on the one card: this process is rank 0."""
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import init_parallel_env

    addr = f"127.0.0.1:{p20_free_port()}"
    workers = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 "--p24-rank", str(r), "--p24-world",
                                 str(P24_WORLD), "--p24-addr", addr])
               for r in range(1, P24_WORLD)]
    try:
        init_parallel_env(addr, P24_WORLD, 0, device="cpu", timeout=600)
        rec = p24_pair_job(0, P24_WORLD)
        every = [None] * P24_WORLD
        dist.all_gather_object(every, rec)
        dist.destroy_process_group()
        for w in workers:
            if w.wait(timeout=600) != 0:
                raise AssertionError(f"phase 24 rank exited {w.returncode}")
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.wait()
    bad = []
    for r, rec in enumerate(every):
        for i, s in enumerate(rec["spreads"]):
            synced = (i + 1) % P24_SGD_K == 0
            if synced and s != 0.0:
                bad.append(f"rank {r} step {i}: replicas differ by {s} "
                           f"after the sync")
            if not synced and not s > 0.0:
                bad.append(f"rank {r} step {i}: replicas equal between syncs")
        for key in ("dense_err", "sparse_err", "residual_err"):
            if not rec[key] <= P24_EXCHANGE_TOL:
                bad.append(f"rank {r} {key} {rec[key]}")
        if not rec["residuals_equal"]:
            bad.append(f"rank {r}: the two exchanges' residuals differ")
    losses = every[0]["sgd_losses"]
    if losses != every[1]["sgd_losses"]:
        bad.append("the ranks' mean losses differ")
    if not losses[-1] < losses[0]:
        bad.append(f"local SGD did not train: losses {losses}")
    if bad:
        raise AssertionError(f"phase 24 pair: {bad}")
    return every[0]


def p24_elastic_child(ckdir, steps, port):
    """(4) A trainer process: run_elastic over the BERT-base fleet step
    (NCCL group of one); prints `step i <loss repr>` a step, then the
    checkpoint's save and restore ms and `done <next step>`."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.distributed import launch, run_elastic
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops.kernels import build
    from paddle_tpu_torch.parallel import Checkpointer
    from paddle_tpu_torch.parallel.fleet import PaddleCloudRoleMaker, fleet

    build.build_all(["flash_attention_fwd", "flash_attention_bwd"])
    os.environ.update(launch.trainer_env(0, 1, port))
    fleet.init(PaddleCloudRoleMaker())
    main, startup, loss, prog = p24_fleet_program(fluid, bert)
    feed = pretrain_feed(P24_B, P24_T, np.random.RandomState(24))
    timing = {"save_ms": [], "restore_ms": []}
    save, restore = Checkpointer.save, Checkpointer.restore

    def timed_save(self, *a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = save(self, *a, **kw)
        if kw.get("blocking"):
            timing["save_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    def timed_restore(self, *a, **kw):
        t0 = time.perf_counter()
        out = restore(self, *a, **kw)
        torch.cuda.synchronize()
        timing["restore_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    Checkpointer.save, Checkpointer.restore = timed_save, timed_restore
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)

    def step_fn(i):
        (lv,) = exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
        print(f"step {i} {float(np.asarray(lv, np.float32).reshape(-1)[0])!r}",
              flush=True)

    nxt = run_elastic(step_fn, ckdir, steps, save_interval=10 * steps,
                      program=main, scope=scope)
    print("timing " + json.dumps(timing), flush=True)
    print(f"done {nxt}", flush=True)


def p24_elastic_parse(text):
    """(losses by step, the timing record, the next step) of a child's
    output."""
    losses, timing, nxt = {}, None, None
    for line in text.splitlines():
        parts = line.split(None, 2)
        if len(parts) == 3 and parts[0] == "step":
            losses[int(parts[1])] = float(parts[2])
        elif line.startswith("timing "):
            timing = json.loads(line[7:])
        elif len(parts) == 2 and parts[0] == "done":
            nxt = int(parts[1])
    return losses, timing, nxt


def p24_elastic_child_proc(ckdir):
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--p24-elastic", ckdir,
         "--p24-steps", str(P24_STEPS), "--p24-port", str(p20_free_port())],
        stdout=subprocess.PIPE, text=True)


def p24_elastic_start():
    """(4), first half: a trainer process SIGTERMed once it printed
    P24_KILL_AFTER steps, then its relaunch started (it restores and runs
    to P24_STEPS while the parent goes on: p24_elastic_finish reads it).
    Returns the state p24_elastic_finish takes."""
    import signal

    ckdir = tempfile.mkdtemp(prefix="p24_elastic_")
    t0 = time.perf_counter()
    p = p24_elastic_child_proc(ckdir)
    lines, seen = [], 0
    while seen < P24_KILL_AFTER:
        line = p.stdout.readline()
        if not line:
            break
        lines.append(line)
        seen += line.startswith("step ")
    p.send_signal(signal.SIGTERM)
    out, _ = p.communicate(timeout=600)
    first_s = time.perf_counter() - t0
    la, ta, resume_at = p24_elastic_parse("".join(lines) + out)
    if p.returncode != 0 or resume_at is None:
        shutil.rmtree(ckdir, ignore_errors=True)
        raise AssertionError(f"phase 24 elastic: the preempted run exited "
                             f"{p.returncode}, done {resume_at}")
    return {"ckdir": ckdir, "first": (la, ta, resume_at, first_s),
            "proc": p24_elastic_child_proc(ckdir),
            "t0": time.perf_counter()}


def p24_elastic_finish(state, reference):
    """(4), second half: the relaunched trainer's output; the stitched
    losses bitwise `reference` (the uninterrupted fleet run's)."""
    p = state["proc"]
    try:
        out, _ = p.communicate(timeout=600)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
        shutil.rmtree(state["ckdir"], ignore_errors=True)
    second_s = time.perf_counter() - state["t0"]
    la, ta, resume_at, first_s = state["first"]
    lb, tb, nxt = p24_elastic_parse(out)
    stitched = dict(la)
    stitched.update(lb)
    rec = {"resume_at": resume_at, "next": nxt,
           "final_checkpoint_ms": ta["save_ms"],
           "restore_ms": (tb or {}).get("restore_ms"),
           "first_run_s": first_s, "second_run_s": second_s,
           "stitched": [stitched.get(i) for i in range(P24_STEPS)]}
    bad = []
    if p.returncode != 0 or nxt != P24_STEPS:
        bad.append(f"the resumed run exited {p.returncode}, done {nxt}")
    if not P24_KILL_AFTER <= resume_at < P24_STEPS or \
            min(lb or [-1]) != resume_at:
        bad.append(f"resumed at {resume_at}, first step {min(lb or [-1])}")
    if rec["stitched"] != list(reference):
        bad.append(f"stitched losses {rec['stitched']} differ from the "
                   f"uninterrupted run's {list(reference)}")
    if bad:
        raise AssertionError(f"phase 24 elastic: {bad}")
    return rec


def p24_hbm_plan_cli():
    """`python -m paddle_tpu_torch.tools.hbm_plan --json`, started now and
    read by p24_hbm_plan_read."""
    return subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.tools.hbm_plan", "--json"],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def p24_hbm_plan_read(cli):
    """The hbm_plan process's JSON line: it fits, on a measured plan."""
    cli_stdout, cli_stderr = cli.communicate(timeout=600)
    if cli.returncode != 0:
        raise AssertionError(f"phase 24 hbm_plan exited {cli.returncode}: "
                             f"{cli_stderr[-2000:]}")
    out = json.loads(cli_stdout.strip().splitlines()[-1])
    if not out["fits"] or out["chosen"]["source"] != "measured":
        raise AssertionError(f"phase 24 hbm_plan chose {out['chosen']}")
    return {k: out[k] for k in ("model", "fits", "budget_bytes", "chosen")}


def p24_planner(fluid, bert, main, loss, feed):
    """(5) plan_for on the BERT-base fleet program (NCCL group of one,
    the card to itself): the card's budget picks stage 0, no remat, K=1;
    a budget one byte under the stage-0 estimate escalates; and at
    B=P24_OOM_B, where the stage-0 step truly runs out of the card's
    memory, the default ladder marks it (and each candidate that also
    runs out) as not fitting and escalates to a plan whose step fits.
    Each measured estimate beside torch.cuda.max_memory_allocated over
    the same candidate's steps (less what was allocated before them)."""
    import torch

    from paddle_tpu_torch import planner
    from paddle_tpu_torch.core import unique_name

    peaks = []
    measured = planner._measured_bytes

    def beside(cp, program, mfeed, loss_name, place):
        p24_sync()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        est, error = measured(cp, program, mfeed, loss_name, place)
        peaks.append((est, torch.cuda.max_memory_allocated() - base, error))
        return est, error

    place = p24_place(fluid)
    planner._measured_bytes = beside
    try:
        t0 = time.perf_counter()
        chosen = planner.plan_for(main, feed, loss.name, place=place)
        chosen_s = time.perf_counter() - t0
        first = peaks[0]
        t0 = time.perf_counter()
        tight = planner.plan_for(main, feed, loss.name,
                                 budget_bytes=chosen.est_bytes_per_device - 1,
                                 place=place)
        tight_s = time.perf_counter() - t0
        ladder = [p.to_dict() for p in planner._last_candidates]
        with unique_name.guard():
            bmain, _, bloss = build_pretrain(fluid, bert, P24_OOM_B, P24_T,
                                             False, dropout=0.0)
        bfeed = pretrain_feed(P24_OOM_B, P24_T, np.random.RandomState(24))
        t0 = time.perf_counter()
        big = planner.plan_for(bmain, bfeed, bloss.name, place=place)
        big_s = time.perf_counter() - t0
        big_ladder = [p.to_dict() for p in planner._last_candidates]
    finally:
        planner._measured_bytes = measured
    torch.cuda.empty_cache()
    ok = [(e, p) for e, p, err in peaks if err is None]
    ratios = [e / p for e, p in ok]
    rec = {"chosen": chosen.to_dict(), "chosen_s": chosen_s,
           "budget_bytes": chosen.budget_bytes,
           "stage0_est_bytes": first[0], "stage0_peak_bytes": first[1],
           "tight": tight.to_dict(), "tight_s": tight_s, "ladder": ladder,
           "oom_batch": P24_OOM_B, "oom_chosen": big.to_dict(),
           "oom_s": big_s, "oom_ladder": big_ladder,
           "est_vs_peak": [{"est": e, "peak": p, "ratio": e / p}
                           for e, p in ok],
           "oom_peaks": [{"est": e, "peak": p, "error": err}
                         for e, p, err in peaks if err is not None]}
    bad = []
    if (chosen.stage, chosen.remat, chosen.microbatch) != (0, "none", 1) \
            or chosen.source != "measured":
        bad.append(f"the card's budget chose {chosen.describe()}")
    if (tight.stage, tight.remat, tight.microbatch) == (0, "none", 1) \
            or not tight.fits:
        bad.append(f"a budget under stage 0 chose {tight.describe()}")
    b0 = big_ladder[0]
    if (b0["stage"], b0["remat"], b0["microbatch"]) != (0, "none", 1) \
            or b0["fits"] or not (b0["error"] or "").startswith(
                "OutOfMemoryError"):
        bad.append(f"stage 0 at B={P24_OOM_B} did not run out: {b0}")
    if (big.stage, big.remat, big.microbatch) == (0, "none", 1) \
            or not big.fits or big.error is not None \
            or big.source != "measured":
        bad.append(f"at B={P24_OOM_B} the ladder chose {big.describe()}")
    if not all(P24_PLAN_RATIO[0] <= r <= P24_PLAN_RATIO[1] for r in ratios):
        bad.append(f"measured bytes over the allocator's peak {ratios}")
    if bad:
        raise AssertionError(f"phase 24 planner: {bad}")
    return rec


def p24_deferred(fluid):
    """(6) DeepFM on the deferred-row log through with_data_parallel on
    the NCCL group of one, across 2 fold boundaries, against the plain
    executor from the same state: losses within P24_FOLD_REL, the log
    count 0 after the last fold."""
    import torch

    from paddle_tpu_torch.models import deepfm

    cfg = P24_DEEPFM
    rows = cfg["B"] * 26
    main, startup, loss = deferred_program(fluid, deepfm, cfg["vocab"], rows,
                                           segments=cfg["segments"])
    rng = np.random.RandomState(24)
    feeds = [deepfm_feed(rng, cfg["B"], cfg["vocab"], device=P24_DEVICE)
             for _ in range(cfg["steps"])]
    exe = fluid.Executor(p24_place(fluid))
    sc0 = fluid.Scope()
    exe.run(startup, scope=sc0)
    init = clone_state(sc0, [v.name for v in main.list_vars()
                             if v.persistable])
    del sc0
    out = {}
    for label, prog in (("plain", main),
                        ("mesh", fluid.CompiledProgram(main)
                         .with_data_parallel(loss_name=loss.name))):
        scope = scope_from(fluid, init)
        losses, ms = [], []
        for f in feeds:
            p24_sync()
            t0 = time.perf_counter()
            (lv,) = exe.run(prog, feed=f, fetch_list=[loss], scope=scope)
            p24_sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(np.asarray(lv, np.float32).reshape(-1)[0]))
        count = int(np.asarray(torch.as_tensor(
            scope.find_var("fm_t@log_count")).cpu()).reshape(-1)[0])
        out[label] = {"losses": losses, "step_ms": ms, "count": count}
        del scope
    torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(out["mesh"]["losses"],
                                                   out["plain"]["losses"]))
    rec = dict(out, loss_rel=rel, folds=cfg["steps"] // cfg["segments"])
    bad = []
    if not rel <= P24_FOLD_REL:
        bad.append(f"losses {rel} relative from the plain run's")
    if out["mesh"]["count"] or out["plain"]["count"]:
        bad.append(f"log counts {out['mesh']['count']}, "
                   f"{out['plain']['count']} after the fold")
    if bad:
        raise AssertionError(f"phase 24 deferred: {bad}")
    return rec


def phase_fleet_cluster(fluid, fa, fb, smi):
    """Phase 24 (module docstring): one line of numbers a part. Returns
    the flash launches of the fleet path ({"fwd"|"bwd": n}, f32) and the
    fused-BN launches of the DGC run (bf16)."""
    import torch
    import torch.distributed as dist

    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel import init_parallel_env

    t_phase = time.perf_counter()
    feed = pretrain_feed(P24_B, P24_T, np.random.RandomState(24))
    marks = {}

    def done(name, rec):
        marks[name] = time.perf_counter() - t_phase
        log(f"fleet_cluster {name} " + json.dumps(rec, default=str))

    cli = elastic = None
    try:
        fleet, reference, main, loss = p24_fleet(fluid, fa, bert, feed,
                                                 p20_free_port())
        done("fleet", fleet)
        dgc, bn = p24_dgc(fluid, fb)
        done("dgc", dgc)
        dist.destroy_process_group()
        done("pair", p24_pair())
        init_parallel_env(f"127.0.0.1:{p20_free_port()}", 1, 0,
                          device=P24_DEVICE, timeout=600)
        try:
            done("planner", p24_planner(fluid, bert, main, loss, feed))
            # the preempted trainer runs alone; its relaunch, the hbm_plan
            # process and the deferred fold then share the card (their
            # checks hold; the fold's ms and the restore ms are shared)
            elastic = p24_elastic_start()
            marks["elastic_preempted"] = time.perf_counter() - t_phase
            cli = p24_hbm_plan_cli()
            done("deferred", p24_deferred(fluid))
        finally:
            dist.destroy_process_group()
        done("hbm_plan_cli", p24_hbm_plan_read(cli))
        done("elastic", p24_elastic_finish(elastic, reference))
    finally:
        for proc in (cli, elastic and elastic["proc"]):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    torch.cuda.empty_cache()
    log("fleet_cluster " + json.dumps({
        "marks_s": marks, "wall_s": time.perf_counter() - t_phase,
        "device": smi}))
    return fleet["launches"], bn

P25_B, P25_T = 8, 512        # BERT-base bf16 AMP training, 12 layers
P25_WARM = 22                # warm steps: past the StepProfiler's 20-sample
#                              baseline, so the fault's step is judged
P25_DELAY_MS = 400.0         # one exec.dispatch delay: ~5 warm steps
P25_UTIL_MAX = 1.05          # a hand-kernel row over this share of its
#                              datasheet bound means its declared counts lie
# rows 1-2 and 3-4 bf16 at B=8, nh=12, T=512, d=64 standalone, device ms a
# call without and with dropout 0.1 (the step's rate): PERF.md §6, phase 3
# of the final run before this phase existed
P25_STANDALONE_MS = {"fwd": (0.03413, 0.06108), "bwd": (0.09405, 0.1502)}
# op_bench cells: the JAX package's defaults (f32), then the main paths'
# shapes (bf16): ResNet-50 stage-1 .c (B=128, 64->256, 56x56) and the NMT
# encoder (B=16, T=256, hidden 1024, 16 heads)
P25_CONV_BN = (((8, 64, 256, 32), "float32"), ((128, 64, 256, 56),
                                                "bfloat16"))
P25_SPARSE = (((2, 512, 256, 4), "float32"), ((16, 256, 1024, 16),
                                               "bfloat16"))
P25_DATASHEET = (989.0, 3350.0)   # H100 SXM: bf16 dense TFLOP/s, HBM GB/s
# in bf16 the conv+BN cell's parameter gradients are sums over all M rows
# (401,408 at stage 1) of bf16 products whose terms cancel: they are printed
# beside the plain arm's, and held only in f32
P25_BF16_SUMS = ("dw", "dscale", "dbias")


def p25_calibrate(workdir, smi):
    """get_calibration(recalibrate=True) into a fresh cache: measured, and
    neither floor above the datasheet's."""
    from paddle_tpu_torch.observability import calibrate

    os.environ["PDTPU_CALIBRATION_DIR"] = os.path.join(workdir, "calib")
    calibrate.reset()
    c = calibrate.get_calibration(recalibrate=True)
    rec = {"source": c.source, "device_kind": c.device_kind,
           "matmul_tflops": c.matmul_tflops, "stream_gbs": c.stream_gbs,
           "peak_flops": c.peak_flops,
           "matmul_share_of_datasheet": c.matmul_tflops / P25_DATASHEET[0],
           "stream_share_of_datasheet": c.stream_gbs / P25_DATASHEET[1],
           "cache": os.path.basename(calibrate.cache_path()), "device": smi}
    if c.source != "measured":
        raise AssertionError(f"calibration: source {c.source!r}: {rec}")
    if not (0 < c.matmul_tflops <= P25_DATASHEET[0]
            and 0 < c.stream_gbs <= P25_DATASHEET[1]):
        raise AssertionError(f"calibration: floors outside (0, datasheet]: "
                             f"{rec}")
    return c, rec


def p25_ledger(fluid, fa, bert, smi):
    """BERT-base bf16 training through Executor.run: one counted ledger
    entry (its flops beside the analytic walk's), warm step records with
    achieved_tflops and mfu, the perf gauges in (0, 1.05], no entry
    registered by a replayed step. Returns (step fn, program key, record,
    warm step ms)."""
    from paddle_tpu_torch.observability import get_registry, perf
    from paddle_tpu_torch.observability.steps import get_step_profiler

    main, startup, loss = build_pretrain(fluid, bert, P25_B, P25_T, True)
    feed = pretrain_feed(P25_B, P25_T, np.random.RandomState(25))
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe.run(startup)

    def step():
        with fluid.scope_guard(scope):
            return float(exe.run(main, feed=feed, fetch_list=[loss])[0])

    key = f"0x{id(main):x}"
    get_step_profiler().reset()
    for fn in (fa.flash_attention_fwd, fa.flash_attention_bwd):
        fn.launches = fn.plain_on_cuda = 0
    t0 = time.perf_counter()
    losses = [step()]
    first_s = time.perf_counter() - t0
    mine = {k: v for k, v in perf.get_ledger().snapshot().items()
            if k.startswith(key)}
    if len(mine) != 1:
        raise AssertionError(f"ledger: {len(mine)} entries for {key}")
    (sig_key, entry), = mine.items()
    if entry["source"] != "counted":
        raise AssertionError(f"ledger: source {entry['source']!r}")
    analytic = perf.analytic_cost(main, feed)
    warm_ms = []
    for _ in range(P25_WARM):
        t0 = time.perf_counter()
        losses.append(step())
        warm_ms.append((time.perf_counter() - t0) * 1e3)
    if set(k for k in perf.get_ledger().snapshot() if k.startswith(key)) \
            != {sig_key}:
        raise AssertionError("ledger: a replayed step registered")
    recs = [r for r in get_step_profiler().records()
            if r.get("program") == key and not r.get("compile")]
    if len(recs) != P25_WARM or not all("achieved_tflops" in r
                                        and "mfu" in r for r in recs):
        raise AssertionError(f"ledger: {len(recs)} warm records, keys "
                             f"{sorted(recs[-1]) if recs else None}")
    gauges = {}
    for s in get_registry().series():
        if s["name"] in ("perf/mfu", "perf/roofline_fraction",
                         "perf/achieved_tflops", "perf/achieved_gbs") \
                and s["labels"].get("program") == key:
            gauges[s["name"]] = s["value"]
    for name in ("perf/mfu", "perf/roofline_fraction"):
        if not 0.0 < gauges.get(name, 0.0) <= 1.05:
            raise AssertionError(f"ledger: {name} = {gauges.get(name)}")
    launches = {"fwd": fa.flash_attention_fwd.launches,
                "bwd": fa.flash_attention_bwd.launches}
    steps = 1 + P25_WARM
    if launches != {"fwd": 12 * steps, "bwd": 12 * steps} or \
            fa.flash_attention_fwd.plain_on_cuda or \
            fa.flash_attention_bwd.plain_on_cuda:
        raise AssertionError(f"ledger: flash launches {launches}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"ledger: losses {losses}")
    rec = {"entry": {k: v for k, v in entry.items() if k != "last"},
           "last_attribution": entry.get("last"),
           "counted_tflop": entry["flops"] / 1e12,
           "analytic_tflop": analytic["flops"] / 1e12,
           "counted_over_analytic": entry["flops"] / analytic["flops"],
           "counted_gb": entry["bytes_accessed"] / 1e9,
           "first_run_s": first_s,
           "warm_ms_median": float(np.median(warm_ms)),
           "warm_ms": warm_ms, "gauges": gauges,
           "last_record": {k: recs[-1][k] for k in
                           ("wall_ms", "achieved_tflops", "mfu")},
           "losses": [losses[0], losses[-1]], "launches": launches,
           "device": smi}
    return step, key, rec, warm_ms, launches


def p25_calls(tab):
    """{base name: calls} over a kernel table's rows."""
    from paddle_tpu_torch.observability.kernel_counts import base_name

    out = {}
    for r in tab["kernels"]:
        out[base_name(r["kernel"])] = out.get(base_name(r["kernel"]), 0) \
            + r["calls"]
    return out


def p25_session(step, calib, workdir, smi):
    """profiler.profiler() around 2 warm steps, then the roofline table of
    the session's directory against the datasheet and the measured floors:
    the flash rows with 12 launches a step each, no hand-kernel row over
    P25_UTIL_MAX of its bound; timeline's summary and a fleet merge of the
    trace with itself."""
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.observability.kernel_counts import HAND_KERNELS
    from paddle_tpu_torch.tools import roofline, timeline

    for attempt in range(3):
        # a torch.profiler session has come back with no device events on
        # the card: say so and take another, at most three
        d = os.path.join(workdir, f"session{attempt}")
        t0 = time.perf_counter()
        with profiler.profiler(profile_path=d):
            for _ in range(2):
                step()
        session_s = time.perf_counter() - t0
        tr = roofline.load_trace(d)
        if any(e.get("cat") in roofline.DEVICE_CATS
               for e in tr["traceEvents"]):
            break
        log(f"root_cause session {attempt}: no device events in the trace")
    tab = roofline.kernel_table(tr, P25_DATASHEET, steps=2, cutoff_ms=0.0)
    if "error" in tab or not any(e.get("cat") in roofline.DEVICE_CATS
                                 for e in tr["traceEvents"]):
        raise AssertionError(f"session: no device time in three sessions "
                             f"({tab.get('error')})")
    rows = p25_calls(tab)
    want = {"flash_fwd_bf16_kernel": 24, "flash_bwd_delta_kernel": 24,
            "flash_bwd_dq_bf16_kernel": 24, "flash_bwd_dkv_bf16_kernel": 24}
    got = {k: rows.get(k, 0) for k in want}
    if got != want:
        raise AssertionError(f"session: flash rows {got}, want {want}")
    hand = {h["name"]: h for h in tab.get("hand_kernels", ())}
    over = [(h["name"], h["util_vs_bound"]) for h in hand.values()
            if (h["util_vs_bound"] or 0.0) > P25_UTIL_MAX]
    over += [(r["kernel"], r["util_vs_bound"]) for r in tab["kernels"]
             if r["kernel"].split("<")[0] in HAND_KERNELS
             and r["util_vs_bound"] > P25_UTIL_MAX]
    for name in ("flash_attention_fwd[bf16]", "flash_attention_bwd[bf16]"):
        if hand.get(name, {}).get("launches") != 24:
            raise AssertionError(f"session: {name} {hand.get(name)}")
    measured = roofline.kernel_table(tr, calib.floors, steps=2,
                                     cutoff_ms=0.0)
    m_hand = {h["name"]: h for h in measured.get("hand_kernels", ())}
    per_launch = {
        k: {"in_step_ms": hand[f"flash_attention_{k}[bf16]"]
            ["ms_per_launch"], "standalone_ms": P25_STANDALONE_MS[k][0],
            "standalone_dropout_ms": P25_STANDALONE_MS[k][1],
            "ratio_to_dropout": hand[f"flash_attention_{k}[bf16]"]
            ["ms_per_launch"] / P25_STANDALONE_MS[k][1],
            "util_vs_datasheet": hand[f"flash_attention_{k}[bf16]"]
            ["util_vs_bound"],
            "util_vs_measured": m_hand[f"flash_attention_{k}[bf16]"]
            ["util_vs_bound"]} for k in ("fwd", "bwd")}
    summary = timeline.summarize(tr)
    top = sorted(summary.items(), key=lambda kv: -kv[1]["total_ms"])[:5]
    merged = timeline.merge_fleet_traces([tr, tr], ["step_a", "step_b"])
    n_ev = len(tr["traceEvents"])
    if len(merged["traceEvents"]) < 2 * n_ev:
        raise AssertionError("timeline: the fleet merge lost events")
    out = os.path.join(workdir, "timeline.json")
    timeline.main(["--logdir", d, "--out", out])
    rec = {"session_s": session_s, "sessions": attempt + 1,
           "device_ms_per_step": tab["device_ms_per_step"],
           "top_kernels": [{k: r[k] for k in ("kernel", "ms", "calls",
                                              "util_vs_bound")}
                           for r in tab["kernels"][:8]],
           "hand_kernels": list(hand.values()), "flash_per_launch":
           per_launch, "rows_over_bound": over,
           "timeline_top": [[k, v["total_ms"], v["count"]] for k, v in top],
           "trace_events": n_ev, "merged_events": len(merged["traceEvents"]),
           "device": smi}
    if over:
        raise AssertionError(f"session: hand-kernel rows over "
                             f"{P25_UTIL_MAX} of their bound: {over}")
    return rec


def p25_capture_flash(att):
    """The capture's flash forward row: it began on the trigger's thread,
    so it must still hold the trainer thread's launches and their device
    time."""
    hand = {h["name"]: h for h in att.get("hand_kernels", ())}
    cap_fwd = hand.get("flash_attention_fwd[bf16]", {})
    if cap_fwd.get("launches", 0) < 12 or not cap_fwd.get("ms"):
        raise AssertionError(f"loop: the capture lacks the main thread's "
                             f"flash launches: {hand}")
    return cap_fwd


def p25_loop(step, warm_ms, workdir, smi):
    """The root-cause loop on the card: a golden on the healthy step, one
    delay_ms fault at exec.dispatch, the StepProfiler's slow_step arming
    the ProfileTrigger (its capture from its own thread), the attribution
    naming kernels against the golden, a TrainStepTime page (budget half
    the warm median) enriched with the culprits and dumped, /alerts and
    /history answering 200, postmortem --url and ops_console --once."""
    import statistics
    import urllib.request

    from paddle_tpu_torch import faults
    from paddle_tpu_torch.observability import (
        AlertManager, FederatedScraper, IntrospectionServer, MetricsHistory,
        ProfileTrigger, ScrapeTarget, SloEngine, default_slos, get_registry,
        install_alert_manager, install_history, install_scraper,
        install_trigger, record_golden)
    from paddle_tpu_torch.observability.steps import get_step_profiler
    from paddle_tpu_torch.tools import ops_console, postmortem

    for k, sub in (("PDTPU_GOLDEN_DIR", "golden"),
                   ("PDTPU_FLIGHT_DIR", "flight")):
        os.environ[k] = os.path.join(workdir, sub)
    os.environ["PDTPU_PROFILE_ON_ANOMALY"] = "1"
    reg = get_registry()
    captures = reg.counter("profiler/captures", trigger="slow_step")
    skipped = {r: reg.counter("profiler/skipped", reason=r)
               for r in ("busy", "cooldown", "cap", "start_failed")}
    before = (captures.value, {r: c.value for r, c in skipped.items()})
    golden = record_golden(step, steps=2)
    steps_prof = get_step_profiler()
    trig = ProfileTrigger(window_steps=2, window_s=30.0, cooldown_s=3600.0)
    install_trigger(trig)
    trig.attach(step_profiler=steps_prof)
    scraper = srv = None
    rec = {"golden": os.path.basename(golden), "device": smi}
    try:
        faults.install("exec.dispatch", "delay_ms", P25_DELAY_MS, count=1)
        step_s = []
        for _ in range(12):
            t0 = time.perf_counter()
            step()
            step_s.append(time.perf_counter() - t0)
            if trig.last_attribution() is not None:
                break
        if not trig.wait_idle(60):
            raise AssertionError("loop: the capture did not end")
        faults.clear()
        att = trig.last_attribution()
        rec["step_s"] = step_s
        n_caps = captures.value - before[0]
        rec["captures_slow_step"] = n_caps
        if att is None or att.get("error") or n_caps != 1:
            raise AssertionError(f"loop: captures {n_caps}, attribution "
                                 f"{att}")
        culprits = att.get("culprit_kernels") or []
        if not culprits or not all(c.get("kernel") for c in culprits):
            raise AssertionError(f"loop: no named culprit: {att}")
        cap_fwd = p25_capture_flash(att)
        rec.update(culprits=culprits, trigger=att.get("trigger"),
                   capture_ms=att.get("capture_ms"),
                   capture_flash_fwd=cap_fwd,
                   device_ms_per_step=att.get("device_ms_per_step"),
                   trace_diff=att.get("trace_diff"))

        median = statistics.median(warm_ms)
        am = AlertManager(for_s=0.0, resolved_hold_s=600.0)
        install_alert_manager(am)
        events = []
        am.add_sink(events.append)
        trig.attach(alert_manager=am)
        hist = MetricsHistory(max_mb=2.0)
        install_history(hist)
        scraper = FederatedScraper([ScrapeTarget.local()], interval_s=0.25,
                                   timeout=0.5)
        hist.attach(scraper)
        engine = SloEngine(default_slos(step_time_ms=0.5 * median),
                           alert_manager=am, window_scale=1.0 / 720.0)
        engine.attach(scraper)
        install_scraper(scraper)
        scraper.start()

        def page():
            for ev in events:
                if (ev["event"] == "firing" and ev["severity"] == "page"
                        and ev["name"] == "TrainStepTime"
                        and (ev.get("annotations") or {}).get(
                            "culprit_kernels")):
                    return ev
            return None

        deadline = time.time() + 60.0
        t_fire = time.time()
        while page() is None and time.time() < deadline:
            step()
        ev = page()
        if ev is None:
            raise AssertionError(f"loop: no enriched TrainStepTime page; "
                                 f"events {events}")
        if not ev.get("dump_path") or not os.path.exists(ev["dump_path"]):
            raise AssertionError(f"loop: the page wrote no flight dump: "
                                 f"{ev}")
        rec.update(page_after_s=time.time() - t_fire,
                   page_culprits=[c.get("kernel") for c in
                                  ev["annotations"]["culprit_kernels"]],
                   page_budget_ms=0.5 * median,
                   page_value=ev.get("value"),
                   flight_dump=os.path.basename(ev["dump_path"]))

        srv = IntrospectionServer(port=0).start()
        codes = {}
        for path in ("/alerts", "/history?window=300"):
            with urllib.request.urlopen(srv.url + path, timeout=10) as r:
                codes[path] = r.status
                json.loads(r.read().decode())
        if set(codes.values()) != {200}:
            raise AssertionError(f"loop: {codes}")
        md = os.path.join(workdir, "postmortem.md")
        postmortem.main(["--url", srv.url, "--md", md])
        text = open(md).read()
        if rec["page_culprits"][0] not in text:
            raise AssertionError("postmortem: the culprit is not named")
        frame_rc = ops_console.main([srv.url, "--once", "--no-color"])
        skips = {r: c.value - before[1][r] for r, c in skipped.items()}
        rec.update(http=codes, postmortem_chars=len(text),
                   ops_console_rc=frame_rc, skipped=skips,
                   captures_slow_step_end=captures.value - before[0],
                   history=hist.stats())
        if rec["captures_slow_step_end"] != 1:
            raise AssertionError(f"loop: captures "
                                 f"{rec['captures_slow_step_end']}")
    finally:
        faults.clear()
        if scraper is not None:
            scraper.stop()
        if srv is not None:
            srv.stop()
        install_scraper(None)
        install_alert_manager(None)
        install_history(None)
        install_trigger(None)
        steps_prof.remove_listener(trig.on_record)
        steps_prof.remove_listener(trig.on_anomaly)
        trig.wait_idle(30)
    return rec


def p25_op_bench(smi):
    """The two op_bench cells at the JAX defaults and the main paths'
    shapes; each kernel arm held to its plain arm (TOL / BN_TOL; the
    bf16 parameter gradients printed, see P25_BF16_SUMS)."""
    from paddle_tpu_torch.tools import op_bench

    out = []
    for (b, ci, co, hw), dt in P25_CONV_BN:
        out.append(op_bench.bench_fused_conv_bn(
            batch=b, ci=ci, co=co, hw=hw, dtype=dt, tol=BN_TOL[dt]))
    for (b, t, h, nh), dt in P25_SPARSE:
        out.append(op_bench.bench_block_sparse_attn(
            batch=b, t=t, hidden=h, num_heads=nh, dtype=dt, tol=TOL[dt]))
    for cell in out:
        cell["device"] = smi
        log("root_cause op_bench " + json.dumps(cell))
        held = {k: v for k, v in cell["within_tol"].items()
                if cell["dtype"] == "float32" or k not in P25_BF16_SUMS}
        if not all(held.values()):
            raise AssertionError(f"op_bench {cell['bench']} "
                                 f"{cell['shape']} {cell['dtype']}: "
                                 f"{cell['within_tol']}")
    return out


def p25_child():
    """Phase 25 in a process of its own (``chip_smoke.py --p25``): in a
    process where other processes or threads have used the card,
    torch.profiler loses a growing share of its kernel records (ten
    dependent matmuls read 20, then 17 after three other processes ran
    and 15 after four threads; a fresh process reads 20), and this phase
    reads profiles. Prints the phase's lines, then the launches."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.executor import cuda_device
    from paddle_tpu_torch.ops.kernels import build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    cuda_device(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build.build_all(["flash_attention_fwd", "flash_attention_bwd",
                     "flash_attention_sparse", "fused_bn"])
    launches = phase_root_cause(fluid, fa, smi)
    print("p25 launches " + json.dumps(launches), flush=True)
    torch.cuda.synchronize()


def phase_root_cause_proc():
    """Phase 25 through `p25_child` in a fresh process; its lines pass
    through. Returns the flash launches of its BERT-base bf16 steps."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--p25"], capture_output=True, text=True,
                          timeout=900)
    launches = None
    for line in proc.stdout.splitlines():
        if line.startswith("p25 launches "):
            launches = json.loads(line[len("p25 launches "):])
        else:
            log(line)
    if proc.returncode != 0 or launches is None:
        raise AssertionError(f"phase 25 (--p25) exited {proc.returncode}:"
                             f" {proc.stderr[-4000:]}")
    return launches


def phase_root_cause(fluid, fa, smi):
    """Phase 25 (module docstring). Returns the flash launches of its
    BERT-base bf16 steps ({"fwd"|"bwd": n})."""
    import torch

    from paddle_tpu_torch.models import bert

    t_phase = time.perf_counter()
    marks = {}
    saved = {k: os.environ.get(k) for k in (
        "PDTPU_CALIBRATION_DIR", "PDTPU_GOLDEN_DIR", "PDTPU_FLIGHT_DIR",
        "PDTPU_PROFILE_ON_ANOMALY")}
    workdir = tempfile.mkdtemp(prefix="p25_")

    def done(name, rec):
        marks[name] = time.perf_counter() - t_phase
        log(f"root_cause {name} " + json.dumps(rec, default=str))

    try:
        calib, rec = p25_calibrate(workdir, smi)
        done("calibration", rec)
        step, key, rec, warm_ms, launches = p25_ledger(fluid, fa, bert, smi)
        done("ledger", rec)
        done("session", p25_session(step, calib, workdir, smi))
        fwd0, bwd0 = (fa.flash_attention_fwd.launches,
                      fa.flash_attention_bwd.launches)
        done("loop", p25_loop(step, warm_ms, workdir, smi))
        launches = {"fwd": fa.flash_attention_fwd.launches,
                    "bwd": fa.flash_attention_bwd.launches}
        if launches["fwd"] - fwd0 < 12 or launches["bwd"] - bwd0 < 12:
            raise AssertionError(f"loop: flash launches {launches}")
        p25_op_bench(smi)
        marks["op_bench"] = time.perf_counter() - t_phase
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    torch.cuda.empty_cache()
    log("root_cause " + json.dumps({
        "marks_s": marks, "wall_s": time.perf_counter() - t_phase,
        "device": smi}))
    return launches


# -- phase 26: dygraph ---------------------------------------------------------
P26_DEVICE = "cuda"
P26_B, P26_HW, P26_CLASSES = 32, 224, 1000
P26_DEPTH, P26_FILTERS = (3, 4, 6, 3), (64, 128, 256, 512)  # ResNet-50
P26_BN = 53                      # BatchNorm layers: 1 + 16·3 + 4 shortcuts
P26_STEPS, P26_CHECKED, P26_WARM = 4, 3, 3
P26_LR, P26_MOMENTUM = 0.01, 0.9
P26_LOSS_REL, P26_DELTA_REL, P26_STAT_REL, P26_JIT_REL = 1e-4, 1e-3, 1e-4, 1e-6
P26_DP_WORLD, P26_DP_STEPS, P26_DP_REL = 2, 5, 1e-5
P26_BN_KEYS = ("bn_stats", "bn_apply", "apply2d", "bn_bwd_reduce",
               "bn_bwd_dx", "conv_stats")


def p26_place(fluid):
    return fluid.CUDAPlace(0) if P26_DEVICE == "cuda" else fluid.CPUPlace()


def p26_resnet(dy, trace):
    """ResNet-50 from dygraph.nn layers (the reference's
    test_imperative_resnet.py pattern): Conv2D + BatchNorm units, bottleneck
    blocks with a projection shortcut first in each stage, global average
    pool, Linear. Returns the model and the ops one forward traces."""

    class ConvBN(dy.Layer):
        def __init__(self, ci, co, k, stride=1, act=None):
            super().__init__()
            self.conv = dy.Conv2D(ci, co, k, stride=stride,
                                  padding=(k - 1) // 2, bias_attr=False)
            self.bn = dy.BatchNorm(co, act=act)
            self.cfg = (co, k, stride, act)

        def forward(self, x):
            return self.bn(self.conv(x))

    class Bottleneck(dy.Layer):
        def __init__(self, ci, f, stride, project):
            super().__init__()
            self.conv0 = ConvBN(ci, f, 1, act="relu")
            self.conv1 = ConvBN(f, f, 3, stride, act="relu")
            self.conv2 = ConvBN(f, 4 * f, 1)
            self.short = ConvBN(ci, 4 * f, 1, stride) if project else None

        def forward(self, x):
            y = self.conv2(self.conv1(self.conv0(x)))
            s = x if self.short is None else self.short(x)
            return trace("relu", {"X": [s + y]}, {})["Out"][0]

    class ResNet50(dy.Layer):
        def __init__(self):
            super().__init__()
            self.stem = ConvBN(3, 64, 7, 2, act="relu")
            self.pool = dy.Pool2D(pool_size=3, pool_stride=2,
                                  pool_padding=1, pool_type="max")
            self.blocks, ci = [], 64
            for s, (n, f) in enumerate(zip(P26_DEPTH, P26_FILTERS)):
                for i in range(n):
                    self.blocks.append(self.add_sublayer(
                        f"b{s}_{i}", Bottleneck(ci, f, 2 if i == 0 and s
                                                else 1, i == 0)))
                    ci = 4 * f
            self.gap = dy.Pool2D(pool_type="avg", global_pooling=True)
            self.fc = dy.Linear(ci, P26_CLASSES)

        def forward(self, x):
            h = self.pool(self.stem(x))
            for b in self.blocks:
                h = b(h)
            h = trace("reshape", {"X": [self.gap(h)]},
                      {"shape": [-1, h.shape[1]]})["Out"][0]
            return self.fc(h)

    model = ResNet50()
    units = [l for l in model.sublayers() if isinstance(l, ConvBN)]
    blocks = len(model.blocks)
    ops = {"conv2d": len(units), "batch_norm": len(units),
           "relu": sum(u.cfg[3] == "relu" for u in units) + blocks,
           "elementwise_add": blocks + 1, "pool2d": 2, "reshape": 1,
           "mul": 1}
    return model, ops


def p26_static(fluid, model, b):
    """The same network in the static DSL (layers.conv2d / batch_norm /
    pool2d / fc, no fused conv+BN), each parameter and running statistic
    named after its dygraph twin, Momentum. Returns (main, startup,
    loss)."""
    from paddle_tpu_torch.core import unique_name

    main, startup = fluid.Program(), fluid.Program()
    L = fluid.layers

    def unit(h, u):
        co, k, stride, act = u.cfg
        h = L.conv2d(h, co, k, stride=stride, padding=(k - 1) // 2,
                     bias_attr=False,
                     param_attr=fluid.ParamAttr(name=u.conv.weight.name))
        return L.batch_norm(h, act=act,
                            param_attr=fluid.ParamAttr(name=u.bn.weight.name),
                            bias_attr=fluid.ParamAttr(name=u.bn.bias.name),
                            moving_mean_name=u.bn._mean.name,
                            moving_variance_name=u.bn._variance.name)

    with fluid.program_guard(main, startup), unique_name.guard():
        x = L.data("img", [3, P26_HW, P26_HW])
        label = L.data("label", [1], dtype="int64")
        h = L.pool2d(unit(x, model.stem), pool_size=3, pool_stride=2,
                     pool_padding=1, pool_type="max")
        for blk in model.blocks:
            y = unit(unit(unit(h, blk.conv0), blk.conv1), blk.conv2)
            s = h if blk.short is None else unit(h, blk.short)
            h = L.relu(L.elementwise_add(s, y))
        h = L.pool2d(h, pool_type="avg", global_pooling=True)
        h = L.reshape(h, [-1, h.shape[1]])
        logits = L.fc(h, P26_CLASSES,
                      param_attr=fluid.ParamAttr(name=model.fc.weight.name),
                      bias_attr=fluid.ParamAttr(name=model.fc.bias.name))
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        fluid.optimizer.Momentum(P26_LR, P26_MOMENTUM).minimize(loss)
    return main, startup, loss


def p26_state(model):
    """{name: a copy of the tensor} of every parameter and buffer."""
    out = {p.name: p.value.detach().clone() for p in model.parameters()}
    out.update({b.name: b.value.detach().clone()
                for _, b in model.named_buffers()})
    return out


def p26_rel_l2(a, b):
    import torch

    den = float(torch.linalg.vector_norm(b.double()))
    return float(torch.linalg.vector_norm((a - b).double())) / den \
        if den else float(torch.linalg.vector_norm(a.double()))


def p26_deterministic(on: bool):
    """cuDNN's deterministic algorithms (and torch's) on or off. With the
    default algorithms two runs of the same static program on the card
    differ: cuDNN's backward sums in no fixed order, and four steps of
    this single-batch run grow 1e-6 at step 1 into 1.6e-3 at step 2 and a
    ~47 % relative L2 spread of the parameters' changes (PERF.md §6,
    the dygraph finding). With them, dygraph and static are bitwise
    equal."""
    import torch

    torch.backends.cudnn.deterministic = on
    torch.use_deterministic_algorithms(on, warn_only=True)


def p26_train(fluid, fb, smi):
    """(a) ResNet-50 in dygraph at full width against the static executor
    on the same weights (both on deterministic algorithms), then timed on
    the default ones; (b) jit against the eager eval forward; (c)
    op_profiler around one step. Returns (record, the fused-BN launches of
    the dygraph and static runs)."""
    import torch

    from paddle_tpu_torch import dygraph as dy
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.dygraph.tracer import trace_op

    feed = resnet_feed(P26_B, P26_HW, seed=26, classes=P26_CLASSES,
                       device=P26_DEVICE)
    place = p26_place(fluid)
    with dy.guard(place, seed=26):
        model, ops = p26_resnet(dy, trace_op)
    bns = [l for l in model.sublayers() if isinstance(l, dy.BatchNorm)]
    if len(bns) != P26_BN:
        raise AssertionError(f"dygraph resnet: {len(bns)} BatchNorms")
    init = p26_state(model)
    params = model.parameters()
    pnames = [p.name for p in params]
    want_bn = {k: (0 if k in ("apply2d", "conv_stats") else P26_BN)
               for k in P26_BN_KEYS}
    launches = {}

    # the static executor on the same network and initial weights
    main, startup, loss = p26_static(fluid, model, P26_B)
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    for name, t in init.items():
        if scope.find_var(name) is None:
            raise AssertionError(f"static resnet: no var {name}")
        scope.set_var(name, t.clone())

    def st_step():
        (lv,) = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        return float(lv)

    p26_deterministic(True)
    try:
        reset_bn_counts(fb)
        st_losses = [st_step() for _ in range(P26_STEPS)]
        launches["static"] = {k: getattr(fb, k).launches
                              for k in P26_BN_KEYS}
        st_state = {n: scope.find_var(n).detach().clone() for n in init}
        with dy.guard(place, seed=26):
            opt = fluid.optimizer.Momentum(P26_LR, P26_MOMENTUM)
            x = dy.to_variable(feed["img"])
            y = dy.to_variable(feed["label"])

            def step():
                logits = model(x)
                ce = trace_op("softmax_with_cross_entropy",
                              {"Logits": [logits], "Label": [y]},
                              {})["Loss"][0]
                lv = trace_op("mean", {"X": [ce]}, {})["Out"][0]
                lv.backward()
                opt.minimize(lv, parameter_list=params)
                model.clear_gradients()
                return lv

            # (a) the dygraph main path: P26_STEPS checked steps
            if P26_DEVICE == "cuda":
                torch.cuda.reset_peak_memory_stats()
            reset_bn_counts(fb)
            dy_losses = [float(step().numpy()) for _ in range(P26_STEPS)]
            launches["dygraph"] = {k: getattr(fb, k).launches
                                   for k in P26_BN_KEYS}
            dy_state = p26_state(model)
            p26_deterministic(False)
            # where the time of one warm step goes (held to the launch
            # counters), and the warm steps, on the default algorithms
            prof = profile_record(f"dygraph resnet50 f32 B={P26_B}", step, 1)
            warm = []
            for _ in range(P26_WARM):
                t0 = time.perf_counter()
                step().numpy()
                warm.append((time.perf_counter() - t0) * 1e3)
            peak = (torch.cuda.max_memory_allocated() / 2**20
                    if P26_DEVICE == "cuda" else None)

            # (c) op_profiler around one training step
            with profiler.op_profiler() as timer:
                step().numpy()
            traced = dict(timer.counts)
            top = [[op, timer.counts[op], timer.times[op] * 1e3] for op in
                   sorted(timer.times, key=lambda o: -timer.times[o])]

            # (b) jit against the eager eval forward on one batch
            model.eval()
            eager = model(x).value
            jitted = dy.jit(model)(feed["img"]).value
            jit_rel = float((jitted - eager).abs().max()
                            / eager.abs().max())
            model.train()
    finally:
        p26_deterministic(False)
    st_warm = []
    for _ in range(P26_WARM):
        t0 = time.perf_counter()
        st_step()
        st_warm.append((time.perf_counter() - t0) * 1e3)
    del scope

    loss_rel = [abs(a - b) / abs(b) for a, b in
                zip(dy_losses[:P26_CHECKED], st_losses[:P26_CHECKED])]
    deltas = {n: p26_rel_l2(dy_state[n] - init[n], st_state[n] - init[n])
              for n in pnames}
    last = bns[-1]
    stat_rel = {k: float((dy_state[b.name] - st_state[b.name]).abs().max()
                         / st_state[b.name].abs().max())
                for k, b in (("mean", last._mean), ("var", last._variance))}
    worst = max(deltas.items(), key=lambda kv: kv[1])
    med, st_med = float(np.median(warm)), float(np.median(st_warm))
    want_ops = dict(ops, softmax_with_cross_entropy=1, mean=1)
    rec = {"device": smi, "config": f"ResNet-50 f32 B={P26_B} "
           f"{P26_HW}^2, {P26_CLASSES} classes, Momentum({P26_LR}, "
           f"{P26_MOMENTUM}), PDTPU_BN_MODE=pallas",
           "dygraph_losses": dy_losses, "static_losses": st_losses,
           "loss_rel": loss_rel, "delta_rel_worst": list(worst),
           "delta_rel_median": float(np.median(list(deltas.values()))),
           "last_bn_stat_rel": stat_rel,
           "dygraph_warm_ms": warm, "static_warm_ms": st_warm,
           "dygraph_median_ms": med, "static_median_ms": st_med,
           "dygraph_vs_static": med / st_med,
           "dygraph_profile": {k: prof[k] for k in (
               "profile", "wall_ms", "device_busy_ms", "by_category_ms",
               "top_kernels_ms")},
           "device_busy_share_of_median": ratio(prof["device_busy_ms"], med),
           "peak_memory_MiB": peak, "fused_bn_launches": launches,
           "jit_rel": jit_rel, "op_profiler_top": top[:8],
           "op_profiler_calls": traced}
    log("dygraph resnet50 " + json.dumps(rec))
    bad = []
    if not all(r <= P26_LOSS_REL for r in loss_rel):
        bad.append(f"losses {loss_rel}")
    if not worst[1] <= P26_DELTA_REL:
        bad.append(f"parameter change {worst}")
    if not all(v <= P26_STAT_REL for v in stat_rel.values()):
        bad.append(f"last BN statistics {stat_rel}")
    if not np.isfinite(dy_losses).all() or not dy_losses[-1] < dy_losses[0]:
        bad.append(f"dygraph losses {dy_losses}")
    if traced != want_ops:
        bad.append(f"op_profiler {traced}, traced {want_ops}")
    if not jit_rel <= P26_JIT_REL:
        bad.append(f"dygraph.jit vs eager {jit_rel}")
    if P26_DEVICE == "cuda":
        for run in ("dygraph", "static"):
            per_step = {k: v / P26_STEPS for k, v in launches[run].items()}
            if per_step != want_bn:
                bad.append(f"{run} fused-BN launches a step {per_step}, "
                           f"want {want_bn}")
    if bad:
        raise AssertionError(f"dygraph resnet50: {bad}")
    return rec, launches


def p26_mlp_losses(fluid, dp, steps=P26_DP_STEPS):
    """tests/torch_dist_dygraph_runner.py's loop on the card: Linear 16 → 1
    (no bias) from a seeded weight, a square loss, SGD 0.1, the same batch
    on every rank; with `dp` the DataParallel recipe. Returns (losses,
    all-reduce bytes a step)."""
    from paddle_tpu_torch import dygraph as dy
    from paddle_tpu_torch.dygraph.tracer import trace_op

    rng = np.random.RandomState(0)
    X = rng.rand(32, 16).astype("float32")
    Y = (X @ rng.rand(16, 1)).astype("float32")
    w0 = np.random.RandomState(3).rand(16, 1).astype("float32") * 0.1
    with dy.guard(p26_place(fluid), seed=3):
        model = dy.Linear(16, 1, bias_attr=False)
        model.set_dict({"weight": w0})
        wrapped = dy.DataParallel(model) if dp else model
        opt = fluid.optimizer.SGD(0.1)
        losses = []
        for _ in range(steps):
            out = wrapped(dy.to_variable(X))
            diff = trace_op("elementwise_sub",
                            {"X": [out], "Y": [dy.to_variable(Y)]},
                            {"axis": -1})["Out"][0]
            loss = trace_op("mean", {"X": [trace_op(
                "square", {"X": [diff]}, {})["Out"][0]]}, {})["Out"][0]
            losses.append(float(loss.numpy()))
            if dp:
                wrapped.scale_loss(loss).backward()
                wrapped.apply_collective_grads()
            else:
                loss.backward()
            opt.minimize(loss, parameter_list=model.parameters())
            model.clear_gradients()
        return losses, (wrapped.last_allreduce_bytes if dp else 0)


def p26_dp_rank(rank, world, addr):
    """Rank `rank` of the DataParallel pair: a gloo group over CUDA
    tensors on the one card (NCCL refuses two ranks on one card). Returns
    its (losses, all-reduce bytes a step)."""
    import torch
    import torch.distributed as dist

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.parallel import init_parallel_env

    # the card only after the rendezvous: rank 1 starts beside the
    # ResNet-50 part, whose profile must see no other process on the card
    init_parallel_env(addr, world, rank, device="cpu", timeout=600)
    if P26_DEVICE == "cuda":
        torch.cuda.set_device(0)
    out = p26_mlp_losses(fluid, True)
    every = [None] * world
    dist.all_gather_object(every, out)
    dist.destroy_process_group()
    return every


def p26_worker(rank, world, addr):
    """A rank > 0 of the pair (`chip_smoke.py --p26-rank`)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    p26_dp_rank(rank, world, addr)


def p26_spawn():
    """The pair's ranks > 0 (this script with --p26-rank), started early:
    each imports the port, then waits at the rendezvous without touching
    the card. Returns (the rendezvous address, the processes)."""
    addr = f"127.0.0.1:{p20_free_port()}"
    return addr, [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                    "--p26-rank", str(r), "--p26-world",
                                    str(P26_DP_WORLD), "--p26-addr", addr])
                  for r in range(1, P26_DP_WORLD)]


def p26_data_parallel(fluid, smi, addr, workers):
    """(e) DataParallel on a gloo pair: this process is rank 0, `workers`
    the other ranks (`p26_spawn`). Each rank's losses within P26_DP_REL of
    one process's."""
    single, _ = p26_mlp_losses(fluid, False)
    try:
        every = p26_dp_rank(0, P26_DP_WORLD, addr)
        for w in workers:
            if w.wait(timeout=600) != 0:
                raise AssertionError(f"phase 26 rank exited {w.returncode}")
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.wait()
    rel = [max(abs(a - b) / abs(b) for a, b in zip(losses, single))
           for losses, _ in every]
    rec = {"device": smi, "single_losses": single,
           "rank_losses": [l for l, _ in every], "rank_max_rel": rel,
           "allreduce_bytes_per_step": [n for _, n in every]}
    log("dygraph data_parallel " + json.dumps(rec))
    if not all(r <= P26_DP_REL for r in rel) or not single[-1] < single[0]:
        raise AssertionError(f"dygraph DataParallel: {rec}")
    return rec


def p26_child():
    """Phase 26 in a process of its own (``chip_smoke.py --p26``), so that
    its profile is read in a process no other process or thread has used
    the card beside. Prints the phase's lines, then its fused-BN launches
    and its sessions' checks."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.executor import cuda_device
    from paddle_tpu_torch.ops.kernels import build
    from paddle_tpu_torch.ops.kernels import fused_bn as fb

    cuda_device(0)
    PHASE[0] = "26"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    build.build_all(["fused_bn"])
    launches = phase_dygraph(fluid, fb, smi)
    print("p26 launches " + json.dumps(launches), flush=True)
    print("p26 sessions " + json.dumps(SESSIONS), flush=True)
    torch.cuda.synchronize()


def phase_dygraph_proc():
    """Phase 26 through `p26_child` in a fresh process; its lines pass
    through. Returns (its fused-BN launches, its sessions' checks)."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--p26"], capture_output=True, text=True,
                          timeout=600)
    launches = sessions = None
    for line in proc.stdout.splitlines():
        if line.startswith("p26 launches "):
            launches = json.loads(line[len("p26 launches "):])
        elif line.startswith("p26 sessions "):
            sessions = json.loads(line[len("p26 sessions "):])
        else:
            log(line)
    if proc.returncode != 0 or launches is None:
        raise AssertionError(f"phase 26 (--p26) exited {proc.returncode}:"
                             f" {proc.stderr[-4000:]}")
    return launches, sessions


def phase_dygraph(fluid, fb, smi):
    """Phase 26 (module docstring). Returns the fused-BN launches of its
    ResNet-50 training runs (dygraph + static), by counter."""
    from paddle_tpu_torch.tools import op_bench

    t_phase = time.perf_counter()
    marks = {}
    saved = {k: os.environ.get(k) for k in (
        "PDTPU_BN_MODE", "PDTPU_CONV_BN_FUSION", "PDTPU_EAGER_JIT")}
    os.environ["PDTPU_BN_MODE"] = "pallas"
    os.environ.pop("PDTPU_CONV_BN_FUSION", None)
    os.environ.pop("PDTPU_EAGER_JIT", None)
    addr, workers = p26_spawn()
    try:
        rec, launches = p26_train(fluid, fb, smi)
        marks["resnet"] = time.perf_counter() - t_phase
        bench = op_bench.bench_dygraph_mlp(device=P26_DEVICE)
        log("dygraph op_bench " + json.dumps(dict(bench, device=smi)))
        marks["op_bench"] = time.perf_counter() - t_phase
        p26_data_parallel(fluid, smi, addr, workers)
        marks["data_parallel"] = time.perf_counter() - t_phase
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.wait()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    log("dygraph " + json.dumps({
        "marks_s": marks, "wall_s": time.perf_counter() - t_phase,
        "device": smi}))
    return {k: launches["dygraph"][k] + launches["static"][k]
            for k in P26_BN_KEYS}


# -- phase 27: control flow, recurrent nets and the CRF -------------------------
P27_DEVICE = "cuda"
P27_B, P27_STEPS, P27_CHECKED = 10, 5, 3   # the book's batch; 5 steps
P27_LOSS_REL, P27_TIE_REL = 1e-4, 1e-5
P27_SRL = {}                  # SRLConfig overrides (none: conll05, full width)
P27_W = 512                   # the loop programs' width
P27_ARRAY_LEN, P27_WHILE_B, P27_WHILE_N, P27_WHILE_MAX = 8, 4, 6, 8
P27_RNN_B, P27_RNN_T = 4, 12
P27_GRAD_TOL, P27_SERVE_TOL = 1e-6, 1e-6
P27_SERVE = ["--requests", "256", "--concurrency", "32",
             "--buckets", "1,2,4,8,16,32"]
P27_SERVE_ROWS, P27_SERVE_DIM = 256, 512   # the tool's defaults
P27_PIPE = {"steps": 30, "batch": 256, "dim": 512, "depth": 4}
P27_OWN_SITES = ("rnn_ops.py", "crf_ops.py", "control_flow_ops.py")


def p27_place(fluid):
    return fluid.CUDAPlace(0) if P27_DEVICE == "cuda" else fluid.CPUPlace()


def p27_sync():
    import torch

    if P27_DEVICE == "cuda":
        torch.cuda.synchronize()


def p27_path_score(em, trans, path):
    """A tag path's Viterbi score in f64: start + end weights, the
    emissions along it and its pairwise transitions."""
    em, trans = em.astype(np.float64), trans.astype(np.float64)
    s = trans[0, path[0]] + trans[1, path[-1]]
    s += em[np.arange(len(path)), path].sum()
    return float(s + trans[2:][path[:-1], path[1:]].sum())


def p27_srl(fluid, smi):
    """(a): the book's db_lstm at conll05's widths trained P27_STEPS steps
    and decoded on the card and on the CPU from the same weights and
    feeds; then one step profiled and its host syncs counted."""
    import torch

    from paddle_tpu_torch.core import unique_name
    from paddle_tpu_torch.models import label_semantic_roles as srl
    from paddle_tpu_torch.ops import coverage_ops

    cfg = srl.SRLConfig(**P27_SRL)
    with unique_name.guard():
        main, startup, loss = srl.build_train_program(cfg)
    with unique_name.guard():
        dprog, path, chunks = srl.build_decode_program(cfg)
    (dec_op,) = [o for o in dprog.global_block().ops
                 if o.type == "crf_decoding"]
    emission = dec_op.inputs["Emission"][0]
    feeds = [srl.make_batch(cfg, P27_B, seed=2700 + i)
             for i in range(P27_STEPS)]
    dfeed = srl.make_batch(cfg, P27_B, seed=2799)
    dfetch = [path, *chunks[3:], emission]
    names = [v.name for v in main.list_vars() if v.persistable]

    marks, t_part = {}, time.perf_counter()

    def mark(name):
        marks[name] = round(time.perf_counter() - t_part, 3)

    gpu_scope = fluid.Scope()
    exe = fluid.Executor(p27_place(fluid))
    exe.run(startup, scope=gpu_scope)
    state = {n: gpu_scope.find_np(n) for n in names if gpu_scope.has_var(n)}
    # P27_CHECKED steps, the decode both devices compare, then the rest;
    # each batch is padded to its own longest row: a new feed signature,
    # so each of these steps is its plan's first run
    gpu_losses, step_ms, dec_ms = [], [], []
    for k, f in enumerate(feeds):
        if k == P27_CHECKED:
            for _ in range(3):
                t0 = time.perf_counter()
                gdec = exe.run(dprog, feed=dfeed, fetch_list=dfetch,
                               scope=gpu_scope)
                dec_ms.append((time.perf_counter() - t0) * 1e3)
            crfw_gpu = gpu_scope.find_np("crfw")
        t0 = time.perf_counter()
        gpu_losses.append(float(exe.run(main, feed=f, fetch_list=[loss],
                                        scope=gpu_scope)[0]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    mark("gpu_train_decode")

    cpu_scope = fluid.Scope()
    fluid.io.load_params_from_numpy(state, scope=cpu_scope)
    cexe = fluid.Executor(fluid.CPUPlace())
    t0 = time.perf_counter()
    cpu_losses = [float(cexe.run(main, feed=f, fetch_list=[loss],
                                 scope=cpu_scope)[0])
                  for f in feeds[:P27_CHECKED]]
    cdec = cexe.run(dprog, feed=dfeed, fetch_list=dfetch, scope=cpu_scope)
    cpu_s = time.perf_counter() - t0
    crfw_cpu = cpu_scope.find_np("crfw")
    mark("cpu_train_decode")

    loss_rel = [abs(g - c) / abs(c) for g, c in
                zip(gpu_losses[:P27_CHECKED], cpu_losses[:P27_CHECKED])]
    gpath, cpath = gdec[0], cdec[0]
    lens = dfeed["length"]
    differ = [b for b in range(P27_B)
              if not np.array_equal(gpath[b, :lens[b]], cpath[b, :lens[b]])]
    ties = []
    for b in differ:   # each row's two paths scored on the CPU's emission
        L = int(lens[b])
        gs = p27_path_score(cdec[-1][b, :L], crfw_cpu, gpath[b, :L])
        cs = p27_path_score(cdec[-1][b, :L], crfw_cpu, cpath[b, :L])
        ties.append({"row": b, "positions": int(
            (gpath[b, :L] != cpath[b, :L]).sum()), "gpu_path_score": gs,
            "cpu_path_score": cs, "rel": abs(gs - cs) / abs(cs)})
    counts = [int(np.asarray(v).ravel()[0]) for v in gdec[1:4]]
    cpu_counts = [int(np.asarray(v).ravel()[0]) for v in cdec[1:4]]
    # chunk_eval on the card over the CPU's decoded path
    dev = torch.device(P27_DEVICE)
    on_cpu_path = coverage_ops._chunk_eval(None, {
        "Inference": [torch.as_tensor(cpath, device=dev)],
        "Label": [torch.as_tensor(dfeed["target"], device=dev)],
        "Length": [torch.as_tensor(lens, device=dev)]},
        {"chunk_scheme": "IOB", "num_chunk_types": cfg.num_chunk_types})
    counts_on_cpu_path = [int(on_cpu_path[k][0]) for k in (
        "NumInferChunks", "NumLabelChunks", "NumCorrectChunks")]

    # one step profiled and one step's host reads, from the trained state
    m_scope = fluid.Scope()
    fluid.io.load_params_from_numpy(
        {n: gpu_scope.find_np(n) for n in state}, scope=m_scope)
    dev_feed = {k: torch.as_tensor(v, device=dev) for k, v in
                feeds[0].items()}

    def step():
        return exe.run(main, feed=dev_feed, fetch_list=[loss],
                       scope=m_scope, return_handle=True)

    step().numpy()
    warm_ms = []
    for _ in range(3):   # a repeated signature: the plan is cached
        t0 = time.perf_counter()
        step().numpy()
        warm_ms.append((time.perf_counter() - t0) * 1e3)
    mark("warm_steps")
    P17_READ_SITES.clear()
    handle, reads = count_host_reads(step)
    handle.numpy()
    sites = dict(P17_READ_SITES)
    torch.cuda.reset_peak_memory_stats()
    prof = profile_record("p27 srl train step", lambda: step().numpy(), 1)
    mark("profile")
    span_ms = cuda_ms(lambda: step().numpy(), iters=2, warmup=0)
    mark("span")
    busy = prof["device_busy_ms"]
    rec = {
        "config": {"word_dict_len": cfg.word_dict_len,
                   "pred_dict_len": cfg.pred_dict_len,
                   "label_dict_len": cfg.label_dict_len,
                   "hidden_dim": cfg.hidden_dim, "lstm_H": cfg.hidden_dim // 4,
                   "depth": cfg.depth, "B": P27_B, "dtype": "float32",
                   "T": [int(f["length"].max()) for f in feeds]},
        "gpu_losses": gpu_losses, "cpu_losses": cpu_losses,
        "loss_rel": loss_rel,
        "warm_step_ms_median": float(np.median(warm_ms)),
        "warm_step_ms": warm_ms, "first_run_step_ms": step_ms,
        "decode_ms_median": float(np.median(dec_ms[1:])),
        "cpu_train_and_decode_s": cpu_s,
        "crfw_rel_l2": rel_l2(crfw_gpu, crfw_cpu),
        "decode_rows_differing": len(differ), "ties": ties,
        "chunk_counts": counts, "cpu_chunk_counts": cpu_counts,
        "chunk_counts_on_cpu_path": counts_on_cpu_path,
        "host_reads_per_step": reads, "host_read_sites": sites,
        "launches_per_step": prof["device_events"],
        "device_ms_per_step": busy,
        "device_busy_share": prof["device_busy_share"],
        "profile": prof["profile"],
        "cuda_event_span_ms": span_ms,
        "span_check": ("not applicable: host-bound (busy share < 0.8)"
                       if busy is None or prof["device_busy_share"] is None
                       or prof["device_busy_share"] < 0.8 else
                       busy / span_ms),
        "peak_memory_MiB": prof["peak_memory_MiB"],
        "by_category_ms": prof["by_category_ms"],
        "top_kernels_ms": prof["top_kernels_ms"][:5], "marks_s": marks,
        "device": smi}
    log("recurrent srl " + json.dumps(rec, default=str))
    bad = []
    if max(loss_rel) > P27_LOSS_REL:
        bad.append(f"losses {loss_rel} > {P27_LOSS_REL}")
    if any(t["rel"] > P27_TIE_REL for t in ties):
        bad.append(f"decoded paths differ beyond a tie: {ties}")
    if not differ and counts != cpu_counts:
        bad.append(f"chunk counts {counts} != CPU {cpu_counts}")
    if counts_on_cpu_path != cpu_counts:
        bad.append(f"chunk counts on the CPU path {counts_on_cpu_path} != "
                   f"{cpu_counts}")
    if not all(np.isfinite(gpu_losses)):
        bad.append(f"losses {gpu_losses}")
    own = p27_own_reads(sites)
    if own:
        bad.append(f"host reads inside the recurrent ops: {own}")
    if bad:
        raise AssertionError("phase 27 srl: " + "; ".join(bad))
    return rec


def p27_own_reads(sites):
    """The host-read sites inside the recurrent and control-flow ops."""
    return {s: n for s, n in sites.items()
            if any(f"{o}:" in s for o in P27_OWN_SITES)}


def p27_run(fluid, build, feed, device, fetch_n, count=False):
    """Build (under a fresh name guard), start and run `build` once on
    `device` ("cuda" | "cpu"): (numpy fetches, None or {"reads": the
    run's host reads, "sites": where they came from})."""
    from paddle_tpu_torch.core import unique_name

    with unique_name.guard():
        main, startup, fetch = build()
    place = fluid.CPUPlace() if device == "cpu" else p27_place(fluid)
    exe = fluid.Executor(place)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    if not count:
        return exe.run(main, feed=feed, fetch_list=fetch, scope=scope), None
    P17_READ_SITES.clear()
    handle, reads = count_host_reads(
        lambda: exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                        return_handle=True))
    return handle.numpy(), {"reads": reads, "sites": dict(P17_READ_SITES)}


def p27_loops(fluid, smi):
    """(b): tests/test_control_flow_rnn.py's loop programs at width
    P27_W on the card against the CPU."""
    L = fluid.layers
    W = P27_W
    rng = np.random.RandomState(27)
    out = {}

    def while_array():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = L.data("x", [W], append_batch_size=False)
            i = L.fill_constant([1], "int64", 0)
            limit = L.fill_constant([1], "int64", P27_ARRAY_LEN)
            arr = L.create_array("float32", element_shape=[W],
                                 max_len=P27_ARRAY_LEN)
            cond = L.less_than(i, limit)
            cur = L.scale(x, scale=1.0)
            with L.While(cond):
                nxt = L.scale(L.elementwise_mul(cur, cur), scale=0.5,
                              bias=0.25)
                L.array_write(nxt, i, arr)
                L.assign(nxt, cur)
                L.increment(i, value=1)
                L.less_than(i, limit, cond=cond)
            n = L.array_length(arr)
        return main, startup, [arr, n, i]

    feed = {"x": rng.uniform(-1, 1, W).astype(np.float32)}
    g, reads = p27_run(fluid, while_array, feed, P27_DEVICE, 3, count=True)
    c, _ = p27_run(fluid, while_array, feed, "cpu", 3)
    out["while_array"] = {
        "bitwise": all(np.array_equal(a, b) for a, b in zip(g, c)),
        "length": int(np.asarray(g[1]).ravel()[0]),
        "host_reads": reads, "iterations": P27_ARRAY_LEN}

    def bounded(max_iters):
        def build():
            main, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(main, startup):
                x = L.data("x", [P27_WHILE_B, W], append_batch_size=False)
                acc = L.scale(x, scale=1.0)
                i = L.fill_constant([1], "int64", 0)
                n = L.fill_constant([1], "int64", P27_WHILE_N)
                cond = L.less_than(i, n)
                with L.While(cond, max_iters=max_iters):
                    L.assign(L.elementwise_add(L.scale(acc, scale=0.5),
                                               L.tanh(acc)), acc)
                    L.assign(L.increment(i, value=1), i)
                    L.assign(L.less_than(i, n), cond)
                loss = L.reduce_sum(acc)
                (gx,) = fluid.gradients([loss], [x])
            return main, startup, [loss, gx]
        return build

    feed = {"x": rng.uniform(-1, 1, (P27_WHILE_B, W)).astype(np.float32)}
    g, reads = p27_run(fluid, bounded(P27_WHILE_MAX), feed, P27_DEVICE, 2,
                       count=True)
    c, _ = p27_run(fluid, bounded(P27_WHILE_MAX), feed, "cpu", 2)
    import torch

    errs = [max_err(torch.as_tensor(np.asarray(a)),
                    torch.as_tensor(np.asarray(b)), P27_GRAD_TOL)
            for a, b in zip(g, c)]
    out["bounded_while"] = {
        "max_iters": P27_WHILE_MAX, "trip": P27_WHILE_N,
        "loss_err": errs[0][0], "grad_err": errs[1][0],
        "within": all(ok for _, ok in errs), "host_reads": reads}

    lengths = np.array([P27_RNN_T, 9, 5, 1], np.int64)[:P27_RNN_B]

    def rnn(dynamic):
        def build():
            B, T = P27_RNN_B, P27_RNN_T
            main, startup = fluid.Program(), fluid.Program()
            main.random_seed = startup.random_seed = 27
            with fluid.program_guard(main, startup):
                x = L.data("x", [B, T, W], append_batch_size=False)
                h0 = L.fill_constant([B, W], "float32", 0.0)
                if dynamic:
                    ln = L.data("len", [B], dtype="int64",
                                append_batch_size=False)
                    r = L.DynamicRNN()
                    guard = r.block()
                else:
                    r = L.StaticRNN()
                    guard = r.step()
                with guard:
                    xt = r.step_input(x, length=ln) if dynamic \
                        else r.step_input(x)
                    h = r.memory(init=h0)
                    nh = L.fc(L.concat([xt, h], axis=1), size=W, act="tanh",
                              param_attr=fluid.ParamAttr(name="rnn_w"),
                              bias_attr=fluid.ParamAttr(name="rnn_b"))
                    r.update_memory(h, nh)
                    r.output(nh)
                o = r()
            return main, startup, [o]
        return build

    feed = {"x": rng.uniform(-1, 1, (P27_RNN_B, P27_RNN_T, W)).astype(
        np.float32), "len": lengths}
    (dyn,), _ = p27_run(fluid, rnn(True), feed, P27_DEVICE, 1)
    (sta,), _ = p27_run(fluid, rnn(False), {"x": feed["x"]}, P27_DEVICE, 1)
    valid = np.arange(P27_RNN_T)[None, :] < lengths[:, None]
    diff = np.abs(dyn - sta)[valid].max()
    out["dynamic_vs_static"] = {
        "max_abs_err_valid": float(diff),
        "padded_zero": bool((dyn[~valid] == 0).all()),
        "lengths": lengths.tolist()}

    def clamps():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            a = L.data("a", [W], append_batch_size=False)
            b = L.data("b", [W], append_batch_size=False)
            i_hi = L.data("i_hi", [1], dtype="int64", append_batch_size=False)
            i_neg = L.data("i_neg", [1], dtype="int64",
                           append_batch_size=False)
            i_last = L.data("i_last", [1], dtype="int64",
                            append_batch_size=False)
            arr = L.create_array("float32", element_shape=[W], max_len=5)
            L.array_write(a, i_hi, arr)
            L.array_write(b, i_neg, arr)
            r_hi = L.array_read(arr, i_hi)
            r_last = L.array_read(arr, i_last)
            n = L.array_length(arr)
        return main, startup, [arr, r_hi, r_last, n]

    va = rng.randn(W).astype(np.float32)
    vb = rng.randn(W).astype(np.float32)
    feed = {"a": va, "b": vb, "i_hi": np.array([5 + 3]),
            "i_neg": np.array([-2]), "i_last": np.array([-1])}
    g, _ = p27_run(fluid, clamps, feed, P27_DEVICE, 4)
    p27_sync()   # a device-side assert would surface here
    c, _ = p27_run(fluid, clamps, feed, "cpu", 4)
    want = np.zeros((5, W), np.float32)
    want[4], want[3] = va, vb
    out["array_clamps"] = {
        "bitwise_vs_cpu": all(np.array_equal(x, y) for x, y in zip(g, c)),
        "as_expected": bool(np.array_equal(g[0], want)
                            and np.array_equal(g[1], va)
                            and np.array_equal(g[2], va)
                            and int(np.asarray(g[3]).ravel()[0]) == 9),
        "writes": {"i=8 (max_len + 3)": "slot 4", "i=-2": "slot 3"},
        "reads": {"i=8": "slot 4", "i=-1": "slot 4"}}
    log("recurrent loops " + json.dumps(dict(out, device=smi), default=str))
    bad = []
    if not out["while_array"]["bitwise"]:
        bad.append("while/array not bitwise the CPU's")
    if not out["bounded_while"]["within"]:
        bad.append(f"bounded while: {out['bounded_while']}")
    own = p27_own_reads(out["bounded_while"]["host_reads"]["sites"])
    if own:
        bad.append(f"the bounded while read the host inside the ops: {own}")
    if out["dynamic_vs_static"]["max_abs_err_valid"] > P27_GRAD_TOL or \
            not out["dynamic_vs_static"]["padded_zero"]:
        bad.append(f"DynamicRNN vs StaticRNN: {out['dynamic_vs_static']}")
    if not (out["array_clamps"]["bitwise_vs_cpu"]
            and out["array_clamps"]["as_expected"]):
        bad.append(f"array clamps: {out['array_clamps']}")
    if bad:
        raise AssertionError("phase 27 loops: " + "; ".join(bad))
    return out


def p27_bench_main(args):
    """serving_bench.main(args) with --metrics-out: (exit code, the
    metrics file's bench/* records)."""
    import io

    from paddle_tpu_torch.tools import serving_bench as sb

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "m.json")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = sb.main(args + ["--device", P27_DEVICE,
                                 "--metrics-out", path])
        with open(path) as f:
            snap = json.load(f)
    return rc, {k: v for k, v in snap.items() if k.startswith("bench/")}


def p27_row(r):
    return {k: r.get(k) for k in ("mode", "requests", "throughput_rps",
                                  "p50_ms", "p99_ms", "errors", "throttled")
            if k in r}


def p27_serving(fluid, smi):
    """(c): serving_bench at its defaults (the MLP 512 → 2048 → 2048 → 16,
    256 closed-loop requests at concurrency 32, buckets 1…32): the served
    outputs against the sequential Predictor's, then the tool's three
    runs and their exit codes."""
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.tools import serving_bench as sb

    rows = sb._gen_rows(P27_SERVE_ROWS, P27_SERVE_DIM)
    pred = sb.build_predictor(in_dim=P27_SERVE_DIM, device=P27_DEVICE)
    want = [pred.run_padded({"x": r}, 1)[0] for r in rows]
    server = serving.InferenceServer(pred, buckets=(1, 2, 4, 8, 16, 32),
                                     max_batch_delay_ms=2.0,
                                     max_queue_size=1024)
    server.warmup(example_feed={"x": rows[0]})
    with server:
        futs = [server.submit({"x": r}) for r in rows]
        got = [f.result()[0] for f in futs]
    err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    within = all(np.allclose(g, w, rtol=P27_SERVE_TOL, atol=P27_SERVE_TOL)
                 for g, w in zip(got, want))
    runs = {}
    for name, extra in (("fp32", []), ("int8", ["--precision", "int8"]),
                        ("tenants", ["--models", "ads:2,feed:1",
                                     "--replicas", "3",
                                     "--slo-p99-ms", "500"])):
        rc, bench = p27_bench_main(P27_SERVE + extra)
        seq, served = bench.get("bench/sequential"), bench["bench/served"]
        rec = {"rc": rc, "sequential": p27_row(seq) if seq else None,
               "served": p27_row(served)}
        want_rc = 1 if seq and served["throughput_rps"] <= \
            seq["throughput_rps"] else 0
        if name == "tenants":
            ten = bench["bench/tenants"]
            rec["tenants"] = {n: p27_row(r) for n, r in
                              ten["per_tenant"].items()}
            breach = any(r["p99_ms"] > 500 or r["errors"] > 0
                         for r in ten["per_tenant"].values())
            want_rc = want_rc or (2 if breach else 0)
        rec["rc_by_contract"] = want_rc
        runs[name] = rec
    rec = {"served_vs_sequential_max_abs_err": err,
           "within_1e-6": within, "runs": runs, "device": smi}
    log("recurrent serving_bench " + json.dumps(rec, default=str))
    bad = [n for n, r in runs.items() if r["rc"] != r["rc_by_contract"]]
    if not within or bad:
        raise AssertionError(f"phase 27 serving_bench: within={within} "
                             f"err={err} exit codes off the contract: {bad}")
    return rec


def p27_pipeline(fluid, smi):
    """(d): pipeline_bench at its defaults on the card."""
    from paddle_tpu_torch.tools import pipeline_bench as pb

    res = pb.run_pipeline_bench(device=P27_DEVICE, **P27_PIPE)
    res.pop("sync_losses")
    log("recurrent pipeline_bench " + json.dumps(dict(res, device=smi)))
    if res["outputs_identical"] is not True:
        raise AssertionError(f"phase 27 pipeline_bench: {res}")
    return res


def phase_recurrent(fluid, smi):
    """Phase 27 (module docstring)."""
    t_phase = time.perf_counter()
    marks = {}
    for name, part in (("srl", p27_srl), ("loops", p27_loops),
                       ("serving_bench", p27_serving),
                       ("pipeline_bench", p27_pipeline)):
        part(fluid, smi)
        marks[name] = time.perf_counter() - t_phase
    log("recurrent " + json.dumps({
        "marks_s": marks, "wall_s": time.perf_counter() - t_phase,
        "device": smi}))


def p27_child():
    """Phase 27 in a process of its own (``chip_smoke.py --p27``), so that
    its profile is read in a process no other process or thread has used
    the card beside. Prints the phase's lines, then its sessions' checks."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch.core.executor import cuda_device

    cuda_device(0)
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on at start")
    PHASE[0] = "27"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    phase_recurrent(fluid, smi)
    print("p27 sessions " + json.dumps(SESSIONS), flush=True)
    torch.cuda.synchronize()


def phase_recurrent_proc():
    """Phase 27 through `p27_child` in a fresh process; its lines pass
    through. Returns its sessions' checks."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--p27"], capture_output=True, text=True,
                          timeout=600)
    sessions = None
    for line in proc.stdout.splitlines():
        if line.startswith("p27 sessions "):
            sessions = json.loads(line[len("p27 sessions "):])
        else:
            log(line)
    if proc.returncode != 0 or sessions is None:
        raise AssertionError(f"phase 27 (--p27) exited {proc.returncode}:"
                             f" {proc.stderr[-4000:]}")
    return sessions


def main():
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import paddle_tpu_torch as fluid
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    from paddle_tpu_torch.core.executor import cuda_device
    from paddle_tpu_torch.ops.kernels import build
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import flash_attention_sparse as fas
    from paddle_tpu_torch.ops.kernels import fused_bn as fb
    from paddle_tpu_torch.ops import deferred_rows as dr
    from paddle_tpu_torch.ops.kernels import sparse_adagrad as fsa

    # 1. device (TF32 stays off, FLAGS_matmul_precision's default, for the
    # f32 comparisons)
    cuda_device(0)
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on at start")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {kind} | {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    phase_s, prev = {}, ["2", time.perf_counter()]
    PHASE[0] = "2"

    def mark(name):
        """The seconds of the phase that ends here; `name` begins."""
        phase_s[prev[0]] = time.perf_counter() - prev[1]
        prev[:] = [name, time.perf_counter()]
        PHASE[0] = name

    # 2. build (each phase's seconds land in phase_s)
    t0 = time.perf_counter()
    built = build.build_all()
    log(f"build: {json.dumps(built)} ({time.perf_counter() - t0:.1f} s wall)")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"build {name}: {line.strip()}")
    log_wgmma_build(build)

    mark("3")

    # 3. kernel
    records = phase_kernel(fa)
    bwd_records = phase_kernel_bwd(fa)
    phase_kernel_routes(fa)
    phase_kernel_wide(fa, fas)
    wide_records = phase_kernel_wider(fa, fas)

    # the other kernel phases (6, 8, 10) run next, before any main path:
    # after phases 4-5 their profiler sessions came back short (ROADMAP
    # §C)
    mark("6")

    # 6. fused batch-norm kernels
    bn_records = phase_kernel_bn(fb)

    mark("8")

    # 8. block-sparse attention kernels
    sparse_records = phase_kernel_sparse(fas)
    phase_sparse_f32_head_dims(fas)
    phase_sparse_routes(fas)

    mark("10")

    # 10. sparse-Adagrad and row kernels
    sa_records = phase_kernel_sparse_adagrad(fsa, dr)

    mark("4")

    # 4. serve (main path 1)
    launches = phase_serve(fluid, fa)

    mark("5")

    # 5. train (main path 2)
    train_launches = phase_train(fluid, fa)

    mark("7")

    # 7. resnet (main path 3)
    bn_launches = phase_resnet(fluid, fb)

    mark("9")

    # 9. nmt (main path 4)
    nmt_launches = phase_nmt(fluid, fas)

    mark("9b")

    # 9b. the wide kernels (main path 7)
    wide_launches = phase_wide_path(fluid, fa, fas)

    mark("11")

    # 11. deepfm (main path 5)
    sa_launches = {"sparse_adagrad_update": phase_deepfm(fluid, fsa)}

    mark("12")

    # 12. ps hot cache (main path 6)
    hot = phase_ps_hot_cache(fluid, fsa)
    sa_launches.update(sparse_row_gather=hot["fused_row_gather"],
                       sparse_row_scatter=hot["fused_row_scatter"])

    mark("13")

    # 13. deepfm GPU vs CPU
    phase_deepfm_gpu_vs_cpu(fluid)

    mark("14")

    # 14. the executor's step surface (remat, update fusion, NaN probe,
    # fetch handles)
    phase_step_surface(fluid, fa, fb)

    mark("15")

    # 15. the training surface (schedules, optimizers, conditional_block,
    # auc, LeNet; ResNet-50 on LARS, Transformer-big on noam, BERT-base on
    # gradient-merged LAMB)
    phase_training_surface(fluid, fa, fas, fb, smi)

    mark("16")

    # 16. the input pipeline and checkpoints (DeviceLoader, the drivers,
    # Checkpointer, reference-format serving, the PS prefetcher)
    phase_input_pipeline(fluid, fa, fsa, smi)

    mark("17")

    # 17. the deferred-row log and the A6 paths (the space-to-depth
    # ResNet-50 stem, ResNet-50 serving, bucketed NMT, sequence/beam ops)
    phase_deferred_and_a6(fluid, fb, smi)

    mark("18")

    # 18. inference and serving (int8, the InferenceServer, the fleet,
    # PS-backed CTR serving)
    launches["float32"] += phase_inference_serving(fluid, fa, smi)

    mark("19")

    # 19. the PS tier over sockets, shard recovery, PS checkpoints,
    # online learning and serving from socket shards
    phase_ps_tier_and_streaming(fluid, fsa, smi)

    mark("20")

    # 20. data and sequence parallelism on an NCCL group (the collectives,
    # BERT-base and ResNet-50 under with_data_parallel at ZeRO stages
    # 0-3, the ring and Ulysses attention)
    p20_flash, p20_bn = phase_parallel(fluid, fa, fb, smi)
    for key, n in p20_flash.items():
        train_launches[key] += n
    for k, n in p20_bn.items():
        bn_launches["bfloat16"][k] += n

    mark("21")

    # 21. model parallelism on a group of two (tensor parallelism on a tp
    # axis: BERT-base, Transformer-big NMT, DeepFM's vocab-sharded packed
    # table; MoE expert parallelism on ep; a tp-sharded checkpoint)
    p21 = phase_model_parallel(fluid, fa, fas, fsa, smi)
    for dt, bert_key, nmt_key in (("float32", "bert_f32", "nmt_f32"),
                                  ("bfloat16", "bert_bf16", "nmt_bf16")):
        for d in ("fwd", "bwd"):
            train_launches[(d, dt)] += p21["launches"][bert_key][d]
            nmt_launches[dt][d] += p21["launches"][nmt_key][d]
    sa_launches["sparse_adagrad_update"] += p21["row12"]

    mark("22")

    # 22. pipelines and the sequence axis (GPipe over pp = 2 on BERT-base,
    # attention dropout under tp = 2 on BERT-base and Transformer-big,
    # sp = 2 on BERT-base, the composed tp2×pp2 program, a pp checkpoint
    # restored into the plain executor)
    p22 = phase_pipelines(fluid, fa, fas, smi)
    for key, dt in (("pp_f32", "float32"), ("pp_bf16", "bfloat16"),
                    ("tp_f32_drop", "float32"), ("sp_f32_drop0.0", "float32"),
                    (f"sp_f32_drop{P22_DROP}", "float32"),
                    ("composed_f32", "float32")):
        for d in ("fwd", "bwd"):
            train_launches[(d, dt)] += p22["launches"][key][d]
    for d in ("fwd", "bwd"):
        nmt_launches["bfloat16"][d] += p22["launches"]["tp_nmt_bf16_drop"][d]

    mark("23")

    # 23. model parallelism, the rest (a global-norm clip across pp = 2
    # stages on BERT-base, BERT-base on tp2×sp2 with dropout, moe_ffn's
    # dense path on dp = 2 and on {"dp": 2, "ep": 2}, a rule-A op in a
    # BERT-base head at dp = 2)
    p23 = phase_model_parallel_rest(fluid, fa, smi)
    for key, dt in (("pp_clip_f32", "float32"), ("pp_clip_bf16", "bfloat16"),
                    ("tpsp_f32_drop", "float32")):
        for d in ("fwd", "bwd"):
            train_launches[(d, dt)] += p23["launches"][key][d]

    mark("24")

    # 24. fleet and cluster (the fleet path on BERT-base, DGC momentum on
    # ResNet-50, local SGD and the DGC exchanges on a gloo pair, elastic
    # resume, the memory planner, the deferred fold on a mesh)
    p24_flash, p24_bn = phase_fleet_cluster(fluid, fa, fb, smi)
    for d in ("fwd", "bwd"):
        train_launches[(d, "float32")] += p24_flash[d]
    for k, n in p24_bn.items():
        bn_launches["bfloat16"][k] += n

    mark("25")

    # 25. the root-cause loop (calibrated floors, the perf ledger on
    # BERT-base bf16 training, a profiler session's roofline and timeline,
    # an anomaly-triggered capture paging with its culprits, op_bench)
    p25 = phase_root_cause_proc()
    for d in ("fwd", "bwd"):
        train_launches[(d, "bfloat16")] += p25[d]

    mark("26")

    # 26. dygraph (ResNet-50 in dygraph on the fused-BN kernels against the
    # static executor, dygraph.jit, op_profiler, the dygraph op_bench,
    # DataParallel on a gloo pair), in a process of its own
    p26, p26_sessions = phase_dygraph_proc()
    for k, n in p26.items():
        bn_launches["float32"][k] += n

    mark("27")

    # 27. control flow, recurrent nets and the CRF (the book's SRL db_lstm
    # trained and decoded at full width against the CPU, the loops and
    # tensor arrays against the CPU, serving_bench and pipeline_bench at
    # their defaults), in a process of its own
    p27_sessions = phase_recurrent_proc()

    mark("end")
    log("phase seconds " + json.dumps(phase_s))

    # every profiler session's check against the launch counters
    sessions = SESSIONS + (p26_sessions or []) + (p27_sessions or [])
    by_status = {}
    for rec in sessions:
        by_status[rec["status"]] = by_status.get(rec["status"], 0) + 1
    by_phase = {}
    for rec in sessions:
        ph = by_phase.setdefault(rec["phase"], {})
        ph[rec["status"]] = ph.get(rec["status"], 0) + 1
    log("profile sessions " + json.dumps({
        "sessions": len(sessions), "by_status": by_status,
        "by_phase": by_phase,
        "retaken": [[r["phase"], r["label"], r["tries"]] for r in sessions
                    if r["tries"] > 1],
        "incomplete": [r for r in sessions
                       if r["status"] not in ("checked", "unchecked")]}))

    kernels = []
    for name in ("float32", "bfloat16"):
        rec = records[(name, 512)]
        kernels.append({
            "name": f"flash_attention_fwd[{name}]", "route": "cuda",
            "source": FA_SOURCE, "replaces": FA_REPLACES,
            "launches": launches[name] + train_launches[("fwd", name)],
            "max_abs_err": max(rec["max_abs_err_out"], rec["max_abs_err_lse"],
                               rec["max_abs_err_dropout"]),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            "dropout_ms": rec["dropout_ms"],
            "vs_library": rec["ms_vs_library"],
            "bound_share": rec["ms_bound_share"],
            **({"bound_fma_ms": rec["bound_fma_ms"]} if "bound_fma_ms" in rec
               else {}),
            "shape": f"B={B} nh={NH} T=512 d={D}"})
    for name in ("float32", "bfloat16"):
        rec = bwd_records[(name, 512)]
        kernels.append({
            "name": f"flash_attention_bwd[{name}]", "route": "cuda",
            "source": FA_BWD_SOURCE, "replaces": FA_BWD_REPLACES,
            "launches": train_launches[("bwd", name)],
            "max_abs_err": max(max(e.values())
                               for e in rec["max_abs_err"].values()),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
            "dropout_ms": rec["dropout_ms"],
            "vs_library": rec["ms_vs_library"],
            "bound_share": rec["ms_bound_share"],
            **({"bound_fma_ms": rec["bound_fma_ms"]} if "bound_fma_ms" in rec
               else {}),
            "shape": f"B={B} nh={NH} T=512 d={D}"})
    for kname, count_keys in (("fused_bn_stats", ("bn_stats",)),
                              ("fused_bn_apply", ("bn_apply", "apply2d")),
                              ("fused_bn_bwd", ("bn_bwd_reduce",)),
                              ("fused_conv_stats", ("conv_stats",))):
        for name in ("float32", "bfloat16"):
            rec = bn_records[(kname, name)]
            kernels.append({
                "name": f"{kname}[{name}]", "route": "cuda",
                "source": BN_SOURCE, "replaces": BN_REPLACES[kname],
                "launches": sum(bn_launches[name][k] for k in count_keys),
                "max_abs_err": max(rec["max_abs_err"].values()),
                "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                "library_ms": rec["library_ms"], "shape": rec["shape"],
                **{k: rec[k] for k in ("bound_fma_ms", "all_shapes")
                   if k in rec}})
    for kname, replaces in (("fwd", FAS_REPLACES), ("bwd", FAS_BWD_REPLACES)):
        for name in ("float32", "bfloat16"):
            rec = sparse_records[(kname, name)]
            kernels.append({
                "name": f"flash_attention_sparse_{kname}[{name}]",
                "route": "cuda", "source": FAS_SOURCE, "replaces": replaces,
                "launches": nmt_launches[name][kname],
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
                "dropout_ms": rec["dropout_ms"],
                **{k: rec[k] for k in ("delta_ms", "bound_fma_ms")
                   if k in rec},
                "shape": f"encoder self B={NMT_B} nh={NMT_NH} T={NMT_T} "
                         f"d={D}"})
    for key, kname, replaces in (
            ("fwd", "flash_attention_wide_fwd", FA_REPLACES),
            ("bwd", "flash_attention_wide_bwd", FA_BWD_REPLACES),
            ("sparse_fwd", "flash_attention_sparse_wide_fwd", FAS_REPLACES),
            ("sparse_bwd", "flash_attention_sparse_wide_bwd",
             FAS_BWD_REPLACES)):
        for name in ("float32", "bfloat16"):
            rec = wide_records[(key, name)]
            kernels.append({
                "name": f"{kname}[{name}]", "route": "cuda",
                "source": FAW_SOURCE, "replaces": f"{replaces}, d >= 320",
                "launches": wide_launches[(key, name)],
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
                "dropout_ms": rec["dropout_ms"],
                "vs_library": rec["ms_vs_library"],
                "bound_share": rec["ms_bound_share"],
                **{k: rec[k] for k in ("bound_fma_ms", "ctas") if k in rec},
                "shape": rec["shape"]})
    for kname, dt in (("sparse_adagrad_update", "float32"),
                      ("sparse_row_gather", "uint16"),
                      ("sparse_row_scatter", "uint16")):
        rec = sa_records[kname]
        kernels.append({
            "name": f"{kname}[{dt}]", "route": "cuda", "source": SA_SOURCE,
            "replaces": SA_REPLACES[kname], "launches": sa_launches[kname],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "shape": rec["shape"]})
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s wall")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if "--p27" in sys.argv:
        p27_child()
        sys.exit(0)
    if "--p25" in sys.argv:
        p25_child()
        sys.exit(0)
    if "--p26" in sys.argv:
        p26_child()
        sys.exit(0)
    if "--p26-rank" in sys.argv:
        args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        p26_worker(int(args["--p26-rank"]), int(args["--p26-world"]),
                   args["--p26-addr"])
        sys.exit(0)
    if "--p24-rank" in sys.argv:
        args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        p24_worker(int(args["--p24-rank"]), int(args["--p24-world"]),
                   args["--p24-addr"])
        sys.exit(0)
    if "--p24-elastic" in sys.argv:
        args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        p24_elastic_child(args["--p24-elastic"], int(args["--p24-steps"]),
                          int(args["--p24-port"]))
        sys.exit(0)
    if "--p22-probe" in sys.argv:
        args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        p22_probe_rank(int(args["--p22-probe"]), int(args["--p22-world"]),
                       args["--p22-addr"])
        sys.exit(0)
    if "--p22-rank" in sys.argv:
        args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        p22_worker(int(args["--p22-rank"]), int(args["--p22-world"]),
                   args["--p22-addr"], args["--p22-backend"],
                   args["--p22-job"], args["--p22-ck"])
        sys.exit(0)
    if "--p21-rank" in sys.argv:
        args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        p21_worker(int(args["--p21-rank"]), int(args["--p21-world"]),
                   args["--p21-addr"], args["--p21-backend"],
                   args["--p21-ck"])
        sys.exit(0)
    if "--p20-rank" in sys.argv:
        args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        p20_worker(int(args["--p20-rank"]), int(args["--p20-world"]),
                   args["--p20-addr"])
        sys.exit(0)
    sys.exit(main())
