#!/usr/bin/env python3
"""Smoke test of paddle_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
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
             of a 2,097,152-row table, 36 steps (3 warm-up), arms
             (pull_ahead, push_depth) = (0,0), (2,0), (2,1), (2,1) with a
             212,992-row hot cache, (2,1) under a 1 Hz FederatedScraper:
             each arm's losses and final shard bytes bitwise equal to an
             in-process run on the same feeds; examples/s, median step
             ms, bytes pulled and pushed a shard, prefetch hits/misses,
             the device busy share of the last (profiled) step, row-12
             launches (one a step) and rows 13-14 in the hot arm. In the
             hot arm, PS checkpoints: save(ps_tables=) before step 12
             with dirty slab rows (flushed through the row-13 gather),
             deltas before steps 18 and 24, the chain restored onto 3
             in-process shards bitwise equal to the live table; the ms
             save holds the loop, bytes, restore ms. The aggregate
             67,108,864-row (17.18 GB) table over 8 socket shards at
             (2,1): finite losses, examples/s, RSS. A pserver SIGKILLed
             mid-run (B = 1024, V = 262,144, 2 runner processes, 18
             steps, killed before step 8, restarted after 0.25 s; with
             and without a 53,248-row hot cache): losses bitwise equal to
             the uninterrupted run, one recovery, RPC retries, the
             recovery pause, journal bytes, /healthz through a
             ShardMonitor ok -> degraded -> ok with the times. Online
             learning (the JAX bench's cell: 200,000-id stream, 2 dynamic
             shards of 16,384 rows, 600 steps of 256, a PsLookupPredictor
             on the card fed by a DeltaPublisher with a 1 s budget): AUC
             rises, rows materialized past the capacity while live rows
             stay within it, staleness p99 within the budget, the serving
             cache bitwise equal to the shards, a delta chain restored
             bitwise. Serving from socket shards: phase 18's CTR model at
             2,097,152 rows loaded over the wire into 2 runner pservers,
             2 ProcessReplicas (--ps-endpoints, on the card) answering 64
             batches of 8 bitwise like a ThreadReplica over an in-process
             table; ps_admin stats, dump-health and fleet exit 0 where
             torch cannot be imported. The phase's wall time.
The last lines are the kernels' JSON record, the card's name and power
limit, and {"ok": true, "device": {...}}; the line before them gives the
script's wall seconds. Exits non-zero without a result when torch sees no
CUDA device or the port is not beside this script.

"""
import json
import os
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


def profile_device(fn, iters=10, counts=None):
    """Device time by kernel name over `iters` calls of fn, from
    torch.profiler: ({name: us per call}, wall us per call, device
    events per call). `counts`, if given, gets {name: launches per call}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6 / iters
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


def device_ms(fn):
    """ms of device time per call of fn, summed over its kernels: the
    median of three profiler sessions that report device events (a session
    has come back with none, and once with a fraction of them), from at
    most six."""
    sums = []
    for _ in range(6):
        per, _, _ = profile_device(fn)
        if per:
            sums.append(sum(per.values()) / 1e3)
        if len(sums) == 3:
            break
    return float(np.median(sums)) if sums else 0.0


def cold_device_ms(fn, iters=10):
    """ms of device time per call of fn with the L2 cache flushed before
    each call (a 64 MB in-place bitwise_not, whose own kernel is left out of
    the sum): a row kernel called back to back on the same rows would
    otherwise find them in the 50 MB L2 and beat the HBM bound."""
    import torch

    buf = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")

    def call():
        buf.bitwise_not_()
        fn()

    for _ in range(3):
        per, _, _ = profile_device(call, iters)
        per = {k: v for k, v in per.items() if "bitwise_not" not in k}
        if per:
            break
    return sum(per.values()) / 1e3


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
    per, wall_us, events = profile_device(fn, iters=iters, counts=counts)
    busy = sum(per.values())
    ranked = sorted(per.items(), key=lambda kv: -kv[1])
    cats, cat_n = {}, {}
    for name, us in per.items():
        cats[category(name)] = cats.get(category(name), 0.0) + us / 1e3
        cat_n[category(name)] = cat_n.get(category(name), 0) + counts[name]
    return {"call": label, "wall_ms": wall_us / 1e3,
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


def kernel_label(mangled):
    """A readable name of a flash or K2 kernel from its mangled one, e.g.
    _ZN...flash_fwd_bf16_kernelILi64EE... -> flash_fwd_bf16_kernel<64>;
    None for another kernel."""
    import re

    k = re.search(r"((?:flash|sparse)_[fb]wd_\w+?_kernel)ILi(\d+)E"
                  r"(?:Li(\d+)E)?", mangled)
    if k:
        return (f"{k.group(1)}<{k.group(2)}"
                f"{', ' + k.group(3) if k.group(3) else ''}>")
    k = re.search(r"(apply_kernel|bwd_dx_kernel)I(f|13__nv_bfloat16)"
                  r"Lb([01])ELb([01])E", mangled)
    if k:
        return (f"{k.group(1)}<{'float' if k.group(2) == 'f' else 'bf16'}, "
                f"res={k.group(3)}, relu={k.group(4)}>")
    k = re.search(r"conv_stats_f32_kernelILb([01])E", mangled)
    if k:
        return f"conv_stats_f32_kernel<resident W={k.group(1)}>"
    k = re.search(r"conv_stats_bf16_kernelILi(\d+)ELi(\d+)ELi(\d+)E",
                  mangled)
    if k:
        return (f"conv_stats_bf16_kernel<BN={k.group(1)}, CTAs/SM="
                f"{k.group(2)}, resident W={k.group(3)} B>")
    k = re.search(r"(wide_[fb]wd_(?:f32|bf16)_kernel)ILb([01])E", mangled)
    if k:
        return f"{k.group(1)}<sparse={k.group(2)}>"
    k = re.search(r"wide_role_f32_kernelILi(\d)ELb([01])E", mangled)
    if k:
        role = ("fwd", "dq", "dk", "dv")[int(k.group(1))]
        return f"wide_role_f32_kernel<{role}, sparse={k.group(2)}>"
    return None


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
            flops = 4.0 * B * NH * t * t * D
            nbytes = (4 * B * t * HIDDEN * q.element_size()   # q, k, v, out
                      + B * NH * t * 4                       # lse
                      + bias.numel() * bias.element_size())
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
            flops = 10.0 * B * NH * t * t * D   # s, dp, dv, dk, dq
            nbytes = (8 * B * t * HIDDEN * q.element_size()  # q k v out dO dq dk dv
                      + 2 * B * NH * t * 4                  # lse, delta
                      + bias.numel() * bias.element_size())
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
    rows = b * nh * t
    isz = q.element_size()
    for rec, flops, nbytes in (
            (recs["fwd"], 4.0 * rows * t * d,
             4 * rows * d * isz + rows * 4 + mask.numel() * isz),
            (recs["bwd"], 10.0 * rows * t * d,
             8 * rows * d * isz + 2 * rows * 4 + mask.numel() * isz)):
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
            log(f"train {name}: flash kernels {flash_ms:.4f} device ms a "
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
                "device_busy_share_of_median": rec["device_busy_ms"] / med}))
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
    nbytes = (2 + has_res) * m * c * x2.element_size() + 3 * c * 4
    flops = (4.0 + has_res + (act == "relu")) * m * c
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
            flops = 2.0 * m * ci * co
            nbytes = (m * ci + ci * co + m * co) * isz + 2 * co * 4
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
                nbytes = 3 * m * co * isz + 5 * co * 4
                bound_ms, bound_by = bound(10.0 * m * co, nbytes, name)
                # each pass alone: the reduce reads dy and x once, the dx
                # pass reads them again and writes dx; the two passes
                # together move 5 M·C elements (the two-pass floor)
                reduce_bound = bound(4.0 * m * co, 2 * m * co * isz
                                     + 4 * co * 4, name)[0]
                dx_bound = bound(6.0 * m * co, 3 * m * co * isz + 5 * co * 4,
                                 name)[0]
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
            nbytes = m * c * isz + 2 * c * 4
            bound_ms, bound_by = bound(3.0 * m * c, nbytes, name)
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
                "device_busy_share_of_median": rec["device_busy_ms"] / med,
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
    b, nh, tq, d = q.shape
    tk = k.shape[2]
    isz = q.element_size()
    pairs = stats["visible_pairs"]
    small = se.numel() * 4 + vis.numel() * 4
    fwd_bytes = (2 * tq + 2 * tk) * b * nh * d * isz + b * nh * tq * 4 + small
    bwd_bytes = ((4 * tq + 4 * tk) * b * nh * d * isz + 2 * b * nh * tq * 4
                 + small)
    for rec, flops, nbytes in ((fwd, 4.0 * d * pairs, fwd_bytes),
                               (bwd, 10.0 * d * pairs, bwd_bytes)):
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
                "device_busy_share_of_median": rec["device_busy_ms"] / med,
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
                    rec["device_busy_ms"] / f32_ms[1],
                "sparse_flash_ms": sparse_ms,
                "sparse_flash_share_of_busy":
                    sum(sparse_ms.values()) / rec["device_busy_ms"],
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
    nbytes = nu * (8 + 4 * DEEPFM_VIS + 8 * DEEPFM_VIS + 2 * fsa.PACK_LANES) \
        + (DEEPFM_ROWS - nu) * 8
    bound_ms, bound_by = bound(6.0 * nu * DEEPFM_VIS, nbytes, "float32")
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
    row_bytes = 2 * fsa.PACK_LANES
    n_slots, n_src = int(slots.unique().numel()), int(src.unique().numel())
    s16 = fsa.i16(slab)
    for kname, fn, plain_fn, lib_fn, lib, nbytes in (
            ("sparse_row_gather",
             lambda: fsa.fused_row_gather(slab, slots),
             lambda: fsa.fused_row_gather_plain(slab, slots),
             lambda: s16.index_select(0, slots), "Tensor.index_select",
             (n_slots + n) * row_bytes + n * 8),
            ("sparse_row_scatter",
             lambda: fsa.fused_row_scatter(slab, slots, rows, src),
             lambda: fsa.fused_row_scatter_plain(slab, slots, rows, src),
             lambda: s16.index_copy_(0, slots, fsa.i16(rows)),
             "Tensor.index_copy_", (n_src + n_slots) * row_bytes + n * 16)):
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
                "device_busy_share_of_median": rec["device_busy_ms"] / med,
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
    rec["plain_busy_share"] = (prof_plain["device_busy_ms"]
                               / rec["plain_median_step_ms"])
    rec["loader_busy_share"] = (prof_loader["device_busy_ms"]
                                / rec["loader_median_step_ms"])
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
        exe._run_epilogue = lambda eprog, sc: around_fold(orig, eprog, sc)
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
P19_B, P19_VOCAB, P19_SHARDS, P19_STEPS, P19_WARMUP = (
    4096, 2_097_152, 8, 36, 3)
P19_ROWS = P19_B * 26
P19_ARMS = ((0, 0, 0, False), (2, 0, 0, False), (2, 1, 0, False),
            (2, 1, 2 * P19_ROWS, False), (2, 1, 0, True))
P19_BIG_VOCAB, P19_BIG_STEPS, P19_BIG_WARMUP = 67_108_864, 6, 2
# PS checkpoints inside the hot arm: a full save before step 12 (dirty
# rows in the slab), deltas before steps 18 and 24
P19_SAVE_AT, P19_DELTAS_AT = 12, (18, 24)
# bench.py:926-1070: B = 1024 over 2 runner pservers of a 262,144-row
# table, 18 steps, SIGKILL shard 1 before step 8, restart it 0.25 s later
P19_KILL = {"batch": 1024, "vocab": 262_144, "steps": 18, "kill_step": 8,
            "restart_s": 0.25}
P19_KNOBS = {"PDTPU_PS_RETRIES": "60", "PDTPU_PS_RETRY_BACKOFF_MS": "20",
             "PDTPU_PS_TIMEOUT": "10"}
# bench.py:1938-2095 at its TPU sizes
P19_ONLINE = {"vocab": 200_000, "cap": 16_384, "steps": 600, "batch": 256,
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
    """(fn(), {wall, device busy ms and share}) of one profiled call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = 0.0
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) is not None \
                and "cuda" in str(evt.device_type).lower():
            busy += _device_us(evt) / 1e3
    return out, {"wall_ms": wall, "device_busy_ms": busy,
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
    arms, ck_out = [], {}
    for pull_ahead, push_depth, hot_rows, scrape in P19_ARMS:
        t_arm = time.perf_counter()
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
            losses, r = p19_train(fluid, deepfm, fsa, table, feeds,
                                  pull_ahead, push_depth, hot_rows,
                                  P19_WARMUP, hook=hook,
                                  hook_steps=(P19_SAVE_AT,) + P19_DELTAS_AT
                                  if hot_rows else (), keep=keep)
            doc = keep.pop("scrape", None)
            final_equal = bool(np.array_equal(keep.pop("table"),
                                              ref_final))
        finally:
            if scraper is not None:
                scraper.stop()
            for s in servers:
                s.stop()
        r.update(wall_s=time.perf_counter() - t_arm,
                 pull_ahead=pull_ahead, push_depth=push_depth,
                 hot_rows=hot_rows, scraper_hz=1.0 if scrape else 0.0,
                 losses_bitwise=losses == ref_losses,
                 shards_bitwise=final_equal)
        if doc is not None:
            r["scrape"] = {"ok": doc["ok"], "targets": len(doc["targets"]),
                           "signals": doc["signals"]}
        launches = r["launches"]
        if not (r["losses_bitwise"] and final_equal):
            raise AssertionError(
                f"ps sockets arm {(pull_ahead, push_depth, hot_rows)}: not "
                f"bitwise ({losses[:3]} vs {ref_losses[:3]})")
        if launches["fused_adagrad_update"] != P19_STEPS:
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

    # 2. build
    t0 = time.perf_counter()
    built = build.build_all()
    log(f"build: {json.dumps(built)} ({time.perf_counter() - t0:.1f} s wall)")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"build {name}: {line.strip()}")
    log_wgmma_build(build)

    # 3. kernel
    records = phase_kernel(fa)
    bwd_records = phase_kernel_bwd(fa)
    phase_kernel_routes(fa)
    phase_kernel_wide(fa, fas)
    wide_records = phase_kernel_wider(fa, fas)

    # 4. serve (main path 1)
    launches = phase_serve(fluid, fa)

    # 5. train (main path 2)
    train_launches = phase_train(fluid, fa)

    # 6. fused batch-norm kernels
    bn_records = phase_kernel_bn(fb)

    # 7. resnet (main path 3)
    bn_launches = phase_resnet(fluid, fb)

    # 8. block-sparse attention kernels
    sparse_records = phase_kernel_sparse(fas)
    phase_sparse_f32_head_dims(fas)
    phase_sparse_routes(fas)

    # 9. nmt (main path 4)
    nmt_launches = phase_nmt(fluid, fas)

    # 9b. the wide kernels (main path 7)
    wide_launches = phase_wide_path(fluid, fa, fas)

    # 10. sparse-Adagrad and row kernels
    sa_records = phase_kernel_sparse_adagrad(fsa, dr)

    # 11. deepfm (main path 5)
    sa_launches = {"sparse_adagrad_update": phase_deepfm(fluid, fsa)}

    # 12. ps hot cache (main path 6)
    hot = phase_ps_hot_cache(fluid, fsa)
    sa_launches.update(sparse_row_gather=hot["fused_row_gather"],
                       sparse_row_scatter=hot["fused_row_scatter"])

    # 13. deepfm GPU vs CPU
    phase_deepfm_gpu_vs_cpu(fluid)

    # 14. the executor's step surface (remat, update fusion, NaN probe,
    # fetch handles)
    phase_step_surface(fluid, fa, fb)

    # 15. the training surface (schedules, optimizers, conditional_block,
    # auc, LeNet; ResNet-50 on LARS, Transformer-big on noam, BERT-base on
    # gradient-merged LAMB)
    phase_training_surface(fluid, fa, fas, fb, smi)

    # 16. the input pipeline and checkpoints (DeviceLoader, the drivers,
    # Checkpointer, reference-format serving, the PS prefetcher)
    phase_input_pipeline(fluid, fa, fsa, smi)

    # 17. the deferred-row log and the A6 paths (the space-to-depth
    # ResNet-50 stem, ResNet-50 serving, bucketed NMT, sequence/beam ops)
    phase_deferred_and_a6(fluid, fb, smi)

    # 18. inference and serving (int8, the InferenceServer, the fleet,
    # PS-backed CTR serving)
    launches["float32"] += phase_inference_serving(fluid, fa, smi)

    # 19. the PS tier over sockets, shard recovery, PS checkpoints,
    # online learning and serving from socket shards
    phase_ps_tier_and_streaming(fluid, fsa, smi)

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
    sys.exit(main())
