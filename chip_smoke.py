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
             both forms, the dropout keep rate and seed dependence; times
             each kernel, its plain version and one PyTorch library call.
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
             launches per step, GPU-vs-CPU agreement at dropout 0 and bf16
             against f32; prints the step time, device-busy share, top
             kernels and peak memory.
6. bn kernels — the fused batch-norm kernels (K1 stats, K2 apply, K3
             backward reduce + dx, K4 1x1-conv GEMM with the statistics of
             its stored output) against their plain versions, f32 and bf16,
             at ResNet-50 B=128 shapes; times each kernel, its plain version
             and one PyTorch library call where one computes the same
             function.
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
             and bf16, dropout 0 and 0.1; the kernels with an all-ones tile
             table bitwise equal to them with the computed one (dropout on);
             times each kernel, its plain version and F.scaled_dot_product_
             attention with the dense boolean mask, and the bound over the
             visible (i, j) pairs.
9. nmt     — main path 4: Transformer-big (d_model 1024, 16 heads, d_ff
             4096, 6+6 layers, vocab 32000, dropout 0.1) packed-sparse
             training, nmt.build_train_program(cfg, 256, 256, packed=True,
             attn="sparse") under mixed_precision.decorate(Adam(1e-4),
             "bfloat16") by Executor(CUDAPlace(0)) from seed 2024: 10 steps
             (2; 1 + 1 profiled; 6 timed) over 3 packed batches of B=16 rows
             in turn. Checks finite losses that start near ln 32000 and
             fall on a repeated batch, and 18 forward and 18 backward sparse
             launches a step; prints step time, non-pad target tokens/s,
             device busy share, device ms by kernel kind and peak memory.
             Then one f32 step at 2+2 layers (full width, B=4, T=128,
             dropout 0) on CUDAPlace(0) and CPUPlace() from the same
             weights: the loss within 1e-5, every gradient within 1e-4
             relative L2 (or twice the CPU's own one-ulp spread where that
             is larger); its sparse launches are the f32 kernels' count.
The last lines are the kernels' JSON record, the card's name and power
limit, and {"ok": true, "device": {...}}. Exits non-zero without a result
when torch sees no CUDA device or the port is not beside this script.
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
    """ms of device time per call of fn, summed over its kernels. A
    profiler session that reports no device event (seen once in a run) is
    repeated, up to three sessions."""
    for _ in range(3):
        per, _, _ = profile_device(fn)
        if per:
            break
    return sum(per.values()) / 1e3


def category(name):
    """The kind of a kernel, from its name."""
    n = name.lower()
    if "sparse_fwd" in n:
        return "flash sparse fwd (hand kernel)"
    if "sparse_dq" in n or "sparse_dkv" in n:
        return "flash sparse bwd (hand kernels)"
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


def bound(flops, nbytes, name):
    t_ops = flops / PEAK_FLOPS[name] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


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
            rec = {"dtype": name, "B": B, "nh": NH, "T": t, "d": D,
                   "max_abs_err_out": e_out, "max_abs_err_lse": e_lse,
                   "max_abs_err_dropout": max(e_dout, e_dlse),
                   "tol": tol, "ms": ms, "dropout_ms": drop_ms,
                   "launch_ms": launch_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "flops": flops, "bytes": nbytes,
                   "bound_ms": bound_ms, "bound_by": bound_by}
            log("kernel fwd " + json.dumps(rec))
            if not (ok_out and ok_lse and ok_dout and ok_dlse):
                raise AssertionError(f"flash_attention_fwd {name} T={t} "
                                     f"disagrees with its plain version: {rec}")
            records[(name, t)] = rec

        # edge cases at small shapes: causal, a per-q bias, ragged T, d=128
        for label, (b, nh, tq, d), causal, per_q in (
                ("causal", (2, 3, 200, 64), True, False),
                ("per_q_bias", (2, 3, 128, 64), False, True),
                ("ragged_T", (2, 2, 100, 64), False, False),
                ("d128_causal_ragged", (2, 2, 130, 128), True, True)):
            q, k, v = qkv_inputs(b, nh, tq, d, dtype, gen)
            bias = None
            if per_q:
                bias = torch.randn(b, nh, tq, tq, generator=gen,
                                   device="cuda").to(dtype)
            out, lse = fa.flash_attention_fwd(q, k, v, bias, causal)
            ref_out, ref_lse = fa.flash_attention_fwd_plain(q, k, v, bias,
                                                            causal)
            torch.cuda.synchronize()
            e_out, ok_out = max_err(out, ref_out, tol)
            e_lse, ok_lse = max_err(lse, ref_lse, tol)
            log(f"kernel fwd edge {name} {label} B={b} nh={nh} T={tq} d={d}: "
                f"max_abs_err out {e_out:.3e} lse {e_lse:.3e} (tol {tol})")
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
            rec = {"dtype": name, "B": B, "nh": NH, "T": t, "d": D,
                   "max_abs_err": errs, "ms": ms, "dropout_ms": drop_ms,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "flops": flops, "bytes": nbytes, "bound_ms": bound_ms,
                   "bound_by": bound_by}
            log("kernel bwd " + json.dumps(rec))
            records[(name, t)] = rec

        # edge cases: causal, per-q bias (dbias per query), ragged T with
        # the mask (column-sum dbias), d=128 causal ragged with dropout
        for label, (b, nh, tq, d), causal, kind, rate in (
                ("causal", (2, 3, 200, 64), True, None, 0.0),
                ("per_q_bias", (2, 3, 128, 64), False, "per_q", 0.0),
                ("ragged_T_mask", (2, 2, 100, 64), False, "col", 0.0),
                ("d128_causal_ragged", (2, 2, 130, 128), True, "per_q",
                 DROPOUT)):
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
            log(f"kernel bwd edge {name} {label} B={b} nh={nh} T={tq} d={d} "
                f"dropout={rate}: max_abs_err {json.dumps(e)}")
            if not ok:
                raise AssertionError(f"flash_attention_bwd {name} {label} "
                                     f"disagrees with its plain version")
    return records


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


def build_pretrain(fluid, bert, b, t, amp, layers=12, dropout=DROPOUT):
    cfg = bert.BertConfig(vocab_size=30522, hidden_size=HIDDEN,
                          num_layers=layers, num_heads=NH, ffn_size=3072,
                          max_position=512, hidden_dropout=dropout,
                          attn_dropout=dropout)

    def opt():
        o = fluid.optimizer.Adam(LR)
        if amp:
            o = fluid.contrib.mixed_precision.decorate(
                o, dtype="bfloat16", use_dynamic_loss_scaling=False)
        return o

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
            fa.flash_attention_fwd.launches = 0       # main path starts
            fa.flash_attention_bwd.launches = 0
            step_ms = []
            vals = []
            for _ in range(4):
                t0 = time.perf_counter()
                (lv,) = exe.run(main, feed=feed, fetch_list=[loss])
                step_ms.append((time.perf_counter() - t0) * 1e3)
                vals.append(float(lv))
            launches[("fwd", name)] = fa.flash_attention_fwd.launches
            launches[("bwd", name)] = fa.flash_attention_bwd.launches
            # main path ends
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


def phase_kernel_bn(fb):
    """Each fused-BN kernel against its plain version at ResNet-50 B=128
    shapes, f32 and bf16, with timings. Returns {(kernel, dtype): record}
    of the shape each kernel's JSON entry quotes."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator("cuda").manual_seed(3)
    records = {}
    B = RESNET_B
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        isz = torch.tensor([], dtype=dtype).element_size()
        peak = PEAK_FLOPS[name]

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
            torch.cuda.synchronize()
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
            rec = {"kernel": "fused_conv_stats", "dtype": name,
                   "shape": f"{label}: M={m} Ci={ci} Co={co}",
                   "max_err": errs, "max_abs_err": abs_errs, "ms": ms,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "library": "torch.matmul (GEMM alone)", "flops": flops, "bytes": nbytes,
                   "bound_ms": bound_ms, "bound_by": bound_by}
            log("kernel bn " + json.dumps(rec))
            if not ok:
                raise AssertionError(f"fused_conv_stats {name} {label} "
                                     f"disagrees with its plain version: "
                                     f"{errs}")
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
            if act == "":
                # the shortcut BN: no relu, no residual, so one PyTorch call
                # computes each function (inference batch_norm; cuDNN's
                # training backward)
                a4 = fb.from2d(y2, (B, co, hw // st, hw // st))
                ms, plain_ms, library_ms = (device_ms(fn) for fn in (
                    lambda: fb.apply2d(y2, mean, inv, scale, bias),
                    lambda: fb.apply_plain(y2, mean, inv * scale, bias),
                    lambda: F.batch_norm(a4, mean, var, scale, bias, False,
                                         0.0, 1e-5)))
                nbytes = 2 * m * co * isz + 3 * co * 4
                bound_ms, bound_by = bound(4.0 * m * co, nbytes, name)
                records[("fused_bn_apply", name)] = rec = {
                    "kernel": "fused_bn_apply", "dtype": name,
                    "shape": f"{label} BN: M={m} C={co}, no relu/res",
                    "max_err": {"apply": errs["apply"]},
                    "max_abs_err": {"apply": abs_errs["apply"]}, "ms": ms,
                    "plain_ms": plain_ms, "library_ms": library_ms,
                    "library": "F.batch_norm(training=False)",
                    "bytes": nbytes, "bound_ms": bound_ms,
                    "bound_by": bound_by}
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

                ms, plain_ms, library_ms = (device_ms(fn) for fn in (
                    k3, k3_plain,
                    lambda: torch.ops.aten.native_batch_norm_backward(
                        dy4, a4, scale, None, None, mean, inv, True, 1e-5,
                        [True, True, True])))
                nbytes = 3 * m * co * isz + 5 * co * 4
                bound_ms, bound_by = bound(10.0 * m * co, nbytes, name)
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
                    "bound_by": bound_by}
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
    return records


def resnet_program(fluid, resnet, b, hw, amp, classes=1000):
    """The JAX bench's ResNet-50 recipe (7x7 stem): resnet → softmax CE →
    mean → Momentum(0.1, 0.9), under bf16 AMP when `amp`. Built with
    PDTPU_CONV_BN_FUSION=pallas (36 fused_conv_bn ops)."""
    os.environ["PDTPU_CONV_BN_FUSION"] = "pallas"
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 2024
    with fluid.program_guard(main, startup):
        img = fluid.layers.data("img", [3, hw, hw])
        label = fluid.layers.data("label", [1], dtype="int64")
        logits = resnet.resnet(img, 50, classes)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        opt = fluid.optimizer.Momentum(0.1, 0.9)
        if amp:
            opt = fluid.contrib.mixed_precision.decorate(
                opt, dtype="bfloat16", use_dynamic_loss_scaling=False)
        opt.minimize(loss)
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


def phase_resnet(fluid, fb):
    """Main path 3: ResNet-50 training with both switches on, bf16 AMP at
    B=128 and f32 at B=32; then GPU against CPU. Returns the launches of
    each run."""
    os.environ["PDTPU_BN_MODE"] = "pallas"
    launches = {}
    launches["bfloat16"], _ = run_resnet(fluid, fb, RESNET_B, True,
                                         "bf16 AMP")
    launches["float32"], _ = run_resnet(fluid, fb, 32, False, "f32")

    # GPU against CPU: f32 at 64x64, B=16, where every fused-BN gate of
    # stages 1-2 and the stem passes, so each kernel launches on the card.
    # The gradients of a depth-50 net at random init are chaotic: on the
    # CPU alone, multiplying the input by (1 + 1e-7 * randn), about one
    # ulp, moves them by ~2 % (relative L2). So the card's gradients are
    # held to the CPU's within twice what that one-ulp change of the input
    # does to the CPU's own (median and worst over the parameters), and the
    # loss within 1e-5.
    from paddle_tpu_torch.models import resnet

    main, startup, loss = resnet_program(fluid, resnet, 16, 64, False)
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
    log(f"resnet GPU vs CPU (depth 50, 64x64, B=16, f32): loss "
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
    return launches

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
    0.1, with the bitwise skip check at 0.1 and exact zeros on the pad row.
    Returns (inputs for timing, {check: max abs err}, skip and fill
    statistics)."""
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
    dense boolean mask, and the bound over the visible pairs."""
    import torch
    import torch.nn.functional as F

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
            if q_seg.shape[1] == NMT_T:   # the main path's shapes: timed
                fwd, bwd = sparse_timing(fas, dt, inputs, stats)
                rec.update(fwd=fwd, bwd=bwd)
                if name == "encoder self":
                    for kname, r, keys in (("fwd", fwd, ("out", "lse")),
                                           ("bwd", bwd, ("dq", "dk", "dv"))):
                        e = max(x[key] for x in errs.values() for key in keys)
                        records[(kname, dt)] = dict(r, max_abs_err=e)
            log("kernel sparse " + json.dumps(rec))
    return records


def nmt_program(fluid, nmt, cfg, t, amp):
    """The JAX bench's NMT recipe: packed-sparse rows, Adam(1e-4), under
    bf16 AMP when `amp`."""
    def opt():
        o = fluid.optimizer.Adam(LR)
        if amp:
            o = fluid.contrib.mixed_precision.decorate(
                o, dtype="bfloat16", use_dynamic_loss_scaling=False)
        return o

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
            "bwd": fas.flash_attention_sparse_bwd.launches}


def reset_sparse_counts(fas):
    fas.flash_attention_sparse_fwd.launches = 0
    fas.flash_attention_sparse_bwd.launches = 0


def phase_nmt(fluid, fas):
    """Main path 4: Transformer-big packed-sparse bf16 AMP training, then
    one f32 step at 2+2 layers against the CPU. Returns the sparse launches
    per dtype."""
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

        for _ in range(2):
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
    if counts != {"fwd": NMT_PER_STEP * steps, "bwd": NMT_PER_STEP * steps}:
        raise AssertionError(f"nmt: sparse launches {counts} in {steps} "
                             f"steps, expected {NMT_PER_STEP} each a step")
    launches = {"bfloat16": counts}

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
    launches["float32"] = sparse_counts(fas)       # f32 path ends
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
        f"{json.dumps(launches['float32'])}")
    if launches["float32"] != {"fwd": 6, "bwd": 6}:
        raise AssertionError("the f32 step did not launch the sparse kernels "
                             "6 + 6 times")
    if loss_rel > 1e-5 or max(card) > limit:
        raise AssertionError("GPU and CPU NMT steps disagree")
    return launches



def main():
    import torch

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

    # 1. device
    cuda_device(0)  # TF32 off for the f32 comparisons
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

    # 3. kernel
    records = phase_kernel(fa)
    bwd_records = phase_kernel_bwd(fa)

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

    # 9. nmt (main path 4)
    nmt_launches = phase_nmt(fluid, fas)

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
                "library_ms": rec["library_ms"], "shape": rec["shape"]})
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
                "shape": f"encoder self B={NMT_B} nh={NMT_NH} T={NMT_T} "
                         f"d={D}"})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
