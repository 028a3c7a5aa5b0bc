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


def profile_device(fn, iters=10):
    """Device time by kernel name over `iters` calls of fn, from
    torch.profiler: ({name: us per call}, wall us per call, device
    events per call)."""
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
    return per, wall, events / iters


def device_ms(fn):
    """ms of device time per call of fn, summed over its kernels."""
    per, _, _ = profile_device(fn)
    return sum(per.values()) / 1e3


def category(name):
    """The kind of a kernel, from its name."""
    n = name.lower()
    if "flash_fwd" in n:
        return "flash fwd (hand kernel)"
    if "flash_bwd" in n:
        return "flash bwd (hand kernels)"
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

    per, wall_us, events = profile_device(fn, iters=iters)
    busy = sum(per.values())
    ranked = sorted(per.items(), key=lambda kv: -kv[1])
    cats = {}
    for name, us in per.items():
        cats[category(name)] = cats.get(category(name), 0.0) + us / 1e3
    return {"call": label, "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / wall_us if wall_us else None,
            "device_events": events,
            "peak_memory_MiB": torch.cuda.max_memory_allocated() / 2**20,
            "by_category_ms": dict(sorted(cats.items(),
                                          key=lambda kv: -kv[1])),
            "top_kernels_ms": [[k[:90], us / 1e3] for k, us in ranked[:10]],
            "top_other_kernels_ms": [[k[:90], us / 1e3] for k, us in ranked
                                     if category(k) == "other"][:5]}


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
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
