"""Per-op micro-benchmark harness (counterpart of
``paddle_tpu.tools.op_bench``).

Reference analog: ``paddle/fluid/operators/benchmark/op_tester.cc`` — a
config-driven runner that builds one op, feeds synthetic tensors, and
reports per-op latency (op_tester.cc:1; config format op_tester_config.cc).

The op executes through the same Program→Executor path as production (so
the measurement includes the op's lowering and the executor's dispatch),
on the card by default (``CUDAPlace(0)``; ``--device cpu`` / ``place=``
for the CPU), with the plan's first run timed apart as ``compile_ms`` so
steady-state latency is reported separately. On the card each timed call
ends in ``torch.cuda.synchronize()``.

`bench_dygraph_mlp` times a dygraph train step of a linear → layer_norm →
gelu MLP with the eager dispatch's prepared-op cache on and off
(``PDTPU_EAGER_JIT=0``), as interleaved 10-step segments.

Two A/B cells hold the hand kernels against what they replace, as
interleaved timed segments (`_interleaved_ab`):

- `bench_fused_conv_bn`: the fused 1×1-conv+BN(+relu) op
  (``fused_conv_bn_act``: K4 conv+stats, K2 apply, K3 backward) against
  its plain composition (``conv_bn_xla``), forward and forward+backward;
- `bench_block_sparse_attn`: block-sparse packed-segment attention (the
  sparse flash kernels) against the dense flash kernels with the same
  segments as an additive mask, forward and forward+backward.

Each cell also reports the largest absolute difference of each arm's
outputs from the plain version's (``max_abs_err``) beside the largest
magnitude of the plain output (``max_abs_ref``); given ``tol``, a forward
output is ``within_tol`` when every element obeys
``|got - want| <= tol + tol·|want|`` and a gradient when its largest
difference is at most ``tol`` times its largest magnitude. On the CPU every
arm runs the kernels' plain versions (parity, not speed).

CLI::

    python -m paddle_tpu_torch.tools.op_bench --op matmul \\
        --input X=256x256 --input Y=256x256 --repeat 200
    python -m paddle_tpu_torch.tools.op_bench --config bench_ops.json
    python -m paddle_tpu_torch.tools.op_bench --fused-conv-bn \\
        --block-sparse-attn
    python -m paddle_tpu_torch.tools.op_bench --dygraph [--device cpu]

Config file: a JSON list of {"op", "inputs": {slot: {"shape", "dtype"}},
"attrs", "outputs", "repeat"}. Output: one JSON line per config with
{op, mean_us, min_us, p50_us, compile_ms, repeat}.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
import zlib
from typing import Callable, Dict, List, Optional

import numpy as np


def _make_input(shape, dtype, seed=0):
    rng = np.random.RandomState(seed)
    if np.issubdtype(np.dtype(dtype), np.integer):
        return rng.randint(0, 8, size=shape).astype(dtype)
    return rng.rand(*shape).astype(dtype)


def _sync(device_type: str) -> None:
    if device_type == "cuda":
        import torch
        torch.cuda.synchronize()


def bench_op(op_type: str, inputs: Dict[str, Dict], attrs: Optional[dict] = None,
             outputs: Optional[Dict[str, int]] = None, repeat: int = 100,
             warmup: int = 2, place=None) -> dict:
    """Build a one-op program, execute through the real Executor, time it.

    inputs: slot -> {"shape": [..], "dtype": "float32"} (or a list of such
    for multi-value slots). outputs: slot -> count (default {"Out": 1}).
    place: the executor's place (default ``CUDAPlace(0)``).
    """
    import paddle_tpu_torch as fluid

    attrs = attrs or {}
    outputs = outputs or {"Out": 1}
    place = place if place is not None else fluid.CUDAPlace(0)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        block = main.global_block()
        in_map, feed = {}, {}
        for slot, specs in inputs.items():
            specs = specs if isinstance(specs, list) else [specs]
            names = []
            for i, sp in enumerate(specs):
                a = _make_input(sp["shape"], sp.get("dtype", "float32"),
                                seed=(zlib.crc32(slot.encode()) + i) % 2 ** 31)
                name = f"{slot.lower()}_{i}"
                block.create_var(name=name, shape=a.shape, dtype=str(a.dtype),
                                 is_data=True)
                feed[name] = a
                names.append(name)
            in_map[slot] = names
        out_map = {}
        for slot, n in outputs.items():
            out_map[slot] = [f"out_{slot.lower()}_{i}" for i in range(n)]
            for nm in out_map[slot]:
                block.create_var(name=nm, dtype="float32")
        block.append_op(op_type, in_map, out_map, attrs)
        fetch = [nm for slot in sorted(out_map) for nm in out_map[slot]]

        with fluid.scope_guard(fluid.Scope()):
            exe = fluid.Executor(place)
            dev = exe.device.type
            exe.run(startup)
            t0 = time.perf_counter()
            exe.run(main, feed=feed, fetch_list=fetch)
            compile_ms = (time.perf_counter() - t0) * 1e3
            for _ in range(warmup):
                exe.run(main, feed=feed, fetch_list=fetch)
            times = []
            for _ in range(repeat):
                t0 = time.perf_counter()
                exe.run(main, feed=feed, fetch_list=fetch,
                        return_numpy=False)
                _sync(dev)
                times.append(time.perf_counter() - t0)
    times = np.array(times) * 1e6
    return {"op": op_type,
            "mean_us": round(float(times.mean()), 2),
            "min_us": round(float(times.min()), 2),
            "p50_us": round(float(np.percentile(times, 50)), 2),
            "compile_ms": round(compile_ms, 2),
            "repeat": repeat}


def _parse_input_flag(s: str):
    # "X=256x256" or "X=256x256:int64"
    slot, rest = s.split("=", 1)
    parts = rest.split(":")
    shape = [int(d) for d in parts[0].split("x")]
    dtype = parts[1] if len(parts) > 1 else "float32"
    return slot, {"shape": shape, "dtype": dtype}


def _iqr(xs) -> float:
    qs = statistics.quantiles(xs, n=4) if len(xs) >= 2 else [0, 0, 0]
    return round(qs[2] - qs[0], 3)


def bench_dygraph_mlp(steps: int = 50, batch: int = 64, width: int = 256,
                      depth: int = 4, device: str = "cuda"):
    """Dygraph transformer-style MLP train-step micro-bench (the JAX
    package's, same defaults): linear → layer_norm → gelu blocks, a square
    loss, SGD. The eager dispatch's prepared-op cache (``ops/eager.py``,
    the PreparedOp analog, imperative/prepared_operator.h) against direct
    dispatch (``PDTPU_EAGER_JIT=0``), as INTERLEAVED 10-step segments with
    per-arm medians and IQRs (host dispatch time drifts over a run, so
    back-to-back A/B runs would compare the drift). Each segment ends in a
    host read of the loss. Returns {cached_ms, uncached_ms, speedup, ...}."""
    import os

    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import dygraph
    from paddle_tpu_torch.dygraph.tracer import trace_op

    rng = np.random.RandomState(0)
    X = rng.rand(batch, width).astype("float32")
    Y = rng.rand(batch, 1).astype("float32")
    seg = 10
    n_seg = max(2, steps // seg)
    place = fluid.CPUPlace() if device == "cpu" else fluid.CUDAPlace(0)

    old = os.environ.get("PDTPU_EAGER_JIT")
    try:
        with dygraph.guard(place, seed=7):
            layers_ = [dygraph.nn.Linear(width, width)
                       for _ in range(depth)] + [dygraph.nn.Linear(width, 1)]
            lns = [dygraph.nn.LayerNorm(width) for _ in range(depth)]
            opt = fluid.optimizer.SGD(0.01)
            xv = dygraph.to_variable(X)
            yv = dygraph.to_variable(Y)
            params = [q for ly in layers_ + lns for q in ly.parameters()]

            def step():
                h = xv
                for i, ly in enumerate(layers_[:-1]):
                    h = lns[i](ly(h))
                    h = trace_op("gelu", {"X": [h]}, {})["Out"][0]
                h = layers_[-1](h)
                diff = trace_op("elementwise_sub", {"X": [h], "Y": [yv]},
                                {"axis": -1})["Out"][0]
                sq = trace_op("square", {"X": [diff]}, {})["Out"][0]
                loss = trace_op("mean", {"X": [sq]}, {})["Out"][0]
                loss.backward()
                opt.minimize(loss, parameter_list=params)
                for ly in layers_ + lns:
                    ly.clear_gradients()
                return loss

            def segment(cached: bool):
                if cached:
                    os.environ.pop("PDTPU_EAGER_JIT", None)
                else:
                    os.environ["PDTPU_EAGER_JIT"] = "0"
                step()  # warm-up for this arm
                t0 = time.perf_counter()
                for _ in range(seg):
                    loss = step()
                loss.numpy()
                return (time.perf_counter() - t0) / seg * 1e3

            cached_t, uncached_t = [], []
            for _ in range(n_seg):
                cached_t.append(segment(True))
                uncached_t.append(segment(False))
    finally:
        if old is not None:
            os.environ["PDTPU_EAGER_JIT"] = old
        else:
            os.environ.pop("PDTPU_EAGER_JIT", None)
    cached = statistics.median(cached_t)
    uncached = statistics.median(uncached_t)
    return {"bench": "dygraph_mlp_step", "steps": steps, "device": device,
            "cached_ms": round(cached, 3), "uncached_ms": round(uncached, 3),
            "cached_iqr_ms": _iqr(cached_t),
            "uncached_iqr_ms": _iqr(uncached_t),
            "n_segments": n_seg,
            "speedup": round(uncached / cached, 2)}


def _interleaved_ab(arms: Dict[str, Callable], n_seg: int = 5,
                    seg_iters: int = 5, device_type: str = "cuda") -> dict:
    """Shared A/B protocol: every arm warmed (first-call builds off the
    clock), then INTERLEAVED timed segments with per-arm medians + IQR.
    On the card each segment ends in ``torch.cuda.synchronize()``."""
    for f in arms.values():
        f()
    _sync(device_type)

    def _seg(f):
        t0 = time.perf_counter()
        for _ in range(seg_iters):
            f()
        _sync(device_type)
        return (time.perf_counter() - t0) / seg_iters * 1e3

    times = {k: [] for k in arms}
    for _ in range(n_seg):
        for k, f in arms.items():
            times[k].append(_seg(f))
    return {k: {"median_ms": round(statistics.median(v), 3),
                "iqr_ms": _iqr(v), "n_segments": n_seg}
            for k, v in times.items()}


def _compare(errs: dict, refs: dict, within: dict, name, got, want,
             tol: Optional[float], elementwise: bool) -> None:
    """Record got against want under `name` (module docstring's rule)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    errs[name] = float(diff.max())
    refs[name] = float(w.abs().max())
    if tol is not None:
        within[name] = bool((diff <= tol + tol * w.abs()).all()) \
            if elementwise else errs[name] <= tol * refs[name]


def _grads(fn, args):
    """Gradients of sum(fn(*args)²) w.r.t. every arg."""
    import torch

    leaves = [a.detach().requires_grad_() for a in args]
    y = fn(*leaves)
    return torch.autograd.grad((y.float() ** 2).sum(), leaves)


def bench_fused_conv_bn(batch: int = 8, ci: int = 64, co: int = 256,
                        hw: int = 32, stride: int = 1, n_seg: int = 5,
                        dtype: str = "float32", device: str = "cuda",
                        tol: Optional[float] = None):
    """Standalone A/B cell for the fused 1×1-conv+BN+relu op (the K4, K2
    and K3 hand kernels) vs the plain composition it replaces
    (``conv_bn_xla``): fwd and fwd+bwd arms, interleaved segments."""
    import torch

    from ..ops.kernels import fused_bn

    dt = getattr(torch, dtype)
    rng = np.random.RandomState(0)

    def t(a):
        return torch.tensor(a, dtype=torch.float32).to(device=device,
                                                       dtype=dt)

    x = t(rng.randn(batch, ci, hw, hw)).contiguous(
        memory_format=torch.channels_last)
    w = t(rng.randn(co, ci, 1, 1) * 0.1)
    scale = torch.tensor(rng.rand(co) + 0.5, dtype=torch.float32,
                         device=device)
    bias = torch.tensor(rng.randn(co) * 0.1, dtype=torch.float32,
                        device=device)
    eps = 1e-5

    def fused(x, w, scale, bias):
        y, _, _ = fused_bn.fused_conv_bn_act(x, w, scale, bias, eps, "relu",
                                             stride, False, None)
        return y

    def plain(x, w, scale, bias):
        y, _, _ = fused_bn.conv_bn_xla(x, w, scale, bias, eps, "relu",
                                       stride, None)
        return y

    args = (x, w, scale, bias)
    res = _interleaved_ab({
        "kernel_fwd": lambda: fused(*args), "plain_fwd": lambda: plain(*args),
        "kernel_bwd": lambda: _grads(fused, args),
        "plain_bwd": lambda: _grads(plain, args),
    }, n_seg=n_seg, device_type=torch.device(device).type)
    errs, refs, within = {}, {}, {}
    with torch.no_grad():
        _compare(errs, refs, within, "fwd", fused(*args), plain(*args), tol,
                 True)
    for n, a, b in zip(("dx", "dw", "dscale", "dbias"),
                       _grads(fused, args), _grads(plain, args)):
        _compare(errs, refs, within, n, a, b, tol, False)
    return {"bench": "fused_conv_bn",
            "shape": [batch, ci, hw, hw], "co": co, "stride": stride,
            "dtype": dtype, "device": torch.device(device).type,
            "arms": res,
            "max_abs_err": {"fwd": errs.pop("fwd"), "bwd": errs},
            "max_abs_ref": refs,
            **({"within_tol": within, "tol": tol} if tol is not None
               else {}),
            "fwd_speedup": round(res["plain_fwd"]["median_ms"]
                                 / res["kernel_fwd"]["median_ms"], 2),
            "bwd_speedup": round(res["plain_bwd"]["median_ms"]
                                 / res["kernel_bwd"]["median_ms"], 2)}


def packed_segments(batch: int, t: int, avg_sent: int, rng) -> np.ndarray:
    """[batch, t] int32 segment rows (1-based, contiguous, 0 = pad tail),
    as the JAX package's cell draws them."""
    seg_np = np.zeros((batch, t), "int32")
    for b in range(batch):
        p, sid = 0, 1
        while p < t - 4:
            ln = min(int(rng.randint(avg_sent // 2, avg_sent * 2)), t - p)
            seg_np[b, p:p + ln] = sid
            p += ln
            sid += 1
            if rng.rand() < 0.3:  # leave a pad tail on some rows
                break
    return seg_np


def bench_block_sparse_attn(batch: int = 2, t: int = 512, hidden: int = 256,
                            num_heads: int = 4, avg_sent: int = 48,
                            n_seg: int = 5, dtype: str = "float32",
                            device: str = "cuda",
                            tol: Optional[float] = None):
    """Standalone A/B cell for block-sparse packed-segment attention vs the
    dense-additive-mask flash path on the same packed batch: fwd and
    fwd+bwd arms, interleaved segments. The dense arm pays every key tile;
    the sparse arm skips fully-masked ones, so the gap scales with
    pad/pack waste."""
    import torch

    from ..ops.kernels import flash_attention as fa
    from ..ops.kernels import flash_attention_sparse as fas

    dt = getattr(torch, dtype)
    rng = np.random.RandomState(0)

    def t_(a):
        return torch.tensor(a, dtype=torch.float32).to(device=device,
                                                       dtype=dt)

    q = t_(rng.randn(batch, t, hidden))
    k = t_(rng.randn(batch, t, hidden))
    v = t_(rng.randn(batch, t, hidden))
    seg_np = packed_segments(batch, t, avg_sent, rng)
    seg = torch.tensor(seg_np, device=device)
    same = (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] > 0)
    neg = torch.where(same, 0.0, -1e30).to(dt)[:, None]
    d = hidden // num_heads

    def sparse(q, k, v):
        return fas.flash_attention_packed_sparse(q, k, v, num_heads, seg,
                                                 seg)

    def heads(x):
        return x.reshape(batch, t, num_heads, d).transpose(1, 2)

    def dense(q, k, v):
        # the dense [B, 1, Tq, Tk] additive segment mask through the 4D
        # bias path: what the packed model fed before the descriptor
        o = fa.flash_attention(heads(q), heads(k), heads(v), bias=neg)
        return o.transpose(1, 2).reshape(batch, t, hidden)

    def plain(q, k, v):
        out, _ = fa.flash_attention_fwd_plain(heads(q), heads(k), heads(v),
                                              neg)
        return out.transpose(1, 2).reshape(batch, t, hidden)

    args = (q, k, v)
    res = _interleaved_ab({
        "sparse_fwd": lambda: sparse(*args), "dense_fwd": lambda: dense(*args),
        "sparse_bwd": lambda: _grads(sparse, args),
        "dense_bwd": lambda: _grads(dense, args),
    }, n_seg=n_seg, device_type=torch.device(device).type)
    # pad queries: the sparse kernels return 0, a fully masked dense row
    # averages every value; hold both to the plain version on real rows
    real = torch.tensor(seg_np > 0, device=device)[..., None]
    errs, refs, within = {}, {}, {}
    with torch.no_grad():
        ref = plain(*args) * real
        for name, fn in (("sparse_fwd", sparse), ("dense_fwd", dense)):
            _compare(errs, refs, within, name, fn(*args) * real, ref, tol,
                     True)
    for n, a, b in zip(("dq", "dk", "dv"),
                       _grads(lambda *x: sparse(*x) * real, args),
                       _grads(lambda *x: dense(*x) * real, args)):
        _compare(errs, refs, within, f"sparse_vs_dense_{n}", a, b, tol,
                 False)
    fill = float((seg_np > 0).mean())
    return {"bench": "block_sparse_attn",
            "shape": [batch, t, hidden], "num_heads": num_heads,
            "dtype": dtype, "device": torch.device(device).type,
            "fill_rate": round(fill, 4),
            "arms": res,
            "max_abs_err": errs,
            "max_abs_ref": refs,
            **({"within_tol": within, "tol": tol} if tol is not None
               else {}),
            "fwd_speedup": round(res["dense_fwd"]["median_ms"]
                                 / res["sparse_fwd"]["median_ms"], 2),
            "bwd_speedup": round(res["dense_bwd"]["median_ms"]
                                 / res["sparse_bwd"]["median_ms"], 2)}


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dygraph", action="store_true",
                    help="run the dygraph MLP step bench (the eager "
                         "prepared-op cache on vs off)")
    ap.add_argument("--fused-conv-bn", action="store_true",
                    help="A/B the fused conv+BN hand kernels vs their plain "
                         "composition")
    ap.add_argument("--block-sparse-attn", action="store_true",
                    help="A/B block-sparse packed-segment attention vs the "
                         "dense-mask flash path")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--op")
    ap.add_argument("--input", action="append", default=[],
                    help="SLOT=shape[:dtype], e.g. X=256x256:float32")
    ap.add_argument("--attrs", default="{}", help="JSON attr dict")
    ap.add_argument("--out", action="append", default=[],
                    help="output slot[:count], default Out:1")
    ap.add_argument("--repeat", type=int, default=100)
    ap.add_argument("--config", help="JSON list of bench specs")
    args = ap.parse_args(argv)

    specs = []
    if args.config:
        with open(args.config) as f:
            specs = json.load(f)
    if args.op:
        inputs = {}
        for s in args.input:
            slot, sp = _parse_input_flag(s)
            inputs.setdefault(slot, []).append(sp)
        outputs = {}
        for o in args.out:
            slot, _, n = o.partition(":")
            outputs[slot] = int(n or 1)
        specs.append({"op": args.op, "inputs": inputs,
                      "attrs": json.loads(args.attrs),
                      "outputs": outputs or None, "repeat": args.repeat})
    ran_cell = False
    if args.dygraph:
        print(json.dumps(bench_dygraph_mlp(device=args.device)))
        ran_cell = True
    if args.fused_conv_bn:
        print(json.dumps(bench_fused_conv_bn(device=args.device)))
        ran_cell = True
    if args.block_sparse_attn:
        print(json.dumps(bench_block_sparse_attn(device=args.device)))
        ran_cell = True
    if ran_cell and not specs:
        return
    if not specs:
        ap.error("need --op or --config")

    place = None
    if args.device == "cpu":
        import paddle_tpu_torch as fluid
        place = fluid.CPUPlace()
    for sp in specs:
        res = bench_op(sp["op"], sp["inputs"], sp.get("attrs"),
                       sp.get("outputs"), sp.get("repeat", 100), place=place)
        print(json.dumps(res))


if __name__ == "__main__":
    main()
