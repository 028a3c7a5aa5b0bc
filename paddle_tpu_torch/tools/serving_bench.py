"""Serving load generator: dynamic batching vs sequential Predictor calls
(counterpart of ``paddle_tpu.tools.serving_bench``).

Reference analog: the reference ecosystem benchmarked serving with an
external RPC load tool; here the generator is in-process (no network
noise): N concurrent single-row requests served through
`serving.InferenceServer` (one padded batch a bucket) against the same N
requests run one by one through the bare Predictor.

The model serves on the card (CUDA device 0) unless ``--device cpu`` (a
Config with ``disable_gpu()``, fleets with ``device="cpu"``) is given;
without a card and without ``--device cpu`` the Predictor raises.

Arrivals are Poisson (exponential inter-arrival gaps at --qps) over
--duration seconds, or a closed-loop burst of --requests when --qps is 0:
the open-loop mode measures latency under a target load, the closed-loop
mode measures peak throughput.

CLI::

    python -m paddle_tpu_torch.tools.serving_bench --requests 256 \
        --concurrency 32
    python -m paddle_tpu_torch.tools.serving_bench --qps 500 --duration 5 \
        --buckets 1,2,4,8,16,32 --batch-delay-ms 2
    python -m paddle_tpu_torch.tools.serving_bench --precision int8
    python -m paddle_tpu_torch.tools.serving_bench --models ads:2,feed:1 \
        --replicas 3 --slo-p99-ms 500
    python -m paddle_tpu_torch.tools.serving_bench --device cpu

Output: one throughput + latency-percentile row per mode, plus the
serving metrics report. Exit code 1 if batched throughput does not beat
sequential.

``--precision int8`` serves the post-training-quantized model: the
bench's own request rows double as the calibration stream
(Config.enable_int8), so the accuracy gate runs before any load is
generated — a model that fails calibration fails the bench.

``--models a:2,b:1`` switches to multi-tenant co-hosting: each
name:weight pair becomes a tenant on ONE ServingFleet (its own
registered model version, replica partition sized by weight), the load
mix draws each request's tenant proportional to weight, and the output
grows one latency row PER TENANT plus the router's ``tenant_stats``.
``--slo-p99-ms`` then gates per tenant — exit 2 if ANY tenant's p99
breaches (same exit-code contract as the single-model gate). Combine
with ``--precision int8`` and the fleet serves quantized replicas,
registered through the registry's int8 promotion gate with the
measured accuracy delta.

Telemetry sidecars: ``--metrics-out m.json`` dumps the unified
observability Registry snapshot (serving counters AND executor
cache-hit/compile-time metrics) and ``--trace-out t.json`` writes the
host tracer's chrome-trace of the run
(``python -m paddle_tpu_torch.tools.timeline t.json --summary`` to read
it).
In fleet runs (``--replicas > 1``) the sidecars widen to the whole
fleet: ``--metrics-out`` gains a ``bench/fleet_federated`` block (one
federated scrape across coordinator + every replica, with the derived
``autoscale/*`` signals) and ``--trace-out`` becomes the MERGED
cross-process timeline — per-replica traces clock-aligned against the
coordinator with client→server flow arrows (merge_fleet_traces).
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import threading
import time

from typing import List, Optional

import numpy as np

__all__ = ["build_predictor", "bench_sequential", "bench_served",
           "bench_fleet", "bench_tenants", "percentile_row", "main"]


def _make_config(model_dir: str, precision: Optional[str],
                 calib_feeds=None, device: str = "cuda"):
    """Config for `model_dir` at `precision` on `device` ("cuda" or
    "cpu"). int8 needs a calibration stream (`calib_feeds`); other
    precisions flow through enable_tpu so an unknown string raises here,
    before any load is generated."""
    from paddle_tpu_torch import inference

    cfg = inference.Config(model_dir)
    if device == "cpu":
        cfg.disable_gpu()
    if precision is None:
        return cfg
    if inference._resolve_precision(precision) == "int8":
        cfg.enable_int8(calib_feeds)
    else:
        cfg.enable_tpu(precision=precision)
    return cfg


def build_predictor(model_dir: Optional[str] = None, in_dim: int = 512,
                    hidden: int = 2048, classes: int = 16, layers: int = 2,
                    precision: Optional[str] = None, calib_feeds=None,
                    device: str = "cuda"):
    """Save an MLP inference model and return its Predictor on `device`.
    The default size (2x2048 hidden) is deliberately weight-heavy: per
    batch-1 call the device must re-read every weight, so batching has
    real economics to demonstrate (one weight read serves the whole
    bucket)."""
    import paddle_tpu_torch as fluid
    from paddle_tpu_torch import inference

    model_dir = model_dir or tempfile.mkdtemp(prefix="serving_bench_")
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [in_dim])
        h = x
        for _ in range(max(1, layers)):
            h = fluid.layers.fc(h, hidden, act="relu")
        out = fluid.layers.fc(h, classes, act="softmax")
    exe = fluid.Executor(fluid.CPUPlace() if device == "cpu"
                         else fluid.CUDAPlace(0))
    exe.run(startup)
    fluid.io.save_inference_model(model_dir, ["x"], [out], exe, main)
    return inference.create_predictor(
        _make_config(model_dir, precision, calib_feeds, device))


def _gen_rows(n: int, in_dim: int, seed: int = 0) -> List[np.ndarray]:
    rng = np.random.RandomState(seed)
    return [rng.rand(1, in_dim).astype(np.float32) for _ in range(n)]


def _poisson_gaps(n: int, qps: float, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed + 1).exponential(1.0 / qps, size=n)


def bench_sequential(predictor, rows: List[np.ndarray]) -> dict:
    """One blocking batch-1 Predictor call per request (the no-serving
    baseline: what a naive RPC handler per request would do)."""
    predictor.run_padded({"x": rows[0]}, 1)  # compile outside the clock
    lats = []
    t0 = time.monotonic()
    for r in rows:
        s = time.monotonic()
        predictor.run_padded({"x": r}, 1)
        lats.append((time.monotonic() - s) * 1e3)
    wall = time.monotonic() - t0
    return _summarize("sequential", len(rows), wall, lats)


def bench_served(predictor, rows: List[np.ndarray], concurrency: int = 32,
                 buckets=(1, 2, 4, 8, 16, 32), batch_delay_ms: float = 2.0,
                 qps: float = 0.0, seed: int = 0) -> dict:
    """Drive the InferenceServer: closed-loop (`qps`=0, `concurrency`
    submitter threads racing through the request list) or open-loop
    Poisson arrivals at `qps`. Latency is measured from scheduled arrival
    to completion, so open-loop numbers include queueing delay."""
    from paddle_tpu_torch import serving

    server = serving.InferenceServer(
        predictor, buckets=buckets, max_batch_delay_ms=batch_delay_ms,
        max_queue_size=max(len(rows), 1024))
    server.warmup(example_feed={"x": rows[0]})
    lats = [0.0] * len(rows)
    errors = [0]

    with server:
        t0 = time.monotonic()
        if qps > 0:
            gaps = _poisson_gaps(len(rows), qps, seed)
            arrivals = t0 + np.cumsum(gaps)
            futs = []
            for i, r in enumerate(rows):
                now = time.monotonic()
                if arrivals[i] > now:
                    time.sleep(arrivals[i] - now)
                futs.append((i, server.submit({"x": r})))
            for i, f in futs:
                try:
                    f.result()
                    lats[i] = (time.monotonic() - arrivals[i]) * 1e3
                except Exception:
                    errors[0] += 1
        else:
            it = iter(list(enumerate(rows)))
            lock = threading.Lock()

            def drive():
                while True:
                    with lock:
                        nxt = next(it, None)
                    if nxt is None:
                        return
                    i, r = nxt
                    s = time.monotonic()
                    try:
                        server.infer({"x": r})
                        lats[i] = (time.monotonic() - s) * 1e3
                    except Exception:
                        errors[0] += 1

            threads = [threading.Thread(target=drive)
                       for _ in range(max(1, concurrency))]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        wall = time.monotonic() - t0
    out = _summarize(f"served(c={concurrency})" if qps <= 0
                     else f"served(qps={qps:g})",
                     len(rows) - errors[0], wall,
                     [x for x in lats if x > 0])
    out["errors"] = errors[0]
    out["metrics"] = server.metrics.snapshot()
    return out


def bench_fleet(model_dir: str, rows: List[np.ndarray], replicas: int = 3,
                concurrency: int = 32, buckets=(1, 2, 4, 8, 16, 32),
                batch_delay_ms: float = 2.0, mode: str = "thread",
                env=None, collect_telemetry: bool = False,
                device: str = "cuda") -> dict:
    """Closed-loop drive of a ServingFleet: `concurrency` client threads
    racing the request list through the router (least-outstanding). The
    multi-replica analog of bench_served — same latency accounting, so
    the 1-vs-N rows compare directly.

    ``collect_telemetry`` additionally performs, before the fleet is
    torn down, (a) one federated metrics scrape across this process and
    every replica and (b) a per-process trace export — what
    ``--metrics-out``/``--trace-out`` write in fleet runs (the trace
    sidecar is then the MERGED timeline, clock-aligned, with flow
    arrows; see tools.timeline.merge_fleet_traces)."""
    from paddle_tpu_torch.serving import fleet as fleet_mod

    reg = fleet_mod.ModelRegistry()
    reg.register("bench-v1", model_dir)
    fl = fleet_mod.ServingFleet(
        reg, "bench-v1", replicas=replicas, mode=mode, buckets=buckets,
        env=env, device="cpu" if device == "cpu" else None,
        server_kwargs={"max_batch_delay_ms": batch_delay_ms,
                       "max_queue_size": max(len(rows), 1024)})
    lats = [0.0] * len(rows)
    errors = [0]
    with fl:
        t0 = time.monotonic()
        it = iter(list(enumerate(rows)))
        lock = threading.Lock()

        def drive():
            while True:
                with lock:
                    nxt = next(it, None)
                if nxt is None:
                    return
                i, r = nxt
                s = time.monotonic()
                try:
                    fl.infer({"x": r})
                    lats[i] = (time.monotonic() - s) * 1e3
                except Exception:
                    errors[0] += 1

        threads = [threading.Thread(target=drive)
                   for _ in range(max(1, concurrency))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.monotonic() - t0
        stats = fl.stats()
        federated, traces = None, None
        if collect_telemetry:
            federated, traces = _collect_fleet_telemetry(fl)
    out = _summarize(f"fleet(n={replicas},c={concurrency})",
                     len(rows) - errors[0], wall,
                     [x for x in lats if x > 0])
    out["errors"] = errors[0]
    out["replicas"] = replicas
    out["fleet"] = {"mode": stats["mode"],
                    "metrics": stats["router"]["metrics"]}
    if federated is not None:
        out["fleet"]["federated"] = federated
    if traces is not None:
        out["fleet"]["traces"] = traces
    return out


def bench_tenants(model_dir: str, specs: "dict[str, float]",
                  rows: List[np.ndarray], replicas: int = 0,
                  concurrency: int = 32, buckets=(1, 2, 4, 8, 16, 32),
                  batch_delay_ms: float = 2.0,
                  precision: Optional[str] = None, calib_feeds=None,
                  slo_p99_ms: Optional[float] = None,
                  seed: int = 0, device: str = "cuda") -> dict:
    """Multi-tenant co-hosting bench: every `specs` name:weight pair is
    registered as its own model version and co-hosted on ONE fleet whose
    replica pool is partitioned by weight. Mixed load — each request's
    tenant is drawn proportional to weight — then one latency summary
    PER TENANT (the isolation claim is per-tenant p99, not the blended
    number) plus the router's own tenant_stats.

    With ``precision='int8'`` the accuracy delta is measured once
    against `calib_feeds` and every tenant's version is registered
    through the registry's int8 promotion gate with that calibration
    metadata; replicas then build quantized predictors."""
    from paddle_tpu_torch.serving import fleet as fleet_mod

    total = max(replicas, len(specs))
    reg = fleet_mod.ModelRegistry()
    factory, reg_precision, meta = None, None, {}
    if precision is not None:
        from paddle_tpu_torch import inference

        if inference._resolve_precision(precision) == "int8":
            probe = inference.create_predictor(
                _make_config(model_dir, precision, calib_feeds, device))
            qm = probe.quant_meta
            reg_precision = "int8"
            meta = {"calibration": {
                "accuracy_delta": qm["accuracy_delta"],
                "accuracy_budget": qm["accuracy_budget"],
                "samples": qm["samples"]}}

        def factory(model):
            from paddle_tpu_torch.inference import create_predictor
            return create_predictor(
                _make_config(model.model_dir, precision, calib_feeds,
                             device))

    tenants = {}
    for name, weight in specs.items():
        reg.register(f"{name}-v1", model_dir, precision=reg_precision,
                     **meta)
        tenants[name] = {"version": f"{name}-v1", "weight": weight,
                         "slo_p99_ms": slo_p99_ms}
    fl = fleet_mod.ServingFleet(
        reg, replicas=total, buckets=buckets, predictor_factory=factory,
        device="cpu" if device == "cpu" else None,
        server_kwargs={"max_batch_delay_ms": batch_delay_ms,
                       "max_queue_size": max(len(rows), 1024)},
        tenants=tenants)

    names = list(specs)
    wsum = sum(specs.values())
    p = np.asarray([specs[n] / wsum for n in names])
    assign = np.random.RandomState(seed + 2).choice(
        len(names), size=len(rows), p=p)
    lats = [0.0] * len(rows)
    errors = {n: 0 for n in names}
    throttled = {n: 0 for n in names}
    elock = threading.Lock()

    with fl:
        t0 = time.monotonic()
        it = iter(list(enumerate(rows)))
        lock = threading.Lock()

        def drive():
            while True:
                with lock:
                    nxt = next(it, None)
                if nxt is None:
                    return
                i, r = nxt
                tenant = names[assign[i]]
                s = time.monotonic()
                try:
                    fl.infer({"x": r}, tenant=tenant)
                    lats[i] = (time.monotonic() - s) * 1e3
                except fleet_mod.TenantThrottledError:
                    with elock:
                        throttled[tenant] += 1
                except Exception:
                    with elock:
                        errors[tenant] += 1

        threads = [threading.Thread(target=drive)
                   for _ in range(max(1, concurrency))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.monotonic() - t0
        tstats = fl.tenant_stats()

    per_tenant = {}
    for j, name in enumerate(names):
        tl = [lats[i] for i in range(len(rows))
              if assign[i] == j and lats[i] > 0]
        row = _summarize(f"tenant:{name}(w={specs[name]:g})",
                         len(tl), wall, tl)
        row["errors"] = errors[name]
        row["throttled"] = throttled[name]
        row["router"] = tstats.get(name)
        per_tenant[name] = row
    ok = len(rows) - sum(errors.values()) - sum(throttled.values())
    out = _summarize(f"tenants(n={len(names)},r={total})", ok, wall,
                     [x for x in lats if x > 0])
    out["errors"] = sum(errors.values())
    out["throttled"] = sum(throttled.values())
    out["per_tenant"] = per_tenant
    out["precision"] = precision or "fp32"
    return out


def _collect_fleet_telemetry(fl):
    """(federated /fleet doc, [(name, chrome-trace), ...]) for a live
    fleet: coordinator + every replica, per-target failures recorded in
    the doc rather than raised."""
    from paddle_tpu_torch.observability import get_tracer
    from paddle_tpu_torch.observability.federate import (FederatedScraper,
                                                         ScrapeTarget)

    targets = [ScrapeTarget.local()]
    for r in fl.replicas:
        targets.append(ScrapeTarget.call(
            r.metrics, name=r.name, role=f"replica-{r.kind}"))
    doc = FederatedScraper(targets).scrape_once()
    traces = [("coordinator", get_tracer().export_chrome_trace())]
    for r in fl.replicas:
        # a thread replica's trace IS the coordinator trace; exporting
        # it again would duplicate every event on a second track
        if r.kind != "process":
            continue
        try:
            traces.append((r.name, r.trace_export()))
        except Exception:
            pass  # a dead replica has no trace to contribute
    return doc, traces


def _summarize(mode: str, n: int, wall: float, lats: List[float]) -> dict:
    arr = np.asarray(sorted(lats)) if lats else np.asarray([0.0])

    def pct(p):
        return float(arr[min(len(arr) - 1, int(round(p / 100.0 * (len(arr) - 1))))])

    return {"mode": mode, "requests": n, "wall_s": wall,
            "throughput_rps": n / wall if wall > 0 else float("inf"),
            "mean_ms": float(arr.mean()), "p50_ms": pct(50),
            "p95_ms": pct(95), "p99_ms": pct(99)}


def percentile_row(r: dict) -> str:
    return (f"{r['mode']:<18}{r['requests']:>6}{r['wall_s']:>9.3f}"
            f"{r['throughput_rps']:>12.1f}{r['mean_ms']:>10.2f}"
            f"{r['p50_ms']:>10.2f}{r['p95_ms']:>10.2f}{r['p99_ms']:>10.2f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=256,
                    help="closed-loop request count (ignored with --qps)")
    ap.add_argument("--qps", type=float, default=0.0,
                    help="open-loop Poisson arrival rate; 0 = closed loop")
    ap.add_argument("--duration", type=float, default=3.0,
                    help="open-loop duration in seconds (with --qps)")
    ap.add_argument("--concurrency", type=int, default=32)
    ap.add_argument("--buckets", default="1,2,4,8,16,32")
    ap.add_argument("--batch-delay-ms", type=float, default=2.0)
    ap.add_argument("--in-dim", type=int, default=512)
    ap.add_argument("--hidden", type=int, default=2048)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="serve on CUDA device 0 (default) or the CPU")
    ap.add_argument("--skip-sequential", action="store_true")
    ap.add_argument("--replicas", type=int, default=1,
                    help="also closed-loop a ServingFleet of N replicas "
                         "behind the router (1 = single-server only)")
    ap.add_argument("--fleet-mode", choices=("thread", "process"),
                    default="thread",
                    help="fleet replica isolation for --replicas")
    ap.add_argument("--precision", default=None,
                    help="serving precision (fp32/bf16/int8); int8 "
                         "calibrates on the bench's own request rows and "
                         "runs the accuracy gate before generating load")
    ap.add_argument("--models", default=None,
                    help="multi-tenant mode: 'a:2,b:1' name:weight pairs "
                         "co-hosted on one fleet (replica pool from "
                         "--replicas, partitioned by weight); reports "
                         "per-tenant p99 and gates --slo-p99-ms per "
                         "tenant")
    ap.add_argument("--slo-p99-ms", type=float, default=None,
                    help="p99 latency SLO gate: exit 2 if the headline "
                         "mode (fleet with --replicas > 1, else served) "
                         "exceeds it or saw any request error")
    ap.add_argument("--metrics-out", default=None,
                    help="dump the unified observability Registry "
                         "snapshot (serving + executor metrics) as JSON")
    ap.add_argument("--trace-out", default=None,
                    help="write the host tracer's chrome-trace JSON of "
                         "the run (load in Perfetto, or summarize with "
                         "tools.timeline --summary)")
    ap.add_argument("--introspect-port", type=int, default=None,
                    help="serve the live introspection plane on this "
                         "port for the duration of the run (0 = "
                         "ephemeral) and scrape /metrics + /healthz once "
                         "mid-run as a smoke check of the endpoints "
                         "under load")
    args = ap.parse_args(argv)
    tracer, was_on = None, None
    if args.trace_out:
        # the port's host tracer is off until asked for; the sidecar needs it
        from paddle_tpu_torch.observability import get_tracer

        tracer = get_tracer()
        was_on, tracer.enabled = tracer.enabled, True
    try:
        return _run(args)
    finally:
        if tracer is not None:
            tracer.enabled = was_on


def _run(args) -> int:

    buckets = tuple(int(b) for b in args.buckets.split(","))
    n = (args.requests if args.qps <= 0
         else max(1, int(args.qps * args.duration)))
    rows = _gen_rows(n, args.in_dim, args.seed)
    # int8 calibration reuses the head of the request stream — the
    # activation ranges the bench serves are the ranges it calibrated on
    calib = [{"x": r} for r in rows[:8]]
    model_dir = tempfile.mkdtemp(prefix="serving_bench_")
    pred = build_predictor(model_dir=model_dir, in_dim=args.in_dim,
                           hidden=args.hidden, layers=args.layers,
                           precision=args.precision, calib_feeds=calib,
                           device=args.device)
    if args.precision:
        qm = pred.quant_meta
        if qm is not None:
            print(f"int8 calibration: accuracy_delta="
                  f"{qm['accuracy_delta']:.6f} (budget "
                  f"{qm['accuracy_budget']:g}, {qm['samples']} samples)")

    header = (f"{'mode':<18}{'reqs':>6}{'wall_s':>9}{'rps':>12}"
              f"{'mean_ms':>10}{'p50_ms':>10}{'p95_ms':>10}{'p99_ms':>10}")
    print(header)
    seq = None
    if not args.skip_sequential:
        seq = bench_sequential(pred, rows)
        print(percentile_row(seq))
    scrape: dict = {}
    scraper = None
    if args.introspect_port is not None:
        from paddle_tpu_torch.observability import serve_introspection

        srv = serve_introspection(args.introspect_port)
        scraper = threading.Thread(
            target=_scrape_introspection, args=(srv.url, scrape),
            daemon=True)
        scraper.start()
    served = bench_served(pred, rows, concurrency=args.concurrency,
                          buckets=buckets, batch_delay_ms=args.batch_delay_ms,
                          qps=args.qps, seed=args.seed)
    if scraper is not None:
        scraper.join(timeout=10)
    print(percentile_row(served))
    flt = None
    ten = None
    if args.models:
        specs = {}
        for part in args.models.split(","):
            name, _, w = part.partition(":")
            specs[name.strip()] = float(w) if w.strip() else 1.0
        ten = bench_tenants(model_dir, specs, rows,
                            replicas=args.replicas,
                            concurrency=args.concurrency, buckets=buckets,
                            batch_delay_ms=args.batch_delay_ms,
                            precision=args.precision, calib_feeds=calib,
                            slo_p99_ms=args.slo_p99_ms, seed=args.seed,
                            device=args.device)
        print(percentile_row(ten))
        for trow in ten["per_tenant"].values():
            print(percentile_row(trow))
    if args.replicas > 1 and not args.models:
        flt = bench_fleet(model_dir, rows, replicas=args.replicas,
                          concurrency=args.concurrency, buckets=buckets,
                          batch_delay_ms=args.batch_delay_ms,
                          mode=args.fleet_mode,
                          collect_telemetry=bool(args.metrics_out
                                                 or args.trace_out),
                          device=args.device)
        print(percentile_row(flt))
    print()
    bs = served["metrics"].get("serving/batch_rows") or {}
    print(f"batches={served['metrics'].get('serving/batches', 0)} "
          f"mean_batch_rows={bs.get('mean') if bs else None} "
          f"padded_rows={served['metrics'].get('serving/padded_rows', 0)} "
          f"errors={served['errors']}")
    if args.metrics_out:
        from paddle_tpu_torch.observability import get_registry

        snap = get_registry().snapshot(deep=True)
        # the bench server is gone by now (its Metrics child is attached
        # to the registry by weakref), so overlay its final snapshot
        for k, v in served["metrics"].items():
            snap.setdefault(k, v)
        snap["bench/served"] = {k: v for k, v in served.items()
                                if k != "metrics"}
        if scrape:
            snap["bench/introspection"] = scrape
        if seq is not None:
            snap["bench/sequential"] = seq
        if flt is not None and flt["fleet"].get("federated"):
            # the whole fleet's series, per process, + autoscale signals
            snap["bench/fleet_federated"] = flt["fleet"]["federated"]
        if ten is not None:
            snap["bench/tenants"] = ten
        with open(args.metrics_out, "w") as f:
            json.dump(snap, f, indent=2, sort_keys=True)
        print(f"wrote registry snapshot to {args.metrics_out}")
    if args.trace_out:
        from paddle_tpu_torch.observability import get_tracer

        fleet_traces = (flt["fleet"].get("traces")
                        if flt is not None else None)
        if fleet_traces and len(fleet_traces) > 1:
            from paddle_tpu_torch.tools.timeline import merge_fleet_traces

            trace = merge_fleet_traces([t for _, t in fleet_traces],
                                       [n for n, _ in fleet_traces])
            with open(args.trace_out, "w") as f:
                json.dump(trace, f)
        else:
            trace = get_tracer().export_chrome_trace(args.trace_out)
        print(f"wrote {args.trace_out} "
              f"({len(trace['traceEvents'])} events) — load in "
              f"chrome://tracing or ui.perfetto.dev")
    if args.introspect_port is not None:
        ok = scrape and all("error" not in r for r in scrape.values())
        print(f"introspection scrape: {json.dumps(scrape)}")
        if not ok:
            print("FAIL: live /metrics + /healthz scrape failed under load")
            return 1
    if seq is not None:
        speedup = served["throughput_rps"] / max(seq["throughput_rps"], 1e-9)
        print(f"batched/sequential throughput: {speedup:.2f}x")
        if served["throughput_rps"] <= seq["throughput_rps"]:
            print("FAIL: dynamic batching did not beat sequential")
            return 1
    if args.slo_p99_ms is not None:
        if ten is not None:
            # tenancy mode gates PER TENANT: co-hosting only counts as
            # isolation if every tenant holds its own p99
            breaches = []
            for name, trow in ten["per_tenant"].items():
                bad = (trow["p99_ms"] > args.slo_p99_ms
                       or trow["errors"] > 0)
                print(f"SLO p99 <= {args.slo_p99_ms:g}ms tenant "
                      f"{name}: p99={trow['p99_ms']:.2f}ms "
                      f"errors={trow['errors']} "
                      f"throttled={trow['throttled']} "
                      f"-> {'FAIL' if bad else 'ok'}")
                if bad:
                    breaches.append(name)
            if breaches:
                return 2
            return 0
        head = flt if flt is not None else served
        breached = (head["p99_ms"] > args.slo_p99_ms
                    or head.get("errors", 0) > 0)
        print(f"SLO p99 <= {args.slo_p99_ms:g}ms on {head['mode']}: "
              f"p99={head['p99_ms']:.2f}ms errors={head.get('errors', 0)} "
              f"-> {'FAIL' if breached else 'ok'}")
        if breached:
            return 2
    return 0


def _scrape_introspection(url: str, out: dict, delay_s: float = 0.2) -> None:
    """One mid-run GET of /metrics and /healthz — proves the endpoints
    answer while the serve loop is under load (results land in `out`)."""
    import urllib.request

    time.sleep(delay_s)  # let the load generator reach steady state
    for ep in ("/metrics", "/healthz"):
        try:
            with urllib.request.urlopen(url + ep, timeout=5) as r:
                body = r.read()
            out[ep] = {"status": r.status, "bytes": len(body)}
        except Exception as e:
            out[ep] = {"error": f"{type(e).__name__}: {e}"[:160]}


if __name__ == "__main__":
    sys.exit(main())
