"""paddle_tpu_torch.serving — dynamic-batching inference serving (the
port of ``paddle_tpu.serving``).

Reference analog: the reference framework's serving story was
AnalysisPredictor clones with shared weights behind an RPC pool, each
clone running requests one-by-one through NaiveExecutor
(analysis_predictor.cc:479 clone path). On a GPU as on a TPU, a batch-8
matmul costs barely more than a batch-1 one, so concurrent requests are
cheapest when MERGED: the serving tier is a batching scheduler in front of
one Predictor:

- `DynamicBatcher` (batcher.py) — groups queued requests by feed
  signature, pads each group to a small fixed set of batch buckets
  (default 1/2/4/8/16/32), dispatches one Predictor call per bucket, and
  slices results back per request.
- `InferenceServer` (server.py) — threaded front end: bounded queue with
  reject-on-full backpressure, `max_batch_delay_ms` straggler window,
  per-request deadlines, graceful drain on stop().
- `warmup` (warmup.py) — runs every (signature x bucket) once ahead of
  serving, so no user request pays the first call's one-time costs
  (cuBLAS handles, the kernel libraries' load, the allocator's growth).
- `Metrics` (metrics.py) — per-server registry of lock-protected
  counters/histograms (requests, batch-size distribution, queue depth,
  latency percentiles, timeouts, rejections) with a `snapshot()` dict
  and text `report()`. Built on `observability.Registry` and attached to
  the process-wide registry, so `InferenceServer.stats()` (or
  `observability.get_registry().snapshot()`) shows serving latency next
  to the executor's metrics in one export.

Minimal end-to-end::

    from paddle_tpu_torch import inference, serving

    pred = inference.create_predictor(inference.Config(model_dir))
    server = serving.InferenceServer(pred, buckets=(1, 2, 4, 8, 16, 32),
                                     max_batch_delay_ms=2.0,
                                     max_queue_size=256)
    server.warmup()                       # every bucket once, up front
    with server:                          # start(); stop() drains on exit
        out, = server.infer({"x": batch_of_rows})
    print(server.metrics.report())
"""
from .batcher import (DEFAULT_BUCKETS, DynamicBatcher, ServingError,  # noqa: F401
                      bucket_for, item_signature)
from .metrics import Counter, Gauge, Histogram, Metrics  # noqa: F401
from .server import (InferenceServer, QueueFullError, Request,  # noqa: F401
                     ServerClosedError)
from .warmup import warmup  # noqa: F401

__all__ = [
    "DEFAULT_BUCKETS", "DynamicBatcher", "ServingError", "bucket_for",
    "item_signature", "Counter", "Gauge", "Histogram", "Metrics",
    "InferenceServer", "QueueFullError", "Request", "ServerClosedError",
    "fleet", "warmup",
]


def __getattr__(name):
    # lazy subpackage: `serving.fleet` without paying its import (and the
    # ps transport import underneath) on every `import paddle_tpu_torch`
    if name == "fleet":
        import importlib
        mod = importlib.import_module(".fleet", __name__)
        globals()["fleet"] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
