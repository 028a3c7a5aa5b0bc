"""Dynamic batcher: group requests by feed signature, pad to buckets.

Reference analog: the reference framework served concurrent users with
AnalysisPredictor *clones* — one predictor per worker thread, each running
batch-as-submitted through NaiveExecutor. A batch-32 matmul costs barely
more than batch-1, so the win is to MERGE concurrent requests into one
padded dispatch instead of running them on parallel clones.

The padding economics: serving traffic is ragged (any row count per
request), so totals are padded up to a small fixed set of bucket sizes
(default powers of two, 1..32): at most len(buckets) shapes per feed
signature, each of which `warmup.warmup()` runs once before the first real
request. Pad waste is bounded by ~2x worst case (power-of-two buckets) and
measured (`serving/padded_rows` counter), not guessed.
"""
from __future__ import annotations

import numpy as np

from typing import Dict, List, Optional, Sequence, Tuple

from .. import profiler
from .metrics import Metrics

__all__ = ["DEFAULT_BUCKETS", "DynamicBatcher", "ServingError",
           "bucket_for", "item_signature"]

DEFAULT_BUCKETS: Tuple[int, ...] = (1, 2, 4, 8, 16, 32)


class ServingError(RuntimeError):
    """Base class for serving-side failures."""


def bucket_for(n: int, buckets: Sequence[int]) -> Optional[int]:
    """Smallest bucket >= n, or None if n exceeds the largest bucket."""
    for b in buckets:
        if n <= b:
            return b
    return None


def item_signature(feed: Dict[str, np.ndarray]) -> tuple:
    """Per-ROW feed signature: (name, shape-without-batch-dim, dtype).

    Two requests batch together iff their item signatures match — then
    padding the concatenated rows to a bucket lands on exactly the
    signature `core.executor.feed_signature` computes for the padded feed
    (same keying, batch dim aside)."""
    return tuple(sorted(
        (str(k), tuple(np.asarray(v).shape[1:]), str(np.asarray(v).dtype))
        for k, v in feed.items()))


class _Slot:
    """One request's rows inside an assembled batch."""

    __slots__ = ("request", "offset")

    def __init__(self, request, offset: int):
        self.request = request
        self.offset = offset


class DynamicBatcher:
    """Assemble same-signature requests into padded Predictor dispatches.

    Stateless between calls (the queueing lives in `server.InferenceServer`);
    `dispatch` takes a list of requests that already share an item
    signature, concatenates their rows, runs them through the predictor in
    bucket-padded chunks, and fulfils each request's future with its own
    row slice of every output.
    """

    def __init__(self, predictor, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 metrics: Optional[Metrics] = None):
        buckets = sorted(set(int(b) for b in buckets))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints; got {buckets}")
        self.predictor = predictor
        self.buckets = tuple(buckets)
        self.max_bucket = buckets[-1]
        self.metrics = metrics if metrics is not None else Metrics()

    # -- batch assembly ----------------------------------------------------
    def dispatch(self, requests: List) -> None:
        """Run `requests` (same item signature, each with .feed/.n/.future)
        and fulfil their futures. Never raises on predictor failure — the
        error is delivered through every affected future instead, so one
        bad batch cannot kill the serve loop."""
        reqs = [r for r in requests if not r.future.done()]
        if not reqs:
            return
        try:
            outs = self._run(reqs)
        except Exception as e:  # deliver, don't crash the worker
            self.metrics.counter("serving/errors").inc()
            from ..observability.flight import (get_flight_recorder,
                                                is_oom)
            if is_oom(e):
                # a device OOM answered through futures leaves no trace
                # otherwise — capture the post-mortem before delivering
                get_flight_recorder().record_failure(e, context={
                    "where": "DynamicBatcher.dispatch",
                    "requests": len(reqs),
                    "rows": sum(r.n for r in reqs)})
            for r in reqs:
                if not r.future.done():
                    r.future.set_exception(e)
            return
        off = 0
        for r in reqs:
            res = [o[off:off + r.n] for o in outs]
            off += r.n
            if not r.future.done():
                r.future.set_result(res)

    def _run(self, reqs: List) -> List[np.ndarray]:
        names = sorted(reqs[0].feed)
        total = sum(r.n for r in reqs)
        concat = {k: (np.concatenate([np.asarray(r.feed[k]) for r in reqs])
                      if len(reqs) > 1 else np.asarray(reqs[0].feed[k]))
                  for k in names}
        m = self.metrics
        m.counter("serving/batches").inc()
        m.histogram("serving/batch_rows").observe(total)
        parts: List[List[np.ndarray]] = []
        off = 0
        # a total beyond the largest bucket runs as a chain of full-bucket
        # chunks plus one padded remainder — no signature ever escapes the
        # bucket set
        while off < total:
            take = min(total - off, self.max_bucket)
            bucket = bucket_for(take, self.buckets)
            chunk = {k: v[off:off + take] for k, v in concat.items()}
            m.counter("serving/padded_rows").inc(bucket - take)
            m.histogram("serving/bucket").observe(bucket)
            # the annotation shows up in torch.profiler traces AND as a
            # host span in the observability tracer's chrome-trace export:
            # per-bucket serving cost is visible in the same tooling as
            # training steps (profiler.record_event routes to both)
            with profiler.record_event(f"serving/dispatch_b{bucket}",
                                       rows=take, bucket=bucket):
                out = self.predictor.run_padded(chunk, bucket)
            for o in out:
                if not (getattr(o, "ndim", 0) and o.shape[0] == take):
                    raise ServingError(
                        f"serving requires batch-major outputs; fetch "
                        f"shape {getattr(o, 'shape', None)} has no leading "
                        f"batch dim of {take}")
            parts.append(out)
            off += take
        if len(parts) == 1:
            return parts[0]
        return [np.concatenate([p[i] for p in parts])
                for i in range(len(parts[0]))]
