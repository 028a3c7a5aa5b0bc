"""Threaded inference server: bounded queue + dynamic batching + deadlines.

Reference analog: a reference-framework serving deployment ran an RPC
front end over a pool of AnalysisPredictor clones (shared weights, one
NaiveExecutor loop each). Here the front end is in-process: callers
`submit()` feeds from any thread, a serve worker drains the queue,
merges same-signature requests up to the largest batch bucket (waiting
at most `max_batch_delay_ms` for stragglers), and one padded predictor
call serves the whole group (`batcher.DynamicBatcher`). Serve workers are
threads; the Predictor sets inference mode and its device inside each
call, so a worker thread needs no setup of its own.

Overload behavior is explicit, not emergent: the queue is bounded and
`submit()` raises `QueueFullError` immediately when it is full
(reject-with-error backpressure — a serving tier should shed load at
admission, not time out deep in the queue); each request can carry a
deadline after which it is answered with `TimeoutError` instead of
occupying a batch slot; `stop()` refuses new work and drains what was
already admitted.
"""
from __future__ import annotations

import os
import threading
import time

from collections import deque
from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

import numpy as np

from .batcher import (DEFAULT_BUCKETS, DynamicBatcher, ServingError,
                      item_signature)
from .metrics import Metrics
from ..observability import context as _trace_ctx
from ..observability.http import (maybe_serve_from_env,
                                  register_health_check,
                                  unregister_health_check)
from ..observability.tracer import trace_span

__all__ = ["InferenceServer", "QueueFullError", "Request", "ServerClosedError",
           "ServingError"]

# distinguishes health-check names when several servers live in one
# process ("serving/queue", then "serving#2/queue", ...)
_server_seq_lock = threading.Lock()
_server_seq = [0]


class QueueFullError(ServingError):
    """Backpressure: the bounded request queue is at max_queue_size."""


class ServerClosedError(ServingError):
    """submit() after stop()."""


class Request:
    """One admitted inference request: `feed` arrays all carry a leading
    batch dim of `n` rows; `future` resolves to the per-request output
    slices (list of np arrays, one per fetch)."""

    __slots__ = ("feed", "n", "sig", "future", "deadline", "enqueued_at",
                 "ctx")

    def __init__(self, feed: Dict[str, np.ndarray], n: int, sig: tuple,
                 deadline: Optional[float], enqueued_at: float,
                 ctx=None):
        self.feed = feed
        self.n = n
        self.sig = sig
        self.future: Future = Future()
        self.deadline = deadline
        self.enqueued_at = enqueued_at
        # trace context captured at submit() so the dispatch (and any PS
        # pulls under it) joins the submitter's distributed trace
        self.ctx = ctx

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now >= self.deadline


class InferenceServer:
    """Dynamic-batching serve loop over a Predictor.

    Usage::

        server = serving.InferenceServer(predictor, buckets=(1, 2, 4, 8),
                                         max_batch_delay_ms=2.0)
        server.warmup(example_feed={"x": np.zeros((1, 8), np.float32)})
        server.start()
        out, = server.infer({"x": x_row})          # blocking convenience
        fut = server.submit({"x": x_row})          # or async
        server.stop()                              # drains, then joins

    `num_workers` > 1 runs several serve workers over predictor clones
    (shared weights — the reference's clone optimization); useful when
    per-dispatch host work (padding, slicing, the eager op loop) limits
    throughput.
    """

    def __init__(self, predictor, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_batch_delay_ms: float = 2.0, max_queue_size: int = 256,
                 default_timeout_ms: Optional[float] = None,
                 num_workers: int = 1, metrics: Optional[Metrics] = None):
        if max_queue_size < 1:
            raise ValueError("max_queue_size must be >= 1")
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        self.metrics = metrics if metrics is not None else Metrics()
        self._predictor = predictor
        self._batchers = [DynamicBatcher(predictor, buckets, self.metrics)]
        for _ in range(num_workers - 1):
            self._batchers.append(
                DynamicBatcher(predictor.clone(), buckets, self.metrics))
        self.buckets = self._batchers[0].buckets
        self.max_batch_delay = max(0.0, float(max_batch_delay_ms)) / 1e3
        self.max_queue_size = int(max_queue_size)
        self.default_timeout = (None if default_timeout_ms is None
                                else float(default_timeout_ms) / 1e3)
        self._queue: deque = deque()
        self._cond = threading.Condition()
        self._workers: List[threading.Thread] = []
        self._started = False
        self._closed = False
        self._draining = False
        self._inflight: set = set()   # popped from queue, future unresolved
        self._stop_lock = threading.Lock()
        self._stop_report: Optional[dict] = None
        self._health_names: List[str] = []
        self._health_fns = [("queue", self._check_queue),
                            ("deadlines", self._check_deadlines),
                            ("workers", self._check_workers)]

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "InferenceServer":
        with self._cond:
            if self._closed:
                raise ServerClosedError("server already stopped")
            if self._started:
                return self
            self._started = True
        for i in range(len(self._batchers)):
            t = threading.Thread(target=self._serve_loop,
                                 args=(self._batchers[i],),
                                 name=f"paddle_tpu_torch-serve-{i}", daemon=True)
            self._workers.append(t)
            t.start()
        # k8s-probe readiness: queue/deadline/worker checks on /healthz,
        # and PDTPU_INTROSPECT_PORT alone brings the endpoints up
        self._register_health_checks()
        maybe_serve_from_env()
        return self

    def stop(self, drain: bool = True,
             grace_ms: Optional[float] = None) -> dict:
        """Refuse new submissions; with drain=True (default) every already
        admitted request is still served before the workers exit, with
        drain=False pending requests are failed with ServerClosedError.

        `grace_ms` (default `PDTPU_SERVE_DRAIN_GRACE_MS`, 0) keeps the
        queue OPEN for that long while `/healthz` already reports the
        degraded `draining` state — a router polling health stops sending
        new work before admission actually closes, so a cooperative fleet
        drains without a single rejected submit.

        Returns the drain report for the requests that were in flight
        (admitted but unresolved) at stop time:
        ``{"pending": n, "completed": served_ok, "rejected": failed}``.
        Idempotent — a second stop() returns the first report.
        """
        with self._stop_lock:
            if self._stop_report is not None:
                return dict(self._stop_report)
            with self._cond:
                self._draining = True
                self._cond.notify_all()
            if grace_ms is None:
                grace_ms = float(
                    os.environ.get("PDTPU_SERVE_DRAIN_GRACE_MS", "0"))
            if grace_ms > 0:
                time.sleep(grace_ms / 1e3)
            with self._cond:
                self._closed = True
                pending = list(self._queue) + list(self._inflight)
                # a never-started server has no workers to drain the queue
                if not drain or not self._started:
                    while self._queue:
                        r = self._queue.popleft()
                        if not r.future.done():
                            r.future.set_exception(ServerClosedError(
                                "server stopped without drain"))
                self.metrics.gauge("serving/queue_depth").set(len(self._queue))
                self._cond.notify_all()
            for t in self._workers:
                t.join()
            self._workers = []
            completed = sum(1 for r in pending
                            if r.future.done() and r.future.exception() is None)
            report = {"pending": len(pending), "completed": completed,
                      "rejected": len(pending) - completed}
            with self._cond:
                self._draining = False
                self._stop_report = report
            for name in self._health_names:
                unregister_health_check(name)
            self._health_names = []
            return dict(report)

    @property
    def state(self) -> str:
        """'idle' | 'serving' | 'draining' | 'stopped' — routers key on
        'draining' to stop sending new work before the queue closes."""
        with self._cond:
            if self._stop_report is not None:
                return "stopped"
            if self._draining:
                return "draining"
            if self._closed:
                return "stopped"
            return "serving" if self._started else "idle"

    # -- health checks (served at /healthz) --------------------------------
    def _check_queue(self):
        with self._cond:
            depth, cap = len(self._queue), self.max_queue_size
        if depth >= cap:
            return ("degraded",
                    f"queue full ({depth}/{cap}) — shedding load")
        if depth >= 0.8 * cap:
            return ("degraded", f"queue {depth}/{cap} (>= 80% full)")
        return ("ok", f"queue {depth}/{cap}")

    def _check_deadlines(self):
        req = self.metrics.counter("serving/requests").value
        missed = self.metrics.counter("serving/timeouts").value
        rate = missed / req if req else 0.0
        detail = f"{missed}/{req} requests missed their deadline"
        if rate > 0.5:
            return ("failing", detail)
        if rate > 0.05:
            return ("degraded", detail)
        return ("ok", detail)

    def _check_workers(self):
        with self._cond:
            started, closed, draining = (self._started, self._closed,
                                         self._draining)
        workers = list(self._workers)
        if draining:
            # degraded, not failing: admitted work is still being served —
            # a router should deprioritize, not declare the replica dead
            return ("degraded",
                    "draining — serving admitted requests, "
                    + ("admission closing soon" if not closed
                       else "admission closed"))
        if closed:
            return ("degraded", "server stopped")
        if not started:
            return ("degraded", "server not started")
        dead = sum(1 for t in workers if not t.is_alive())
        if dead:
            return ("failing",
                    f"{dead}/{len(workers)} serve workers dead — "
                    f"dispatch is stalled")
        return ("ok", f"{len(workers)} serve workers alive")

    def _register_health_checks(self) -> None:
        with _server_seq_lock:
            _server_seq[0] += 1
            seq = _server_seq[0]
        prefix = "serving" if seq == 1 else f"serving#{seq}"
        for short, fn in self._health_fns:
            name = f"{prefix}/{short}"
            register_health_check(name, fn)
            self._health_names.append(name)

    def health(self) -> dict:
        """This server's own /healthz view (no global registry involved):
        ``{"status": worst, "state": ..., "checks": {name: {status,
        detail}}}`` — what a fleet router polls per replica."""
        order = {"ok": 0, "degraded": 1, "failing": 2}
        checks = {}
        worst = "ok"
        for short, fn in self._health_fns:
            try:
                status, detail = fn()
            except Exception as e:  # a broken check is itself a failure
                status, detail = "failing", f"check raised: {e!r}"
            checks[short] = {"status": status, "detail": detail}
            if order.get(status, 2) > order[worst]:
                worst = status
        return {"status": worst, "state": self.state, "checks": checks}

    def __enter__(self) -> "InferenceServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def stats(self) -> dict:
        """Unified runtime snapshot: this server's serving metrics merged
        with the process-wide observability registry — executor plan-cache
        hits/misses, queue depth, and latency percentiles in ONE dict (the
        server's
        `Metrics` attaches itself to `observability.get_registry()` at
        construction). For only this server's metrics use
        ``server.metrics.snapshot()``."""
        from ..observability import get_registry

        snap = get_registry().snapshot(deep=True)
        # a detached Metrics (Metrics(attach=False)) must still show up
        # in its own server's stats
        for k, v in self.metrics.snapshot().items():
            snap.setdefault(k, v)
        return snap

    def warmup(self, example_feed: Optional[Dict[str, np.ndarray]] = None):
        """Run every (signature x bucket) once before serving (see
        serving.warmup.warmup)."""
        from .warmup import warmup as _warmup
        reports = [_warmup(b.predictor, self.buckets, example_feed)
                   for b in self._batchers]
        return reports[0] if len(reports) == 1 else reports

    # -- admission ---------------------------------------------------------
    def submit(self, feed: Dict[str, np.ndarray],
               timeout_ms: Optional[float] = None) -> Future:
        """Admit one request; returns a Future of its output slices.
        Raises QueueFullError (backpressure) or ServerClosedError
        immediately instead of blocking the caller."""
        feed = {k: np.asarray(v) for k, v in feed.items()}
        if not feed:
            raise ValueError("submit: empty feed")
        ns = {k: (v.shape[0] if v.ndim else -1) for k, v in feed.items()}
        n = next(iter(ns.values()))
        if n <= 0 or any(m != n for m in ns.values()):
            raise ValueError(
                f"submit: feeds must share one positive leading batch dim "
                f"(add [None] for single rows); got {ns}")
        now = time.monotonic()
        timeout = (self.default_timeout if timeout_ms is None
                   else float(timeout_ms) / 1e3)
        req = Request(feed, n, item_signature(feed),
                      None if timeout is None else now + timeout, now,
                      ctx=_trace_ctx.current())
        with self._cond:
            if self._closed:
                raise ServerClosedError("server is stopped")
            if len(self._queue) >= self.max_queue_size:
                self.metrics.counter("serving/rejected").inc()
                raise QueueFullError(
                    f"request queue full ({self.max_queue_size}); retry "
                    f"later or raise max_queue_size")
            self._queue.append(req)
            self.metrics.counter("serving/requests").inc()
            self.metrics.gauge("serving/queue_depth").set(len(self._queue))
            self._cond.notify()
        return req.future

    def infer(self, feed: Dict[str, np.ndarray],
              timeout_ms: Optional[float] = None) -> List[np.ndarray]:
        """Blocking convenience wrapper around submit()."""
        return self.submit(feed, timeout_ms=timeout_ms).result()

    # -- serve loop --------------------------------------------------------
    def _pop_group(self) -> Optional[List[Request]]:
        """Take the queue head plus every queued same-signature request up
        to the largest bucket; wait up to max_batch_delay for stragglers
        once a group is open. Returns None only at shutdown with an empty
        queue. Holds the lock except while sleeping on the condition."""
        max_rows = self._batchers[0].max_bucket
        with self._cond:
            while not self._queue:
                if self._closed:
                    return None
                self._cond.wait(0.05)
            group = [self._queue.popleft()]
            sig = group[0].sig
            rows = group[0].n

            def scoop():
                nonlocal rows
                i = 0
                while i < len(self._queue) and rows < max_rows:
                    if self._queue[i].sig == sig:
                        r = self._queue[i]
                        del self._queue[i]
                        group.append(r)
                        rows += r.n
                    else:
                        i += 1

            scoop()
            deadline = time.monotonic() + self.max_batch_delay
            # batch-delay gamble: trade a bounded sliver of latency for a
            # fuller bucket — but never wait once the bucket is full or the
            # server is draining
            while (rows < max_rows and not self._closed):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(remaining)
                scoop()
            self.metrics.gauge("serving/queue_depth").set(len(self._queue))
        return group

    def _serve_loop(self, batcher: DynamicBatcher) -> None:
        while True:
            group = self._pop_group()
            if group is None:
                return
            now = time.monotonic()
            live: List[Request] = []
            for r in group:
                if r.expired(now):
                    self.metrics.counter("serving/timeouts").inc()
                    if not r.future.done():
                        r.future.set_exception(TimeoutError(
                            f"request missed its deadline after "
                            f"{(now - r.enqueued_at) * 1e3:.1f}ms in queue"))
                else:
                    live.append(r)
            if not live:
                continue
            with self._cond:
                self._inflight.update(live)
            t0 = time.monotonic()
            # adopt one request's trace for the batch dispatch — a batch
            # serves many requests but a span tree needs one parent; the
            # group-opener's context wins, and every PS pull under the
            # dispatch inherits it across the socket
            ctx = next((r.ctx for r in live if r.ctx is not None), None)
            try:
                with _trace_ctx.use(ctx), \
                        trace_span("serving/dispatch",
                                   batch=sum(r.n for r in live),
                                   requests=len(live)):
                    batcher.dispatch(live)
            finally:
                with self._cond:
                    self._inflight.difference_update(live)
            done = time.monotonic()
            lat = self.metrics.histogram("serving/latency_ms")
            wait = self.metrics.histogram("serving/queue_wait_ms")
            for r in live:
                lat.observe((done - r.enqueued_at) * 1e3)
                wait.observe((t0 - r.enqueued_at) * 1e3)
