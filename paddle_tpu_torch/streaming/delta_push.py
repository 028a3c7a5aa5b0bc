"""DeltaPublisher — stream freshly-trained rows to serving at bounded
staleness (the port's copy of ``paddle_tpu.streaming.delta_push``).

Reference analog: the online-learning deployments around the reference
push sparse-table deltas from trainers to the serving cache (Cube) on a
seconds cadence, instead of shipping whole-model checkpoints. Here the
trainer side already has a precise "what changed" signal: every update
the tier makes lands as a ``ShardedTable.push`` (the async pusher, hot-
slab write-backs, flush — all of them). The publisher taps that stream
with ``add_push_listener``, coalesces per-uid (last write wins — a hot id
pushed 50 times in a window ships once, with its newest bytes), and a
background thread flushes the pending set to subscribers every
``staleness_s/2`` seconds, so a row a serving replica already holds is
refreshed within ~``staleness_s`` of the trainer computing it.

Subscribers are callables ``fn(table_name, sorted_uids, rows)``:

- ``attach_predictor`` wires ``PsLookupPredictor.apply_delta`` — resident
  cache rows are overwritten in place, absent rows fault in from the PS
  shards (which applied the push before the listener ever fired, so the
  pull is coherent);
- ``attach_hot_cache`` wires ``HotRowCache.drop_rows`` for a device slab
  owned by ANOTHER process's tier (drop clean residents so the next
  touch re-pulls) — never attach a tier's publisher to its own slab.

The staleness contract: a pushed
row is visible to every subscriber within ``staleness_s`` plus one
subscriber-callback time, env-tunable via ``PDTPU_STREAM_STALENESS_S``
(seconds, default 2.0). Observed per-row staleness (flush time − push
time) feeds the ``stream/staleness_ms`` histogram and the local p50/p99
sample window the soak assertions read. That number is the
publisher's HALF of the story; meta-aware subscribers (``subscribe(fn,
meta=True)``, which `attach_predictor` uses) additionally receive the
per-row enqueue stamps and record their own visibility time, closing
the TRUE train→serve audit as ``staleness/e2e_ms`` (push → visible in
the serving cache) — the histogram the ``DeltaStaleness`` SLO reads.
"""
from __future__ import annotations

import collections
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..observability import get_registry

__all__ = ["DeltaPublisher"]


class DeltaPublisher:
    """Coalescing push-stream fan-out for one ``ShardedTable``."""

    def __init__(self, table, staleness_s: Optional[float] = None,
                 start: bool = True):
        if staleness_s is None:
            staleness_s = float(
                os.environ.get("PDTPU_STREAM_STALENESS_S", "2.0"))
        if staleness_s <= 0:
            raise ValueError(
                f"staleness_s must be > 0, got {staleness_s}")
        self.table = table
        self.staleness_s = float(staleness_s)
        self._subs: List[tuple] = []  # (fn, wants_meta)
        self._seq = 0
        # uid -> (row copy, enqueue time): last write wins, age is the
        # FIRST unflushed write's (the staleness bound is on the oldest
        # pending byte, not the newest)
        self._pending: Dict[int, tuple] = {}
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self.staleness_samples: "collections.deque" = collections.deque(
            maxlen=4096)
        reg = get_registry()
        lbl = {"table": getattr(table, "name", "?")}
        self._c_rows = reg.counter("stream/delta_rows", **lbl)
        self._c_bytes = reg.counter("stream/delta_bytes", **lbl)
        self._c_flushes = reg.counter("stream/delta_flushes", **lbl)
        self._c_errors = reg.counter("stream/subscriber_errors", **lbl)
        self._h_staleness = reg.histogram("stream/staleness_ms", **lbl)
        table.add_push_listener(self._on_push)
        if start:
            self._thread = threading.Thread(
                target=self._run, name="delta_publisher", daemon=True)
            self._thread.start()

    # -- the tap (runs on whatever thread pushed) ---------------------------
    def _on_push(self, ids: np.ndarray, rows: np.ndarray) -> None:
        now = time.monotonic()
        rows = np.array(rows, np.uint16, copy=True)  # caller may reuse
        with self._lock:
            for j, u in enumerate(np.asarray(ids).tolist()):
                prev = self._pending.get(u)
                # newest bytes, oldest timestamp
                self._pending[u] = (rows[j],
                                    prev[1] if prev is not None else now)

    # -- fan-out -------------------------------------------------------------
    def subscribe(self, fn: Callable, meta: bool = False) -> None:
        """``fn(table_name, sorted_uids, rows)`` on every flush. Runs on
        the publisher thread — keep it bounded (a cache refresh, not a
        network round-trip per row).

        With ``meta=True`` the subscriber instead gets
        ``fn(table_name, sorted_uids, rows, meta=meta_dict)`` where the
        dict carries the staleness-auditor stamps: ``seq`` (flush
        number), ``published_t`` (monotonic flush time) and
        ``enqueue_t`` (float64 array aligned with `uids`: each row's
        FIRST unflushed push time). A meta-aware consumer records its
        own visibility time against these stamps, producing a true
        train→serve end-to-end freshness histogram instead of the
        publisher-half number `staleness_percentiles` sees."""
        self._subs.append((fn, bool(meta)))

    def attach_predictor(self, predictor) -> None:
        # meta-aware: the predictor stamps visibility per delta batch,
        # closing the e2e staleness audit (staleness/e2e_ms)
        self.subscribe(predictor.apply_delta, meta=True)

    def attach_hot_cache(self, hot_cache) -> None:
        self.subscribe(lambda name, uids, rows: hot_cache.drop_rows(uids))

    def flush(self) -> int:
        """Publish the pending set now (also the cadence thread's body).
        Returns #rows shipped."""
        now = time.monotonic()
        with self._lock:
            if not self._pending:
                return 0
            pending, self._pending = self._pending, {}
        uids = np.asarray(sorted(pending), np.int64)
        rows = np.stack([pending[int(u)][0] for u in uids])
        enqueue_t = np.asarray([pending[int(u)][1] for u in uids.tolist()],
                               np.float64)
        ages_ms = ((now - enqueue_t) * 1e3).tolist()
        for a in ages_ms:
            self._h_staleness.observe(a)
        self.staleness_samples.extend(ages_ms)
        name = getattr(self.table, "name", "?")
        self._seq += 1
        meta = {"seq": self._seq, "published_t": now,
                "enqueue_t": enqueue_t}
        for fn, wants_meta in list(self._subs):
            try:
                if wants_meta:
                    fn(name, uids, rows, meta=meta)
                else:
                    fn(name, uids, rows)
            except Exception:
                # one sick replica must not stall the stream (or lose the
                # flush for its siblings); it re-converges on its next
                # cache miss because the shards already hold these bytes
                self._c_errors.inc()
        self._c_rows.inc(int(uids.size))
        self._c_bytes.inc(int(rows.nbytes))
        self._c_flushes.inc()
        return int(uids.size)

    def _run(self) -> None:
        # half the budget per tick: a row enqueued right after a flush
        # still ships within ~staleness_s
        tick = max(0.01, self.staleness_s / 2.0)
        while not self._stop:
            self._wake.wait(tick)
            self._wake.clear()
            if self._stop:
                break
            try:
                self.flush()
            except Exception:
                self._c_errors.inc()

    def staleness_percentiles(self) -> dict:
        """{p50, p99, max} over the recent per-row staleness samples
        (ms) — the numbers the soak asserts against the budget."""
        s = list(self.staleness_samples)
        if not s:
            return {"p50": None, "p99": None, "max": None}
        arr = np.asarray(s, np.float64)
        return {"p50": float(np.percentile(arr, 50)),
                "p99": float(np.percentile(arr, 99)),
                "max": float(arr.max())}

    def close(self) -> None:
        """Detach from the table, stop the cadence thread, final flush."""
        try:
            self.table.remove_push_listener(self._on_push)
        except Exception:
            pass
        self._stop = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
