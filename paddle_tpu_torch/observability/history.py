"""Bounded in-memory metrics history: the ring TSDB under every page.

Everything the registry exports is a point-in-time snapshot; a page
arrives *after* the interesting part. `MetricsHistory` subscribes to
the `FederatedScraper` sweep stream (or samples the local registry on
its own thread when no scraper runs) and keeps the recent trajectory of
every numeric series in memory, in three tiers:

* ``raw``  — every sweep sample, per-series ring
  (``PDTPU_HISTORY_POINTS``, default 512 points);
* ``mid``  — 10 s buckets of (mean, min, max, count), ~1 h;
* ``long`` — 120 s buckets, ~24 h.

so a 1 Hz scrape keeps full resolution for the last ~8 minutes and a
degrading-but-honest summary for a day — the window a post-mortem
actually reads. Series identity is ``(name, labels, field)``: counters
and gauges contribute a ``value`` field, histograms/summaries
contribute ``p50``/``p99``/``count`` (the fields the SLO engine and the
ops console key on — storing all seven summary fields triples memory
for columns nobody queries).

Memory is bounded twice: per-series rings have fixed maxlen, and the
whole store is capped at ``PDTPU_HISTORY_MAX_MB`` (default 8) /
``PDTPU_HISTORY_MAX_SERIES`` (default 2048) with LRU series eviction —
a label-cardinality explosion evicts the series nobody touched rather
than growing without bound. The cap is enforced against a conservative
per-point byte estimate (``history/est_bytes`` gauge; the tracemalloc
test holds the real footprint under the same cap).

Set ``PDTPU_HISTORY_DIR`` to additionally spill one compact JSONL line
per sweep into size-capped rotating segments
(``PDTPU_HISTORY_SEGMENT_MB``, default 16; ``PDTPU_HISTORY_MAX_SEGMENTS``,
default 8, oldest deleted) so the lead-up to a crash survives process
death. `tools/metrics_lint.py --history DIR` lints the segments;
`tools/postmortem.py` bundles them.

Query via `MetricsHistory.query()` or the ``/history`` HTTP endpoint
(`observability/http.py`): series-prefix filter + time window +
tier + max_points.

The port's copy of ``paddle_tpu.observability.history``, stdlib only.
"""
from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Callable, List, Optional, Tuple

from .registry import Registry, get_registry

__all__ = ["MetricsHistory", "install_history", "get_history"]

Registry.describe("history/points", "raw points currently held")
Registry.describe("history/series", "distinct series currently held")
Registry.describe("history/est_bytes",
                  "estimated history memory footprint")
Registry.describe("history/evicted_series",
                  "series dropped by the LRU memory cap")
Registry.describe("history/sweeps", "sweeps recorded into history")
Registry.describe("history/segments_rotated",
                  "JSONL spill segments rotated out")

# conservative CPython cost estimates the memory cap is enforced with:
# a raw point is a (float, float) tuple in a deque slot; an aggregate
# point is a 5-float tuple. Real footprints measure smaller.
_RAW_POINT_BYTES = 120
_AGG_POINT_BYTES = 176
_SERIES_OVERHEAD_BYTES = 1024

# summary fields worth a timeline (see module docstring)
_SUMMARY_FIELDS = ("p50", "p99", "count")

_TIERS = {"raw": 0, "mid": 1, "long": 2}


class _Tier:
    """One downsampling tier: fixed-width time buckets folded into
    (bucket_t, mean, min, max, count) tuples in a bounded ring."""

    __slots__ = ("width", "ring", "_open")

    def __init__(self, width_s: float, maxlen: int):
        self.width = float(width_s)
        self.ring: collections.deque = collections.deque(maxlen=maxlen)
        self._open: Optional[list] = None  # [t, sum, min, max, count]

    def add(self, t: float, v: float) -> None:
        bt = t - (t % self.width)
        o = self._open
        if o is not None and o[0] == bt:
            o[1] += v
            o[2] = min(o[2], v)
            o[3] = max(o[3], v)
            o[4] += 1
            return
        if o is not None:
            self.ring.append((o[0], o[1] / o[4], o[2], o[3], o[4]))
        self._open = [bt, v, v, v, 1]

    def points(self) -> list:
        out = [[t, round(mean, 6), mn, mx, n]
               for t, mean, mn, mx, n in self.ring]
        o = self._open
        if o is not None:
            out.append([o[0], round(o[1] / o[4], 6), o[2], o[3], o[4]])
        return out

    def __len__(self) -> int:
        return len(self.ring) + (1 if self._open is not None else 0)


class _Series:
    __slots__ = ("raw", "mid", "long")

    def __init__(self, raw_points: int, mid_points: int, long_points: int):
        self.raw: collections.deque = collections.deque(maxlen=raw_points)
        self.mid = _Tier(10.0, mid_points)
        self.long = _Tier(120.0, long_points)

    def add(self, t: float, v: float) -> None:
        self.raw.append((t, v))
        self.mid.add(t, v)
        self.long.add(t, v)

    def est_bytes(self) -> int:
        return (_SERIES_OVERHEAD_BYTES
                + len(self.raw) * _RAW_POINT_BYTES
                + (len(self.mid) + len(self.long)) * _AGG_POINT_BYTES)


def _label_key(labels: Optional[dict]) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsHistory:
    """The bounded ring TSDB. `observe_sweep(doc)` records one
    `FederatedScraper` sweep; `attach(scraper)` subscribes; `query()`
    reads a window back out. Thread-safe throughout."""

    def __init__(self, raw_points: Optional[int] = None,
                 max_mb: Optional[float] = None,
                 max_series: Optional[int] = None,
                 spill_dir: Optional[str] = None,
                 registry: Optional[Registry] = None):
        env = os.environ
        if raw_points is None:
            raw_points = int(env.get("PDTPU_HISTORY_POINTS", "512"))
        if max_mb is None:
            max_mb = float(env.get("PDTPU_HISTORY_MAX_MB", "8"))
        if max_series is None:
            max_series = int(env.get("PDTPU_HISTORY_MAX_SERIES", "2048"))
        if spill_dir is None:
            spill_dir = env.get("PDTPU_HISTORY_DIR") or None
        self.raw_points = max(8, int(raw_points))
        self.max_bytes = int(max_mb * 1024 * 1024)
        self.max_series = max(16, int(max_series))
        self.mid_points = 360   # 10 s * 360 = 1 h
        self.long_points = 720  # 120 s * 720 = 24 h
        self._reg = registry if registry is not None else get_registry()
        self._lock = threading.Lock()
        # LRU on write: oldest-written series evicted first under the cap
        self._series: "collections.OrderedDict[tuple, _Series]" = \
            collections.OrderedDict()
        self._est_bytes = 0
        self._sweeps = 0
        self._started: Optional[float] = None
        # local-sampler thread state (used when no scraper runs)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # JSONL spill
        self.spill_dir = spill_dir
        self.segment_bytes = int(float(
            env.get("PDTPU_HISTORY_SEGMENT_MB", "16")) * 1024 * 1024)
        self.max_segments = max(1, int(
            env.get("PDTPU_HISTORY_MAX_SEGMENTS", "8")))
        self._spill_fh = None
        self._spill_path: Optional[str] = None
        self._spill_seq = 0

    # ------------------------------------------------------------ recording
    def attach(self, scraper) -> "MetricsHistory":
        """Subscribe to a `FederatedScraper`'s sweep stream."""
        scraper.add_sweep_listener(self.observe_sweep)
        return self

    def observe_sweep(self, doc: dict) -> None:
        """Record one sweep document (`FederatedScraper.scrape_once`
        shape). Each target's series land with the target's
        process/role(/shard) labels merged in, so fleet-wide history
        keys match fleet-wide exposition."""
        t = doc.get("t")
        if not isinstance(t, (int, float)):
            t = time.time()
        flat: List[tuple] = []
        for r in doc.get("targets", ()):
            if not r.get("ok"):
                continue
            extra = {"process": r.get("process"), "role": r.get("role")}
            if r.get("shard") is not None:
                extra["shard"] = str(r["shard"])
            for s in r.get("series", ()):
                self._flatten(s, extra, flat)
        self._record(t, flat)

    def observe_local(self, now: Optional[float] = None) -> None:
        """Record one snapshot of the local registry (scraper-less
        processes: a single-host trainer, a test)."""
        t = time.time() if now is None else float(now)
        flat: List[tuple] = []
        for s in self._reg.series(deep=True):
            self._flatten(s, None, flat)
        self._record(t, flat)

    @staticmethod
    def _flatten(s: dict, extra: Optional[dict], out: List[tuple]) -> None:
        name = s.get("name")
        if not name:
            return
        # scrape-source labels are DEFAULTS: a series' own process/role
        # label (e.g. autoscale/queue_depth{process=...}) must win over
        # the label of the target it was scraped through
        labels = {k: v for k, v in (extra or {}).items() if v is not None}
        labels.update(s.get("labels") or {})
        lk = _label_key(labels)
        if s.get("type") == "summary":
            summ = s.get("summary") or {}
            for f in _SUMMARY_FIELDS:
                v = summ.get(f)
                if isinstance(v, (int, float)):
                    out.append(((name, lk, f), float(v)))
        else:
            v = s.get("value")
            if isinstance(v, (int, float)):
                out.append(((name, lk, "value"), float(v)))

    def _record(self, t: float, flat: List[tuple]) -> None:
        evicted = 0
        with self._lock:
            if self._started is None:
                self._started = t
            self._sweeps += 1
            for key, v in flat:
                ser = self._series.get(key)
                if ser is None:
                    ser = _Series(self.raw_points, self.mid_points,
                                  self.long_points)
                    self._series[key] = ser
                else:
                    self._est_bytes -= ser.est_bytes()
                    self._series.move_to_end(key)
                ser.add(t, v)
                self._est_bytes += ser.est_bytes()
            while (len(self._series) > self.max_series
                   or self._est_bytes > self.max_bytes):
                if len(self._series) <= 1:
                    break
                _, old = self._series.popitem(last=False)
                self._est_bytes -= old.est_bytes()
                evicted += 1
            est = self._est_bytes
            nser = len(self._series)
            npts = sum(len(s.raw) for s in self._series.values())
        reg = self._reg
        reg.counter("history/sweeps").inc()
        reg.gauge("history/series").set(nser)
        reg.gauge("history/points").set(npts)
        reg.gauge("history/est_bytes").set(est)
        if evicted:
            reg.counter("history/evicted_series").inc(evicted)
        if self.spill_dir:
            self._spill(t, flat)

    # ---------------------------------------------------------- JSONL spill
    def _spill(self, t: float, flat: List[tuple]) -> None:
        """One compact JSONL line per sweep; rotate segments by size,
        delete oldest past `max_segments`. Spill failures are swallowed:
        history must survive a full disk."""
        try:
            line = json.dumps({
                "t": round(t, 3),
                "series": [{"name": k[0], "labels": dict(k[1]),
                            "field": k[2], "v": v} for k, v in flat],
            }, separators=(",", ":"))
            with self._lock:
                fh = self._ensure_segment(len(line) + 1)
                fh.write(line + "\n")
                fh.flush()
        except Exception:
            pass

    def _ensure_segment(self, nbytes: int):
        """Open/rotate the active segment (caller holds the lock)."""
        if (self._spill_fh is not None
                and self._spill_fh.tell() + nbytes <= self.segment_bytes):
            return self._spill_fh
        if self._spill_fh is not None:
            self._spill_fh.close()
            self._spill_fh = None
            self._reg.counter("history/segments_rotated").inc()
        os.makedirs(self.spill_dir, exist_ok=True)
        self._spill_seq += 1
        self._spill_path = os.path.join(
            self.spill_dir,
            f"history_{os.getpid()}_{self._spill_seq:05d}.jsonl")
        self._spill_fh = open(self._spill_path, "a")
        self._prune_segments()
        return self._spill_fh

    def _prune_segments(self) -> None:
        segs = sorted(
            f for f in os.listdir(self.spill_dir)
            if f.startswith("history_") and f.endswith(".jsonl"))
        for f in segs[:-self.max_segments]:
            try:
                os.unlink(os.path.join(self.spill_dir, f))
            except OSError:
                pass

    # ---------------------------------------------------- local sampler
    def start_local(self, interval_s: float = 1.0) -> "MetricsHistory":
        """Sample the local registry at `interval_s` on a daemon thread
        — the scraper-less deployment's sweep source (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def _loop():
            while not self._stop.is_set():
                try:
                    self.observe_local()
                except Exception:
                    pass
                self._stop.wait(interval_s)

        self._thread = threading.Thread(target=_loop,
                                        name="metrics-history",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        with self._lock:
            if self._spill_fh is not None:
                self._spill_fh.close()
                self._spill_fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # -------------------------------------------------------------- reading
    def query(self, prefix: str = "", start: Optional[float] = None,
              end: Optional[float] = None, tier: str = "raw",
              max_points: int = 512) -> List[dict]:
        """Windowed read. Returns a list of
        ``{"name", "labels", "field", "tier", "points"}`` dicts —
        raw points are ``[t, v]`` pairs; mid/long points are
        ``[bucket_t, mean, min, max, count]``. `max_points` keeps the
        newest points of each series. Copies under the lock: readers
        never see a ring mid-append."""
        if tier not in _TIERS:
            raise ValueError(f"unknown tier {tier!r}; "
                             f"one of {sorted(_TIERS)}")
        mp = max(1, int(max_points))
        out: List[dict] = []
        with self._lock:
            for (name, lk, field), ser in self._series.items():
                if prefix and not name.startswith(prefix):
                    continue
                if tier == "raw":
                    pts = [[t, v] for t, v in ser.raw]
                elif tier == "mid":
                    pts = ser.mid.points()
                else:
                    pts = ser.long.points()
                if start is not None:
                    pts = [p for p in pts if p[0] >= start]
                if end is not None:
                    pts = [p for p in pts if p[0] <= end]
                if not pts:
                    continue
                out.append({"name": name, "labels": dict(lk),
                            "field": field, "tier": tier,
                            "points": pts[-mp:]})
        out.sort(key=lambda s: (s["name"], sorted(s["labels"].items()),
                                s["field"]))
        return out

    def window(self, center: float, half_width_s: float = 30.0,
               prefix: str = "", max_points: int = 256) -> dict:
        """The post-mortem cut: every series around a moment in time.
        Attached to alert events by the ProfileTrigger."""
        return {
            "center_t": round(center, 3),
            "half_width_s": half_width_s,
            "series": self.query(prefix=prefix,
                                 start=center - half_width_s,
                                 end=center + half_width_s,
                                 max_points=max_points),
        }

    def stats(self) -> dict:
        with self._lock:
            return {
                "series": len(self._series),
                "raw_points": sum(len(s.raw)
                                  for s in self._series.values()),
                "est_bytes": self._est_bytes,
                "max_bytes": self.max_bytes,
                "max_series": self.max_series,
                "sweeps": self._sweeps,
                "started_t": self._started,
                "spill_dir": self.spill_dir,
                "spill_path": self._spill_path,
            }


# the history the introspection server's /history endpoint answers from
_installed: Optional[MetricsHistory] = None
_install_lock = threading.Lock()


def install_history(history: Optional[MetricsHistory]):
    """Make `history` the one ``/history`` answers from (None
    uninstalls). Returns the history."""
    global _installed
    with _install_lock:
        _installed = history
    return history


def get_history() -> Optional[MetricsHistory]:
    with _install_lock:
        return _installed
