"""Process-wide metrics registry: counters, gauges, histograms — the port's
copy of the part of ``paddle_tpu.observability.registry`` the PS tier uses
(exporters, child registries and help texts are not ported).

Each metric holds one small lock; the registry lock is touched only when a
metric is first created. Metrics may carry labels (``counter("x",
shard="0")``); the registry keys on (name, sorted label items) and
``snapshot()`` renders them as ``name{shard="0"}``. A ``Histogram`` keeps
all-time count/sum/min/max and percentiles over a ring of its most recent
observations, copied under the lock before any read.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "get_registry"]


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_name(name: str, label_items: tuple) -> str:
    if not label_items:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in label_items)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic counter (requests, batches, cache hits/misses)."""

    def __init__(self, name: str, labels: Optional[dict] = None):
        self.name = name
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value (queue depth, resident rows)."""

    def __init__(self, name: str, labels: Optional[dict] = None):
        self.name = name
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, d: float) -> None:
        with self._lock:
            self._value += float(d)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Observation stream with all-time count/sum/min/max and nearest-rank
    percentiles over a ring of the most recent `cap` observations."""

    def __init__(self, name: str, cap: int = 8192,
                 labels: Optional[dict] = None):
        self.name = name
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self._ring: List[float] = []
        self._cap = int(cap)
        self._idx = 0
        self._count = 0
        self._sum = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            self._min = v if self._min is None else min(self._min, v)
            self._max = v if self._max is None else max(self._max, v)
            if len(self._ring) < self._cap:
                self._ring.append(v)
            else:
                self._ring[self._idx] = v
                self._idx = (self._idx + 1) % self._cap

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def snapshot(self) -> dict:
        with self._lock:
            n, s, lo, hi = self._count, self._sum, self._min, self._max
            data = sorted(self._ring)

        def pct(p):
            if not data:
                return None
            return data[max(0, min(len(data) - 1,
                                   int(round(p / 100.0 * (len(data) - 1)))))]

        return {"count": n, "mean": (s / n) if n else None, "min": lo,
                "max": hi, "p50": pct(50), "p95": pct(95), "p99": pct(99)}


class Registry:
    """Named metric registry; metrics are created on first use so hot
    paths never need None-checks. Thread-safe throughout."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[tuple, object] = {}

    def _get(self, cls, name, labels, *args):
        key = (cls.__name__, name, _label_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = self._metrics[key] = cls(name, *args, labels=labels)
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, cap: int = 8192, **labels) -> Histogram:
        return self._get(Histogram, name, labels, cap)

    def snapshot(self) -> dict:
        """One flat dict: counters and gauges as numbers, histograms as
        summary dicts, keyed ``name{label="v"}``."""
        with self._lock:
            items = list(self._metrics.items())
        return {_fmt_name(name, labels): (m.snapshot()
                                          if isinstance(m, Histogram)
                                          else m.value)
                for (_, name, labels), m in items}

_default = Registry()


def get_registry() -> Registry:
    """THE process-wide registry."""
    return _default
