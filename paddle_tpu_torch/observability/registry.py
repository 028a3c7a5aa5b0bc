"""Process-wide metrics registry: counters, gauges, histograms (the port's
copy of ``paddle_tpu.observability.registry``, stdlib only).

One in-process object every layer writes into (the executor's plan cache,
the PS tier, the serving tier's request counters, user code via
`get_registry()`), so a single export shows the whole runtime.

Design:
- each metric holds one small lock (contention is per-metric, not
  registry-wide); the registry lock is touched only on first-use creation;
- `Histogram` keeps a fixed-size ring of recent observations, and every
  read (percentile/snapshot) copies the ring UNDER the lock before
  computing, so concurrent `observe()` calls can never corrupt a
  percentile read;
- metrics may carry labels (``counter("x", shard="0")``): the registry
  keys on (name, sorted label items) and exporters render
  ``name{shard="0"}``;
- registries compose: a child registry (e.g. one server's
  ``serving.Metrics``) attaches to the process registry by weakref, and a
  deep `snapshot()` / `series()` / `prometheus_text()` merges children in:
  counters and gauges sum, histograms merge at the sample level.
"""
from __future__ import annotations

import json
import threading
import weakref
from typing import Dict, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "get_registry",
           "render_prometheus"]


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


# Module-level help-text store (`Registry.describe`): metric name ->
# one-line doc, shared by every registry in the process so federated and
# local exposition emit identical ``# HELP`` lines. Keyed on the RAW
# name (pre-sanitization), matching how callers register metrics.
_HELP: Dict[str, str] = {}
_HELP_LOCK = threading.Lock()


def _prom_help_text(text: str) -> str:
    """HELP-line escaping per the exposition spec: backslash and
    newline only (double quotes are legal in help text)."""
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _prom_metric_name(name: str) -> str:
    """Map to the exposition-spec metric-name charset
    ``[a-zA-Z_:][a-zA-Z0-9_:]*`` (we also fold ``:`` to ``_`` — the
    spec reserves colons for recording rules)."""
    s = "".join(ch if (ch.isalnum() and ch.isascii()) or ch == "_"
                else "_" for ch in name)
    if not s or s[0].isdigit():
        s = "_" + s
    return s


def _prom_label_name(name: str) -> str:
    """Label-name charset ``[a-zA-Z_][a-zA-Z0-9_]*``."""
    return _prom_metric_name(name)


def _prom_label_value(value) -> str:
    """Escape per the exposition spec: backslash, double quote, and
    newline inside quoted label values."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _prom_labelstr(items, extra=()) -> str:
    items = tuple(items) + tuple(extra)
    if not items:
        return ""
    return ("{" + ",".join(
        f'{_prom_label_name(k)}="{_prom_label_value(v)}"'
        for k, v in items) + "}")


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
    """Point-in-time value (queue depth, device count)."""

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


def _percentiles_from(data: List[float], sums: Tuple[int, float],
                      lo, hi) -> dict:
    n, s = sums

    def pct(p):
        if not data:
            return None
        return data[max(0, min(len(data) - 1,
                               int(round(p / 100.0 * (len(data) - 1)))))]

    return {"count": n, "mean": (s / n) if n else None,
            "min": lo, "max": hi,
            "p50": pct(50), "p95": pct(95), "p99": pct(99)}


class Histogram:
    """Observation stream with all-time count/sum/min/max and percentiles
    over a fixed ring of the most recent `cap` observations.

    Snapshot/percentile reads are copy-on-read: the ring is copied while
    the lock is held and all sorting/ranking happens on the copy, so a
    reader can never observe (or cause) a half-updated ring while writer
    threads `observe()` concurrently."""

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

    def _state(self) -> tuple:
        """(count, sum, min, max, ring-copy) — one consistent read."""
        with self._lock:
            return (self._count, self._sum, self._min, self._max,
                    list(self._ring))

    def percentile(self, p: float) -> Optional[float]:
        """Nearest-rank percentile (p in [0, 100]) over the retained ring."""
        data = sorted(self._state()[4])
        if not data:
            return None
        rank = max(0, min(len(data) - 1,
                          int(round(p / 100.0 * (len(data) - 1)))))
        return data[rank]

    def snapshot(self) -> dict:
        n, s, lo, hi, ring = self._state()
        return _percentiles_from(sorted(ring), (n, s), lo, hi)


def _merge_hist_states(states: List[tuple]) -> dict:
    n = sum(st[0] for st in states)
    s = sum(st[1] for st in states)
    los = [st[2] for st in states if st[2] is not None]
    his = [st[3] for st in states if st[3] is not None]
    data = sorted(v for st in states for v in st[4])
    return _percentiles_from(data, (n, s),
                             min(los) if los else None,
                             max(his) if his else None)


class Registry:
    """Named metric registry; metrics are created on first use so hot
    paths never need None-checks. Thread-safe throughout."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[tuple, Counter] = {}
        self._gauges: Dict[tuple, Gauge] = {}
        self._histograms: Dict[tuple, Histogram] = {}
        # child registries (weak: a GC'd server's metrics drop out of the
        # deep export automatically)
        self._children: "weakref.WeakSet[Registry]" = weakref.WeakSet()

    # -- creation ----------------------------------------------------------
    def counter(self, name: str, **labels) -> Counter:
        key = (name, _label_key(labels))
        with self._lock:
            m = self._counters.get(key)
            if m is None:
                m = self._counters[key] = Counter(name, labels)
            return m

    def gauge(self, name: str, **labels) -> Gauge:
        key = (name, _label_key(labels))
        with self._lock:
            m = self._gauges.get(key)
            if m is None:
                m = self._gauges[key] = Gauge(name, labels)
            return m

    def histogram(self, name: str, cap: int = 8192, **labels) -> Histogram:
        key = (name, _label_key(labels))
        with self._lock:
            m = self._histograms.get(key)
            if m is None:
                m = self._histograms[key] = Histogram(name, cap, labels)
            return m

    # -- documentation -----------------------------------------------------
    @staticmethod
    def describe(name: str, help_text: str) -> None:
        """Attach a one-line doc to a metric name; `render_prometheus`
        emits it as a ``# HELP`` line (described series only). Process-
        wide (module-level store), so it applies to every registry and
        to federated re-rendering alike."""
        with _HELP_LOCK:
            _HELP[str(name)] = str(help_text)

    @staticmethod
    def help_for(name: str) -> Optional[str]:
        with _HELP_LOCK:
            return _HELP.get(str(name))

    # -- removal -----------------------------------------------------------
    def remove(self, name: str, **labels) -> bool:
        """Drop the exact (name, labels) series from this registry, all
        three kinds. Returns True if anything was removed. The federated
        scraper uses this to retire ``autoscale/*`` gauges whose source
        target vanished, so a removed shard's last reading doesn't
        linger forever as a live-looking sample."""
        key = (name, _label_key(labels))
        removed = False
        with self._lock:
            for d in (self._counters, self._gauges, self._histograms):
                if d.pop(key, None) is not None:
                    removed = True
        return removed

    def remove_matching(self, name: str) -> int:
        """Drop every series with metric name `name`, any label set.
        Returns the number of series removed."""
        n = 0
        with self._lock:
            for d in (self._counters, self._gauges, self._histograms):
                for key in [k for k in d if k[0] == name]:
                    del d[key]
                    n += 1
        return n

    # -- composition -------------------------------------------------------
    def attach(self, child: "Registry") -> "Registry":
        """Include `child`'s metrics in this registry's deep exports.
        Held by weakref: detaches automatically when the child dies."""
        if child is self:
            raise ValueError("a registry cannot attach to itself")
        self._children.add(child)
        return child

    def _collect(self, deep: bool, _seen=None):
        """All (key, metric) tuples of self (+ children when deep), as
        three lists: counters, gauges, histograms."""
        _seen = _seen if _seen is not None else set()
        if id(self) in _seen:  # cycle guard: A attached to B attached to A
            return [], [], []
        _seen.add(id(self))
        with self._lock:
            cs = list(self._counters.items())
            gs = list(self._gauges.items())
            hs = list(self._histograms.items())
            children = list(self._children) if deep else []
        for ch in children:
            c2, g2, h2 = ch._collect(deep, _seen)
            cs += c2
            gs += g2
            hs += h2
        return cs, gs, hs

    # -- export ------------------------------------------------------------
    def snapshot(self, deep: bool = True) -> dict:
        """One plain dict of everything — counters/gauges as numbers,
        histograms as summary dicts. With deep=True, attached child
        registries merge in: counters/gauges with the same name+labels
        sum; histograms merge at the sample level (percentiles over the
        union of retained rings)."""
        cs, gs, hs = self._collect(deep)
        out: dict = {}
        for key, c in cs:
            name = _fmt_name(*key)
            out[name] = out.get(name, 0) + c.value
        for key, g in gs:
            name = _fmt_name(*key)
            out[name] = out.get(name, 0.0) + g.value
        by_name: Dict[str, list] = {}
        for key, h in hs:
            by_name.setdefault(_fmt_name(*key), []).append(h._state())
        for name, states in by_name.items():
            out[name] = (_percentiles_from(sorted(states[0][4]),
                                           states[0][:2], *states[0][2:4])
                         if len(states) == 1 else _merge_hist_states(states))
        return out

    def dump_json(self, path: str, deep: bool = True) -> dict:
        snap = self.snapshot(deep)
        with open(path, "w") as f:
            json.dump(snap, f, indent=2, sort_keys=True)
        return snap

    def series(self, deep: bool = True) -> List[dict]:
        """Structured export: one dict per series, JSON- and
        PS-transport-safe (plain str/int/float/None values only), so a
        federation scraper — HTTP ``/metrics/series`` or the pserver
        ``metrics`` transport op — gets labels as DATA instead of
        parsing them back out of flat ``name{k="v"}`` snapshot keys.

        Shapes::

            {"name", "type": "counter"|"gauge", "labels": {...}, "value"}
            {"name", "type": "summary", "labels": {...},
             "summary": {count, sum, mean, min, max, p50, p95, p99}}

        Same merge semantics as `snapshot`/`prometheus_text`: duplicate
        keys across attached children sum (counters/gauges) or merge at
        the sample level (histograms)."""
        cs, gs, hs = self._collect(deep)
        out: List[dict] = []
        merged_c: Dict[tuple, int] = {}
        for key, c in cs:
            merged_c[key] = merged_c.get(key, 0) + c.value
        for (name, items), v in sorted(merged_c.items()):
            out.append({"name": name, "type": "counter",
                        "labels": dict(items), "value": v})
        merged_g: Dict[tuple, float] = {}
        for key, g in gs:
            merged_g[key] = merged_g.get(key, 0.0) + g.value
        for (name, items), v in sorted(merged_g.items()):
            out.append({"name": name, "type": "gauge",
                        "labels": dict(items), "value": v})
        merged_h: Dict[tuple, list] = {}
        for key, h in hs:
            merged_h.setdefault(key, []).append(h._state())
        for (name, items), states in sorted(merged_h.items()):
            summ = _merge_hist_states(states)
            summ["sum"] = sum(st[1] for st in states)
            out.append({"name": name, "type": "summary",
                        "labels": dict(items), "summary": summ})
        return out

    def prometheus_text(self, deep: bool = True) -> str:
        """Prometheus text exposition format. Histograms render as
        summaries (quantile labels + _count/_sum). Metric/label names
        are sanitized to the spec charsets and label values escaped
        (backslash, double quote, newline), so hostile values like a
        feed signature ``x:f32[8,128]`` cannot produce an unscrapeable
        page. Implemented as `render_prometheus(self.series(deep))` so
        local and federated output share one renderer by construction."""
        return render_prometheus(self.series(deep))

    def report(self, deep: bool = False) -> str:
        """Human-readable text table of the snapshot."""
        snap = self.snapshot(deep)
        lines = [f"{'metric':<36}{'value':>44}"]
        for name in sorted(snap):
            v = snap[name]
            if isinstance(v, dict):
                parts = []
                for k in ("count", "mean", "p50", "p95", "p99", "max"):
                    x = v.get(k)
                    if x is None:
                        continue
                    parts.append(f"{k}={x:.3f}" if isinstance(x, float)
                                 else f"{k}={x}")
                v = " ".join(parts) or "-"
            lines.append(f"{name:<36}{str(v):>44}")
        return "\n".join(lines)

    def reset(self) -> None:
        """Drop every metric (tests / long-lived processes rolling over);
        attached children are kept but their metrics are untouched."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


def render_prometheus(series: List[dict], extra_labels=()) -> str:
    """Render a `Registry.series()`-shaped list in the exposition text
    format: ``# TYPE`` line once per metric name, counters then gauges
    then summaries, each group sorted by (name, labels). `extra_labels`
    ((key, value) pairs) are appended to every sample's label set — the
    federation exporter passes ``process``/``role``/``shard`` here —
    and go through the SAME name sanitization and value escaping as
    local labels, so federated output cannot diverge from local output.
    """
    extra = tuple(extra_labels)
    groups: Dict[str, list] = {"counter": [], "gauge": [], "summary": []}
    for s in series:
        t = s.get("type")
        if t not in groups:
            continue
        items = _label_key(s.get("labels") or {})
        groups[t].append(((s["name"], items), s))
    lines: List[str] = []
    typed = set()
    for kind in ("counter", "gauge", "summary"):
        for (name, items), s in sorted(groups[kind], key=lambda kv: kv[0]):
            pname = _prom_metric_name(name)
            if pname not in typed:
                typed.add(pname)
                help_text = Registry.help_for(name)
                if help_text is not None:
                    lines.append(
                        f"# HELP {pname} {_prom_help_text(help_text)}")
                lines.append(f"# TYPE {pname} {kind}")
            if kind == "summary":
                summ = s.get("summary") or {}
                for q, k in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                    if summ.get(k) is not None:
                        lines.append(
                            f"{pname}"
                            f"{_prom_labelstr(items, extra + (('quantile', q),))}"
                            f" {summ[k]}")
                lines.append(f"{pname}_count{_prom_labelstr(items, extra)} "
                             f"{summ.get('count', 0)}")
                lines.append(f"{pname}_sum{_prom_labelstr(items, extra)} "
                             f"{summ.get('sum', 0.0)}")
            else:
                lines.append(f"{pname}{_prom_labelstr(items, extra)} "
                             f"{s.get('value', 0)}")
    return "\n".join(lines) + ("\n" if lines else "")


_default = Registry()


def get_registry() -> Registry:
    """THE process-wide registry: executor, serving, and user metrics all
    land here (serving `Metrics` instances attach as children)."""
    return _default
