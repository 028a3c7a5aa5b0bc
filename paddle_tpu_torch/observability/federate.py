"""Fleet-wide metrics federation: one scrape of every process (the port's
copy of ``paddle_tpu.observability.federate``, stdlib only).

The runtime is many processes — pserver shards,
serving worker subprocesses, the coordinator — each with its own
process-local `Registry`. This module is the aggregation point: a
`FederatedScraper` holds a list of `ScrapeTarget`s (one per process),
pulls each one's structured series (`Registry.series()` shape), and
re-exports the union with ``process``/``role``(/``shard``) labels
appended through the SAME exposition renderer the local ``/metrics``
endpoint uses (`registry.render_prometheus`), so federated output obeys
identical name-sanitization and label-escaping rules.

Three target kinds, matching how each process can actually be reached:

* ``http`` — a process running the introspection server
  (``PDTPU_INTROSPECT_PORT``): ``GET /metrics/series`` (structured),
  falling back to parsing the flat ``/metrics.json`` snapshot of processes
  that serve no series;
* ``ps`` — a pserver: the ``metrics`` op of the PS wire protocol, through
  ``ps.transport.SocketClient`` (pservers have no HTTP server and load no
  torch — the transport op costs nothing they don't already have);
* ``call`` — anything reachable as a Python callable returning a series
  list: the local registry, a `ThreadReplica`/`ProcessReplica`
  (both expose ``.metrics()``), a test stub.

Derived autoscaler signals (ROADMAP #5): every ``scrape_once()`` also
distills the merged series into the gauges an autoscaler keys on —
per-shard pull p99, per-process serving queue depth, straggler/anomaly
counts, shard recovery counts, shards currently down — published into
the coordinator's own registry under ``autoscale/*`` so they ride the
normal ``/metrics`` export and the ``/fleet`` endpoint alike.

Off the hot path by construction: scraping happens on this thread (or
the optional 1 Hz background thread via ``start()``), touches workers
only through their existing metrics surfaces, and records its own cost
in ``fleet/scrape_ms`` — the bench asserts the delta on the training
step is noise (<1%).
"""
from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

from typing import Callable, List, Optional

from .registry import Registry, get_registry, render_prometheus

__all__ = ["ScrapeTarget", "FederatedScraper", "install_scraper",
           "get_scraper"]

Registry.describe("autoscale/ps_pull_p99_ms",
                  "worst per-shard PS pull p99 seen across the fleet")
Registry.describe("autoscale/queue_depth",
                  "serving queue depth per process")
Registry.describe("autoscale/stragglers",
                  "step anomaly count summed across the fleet")
Registry.describe("autoscale/recoveries",
                  "PS shard recovery count summed across the fleet")
Registry.describe("autoscale/shards_down",
                  "PS shards currently reporting down")
Registry.describe("autoscale/targets_unreachable",
                  "scrape targets that failed this sweep")
Registry.describe("fleet/scrape_ms", "federated sweep duration")


def _series_from_snapshot(snap: dict) -> List[dict]:
    """Best-effort conversion of a flat ``/metrics.json`` snapshot
    (``name{k="v",...}`` keys) back into series dicts — the fallback for
    processes that predate ``/metrics/series``. Label values containing
    quotes won't round-trip perfectly; structured scraping is the fix,
    this keeps old workers visible rather than dark."""
    out: List[dict] = []
    for key, v in snap.items():
        name, labels = key, {}
        if key.endswith("}") and "{" in key:
            name, inner = key.split("{", 1)
            for part in inner[:-1].split('",'):
                if "=" not in part:
                    continue
                k, val = part.split("=", 1)
                labels[k.strip()] = val.strip().strip('"')
        if isinstance(v, dict):
            out.append({"name": name, "type": "summary", "labels": labels,
                        "summary": dict(v)})
        else:
            # flat snapshots don't distinguish counter from gauge; gauge
            # is the lossless guess (no monotonicity claim)
            out.append({"name": name, "type": "gauge", "labels": labels,
                        "value": v})
    return out


class ScrapeTarget:
    """One process to scrape. Build via the classmethods."""

    def __init__(self, name: str, role: str, kind: str,
                 address: str = "", shard: Optional[int] = None,
                 fn: Optional[Callable[[], list]] = None):
        self.name = str(name)
        self.role = str(role)
        self.kind = kind
        self.address = address
        self.shard = shard
        self._fn = fn

    @classmethod
    def http(cls, base_url: str, name: str = "", role: str = "worker"):
        """A process with the introspection HTTP server."""
        base = base_url.rstrip("/")
        return cls(name or base, role, "http", address=base)

    @classmethod
    def ps(cls, endpoint: str, shard: int, name: str = ""):
        """A pserver, via the transport ``metrics`` op."""
        return cls(name or f"pserver:{endpoint}", "pserver", "ps",
                   address=endpoint, shard=int(shard))

    @classmethod
    def call(cls, fn: Callable[[], list], name: str, role: str):
        """Anything that can hand over a series list directly: the local
        registry, a fleet replica handle, a test stub."""
        return cls(name, role, "call", fn=fn)

    @classmethod
    def local(cls, name: str = "coordinator", role: str = "coordinator"):
        return cls.call(lambda: get_registry().series(deep=True),
                        name, role)

    def extra_labels(self) -> tuple:
        extra = (("process", self.name), ("role", self.role))
        if self.shard is not None:
            extra += (("shard", str(self.shard)),)
        return extra

    def scrape(self, timeout: float) -> List[dict]:
        if self.kind == "call":
            return list(self._fn())
        if self.kind == "ps":
            from ..ps.transport import SocketClient
            c = SocketClient(self.address, timeout=timeout, retries=0)
            try:
                return c.metrics()
            finally:
                c.close()
        # http: structured endpoint first, flat snapshot as fallback
        try:
            with urllib.request.urlopen(self.address + "/metrics/series",
                                        timeout=timeout) as resp:
                return json.load(resp)
        except urllib.error.HTTPError:
            with urllib.request.urlopen(self.address + "/metrics.json",
                                        timeout=timeout) as resp:
                return _series_from_snapshot(json.load(resp))


def _series_value(series: List[dict], name: str, field: str = "value"):
    """Sum of `field` over every series named `name` (labels ignored)."""
    vals = [s.get(field) for s in series if s.get("name") == name]
    vals = [v for v in vals if isinstance(v, (int, float))]
    return sum(vals) if vals else None


class FederatedScraper:
    """Scrapes every target, merges, re-labels, derives the autoscaler
    signals. `scrape_once()` is the whole protocol; `start()` runs it on
    a background thread at `interval_s` for continuously-fresh gauges.
    """

    def __init__(self, targets=(), interval_s: float = 1.0,
                 timeout: float = 2.0):
        self.targets: List[ScrapeTarget] = list(targets)
        self.interval_s = float(interval_s)
        self.timeout = float(timeout)
        self._lock = threading.Lock()
        self._last: Optional[dict] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._listeners: List[Callable[[dict], None]] = []
        # label sets published into autoscale/* on the previous sweep,
        # so _signals can retire gauges whose source target vanished
        self._prev_pull_shards: set = set()
        self._prev_queue_procs: set = set()
        reg = get_registry()
        self._h_scrape = reg.histogram("fleet/scrape_ms")
        self._c_failed = reg.counter("fleet/scrape_failures")

    def add_target(self, target: ScrapeTarget) -> ScrapeTarget:
        """Add a target; a target with the SAME name replaces the old
        one (re-adding a bounced worker must not double-count it)."""
        with self._lock:
            self.targets = ([t for t in self.targets
                             if t.name != target.name] + [target])
        return target

    def remove_target(self, name: str) -> bool:
        """Drop the target named `name`; its derived ``autoscale/*``
        gauges retire on the next sweep. Returns True if found."""
        with self._lock:
            before = len(self.targets)
            self.targets = [t for t in self.targets if t.name != name]
            return len(self.targets) != before

    def add_sweep_listener(self, fn: Callable[[dict], None]) -> Callable:
        """Call ``fn(doc)`` with every completed sweep document — the
        SLO engine's subscription point. Listener exceptions are
        swallowed (an alerting bug must not kill the scrape loop)."""
        self._listeners.append(fn)
        return fn

    # ------------------------------------------------------------- scraping
    def scrape_once(self) -> dict:
        """One federated sweep: the ``/fleet`` document. Always returns —
        per-target failures are recorded (``ok: false`` + error string),
        never raised, so one dead worker can't take down the scrape."""
        t0 = time.perf_counter()
        results = []
        with self._lock:
            targets = list(self.targets)
        for t in targets:
            s0 = time.perf_counter()
            try:
                series = t.scrape(self.timeout)
                ok, err = True, None
            except Exception as e:
                series, ok, err = [], False, f"{type(e).__name__}: {e}"
                self._c_failed.inc()
            results.append({
                "process": t.name, "role": t.role, "shard": t.shard,
                "ok": ok, "error": err,
                "scrape_ms": (time.perf_counter() - s0) * 1e3,
                "series": series,
            })
        doc = {"t": time.time(),
               "targets": results,
               "ok": all(r["ok"] for r in results),
               "signals": self._signals(results)}
        self._h_scrape.observe((time.perf_counter() - t0) * 1e3)
        with self._lock:
            self._last = doc
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(doc)
            except Exception:
                pass  # a listener bug must not kill the scrape loop
        return doc

    def last(self) -> Optional[dict]:
        with self._lock:
            return self._last

    # ------------------------------------------------------------ rendering
    def prometheus_text(self, refresh: bool = False) -> str:
        """The whole fleet in exposition format: each target's series
        rendered with its ``process``/``role``(/``shard``) labels
        appended, via the same renderer as local ``/metrics``."""
        doc = None if refresh else self.last()
        if doc is None:
            doc = self.scrape_once()
        chunks = []
        for r in doc["targets"]:
            t_extra = (("process", r["process"]), ("role", r["role"]))
            if r["shard"] is not None:
                t_extra += (("shard", str(r["shard"])),)
            chunks.append(render_prometheus(r["series"],
                                            extra_labels=t_extra))
        return "".join(chunks)

    # ------------------------------------------------- autoscaler signals
    def _signals(self, results: List[dict]) -> dict:
        """Distill the merged scrape into the ROADMAP-5 decision gauges
        and publish them into the local registry (``autoscale/*``)."""
        reg = get_registry()
        pull_p99: dict = {}      # shard label -> worst p99 seen
        queue_depth: dict = {}   # process -> depth
        stragglers = 0.0
        recoveries = 0.0
        shards_down = 0
        for r in results:
            if not r["ok"]:
                continue
            for s in r["series"]:
                name = s.get("name")
                if name == "ps/shard_pull_ms":
                    sh = (s.get("labels") or {}).get("shard", "?")
                    p99 = (s.get("summary") or {}).get("p99")
                    if isinstance(p99, (int, float)):
                        pull_p99[sh] = max(pull_p99.get(sh, 0.0),
                                           float(p99))
                elif name == "serving/queue_depth":
                    v = s.get("value")
                    if isinstance(v, (int, float)):
                        queue_depth[r["process"]] = (
                            queue_depth.get(r["process"], 0.0) + float(v))
                elif name == "steps/anomalies":
                    v = s.get("value")
                    if isinstance(v, (int, float)):
                        stragglers += float(v)
                elif name == "ps/recoveries":
                    v = s.get("value")
                    if isinstance(v, (int, float)):
                        recoveries += float(v)
                elif name == "ps/shard_up":
                    if not s.get("value"):
                        shards_down += 1
        # retire per-label gauges whose source vanished this sweep — a
        # removed shard/process must not linger as a live-looking sample
        for sh in self._prev_pull_shards - set(pull_p99):
            reg.remove("autoscale/ps_pull_p99_ms", shard=sh)
        for proc in self._prev_queue_procs - set(queue_depth):
            reg.remove("autoscale/queue_depth", process=proc)
        self._prev_pull_shards = set(pull_p99)
        self._prev_queue_procs = set(queue_depth)
        for sh, v in pull_p99.items():
            reg.gauge("autoscale/ps_pull_p99_ms", shard=sh).set(v)
        for proc, v in queue_depth.items():
            reg.gauge("autoscale/queue_depth", process=proc).set(v)
        reg.gauge("autoscale/stragglers").set(stragglers)
        reg.gauge("autoscale/recoveries").set(recoveries)
        reg.gauge("autoscale/shards_down").set(shards_down)
        reg.gauge("autoscale/targets_unreachable").set(
            sum(1 for r in results if not r["ok"]))
        return {
            "ps_pull_p99_ms": pull_p99,
            "queue_depth": queue_depth,
            "stragglers": stragglers,
            "recoveries": recoveries,
            "shards_down": shards_down,
            "targets_unreachable": sum(
                1 for r in results if not r["ok"]),
        }

    # ---------------------------------------------------- background thread
    def start(self) -> "FederatedScraper":
        """Scrape at `interval_s` on a daemon thread (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="fleet-scraper", daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.scrape_once()
            except Exception:
                pass  # scrape_once already accounts per-target failures
            self._stop.wait(self.interval_s)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


# the scraper the coordinator's HTTP plane serves from /fleet
_installed: Optional[FederatedScraper] = None
_install_lock = threading.Lock()


def install_scraper(scraper: Optional[FederatedScraper]):
    """Make `scraper` the one the introspection server's ``/fleet``
    endpoint answers from (None uninstalls). Returns the scraper."""
    global _installed
    with _install_lock:
        _installed = scraper
    return scraper


def get_scraper() -> Optional[FederatedScraper]:
    with _install_lock:
        return _installed
