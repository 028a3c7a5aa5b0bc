"""Alert lifecycle engine: pending → firing → resolved, with sinks.

`slo.SloEngine` decides *whether* a condition is breached each sweep;
this module owns everything that happens after: the per-alert state
machine (a condition must hold for ``for_s`` before it pages, a resolved
alert lingers ``resolved_hold_s`` so operators see what just cleared),
fan-out to pluggable sinks (JSONL file, webhook POST, or a plain
callable — the callable sink is the autoscaler's hook),
``ALERTS{alertname,severity,alertstate}`` exposition series in the
Prometheus convention, a ``/alerts`` introspection document, an
``alerts`` health check (degraded while a warn-severity alert fires,
failing on page severity), and an alert-triggered `FlightRecorder`
post-mortem dump so every page ships its own forensics.

The manager is deliberately dumb about *what* it is alerting on: `update`
takes (name, severity, labels, active) and nothing else drives state.
That keeps it reusable for hand-rolled conditions (tests, operators)
alongside the SLO engine, and makes the state machine testable with an
injected clock (`now=`).

The port's copy of ``paddle_tpu.observability.alerts``, stdlib only.
"""
from __future__ import annotations

import collections
import json
import threading
import time
import urllib.request
from typing import Callable, Dict, List, Optional

from .flight import get_flight_recorder
from .registry import Registry, get_registry
from .tracer import get_tracer

__all__ = ["Alert", "AlertManager", "AlertFiringError", "FileSink",
           "WebhookSink", "install_alert_manager", "get_alert_manager"]

Registry.describe(
    "ALERTS", "1 for every live alert; labels alertname/severity/"
    "alertstate plus the alert's own labels (Prometheus convention)")
Registry.describe(
    "alerts/sink_errors", "alert sink deliveries that raised (the event "
    "is dropped for that sink only)")
Registry.describe(
    "alerts/transitions", "alert state-machine transitions, by to-state")


class AlertFiringError(Exception):
    """Never raised — the synthetic 'exception' a firing alert hands to
    `FlightRecorder.record_failure` so the page's post-mortem dump rides
    the existing forensics pipeline."""


def _label_items(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Alert:
    """One live alert instance: (name, severity, labels) plus lifecycle
    timestamps. State is one of pending / firing / resolved."""

    __slots__ = ("name", "severity", "labels", "state", "since",
                 "pending_at", "fired_at", "resolved_at", "value",
                 "annotations", "dump_path")

    def __init__(self, name: str, severity: str, labels: dict, now: float):
        self.name = name
        self.severity = severity
        self.labels = dict(labels)
        self.state = "pending"
        self.since = now          # start of the current condition episode
        self.pending_at = now
        self.fired_at: Optional[float] = None
        self.resolved_at: Optional[float] = None
        self.value: Optional[float] = None
        self.annotations: dict = {}
        self.dump_path: Optional[str] = None

    def doc(self) -> dict:
        return {"name": self.name, "severity": self.severity,
                "labels": dict(self.labels), "state": self.state,
                "since": self.since, "pending_at": self.pending_at,
                "fired_at": self.fired_at, "resolved_at": self.resolved_at,
                "value": self.value, "annotations": dict(self.annotations),
                "dump_path": self.dump_path}


class FileSink:
    """Append one JSON line per alert event (fire/resolve) to `path`."""

    def __init__(self, path: str):
        self.path = str(path)
        self._lock = threading.Lock()

    def __call__(self, event: dict) -> None:
        line = json.dumps(event, default=str)
        with self._lock:
            with open(self.path, "a") as f:
                f.write(line + "\n")


class WebhookSink:
    """POST each alert event as JSON to `url` (stdlib urllib; short
    timeout so a dead receiver cannot stall the sweep)."""

    def __init__(self, url: str, timeout: float = 2.0):
        self.url = str(url)
        self.timeout = float(timeout)

    def __call__(self, event: dict) -> None:
        data = json.dumps(event, default=str).encode("utf-8")
        req = urllib.request.Request(
            self.url, data=data,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=self.timeout):
            pass


class AlertManager:
    """The state machine + fan-out. One instance per process (installed
    via `install_alert_manager`); the SLO engine calls `update` for each
    compiled rule every sweep.

    Transitions (evaluated inside `update`, clock injectable via `now`):

        (absent)  --active-->  pending   (condition seen, not yet for_s)
        pending   --for_s-->   firing    (sinks notified; page-severity
                                          alerts also write a flight dump)
        pending   --clear-->   (removed silently — never fired)
        firing    --clear-->   resolved  (sinks notified)
        resolved  --active-->  firing    (re-fire, same episode record)
        resolved  --hold-->    (removed after resolved_hold_s)

    ``for_s=0`` fires on the first active update — the bench chaos cell
    relies on this to page within two scrape sweeps.
    """

    def __init__(self, for_s: float = 0.0, resolved_hold_s: float = 300.0,
                 sinks=(), flight_dump_severities=("page",),
                 registry: Optional[Registry] = None):
        self.for_s = float(for_s)
        self.resolved_hold_s = float(resolved_hold_s)
        self.flight_dump_severities = tuple(flight_dump_severities)
        self._sinks: List[Callable[[dict], None]] = list(sinks)
        self._enrichers: List[Callable[[Alert], Optional[dict]]] = []
        self._lock = threading.Lock()
        self._alerts: Dict[tuple, Alert] = {}
        self._recent: collections.deque = collections.deque(maxlen=256)
        self._reg = registry if registry is not None else get_registry()
        self._c_sink_err = self._reg.counter("alerts/sink_errors")

    # ------------------------------------------------------------- sinks
    def add_sink(self, sink: Callable[[dict], None]) -> Callable:
        """Register a callable receiving every fire/resolve event dict.
        This is the autoscaler's subscription point:
        an actuator passes a callback here and keys on
        ``event["name"]`` / ``event["labels"]``."""
        self._sinks.append(sink)
        return sink

    def add_enricher(self, fn: Callable[[Alert], Optional[dict]]) -> Callable:
        """Register a callable receiving every newly-FIRING Alert before
        sinks and the flight dump run: a returned dict merges into the
        alert's annotations, so the firing event ships with it. This is
        how the ProfileTrigger attaches culprit kernels + the /history
        window to a page (root-cause loop); enricher exceptions are
        swallowed — attribution is best-effort, paging is not."""
        self._enrichers.append(fn)
        return fn

    def _emit(self, event: dict) -> None:
        self._recent.append(dict(event))
        for sink in list(self._sinks):
            try:
                sink(dict(event))
            except Exception:
                self._c_sink_err.inc()

    # ------------------------------------------------------- state machine
    def update(self, name: str, active: bool, severity: str = "page",
               labels: Optional[dict] = None, value: Optional[float] = None,
               annotations: Optional[dict] = None,
               now: Optional[float] = None) -> Optional[Alert]:
        """Advance one alert's state machine with the condition's current
        truth value. Returns the live Alert (None once removed).
        Sink delivery and flight dumps happen after the lock is
        released, so a slow webhook cannot stall concurrent updates and
        a sink may safely call back into the manager."""
        now = time.monotonic() if now is None else float(now)
        labels = dict(labels or {})
        key = (name, severity, _label_items(labels))
        fired: Optional[Alert] = None
        events: List[dict] = []
        went_pending = False
        with self._lock:
            a = self._alerts.get(key)
            if a is None and active:
                a = Alert(name, severity, labels, now)
                self._alerts[key] = a
                self._set_state_gauge(a, None)
                self._reg.counter("alerts/transitions", to="pending").inc()
                went_pending = True
            if a is not None:
                if value is not None:
                    a.value = value
                if annotations:
                    a.annotations.update(annotations)
                if active:
                    if (a.state == "pending"
                            and now - a.pending_at >= self.for_s):
                        self._fire_locked(a, now, events)
                        fired = a
                    elif a.state == "resolved":
                        # condition came back while we held the resolved
                        # record: re-fire the same episode
                        a.resolved_at = None
                        self._fire_locked(a, now, events)
                        fired = a
                else:
                    if a.state == "pending":
                        # never fired: vanish silently
                        self._remove_locked(key, a)
                    elif a.state == "firing":
                        prev = a.state
                        a.state = "resolved"
                        a.resolved_at = now
                        self._set_state_gauge(a, prev)
                        self._reg.counter("alerts/transitions",
                                          to="resolved").inc()
                        events.append(self._event(a, "resolved", now))
            self._prune_locked(now)
            live = self._alerts.get(key)
        # alert timeline in merged fleet traces: one instant per state
        # transition, right next to the spans that explain it
        tracer = get_tracer()
        if went_pending:
            tracer.instant("alerts/pending",
                           {"alert": name, "severity": severity})
        for ev in events:
            tracer.instant(f"alerts/{ev['event']}",
                           {"alert": ev["name"],
                            "severity": ev["severity"]})
        if fired is not None and self._enrichers:
            # root-cause enrichment BEFORE the dump and the sinks, so
            # both carry the attribution
            for fn in list(self._enrichers):
                try:
                    extra = fn(fired)
                except Exception:
                    extra = None
                if extra:
                    fired.annotations.update(extra)
            for ev in events:
                if ev["event"] == "firing" and ev["name"] == fired.name:
                    ev["annotations"] = dict(fired.annotations)
        if (fired is not None
                and fired.severity in self.flight_dump_severities
                and fired.dump_path is None):
            fired.dump_path = self._flight_dump(fired)
            for ev in events:
                if ev["event"] == "firing" and ev["name"] == fired.name:
                    ev["dump_path"] = fired.dump_path
        for ev in events:
            self._emit(ev)
        return live

    def _fire_locked(self, a: Alert, now: float, events: List[dict]) -> None:
        prev = a.state
        a.state = "firing"
        a.fired_at = now
        self._set_state_gauge(a, prev)
        self._reg.counter("alerts/transitions", to="firing").inc()
        events.append(self._event(a, "firing", now))

    def _flight_dump(self, a: Alert) -> Optional[str]:
        """Every page ships its own post-mortem: reuse the OOM forensics
        pipeline with a synthetic exception naming the alert."""
        try:
            exc = AlertFiringError(
                f"alert {a.name} firing (severity={a.severity}, "
                f"labels={a.labels})")
            return get_flight_recorder().record_failure(exc, context={
                "where": "alerts", "alert": a.name,
                "severity": a.severity, "labels": dict(a.labels),
                "value": a.value, "annotations": dict(a.annotations)})
        except Exception:
            return None

    def _event(self, a: Alert, what: str, now: float) -> dict:
        return {"event": what, "t": now, "wall_t": time.time(),
                "name": a.name, "severity": a.severity,
                "labels": dict(a.labels), "value": a.value,
                "annotations": dict(a.annotations),
                "since": a.since, "dump_path": a.dump_path}

    # ----------------------------------------------------- ALERTS series
    def _alerts_labels(self, a: Alert, state: str) -> dict:
        out = dict(a.labels)
        out.update(alertname=a.name, severity=a.severity, alertstate=state)
        return out

    def _set_state_gauge(self, a: Alert, prev_state: Optional[str]) -> None:
        if prev_state is not None:
            self._reg.remove("ALERTS", **self._alerts_labels(a, prev_state))
        self._reg.gauge("ALERTS", **self._alerts_labels(a, a.state)).set(1)

    def _remove_locked(self, key: tuple, a: Alert) -> None:
        self._reg.remove("ALERTS", **self._alerts_labels(a, a.state))
        self._alerts.pop(key, None)

    def _prune_locked(self, now: float) -> None:
        for key, a in list(self._alerts.items()):
            if (a.state == "resolved" and a.resolved_at is not None
                    and now - a.resolved_at >= self.resolved_hold_s):
                self._remove_locked(key, a)

    # ------------------------------------------------------- introspection
    def alerts(self, state: Optional[str] = None,
               severity: Optional[str] = None) -> List[Alert]:
        with self._lock:
            out = list(self._alerts.values())
        if state is not None:
            out = [a for a in out if a.state == state]
        if severity is not None:
            out = [a for a in out if a.severity == severity]
        return out

    def firing(self, severity: Optional[str] = None) -> List[Alert]:
        return self.alerts(state="firing", severity=severity)

    def recent_events(self, n: int = 64) -> List[dict]:
        """Most recent fire/resolve events, oldest first — the alert
        timeline `tools/postmortem.py` bundles."""
        out = list(self._recent)
        return out[-int(n):] if n else out

    def doc(self) -> dict:
        """The ``/alerts`` endpoint document."""
        with self._lock:
            alerts = [a.doc() for a in self._alerts.values()]
        order = {"firing": 0, "pending": 1, "resolved": 2}
        alerts.sort(key=lambda d: (order.get(d["state"], 9), d["name"]))
        return {"alerts": alerts,
                "firing": sum(1 for d in alerts if d["state"] == "firing"),
                "pending": sum(1 for d in alerts if d["state"] == "pending"),
                "resolved": sum(
                    1 for d in alerts if d["state"] == "resolved"),
                "recent_events": self.recent_events(32)}

    def health_check(self):
        """/healthz ``alerts`` check: failing while any page-severity
        alert fires, degraded for any other firing severity."""
        firing = self.firing()
        if not firing:
            return "ok"
        names = ",".join(sorted({a.name for a in firing}))
        if any(a.severity == "page" for a in firing):
            return ("failing", f"page alerts firing: {names}")
        return ("degraded", f"alerts firing: {names}")

    def clear(self) -> None:
        """Drop every live alert and its ALERTS series (tests)."""
        with self._lock:
            for key, a in list(self._alerts.items()):
                self._remove_locked(key, a)


# process-wide manager: what /alerts and the healthz check answer from
_installed: Optional[AlertManager] = None
_install_lock = threading.Lock()


def install_alert_manager(mgr: Optional[AlertManager]):
    """Make `mgr` the process-wide alert manager: the ``/alerts``
    endpoint serves its `doc()` and /healthz gains the ``alerts`` check.
    None uninstalls both. Returns the manager."""
    global _installed
    from .http import register_health_check, unregister_health_check
    with _install_lock:
        _installed = mgr
    if mgr is None:
        unregister_health_check("alerts")
    else:
        register_health_check("alerts", mgr.health_check)
    return mgr


def get_alert_manager() -> Optional[AlertManager]:
    with _install_lock:
        return _installed
