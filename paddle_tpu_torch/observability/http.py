"""HTTP introspection plane: /metrics, /healthz, /debug endpoints (the
port's copy of ``paddle_tpu.observability.http``, stdlib only).

A production serving or training process needs a live scrape surface —
the reference framework deployments exported QPS/latency via external
RPC metrics and were probed by the fleet's health checker. This module
is the stdlib-only equivalent: a daemon-threaded `ThreadingHTTPServer`
(no new dependencies) exposing the process registry, step records, and
flight-recorder contents:

    GET /metrics         Prometheus text exposition (Registry.prometheus_text)
    GET /metrics.json    deep registry snapshot as JSON
    GET /metrics/series  structured series list (Registry.series) — what
                         the federation scraper consumes
    GET /fleet           one federated scrape of every process (requires
                         an installed federate.FederatedScraper; 404
                         otherwise, 503 when any target is unreachable)
    GET /alerts          501: the alert manager is ROADMAP A10
    GET /history         501: the metrics history is ROADMAP A10
    GET /healthz         named health checks, ok/degraded/failing
                         aggregation (200 for ok/degraded, 503 for failing)
    GET /debug/steps     recent StepProfiler records (?n=50 to limit)
    GET /debug/flight    flight-recorder ring + last post-mortem dump

Start explicitly with ``obs.serve_introspection(port)`` (0 = ephemeral)
or implicitly by setting ``PDTPU_INTROSPECT_PORT``: `InferenceServer.start()`
calls `maybe_serve_from_env()`, so exporting the variable is all a serving
deployment needs. The server is
process-wide and idempotent: repeat calls return the running instance.

Health checks are pluggable: ``register_health_check(name, fn)`` where
``fn() -> "ok" | (status, detail)``; the serving tier registers queue
depth / deadline-miss / worker-liveness checks, which is what makes
`InferenceServer` directly usable behind k8s liveness/readiness probes
"""
from __future__ import annotations

import http.server
import json
import logging
import os
import threading
import urllib.parse
from typing import Callable, Dict, Optional, Tuple

from . import federate
from .flight import get_flight_recorder
from .registry import get_registry
from .steps import get_step_profiler

__all__ = ["IntrospectionServer", "serve_introspection",
           "stop_introspection", "maybe_serve_from_env",
           "register_health_check", "unregister_health_check",
           "run_health_checks"]

logger = logging.getLogger("paddle_tpu_torch.observability.http")

_A10 = ("is not ported to paddle_tpu_torch yet (ROADMAP A10: the alerts "
        "and history modules)\n")

_STATUS_ORDER = {"ok": 0, "degraded": 1, "failing": 2}

_health_lock = threading.Lock()
_health_checks: Dict[str, Callable] = {}


def register_health_check(name: str, fn: Callable) -> None:
    """Add a named check to /healthz. `fn` returns ``"ok"`` /
    ``"degraded"`` / ``"failing"`` or a ``(status, detail)`` tuple; a
    raising check reports as failing with the error as detail."""
    with _health_lock:
        _health_checks[name] = fn


def unregister_health_check(name: str) -> None:
    with _health_lock:
        _health_checks.pop(name, None)


def run_health_checks() -> Tuple[str, dict]:
    """(overall, {name: {"status", "detail"}}). Aggregation: failing >
    degraded > ok; no registered checks means ok (process is up and
    answering)."""
    with _health_lock:
        checks = list(_health_checks.items())
    overall = "ok"
    detail: dict = {}
    for name, fn in checks:
        try:
            res = fn()
            if isinstance(res, tuple):
                status, info = res[0], (res[1] if len(res) > 1 else "")
            else:
                status, info = str(res), ""
            if status not in _STATUS_ORDER:
                status, info = "failing", f"bad check result {res!r}"
        except Exception as e:
            status, info = "failing", f"{type(e).__name__}: {e}"
        detail[name] = {"status": status, "detail": str(info)}
        if _STATUS_ORDER[status] > _STATUS_ORDER[overall]:
            overall = status
    return overall, detail


class _Handler(http.server.BaseHTTPRequestHandler):
    server_version = "pdtpu-introspect/1"

    def log_message(self, fmt, *args):  # route away from stderr
        logger.debug("%s %s", self.address_string(), fmt % args)

    def _send(self, code: int, body, ctype: str) -> None:
        data = body if isinstance(body, bytes) else body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_json(self, code: int, obj) -> None:
        self._send(code, json.dumps(obj, indent=2, default=str),
                   "application/json")

    def do_GET(self):  # noqa: N802 (BaseHTTPRequestHandler API)
        parsed = urllib.parse.urlparse(self.path)
        path = parsed.path.rstrip("/") or "/"
        try:
            if path == "/metrics":
                text = get_registry().prometheus_text(deep=True)
                scraper = federate.get_scraper()
                if scraper is not None and scraper.last() is not None:
                    # coordinator /metrics carries the fleet too — each
                    # federated series is distinct via its process label
                    text += scraper.prometheus_text()
                self._send(200, text,
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/metrics.json":
                self._send_json(200, get_registry().snapshot(deep=True))
            elif path == "/metrics/series":
                self._send_json(200, get_registry().series(deep=True))
            elif path == "/fleet":
                scraper = federate.get_scraper()
                if scraper is None:
                    self._send(404, "no FederatedScraper installed "
                                    "(observability.federate."
                                    "install_scraper)\n", "text/plain")
                else:
                    doc = scraper.scrape_once()
                    self._send_json(200 if doc["ok"] else 503, doc)
            elif path in ("/alerts", "/history"):
                self._send(501, f"{path} {_A10}", "text/plain")
            elif path == "/healthz":
                overall, detail = run_health_checks()
                code = 200 if overall in ("ok", "degraded") else 503
                self._send_json(code, {"status": overall, "checks": detail})
            elif path == "/debug/steps":
                qs = urllib.parse.parse_qs(parsed.query)
                n = None
                if qs.get("n"):
                    try:
                        n = int(qs["n"][0])
                    except ValueError:
                        n = None
                self._send_json(
                    200, {"records": get_step_profiler().records(n)})
            elif path == "/debug/flight":
                self._send_json(200, get_flight_recorder().contents())
            elif path == "/":
                self._send(200, "paddle_tpu_torch introspection: /metrics "
                                "/metrics.json /metrics/series /fleet "
                                "/alerts /history /healthz /debug/steps "
                                "/debug/flight\n", "text/plain")
            else:
                self._send(404, f"no such endpoint: {path}\n", "text/plain")
        except Exception as e:  # endpoint bug must not kill the server
            logger.warning("introspection handler error on %s: %s",
                           path, e)
            try:
                self._send(500, f"{type(e).__name__}: {e}\n", "text/plain")
            except Exception:
                pass


class IntrospectionServer:
    """One ThreadingHTTPServer on a daemon thread; ``port=0`` binds an
    ephemeral port (read it back from ``.port`` after start)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._host = host
        self._requested_port = int(port)
        self._server: Optional[http.server.ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "IntrospectionServer":
        if self._server is not None:
            return self
        srv = http.server.ThreadingHTTPServer(
            (self._host, self._requested_port), _Handler)
        srv.daemon_threads = True
        self._server = srv
        self._thread = threading.Thread(
            target=srv.serve_forever, name="pdtpu-introspect", daemon=True)
        self._thread.start()
        logger.info("introspection server listening on http://%s:%d",
                    self._host, self.port)
        return self

    @property
    def running(self) -> bool:
        return self._server is not None

    @property
    def port(self) -> int:
        if self._server is None:
            return self._requested_port
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def stop(self) -> None:
        srv, self._server = self._server, None
        thread, self._thread = self._thread, None
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        if thread is not None:
            thread.join(timeout=5)


_server_lock = threading.Lock()
_server: Optional[IntrospectionServer] = None


def serve_introspection(port: Optional[int] = None,
                        host: str = "127.0.0.1") -> IntrospectionServer:
    """Start (or return) the process-wide introspection server.
    ``port=None`` falls back to ``PDTPU_INTROSPECT_PORT``, then 0
    (ephemeral). Idempotent: a second call returns the running server
    regardless of the requested port."""
    global _server
    with _server_lock:
        if _server is not None and _server.running:
            return _server
        if port is None:
            port = int(os.environ.get("PDTPU_INTROSPECT_PORT", "0"))
        _server = IntrospectionServer(port=port, host=host).start()
        return _server


def stop_introspection() -> None:
    """Shut the process-wide server down (tests / clean exit)."""
    global _server
    with _server_lock:
        srv, _server = _server, None
    if srv is not None:
        srv.stop()


def maybe_serve_from_env() -> Optional[IntrospectionServer]:
    """Start the server iff ``PDTPU_INTROSPECT_PORT`` is set, as
    `InferenceServer.start()` does. No-op (returns None) when unset."""
    port = os.environ.get("PDTPU_INTROSPECT_PORT")
    if not port:
        return None
    try:
        return serve_introspection(int(port))
    except (ValueError, OSError) as e:
        logger.warning("PDTPU_INTROSPECT_PORT=%r: cannot start "
                       "introspection server: %s", port, e)
        return None
