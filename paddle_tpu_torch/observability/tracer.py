"""Host-side span tracer with chrome-trace export — the part of
``paddle_tpu.observability.tracer`` the PS tier and the executor use
(stdlib only).

Wall-clock spans recorded per thread as B/E (begin/end) event pairs,
exported as chrome-trace JSON that loads in chrome://tracing or
https://ui.perfetto.dev. Device time is ``torch.profiler``'s, not this
module's. The tier roots one trace per training step (``start_trace
("ps/train_step")``); an operator who wants the host timeline of a run
turns the tracer on and exports it::

    from paddle_tpu_torch.observability.tracer import get_tracer

    get_tracer().enabled = True
    ...                                   # tier.run_step(...) a few times
    get_tracer().export_chrome_trace("host_trace.json")

``trace_span`` is a context manager and a decorator (``@trace_span
("load_batch")``: one span per call). The tracer starts disabled, and a
disabled span is a no-op: no event, no
trace context. Enabled, a span costs one ``perf_counter`` call and one
lock-protected list append at each end. While a `context.TraceContext` is
active on the thread, a span derives a child context for its duration and
stamps ``trace_id``/``span_id``/``parent_id`` into its args.
"""
from __future__ import annotations

import functools
import json
import os
import threading
import time
from typing import Dict, List, Optional

from . import context as _ctx

__all__ = ["Tracer", "get_tracer", "trace_span", "start_trace",
           "server_span"]

# one process-wide timebase so spans from every thread share a clock;
# chrome trace wants microseconds
_T0 = time.perf_counter()


def _now_us() -> float:
    return (time.perf_counter() - _T0) * 1e6


class Tracer:
    """Collects completed span events; bounded so an unobserved long-running
    process cannot grow without limit (past `max_events` new events are
    dropped and counted in `dropped`)."""

    def __init__(self, max_events: int = 200_000):
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._thread_names: Dict[int, str] = {}
        self.max_events = int(max_events)
        self.dropped = 0
        self.enabled = False
        self.process_name = "paddle_tpu_torch host"

    def _emit(self, ev: dict) -> None:
        tid = ev["tid"]
        with self._lock:
            if tid not in self._thread_names:
                self._thread_names[tid] = threading.current_thread().name
            if len(self._events) >= self.max_events:
                self.dropped += 1
                return
            self._events.append(ev)

    def begin(self, name: str, args: Optional[dict] = None) -> None:
        ev = {"name": name, "ph": "B", "ts": _now_us(),
              "pid": os.getpid(), "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        self._emit(ev)

    def end(self, name: str) -> None:
        self._emit({"name": name, "ph": "E", "ts": _now_us(),
                    "pid": os.getpid(), "tid": threading.get_ident()})

    def instant(self, name: str, args: Optional[dict] = None) -> None:
        """One timestamped marker (chrome-trace 'i' event)."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "i", "s": "t", "ts": _now_us(),
              "pid": os.getpid(), "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        self._emit(ev)

    def export_chrome_trace(self, path: Optional[str] = None) -> dict:
        """Chrome-trace JSON object ({"traceEvents": [...]}); written to
        `path` when given."""
        with self._lock:
            events = list(self._events)
            names = dict(self._thread_names)
        pid = os.getpid()
        meta: List[dict] = [
            {"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": self.process_name}}]
        for tid, tname in sorted(names.items()):
            meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                         "tid": tid, "args": {"name": tname}})
        trace = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(trace, f)
        return trace

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._thread_names.clear()
            self.dropped = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


_tracer = Tracer()


def get_tracer() -> Tracer:
    """The process-wide host tracer every `trace_span` records into."""
    return _tracer


class trace_span:
    """``with trace_span(name, **args):`` (or ``@trace_span(name)`` on a
    function) records one named wall-clock span; keyword arguments become
    chrome-trace `args`. The end event is
    emitted even when the body raises. Under an active `TraceContext` the
    span is a child span of it."""

    __slots__ = ("name", "args", "_entered", "_ctx_token")

    def __init__(self, name: str, **args):
        self.name = name
        self.args = args or None
        self._entered = False
        self._ctx_token = None

    def _span_ctx(self):
        """The context this span records under, or None."""
        parent = _ctx.current()
        return parent.child() if parent is not None else None

    def __enter__(self):
        t = _tracer
        if t.enabled:
            ctx = self._span_ctx()
            args = self.args
            if ctx is not None:
                self._ctx_token = _ctx._activate(ctx)
                args = dict(args) if args else {}
                args.update(ctx.args())
            self._entered = True
            t.begin(self.name, args)
        return self

    def __exit__(self, *exc):
        if self._entered:
            self._entered = False
            _tracer.end(self.name)
        if self._ctx_token is not None:
            _ctx._restore(self._ctx_token)
            self._ctx_token = None
        return False

    def __call__(self, fn):
        name, args, cls = self.name, self.args or {}, type(self)

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with cls(name, **args):
                return fn(*a, **kw)

        return wrapper


class start_trace(trace_span):
    """Root span of a new trace: activates a fresh `TraceContext` (new
    trace_id, no parent) for the span's duration, so every span beneath it
    shares one trace_id. Under an active trace it is a plain child span."""

    __slots__ = ()

    def _span_ctx(self):
        parent = _ctx.current()
        return parent.child() if parent is not None else _ctx.new_trace()


class server_span(trace_span):
    """Server-side RPC span: adopts the ``"trace"`` header dict of an
    incoming frame (`context.from_wire`), parenting this process's span to
    the client's RPC span. With no or a malformed header it records as a
    plain local span::

        with server_span(f"serve/{op}", msg.get("trace"), op=op):
            reply = handle(op, msg)
    """

    __slots__ = ("_wire",)

    def __init__(self, name: str, wire, **args):
        super().__init__(name, **args)
        self._wire = wire

    def _span_ctx(self):
        ctx = _ctx.from_wire(self._wire)
        if ctx is None:
            return super()._span_ctx()
        return ctx
