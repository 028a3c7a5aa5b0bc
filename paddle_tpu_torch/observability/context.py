"""Distributed trace context: the identity a request carries across
process boundaries.

A `TraceContext` is three ids — ``trace_id`` (the whole request),
``span_id`` (the current operation), ``parent_id`` (the operation that
caused it) — plus nothing else: no baggage, no sampling flags. It rides
the existing JSON header of the PS wire protocol and the fleet worker
RPC as a ``"trace"`` dict (``{"trace_id", "span_id"}``, plus
``"retry": n`` on re-sent frames), so propagation costs one small dict
per RPC and zero new dependencies.

The active context is thread-local. Crossing an explicit thread hop
(pool fan-out in `ShardedTable`, the serving batcher queue, a replica's
RPC pool) requires capturing `current()` on the submitting thread and
re-activating it with `use(ctx)` on the worker thread — thread-locals
don't follow work items on their own, and the hop points in this
codebase each do so explicitly.

The port's copy of ``paddle_tpu.observability.context`` (stdlib only).
"""
from __future__ import annotations

import os
import threading

from typing import Optional

__all__ = ["TraceContext", "current", "use", "new_trace", "from_wire"]


def _new_id() -> str:
    return os.urandom(8).hex()


class TraceContext:
    """Immutable (trace_id, span_id, parent_id) triple."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id: str, span_id: Optional[str] = None,
                 parent_id: Optional[str] = None):
        self.trace_id = str(trace_id)
        self.span_id = str(span_id) if span_id else _new_id()
        self.parent_id = str(parent_id) if parent_id else None

    def child(self) -> "TraceContext":
        """A new span in the same trace, parented to this one."""
        return TraceContext(self.trace_id, _new_id(), self.span_id)

    def to_wire(self) -> dict:
        """The RPC header payload. Deliberately minimal: the receiver
        only needs the trace and the sender's span to parent to."""
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    def args(self) -> dict:
        """Chrome-trace ``args`` fields — what the fleet timeline merger
        keys on to pair client and server spans."""
        a = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_id:
            a["parent_id"] = self.parent_id
        return a

    def __repr__(self):
        return (f"TraceContext(trace={self.trace_id} span={self.span_id} "
                f"parent={self.parent_id})")


def new_trace() -> TraceContext:
    """Root context for a fresh trace (no parent)."""
    return TraceContext(os.urandom(16).hex(), _new_id(), None)


def from_wire(wire) -> Optional[TraceContext]:
    """Server-side adoption of an incoming ``"trace"`` header: a FRESH
    span in the sender's trace, parented to the sender's span. Returns
    None for absent/malformed headers — tracing is best-effort and must
    never fail an RPC."""
    if not isinstance(wire, dict):
        return None
    tid, sid = wire.get("trace_id"), wire.get("span_id")
    if not (isinstance(tid, str) and tid and isinstance(sid, str) and sid):
        return None
    return TraceContext(tid, _new_id(), sid)


# -- thread-local active context ------------------------------------------

_tls = threading.local()


def current() -> Optional[TraceContext]:
    """The context active on this thread, or None."""
    return getattr(_tls, "ctx", None)


def _activate(ctx: Optional[TraceContext]):
    """Set `ctx` as this thread's active context; returns a token for
    `_restore`. Activating None is a no-op that still returns a token."""
    prev = getattr(_tls, "ctx", None)
    if ctx is not None:
        _tls.ctx = ctx
    return (ctx is not None, prev)


def _restore(token) -> None:
    changed, prev = token
    if changed:
        _tls.ctx = prev


class use:
    """``with use(ctx):`` — activate a captured context on this thread
    (the thread-hop idiom). ``use(None)`` is a no-op, so call sites
    don't need to branch on whether a trace is active."""

    __slots__ = ("_ctx", "_token")

    def __init__(self, ctx: Optional[TraceContext]):
        self._ctx = ctx
        self._token = None

    def __enter__(self):
        self._token = _activate(self._ctx)
        return self._ctx

    def __exit__(self, *exc):
        _restore(self._token)
        self._token = None
        return False
