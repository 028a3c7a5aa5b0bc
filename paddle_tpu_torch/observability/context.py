"""Trace context: the identity of a training step's spans.

A `TraceContext` is three ids — ``trace_id`` (the whole step),
``span_id`` (the current operation), ``parent_id`` (the operation that
caused it) — plus nothing else: no baggage, no sampling flags. The active
context is thread-local.

The port's copy of the part of ``paddle_tpu.observability.context`` that
the tracer uses (stdlib only). The RPC header encoding and the thread-hop
helper come with the socket transport, whose server spans read them.
"""
from __future__ import annotations

import os
import threading

from typing import Optional

__all__ = ["TraceContext", "current", "new_trace"]


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

    def args(self) -> dict:
        """Chrome-trace ``args`` fields."""
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
