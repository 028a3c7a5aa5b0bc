"""Serving metrics: a per-server view onto the shared telemetry Registry.

Reference analog: the reference framework's serving deployments counted
QPS and latency outside the framework (Paddle Serving's grpc metrics);
here the registry is in-process so the batcher/server can account every
request, batch, rejection, and timeout at the exact point it happens.

The metric primitives (`Counter`/`Gauge`/`Histogram`) and the registry
machinery live in ``observability.registry``: one implementation shared by
the executor, the serving tier, and user code. `Metrics` stays the serving
public API: an instance-scoped registry (two servers in one process keep
separate request counts) that ATTACHES itself to the process-wide
registry, so ``observability.get_registry().snapshot()`` shows serving
latency next to executor cache/compile metrics in one export, and
`InferenceServer.stats()` can surface the unified view.

Histogram snapshot/percentile reads are copy-on-read under the metric's
lock (the ring is copied before any sorting), so concurrent `observe()`
calls from serve workers can never corrupt a dashboard read.
"""
from __future__ import annotations

from ..observability.registry import (Counter, Gauge, Histogram,  # noqa: F401
                                      Registry, get_registry)

__all__ = ["Counter", "Gauge", "Histogram", "Metrics"]


class Metrics(Registry):
    """Instance-scoped metric registry for one server/batcher.

    Metrics are created on first use so the hot path never needs
    None-checks. By default the instance attaches to the process-wide
    registry (`observability.get_registry()`) as a child — weakly held,
    so a dropped server's metrics leave the global export automatically.
    Pass ``attach=False`` for a fully isolated registry.
    """

    def __init__(self, attach: bool = True):
        super().__init__()
        if attach:
            get_registry().attach(self)
