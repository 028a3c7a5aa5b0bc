"""Observability of the port: the analytic IR cost walk (``perf``), the
metrics registry and the trace context the PS tier records into
(``registry``, ``context``, ``tracer``)."""
from .registry import Counter, Gauge, Histogram, get_registry  # noqa: F401
