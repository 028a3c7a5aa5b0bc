"""Observability of the port: the analytic IR cost walk (``perf``), the
metrics registry and the trace context the PS tier and the executor record
into (``registry``, ``context``, ``tracer``), and the executor's step
records, re-prepare watchdog and flight recorder (``steps``, ``watchdog``,
``flight``)."""
from .registry import Counter, Gauge, Histogram, get_registry  # noqa: F401
