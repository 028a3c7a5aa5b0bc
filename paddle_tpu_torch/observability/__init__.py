"""Observability of the port: the analytic IR cost walk (``perf``), the
metrics registry with its Prometheus and series exports (``registry``), the
trace context and its RPC header (``context``), the host tracer
(``tracer``), the executor's step records, re-prepare watchdog and flight
recorder (``steps``, ``watchdog``, ``flight``), and the introspection plane:
health checks and the stdlib HTTP server (``http``) with fleet-wide
federation (``federate``)."""
from . import context  # noqa: F401
from . import federate  # noqa: F401
from .context import TraceContext  # noqa: F401
from .federate import (FederatedScraper, ScrapeTarget,  # noqa: F401
                       get_scraper, install_scraper)
from .http import (IntrospectionServer, maybe_serve_from_env,  # noqa: F401
                   register_health_check, run_health_checks,
                   serve_introspection, stop_introspection,
                   unregister_health_check)
from .registry import (Counter, Gauge, Histogram, Registry,  # noqa: F401
                       get_registry, render_prometheus)
from .tracer import (Tracer, get_tracer, server_span,  # noqa: F401
                     start_trace, trace_span)
