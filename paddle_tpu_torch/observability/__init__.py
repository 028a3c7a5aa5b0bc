"""paddle_tpu_torch.observability — runtime telemetry of the port.

Counterpart of ``paddle_tpu.observability``:

- **Registry** (registry.py) — process-wide counters / gauges /
  histograms with Prometheus and JSON exports; serving registries attach
  as children.
- **trace_span / Tracer** (tracer.py) — host-side spans exported as
  chrome-trace JSON; device time is ``torch.profiler``'s
  (``paddle_tpu_torch.profiler``), and ``tools.timeline`` merges both.
- **RecompileWatchdog / StepProfiler / FlightRecorder** (watchdog.py,
  steps.py, flight.py) — plan-cache misses, one record a dispatch with a
  straggler detector, and the crash-forensics ring.
- **Calibration / CostLedger** (calibrate.py, perf.py, kernel_counts.py)
  — the card's measured floors, what each plan's dispatch costs (counted
  aten ops plus the hand kernels' declared launches), and the live
  ``perf/mfu`` / ``perf/roofline_fraction`` gauges.
- **IntrospectionServer / FederatedScraper** (http.py, federate.py) —
  ``/metrics``, ``/healthz``, ``/debug/*``, ``/alerts``, ``/history``,
  ``/fleet``.
- **SloEngine / AlertManager** (slo.py, alerts.py) — burn-rate SLOs over
  the federated sweep and the pending→firing→resolved alert machine with
  sinks and page-time flight dumps.
- **MetricsHistory / ProfileTrigger** (history.py, profile_trigger.py) —
  the root-cause loop: a bounded ring TSDB of every sweep, and an
  anomaly-triggered ``torch.profiler`` capture diffed per kernel against a
  golden, whose culprits enrich the page. ``tools.postmortem`` bundles it.

Quick start::

    from paddle_tpu_torch import observability as obs

    with obs.trace_span("train/epoch", epoch=e):
        exe.run(main, feed=..., fetch_list=[loss])

    print(obs.get_registry().report())
"""
from . import calibrate  # noqa: F401
from . import context  # noqa: F401
from . import federate  # noqa: F401
from . import perf  # noqa: F401
from .alerts import (Alert, AlertFiringError, AlertManager,  # noqa: F401
                     FileSink, WebhookSink, get_alert_manager,
                     install_alert_manager)
from .calibrate import Calibration, get_calibration  # noqa: F401
from .context import TraceContext  # noqa: F401
from .federate import (FederatedScraper, ScrapeTarget,  # noqa: F401
                       get_scraper, install_scraper)
from .flight import (FlightRecorder, get_flight_recorder,  # noqa: F401
                     is_oom, register_dump_section,
                     unregister_dump_section)
from .history import (MetricsHistory, get_history,  # noqa: F401
                      install_history)
from .http import (IntrospectionServer, maybe_serve_from_env,  # noqa: F401
                   register_health_check, run_health_checks,
                   serve_introspection, stop_introspection,
                   unregister_health_check)
from .memory import (device_memory_stats,  # noqa: F401
                     per_device_state_bytes, record_state_memory)
from .perf import CostLedger, ProgramCost, attribute, get_ledger  # noqa: F401
from .profile_trigger import (ProfileTrigger, get_trigger,  # noqa: F401
                              golden_path, install_trigger,
                              record_golden)
from .registry import (Counter, Gauge, Histogram, Registry,  # noqa: F401
                       get_registry, render_prometheus)
from .slo import (BURN_RATE_WINDOWS, SloEngine, SloSpec,  # noqa: F401
                  default_slos)
from .steps import StepProfiler, get_step_profiler  # noqa: F401
from .tracer import (Tracer, get_tracer, server_span,  # noqa: F401
                     start_trace, trace_span)
from .watchdog import (RecompileWarning, RecompileWatchdog,  # noqa: F401
                       diff_signatures, get_watchdog)

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "get_registry",
    "render_prometheus",
    "Calibration", "get_calibration", "calibrate",
    "CostLedger", "ProgramCost", "attribute", "get_ledger", "perf",
    "TraceContext", "context",
    "FederatedScraper", "ScrapeTarget", "install_scraper", "get_scraper",
    "device_memory_stats", "per_device_state_bytes", "record_state_memory",
    "Tracer", "get_tracer", "trace_span", "start_trace", "server_span",
    "RecompileWarning", "RecompileWatchdog", "diff_signatures",
    "get_watchdog",
    "FlightRecorder", "get_flight_recorder", "is_oom",
    "register_dump_section", "unregister_dump_section",
    "StepProfiler", "get_step_profiler",
    "IntrospectionServer", "serve_introspection", "stop_introspection",
    "maybe_serve_from_env", "register_health_check",
    "unregister_health_check", "run_health_checks",
    "SloSpec", "SloEngine", "default_slos", "BURN_RATE_WINDOWS",
    "Alert", "AlertManager", "AlertFiringError", "FileSink",
    "WebhookSink", "install_alert_manager", "get_alert_manager",
    "MetricsHistory", "install_history", "get_history",
    "ProfileTrigger", "install_trigger", "get_trigger",
    "golden_path", "record_golden",
]
