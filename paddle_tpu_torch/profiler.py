"""Profiler surface (counterpart of ``paddle_tpu.profiler``).

Reference analog: ``python/paddle/fluid/profiler.py`` over the C++
RecordEvent/DeviceTracer stack (platform/profiler.h:166). ``record_event``
is ported: a named region that shows in ``torch.profiler`` traces and in the
host tracer's chrome-trace export alike. The session API (``profiler``,
``start_profiler``/``stop_profiler``, ``op_profiler``, ``cuda_profiler``,
``reset_profiler``) raises ``NotImplementedError``: it moves onto
``torch.profiler`` with ROADMAP A10.
"""
from __future__ import annotations

import contextlib

__all__ = ["record_event", "profiler", "start_profiler", "stop_profiler",
           "op_profiler", "cuda_profiler", "reset_profiler"]


@contextlib.contextmanager
def record_event(name: str, **args):
    """RecordEvent RAII parity (platform/profiler.h:81): a
    ``torch.profiler.record_function`` range (visible beside the device
    kernels it launches in a ``torch.profiler`` trace) AND a host span in
    `observability.get_tracer()`. Extra kwargs become chrome-trace span
    args."""
    import torch

    from .observability.tracer import trace_span

    with trace_span(name, **args), torch.profiler.record_function(name):
        yield


def _not_ported(what):
    def fn(*a, **kw):
        raise NotImplementedError(
            f"profiler.{what} is not ported to paddle_tpu_torch yet "
            f"(ROADMAP A10: the profiler session API on torch.profiler); "
            f"profiler.record_event is")
    fn.__name__ = what
    return fn


profiler = _not_ported("profiler")
start_profiler = _not_ported("start_profiler")
stop_profiler = _not_ported("stop_profiler")
op_profiler = _not_ported("op_profiler")
cuda_profiler = _not_ported("cuda_profiler")
reset_profiler = _not_ported("reset_profiler")
