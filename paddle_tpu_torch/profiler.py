"""Profiler surface (counterpart of ``paddle_tpu.profiler``).

Reference analog: ``python/paddle/fluid/profiler.py`` (profiler()
contextmanager, start/stop_profiler) over the C++ RecordEvent/DeviceTracer
CUPTI stack (platform/profiler.h:166), exported to chrome://tracing by
tools/timeline.py.

Here a session is one ``torch.profiler.profile`` (host ops, plus the
card's kernels, copies and sets when the card is there) that writes a
chrome trace, ``<host>_<pid>_<ms>.pt.trace.json``, under its log dir;
``python -m paddle_tpu_torch.tools.roofline DIR`` tabulates it per kernel
and ``tools.timeline`` merges and summarizes it. While a session runs the
hand kernels' wrappers declare each launch's flops and bytes
(``observability.kernel_counts``); the session writes them beside the
trace (``*.pt.declared.json``), where the roofline join reads them.

One session can run in a process (Kineto's limit): `start_profiler`,
`profiler()`, the calibration's microbenches and the profile trigger's
captures share one guard, and a second start raises "already active"
instead of clobbering the session. `record_event` marks a named region in
the trace and in the host tracer alike. `op_profiler` (per-op eager
timings) patches the dygraph tracer (``dygraph/tracer.py``) and exports its
table to the registry.
"""
from __future__ import annotations

import contextlib
import json
import os
import socket
import tempfile
import threading
import time
from collections import defaultdict
from typing import Optional

__all__ = ["record_event", "profiler", "start_profiler", "stop_profiler",
           "op_profiler", "cuda_profiler", "reset_profiler",
           "export_op_profile", "DECLARED_SUFFIX"]

DECLARED_SUFFIX = ".pt.declared.json"

_active: dict = {}
_lock = threading.Lock()


def _default_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "paddle_tpu_torch_profile")


def _claim(owner: str, log_dir: Optional[str]) -> None:
    with _lock:
        if _active.get("owner") is not None:
            where = (f"writing to {_active['dir']!r}"
                     if _active.get("dir") else f"held by {_active['owner']}")
            raise RuntimeError(
                f"start_profiler: a profiling session is already active "
                f"({where}) — nested profiler()/start_profiler calls are "
                f"not supported; stop_profiler() first. For cheap "
                f"always-on host spans inside a profiled region use "
                f"observability.trace_span instead.")
        _active["owner"] = owner
        _active["dir"] = log_dir


def _release() -> dict:
    with _lock:
        state = dict(_active)
        _active.clear()
    return state


def busy() -> bool:
    """True while a session (any owner) holds the profiler."""
    with _lock:
        return _active.get("owner") is not None


@contextlib.contextmanager
def _guard(owner: str):
    """Hold the one-session guard around a profiler run of the port's own
    (calibration, a kernel-table capture)."""
    _claim(owner, None)
    try:
        yield
    finally:
        _release()


class Session:
    """One ``torch.profiler`` session writing under `log_dir`: the chrome
    trace and the hand kernels' declared counts. Not guarded by itself:
    `start_profiler` and the profile trigger claim the guard first."""

    def __init__(self, log_dir: str, cuda: Optional[bool] = None,
                 all_threads: bool = False):
        import torch

        self.log_dir = log_dir
        # host ops of every thread, not only the starting one's (a capture
        # started on a helper thread must see the trainer's ops)
        self.all_threads = bool(all_threads)
        if cuda is None:
            cuda = torch.cuda.is_available()
        self.cuda = bool(cuda)
        self.trace_path: Optional[str] = None
        self._prof = None
        self._collect = None
        self.declared = None   # the hand kernels' declarations meanwhile

    def start(self) -> "Session":
        import torch
        from torch.profiler import ProfilerActivity, profile

        from .observability import kernel_counts

        os.makedirs(self.log_dir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self._collect = kernel_counts.collect()
        self.declared = self._collect.__enter__()
        try:
            self._prof = profile(activities=acts,
                                 experimental_config=self._config())
            self._prof.__enter__()
        except BaseException:
            self._collect.__exit__(None, None, None)
            raise
        return self

    def _config(self):
        if not self.all_threads:
            return None
        try:
            from torch._C._profiler import _ExperimentalConfig
            return _ExperimentalConfig(profile_all_threads=True)
        except (ImportError, TypeError):   # a torch without the option
            return None

    def stop(self) -> str:
        """End the session; returns the trace file's path."""
        import torch

        try:
            if self.cuda:
                torch.cuda.synchronize()
            self._prof.__exit__(None, None, None)
        finally:
            self._collect.__exit__(None, None, None)
        stem = (f"{socket.gethostname()}_{os.getpid()}_"
                f"{int(time.time() * 1e3)}")
        self.trace_path = os.path.join(self.log_dir, stem + ".pt.trace.json")
        self._prof.export_chrome_trace(self.trace_path)
        declared = self.declared.totals()
        with open(os.path.join(self.log_dir, stem + DECLARED_SUFFIX),
                  "w") as f:
            json.dump(declared, f)
        return self.trace_path


def start_profiler(state: str = "All", tracer_option=None,
                   log_dir: Optional[str] = None):
    """Begin one ``torch.profiler`` session writing under `log_dir`.
    Exactly one session can be active per process; a second start (a
    nested `profiler()` context, or one while the profile trigger
    captures) raises a clear error instead of clobbering the session.
    ``state="CPU"`` records host ops only."""
    log_dir = log_dir or _default_dir()
    _claim("start_profiler", log_dir)
    try:
        session = Session(log_dir, cuda=None if state != "CPU" else False)
        session.start()
    except BaseException:
        _release()
        raise
    with _lock:
        _active["session"] = session


def stop_profiler(sorted_key: Optional[str] = None,
                  profile_path: Optional[str] = None):
    """End the active session and return its log dir. Raises a clear
    error when no session is active."""
    with _lock:
        session = _active.get("session")
    if session is None:
        raise RuntimeError(
            "stop_profiler without a matching start_profiler: no "
            "profiling session is active")
    state = _release()      # cleared even if the export raises, so a new
    session.stop()          # session can still start
    return state["dir"]


@contextlib.contextmanager
def profiler(state: str = "All", sorted_key: Optional[str] = None,
             profile_path: Optional[str] = None):
    """fluid.profiler.profiler parity: wraps a training region; writes a
    chrome trace under profile_path (chrome://tracing, Perfetto, or
    ``tools.roofline`` / ``tools.timeline``)."""
    start_profiler(state, log_dir=profile_path)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


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


class _OpTimer:
    """Host-side per-op wall-time table for eager mode — the analog of the
    reference's EnableProfiler sorted per-op summary."""

    def __init__(self):
        self.times = defaultdict(float)
        self.counts = defaultdict(int)

    def summary(self, sorted_key: str = "total"):
        rows = [(k, self.counts[k], self.times[k] * 1e3,
                 self.times[k] / max(self.counts[k], 1) * 1e3)
                for k in self.times]
        rows.sort(key=lambda r: -r[2])
        lines = [f"{'op':<32}{'calls':>8}{'total_ms':>12}{'avg_ms':>10}"]
        for name, c, tot, avg in rows:
            lines.append(f"{name:<32}{c:>8}{tot:>12.3f}{avg:>10.4f}")
        return "\n".join(lines)


_op_timer: Optional[_OpTimer] = None


def export_op_profile(timer: _OpTimer) -> None:
    """Publish an eager per-op timing table to the process registry —
    ``eager/op_ms{op=}`` (cumulative host ms per op type, gauge) and
    ``eager/op_calls{op=}`` (counter)."""
    from .observability.registry import get_registry

    reg = get_registry()
    for op, secs in timer.times.items():
        g = reg.gauge("eager/op_ms", op=op)
        g.set(g.value + secs * 1e3)
        reg.counter("eager/op_calls", op=op).inc(timer.counts[op])


@contextlib.contextmanager
def op_profiler():
    """Eager per-op timing: patches the dygraph tracer's dispatch and
    records each op's host time once its outputs are ready (on the card
    after ``torch.cuda.synchronize``, where the JAX package blocks until
    its arrays are ready). On exit the table is exported to the registry
    (``export_op_profile``) and stays readable as ``timer.summary()``."""
    global _op_timer
    import torch

    from .dygraph import tracer as tr_mod

    _op_timer = _OpTimer()
    orig = tr_mod.Tracer.trace_op

    def timed(self, op_type, inputs, attrs=None):
        t0 = time.perf_counter()
        out = orig(self, op_type, inputs, attrs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        _op_timer.times[op_type] += time.perf_counter() - t0
        _op_timer.counts[op_type] += 1
        return out

    tr_mod.Tracer.trace_op = timed
    try:
        yield _op_timer
    finally:
        tr_mod.Tracer.trace_op = orig
        timer, _op_timer = _op_timer, None
        try:
            export_op_profile(timer)
        except Exception:
            pass


def reset_profiler():
    """Reference profiler.py reset_profiler: clear collected per-op stats."""
    if _op_timer is not None:
        _op_timer.times.clear()
        _op_timer.counts.clear()


@contextlib.contextmanager
def cuda_profiler(output_file=None, output_mode=None, config=None):
    """Reference profiler.py cuda_profiler (nvprof hooks): a no-op shim,
    as in the JAX package; `profiler()` traces the card."""
    yield
