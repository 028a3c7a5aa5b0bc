"""Anomaly-triggered profiling: the capture half of the root-cause loop.

Detection (StepProfiler anomalies, burn-rate pages) and attribution
(`tools/roofline.py` kernel tables) existed as separate facilities; the
evidence that explains a page was only on disk if a human happened to
be running the profiler. `ProfileTrigger` closes that gap: it arms
``torch.profiler`` the moment a ``slow_step``/``recompile`` anomaly or a
page-severity alert appears, captures a bounded trace window (the next
few dispatches), tabulates it per-kernel, diffs against a recorded
*golden* trace, and hands the top movers + the surrounding metrics
history to the alert that is about to page — so the page arrives
already naming the culprit kernels, zero human-in-the-loop.

Safety rails (always-on profiling in production must be boring):

* kill switch — ``PDTPU_PROFILE_ON_ANOMALY=0`` disables arming
  entirely;
* cooldown — at most one capture per ``PDTPU_PROFILE_COOLDOWN_S``
  (default 60 s);
* rate cap — at most ``PDTPU_PROFILE_MAX_CAPTURES`` (default 12)
  captures per rolling hour;
* bounded window — the trace stops after ``window_steps`` further
  dispatches or ``window_s`` seconds, whichever comes first, so a
  stalled program cannot leave the profiler running.

Skipped arms are counted in ``profiler/skipped{reason=...}``; captures
in ``profiler/captures{trigger=...}``.

Golden traces are per-machine like `calibrate.py` floors: one JSON per
(device kind, host) under ``PDTPU_GOLDEN_DIR`` (default
``~/.cache/paddle_tpu_torch/golden``), written by `record_golden()` (also
a CLI: ``python -m paddle_tpu_torch.tools.roofline --save-golden``)
during a known-healthy run. Without a golden, attribution falls back to the
capture's own top-k kernels — still a named culprit, just without the
"vs healthy" delta.

The profiler backend is injectable (`profiler=` — anything with
``start(logdir)``/``stop()``) so the gating semantics are testable
without tracing a single op. The default backend, `_TorchProfiler`, is a
``torch.profiler`` session (``paddle_tpu_torch.profiler.Session``) under
the process's one-session guard: an arm while another session holds the
profiler (a user's ``profiler()``, a calibration) is skipped as
``profiler/skipped{reason="busy"}``, never raised into a step. The
capture starts and stops on its own thread while the trainer's thread
launches steps; the card's kernel events are process-wide, and the
attribution reads only those and the hand kernels' declared counts, not
the host ops of any one thread. A capture that recorded no device time
says so in its attribution (``"error"``).

(The port of ``paddle_tpu.observability.profile_trigger``.)
"""
from __future__ import annotations

import collections
import json
import os
import re
import shutil
import socket
import tempfile
import threading
import time
from typing import Callable, List, Optional

from .registry import Registry, get_registry

__all__ = ["ProfileTrigger", "install_trigger", "get_trigger",
           "golden_path", "record_golden"]

Registry.describe("profiler/captures",
                  "anomaly-triggered trace captures, by trigger")
Registry.describe("profiler/skipped",
                  "arm requests skipped, by reason "
                  "(disabled/cooldown/cap/busy/start_failed)")
Registry.describe("profiler/capture_ms", "trace capture duration")
Registry.describe("profiler/golden_recorded",
                  "golden traces recorded to the disk cache")

# spans the python host tracer emits that can never be a device culprit
_HOST_SPAN_RE = re.compile(r"(^\$)|(\.py:\d+)|(^PjitFunction)"
                           r"|(^TfrtCpu)|(Execute)")

# pure runtime plumbing — never a culprit of EITHER kind. Distinct from
# _HOST_SPAN_RE: a host span from user/framework code (a data loader, a
# fault probe, a lock the trainer actually contends on) IS a legitimate
# root cause when the device kernels didn't move; threading internals,
# the profiler's own machinery, and per-dispatch runtime bookkeeping
# are not.
_NOISE_SPAN_RE = re.compile(
    r"threading\.py|profiler\.py|contextlib\.py|importlib|<unknown>"
    r"|<string>|^\$?tempfile\.py|^DevicePut$|^ParseArguments$"
    r"|^ThreadpoolListener|^PjitFunction|^TfrtCpu|Execute"
    # torch.profiler's own session span
    r"|^PyTorch Profiler|^ProfilerStep"
    # span names carry only file BASENAMES, so an __init__.py frame
    # names no package at all — uninformative as a culprit, and in
    # practice it is the stdlib logging machinery reacting to the
    # anomaly's own warning line inside every capture window
    r"|^\$?__init__\.py:\d+")


def _is_host_span(name: str) -> bool:
    return bool(_HOST_SPAN_RE.search(name))


def _is_noise_span(name: str) -> bool:
    return bool(_NOISE_SPAN_RE.search(name))


# ----------------------------------------------------------- golden store
def _golden_dir() -> str:
    return (os.environ.get("PDTPU_GOLDEN_DIR")
            or os.path.expanduser("~/.cache/paddle_tpu_torch/golden"))


def golden_path(device_kind: Optional[str] = None,
                host: Optional[str] = None) -> str:
    """Golden-trace cache file for this (device kind, host) — keyed the
    same way as `calibrate.py` floors."""
    if device_kind is None:
        from .calibrate import _device_kind
        device_kind, _ = _device_kind()
    host = host or socket.gethostname()
    key = re.sub(r"[^A-Za-z0-9._-]", "_", f"{device_kind}_{host}")
    return os.path.join(_golden_dir(), f"{key}.json")


def load_golden(path: Optional[str] = None) -> Optional[dict]:
    try:
        with open(path or golden_path()) as f:
            d = json.load(f)
        return d if isinstance(d.get("table"), dict) else None
    except Exception:
        return None


def save_golden(table: dict, path: Optional[str] = None,
                note: str = "") -> str:
    path = path or golden_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    doc = {"t": time.time(), "note": note, "table": table}
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, default=str)
    get_registry().counter("profiler/golden_recorded").inc()
    return path


def record_golden(run_step: Callable[[], None], steps: int = 2,
                  path: Optional[str] = None, note: str = "") -> str:
    """Capture `run_step` under the profiler during a known-healthy run
    and persist its kernel table as THE golden for this machine."""
    from ..tools import roofline
    # every kernel, as the capture's table has: a kernel under a cutoff in
    # one table only would read as new in the diff
    table = roofline.capture_kernel_table(run_step, _floors(), steps=steps,
                                          cutoff_ms=0.0)
    if "error" in table:
        raise RuntimeError(f"golden capture failed: {table['error']}")
    return save_golden(table, path=path, note=note)


def _floors() -> tuple:
    """(mm_tflops, stream_gbs) from the calibration cache; permissive
    fallback so attribution still tabulates on an uncalibrated box."""
    try:
        from .calibrate import get_calibration
        return get_calibration().floors
    except Exception:
        return (1.0, 10.0)


class _TorchProfiler:
    """The real backend: a ``torch.profiler`` session under the process's
    one-session guard (``paddle_tpu_torch.profiler``)."""

    def __init__(self):
        self._session = None
        self._last = None

    @staticmethod
    def busy() -> bool:
        from .. import profiler
        return profiler.busy()

    def start(self, logdir: str) -> None:
        from .. import profiler
        profiler._claim("profile_trigger", logdir)
        try:
            self._session = profiler.Session(logdir,
                                             all_threads=True).start()
        except BaseException:
            profiler._release()
            raise

    def stop(self) -> None:
        from .. import profiler
        session, self._session = self._session, None
        self._last = session
        try:
            session.stop()
        finally:
            profiler._release()

    def declared_between(self, since: float, until: float) -> dict:
        """The last session's hand-kernel declarations made between two
        wall times (the capture window's steps)."""
        return self._last.declared.totals(since, until) if self._last \
            else {}


class ProfileTrigger:
    """Arms a bounded trace capture on anomalies/pages and turns the
    capture into a kernel-level attribution. See module docstring."""

    def __init__(self, profiler=None, window_steps: int = 2,
                 window_s: float = 5.0,
                 cooldown_s: Optional[float] = None,
                 max_captures_per_h: Optional[int] = None,
                 topk: int = 5,
                 history_half_width_s: float = 30.0,
                 registry: Optional[Registry] = None):
        env = os.environ
        if cooldown_s is None:
            cooldown_s = float(env.get("PDTPU_PROFILE_COOLDOWN_S", "60"))
        if max_captures_per_h is None:
            max_captures_per_h = int(
                env.get("PDTPU_PROFILE_MAX_CAPTURES", "12"))
        self.profiler = profiler if profiler is not None \
            else _TorchProfiler()
        self.window_steps = max(1, int(window_steps))
        self.window_s = float(window_s)
        self.cooldown_s = float(cooldown_s)
        self.max_captures_per_h = max(1, int(max_captures_per_h))
        self.topk = int(topk)
        self.history_half_width_s = float(history_half_width_s)
        self.enrich_wait_s = float(
            env.get("PDTPU_PROFILE_ENRICH_WAIT_S", "8"))
        self._reg = registry if registry is not None else get_registry()
        self._lock = threading.Lock()
        self._capturing = False
        self._capture_times: collections.deque = collections.deque(maxlen=64)
        self._steps_seen = 0
        self._t_started: Optional[float] = None
        self._span: Optional[tuple] = None   # the window's steps, wall s
        self._window_done = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._last: Optional[dict] = None
        self._thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------- gating
    @staticmethod
    def enabled() -> bool:
        return os.environ.get("PDTPU_PROFILE_ON_ANOMALY", "1") != "0"

    def arm(self, reason: str, anomaly_t: Optional[float] = None):
        """Request a capture. Returns the capture thread when armed,
        None when gated (the skip reason lands in
        ``profiler/skipped{reason=...}``)."""
        now = time.time()
        if not self.enabled():
            self._reg.counter("profiler/skipped", reason="disabled").inc()
            return None
        busy = getattr(self.profiler, "busy", None)
        with self._lock:
            if self._capturing or (busy is not None and busy()):
                # another session holds the profiler (one a process)
                self._reg.counter("profiler/skipped", reason="busy").inc()
                return None
            if (self._capture_times
                    and now - self._capture_times[-1] < self.cooldown_s):
                self._reg.counter("profiler/skipped",
                                  reason="cooldown").inc()
                return None
            recent = [t for t in self._capture_times if now - t < 3600.0]
            if len(recent) >= self.max_captures_per_h:
                self._reg.counter("profiler/skipped", reason="cap").inc()
                return None
            self._capturing = True
            self._capture_times.append(now)
            self._steps_seen = 0
            self._span = None
            self._window_done.clear()
            self._idle.clear()
        self._reg.counter("profiler/captures", trigger=reason).inc()
        t = threading.Thread(target=self._capture, name="profile-capture",
                             args=(reason, anomaly_t or now), daemon=True)
        with self._lock:
            self._thread = t
        t.start()
        return t

    # ------------------------------------------------------- subscriptions
    def on_record(self, rec: dict) -> None:
        """StepProfiler per-record listener: closes the capture window
        after `window_steps` further dispatches. A record that carries its
        times counts only when its step began after the trace did (a step
        under way when the capture thread started the profiler is partly
        outside the trace)."""
        with self._lock:
            if not self._capturing:
                return
            if rec.get("t") is not None and rec.get("wall_ms") is not None:
                began = float(rec["t"]) - float(rec["wall_ms"]) / 1e3
                if self._t_started is None or began < self._t_started:
                    return
                lo = began if self._span is None else self._span[0]
                self._span = (lo, float(rec["t"]))
            self._steps_seen += 1
            if self._steps_seen >= self.window_steps:
                self._window_done.set()

    def on_anomaly(self, rec: dict, reason: str) -> None:
        """StepProfiler anomaly listener: the arming signal."""
        self.arm(reason, anomaly_t=rec.get("t"))

    def enrich_alert(self, alert) -> Optional[dict]:
        """AlertManager enricher: page-severity alerts get (and if
        needed, trigger) the current attribution before the event is
        emitted. Blocks up to `enrich_wait_s` for an in-flight capture
        so the firing event deterministically carries the culprits."""
        if alert.severity != "page":
            return None
        with self._lock:
            idle = not self._capturing
        if idle:
            # no capture in flight: try to get one (cooldown/cap gating
            # applies — when gated we fall back to the last attribution)
            self.arm(f"alert:{alert.name}")
        self._idle.wait(self.enrich_wait_s)
        att = self.last_attribution()
        if not att or att.get("error"):
            return None
        out = {"culprit_kernels": att.get("culprit_kernels"),
               "attribution_t": att.get("t"),
               "attribution_trigger": att.get("trigger")}
        if att.get("trace_diff") is not None:
            out["trace_diff"] = att["trace_diff"]
        if att.get("history") is not None:
            out["history"] = att["history"]
        return out

    def attach(self, step_profiler=None, alert_manager=None
               ) -> "ProfileTrigger":
        """Wire into the detection layer: StepProfiler records +
        anomalies, AlertManager enrichment. Also registers the
        ``profile_trigger`` flight-dump section."""
        if step_profiler is not None:
            step_profiler.add_listener(self.on_record)
            step_profiler.add_anomaly_listener(self.on_anomaly)
        if alert_manager is not None:
            alert_manager.add_enricher(self.enrich_alert)
        from .flight import register_dump_section
        register_dump_section("profile_trigger", self.doc)
        return self

    # ------------------------------------------------------------ capture
    def _capture(self, reason: str, anomaly_t: float) -> None:
        t0 = time.time()
        logdir = tempfile.mkdtemp(prefix="pdtpu_profile_")
        att: dict = {"t": anomaly_t, "trigger": reason}
        try:
            try:
                self.profiler.start(logdir)
            except Exception as e:
                self._reg.counter("profiler/skipped",
                                  reason="start_failed").inc()
                att["error"] = f"start_trace: {type(e).__name__}: {e}"
                return
            with self._lock:
                # rec["t"] is rounded to the millisecond
                self._t_started = time.time() - 1e-3
            self._window_done.wait(self.window_s)
            try:
                self.profiler.stop()
            except Exception as e:
                att["error"] = f"stop_trace: {type(e).__name__}: {e}"
                return
            try:
                att.update(self._attribute(logdir, anomaly_t))
            except Exception as e:
                att["error"] = f"attribution: {type(e).__name__}: {e}"
        finally:
            att["capture_ms"] = round((time.time() - t0) * 1e3, 1)
            self._reg.histogram("profiler/capture_ms").observe(
                att["capture_ms"])
            shutil.rmtree(logdir, ignore_errors=True)
            with self._lock:
                self._last = att
                self._capturing = False
                self._t_started = None
            self._idle.set()

    def _attribute(self, logdir: str, anomaly_t: float) -> dict:
        """Trace dir → kernel table → golden diff → culprits + the
        surrounding history window."""
        from ..tools import roofline
        tr = roofline.load_trace(logdir)
        with self._lock:
            span = self._span
        if span is not None:
            # only the window's steps: the trace also holds the ends of the
            # steps under way when the profiler started and stopped
            tr = _within(tr, span[0] - 1e-3, span[1] + 1e-3)
            between = getattr(self.profiler, "declared_between", None)
            if between is not None:
                tr["declaredCounts"] = between(span[0] - 1e-3,
                                               span[1] + 1e-3)
        if tr.get("deviceProperties") and not any(
                e.get("cat") in roofline.DEVICE_CATS
                for e in tr.get("traceEvents", ())):
            # the session traced the card but caught none of its work
            return {"error": "capture recorded no device time"}
        table = roofline.kernel_table(tr, _floors(),
                                      steps=max(1, self.window_steps),
                                      cutoff_ms=0.0)
        if "error" in table:
            return {"error": table["error"]}
        out: dict = {"kernel_table_top": table["kernels"][:self.topk],
                     "hand_kernels": table.get("hand_kernels", []),
                     "device_ms_per_step": table.get("device_ms_per_step")}
        golden = load_golden()
        culprits: List[dict] = []
        if golden is not None:
            diff = roofline.diff_tables(golden["table"], table,
                                        topk=max(self.topk, 8))
            out["trace_diff"] = {
                "golden_t": golden.get("t"),
                "delta_ms_per_step": diff.get("delta_ms_per_step"),
                "movers": diff.get("movers", [])[:self.topk],
                "only_in_capture": diff.get("only_in_b", [])[:self.topk],
            }
            host_culprits: List[dict] = []
            for m in diff.get("movers", ()):
                nm = m.get("kernel", "")
                if m.get("delta_ms", 0) <= 0 or _is_noise_span(nm):
                    continue
                if _is_host_span(nm):
                    # device kernels can be clean while the step still
                    # regressed: a host-side stall (loader, lock, fault
                    # probe) is then the truthful culprit — rank it
                    # after any device mover
                    host_culprits.append(
                        {"kernel": nm, "delta_ms": m["delta_ms"],
                         "ms": m.get("ms_b"),
                         "why": "host-side regression vs golden"})
                else:
                    culprits.append({"kernel": nm,
                                     "delta_ms": m["delta_ms"],
                                     "ms": m.get("ms_b"),
                                     "why": "regressed vs golden"})
            culprits.extend(host_culprits)
            for nm in diff.get("only_in_b", ()):
                if not _is_noise_span(nm):
                    culprits.append({"kernel": nm,
                                     "why": "new vs golden"})
        if not culprits:
            # no golden (or nothing moved): the capture's own heaviest
            # device kernels are still a named starting point
            why = ("top by time (nothing moved vs golden)"
                   if golden is not None else "top by time (no golden)")
            for k in table["kernels"]:
                if not (_is_host_span(k["kernel"])
                        or _is_noise_span(k["kernel"])):
                    culprits.append({"kernel": k["kernel"], "ms": k["ms"],
                                     "why": why})
                if len(culprits) >= self.topk:
                    break
        out["culprit_kernels"] = culprits[:self.topk]
        from .history import get_history
        hist = get_history()
        if hist is not None:
            out["history"] = hist.window(
                anomaly_t, half_width_s=self.history_half_width_s)
        return out

    # ------------------------------------------------------------- reading
    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Block until no capture is in flight (bench/test sync)."""
        return self._idle.wait(timeout)

    def last_attribution(self) -> Optional[dict]:
        with self._lock:
            return self._last

    def doc(self) -> dict:
        with self._lock:
            last = dict(self._last) if self._last else None
        if last is not None:
            # flight dumps don't need the full history window re-embedded
            last.pop("history", None)
        return {"capturing": not self._idle.is_set(),
                "captures": len(self._capture_times),
                "window_steps": self.window_steps,
                "cooldown_s": self.cooldown_s,
                "max_captures_per_h": self.max_captures_per_h,
                "last": last}


def _within(tr: dict, since: float, until: float) -> dict:
    """The trace's complete ("X") events that began between two wall
    times (a torch.profiler trace's ``ts`` is µs after
    ``baseTimeNanoseconds``); a trace without that base as it is."""
    base = tr.get("baseTimeNanoseconds")
    if base is None:
        return tr
    lo, hi = since * 1e6 - base / 1e3, until * 1e6 - base / 1e3
    events = [e for e in tr.get("traceEvents", ())
              if e.get("ph") != "X" or lo <= float(e.get("ts", 0)) <= hi]
    return dict(tr, traceEvents=events)


# process-wide trigger (mirrors install_scraper/install_history)
_installed: Optional[ProfileTrigger] = None
_install_lock = threading.Lock()


def install_trigger(trigger: Optional[ProfileTrigger]):
    """Make `trigger` the process-wide one (None uninstalls)."""
    global _installed
    with _install_lock:
        _installed = trigger
    return trigger


def get_trigger() -> Optional[ProfileTrigger]:
    with _install_lock:
        return _installed
