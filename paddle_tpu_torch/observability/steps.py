"""Per-step profiler: one structured record per Executor.run dispatch.

Copy of ``paddle_tpu.observability.steps`` (stdlib only). The reference
framework's profiler emitted one RecordEvent per op; the executor's grain
here is the *step* — one ``Executor.run``. `StepProfiler.record()` is
called by the executor after every run with the host wall time and
identity of the step; the profiler enriches the record with what the rest
of the runtime already published to the registry (the last fetch wait,
the card's allocated bytes), keeps a rolling window, forwards each record
to the flight recorder's ring, and runs a straggler detector over it. On
the card ``wall_ms`` is host time: the kernels run on asynchronously,
and a ``FetchHandle``'s wait shows where the host caught up with them.

Straggler detection is median/MAD (median absolute deviation): robust
to the long right tail of step times, no assumption of normality, and
immune to the detector's own anomalies polluting the baseline the way a
mean/stddev would. Baselines are kept per (program, signature) stream
so interleaving train/eval programs cannot trip false positives on each
other. A step is anomalous when it exceeds
``median + k * 1.4826 * MAD`` (k=6) *and* 1.5x the median (guards the
near-zero-MAD case where every step is metronome-identical). Plan-cache
misses (``compiled=True``) are excluded from the baseline; a miss
arriving after the stream was steady is itself flagged
(``reason="recompile"``), since a mid-run re-prepare is the other
classic straggler source. Anomalies increment
``steps/anomalies{reason=...}`` and log one structured warning line
naming the step and its deviation.

Window size: ``PDTPU_STEP_WINDOW`` (default 512).

Environment sampling is rate-limited: one record in
``PDTPU_STEP_SAMPLE_EVERY`` (default 16) takes a fresh sample; the others
stamp the cached values. The first record after construction or
``reset()`` always samples fresh.
"""
from __future__ import annotations

import collections
import logging
import os
import threading
import time
from typing import Deque, Dict, Optional

from .flight import get_flight_recorder
from .registry import Registry, get_registry
from .tracer import get_tracer

__all__ = ["StepProfiler", "get_step_profiler"]

logger = logging.getLogger("paddle_tpu_torch.observability.steps")

# Detector constants: 1.4826 scales MAD to a stddev-equivalent for a
# normal distribution; k=6 ~ "six sigma" on the robust scale.
_MAD_TO_SIGMA = 1.4826
_MAX_STREAMS = 64  # bound the per-(program, sig) baseline table


class StepProfiler:
    """Rolling window of step records + median/MAD straggler detector."""

    def __init__(self, window: Optional[int] = None, k: float = 6.0,
                 min_samples: int = 20,
                 registry: Optional[Registry] = None):
        if window is None:
            window = int(os.environ.get("PDTPU_STEP_WINDOW", "512"))
        window = max(8, int(window))
        self.k = float(k)
        self.min_samples = int(min_samples)
        self._reg = registry if registry is not None else get_registry()
        self._lock = threading.Lock()
        self._records: Deque[dict] = collections.deque(maxlen=window)
        # steady (non-compile) wall_ms per (program, sig) stream
        self._baselines: "collections.OrderedDict[tuple, Deque[float]]" = \
            collections.OrderedDict()
        self._step = 0
        self._sample_every = max(
            1, int(os.environ.get("PDTPU_STEP_SAMPLE_EVERY", "16")))
        self._sample_tick = 0
        self._env_cache: dict = {}
        # subscription points (ProfileTrigger): called OUTSIDE the lock
        self._listeners: list = []
        self._anomaly_listeners: list = []

    def add_listener(self, fn) -> "StepProfiler":
        """Call ``fn(rec)`` after every record (outside the lock).
        Listener exceptions are swallowed — observability plumbing must
        not kill the hot loop."""
        self._listeners.append(fn)
        return self

    def add_anomaly_listener(self, fn) -> "StepProfiler":
        """Call ``fn(rec, reason)`` on every slow_step/recompile anomaly
        (outside the lock; exceptions swallowed) — the ProfileTrigger's
        arming signal."""
        self._anomaly_listeners.append(fn)
        return self

    def remove_listener(self, fn) -> "StepProfiler":
        """Detach `fn` from both listener lists (missing is fine) — the
        teardown half of add_listener/add_anomaly_listener for harnesses
        that wire a ProfileTrigger temporarily."""
        for lst in (self._listeners, self._anomaly_listeners):
            while fn in lst:
                lst.remove(fn)
        return self

    # -- environment sampling ---------------------------------------------
    def _sample_environment(self, rec: dict) -> None:
        """Pull fetch-wait and memory context other layers already
        published. A fresh sample runs once per `_sample_every` records
        (the tick is a plain int — a rare racy double-sample is harmless);
        in between, records get the cached fields, keeping the hot-loop
        cost O(1) dict-update."""
        tick = self._sample_tick
        self._sample_tick = tick + 1
        if tick % self._sample_every:
            rec.update(self._env_cache)
            return
        env: dict = {}
        self._sample_fresh(env)
        self._env_cache = env
        rec.update(env)

    def _sample_fresh(self, rec: dict) -> None:
        reg = self._reg
        try:
            wait = reg.gauge("executor/last_fetch_wait_ms").value
            if wait > 0.0:
                rec["fetch_wait_ms"] = round(wait, 3)
        except Exception:
            pass
        try:
            import torch
            if torch.cuda.is_initialized():
                rec["mem_bytes_in_use"] = int(torch.cuda.memory_allocated())
        except Exception:
            pass

    # -- recording ---------------------------------------------------------
    def record(self, wall_ms: float, *, program_id: Optional[int] = None,
               sig: Optional[str] = None, compiled: bool = False,
               steps: int = 1, sample_env: bool = True, **extra) -> dict:
        """Record one dispatch; returns the (possibly annotated) record.
        `compiled` marks a trace+compile dispatch (excluded from the
        straggler baseline); `steps` > 1 for run_batched dispatches."""
        rec: dict = {
            "t": round(time.time(), 3),
            "wall_ms": round(float(wall_ms), 3),
            "compile": bool(compiled),
        }
        if program_id is not None:
            rec["program"] = f"0x{program_id:x}"
        if sig is not None:
            rec["sig"] = sig
        if steps != 1:
            rec["steps_in_dispatch"] = int(steps)
        if extra:
            rec.update(extra)
        if sample_env:
            self._sample_environment(rec)
        if program_id is not None:
            # perf-attribution join: when the dispatched program has a
            # cost-ledger entry, the record gains achieved_tflops (and
            # the live perf/* gauges update), so /debug/steps and
            # straggler anomalies carry utilization context
            try:
                from . import perf
                perf.get_ledger().annotate_record(rec)
            except Exception:
                pass
        stream = (rec.get("program"), rec.get("sig"))
        anomaly = None
        with self._lock:
            self._step += 1
            rec["step"] = self._step
            base = self._baselines.get(stream)
            if base is None:
                base = collections.deque(maxlen=self._records.maxlen)
                self._baselines[stream] = base
                while len(self._baselines) > _MAX_STREAMS:
                    self._baselines.popitem(last=False)
            if compiled:
                if len(base) >= self.min_samples:
                    anomaly = ("recompile", None, None, None)
            else:
                if len(base) >= self.min_samples:
                    med, sigma = _median_sigma(base)
                    per_step = float(wall_ms) / max(1, int(steps))
                    if (per_step > med + self.k * sigma
                            and per_step > 1.5 * med):
                        dev = (per_step - med) / sigma if sigma > 0 else 0.0
                        anomaly = ("slow_step", med, sigma, dev)
                base.append(float(wall_ms) / max(1, int(steps)))
            if anomaly is not None:
                rec["anomaly"] = anomaly[0]
                if anomaly[3] is not None:
                    rec["deviation"] = round(anomaly[3], 1)
            self._records.append(rec)

        self._reg.counter("steps/total").inc()
        self._reg.histogram("steps/wall_ms").observe(float(wall_ms))
        if anomaly is not None:
            reason, med, sigma, dev = anomaly
            self._reg.counter("steps/anomalies", reason=reason).inc()
            if reason == "slow_step":
                msg = (f"slow step: step={rec['step']} "
                       f"wall_ms={rec['wall_ms']:.2f} "
                       f"median_ms={med:.2f} sigma_ms={sigma:.3f} "
                       f"deviation={dev:.1f}x "
                       f"program={rec.get('program', '?')} "
                       f"sig={rec.get('sig', '?')}")
            else:
                msg = (f"mid-run recompile: step={rec['step']} "
                       f"compile_ms={rec['wall_ms']:.2f} "
                       f"program={rec.get('program', '?')} "
                       f"sig={rec.get('sig', '?')} — feed shape/dtype "
                       f"drifted after a steady window")
            logger.warning(msg)
            get_flight_recorder().note_event("warning", msg,
                                             reason=reason,
                                             step=rec["step"])
            # instant event too: a merged fleet timeline shows WHERE the
            # straggler detector fired, not just that a counter moved
            iargs = {"reason": reason, "step": rec["step"],
                     "wall_ms": rec["wall_ms"]}
            if anomaly[3] is not None:
                iargs["deviation"] = round(anomaly[3], 1)
            get_tracer().instant(f"steps/{reason}", iargs)
        get_flight_recorder().note_step(rec)
        if anomaly is not None and self._anomaly_listeners:
            for fn in list(self._anomaly_listeners):
                try:
                    fn(rec, anomaly[0])
                except Exception:
                    pass
        if self._listeners:
            for fn in list(self._listeners):
                try:
                    fn(rec)
                except Exception:
                    pass
        return rec

    # -- reading -----------------------------------------------------------
    def records(self, n: Optional[int] = None) -> list:
        """Most recent records, oldest first."""
        with self._lock:
            out = list(self._records)
        return out[-int(n):] if n else out

    @property
    def step(self) -> int:
        with self._lock:
            return self._step

    def reset(self) -> None:
        with self._lock:
            self._records.clear()
            self._baselines.clear()
            self._step = 0
            self._sample_tick = 0
            self._env_cache = {}


def _median_sigma(samples) -> tuple:
    """(median, robust sigma) of the baseline window; sigma is floored
    at max(2% of median, 0.05ms) so a metronome-steady stream can't
    produce a hair-trigger threshold."""
    data = sorted(samples)
    med = _median(data)
    mad = _median(sorted(abs(x - med) for x in data))
    sigma = _MAD_TO_SIGMA * mad
    return med, max(sigma, 0.02 * med, 0.05)


def _median(sorted_data) -> float:
    n = len(sorted_data)
    mid = n // 2
    if n % 2:
        return float(sorted_data[mid])
    return (sorted_data[mid - 1] + sorted_data[mid]) / 2.0


_profiler = StepProfiler()


def get_step_profiler() -> StepProfiler:
    """THE process-wide step profiler the Executor records into."""
    return _profiler
