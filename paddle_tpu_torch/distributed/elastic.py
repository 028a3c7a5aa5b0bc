"""Elastic / preemption-aware training driver (the port's copy of
``paddle_tpu.distributed.elastic``).

Reference analog: the reference's fault-tolerance story is thin (SURVEY §5
"failure detection / elastic recovery") — a pserver checkpoint-notify RPC
(distributed_ops/checkpoint_notify_op.cc, grpc_client.cc
AsyncCheckpointNotify) and manual retries; no automatic resume, no
preemption handling. This module is the upgrade the survey calls for:
cloud accelerators are preemptible, so the driver must treat SIGTERM as a
first-class event.

- `PreemptionGuard`: installs SIGTERM/SIGINT handlers that set a flag (and
  chain to any previous handler). The training loop polls `should_stop`;
  a step is never interrupted mid-dispatch. Off the main thread the
  guard degrades to a no-op flag — it now SAYS so (one warning +
  ``elastic/guard_degraded`` gauge) instead of silently not observing
  SIGTERM.
- `run_elastic`: a resumable step loop around `Checkpointer` — restores the
  latest *verified* checkpoint (step counter + params + RNG stream +
  input-pipeline cursor), runs user steps, checkpoints every
  `save_interval`, and on preemption writes a final blocking checkpoint
  before returning. Re-launching the same command continues where the
  preempted run stopped; the checkpoint bundles are reshardable, so the
  resumed run may use a different mesh. The restore places the values on
  `place` (``CUDAPlace(0)`` unless the caller passes another, as
  ``Checkpointer.restore`` does). Pass `loader=` (a
  ``dataio.DeviceLoader``) and its (epoch, cursor) position rides in every
  checkpoint as ``@dataio@*`` keys — a mid-epoch resume replays exactly
  the batches the killed run never consumed, which is what makes the
  resumed loss trajectory bitwise-identical over stateful readers.
- `heartbeat_file`: liveness marker for an external watchdog (the failure-
  detection half: a supervisor that sees a stale heartbeat restarts the
  trainer, which then self-resumes). fsynced before rename, so power loss
  cannot durably publish an empty heartbeat; written once immediately
  after restore so a supervisor can tell a slow restore from a hang.
- `/healthz` integration: while `run_elastic` runs, the introspection
  plane (observability.http) reports ``elastic/progress`` — "failing"
  once no step has completed for ``PDTPU_WEDGE_TIMEOUT`` seconds (default
  300) — and ``elastic/checkpoint`` — "degraded" while an async save is
  in flight, "failing" if the background writer died. An orchestrator
  probing /healthz can therefore tell *checkpointing* (leave it alone)
  from *wedged* (restart it). Checks are unregistered on exit.
"""
from __future__ import annotations

import os
import signal
import threading
import time
import warnings
from typing import Callable, Optional

import numpy as np

from ..faults import fault_point
from ..observability.http import (register_health_check,
                                  unregister_health_check)
from ..observability.registry import get_registry
from ..parallel.checkpoint import Checkpointer

_OBS = get_registry()
# 1 while a PreemptionGuard exists that cannot observe OS signals
_GUARD_DEGRADED = _OBS.gauge("elastic/guard_degraded")
_warned_guard_degraded = False


class PreemptionGuard:
    """Converts SIGTERM/SIGINT into a cooperative stop flag.

    signal.signal() is only legal in the main thread; from a worker thread
    (notebook executor, supervisor thread) the guard degrades to a no-op
    flag — checkpointing still works, only OS-signal preemption is not
    observed there. The degradation is loud: one RuntimeWarning per
    process and an ``elastic/guard_degraded`` gauge the operator can
    alert on, because a trainer that will NOT see SIGTERM must not look
    preemption-safe on a dashboard.
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._stop = False
        self._prev = {}
        self.degraded = False
        if threading.current_thread() is not threading.main_thread():
            global _warned_guard_degraded
            self.degraded = True
            _GUARD_DEGRADED.set(1)
            if not _warned_guard_degraded:
                _warned_guard_degraded = True
                warnings.warn(
                    "PreemptionGuard installed off the main thread: signal "
                    "handlers cannot be registered, so SIGTERM/SIGINT will "
                    "NOT be observed and preemption will kill the run "
                    "without a final checkpoint (elastic/guard_degraded=1)",
                    RuntimeWarning, stacklevel=2)
            return
        for sig in signals:
            self._prev[sig] = signal.signal(sig, self._handler)
        _GUARD_DEGRADED.set(0)

    def _handler(self, signum, frame):
        self._stop = True
        prev = self._prev.get(signum)
        # never chain into default_int_handler: it raises KeyboardInterrupt
        # mid-step, which is exactly the interruption this guard prevents
        if callable(prev) and prev is not signal.default_int_handler \
                and prev not in (signal.SIG_IGN, signal.SIG_DFL):
            prev(signum, frame)

    @property
    def should_stop(self) -> bool:
        return self._stop

    def uninstall(self):
        for sig, prev in self._prev.items():
            # getsignal() returns None for handlers installed from C;
            # signal.signal() rejects None — restore the OS default instead
            signal.signal(sig, prev if prev is not None else signal.SIG_DFL)
        self._prev = {}


def touch_heartbeat(path: str, step: int):
    """Liveness marker: `<path>` holds the last completed step + wall time.
    fsync before the rename: without it a power loss can durably publish
    the *rename* but not the *bytes*, and the watchdog reads an empty
    heartbeat as a dead trainer. Written via rename so a watchdog never
    reads a torn file."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(f"{step} {time.time()}\n")
        f.flush()
        os.fsync(f.fileno())
    fault_point("heartbeat", path=tmp)
    os.replace(tmp, path)


def _dataio_extra(loader) -> Optional[dict]:
    """The loader's resume position as checkpoint-bundle extras."""
    if loader is None:
        return None
    st = loader.state()
    return {"@dataio@version": np.int64(st.get("version", 1)),
            "@dataio@epoch": np.int64(st["epoch"]),
            "@dataio@cursor": np.int64(st["cursor"])}


def _decode_dataio_extra(extra: dict) -> Optional[dict]:
    if "@dataio@epoch" not in extra or "@dataio@cursor" not in extra:
        return None
    return {"version": int(np.asarray(extra.get("@dataio@version", 1))),
            "epoch": int(np.asarray(extra["@dataio@epoch"])),
            "cursor": int(np.asarray(extra["@dataio@cursor"]))}


def run_elastic(step_fn: Callable[[int], object], ckpt_dir: str,
                num_steps: int, save_interval: int = 10,
                program=None, scope=None,
                heartbeat: Optional[str] = None,
                on_resume: Optional[Callable[[int], None]] = None,
                loader=None, place=None) -> int:
    """Run `step_fn(step)` for steps [resume_step, num_steps), checkpointing.

    Returns the next step to run (== num_steps when training completed, or
    the resume point when preempted). The caller's program/scope hold the
    training state; `step_fn` is typically `lambda i: exe.run(prog, ...)`.
    `loader` (optional ``dataio.DeviceLoader``) is checkpointed and
    restored alongside the model, making mid-epoch resume deterministic
    over stateful readers. `place`: where the restored values go
    (``CUDAPlace(0)`` by default, ``CPUPlace()`` for the CPU).
    """
    ck = Checkpointer(ckpt_dir)
    start = ck.restore(program=program, scope=scope, place=place)
    if start is None:
        start = 0
    else:
        if loader is not None:
            st = _decode_dataio_extra(ck.last_extra)
            if st is not None:
                loader.restore_state(st)
        if on_resume is not None:
            on_resume(start)
    if heartbeat:
        # first heartbeat BEFORE the first (possibly slow) step: a
        # supervisor watching the file can now tell "restoring/compiling"
        # from "hung before it ever came up"
        touch_heartbeat(heartbeat, start)

    wedge_timeout = float(os.environ.get("PDTPU_WEDGE_TIMEOUT", "300"))
    progress = {"step": start, "t": time.time()}

    def _progress_check():
        dt = time.time() - progress["t"]
        if dt > wedge_timeout:
            return ("failing",
                    f"no step completed for {dt:.1f}s (last step "
                    f"{progress['step']}, wedge timeout {wedge_timeout:g}s)")
        return ("ok", f"step {progress['step']}/{num_steps}")

    def _checkpoint_check():
        t = ck._thread
        if t is not None and t.is_alive():
            return ("degraded", "checkpoint save in flight")
        if ck._error is not None:
            return ("failing", "background checkpoint write failed; the "
                               "next save()/wait() will raise")
        return ("ok", "no save in flight")

    register_health_check("elastic/progress", _progress_check)
    register_health_check("elastic/checkpoint", _checkpoint_check)

    guard = PreemptionGuard()
    step = start
    try:
        while step < num_steps:
            if guard.should_stop:
                break
            step_fn(step)
            step += 1
            progress["step"] = step
            progress["t"] = time.time()
            if heartbeat:
                touch_heartbeat(heartbeat, step)
            if step % save_interval == 0 and step < num_steps:
                ck.save(step, program=program, scope=scope,
                        extra=_dataio_extra(loader))
        # final checkpoint is blocking: the process may be about to die
        ck.save(step, program=program, scope=scope, blocking=True,
                extra=_dataio_extra(loader))
    finally:
        guard.uninstall()
        unregister_health_check("elastic/progress")
        unregister_health_check("elastic/checkpoint")
    return step
