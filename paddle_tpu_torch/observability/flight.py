"""Flight recorder: crash forensics for device failures (OOM first).

Copy of ``paddle_tpu.observability.flight`` (stdlib and torch only). A
device OOM kills a step with a bare ``CUDA out of memory`` and no
context — which step tipped over, what memory looked like, which plans
were resident. The flight recorder keeps a bounded in-memory ring of the
most recent step records (fed by `steps.StepProfiler`) and warning-level
events; when a dispatch site (``Executor.run``) catches an OOM it calls
`record_failure(exc)` to write a post-mortem JSON dump — last-N step
records, a registry snapshot, per-device memory stats
(``torch.cuda.memory_stats``), and any registered forensic sections
(the executor's resident plan keys, watchdog state) — before re-raising
the original exception unchanged.

Dump destination is ``PDTPU_FLIGHT_DIR``; without it the dump is kept
in memory only (``last_dump``). Ring sizes: ``PDTPU_FLIGHT_STEPS``
(default 64) step records, 128 events. After each write the recorder
deletes oldest-first past ``PDTPU_FLIGHT_MAX_DUMPS`` (default 32) files or
``PDTPU_FLIGHT_MAX_MB`` (default 256) total, counting deletions in
``flight/dumps_pruned``. The dump just written is never pruned.
"""
from __future__ import annotations

import collections
import contextlib
import json
import logging
import os
import threading
import time
from typing import Callable, Dict, Optional

__all__ = ["FlightRecorder", "get_flight_recorder", "is_oom",
           "register_dump_section", "unregister_dump_section"]

logger = logging.getLogger("paddle_tpu_torch.observability.flight")

_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory")
_OOM_TYPE_NAMES = ("OutOfMemoryError", "AcceleratorError")


def is_oom(exc: BaseException) -> bool:
    """True for failures the flight recorder should dump on: torch's
    ``OutOfMemoryError``, CUDA runtime errors (``AcceleratorError``) and
    anything carrying an out-of-memory marker."""
    msg = str(exc)
    if any(m in msg for m in _OOM_MARKERS):
        return True
    for klass in type(exc).__mro__:
        if klass.__name__ in _OOM_TYPE_NAMES:
            return True
    return False


# Forensic dump sections: other layers register a callable producing a
# JSON-safe value; flight.py stays import-cycle-free (the executor
# imports us, never the reverse).
_sections_lock = threading.Lock()
_sections: Dict[str, Callable[[], object]] = {}


def register_dump_section(name: str, fn: Callable[[], object]) -> None:
    """Include ``fn()`` under ``sections[name]`` in every flight dump.
    The callable must not raise for long — errors are captured inline."""
    with _sections_lock:
        _sections[name] = fn


def unregister_dump_section(name: str) -> None:
    with _sections_lock:
        _sections.pop(name, None)


def _collect_sections() -> dict:
    with _sections_lock:
        items = list(_sections.items())
    out = {}
    for name, fn in items:
        try:
            out[name] = fn()
        except Exception as e:  # a broken provider must not mask the OOM
            out[name] = {"error": f"{type(e).__name__}: {e}"}
    return out


def _per_device_memory() -> dict:
    """``torch.cuda.memory_stats(i)`` for every visible device ({} on a
    machine without CUDA or before the port touched the card)."""
    out: dict = {}
    try:
        import torch
        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return out
        for i in range(torch.cuda.device_count()):
            try:
                stats = torch.cuda.memory_stats(i)
            except Exception:
                stats = None
            if stats:
                out[f"cuda:{i}"] = dict(stats)
    except Exception:
        pass
    return out


class FlightRecorder:
    """Bounded ring of step records + warning events, dumped on failure."""

    def __init__(self, step_cap: Optional[int] = None, event_cap: int = 128):
        if step_cap is None:
            step_cap = int(os.environ.get("PDTPU_FLIGHT_STEPS", "64"))
        self._lock = threading.Lock()
        self._steps = collections.deque(maxlen=max(1, int(step_cap)))
        self._events = collections.deque(maxlen=max(1, int(event_cap)))
        self._dump_seq = 0
        self.last_dump: Optional[dict] = None
        self.last_dump_path: Optional[str] = None

    # -- feeding the ring --------------------------------------------------
    def note_step(self, record: dict) -> None:
        with self._lock:
            self._steps.append(record)

    def note_event(self, level: str, message: str, **ctx) -> None:
        ev = {"t": time.time(), "level": level, "message": message}
        if ctx:
            ev.update(ctx)
        with self._lock:
            self._events.append(ev)

    def contents(self) -> dict:
        """Current ring contents."""
        with self._lock:
            return {"steps": list(self._steps),
                    "events": list(self._events),
                    "last_dump_path": self.last_dump_path,
                    "last_dump": self.last_dump}

    # -- post-mortem -------------------------------------------------------
    def record_failure(self, exc: BaseException,
                       context: Optional[dict] = None) -> Optional[str]:
        """Assemble a post-mortem dump; write it to PDTPU_FLIGHT_DIR when
        set. Returns the dump path (None when kept in memory only).
        Never raises: forensics must not replace the original error."""
        try:
            return self._record_failure(exc, context)
        except Exception as e:
            logger.warning("flight dump failed: %s: %s",
                           type(e).__name__, e)
            return None

    def _record_failure(self, exc, context) -> Optional[str]:
        from .registry import get_registry
        from .watchdog import get_watchdog
        with self._lock:
            steps = list(self._steps)
            events = list(self._events)
            self._dump_seq += 1
            seq = self._dump_seq
        dump = {
            "time": time.time(),
            "pid": os.getpid(),
            "exception": {"type": type(exc).__name__,
                          "message": str(exc)[:4000]},
            "context": dict(context or {}),
            "steps": steps,
            "events": events,
            "registry": get_registry().snapshot(),
            "device_memory": _per_device_memory(),
            "sections": _collect_sections(),
            "watchdog": get_watchdog().state(),
        }
        path = None
        flight_dir = os.environ.get("PDTPU_FLIGHT_DIR")
        if flight_dir:
            os.makedirs(flight_dir, exist_ok=True)
            fname = (f"flight_{os.getpid()}_"
                     f"{int(dump['time'] * 1000)}_{seq}.json")
            path = os.path.join(flight_dir, fname)
            with open(path, "w") as f:
                json.dump(dump, f, indent=2, default=str)
            self._prune_dumps(flight_dir, keep=path)
        with self._lock:
            self.last_dump = dump
            self.last_dump_path = path
        logger.warning(
            "flight recorder: %s during %s — post-mortem %s "
            "(%d step records, %d events)",
            dump["exception"]["type"],
            dump["context"].get("where", "<unknown>"),
            path or "kept in memory (set PDTPU_FLIGHT_DIR to persist)",
            len(steps), len(events))
        return path

    def _prune_dumps(self, flight_dir: str, keep: str) -> None:
        """Oldest-first retention over the dump directory: alert-driven
        dumps must not fill the disk over a long incident. Never touches
        `keep` (the dump just written); failures are swallowed."""
        try:
            max_dumps = max(1, int(
                os.environ.get("PDTPU_FLIGHT_MAX_DUMPS", "32")))
            max_bytes = int(float(
                os.environ.get("PDTPU_FLIGHT_MAX_MB", "256")) * 1024 * 1024)
            entries = []
            for f in os.listdir(flight_dir):
                if not (f.startswith("flight_") and f.endswith(".json")):
                    continue
                p = os.path.join(flight_dir, f)
                try:
                    st = os.stat(p)
                    entries.append((st.st_mtime, p, st.st_size))
                except OSError:
                    continue
            entries.sort()  # oldest first (pid in the name breaks lexical)
            total = sum(sz for _, _, sz in entries)
            pruned = 0
            for _, p, sz in entries:
                if len(entries) - pruned <= max_dumps and total <= max_bytes:
                    break
                if p == keep:
                    continue
                try:
                    os.unlink(p)
                    pruned += 1
                    total -= sz
                except OSError:
                    pass
            if pruned:
                from .registry import get_registry
                get_registry().counter("flight/dumps_pruned").inc(pruned)
        except Exception:
            pass

    @contextlib.contextmanager
    def guard(self, where: str, **ctx):
        """Wrap a device-dispatch site: on OOM, dump then re-raise the
        ORIGINAL exception unchanged (bare raise)."""
        try:
            yield
        except BaseException as e:
            if is_oom(e):
                self.record_failure(e, context={"where": where, **ctx})
            raise

    def reset(self) -> None:
        with self._lock:
            self._steps.clear()
            self._events.clear()
            self.last_dump = None
            self.last_dump_path = None


_recorder = FlightRecorder()


def get_flight_recorder() -> FlightRecorder:
    """THE process-wide flight recorder all dispatch sites report into."""
    return _recorder
