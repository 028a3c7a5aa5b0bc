"""Executor re-prepare watchdog: detect and diagnose plan-cache storms.

Copy of ``paddle_tpu.observability.watchdog`` (stdlib only). The port's
executor prepares one plan per (program, feed signature, fetch names,
state names): the sorted state, the read set, the autodiff targets, the
remat units and the update-fusion schedule. A feed whose shape or dtype
drifts makes every step re-prepare (and, for the update fusion, decide
its groups again) instead of replaying a cached plan, and nothing in the
output says why. In the JAX package a miss costs an XLA compile; here it
costs host time, so the same watchdog names the drifting feed.

`RecompileWatchdog.record_compile(key, feed_sig)` is called by the
executor on every plan-cache miss. When one program key has
compiled more than `threshold` times, a single `RecompileWarning` is
emitted that names the exact feed keys whose shape/dtype diverged
between the previous and the new signature — the actionable part
("pad/bucket feed 'x'") rather than just "slow".

Threshold default is 8, overridable with PDTPU_RECOMPILE_THRESHOLD (0
disables the warning; compiles are still counted in the registry).
"""
from __future__ import annotations

import os
import threading
import warnings
from typing import Dict, List, Optional

__all__ = ["RecompileWarning", "RecompileWatchdog", "get_watchdog"]


class RecompileWarning(UserWarning):
    """One program recompiled beyond the watchdog threshold."""


def _sig_dict(feed_sig) -> dict:
    """feed_signature tuple of (name, shape, dtype) -> {name: (shape, dtype)}."""
    return {name: (shape, dtype) for name, shape, dtype in feed_sig}


def diff_signatures(prev, new) -> List[str]:
    """Human-readable list of diverging feed keys between two
    `core.executor.feed_signature` tuples."""
    a, b = _sig_dict(prev), _sig_dict(new)
    out: List[str] = []
    for name in sorted(set(a) | set(b)):
        if name not in b:
            out.append(f"feed {name!r} removed (was "
                       f"shape={a[name][0]} dtype={a[name][1]})")
        elif name not in a:
            out.append(f"feed {name!r} added "
                       f"(shape={b[name][0]} dtype={b[name][1]})")
        elif a[name] != b[name]:
            (ash, adt), (bsh, bdt) = a[name], b[name]
            parts = []
            if ash != bsh:
                parts.append(f"shape {ash} -> {bsh}")
            if adt != bdt:
                parts.append(f"dtype {adt} -> {bdt}")
            out.append(f"feed {name!r} changed " + ", ".join(parts))
    return out


class _Entry:
    __slots__ = ("count", "last_sig", "warned", "diverging")

    def __init__(self):
        self.count = 0
        self.last_sig = None
        self.warned = False
        self.diverging: Dict[str, int] = {}  # feed key -> times it diverged


class RecompileWatchdog:
    """Per-program compile counting + signature-diff diagnosis."""

    def __init__(self, threshold: Optional[int] = None):
        if threshold is None:
            threshold = int(os.environ.get("PDTPU_RECOMPILE_THRESHOLD", "8"))
        self.threshold = threshold
        self._lock = threading.Lock()
        self._entries: Dict[object, _Entry] = {}

    def record_compile(self, key, feed_sig, label: str = "program") -> bool:
        """Count one executable compile for program `key` with `feed_sig`.
        Returns True the first time `key` is seen (so the caller can hook
        lifetime cleanup, e.g. weakref.finalize -> `forget`). Emits ONE
        RecompileWarning per key once compiles exceed the threshold."""
        with self._lock:
            ent = self._entries.get(key)
            fresh = ent is None
            if fresh:
                ent = self._entries[key] = _Entry()
            ent.count += 1
            diag: List[str] = []
            if ent.last_sig is not None and ent.last_sig != feed_sig:
                diag = diff_signatures(ent.last_sig, feed_sig)
                for name in _diverging_names(ent.last_sig, feed_sig):
                    ent.diverging[name] = ent.diverging.get(name, 0) + 1
            prev_sig = ent.last_sig
            ent.last_sig = feed_sig
            warn_now = (self.threshold > 0 and not ent.warned
                        and ent.count > self.threshold)
            if warn_now:
                ent.warned = True
                count = ent.count
                hot = sorted(ent.diverging.items(), key=lambda kv: -kv[1])
        if warn_now:
            detail = ("; ".join(diag) if diag else
                      "signature identical to the previous compile — the "
                      "recompiles come from program/fetch changes, not feeds")
            hot_txt = ("" if not hot else
                       " Most-diverging feeds so far: "
                       + ", ".join(f"{n!r} ({c}x)" for n, c in hot[:3]) + ".")
            warnings.warn(RecompileWarning(
                f"{label} recompiled {count} times (threshold "
                f"{self.threshold}) — every compile re-prepares the "
                f"step's plan. Last change: {detail}.{hot_txt} Pad or "
                f"bucket the offending feeds to a fixed set of shapes "
                f"(see reader.bucket_by_sequence_length / serving "
                f"batch buckets)."), stacklevel=3)
        return fresh

    def compile_count(self, key) -> int:
        with self._lock:
            ent = self._entries.get(key)
            return ent.count if ent is not None else 0

    def state(self) -> dict:
        """JSON-safe view of every tracked program (flight-dump section):
        compile count, warned flag, and per-feed divergence counts."""
        with self._lock:
            return {
                "threshold": self.threshold,
                "programs": [
                    {"key": repr(key)[:200],
                     "compiles": ent.count,
                     "warned": ent.warned,
                     "diverging_feeds": dict(ent.diverging)}
                    for key, ent in self._entries.items()
                ],
            }

    def forget(self, key) -> None:
        """Drop a program's entry (hooked to program GC by the executor so
        a recycled id() cannot inherit a dead program's compile count)."""
        with self._lock:
            self._entries.pop(key, None)

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()


def _diverging_names(prev, new) -> List[str]:
    a, b = _sig_dict(prev), _sig_dict(new)
    return [n for n in set(a) | set(b) if a.get(n) != b.get(n)]


_watchdog = RecompileWatchdog()


def get_watchdog() -> RecompileWatchdog:
    """The process-wide watchdog the Executor reports compiles to."""
    return _watchdog
