"""ShardMonitor — client-side liveness tracking for the PS shard fleet (the
port's copy of ``paddle_tpu.ps.health``).

The transport's retry loop answers "is THIS rpc going to survive a
restart"; the monitor answers the orchestrator's question: "is the tier
healthy RIGHT NOW, and if not, is it a blip or a wedge". A daemon thread
pings every shard each ``PDTPU_PS_MONITOR_INTERVAL`` seconds (default 1)
and publishes three views of the same facts:

* ``ps/shard_up{shard=i}`` gauges (1/0) in the process metrics registry —
  the /metrics scrape and ``tools/ps_admin.py dump-health``;
* a registered ``/healthz`` check named ``ps/shards``: ``ok`` when every
  shard answered its last ping, ``degraded`` while any shard is down
  (recovery in progress — keep the process alive), escalating to
  ``failing`` once a shard has been down longer than
  ``PDTPU_WEDGE_TIMEOUT`` seconds (default 300, the knob the tier's
  recovery wait uses) — that is the "restart the job" signal;
* :meth:`status` — the structured form, for code.

Pings never ride the training connections: socket shards are probed with
a fresh one-shot connection (``transport.probe``), so a monitor sweep can
neither queue behind a large pull nor trip the persistent client's
restart detection. In-process shards are dispatched directly.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Union

from ..observability.http import (register_health_check,
                                  unregister_health_check)
from ..observability.registry import get_registry
from .transport import ShardClient, SocketClient, probe

__all__ = ["ShardMonitor"]

CHECK_NAME = "ps/shards"


def _pinger(target) -> Callable[[], bool]:
    """A zero-arg liveness probe for one shard (never raises)."""
    if isinstance(target, str):
        return lambda: probe(target)
    if isinstance(target, SocketClient):
        # fresh socket, NOT the training connection (see module docstring)
        return lambda: probe(target.endpoint)
    if isinstance(target, ShardClient):
        def ping():
            try:
                return bool(target.ping())
            except Exception:
                return False
        return ping
    raise TypeError(f"ShardMonitor: cannot ping {type(target).__name__}")


class ShardMonitor:
    """Pings every shard on an interval; gauges + /healthz + status().

    ``targets`` may mix ``"host:port"`` endpoint strings and
    ``ShardClient`` objects (the tier passes its pull clients). Use as a
    context manager or call ``start()``/``stop()``; ``poll_now()`` runs
    one synchronous sweep — tests use it to avoid timing races.
    """

    def __init__(self, targets: Sequence[Union[str, ShardClient]],
                 interval_s: Optional[float] = None,
                 check_name: str = CHECK_NAME):
        if not targets:
            raise ValueError("ShardMonitor: no shards to watch")
        self._pingers = [_pinger(t) for t in targets]
        self._labels = [t if isinstance(t, str)
                        else getattr(t, "endpoint", f"in-process:{i}")
                        for i, t in enumerate(targets)]
        self._interval = interval_s
        self._check_name = check_name
        self._up: List[bool] = [True] * len(self._pingers)
        self._down_since: List[Optional[float]] = [None] * len(self._pingers)
        self._polled = False
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        reg = get_registry()
        self._gauges = [reg.gauge("ps/shard_up", shard=str(i))
                        for i in range(len(self._pingers))]
        # the autoscaler-facing aggregate: the federation scraper reads
        # the per-shard gauges, but a single-process consumer (or an
        # alert rule) wants the count directly
        self._g_down = reg.gauge("ps/shards_down")

    @classmethod
    def for_endpoints(cls, endpoints: Sequence[str],
                      interval_s: Optional[float] = None) -> "ShardMonitor":
        return cls(list(endpoints), interval_s=interval_s)

    # ------------------------------------------------------------- polling
    def _cfg_interval(self) -> float:
        if self._interval is not None:
            return self._interval
        return float(os.environ.get("PDTPU_PS_MONITOR_INTERVAL", "1.0"))

    def poll_now(self) -> List[bool]:
        """One synchronous sweep; returns the per-shard up flags."""
        results = [p() for p in self._pingers]
        now = time.monotonic()
        with self._lock:
            for i, up in enumerate(results):
                self._up[i] = up
                if up:
                    self._down_since[i] = None
                elif self._down_since[i] is None:
                    self._down_since[i] = now
                self._gauges[i].set(1.0 if up else 0.0)
            self._g_down.set(sum(1 for up in results if not up))
            self._polled = True
        return results

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.poll_now()
            except Exception:
                pass  # a monitor must never kill the worker
            self._stop.wait(self._cfg_interval())

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ShardMonitor":
        if self._thread is not None:
            return self
        self._stop.clear()
        register_health_check(self._check_name, self._health)
        self._thread = threading.Thread(target=self._loop,
                                        name="ps-shard-monitor",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)
        unregister_health_check(self._check_name)

    def __enter__(self) -> "ShardMonitor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -------------------------------------------------------------- status
    def _health(self):
        """The registered /healthz check (see module docstring)."""
        wedge = float(os.environ.get("PDTPU_WEDGE_TIMEOUT", "300"))
        now = time.monotonic()
        with self._lock:
            if not self._polled:
                return "ok", "no sweep completed yet"
            down = [(i, now - t) for i, t in enumerate(self._down_since)
                    if t is not None]
        if not down:
            return "ok", f"{len(self._pingers)} shards up"
        worst = max(s for _, s in down)
        names = ", ".join(f"shard {i} ({self._labels[i]}) down {s:.1f}s"
                          for i, s in down)
        if worst > wedge:
            return "failing", f"wedged past {wedge:g}s: {names}"
        return "degraded", names

    def status(self) -> Dict[str, object]:
        now = time.monotonic()
        with self._lock:
            shards = [{
                "shard": i,
                "endpoint": self._labels[i],
                "up": self._up[i],
                "down_for_s": (0.0 if self._down_since[i] is None
                               else round(now - self._down_since[i], 3)),
            } for i in range(len(self._pingers))]
        st = self._health()
        status, detail = (st if isinstance(st, tuple) else (st, ""))
        return {"status": status, "detail": detail, "shards": shards}
