"""FleetRouter: the connection-distributing frontend of the replica set.

Routing policy: ``least_outstanding`` (default — send to the eligible
replica with the fewest unresolved requests; a slow or swap-warming
replica naturally sheds load) or ``round_robin``.

Health-driven shedding, off the same signals `/healthz` serves:

* **degraded** replicas (full queue, draining grace, deadline misses)
  are *deprioritized* — chosen only when no healthy replica is eligible;
* a replica whose server state is **draining** is removed from rotation
  immediately (new work stops before its admission closes — the
  `stop(drain=True)` contract);
* **failing**/dead replicas are *ejected* and re-admitted automatically
  when a later health sweep sees them healthy again (a replica that was
  merely overloaded or mid-swap comes back; a SIGKILLed process does
  not).

Failover: a request whose replica dies mid-flight (transient
`TransportError`, `ServerClosedError`, `ReplicaDeadError`) is retried
on a different replica — inference is idempotent, so replay is safe.
Each replica is tried at most once per request; non-replica errors
(`TimeoutError`, `ValueError` from a bad feed) surface to the caller
unchanged. `QueueFullError` also fails over (another replica may have
room) but surfaces when every replica is full — backpressure stays
explicit at the fleet boundary.

Multi-tenant co-hosting (generalizing the A/B weight split): replicas
carry a ``tenant`` tag and ``set_tenants`` declares the tenant table —
relative capacity weight plus an optional p99 SLO per tenant. A request
submitted with ``tenant=`` routes only to that tenant's replicas, and
admission is capped at the tenant's weighted share of fleet capacity
(`TenantThrottledError` — a bursting tenant is throttled at the door
instead of queuing behind everyone else's work, which is what keeps the
*other* tenants' p99 flat). Per-tenant latency lands in a labelled
histogram; ``tenant_stats`` reports p99-vs-SLO per tenant.
"""
from __future__ import annotations

import os
import random
import threading
import time

from concurrent.futures import Future
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..batcher import ServingError
from ..metrics import Metrics
from ..server import QueueFullError, ServerClosedError
from ...observability import context as _trace_ctx
from ...observability.tracer import trace_span
from ...ps.transport import TransportError
from .replica import ReplicaDeadError

__all__ = ["FleetRouter", "NoReplicaAvailableError", "TenantThrottledError"]

# a replica died under the request — replay it elsewhere
_FAILOVER_ERRORS = (TransportError, ServerClosedError, ReplicaDeadError,
                    ConnectionError, EOFError)


class NoReplicaAvailableError(ServingError):
    """Every replica is ejected, draining, or already tried."""


class TenantThrottledError(ServingError):
    """The tenant is at its weighted capacity share — back off and retry.

    Raised at admission, before any replica queue is touched: one
    tenant's burst must not consume fleet headroom another tenant's SLO
    depends on."""


class _ReplicaSlot:
    __slots__ = ("replica", "eligible", "degraded", "ejected")

    def __init__(self, replica):
        self.replica = replica
        self.eligible = True
        self.degraded = False
        self.ejected = False


class FleetRouter:
    def __init__(self, replicas: Sequence, policy: str = "least_outstanding",
                 health_interval_s: Optional[float] = None,
                 metrics: Optional[Metrics] = None, seed: int = 0):
        if not replicas:
            raise ValueError("FleetRouter needs at least one replica")
        if policy not in ("least_outstanding", "round_robin"):
            raise ValueError(f"unknown policy {policy!r}")
        self._slots = [_ReplicaSlot(r) for r in replicas]
        self._by_name = {s.replica.name: s for s in self._slots}
        if len(self._by_name) != len(self._slots):
            raise ValueError("replica names must be unique")
        self.policy = policy
        self.metrics = metrics if metrics is not None else Metrics()
        self._lock = threading.Lock()
        self._rr = 0
        self._rng = random.Random(seed)
        self._weights: Optional[Dict[str, float]] = None
        # tenancy: {tenant: {"weight": normalized, "slo_p99_ms": float|None,
        #                    "share": max in-flight}} — None = single-tenant
        self._tenants: Optional[Dict[str, dict]] = None
        self._tenant_out: Dict[str, int] = {}
        self._interval = (health_interval_s if health_interval_s is not None
                          else float(os.environ.get(
                              "PDTPU_FLEET_HEALTH_INTERVAL", "0.5")))
        self._stop_evt = threading.Event()
        self._health_thread: Optional[threading.Thread] = None

    # -- health sweep -------------------------------------------------------
    def start(self) -> "FleetRouter":
        if self._health_thread is None:
            self.sweep()
            self._stop_evt.clear()
            t = threading.Thread(target=self._health_loop, daemon=True,
                                 name="fleet-health")
            self._health_thread = t
            t.start()
        return self

    def close(self) -> None:
        self._stop_evt.set()
        t, self._health_thread = self._health_thread, None
        if t is not None:
            t.join(timeout=5.0)

    def _health_loop(self) -> None:
        while not self._stop_evt.wait(self._interval):
            try:
                self.sweep()
            except Exception:
                pass  # a broken sweep must never kill routing

    def sweep(self) -> dict:
        """One health pass over every replica; returns the fleet view."""
        view = {}
        for slot in self._slots:
            r = slot.replica
            try:
                h = r.health() if r.alive else {"status": "failing",
                                                "state": "dead"}
            except Exception as e:
                h = {"status": "failing", "state": "unreachable",
                     "error": str(e)[:200]}
            status = h.get("status", "failing")
            state = h.get("state", "")
            with self._lock:
                if status == "failing" or state in ("dead", "stopped"):
                    if not slot.ejected:
                        slot.ejected = True
                        self.metrics.counter("fleet/ejections").inc()
                    slot.eligible = False
                elif state == "draining":
                    # cooperative drain: not dead, but take no new work
                    slot.eligible = False
                else:
                    if slot.ejected:
                        slot.ejected = False
                        self.metrics.counter("fleet/readmissions").inc()
                    slot.eligible = True
                    slot.degraded = (status == "degraded")
            view[r.name] = h
        with self._lock:
            live = sum(1 for s in self._slots if s.eligible)
        self.metrics.gauge("fleet/replicas_eligible").set(live)
        return view

    def _suspect(self, name: str) -> None:
        """Immediate demotion on an observed failure — don't keep routing
        to a corpse until the next sweep re-confirms it."""
        with self._lock:
            slot = self._by_name.get(name)
            if slot is not None and slot.eligible:
                slot.eligible = False

    # -- A/B ----------------------------------------------------------------
    def set_version_weights(self,
                            weights: Optional[Dict[str, float]]) -> None:
        """Weighted A/B routing across the versions currently served by
        the fleet (None restores version-blind routing). Weights are
        relative; versions with no eligible replica fall through to the
        rest of the fleet."""
        if weights is not None:
            total = sum(float(w) for w in weights.values())
            if total <= 0:
                raise ValueError("version weights must sum to > 0")
            weights = {v: float(w) / total for v, w in weights.items()}
        with self._lock:
            self._weights = weights

    # -- tenancy ------------------------------------------------------------
    def set_tenants(self, tenants: Optional[Dict[str, dict]],
                    capacity: Optional[int] = None) -> None:
        """Declare the tenant table: ``{name: {"weight": w,
        "slo_p99_ms": ms}}`` (None returns to single-tenant routing).
        ``capacity`` is the fleet-wide in-flight budget the weights
        divide (default: 8 × replica count); every tenant gets at least
        one admission slot."""
        if tenants is None:
            with self._lock:
                self._tenants = None
                self._tenant_out = {}
            return
        total = sum(float(t.get("weight", 1.0)) for t in tenants.values())
        if total <= 0:
            raise ValueError("tenant weights must sum to > 0")
        cap = int(capacity) if capacity is not None else 8 * len(self._slots)
        table = {}
        for name, spec in tenants.items():
            w = float(spec.get("weight", 1.0)) / total
            slo = spec.get("slo_p99_ms")
            table[name] = {"weight": w,
                           "slo_p99_ms": None if slo is None else float(slo),
                           "share": max(1, int(round(w * cap)))}
        with self._lock:
            self._tenants = table
            self._tenant_out = {name: 0 for name in table}

    def _admit(self, tenant: str) -> None:
        """Count the request against the tenant's capacity share."""
        with self._lock:
            table = self._tenants
            if table is None:
                return
            spec = table.get(tenant)
            if spec is None:
                raise ValueError(f"unknown tenant {tenant!r}; declared: "
                                 f"{sorted(table)}")
            if self._tenant_out[tenant] >= spec["share"]:
                self.metrics.counter("fleet/tenant_throttled",
                                     tenant=tenant).inc()
                raise TenantThrottledError(
                    f"tenant {tenant!r} at capacity share "
                    f"({spec['share']} in flight)")
            self._tenant_out[tenant] += 1

    def _release(self, tenant: str, t0: float, ok: bool) -> None:
        with self._lock:
            if self._tenants is not None and tenant in self._tenant_out:
                self._tenant_out[tenant] = max(
                    0, self._tenant_out[tenant] - 1)
        if ok:
            self.metrics.histogram("fleet/tenant_latency_ms",
                                   tenant=tenant).observe(
                (time.monotonic() - t0) * 1e3)

    def tenant_stats(self) -> Optional[dict]:
        """Per-tenant view: share, in-flight, request/throttle counts,
        observed p99 against the declared SLO (``slo_ok`` is None until
        latency samples exist)."""
        with self._lock:
            table = self._tenants
            if table is None:
                return None
            out = dict(self._tenant_out)
            table = {k: dict(v) for k, v in table.items()}
        stats = {}
        for name, spec in table.items():
            p99 = self.metrics.histogram(
                "fleet/tenant_latency_ms", tenant=name).percentile(99)
            slo = spec["slo_p99_ms"]
            stats[name] = {
                "weight": spec["weight"], "share": spec["share"],
                "outstanding": out.get(name, 0),
                "requests": self.metrics.counter(
                    "fleet/tenant_requests", tenant=name).value,
                "throttled": self.metrics.counter(
                    "fleet/tenant_throttled", tenant=name).value,
                "p99_ms": p99, "slo_p99_ms": slo,
                "slo_ok": (None if p99 is None or slo is None
                           else bool(p99 <= slo)),
            }
        return stats

    # -- replica choice -----------------------------------------------------
    def _pick(self, exclude: set, tenant: Optional[str] = None):
        with self._lock:
            cands = [s for s in self._slots
                     if s.eligible and s.replica.name not in exclude
                     and s.replica.alive]
            if tenant is not None:
                cands = [s for s in cands
                         if getattr(s.replica, "tenant", None) == tenant]
            if not cands:
                return None
            weights = self._weights
            if weights:
                present = [v for v in weights
                           if any(s.replica.version == v for s in cands)]
                if present:
                    r = self._rng.random() * sum(weights[v] for v in present)
                    acc = 0.0
                    chosen = present[-1]
                    for v in present:
                        acc += weights[v]
                        if r < acc:
                            chosen = v
                            break
                    cands = [s for s in cands
                             if s.replica.version == chosen]
            healthy = [s for s in cands if not s.degraded]
            pool = healthy or cands  # degraded → deprioritized, not dead
            if self.policy == "round_robin":
                self._rr += 1
                return pool[self._rr % len(pool)].replica
            return min(pool, key=lambda s: s.replica.outstanding).replica

    # -- request path -------------------------------------------------------
    def submit(self, feed: Dict[str, np.ndarray],
               timeout_ms: Optional[float] = None,
               tenant: Optional[str] = None) -> Future:
        """Route one request; the returned Future resolves to the output
        slices. Failover happens inside — the caller only ever sees a
        non-replica error or the final result. With ``tenant=`` the
        request is admission-checked against the tenant's capacity share
        (raising :class:`TenantThrottledError` synchronously) and routed
        only to that tenant's replicas."""
        outer: Future = Future()
        attempted: set = set()
        if tenant is not None:
            self._admit(tenant)  # raises before any queue is touched
            self.metrics.counter("fleet/tenant_requests",
                                 tenant=tenant).inc()
            t0 = time.monotonic()
            outer.add_done_callback(
                lambda f: self._release(tenant, t0, f.exception() is None))
        self.metrics.counter("fleet/requests").inc()
        # every routed request is one distributed trace: adopt the
        # caller's context or root a fresh one here — try_next may run
        # on a callback thread (failover), so the root is re-activated
        # explicitly at every attempt
        root = _trace_ctx.current() or _trace_ctx.new_trace()

        def try_next(last_error: Optional[Exception]) -> None:
            replica = self._pick(attempted, tenant)
            if replica is None:
                outer.set_exception(last_error or NoReplicaAvailableError(
                    f"no eligible replica"
                    + (f" for tenant {tenant!r}" if tenant else "")
                    + f" (tried {sorted(attempted)})"))
                return
            attempted.add(replica.name)
            try:
                with _trace_ctx.use(root), \
                        trace_span("fleet/route", replica=replica.name,
                                   attempt=len(attempted)):
                    inner = replica.submit(feed, timeout_ms=timeout_ms)
            except _FAILOVER_ERRORS as e:
                self._suspect(replica.name)
                self.metrics.counter("fleet/retries").inc()
                try_next(e)
                return
            except QueueFullError as e:
                self.metrics.counter("fleet/retries").inc()
                try_next(e)  # replica stays eligible — it is just full
                return
            except Exception as e:
                outer.set_exception(e)
                return

            def done(f: Future) -> None:
                exc = f.exception()
                if exc is None:
                    outer.set_result(f.result())
                elif isinstance(exc, _FAILOVER_ERRORS):
                    self._suspect(replica.name)
                    self.metrics.counter("fleet/retries").inc()
                    try_next(exc)
                elif isinstance(exc, QueueFullError):
                    self.metrics.counter("fleet/retries").inc()
                    try_next(exc)
                else:
                    outer.set_exception(exc)

            inner.add_done_callback(done)

        try_next(None)
        return outer

    def infer(self, feed: Dict[str, np.ndarray],
              timeout_ms: Optional[float] = None,
              tenant: Optional[str] = None) -> List[np.ndarray]:
        return self.submit(feed, timeout_ms=timeout_ms,
                           tenant=tenant).result()

    # -- introspection ------------------------------------------------------
    @property
    def replicas(self) -> List:
        return [s.replica for s in self._slots]

    def stats(self) -> dict:
        with self._lock:
            per = {s.replica.name: {
                "eligible": s.eligible, "degraded": s.degraded,
                "ejected": s.ejected, "alive": s.replica.alive,
                "version": s.replica.version,
                "tenant": getattr(s.replica, "tenant", None),
                "outstanding": s.replica.outstanding}
                for s in self._slots}
            weights = dict(self._weights) if self._weights else None
        return {"policy": self.policy, "replicas": per,
                "version_weights": weights,
                "tenants": self.tenant_stats(),
                "metrics": self.metrics.snapshot()}
