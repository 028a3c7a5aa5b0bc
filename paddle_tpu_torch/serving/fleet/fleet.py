"""ServingFleet: registry + replicas + router, wired end to end.

The deployment object a serving host runs: build N shared-nothing
replicas (threads or subprocesses) for a registered model version, put
the FleetRouter in front, and drive lifecycle operations against
*versions*, never raw files:

* ``rollout(version)`` — zero-downtime fleet-wide weight swap. One
  replica at a time: background-warm the new version (`warmup()` runs
  every bucket once), flip
  atomically, drain the old server. The rest of the fleet keeps serving
  throughout, so fleet capacity never drops below N-1 warm replicas and
  no request is dropped.
* ``ab_split(version_b, weight_b)`` — swap a subset of replicas to
  version B and weight the router: weighted A/B between two live
  versions.
* ``submit()/infer()`` — the router's failover-wrapped request path.

Multi-tenant co-hosting: pass ``tenants={name: {"version": v,
"weight": w, "slo_p99_ms": ms}}`` and the replica pool is partitioned
by weight (largest remainder, every tenant keeps at least one replica),
each partition serving its tenant's model version. Requests then carry
``tenant=``; the router enforces the weighted admission share and
tracks per-tenant p99 against the declared SLO (``tenant_stats()``).
``rollout(version, tenant=...)`` swaps one tenant's partition without
touching the others.

``device`` places every replica built without a ``predictor_factory``
(None: CUDA device 0; ``"cpu"``; ``"cuda:N"``).
"""
from __future__ import annotations

import math
import time

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..batcher import DEFAULT_BUCKETS
from .registry import ModelRegistry
from .replica import ProcessReplica, ThreadReplica
from .router import FleetRouter

__all__ = ["ServingFleet"]


def _partition_by_weight(total: int, weights: Dict[str, float]) -> Dict[str, int]:
    """Split `total` replica slots across tenants proportional to weight:
    floor of the proportional quota on top of a guaranteed 1 each, then
    largest-remainder for what's left."""
    names = list(weights)
    if total < len(names):
        raise ValueError(f"{len(names)} tenants need at least "
                         f"{len(names)} replicas (got {total})")
    wsum = sum(weights.values())
    rest = total - len(names)
    quota = {n: weights[n] / wsum * rest for n in names}
    alloc = {n: 1 + int(math.floor(quota[n])) for n in names}
    leftover = total - sum(alloc.values())
    for n in sorted(names, key=lambda n: quota[n] - math.floor(quota[n]),
                    reverse=True)[:leftover]:
        alloc[n] += 1
    return alloc


class ServingFleet:
    def __init__(self, registry: ModelRegistry, version: Optional[str] = None,
                 replicas: int = 3, mode: str = "thread",
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 policy: str = "least_outstanding", warm: bool = True,
                 predictor_factory=None, example_feed=None,
                 server_kwargs: Optional[dict] = None,
                 env: Optional[dict] = None,
                 health_interval_s: Optional[float] = None, seed: int = 0,
                 tenants: Optional[Dict[str, dict]] = None,
                 tenant_capacity: Optional[int] = None,
                 device: Optional[str] = None):
        if replicas < 1:
            raise ValueError("a fleet needs at least one replica")
        if mode not in ("thread", "process"):
            raise ValueError(f"unknown fleet mode {mode!r}")
        if mode == "process" and predictor_factory is not None:
            raise ValueError("predictor_factory is thread-mode only (a "
                             "subprocess builds its own predictor)")
        self.registry = registry
        self.mode = mode
        self._tenants = tenants
        self._replicas: List = []

        def build(name, model, tenant=None):
            if mode == "thread":
                r = ThreadReplica(
                    name, model, buckets=buckets,
                    predictor_factory=predictor_factory, warm=warm,
                    example_feed=example_feed, server_kwargs=server_kwargs,
                    device=device)
            else:
                r = ProcessReplica(name, model, buckets=buckets, warm=warm,
                                   env=env, server_kwargs=server_kwargs,
                                   device=device)
            r.tenant = tenant
            self._replicas.append(r)
            return r

        if tenants:
            # tenant partitions: each tenant's replicas serve its own
            # version; the int `replicas` is the total pool being split
            alloc = _partition_by_weight(
                replicas,
                {n: float(s.get("weight", 1.0)) for n, s in tenants.items()})
            for tname, spec in tenants.items():
                v = spec.get("version") or version or registry.latest()
                if v is None:
                    raise ValueError(f"tenant {tname!r} names no version "
                                     "and the registry is empty")
                model = registry.resolve(v)
                for i in range(alloc[tname]):
                    build(f"{tname}/replica-{i}", model, tenant=tname)
        else:
            version = version if version is not None else registry.latest()
            if version is None:
                raise ValueError(
                    "registry is empty — register a version first")
            model = registry.resolve(version)
            for i in range(replicas):
                build(f"replica-{i}", model)
        if mode == "process":
            # spawned all workers above; wait after, so startup cost is
            # one worker's wall time, not N of them
            for r in self._replicas:
                r.wait_ready()
        self.router = FleetRouter(self._replicas, policy=policy,
                                  health_interval_s=health_interval_s,
                                  seed=seed)
        if tenants:
            self.router.set_tenants(
                {n: {"weight": s.get("weight", 1.0),
                     "slo_p99_ms": s.get("slo_p99_ms")}
                 for n, s in tenants.items()},
                capacity=tenant_capacity)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "ServingFleet":
        self.router.start()
        return self

    def stop(self) -> dict:
        self.router.close()
        reports = {}
        for r in self._replicas:
            try:
                reports[r.name] = r.stop()
            except Exception as e:
                reports[r.name] = {"error": str(e)[:200]}
        return reports

    def __enter__(self) -> "ServingFleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- request path -------------------------------------------------------
    def submit(self, feed: Dict[str, np.ndarray],
               timeout_ms: Optional[float] = None,
               tenant: Optional[str] = None):
        return self.router.submit(feed, timeout_ms=timeout_ms, tenant=tenant)

    def infer(self, feed: Dict[str, np.ndarray],
              timeout_ms: Optional[float] = None,
              tenant: Optional[str] = None) -> List[np.ndarray]:
        return self.router.infer(feed, timeout_ms=timeout_ms, tenant=tenant)

    def tenant_stats(self) -> Optional[dict]:
        return self.router.tenant_stats()

    # -- version management -------------------------------------------------
    @property
    def replicas(self) -> List:
        return list(self._replicas)

    def versions_live(self) -> Dict[str, int]:
        live: Dict[str, int] = {}
        for r in self._replicas:
            if r.alive:
                live[r.version] = live.get(r.version, 0) + 1
        return live

    def rollout(self, version: str,
                only: Optional[Sequence[str]] = None,
                tenant: Optional[str] = None) -> dict:
        """Swap every live replica (or the named subset, or one tenant's
        partition) to `version`, one at a time, each swap
        warm-then-flip-then-drain. Returns the per-replica swap reports;
        a replica that died mid-rollout is reported, not fatal (the rest
        of the fleet still converges)."""
        model = self.registry.resolve(version)
        t0 = time.monotonic()
        reports = {}
        names = set(only) if only is not None else None
        for r in self._replicas:
            if tenant is not None and getattr(r, "tenant", None) != tenant:
                continue
            if names is not None and r.name not in names:
                continue
            if not r.alive:
                reports[r.name] = {"skipped": "replica dead"}
                continue
            try:
                reports[r.name] = r.swap(model)
            except Exception as e:
                reports[r.name] = {"error": f"{type(e).__name__}: "
                                            f"{str(e)[:200]}"}
        # re-sweep now: replicas that looked draining mid-swap are
        # eligible again the moment their new server answers healthy
        self.router.sweep()
        return {"version": version, "wall_ms": (time.monotonic() - t0) * 1e3,
                "replicas": reports}

    def ab_split(self, version_b: str, weight_b: float = 0.5,
                 count: Optional[int] = None) -> dict:
        """Weighted A/B: swap `count` replicas (default: the weighted
        share, at least 1) to `version_b` and set router weights so
        traffic splits `1-weight_b` / `weight_b` between the versions."""
        if not 0.0 < weight_b < 1.0:
            raise ValueError("weight_b must be in (0, 1)")
        live = [r for r in self._replicas if r.alive]
        if len(live) < 2:
            raise ValueError("A/B needs at least 2 live replicas")
        if count is None:
            count = max(1, min(len(live) - 1,
                               int(math.floor(weight_b * len(live) + 0.5))))
        version_a = live[0].version
        report = self.rollout(version_b,
                              only=[r.name for r in live[-count:]])
        self.router.set_version_weights(
            {version_a: 1.0 - weight_b, version_b: weight_b})
        return report

    def stats(self) -> dict:
        return {"mode": self.mode, "versions_live": self.versions_live(),
                "tenants": self.tenant_stats(),
                "router": self.router.stats()}
