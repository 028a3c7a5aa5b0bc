"""paddle_tpu_torch.serving.fleet — replica scale-out for the serving tier
(the port of ``paddle_tpu.serving.fleet``).

The fleet half of "millions of users": N shared-nothing
`InferenceServer` replicas (threads or SIGKILL-able subprocesses)
behind a `FleetRouter` that distributes requests (least-outstanding or
round-robin), sheds load off per-replica `/healthz` signals (degraded →
deprioritize, draining → stop sending, failing → eject, re-admit on
recovery) and replays idempotent requests on a different replica when
one dies mid-flight; a `ModelRegistry` of versioned, manifest-verified
model directories; `ServingFleet.rollout()` for zero-downtime weight
swaps (background-warm → atomic flip → drain, one replica at a time)
and `ab_split()` for weighted A/B between two live versions.

Multi-tenant co-hosting: `ServingFleet(..., tenants={...})` partitions
the replica pool by tenant weight (each partition serving its tenant's
model version), routes `infer(feed, tenant=...)` only within the
partition, throttles each tenant at its weighted admission share
(`TenantThrottledError`) and tracks per-tenant p99 against a declared
SLO (`tenant_stats()`).

PS-backed CTR serving plugs in through `predictor_factory`: build each
replica's predictor as an `inference.PsLookupPredictor` and the fleet
serves a big-table model while every replica holds only an LRU row
cache (rows pulled from the live `ps.ShardedTable`).

Replicas serve on the card unless the fleet is built with
``device="cpu"`` (a process replica's worker gets ``--device``): the
worker is a fresh interpreter, never a fork of a process whose CUDA is
up.

Minimal end-to-end::

    from paddle_tpu_torch.serving import fleet

    reg = fleet.ModelRegistry()
    reg.register("v1", model_dir_v1)
    with fleet.ServingFleet(reg, "v1", replicas=3, mode="process") as f:
        out, = f.infer({"x": rows})
        reg.register("v2", model_dir_v2)
        f.rollout("v2")            # zero requests dropped
"""
from .fleet import ServingFleet  # noqa: F401
from .registry import ModelRegistry, ModelVersion  # noqa: F401
from .replica import (ProcessReplica, ReplicaDeadError,  # noqa: F401
                      ThreadReplica)
from .router import (FleetRouter, NoReplicaAvailableError,  # noqa: F401
                     TenantThrottledError)

__all__ = [
    "FleetRouter", "ModelRegistry", "ModelVersion",
    "NoReplicaAvailableError", "ProcessReplica", "ReplicaDeadError",
    "ServingFleet", "TenantThrottledError", "ThreadReplica",
]
