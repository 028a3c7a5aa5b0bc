"""Device-memory stats and gauges (the port's counterpart of
``paddle_tpu.observability.memory``).

The card's caching-allocator numbers under the JAX package's key names,
read by the planner (``planner.resolve_budget_bytes``: a budget is a
fraction of ``bytes_limit``), and two gauges, set after a plan's first
run (once per plan: that is when layouts can have changed):

- ``memory/state_bytes_per_device`` — bytes of model state (parameters,
  optimizer accumulators) resident on ONE device: a DTensor contributes
  its local shard, a plain tensor counts in full. On a mesh the mesh step
  sets it (``core/mesh_step.py`` ``record_state_bytes``).
- ``memory/hbm_bytes_in_use`` — the caching allocator's allocated bytes
  on the card; absent off the card.
"""
from __future__ import annotations

from typing import Iterable, Optional

from .registry import get_registry

__all__ = ["device_memory_stats", "per_device_state_bytes",
           "record_state_memory"]


def device_memory_stats(device=None) -> Optional[dict]:
    """The card's allocator numbers under the JAX package's key names
    (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``: the card's
    total memory), or None off the card (a CPU device, or no CUDA)."""
    import torch

    if device is not None:
        device = torch.device(device)
        if device.type != "cuda":
            return None
    if not torch.cuda.is_available():
        return None
    index = (device.index if device is not None and device.index is not None
             else torch.cuda.current_device())
    stats = torch.cuda.memory_stats(index)
    _free, total = torch.cuda.mem_get_info(index)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(total)}


def _leaf_bytes_on_device(v) -> int:
    """Bytes `v` occupies on one device: a DTensor's local shard, a
    tensor's elements."""
    local = getattr(v, "to_local", None)
    if callable(local) and type(v).__name__ == "DTensor":
        v = local()
    numel = getattr(v, "numel", None)
    if callable(numel):
        return int(numel()) * int(v.element_size())
    return int(getattr(v, "nbytes", 0))


def per_device_state_bytes(leaves: Iterable) -> int:
    """Sum of per-device bytes across `leaves`: the one-device footprint
    of the model state under its current shardings."""
    return sum(_leaf_bytes_on_device(v) for v in leaves)


def record_state_memory(leaves: Optional[Iterable] = None,
                        device=None) -> dict:
    """Set the memory gauges; returns what was recorded. Never raises:
    sampling must not take down a training run."""
    reg = get_registry()
    out = {}
    if leaves is not None:
        try:
            b = per_device_state_bytes(leaves)
        except Exception:
            b = None
        if b is not None:
            reg.gauge("memory/state_bytes_per_device").set(b)
            out["state_bytes_per_device"] = b
    try:
        stats = device_memory_stats(device)
    except Exception:
        stats = None
    if stats and stats.get("bytes_in_use") is not None:
        reg.gauge("memory/hbm_bytes_in_use").set(int(stats["bytes_in_use"]))
        out["hbm_bytes_in_use"] = int(stats["bytes_in_use"])
    return out
