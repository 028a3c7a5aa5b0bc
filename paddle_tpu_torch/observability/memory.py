"""Device-memory stats (the port's counterpart of
``paddle_tpu.observability.memory``'s ``device_memory_stats``).

The card's caching-allocator numbers under the JAX package's key names,
read by the planner (``planner.resolve_budget_bytes``: a budget is a
fraction of ``bytes_limit``). The per-rank state bytes gauge
(``memory/state_bytes_per_device``) is set by the mesh step
(``core/mesh_step.py`` ``record_state_bytes``).
"""
from __future__ import annotations

from typing import Optional

__all__ = ["device_memory_stats"]


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
