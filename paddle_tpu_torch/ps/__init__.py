"""paddle_tpu_torch.ps — sharded parameter-server embedding tier (the port
of ``paddle_tpu.ps``).

* :mod:`.shard` — ``RangeSpec`` (contiguous row-range partition) and
  ``EmbeddingShard`` (one table slice as packed ``[n, 128] uint16`` rows,
  numpy only);
* :mod:`.transport` — ``ShardClient`` (in-process direct dispatch or the
  length-prefixed socket protocol with reconnect + capped-backoff retry
  and the ``TransportError(transient)`` taxonomy) and ``ShardServer``;
* :mod:`.table` — ``ShardedTable``: sorted-id fan-out pull/push with
  per-shard byte accounting, the client-side push journal and
  ``recover_shard`` (lossless rebuild of a restarted shard from the newest
  verified checkpoint + journal replay);
* :mod:`.dynamic` — ``DynamicEmbeddingShard``: rows materialize on first
  pull into a bounded slab and cold ids are swept out (TTL + watermark
  LFU);
* :mod:`.health` — ``ShardMonitor``: periodic shard pings driving
  ``ps/shard_up`` gauges and the ``ps/shards`` /healthz check;
* :mod:`.slab` and :mod:`.hot_cache` — ``HotRowCache``: the
  device-resident, LFU-admitted hot-row slab whose write-back gather and
  admission scatter are the row kernels 13 and 14;
* :mod:`.tier` — ``PsEmbeddingTier``: the worker-side training driver,
  pulls inline or prefetched, push synchronous or bounded-depth async,
  bitwise exact against the single-table packed baseline;
  ``attach_checkpointer`` arms recover-and-resume on shard outages.

A pserver host loads neither torch nor JAX: the shard, transport,
dynamic-shard and health modules are numpy + stdlib, and the four names
that need torch (``HotRowCache``, ``CachePlan``, ``PsEmbeddingTier``,
``PsTableBinding``) are imported on first use.
"""
from .dynamic import (DynamicEmbeddingShard,  # noqa: F401
                      make_dynamic_shards, zero_init_rows)
from .health import ShardMonitor  # noqa: F401
from .shard import EmbeddingShard, RangeSpec, make_shards  # noqa: F401
from .slab import FreqSketch, LruOrder, SlotMap  # noqa: F401
from .table import ShardedTable  # noqa: F401
from .transport import (InProcessClient, ShardClient,  # noqa: F401
                        ShardRestartedError, ShardServer, SocketClient,
                        TransportError, connect, probe)

__all__ = [
    "RangeSpec", "EmbeddingShard", "make_shards",
    "ShardClient", "InProcessClient", "SocketClient", "ShardServer",
    "TransportError", "ShardRestartedError", "connect", "probe",
    "ShardedTable", "ShardMonitor", "PsTableBinding", "PsEmbeddingTier",
    "HotRowCache", "CachePlan", "SlotMap", "LruOrder", "FreqSketch",
    "DynamicEmbeddingShard", "make_dynamic_shards", "zero_init_rows",
]

# names whose modules import torch: loaded on first access
_LAZY = {"HotRowCache": "hot_cache", "CachePlan": "hot_cache",
         "PsEmbeddingTier": "tier", "PsTableBinding": "tier"}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib
    value = getattr(importlib.import_module(f".{mod}", __name__), name)
    globals()[name] = value
    return value
