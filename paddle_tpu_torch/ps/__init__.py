"""paddle_tpu_torch.ps — sharded parameter-server embedding tier (the port
of ``paddle_tpu.ps``).

* :mod:`.shard` — ``RangeSpec`` (contiguous row-range partition) and
  ``EmbeddingShard`` (one table slice as packed ``[n, 128] uint16`` rows,
  numpy only);
* :mod:`.transport` — ``ShardClient`` and ``InProcessClient`` (direct
  dispatch onto shards in this process) and the ``TransportError``
  taxonomy; the socket transport raises ``NotImplementedError``;
* :mod:`.table` — ``ShardedTable``: sorted-id fan-out pull/push with
  per-shard byte accounting and the client-side push journal;
* :mod:`.slab` and :mod:`.hot_cache` — ``HotRowCache``: the
  device-resident, LFU-admitted hot-row slab whose write-back gather and
  admission scatter are the row kernels 13 and 14;
* :mod:`.tier` — ``PsEmbeddingTier``: the worker-side training driver,
  pull inline and push synchronous or bounded-depth async, bitwise exact
  against the single-table packed baseline.

Not ported yet: the socket transport, ``health``, ``dynamic`` shards,
shard recovery and prefetching pulls (``pull_ahead >= 1``).
"""
from .hot_cache import CachePlan, HotRowCache  # noqa: F401
from .shard import EmbeddingShard, RangeSpec, make_shards  # noqa: F401
from .slab import FreqSketch, LruOrder, SlotMap  # noqa: F401
from .table import ShardedTable  # noqa: F401
from .tier import PsEmbeddingTier, PsTableBinding  # noqa: F401
from .transport import (InProcessClient, ShardClient,  # noqa: F401
                        ShardRestartedError, ShardServer, SocketClient,
                        TransportError, connect)

__all__ = [
    "RangeSpec", "EmbeddingShard", "make_shards",
    "ShardClient", "InProcessClient", "SocketClient", "ShardServer",
    "TransportError", "ShardRestartedError", "connect",
    "ShardedTable", "PsTableBinding", "PsEmbeddingTier",
    "HotRowCache", "CachePlan", "SlotMap", "LruOrder", "FreqSketch",
]
