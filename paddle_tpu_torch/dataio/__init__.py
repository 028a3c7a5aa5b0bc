"""paddle_tpu_torch.dataio — the asynchronous host→device input pipeline.

- **DeviceLoader** (loader.py) — a background worker that pulls batches
  from any reader, converts them on the host, pins them and copies them
  to the card on a side CUDA stream into a bounded queue, so host-side
  batch prep and the H2D copy overlap the running step; each batch is
  handed to the consumer's stream with an event. ``PyReader(
  use_double_buffer=True)``, ``Executor.train_from_dataset`` /
  ``train_scanned`` and the PS tier's prefetcher ride on it.
- **FetchHandle** (handle.py) — un-synced fetch results from
  ``Executor.run(..., return_handle=True)``: the step's kernels keep
  running on the card while the host moves on; ``.numpy()`` is the
  explicit sync point.

Together they pipeline: step N runs on the card while the loader converts
and copies batch N+1 and the trainer holds up to
``PDTPU_MAX_INFLIGHT_STEPS`` un-synced steps (``dataio/
prefetch_queue_depth``, ``dataio/h2d_ms``, ``executor/fetch_wait_ms``,
``executor/inflight_steps``).
"""
from .handle import FetchHandle  # noqa: F401
from .loader import DeviceLoader, close_all_loaders  # noqa: F401

__all__ = ["DeviceLoader", "FetchHandle", "close_all_loaders"]
