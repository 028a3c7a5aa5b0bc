"""paddle_tpu_torch.dataio — the fetch side of the input pipeline.

- **FetchHandle** (handle.py) — un-synced fetch results from
  ``Executor.run(..., return_handle=True)``: the step's kernels keep
  running on the card while the host moves on; ``.numpy()`` is the
  explicit sync point.

The JAX package's ``DeviceLoader`` (its background host→device loader)
comes with the dataset trainer (ROADMAP A4).
"""
from .handle import FetchHandle  # noqa: F401

__all__ = ["FetchHandle"]
