"""FetchHandle: un-synced fetch results from a dispatched step.

Counterpart of ``paddle_tpu.dataio.handle``. The reference executor
copied every fetch var to host inside Run (executor.cc:431
GetFetchVariable), so the caller paid a device sync per step. On the card
the port's ops launch asynchronously on the current CUDA stream; a
FetchHandle keeps the fetches as device tensors, with a ``torch.cuda.Event``
recorded after the step, so the caller decides WHEN to sync: touch
nothing and the next step's host work (feed conversion, op dispatch,
logging) overlaps the card's compute; call ``.numpy()`` when the values
are needed. CUDA has no buffer donation, so a fetch-less step needs no
extra probe tensor: the event is what a caller waits on.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np

from ..core.dtypes import to_numpy
from ..observability.registry import get_registry

_FETCH_WAIT_MS = get_registry().histogram("executor/fetch_wait_ms")
# last wait as a gauge: the StepProfiler stamps step records with it
_LAST_FETCH_WAIT_MS = get_registry().gauge("executor/last_fetch_wait_ms")

__all__ = ["FetchHandle"]


class FetchHandle:
    """Holds one step's fetch tensors un-synced.

    `names` aligns with the tensors (the program's fetch_list order).
    `event` is a ``torch.cuda.Event`` recorded on the step's stream after
    its last kernel, or None on the CPU, where every op has finished by the
    time ``Executor.run`` returns.
    """

    __slots__ = ("names", "_values", "_event", "_numpy")

    def __init__(self, names: Sequence[str], values: Sequence,
                 event=None):
        self.names = list(names)
        self._values = list(values)
        self._event = event
        self._numpy: Optional[List[np.ndarray]] = None

    @staticmethod
    def _observe(t0: float) -> None:
        dt = (time.perf_counter() - t0) * 1e3
        _FETCH_WAIT_MS.observe(dt)
        _LAST_FETCH_WAIT_MS.set(dt)

    # -- sync points -------------------------------------------------------
    def numpy(self) -> List[np.ndarray]:
        """Copy every fetch to host (the sync point). Cached: the wait is
        paid once, repeat calls return the same arrays."""
        if self._numpy is None:
            t0 = time.perf_counter()
            self._numpy = [to_numpy(v) for v in self._values]
            self._observe(t0)
        return self._numpy

    def tensors(self) -> list:
        """The fetch tensors as they are (possibly still being computed on
        the card): no sync."""
        return list(self._values)

    def block_until_ready(self) -> "FetchHandle":
        """Wait for the step to finish WITHOUT copying to host (bounds the
        in-flight depth; cheaper than `.numpy()` for large fetches)."""
        t0 = time.perf_counter()
        if self._event is not None:
            self._event.synchronize()
        self._observe(t0)
        return self

    def is_ready(self) -> bool:
        """True when the step has finished on the card (no sync)."""
        return self._event is None or self._event.query()

    # -- container protocol (materializing) --------------------------------
    def __len__(self) -> int:
        return len(self._values)

    def __iter__(self):
        return iter(self.numpy())

    def __getitem__(self, i):
        return self.numpy()[i]

    def __repr__(self):
        state = "materialized" if self._numpy is not None else "pending"
        return (f"FetchHandle({len(self._values)} fetches "
                f"[{', '.join(self.names[:4])}"
                f"{', ...' if len(self.names) > 4 else ''}], {state})")
