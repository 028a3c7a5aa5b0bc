"""DeviceLoader: background host→device prefetch over any batch reader (the
port's counterpart of ``paddle_tpu.dataio.loader``).

Reference analog: ``buffered_reader.cc`` — the double-buffered reader that
``PyReader(use_double_buffer=True)`` promised: a worker thread pulls the
next batch, converts it, and starts the H2D copy while the device still
runs the current step, so by the time the training loop asks for batch
N+1 it is a set of device tensors and ``Executor.run`` skips straight to
the step.

On the card (a ``CUDAPlace``), for each batch the worker thread:
- converts every feed on the host to its declared dtype, with the same
  validation as a synchronous ``Executor.run`` (``convert_feed_value``);
- copies it into **pinned** host memory (a ``non_blocking`` copy from
  pageable memory would be synchronous), pinned anew for each batch;
- issues the H2D copies on the loader's own side CUDA stream (after
  ``torch.cuda.set_device`` in the worker), records an event there, and
  waits on that event before it queues the batch. The wait blocks only
  the worker: it makes ``dataio/h2d_ms`` the real conversion + transfer
  time, and no pinned buffer is dropped while its copy is in flight.

The consumer's stream waits on the batch's event before it reads the
batch (in ``__iter__`` and in ``peek_many``), and every tensor of the
batch gets ``record_stream`` on the consumer's stream, so the caching
allocator does not hand its memory to the side stream while a step still
reads it. A failed pin or copy reaches the consumer as a reader error
does; nothing falls back to the CPU. With ``CPUPlace()`` the loader yields
CPU tensors and uses no stream. With no place the loader runs on CUDA
device 0 and raises where torch sees no GPU.

A ``convert=`` function (the PS tier's convert + pull) runs on the worker
under the side stream too: its device work lands on that stream, and the
same event hands its result over. ``stage(t, device)`` is the pinned,
stream-ordered copy such a function uses.

Threading contract:
- ONE worker per epoch → batch order is exactly reader order;
- a reader exception is captured and re-raised in the CONSUMER at the
  point of the failed batch (never swallowed in the worker);
- `close()` is idempotent and joins the worker (a mid-epoch `break`
  through ``close()``/``PyReader.reset()`` leaves no live thread holding
  device buffers); iterating to exhaustion closes automatically.

Deterministic resume: the loader tracks an (epoch, cursor) position —
`state()` returns it, `restore_state()` replays it on a FRESH reader by
skipping `cursor` raw batches at the next epoch start (skipped batches are
never converted or copied). Callable readers that accept an argument are
invoked as ``reader(epoch)`` so a stateful reader can regenerate epoch
N's exact stream after a crash; ``Checkpointer.save(extra=...)`` carries
the state as ``@dataio@*`` keys.

Telemetry (process registry): ``dataio/prefetch_queue_depth`` gauge,
``dataio/h2d_ms`` per-batch conversion + transfer histogram,
``dataio/last_h2d_ms`` gauge, ``dataio/batches`` counter. Chaos probe:
``loader.next`` fires in the worker at every reader pull.
"""
from __future__ import annotations

import inspect
import threading
import time
import weakref
from queue import Empty, Full, Queue
from typing import Callable, Dict, Iterable, Optional, Union

import numpy as np
import torch

from ..faults import fault_point
from ..observability.registry import get_registry

__all__ = ["DeviceLoader", "close_all_loaders", "stage"]

_OBS = get_registry()
_QUEUE_DEPTH = _OBS.gauge("dataio/prefetch_queue_depth")
_H2D_MS = _OBS.histogram("dataio/h2d_ms")
# last observation as a gauge so a step record can carry the most recent
# transfer without a histogram read
_LAST_H2D_MS = _OBS.gauge("dataio/last_h2d_ms")
_BATCHES = _OBS.counter("dataio/batches")

# every live loader, so Executor.close() / test teardown can sweep
# stragglers without owning them
_LIVE_LOADERS: "weakref.WeakSet" = weakref.WeakSet()


class _EndOfEpoch:
    pass


class _WorkerError:
    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class _Staged:
    """One converted batch in the queue: its value and the side-stream
    event its copies completed at (None on the CPU)."""
    __slots__ = ("value", "event")

    def __init__(self, value, event):
        self.value = value
        self.event = event


def stage(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`t` on `device`: on a CUDA device through a pinned host copy and a
    ``non_blocking`` H2D copy on the CURRENT stream (the loader's side
    stream when called from its worker); on the CPU, `t` itself. uint16
    (a packed row table) moves as an int16 view of the same bits."""
    if device.type != "cuda":
        return t
    u16 = t.dtype == torch.uint16
    src = t.view(torch.int16) if u16 else t
    out = src.pin_memory().to(device, non_blocking=True)
    return out.view(torch.uint16) if u16 else out


def _tensors(obj, depth: int = 0):
    """Every torch tensor reachable from a converted batch: dict values,
    list/tuple items and the attributes of small objects (the PS tier's
    prepared batches), a few levels deep."""
    if isinstance(obj, torch.Tensor):
        yield obj
        return
    if depth > 4 or obj is None or isinstance(
            obj, (str, bytes, int, float, np.ndarray)):
        return
    if isinstance(obj, dict):
        items = obj.values()
    elif isinstance(obj, (list, tuple)):
        items = obj
    elif hasattr(obj, "__slots__"):
        items = [getattr(obj, s, None) for s in obj.__slots__]
    else:
        items = list(getattr(obj, "__dict__", {}).values())
    for v in items:
        yield from _tensors(v, depth + 1)


def _default_convert(block, device: torch.device):
    """Batch dict → dict of tensors on `device`. With a program block,
    feeds get the same validation and dtype as a synchronous
    ``Executor.run`` (so the prefetch path cannot silently accept what the
    sync path rejects); names the block does not declare pass through
    (e.g. '<name>_len' companions). The conversion happens on the host,
    then each tensor is staged to the device."""
    from ..core.dtypes import from_numpy
    from ..core.executor import convert_feed_value

    host = torch.device("cpu")

    def convert(batch: Dict[str, object]) -> Dict[str, torch.Tensor]:
        out = {}
        for name, val in batch.items():
            if block is not None and \
                    block._find_var_recursive(name) is not None:
                t = convert_feed_value(block, name, val, host)
            elif isinstance(val, torch.Tensor):
                t = val.to(host)
            else:
                t = from_numpy(np.asarray(val))
            out[name] = stage(t, device)
        return out

    return convert


class DeviceLoader:
    """Prefetch batches from `reader` onto the device via a worker thread.

    reader: a callable returning an iterable of feed dicts (name → array),
      or a plain iterable (single-epoch). Each ``__iter__`` starts a fresh
      epoch (and tears down any previous one).
    capacity: max prefetched device batches. 2 = classic double buffering.
    program: optional Program whose global block provides feed
      validation/dtype policy (same semantics as Executor.run's feeds).
    convert: override the batch→device function entirely (it runs on the
      worker, under the side stream).
    place: where batches land: ``CUDAPlace(0)`` unless the caller passes
      another place (``CPUPlace()`` for the CPU).
    """

    def __init__(self, reader: Union[Callable, Iterable], capacity: int = 2,
                 program=None, convert: Optional[Callable] = None,
                 name: str = "device_loader", place=None):
        from ..core.executor import CUDAPlace

        if capacity < 1:
            raise ValueError(f"DeviceLoader capacity must be >= 1, "
                             f"got {capacity}")
        self.place = place or CUDAPlace(0)
        self.device = self.place.torch_device()
        self._reader = reader
        self._capacity = int(capacity)
        self._block = (program.global_block()
                       if program is not None else None)
        self._convert = convert
        self.name = name
        self._queue: Optional[Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop: Optional[threading.Event] = None
        self._closed = False
        self._stream = None  # the side stream, made on first start()
        # deterministic-resume position: completed epochs / batches
        # DELIVERED to the consumer this epoch / pending skip-ahead
        self._epoch = 0
        self._consumed = 0
        self._skip = 0
        self._takes_epoch: Optional[bool] = None
        _LIVE_LOADERS.add(self)

    # -- epoch lifecycle ---------------------------------------------------
    def _epoch_iterable(self):
        r = self._reader
        if not callable(r):
            return r
        if self._takes_epoch is None:
            # epoch-aware readers (`def reader(epoch):`) get the epoch
            # index: the contract that lets a stateful reader regenerate
            # epoch N's exact stream after a crash-resume
            try:
                sig = inspect.signature(r)
                self._takes_epoch = any(
                    p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD,
                               p.VAR_POSITIONAL)
                    for p in sig.parameters.values())
            except (TypeError, ValueError):
                self._takes_epoch = False
        return r(self._epoch) if self._takes_epoch else r()

    def _convert_staged(self, convert, batch) -> _Staged:
        """Convert one batch; on the card under the side stream, with the
        event its copies complete at (waited on here, in the worker)."""
        if self.device.type != "cuda":
            return _Staged(convert(batch), None)
        with torch.cuda.stream(self._stream):
            value = convert(batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        event.synchronize()
        return _Staged(value, event)

    def start(self) -> "DeviceLoader":
        """Spin up the prefetch worker for a fresh epoch (idempotent when
        one is already running)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._closed = False
        if self.device.type == "cuda" and self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        q: Queue = Queue(maxsize=self._capacity)
        stop = threading.Event()
        convert = self._convert or _default_convert(self._block, self.device)
        # restore_state() parks a skip count; this epoch's worker fast-
        # forwards past it (raw next() only — no convert, no copy)
        skip, self._skip = self._skip, 0
        self._consumed = skip
        device = self.device

        def worker():
            try:
                if device.type == "cuda":
                    torch.cuda.set_device(device)
                it = iter(self._epoch_iterable())
                for _ in range(skip):
                    fault_point("loader.next")
                    try:
                        next(it)
                    except StopIteration:
                        break
                for batch in it:
                    fault_point("loader.next")
                    if stop.is_set():
                        return
                    t0 = time.perf_counter()
                    staged = self._convert_staged(convert, batch)
                    dt = (time.perf_counter() - t0) * 1e3
                    _H2D_MS.observe(dt)
                    _LAST_H2D_MS.set(dt)
                    # bounded put that stays responsive to close(): a
                    # plain q.put would deadlock a worker whose consumer
                    # broke out of the epoch without draining
                    while not stop.is_set():
                        try:
                            q.put(staged, timeout=0.1)
                            break
                        except Full:
                            continue
                    if stop.is_set():
                        return
                    _BATCHES.inc()
                    _QUEUE_DEPTH.set(q.qsize())
            except BaseException as e:  # re-raised in the consumer
                while not stop.is_set():
                    try:
                        q.put(_WorkerError(e), timeout=0.1)
                        return
                    except Full:
                        continue
            finally:
                while not stop.is_set():
                    try:
                        q.put(_EndOfEpoch, timeout=0.1)
                        break
                    except Full:
                        continue

        t = threading.Thread(target=worker, daemon=True,
                             name=f"pdtpu-{self.name}")
        self._queue, self._stop, self._thread = q, stop, t
        t.start()
        return self

    def _handover(self, staged: _Staged):
        """The consumer's side of a batch: its stream waits on the copy's
        event, and each tensor is marked as used on that stream."""
        if staged.event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(staged.event)
            for t in _tensors(staged.value):
                if t.device.type == "cuda":
                    t.record_stream(cur)
        return staged.value

    def __iter__(self):
        # a fresh epoch per iteration, like calling a decorated reader;
        # an unfinished previous epoch is torn down first
        if self._thread is not None and self._thread.is_alive():
            self.close()
        self.start()
        return self._drain()

    def _teardown(self, stop, thread) -> None:
        # the worker must not outlive the epoch it served
        stop.set()
        if thread is not None:
            thread.join(timeout=5)
        if self._thread is thread:
            self._thread = None
            self._closed = True

    def _drain(self):
        q, stop, thread = self._queue, self._stop, self._thread
        try:
            while True:
                item = q.get()
                _QUEUE_DEPTH.set(q.qsize())
                if item is _EndOfEpoch:
                    # the epoch delivered everything: advance the resume
                    # cursor to the next epoch's start. (A stop-set
                    # sentinel is close()'s cross-thread wake-up, not a
                    # real epoch end — position must survive teardown.)
                    if not stop.is_set():
                        self._epoch += 1
                        self._consumed = 0
                    return
                if isinstance(item, _WorkerError):
                    raise item.exc
                value = self._handover(item)
                self._consumed += 1  # counted when DELIVERED, not queued
                yield value
        finally:
            # normal exhaustion, consumer break, or consumer exception
            self._teardown(stop, thread)

    # -- stacked K-step feeds (Executor.train_scanned) ---------------------
    def peek_many(self, k: int):
        """Pull up to `k` prefetched device batches and return them as ONE
        stacked feed dict ``{name: [m, ...] tensor}`` plus ``m``, the
        number of batches actually pulled (``m < k`` only at end of epoch;
        ``({}, 0)`` once exhausted).

        This is the scan driver's fill path: the stack happens on the
        device, on the consumer's stream after it waited on each batch's
        copy, and the result is the K-step feed buffer the driver indexes
        step by step. Worker errors re-raise here exactly like
        `__iter__`, and exhaustion tears the worker down with the same
        stop-event/join lifecycle as `_drain`.
        """
        if k < 1:
            raise ValueError(f"peek_many: k must be >= 1, got {k}")
        q, stop, thread = self._queue, self._stop, self._thread
        if q is None or (self._closed
                         and (thread is None or not thread.is_alive())):
            # epoch already exhausted or loader closed: nothing will ever
            # arrive on the queue again — don't block on it
            return {}, 0
        batches = []
        ended = epoch_done = False
        try:
            while len(batches) < k:
                item = q.get()
                _QUEUE_DEPTH.set(q.qsize())
                if item is _EndOfEpoch:
                    ended = True
                    epoch_done = not stop.is_set()
                    break
                if isinstance(item, _WorkerError):
                    ended = True
                    raise item.exc
                batches.append(self._handover(item))
        finally:
            self._consumed += len(batches)
            if epoch_done:
                self._epoch += 1
                self._consumed = 0
            if ended:
                # a later peek_many returns (_, 0)
                self._teardown(stop, thread)
        if not batches:
            return {}, 0
        keys0 = set(batches[0])
        for i, b in enumerate(batches[1:], start=1):
            if set(b) != keys0:
                raise ValueError(
                    f"peek_many: batch {i} key set {sorted(b)} does not "
                    f"match batch 0's {sorted(keys0)}")
        stacked = {name: torch.stack([b[name] for b in batches])
                   for name in sorted(keys0)}
        return stacked, len(batches)

    # -- deterministic resume ---------------------------------------------
    def state(self) -> Dict[str, int]:
        """Resume position: ``{"version", "epoch", "cursor"}`` — epochs
        completed and batches delivered to the consumer this epoch. Safe
        to call between steps (e.g. at checkpoint time): prefetched-but-
        undelivered batches are NOT counted, so a restore replays exactly
        the batches the training loop never saw."""
        return {"version": 1, "epoch": int(self._epoch),
                "cursor": int(self._consumed)}

    def restore_state(self, state: Dict[str, int]) -> None:
        """Rewind a fresh (non-running) loader to a `state()` snapshot:
        the next epoch starts at ``state["epoch"]`` and fast-forwards past
        ``state["cursor"]`` raw batches of a fresh reader — mid-epoch
        crash-resume lands on exactly the next undelivered batch."""
        if self.running:
            raise RuntimeError(
                "DeviceLoader.restore_state: loader is running; close() "
                "it first (restore rewinds the NEXT epoch)")
        version = int(state.get("version", 1))
        if version != 1:
            raise ValueError(
                f"DeviceLoader.restore_state: unknown state version "
                f"{version}")
        epoch = int(state["epoch"])
        cursor = int(state["cursor"])
        if epoch < 0 or cursor < 0:
            raise ValueError(
                f"DeviceLoader.restore_state: bad state {state!r}")
        self._epoch = epoch
        self._consumed = cursor   # state() stays truthful pre-start
        self._skip = cursor

    # -- shutdown ----------------------------------------------------------
    def close(self) -> None:
        """Tear down the prefetch thread and drop queued device batches.
        Idempotent; safe from any thread."""
        if self._closed and (self._thread is None
                             or not self._thread.is_alive()):
            return
        self._closed = True
        stop, q, t = self._stop, self._queue, self._thread
        if stop is not None:
            stop.set()
        if q is not None:
            # release a worker blocked on put() and free device buffers
            while True:
                try:
                    q.get_nowait()
                except Empty:
                    break
            _QUEUE_DEPTH.set(0)
            # wake a consumer blocked in q.get() (close() from another
            # thread may have drained the worker's own end sentinel)
            try:
                q.put_nowait(_EndOfEpoch)
            except Full:
                pass
        if t is not None and t.is_alive():
            t.join(timeout=5)
        self._thread = None
        self._queue = None

    def __enter__(self) -> "DeviceLoader":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def __del__(self):  # best-effort: a dropped loader stops its worker
        try:
            self.close()
        except Exception:
            pass

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def queue_depth(self) -> int:
        """Prefetched batches currently queued (0 when not running).
        Consumers that care about overlap (the PS tier's prefetch-hit
        accounting) read this just before blocking on the next batch."""
        q = self._queue
        return q.qsize() if q is not None else 0


def close_all_loaders() -> int:
    """Close every live DeviceLoader (Executor.close / test teardown
    sweep). Returns how many were still running."""
    n = 0
    for ld in list(_LIVE_LOADERS):
        if ld.running:
            n += 1
        ld.close()
    return n
