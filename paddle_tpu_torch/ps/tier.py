"""PsEmbeddingTier — pull/push training over sharded tables (the port's copy
of ``paddle_tpu.ps.tier``).

Reference analog: the worker half of the Downpour loop — ``FleetWrapper::
PullSparseVarsSync`` before the forward, ``PushSparseVarsWithLabelAsync``
after the backward, with the Communicator batching the pushes. Here the
same overlap rides the repo's own machinery:

* the **pull**: before each step the tier extracts the global row ids of
  every bound table, dedups them host-side (``np.unique`` — the host
  mirror of ``uniq_merge``'s device contract: ascending uniques + inverse
  positions), rewrites the id feeds to LOCAL cache rows, fans per-shard
  pulls out through ``ShardedTable``, and lands the gathered rows on the
  device. With ``pull_ahead`` ≥ 1 (the default, 1) this runs
  ``pull_ahead`` batches ahead on a ``dataio.DeviceLoader`` worker: its
  H2D copies go through pinned memory on the loader's side stream, and
  that stream first waits on the event the last step recorded after its
  write-back, so no device work of a prefetched pull can run ahead of the
  updates of the steps before it. ``pull_ahead=0`` converts and pulls
  inline on the calling thread;
* the step itself runs unchanged: the program's table param is a CACHE of
  ``cache_rows`` packed rows; ``scope.set_var`` swaps the pulled cache in,
  the packed optimizer (``adagrad_row_packed`` et al.) updates it in
  place, and rows ``[0, U)`` of the result are exactly the new values of
  the step's U unique ids. Each step pulls into a fresh tensor, so the
  one handed to the pusher is never written again;
* **push** slices those U rows and hands them to a per-table pusher —
  ``push_depth`` 0 applies synchronously (staleness-0 exact), k ≥ 1
  queues them on a flusher thread with at most k batches in flight, so
  the host→shard write happens under the next step's compute.

Exactness. The global→local id remap is strictly monotone (uids are
ascending), the sort in ``uniq_merge`` is stable and its duplicate sums run
in occurrence order, so the duplicate-gradient merge order and every
downstream float op are bit-identical to the single-table run. With
``push_depth ≥ 1`` a prefetched pull can race an in-flight push; the tier
repairs that at dispatch with read-your-writes patching: every pull
records the pusher's ``applied_seq`` snapshot, and any push issued after
it is copied into the cache on the device before the step (pushes carry
absolute rows, so patching is idempotent under the race). A pull so
stale that its missing pushes have left the patch window falls back to
flush + re-pull (``ps/repulls``). Net: single-worker training is bitwise
exact at ANY depth; ``push_depth`` only relaxes cross-worker visibility.

Hot-row cache (``hot_rows`` > 0, or ``PDTPU_PS_HOT_ROWS``): the cache
param becomes a persistent ``[hot_rows + step_rows]`` slab managed by
``ps.hot_cache.HotRowCache`` — LFU-admitted hot rows stay resident in
device memory across steps (hits are never pulled OR pushed), misses flow through
the staging tail exactly like the uncached per-step path, and evicted
dirty rows are written back through the same pusher/journal machinery.
The bitwise contract is unchanged: the id remap per step is injective
and the update math depends only on id equality structure, while miss
pulls and write-backs observe the same read-your-writes patching — so
single-worker runs stay bit-identical to the uncached tier at any push
depth.

Shard outages (``attach_checkpointer``): a pull or push that a dead shard
interrupts waits for it to answer again, the shard is rebuilt from the
newest verified checkpoint plus the push journal, and the same call is
retried — a push with the host rows its pusher already copied off the
device, so a retry never reads a tensor a later step has updated. The
table's flush hook (set here, cleared at ``close``) lets
``Checkpointer.save(ps_tables=)`` write back the slab's dirty rows first.

Metrics: ``ps/prefetch_hit``/``ps/prefetch_miss`` (was batch N+1 already
converted+pulled when the loop asked?), ``ps/patched_rows``,
``ps/repulls``, ``ps/recoveries``, ``ps/recovered_batches{table}`` — plus ``ps/pull_ms``/``ps/push_ms``/``ps/bytes_*`` from
the table layer and ``ps/cache_*`` from the hot cache.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from ..core.dtypes import to_numpy
from ..core.executor import CUDAPlace
from ..dataio.loader import DeviceLoader, stage
from ..faults import fault_point
from ..observability import get_registry
from ..ops.kernels.sparse_adagrad import i16
from .table import ShardedTable
from .transport import ShardRestartedError, TransportError

__all__ = ["PsTableBinding", "PsEmbeddingTier"]


class PsTableBinding:
    """One PS-backed table: which program param is its cache and which
    feed names carry its global row ids."""

    def __init__(self, param: str, table: ShardedTable,
                 id_feeds: Sequence[str]):
        if not id_feeds:
            raise ValueError(f"PsTableBinding {param!r}: need at least "
                             f"one id feed")
        self.param = str(param)
        self.table = table
        self.id_feeds = list(id_feeds)


class _Entry:
    """One table's pulled state for one batch. In hot-cache mode `uids`
    are the step's MISS uids (hits never leave the slab) and `plan` is
    the HotRowCache.CachePlan that owns the slab slot assignment."""
    __slots__ = ("uids", "n", "cache", "version", "plan")

    def __init__(self, uids, n, cache, version, plan=None):
        self.uids = uids      # ascending unique global ids, [n] int64
        self.n = n
        self.cache = cache    # [cache_rows, lanes] u16 device tensor
        self.version = version  # pusher.applied_seq snapshot before pull
        self.plan = plan


class _Prepared:
    """One converted batch: device feeds (ids already local) + per-table
    pull entries."""
    __slots__ = ("feed", "entries")

    def __init__(self, feed, entries):
        self.feed = feed        # numpy feeds, ids already local
        self.entries = entries  # param -> _Entry


class _Pusher:
    """Per-table push applier with bounded in-flight depth.

    depth 0: ``submit`` applies inline (synchronous exact). depth k: a
    flusher thread drains a queue of maxsize k — ``submit`` blocks only
    when k batches are already in flight. ``recent`` keeps the last few
    submitted batches for read-your-writes patching; it is touched ONLY
    by the submitting thread.
    """

    def __init__(self, table: ShardedTable, depth: int, window: int):
        self.table = table
        self.depth = int(depth)
        self.issued_seq = 0
        self.applied_seq = 0
        self.recent = deque(maxlen=window)  # (seq, uids_np, rows tensor)
        self._cv = threading.Condition()
        self._err: Optional[BaseException] = None
        self._q = None
        self._thread = None
        if self.depth > 0:
            import queue as _qm
            self._q = _qm.Queue(maxsize=self.depth)
            self._thread = threading.Thread(
                target=self._drain, daemon=True,
                name=f"ps-push-{table.name}")
            self._thread.start()

    def _apply(self, seq, uids, rows):
        fault_point("ps.push")
        # rows is the full cache (or a gathered bucket); the copy to the
        # host is the device sync — on depth>0 it happens HERE, on the
        # flusher thread, off the step path — of the batch's n rows only
        if uids.size:
            self.table.push(uids, to_numpy(rows[:uids.size]))
        with self._cv:
            self.applied_seq = seq
            self._cv.notify_all()

    def _drain(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            seq, uids, rows = item
            try:
                self._apply(seq, uids, rows)
            except BaseException as e:
                with self._cv:
                    self._err = e
                    self.applied_seq = seq  # unblock flush(); err re-raised
                    self._cv.notify_all()

    def submit(self, uids: np.ndarray, rows) -> int:
        """Queue (or apply) one push batch; returns its seq."""
        self._check()
        self.issued_seq += 1
        seq = self.issued_seq
        self.recent.append((seq, uids, rows))
        if self.depth == 0:
            self._apply(seq, uids, rows)
        else:
            self._q.put((seq, uids, rows))  # blocks at depth in flight
        return seq

    def flush(self):
        """Block until every submitted push is applied on the shards."""
        with self._cv:
            while self.applied_seq < self.issued_seq and self._err is None:
                self._cv.wait(timeout=0.5)
        self._check()

    def _check(self):
        # a drained-push failure means a batch was DROPPED on the shards;
        # the pusher stays poisoned so no later submit/flush (e.g. a
        # retried checkpoint save) can report success over missing rows —
        # recovery is rebuilding the tier from a known-good state
        if self._err is not None:
            raise RuntimeError(
                f"ps push to table {self.table.name!r} failed; pusher is "
                f"poisoned — rebuild the tier") from self._err

    def close(self):
        if self._thread is not None:
            self._q.put(None)
            self._thread.join(timeout=5.0)
            self._thread = None


class PsEmbeddingTier:
    """Drives a program whose sparse tables live on PS shards.

    Usage::

        tier = PsEmbeddingTier(program, bindings, pull_ahead=1,
                               push_depth=1, place=fluid.CUDAPlace(0))
        for prepared in tier.steps(reader, scope=sc):
            loss, = tier.run_step(exe, prepared, fetch_list=[loss_var],
                                  scope=sc)
        tier.flush()

    ``place`` is where the caches live: the executor's place, CUDA device
    0 unless the caller passes ``CPUPlace()``. ``pull_ahead`` ≥ 1
    prefetches (a DeviceLoader of that capacity runs convert + pull on a
    worker thread and side stream); 0 converts inline on the calling
    thread. Single-worker training is bitwise the same either way.
    """

    def __init__(self, program, bindings: Sequence[PsTableBinding],
                 pull_ahead: int = 1, push_depth: int = 0,
                 hot_rows: Optional[int] = None, place=None):
        if pull_ahead < 0 or push_depth < 0:
            raise ValueError(f"pull_ahead/push_depth must be >= 0, got "
                             f"{pull_ahead}/{push_depth}")
        self.place = place or CUDAPlace(0)
        self.device = self.place.torch_device()
        self.program = program
        self.bindings = list(bindings)
        if not self.bindings:
            raise ValueError("PsEmbeddingTier: no table bindings")
        self.pull_ahead = int(pull_ahead)
        self.push_depth = int(push_depth)
        if hot_rows is None:
            hot_rows = int(os.environ.get("PDTPU_PS_HOT_ROWS", "0"))
        self.hot_rows = max(0, int(hot_rows))
        block = program.global_block()
        self._cache_shape: Dict[str, tuple] = {}
        self._id_dtype: Dict[str, object] = {}
        for b in self.bindings:
            v = block.var(b.param)
            rows, lanes = int(v.shape[0]), int(v.shape[1])
            if lanes != b.table.lanes:
                raise ValueError(
                    f"cache param {b.param!r} has {lanes} lanes but table "
                    f"{b.table.name!r} has {b.table.lanes}")
            self._cache_shape[b.param] = (rows, lanes)
        # device-resident hot-row cache (ps/hot_cache.py): the cache param
        # becomes a persistent [hot_rows + step_rows] slab instead of a
        # per-step scratch pull target
        self._hot: Dict[str, object] = {}
        if self.hot_rows:
            from .hot_cache import HotRowCache
            for b in self.bindings:
                rows_cap, lanes = self._cache_shape[b.param]
                step_rows = rows_cap - self.hot_rows
                if step_rows < 1:
                    raise ValueError(
                        f"hot_rows={self.hot_rows} leaves no staging rows "
                        f"in cache param {b.param!r} ({rows_cap} rows); "
                        "rebuild the program with a [hot_rows + per-step "
                        "rows] cache param")
                self._hot[b.param] = HotRowCache(
                    self.hot_rows, step_rows, lanes=lanes,
                    vocab=b.table.spec.vocab, name=b.table.name,
                    device=self.device)
        # patch window: every pull can be behind by at most the prefetch
        # depth plus the in-flight pushes (+ slack for the re-pull path);
        # hot-cache mode submits up to three batches per step (eviction
        # write-back, staging push, flush) instead of one, so the window
        # widens accordingly — overflow is still safe (repull fallback)
        window = ((self.pull_ahead + self.push_depth + 2)
                  * (3 if self.hot_rows else 1))
        self._pushers = {b.param: _Pusher(b.table, push_depth, window)
                         for b in self.bindings}
        for b in self.bindings:
            # checkpoint flush hook: Checkpointer.save() calls it before
            # taking the journal mark + dumping shards, so slab-dirty rows
            # and queued pushes are on the shards the mark covers
            b.table.set_flush_hook(lambda p=b.param: self._flush_param(p))
        reg = get_registry()
        self._c_hit = reg.counter("ps/prefetch_hit")
        self._c_miss = reg.counter("ps/prefetch_miss")
        self._c_patched = reg.counter("ps/patched_rows")
        self._c_repulls = reg.counter("ps/repulls")
        self._c_recoveries = reg.counter("ps/recoveries")
        self._loader = None
        # recorded on the step's stream after each step's write-back; a
        # prefetching pull's stream waits on it first
        self._step_event = None
        self._ck = None        # Checkpointer armed by attach_checkpointer
        self._recover_lock = threading.Lock()

    # --------------------------------------------------------- shard outage
    def attach_checkpointer(self, ck) -> None:
        """Arm lossless shard recovery. With a Checkpointer attached,
        a transient shard outage no longer kills the step: the failing
        pull/push blocks (which pauses the prefetcher and the pusher —
        they are the threads doing the failing calls), the tier waits for
        the shard to answer pings again (bounded by
        ``PDTPU_WEDGE_TIMEOUT``), rebuilds it from the newest VERIFIED
        checkpoint slice plus the table's push-journal replay
        (``ShardedTable.recover_shard``), and the interrupted op retries
        — bitwise-identical to a never-crashed run at staleness 0. A
        retried push resends the host rows it was pushing (the pusher
        copied them off the device once, before the first attempt), never
        a fresh read of a device tensor a later step may have updated.
        Save a checkpoint (``ps_tables=``) before training so a recovery
        base exists. Without attachment, outages surface as
        TransportError after transport-level retries."""
        self._ck = ck
        for b in self.bindings:
            b.table.set_recovery(
                lambda i, exc, t=b.table: self._recover(t, i, exc))

    def _recover(self, table: ShardedTable, i: int,
                 exc: BaseException) -> None:
        """Recovery hook (runs on whichever thread hit the dead shard —
        prefetcher, pusher, or the step thread). Serialized: concurrent
        victims of the same outage queue here, and all but the first
        find the shard already healthy and return to their retry."""
        with self._recover_lock:
            deadline = time.monotonic() + float(
                os.environ.get("PDTPU_WEDGE_TIMEOUT", "300"))
            client = table.clients[i]
            while True:
                try:
                    client.ping()
                    # reachable under the SAME instance id: the process
                    # never died (blip / slow shard) — rows are intact,
                    # no rebuild needed, let the op retry
                    return
                except ShardRestartedError:
                    break  # reachable but reborn: rebuild below
                except TransportError as e:
                    if not e.transient or time.monotonic() > deadline:
                        raise RuntimeError(
                            f"ps shard {i} of table {table.name!r} "
                            "unreachable past PDTPU_WEDGE_TIMEOUT — tier "
                            "is wedged, not recovering") from e
                    time.sleep(0.1)
            self._c_recoveries.inc()
            if self._ck is None:
                raise RuntimeError(
                    f"ps shard {i} of table {table.name!r} restarted and "
                    "lost its rows, but no checkpointer is attached — "
                    "call tier.attach_checkpointer(ck) for lossless "
                    "recovery") from exc
            full_rows, mark, step = self._ck.load_ps_table(table.name)
            replayed = table.recover_shard(i, full_rows, mark)
            del full_rows
            get_registry().counter(
                "ps/recovered_batches", table=table.name).inc(replayed)

    # ----------------------------------------------------------- pull path
    def _pull_cache(self, binding: PsTableBinding, uids: np.ndarray,
                    version: int, cap: Optional[int] = None):
        """Pull rows for `uids`, pad to the cache shape (or `cap` rows —
        the hot path's miss buffer), land on the device."""
        fault_point("ps.pull")
        rows_cap, lanes = self._cache_shape[binding.param]
        if cap is not None:
            rows_cap = int(cap)
        if uids.shape[0] > rows_cap:
            raise ValueError(
                f"batch touches {uids.shape[0]} unique rows of table "
                f"{binding.table.name!r} but cache param {binding.param!r} "
                f"holds only {rows_cap}; rebuild the program with a larger "
                f"cache (>= max unique ids per batch)")
        pulled = binding.table.pull(uids)
        cache = np.zeros((rows_cap, lanes), dtype=np.uint16)
        cache[:uids.shape[0]] = pulled
        return _Entry(uids, int(uids.shape[0]),
                      stage(torch.from_numpy(cache), self.device), version)

    def _convert(self, batch: Dict[str, object]) -> _Prepared:
        """Dedup ids, localize feeds, pull caches. The feeds stay numpy;
        the executor validates and moves them. On a prefetch worker this
        runs under the loader's side stream, which first waits on the
        last step's write-back event."""
        event = self._step_event
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)
        out = dict(batch)
        entries: Dict[str, _Entry] = {}
        for b in self.bindings:
            arrs = [np.asarray(out[f]) for f in b.id_feeds]
            flat = (np.concatenate([a.ravel() for a in arrs])
                    if arrs else np.zeros((0,), np.int64))
            uids, inv = np.unique(flat.astype(np.int64),
                                  return_inverse=True)
            hot = self._hot.get(b.param)
            if hot is None:
                loc_all = inv
            else:
                # hot path: ids map to SLAB rows (resident slot for hits
                # and admitted misses, staging tail for bypass) and only
                # the miss rows are pulled. The remap stays injective per
                # step, so uniq_merge's equality structure — and every
                # float op — matches the uncached run bit-for-bit.
                # Occurrence counts feed the lookup-weighted hit metrics.
                plan = hot.plan(uids, np.bincount(inv))
                loc_all = plan.slots[inv]
            off = 0
            for f, a in zip(b.id_feeds, arrs):
                loc = loc_all[off:off + a.size].reshape(a.shape)
                out[f] = loc.astype(a.dtype if a.dtype.kind in "iu"
                                    else np.int64)
                off += a.size
            version = self._pushers[b.param].applied_seq
            if hot is None:
                entries[b.param] = self._pull_cache(b, uids, version)
            else:
                entry = self._pull_cache(b, plan.miss_uids, version,
                                         cap=hot.step_rows)
                entry.plan = plan
                entries[b.param] = entry
        return _Prepared(out, entries)

    def steps(self, reader, scope=None) -> Iterable[_Prepared]:
        """Iterate prepared batches. With ``pull_ahead >= 1`` the convert
        + pull runs on a DeviceLoader worker `pull_ahead` batches ahead;
        with 0 it runs inline."""
        if self.pull_ahead == 0:
            it = reader() if callable(reader) else reader
            for batch in it:
                self._c_miss.inc()  # inline = never overlapped
                yield self._convert(batch)
            return
        loader = DeviceLoader(reader, capacity=self.pull_ahead,
                              convert=self._convert, name="ps_prefetch",
                              place=self.place)
        self._loader = loader
        try:
            it = iter(loader)
            while True:
                ready = loader.queue_depth > 0
                try:
                    prepared = next(it)
                except StopIteration:
                    return
                (self._c_hit if ready else self._c_miss).inc()
                yield prepared
        finally:
            loader.close()
            self._loader = None

    # ------------------------------------------------------ dispatch + push
    def _patched_cache(self, binding: PsTableBinding, entry: _Entry):
        """Read-your-writes repair: overlay every push the pull could not
        have seen, in place on the entry's own cache. Ascending-seq order
        so later pushes win."""
        pusher = self._pushers[binding.param]
        pusher._check()
        if pusher.issued_seq == entry.version:
            return entry.cache  # pull already reflects everything issued
        oldest_kept = (pusher.recent[0][0] if pusher.recent
                       else pusher.issued_seq + 1)
        if entry.version + 1 < oldest_kept:
            # pushes this pull missed have left the window: flush and
            # re-pull (rare — only when a consumer stalls far behind)
            self._c_repulls.inc()
            pusher.flush()
            fresh = self._pull_cache(binding, entry.uids,
                                     pusher.applied_seq,
                                     cap=int(entry.cache.shape[0]))
            return fresh.cache
        cache = entry.cache
        n = entry.n
        for seq, puids, prows in list(pusher.recent):
            if seq <= entry.version or puids.size == 0 or n == 0:
                continue
            pos = np.searchsorted(entry.uids, puids)
            posc = np.minimum(pos, n - 1)
            mask = entry.uids[posc] == puids
            if not mask.any():
                continue
            tgt = torch.from_numpy(posc[mask].astype(np.int64))
            src = torch.from_numpy(np.nonzero(mask)[0].astype(np.int64))
            i16(cache).index_copy_(
                0, tgt.to(self.device),
                i16(prows).index_select(0, src.to(self.device)))
            self._c_patched.inc(int(tgt.numel()))
        return cache

    def _dispatch_hot(self, binding: PsTableBinding, hot, entry: _Entry):
        """Slab maintenance for one step, in plan order: write back the
        plan's eviction victims (gathered BEFORE their slots are
        overwritten), read-your-writes-patch the pulled miss rows, and
        scatter them into their slab slots. Returns the slab to run on."""
        plan = entry.plan
        hot.ensure_slab()
        if plan.evict_uids.size:
            # always write evicted rows back — for a clean row the push
            # rewrites identical bytes (idempotent); for a dirty one this
            # IS the write-back that makes eviction lossless
            rows = hot.take_rows(plan.evict_slots)
            self._pushers[binding.param].submit(plan.evict_uids, rows)
            hot.note_writeback(int(plan.evict_uids.size))
        if entry.n:
            patched = self._patched_cache(binding, entry)
            hot.insert_rows(plan.miss_slots, patched)
        return hot.slab

    def run_step(self, exe, prepared: _Prepared, fetch_list=None,
                 scope=None, **run_kw):
        """One training step: swap caches in, run, push updated rows.
        With the host tracer on (``observability.tracer``) the step is a
        ``ps/train_step`` span, the root of a new trace."""
        from ..observability.tracer import start_trace

        with start_trace("ps/train_step"):
            return self._run_step(exe, prepared, fetch_list, scope,
                                  **run_kw)

    def _run_step(self, exe, prepared: _Prepared, fetch_list=None,
                  scope=None, **run_kw):
        from ..core.scope import _scope  # thread-local default scope

        sc = scope if scope is not None else _scope()
        for b in self.bindings:
            entry = prepared.entries[b.param]
            hot = self._hot.get(b.param)
            if hot is None:
                sc.set_var(b.param, self._patched_cache(b, entry))
            else:
                sc.set_var(b.param, self._dispatch_hot(b, hot, entry))
        out = exe.run(self.program, feed=prepared.feed,
                      fetch_list=fetch_list, scope=sc, **run_kw)
        for b in self.bindings:
            entry = prepared.entries[b.param]
            hot = self._hot.get(b.param)
            new_cache = sc.find_var(b.param)
            if hot is None:
                # hand the pusher the full cache: the device→host copy of
                # its [:n] rows happens in the pusher; the tensor is never
                # re-fed to the program (set_var replaces it with the next
                # step's pull before the next run), so no later update
                # writes into it
                self._pushers[b.param].submit(entry.uids, new_cache)
                continue
            # hot path: the program updated the slab in place, and it IS
            # the next step's slab; only rows that leave it cross back to
            # the shards — the staging (bypass) rows now (a gathered
            # copy), resident rows on eviction/flush
            hot.slab = new_cache
            plan = entry.plan
            if plan.bypass_uids.size:
                rows = hot.take_rows(plan.bypass_slots)
                self._pushers[b.param].submit(plan.bypass_uids, rows)
            hot.commit(plan)
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
            self._step_event = event
        return out

    def train(self, exe, reader, fetch_list=None, scope=None,
              max_steps: Optional[int] = None):
        """Convenience loop: yields each step's fetch results."""
        done = 0
        for prepared in self.steps(reader, scope=scope):
            yield self.run_step(exe, prepared, fetch_list=fetch_list,
                                scope=scope)
            done += 1
            if max_steps is not None and done >= max_steps:
                break
        self.flush()

    # ------------------------------------------------------------ lifecycle
    def _flush_param(self, param: str) -> None:
        """Make the shards authoritative for one table: push every row
        whose newest bytes live only in the hot slab (dirty residents +
        planned-but-undispatched eviction victims), then drain the
        pusher. This is also the table's checkpoint flush hook, so
        ``Checkpointer.save(ps_tables=...)`` dumps shard bytes that the
        ``@ps_mark@`` journal mark really covers."""
        hot = self._hot.get(param)
        pusher = self._pushers[param]
        if hot is not None and hot.slab is not None:
            fuids, fslots = hot.flush_rows()
            if fuids.size:
                rows = hot.take_rows(fslots)
                pusher.submit(fuids, rows)
                hot.note_writeback(int(fuids.size))
        pusher.flush()

    def flush(self):
        """Drain every pusher — after this the shards hold every update
        (checkpoint save and the exactness tests call this). In hot-cache
        mode, dirty resident rows are written back first."""
        for b in self.bindings:
            self._flush_param(b.param)

    def stats(self) -> dict:
        out = {b.param: b.table.stats() for b in self.bindings}
        for p, hot in self._hot.items():
            out[p]["hot_cache"] = hot.stats()
        return out

    def close(self):
        if self._loader is not None:
            self._loader.close()
            self._loader = None
        for p in self._pushers.values():
            p.close()
        for b in self.bindings:
            b.table.set_flush_hook(None)
            b.table.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        try:
            self.flush()
        finally:
            self.close()
        return False
