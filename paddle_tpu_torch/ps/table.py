"""ShardedTable — one logical embedding table fanned out over N shards (the
port's copy of ``paddle_tpu.ps.table``).

The worker-side aggregation point: takes SORTED unique global row ids
(what ``uniq_merge`` / ``np.unique`` produce), slices them into per-shard
contiguous chunks via the range spec, fans pull/push out across the shard
clients, and re-assembles pulls by concatenation (sorted ids + ordered
ranges ⇒ shard chunks are adjacent slices — no scatter on the hot path).

Fan-out uses one long-lived thread per shard only when there is more than
one shard: for the in-process single-shard case direct dispatch is
cheaper, and for socket shards the threads are what actually buys
parallelism (each client connection is its own TCP stream).

Metrics: ``ps/pull_ms`` / ``ps/push_ms`` histograms and
``ps/bytes_pulled`` / ``ps/bytes_pushed`` counters land in the process
`observability` Registry; per-shard byte counters are kept here as plain
ints (read by ``stats()``).

Fault tolerance (the lossless-recovery half; transport retries are the
other half). The table keeps a client-side **push journal**: every push
batch is appended — per shard, BEFORE the remote send — and entries stay
until a checkpoint that contains them commits (``journal_truncate``,
driven by the Checkpointer's commit callback). A restarted shard is then
rebuilt exactly: ``recover_shard(i)`` loads the shard's slice of the
newest verified checkpoint and replays that shard's journal entries past
the checkpoint's mark, in issue order. Because entries are retained even
after a SUCCESSFUL remote push, replay is a superset of what the shard
may have lost — and pushes carry absolute rows (scatter-SET), so
re-applying one is idempotent. Net: checkpoint slice + replay ==
every push ever issued == what a never-crashed shard would hold.

The journal is bounded (``PDTPU_PS_JOURNAL_MAX_MB``, default 256):
past the cap the oldest entries are evicted and the eviction horizon
recorded — a later recovery that would need an evicted entry fails
loudly ("checkpoint too old for the journal") instead of rebuilding a
silently stale shard. Checkpoint cadence therefore bounds journal
growth; ``ps/journal_bytes`` gauges it.

Recovery runs under a write-lock while pull/push hold read-locks: a
concurrent push can never land between the checkpoint load and the
replay (where the load would erase it from the shard but the replay
snapshot would miss it).
"""
from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..observability import get_registry
from ..observability import context as _trace_ctx
from .shard import EmbeddingShard, RangeSpec, make_shards
from .transport import InProcessClient, ShardClient, TransportError

__all__ = ["ShardedTable"]


class _RWLock:
    """Many readers (pull/push fan-outs) XOR one writer (shard
    recovery). Writer-preference is irrelevant at this contention level;
    keep it minimal."""

    def __init__(self):
        self._cv = threading.Condition()
        self._readers = 0
        self._writer = False

    def acquire_read(self):
        with self._cv:
            while self._writer:
                self._cv.wait()
            self._readers += 1

    def release_read(self):
        with self._cv:
            self._readers -= 1
            if self._readers == 0:
                self._cv.notify_all()

    def acquire_write(self):
        with self._cv:
            while self._writer or self._readers:
                self._cv.wait()
            self._writer = True

    def release_write(self):
        with self._cv:
            self._writer = False
            self._cv.notify_all()


class ShardedTable:
    """Client-side view of one range-partitioned table.

    ``clients[i]`` serves rows ``spec.bounds(i)``; several tables may
    share the same client objects (one worker process per shard hosting
    every table's slice), so the executor pool is per-table but sized by
    shard count.
    """

    def __init__(self, name: str, spec: RangeSpec,
                 clients: Sequence[ShardClient], lanes: int = 128,
                 push_clients: Optional[Sequence[ShardClient]] = None):
        """push_clients: optional dedicated channel for pushes. A socket
        client serializes requests on its one connection, so when an
        async pusher (push_depth >= 1) shares clients with the pull
        prefetcher, every push queues behind — and delays — the next
        prefetch pull to the same shard. A second connection per shard
        lets them truly overlap; read-your-writes patching in the tier
        already covers the pull/push race. Defaults to `clients`
        (in-process dispatch has no per-connection serialization)."""
        if len(clients) != spec.num_shards:
            raise ValueError(
                f"ShardedTable {name!r}: {len(clients)} clients for "
                f"{spec.num_shards} shards")
        if (push_clients is not None
                and len(push_clients) != spec.num_shards):
            raise ValueError(
                f"ShardedTable {name!r}: {len(push_clients)} push clients "
                f"for {spec.num_shards} shards")
        self.name = str(name)
        self.spec = spec
        self.clients = list(clients)
        self.push_clients = (list(push_clients) if push_clients is not None
                             else self.clients)
        self.lanes = int(lanes)
        self.bytes_pulled_per_shard = [0] * spec.num_shards
        self.bytes_pushed_per_shard = [0] * spec.num_shards
        self._acct = threading.Lock()
        # push journal: per-shard [(seq, ids, rows)] since the last
        # committed checkpoint (see module docstring)
        self._jlock = threading.Lock()
        self._journal: List[List[tuple]] = [[] for _ in range(spec.num_shards)]
        self._journal_seq = 0
        self._journal_nbytes = 0
        # highest seq ever evicted from shard i's journal by the size cap
        self._evicted_upto = [0] * spec.num_shards
        self._rw = _RWLock()
        # delta-push taps: called (sorted_uids, rows) AFTER a push has
        # been applied on the shards — the streaming DeltaPublisher rides
        # this to stream touched rows to serving replicas
        self._push_listeners: List[Callable] = []
        self._recovery: Optional[Callable[[int, BaseException], None]] = None
        # armed by the tier: Checkpointer.save() calls it before taking
        # the journal mark / dumping shards, so device-resident dirty rows
        # (hot cache) and queued async pushes land first (see
        # set_flush_hook)
        self.flush_hook: Optional[Callable[[], None]] = None
        # with a dual channel, pulls and pushes run concurrently — size
        # the pool so one side never starves the other of workers
        self._pool = (ThreadPoolExecutor(
            max_workers=spec.num_shards * (
                2 if push_clients is not None else 1),
            thread_name_prefix=f"ps-{name}")
            if spec.num_shards > 1 else None)
        reg = get_registry()
        self._h_pull = reg.histogram("ps/pull_ms")
        self._h_push = reg.histogram("ps/push_ms")
        # per-shard pull time, observed INSIDE the fan-out thunk so each
        # sample is one shard's RPC (not the whole fan-out): the
        # federation layer's per-shard p99 straggler signal (ROADMAP 5)
        self._h_shard_pull = [reg.histogram("ps/shard_pull_ms", shard=str(i))
                              for i in range(spec.num_shards)]
        self._c_pulled = reg.counter("ps/bytes_pulled")
        self._c_pushed = reg.counter("ps/bytes_pushed")
        self._g_journal = reg.gauge("ps/journal_bytes", table=self.name)

    @classmethod
    def build_in_process(cls, name: str, spec: RangeSpec,
                         full_rows: Optional[np.ndarray] = None,
                         lanes: int = 128) -> "ShardedTable":
        """Single-host convenience: materialize the shards in this
        process (optionally pre-loaded from a full packed table) behind
        in-process clients."""
        shards = make_shards(name, spec, full_rows, lanes=lanes)
        return cls(name, spec, [InProcessClient([s]) for s in shards],
                   lanes=lanes)

    # ------------------------------------------------------------- fan-out
    def _chunks(self, sorted_ids: np.ndarray):
        """(shard_index, id-slice) for each shard that owns any of the
        ids. ``sorted_ids`` must be ascending (asserted cheaply at the
        ends — full monotonicity is the caller's contract)."""
        sorted_ids = np.asarray(sorted_ids, dtype=np.int64)
        if sorted_ids.size and sorted_ids[0] > sorted_ids[-1]:
            raise ValueError(
                f"ShardedTable {self.name!r}: ids must be ascending "
                f"(first={int(sorted_ids[0])} > last={int(sorted_ids[-1])}); "
                f"an unsorted pull would reassemble rows in the wrong order")
        cuts = self.spec.cuts_into(sorted_ids)
        out = []
        for i in range(self.spec.num_shards):
            a, b = int(cuts[i]), int(cuts[i + 1])
            if b > a:
                out.append((i, slice(a, b)))
        return sorted_ids, out

    def _run(self, jobs):
        """Execute (shard_index, thunk) jobs, parallel across shards.
        A TransportError is tagged with ``shard_index`` (the recovery
        hook needs to know WHICH shard died); with a pool, every future
        is drained before the first error re-raises, so a retry never
        races a still-in-flight sibling job."""
        if self._pool is None or len(jobs) <= 1:
            out = []
            for i, fn in jobs:
                try:
                    out.append((i, fn()))
                except TransportError as e:
                    e.shard_index = i
                    raise
            return out
        futs = [(i, self._pool.submit(fn)) for i, fn in jobs]
        results, first_err = [], None
        for i, f in futs:
            try:
                results.append((i, f.result()))
            except BaseException as e:
                if isinstance(e, TransportError):
                    e.shard_index = i
                if first_err is None:
                    first_err = e
        if first_err is not None:
            raise first_err
        return results

    def _run_shared(self, jobs):
        """_run under the read side of the recovery lock (dump/load
        paths: they must not interleave with a recovery's load+replay)."""
        self._rw.acquire_read()
        try:
            return self._run(jobs)
        finally:
            self._rw.release_read()

    def _run_recovering(self, jobs):
        """_run, retrying through the recovery hook: a transient
        transport failure on shard i hands (i, exc) to the hook (the
        tier's recover-and-resume path) and, when the hook returns,
        re-runs ALL the jobs — safe because pull is a read and push
        scatter-sets absolute rows (re-applying identical data is a
        no-op). The hook is invoked with no locks held; it raises to
        abort (no hook installed, wedge deadline exceeded, unrecoverable
        taxonomy) and that abort propagates to the training loop."""
        while True:
            try:
                self._rw.acquire_read()
                try:
                    return self._run(jobs)
                finally:
                    self._rw.release_read()
            except TransportError as e:
                hook = self._recovery
                i = getattr(e, "shard_index", None)
                if hook is None or i is None or not e.transient:
                    raise
                hook(i, e)

    def _shard_pull(self, i: int, ids_chunk: np.ndarray, ctx):
        """One shard's pull, on whatever thread the fan-out picked:
        re-activate the caller's trace context (thread-locals don't
        follow pool jobs) and time the shard individually."""
        with _trace_ctx.use(ctx):
            t0 = time.perf_counter()
            out = self.clients[i].pull(self.name, ids_chunk)
            self._h_shard_pull[i].observe((time.perf_counter() - t0) * 1e3)
            return out

    def pull(self, sorted_uids: np.ndarray) -> np.ndarray:
        """Packed rows ``[k, lanes] uint16`` for ascending unique ids."""
        t0 = time.perf_counter()
        ctx = _trace_ctx.current()
        ids, chunks = self._chunks(sorted_uids)
        if not chunks:
            out = np.zeros((0, self.lanes), dtype=np.uint16)
        else:
            jobs = [(i, (lambda i=i, sl=sl: self._shard_pull(
                i, ids[sl], ctx))) for i, sl in chunks]
            parts = self._run_recovering(jobs)
            out = (parts[0][1] if len(parts) == 1
                   else np.concatenate([r for _, r in parts], axis=0))
        nb = out.nbytes
        with self._acct:
            for (i, sl) in chunks:
                self.bytes_pulled_per_shard[i] += (
                    (sl.stop - sl.start) * self.lanes * 2)
        self._c_pulled.inc(nb)
        self._h_pull.observe((time.perf_counter() - t0) * 1e3)
        return out

    def _shard_push(self, i: int, ids_chunk, rows_chunk, ctx):
        with _trace_ctx.use(ctx):
            self.push_clients[i].push(self.name, ids_chunk, rows_chunk)

    def push(self, sorted_uids: np.ndarray, rows: np.ndarray) -> None:
        """Scatter-set whole rows at ascending unique ids."""
        t0 = time.perf_counter()
        ids, chunks = self._chunks(sorted_uids)
        rows = np.asarray(rows, dtype=np.uint16)
        if rows.shape != (ids.shape[0], self.lanes):
            raise ValueError(
                f"ShardedTable {self.name!r}: push rows {rows.shape} != "
                f"({ids.shape[0]}, {self.lanes})")
        # journal BEFORE the remote send: if the shard dies mid-push the
        # batch is already replayable
        self._journal_append(ids, rows, chunks)
        ctx = _trace_ctx.current()
        jobs = [(i, (lambda i=i, sl=sl: self._shard_push(
            i, ids[sl], rows[sl], ctx))) for i, sl in chunks]
        self._run_recovering(jobs)
        nb = rows.nbytes
        with self._acct:
            for (i, sl) in chunks:
                self.bytes_pushed_per_shard[i] += (
                    (sl.stop - sl.start) * self.lanes * 2)
        self._c_pushed.inc(nb)
        self._h_push.observe((time.perf_counter() - t0) * 1e3)
        # notify AFTER the remote apply: a listener that forwards these
        # bytes to a serving cache never races ahead of the shard state.
        # Listener arrays are read-only by contract (not re-copied here).
        for fn in self._push_listeners:
            try:
                fn(ids, rows)
            except Exception:
                get_registry().counter("stream/listener_errors",
                                       table=self.name).inc()

    def add_push_listener(self, fn: Callable) -> None:
        """Register `fn(sorted_uids, rows)` to observe every applied push
        (the train->serve delta stream tap). A listener must not mutate
        its arguments and must not block — it runs on whatever thread
        issued the push (trainer or async flusher)."""
        self._push_listeners.append(fn)

    def remove_push_listener(self, fn: Callable) -> None:
        try:
            self._push_listeners.remove(fn)
        except ValueError:
            pass

    # ------------------------------------------------------ journal/recovery
    def _journal_append(self, ids: np.ndarray, rows: np.ndarray, chunks):
        max_bytes = int(float(os.environ.get(
            "PDTPU_PS_JOURNAL_MAX_MB", "256")) * (1 << 20))
        with self._jlock:
            self._journal_seq += 1
            seq = self._journal_seq
            for i, sl in chunks:
                # own copies: the caller's buffers are reused across steps
                e = (seq, ids[sl].copy(), rows[sl].copy())
                self._journal[i].append(e)
                self._journal_nbytes += e[1].nbytes + e[2].nbytes
            while self._journal_nbytes > max_bytes:
                # evict the globally-oldest entry (smallest head seq)
                heads = [(sh[0][0], i) for i, sh in enumerate(self._journal)
                         if sh]
                if not heads:
                    break
                _, i = min(heads)
                s, eids, erows = self._journal[i].pop(0)
                self._journal_nbytes -= eids.nbytes + erows.nbytes
                self._evicted_upto[i] = max(self._evicted_upto[i], s)
            self._g_journal.set(float(self._journal_nbytes))

    def journal_mark(self) -> int:
        """The current push seq. A checkpoint taken AFTER a flush records
        this mark: every journal entry with seq <= mark is contained in
        the checkpoint's shard bytes."""
        with self._jlock:
            return self._journal_seq

    def journal_truncate(self, mark: int) -> None:
        """Drop entries a committed checkpoint at `mark` made redundant
        (the Checkpointer's on-commit callback). Idempotent."""
        with self._jlock:
            for i, sh in enumerate(self._journal):
                kept = [e for e in sh if e[0] > mark]
                self._journal_nbytes -= sum(
                    e[1].nbytes + e[2].nbytes for e in sh) - sum(
                    e[1].nbytes + e[2].nbytes for e in kept)
                self._journal[i] = kept
            self._g_journal.set(float(self._journal_nbytes))

    def journal_reset(self, mark: int) -> None:
        """Restore-time coherence: the shards were just load_full'd from
        a checkpoint whose mark is `mark` — the journal (possibly from a
        DIFFERENT process lifetime, where seq counting restarted at 0) no
        longer describes deltas over the live shard state. Clear it and
        fast-forward the seq counter past the mark so future marks stay
        monotonic."""
        with self._jlock:
            self._journal = [[] for _ in range(self.spec.num_shards)]
            self._journal_nbytes = 0
            self._journal_seq = max(self._journal_seq, int(mark))
            self._evicted_upto = [int(mark)] * self.spec.num_shards
            self._g_journal.set(0.0)

    def journal_bytes(self) -> int:
        with self._jlock:
            return self._journal_nbytes

    def journal_entries_since(self, mark: int) -> List[tuple]:
        """Every journaled push past `mark` as ``[(seq, ids, rows)]`` in
        ascending seq order — the payload of an incremental checkpoint
        (``Checkpointer.save_delta``). Per-shard slices of one original
        push (same seq) are re-merged in shard order, so each returned
        entry has ascending ids and replays as one valid ``push``.
        Raises when the journal cap evicted entries the range needs: a
        delta built over a hole would restore silently stale rows."""
        mark = int(mark)
        with self._jlock:
            for i, ev in enumerate(self._evicted_upto):
                if ev > mark:
                    raise RuntimeError(
                        f"ShardedTable {self.name!r}: cannot build a delta "
                        f"since mark {mark}: shard {i}'s journal evicted "
                        f"entries up to seq {ev} (PDTPU_PS_JOURNAL_MAX_MB "
                        "cap) — save deltas/checkpoints more often or "
                        "raise the cap")
            by_seq: Dict[int, list] = {}
            for i, sh in enumerate(self._journal):
                for seq, ids, rows in sh:
                    if seq > mark:
                        by_seq.setdefault(seq, []).append((i, ids, rows))
        out = []
        for seq in sorted(by_seq):
            parts = sorted(by_seq[seq], key=lambda p: p[0])
            if len(parts) == 1:
                out.append((seq, parts[0][1], parts[0][2]))
            else:
                out.append((seq,
                            np.concatenate([p[1] for p in parts]),
                            np.concatenate([p[2] for p in parts], axis=0)))
        return out

    def set_flush_hook(self, hook: Optional[Callable[[], None]]) -> None:
        """Install (or clear) the make-shards-authoritative callback the
        Checkpointer invokes before snapshotting this table. The tier
        points it at its flush path — dirty hot-cache rows are written
        back and the pusher drained — so ``journal_mark()`` taken right
        after really covers the dumped shard bytes, without every save
        call site having to remember ``tier.flush()``."""
        self.flush_hook = hook

    def set_recovery(self,
                     hook: Optional[Callable[[int, BaseException], None]]
                     ) -> None:
        """Install the shard-outage handler pull/push retry through (the
        tier's wait-for-shard + recover_shard orchestration)."""
        self._recovery = hook

    def recover_shard(self, i: int, base_rows: np.ndarray,
                      base_mark: int) -> int:
        """Rebuild restarted shard `i` losslessly: load its slice of
        `base_rows` (the full ``[vocab, lanes]`` table from the newest
        VERIFIED checkpoint, whose journal mark is `base_mark`), then
        replay this shard's journal entries past the mark in issue
        order. Returns the number of batches replayed. Runs under the
        write lock — no pull/push interleaves. Raises if the journal's
        size cap evicted entries the replay needs (checkpoint older than
        the journal horizon): recovery would be silently lossy."""
        base_rows = np.asarray(base_rows, dtype=np.uint16)
        if base_rows.shape != (self.spec.vocab, self.lanes):
            raise ValueError(
                f"ShardedTable {self.name!r}: recover_shard base shape "
                f"{base_rows.shape} != ({self.spec.vocab}, {self.lanes})")
        lo, hi = self.spec.bounds(i)
        self._rw.acquire_write()
        try:
            with self._jlock:
                if base_mark < self._evicted_upto[i]:
                    raise RuntimeError(
                        f"ShardedTable {self.name!r}: cannot recover shard "
                        f"{i} from checkpoint mark {base_mark}: the journal "
                        f"evicted entries up to seq {self._evicted_upto[i]} "
                        f"(PDTPU_PS_JOURNAL_MAX_MB cap) — checkpoint more "
                        "often or raise the cap")
                replay = [e for e in self._journal[i] if e[0] > base_mark]
            # the restarted server carries a fresh instance id; expect it
            clients = {id(self.clients[i]): self.clients[i],
                       id(self.push_clients[i]): self.push_clients[i]}
            for c in clients.values():
                c.reset_instance_expectation()
            self.clients[i].load(self.name, base_rows[lo:hi])
            for _seq, ids, rows in replay:
                self.push_clients[i].push(self.name, ids, rows)
            return len(replay)
        finally:
            self._rw.release_write()

    def sweep(self) -> int:
        """Fan a dynamic-vocab eviction pass out to every shard; returns
        total rows evicted (0 when every shard is static)."""
        parts = self._run_shared(
            [(i, (lambda i=i: self.clients[i].sweep(self.name)))
             for i in range(self.spec.num_shards)])
        return int(sum(n for _, n in parts))

    # -------------------------------------------------------- full-table io
    def dump_shard(self, i: int) -> np.ndarray:
        return self.clients[i].dump(self.name)

    def dump_full(self) -> np.ndarray:
        """Assemble the whole ``[vocab, lanes]`` table (checkpoint save;
        ranges are ordered and exhaustive so this is a concat)."""
        parts = self._run_shared(
            [(i, (lambda i=i: self.clients[i].dump(self.name)))
             for i in range(self.spec.num_shards)])
        return np.concatenate([p for _, p in parts], axis=0)

    def load_full(self, full_rows: np.ndarray) -> None:
        """Re-partition a full table onto the LIVE spec — this is what
        makes restore-onto-a-different-shard-count work: the checkpoint
        stores per-shard slices, `_assemble_shards` merges them into the
        full array, and this scatter follows the current boundaries."""
        full_rows = np.asarray(full_rows, dtype=np.uint16)
        if full_rows.shape != (self.spec.vocab, self.lanes):
            raise ValueError(
                f"ShardedTable {self.name!r}: load_full shape "
                f"{full_rows.shape} != ({self.spec.vocab}, {self.lanes})")
        jobs = []
        for i in range(self.spec.num_shards):
            lo, hi = self.spec.bounds(i)
            jobs.append((i, (lambda i=i, lo=lo, hi=hi:
                             self.clients[i].load(
                                 self.name, full_rows[lo:hi]))))
        self._run_shared(jobs)

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        per_shard = []
        for i in range(self.spec.num_shards):
            lo, hi = self.spec.bounds(i)
            per_shard.append({
                "shard": i, "lo": lo, "hi": hi, "rows": hi - lo,
                "bytes_pulled": self.bytes_pulled_per_shard[i],
                "bytes_pushed": self.bytes_pushed_per_shard[i],
            })
        with self._jlock:
            journal = {"bytes": self._journal_nbytes,
                       "seq": self._journal_seq,
                       "entries": sum(len(s) for s in self._journal),
                       "evicted_upto": list(self._evicted_upto)}
        return {"name": self.name, "vocab": self.spec.vocab,
                "num_shards": self.spec.num_shards,
                "lanes": self.lanes, "shards": per_shard,
                "journal": journal}

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
