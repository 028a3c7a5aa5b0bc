"""ShardedTable — one logical embedding table fanned out over N shards.

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
ints (read by the bench's ``ps_embedding`` record and ``stats()``).

The port's copy of ``paddle_tpu.ps.table``.

The table can keep a client-side **push journal**: every push batch is
appended — per shard, BEFORE the remote send — and entries stay until a
checkpoint that contains them commits (``journal_truncate``). It is what
lossless shard recovery replays on top of a checkpoint slice. The journal
is bounded by ``PDTPU_PS_JOURNAL_MAX_MB``: past the cap the oldest entries
are evicted and the eviction horizon recorded; ``ps/journal_bytes`` gauges
it. The recovery that reads it (``recover_shard``), the checkpointer and
the socket transport are not ported yet (ROADMAP), so the port's cap
defaults to 0 (the JAX package's is 256): a push then copies no rows, and
only the push seq and the eviction horizon advance, as if every entry had
been evicted at once.
"""
from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

import numpy as np

from ..observability import get_registry
from .shard import RangeSpec, make_shards
from .transport import InProcessClient, ShardClient, TransportError

__all__ = ["ShardedTable"]


class ShardedTable:
    """Client-side view of one range-partitioned table.

    ``clients[i]`` serves rows ``spec.bounds(i)``; several tables may
    share the same client objects (one worker process per shard hosting
    every table's slice), so the executor pool is per-table but sized by
    shard count.
    """

    def __init__(self, name: str, spec: RangeSpec,
                 clients: Sequence[ShardClient], lanes: int = 128):
        if len(clients) != spec.num_shards:
            raise ValueError(
                f"ShardedTable {name!r}: {len(clients)} clients for "
                f"{spec.num_shards} shards")
        self.name = str(name)
        self.spec = spec
        self.clients = list(clients)
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
        self._pool = (ThreadPoolExecutor(max_workers=spec.num_shards,
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

    def _shard_pull(self, i: int, ids_chunk: np.ndarray):
        """One shard's pull, on whatever thread the fan-out picked, timed
        individually."""
        t0 = time.perf_counter()
        out = self.clients[i].pull(self.name, ids_chunk)
        self._h_shard_pull[i].observe((time.perf_counter() - t0) * 1e3)
        return out

    def pull(self, sorted_uids: np.ndarray) -> np.ndarray:
        """Packed rows ``[k, lanes] uint16`` for ascending unique ids."""
        t0 = time.perf_counter()
        ids, chunks = self._chunks(sorted_uids)
        if not chunks:
            out = np.zeros((0, self.lanes), dtype=np.uint16)
        else:
            jobs = [(i, (lambda i=i, sl=sl: self._shard_pull(i, ids[sl])))
                    for i, sl in chunks]
            parts = self._run(jobs)
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
        jobs = [(i, (lambda i=i, sl=sl: self.clients[i].push(
            self.name, ids[sl], rows[sl]))) for i, sl in chunks]
        self._run(jobs)
        nb = rows.nbytes
        with self._acct:
            for (i, sl) in chunks:
                self.bytes_pushed_per_shard[i] += (
                    (sl.stop - sl.start) * self.lanes * 2)
        self._c_pushed.inc(nb)
        self._h_push.observe((time.perf_counter() - t0) * 1e3)

    # ---------------------------------------------------------------- journal
    def _journal_append(self, ids: np.ndarray, rows: np.ndarray, chunks):
        max_bytes = int(float(os.environ.get(
            "PDTPU_PS_JOURNAL_MAX_MB", "0")) * (1 << 20))
        with self._jlock:
            self._journal_seq += 1
            seq = self._journal_seq
            if max_bytes <= 0:
                for i, _ in chunks:
                    self._evicted_upto[i] = seq
                return
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

    # -------------------------------------------------------- full-table io
    def dump_full(self) -> np.ndarray:
        """Assemble the whole ``[vocab, lanes]`` table (checkpoint save;
        ranges are ordered and exhaustive so this is a concat)."""
        parts = self._run(
            [(i, (lambda i=i: self.clients[i].dump(self.name)))
             for i in range(self.spec.num_shards)])
        return np.concatenate([p for _, p in parts], axis=0)

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
