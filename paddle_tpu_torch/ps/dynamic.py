"""Dynamic-vocab embedding shards — tables that grow past provisioning (the
port's copy of ``paddle_tpu.ps.dynamic``).

Reference analog: pslib's DownpourSparseTable in *online* mode — ids are
not provisioned up front; a row materializes the first time a worker
touches it (init-on-pull) and a background shrink pass reclaims ids that
went cold (``FleetWrapper::ShrinkSparseTable``). That is what lets the
production CTR table hold billions of *live* ids inside a bounded DRAM
budget: the id SPACE is huge, the resident row set is capped.

:class:`DynamicEmbeddingShard` keeps the :class:`~.shard.EmbeddingShard`
wire contract (global-id pull/push, scatter-SET semantics, dense
dump/load for the checkpoint path) but stores rows in a fixed
``capacity``-row slab with the shared :mod:`.slab` bookkeeping:

* ``SlotMap`` — global id -> slab slot (dict mode; the id universe is
  unbounded by design);
* ``LruOrder`` + per-slot touch timestamps — the TTL/recency half of the
  eviction policy;
* ``FreqSketch`` — the frequency half: a cold-by-recency row whose
  estimated frequency is still high gets one second chance per sweep.

Semantics the tests pin down:

* a pull of a never-seen id returns the DETERMINISTIC init row
  (``init_row_fn``, default all-zero packed rows = 0.0 embedding and
  zero optimizer state) and materializes it;
* evicting a row discards its bytes *and optimizer state*: a later
  touch re-materializes the init row, never stale bytes;
* ``sweep()`` runs under the same mutation lock as pull/push (eviction
  can never interleave with an in-flight push's scatter) and skips
  pinned rows (``pin``/``unpin`` — the hot-cache-style in-flight guard);
* ``dump``/``load`` stay bitwise round-trips: dump scatters live rows
  over an init-filled dense slice, load re-materializes exactly the rows
  that differ from init (a row equal to its init row pulls the same
  bytes whether or not it occupies a slot).

Observability: ``ps/vocab_rows`` / ``ps/vocab_capacity`` gauges and
``ps/materialized_rows`` / ``ps/evicted_rows`` counters (labelled by
table + shard range) land in the process registry — a socket pserver
exports them through the transport ``metrics`` op into the
federation surface; ``tools/ps_admin.py stats`` renders them as the
``vocab`` block.

Like the static shard, this module is numpy + stdlib only: pserver
processes import neither torch nor JAX.
"""
from __future__ import annotations

import os
import time
from typing import Callable, List, Optional

import numpy as np

from ..observability import get_registry
from .shard import PACK_LANES, EmbeddingShard, RangeSpec
from .slab import FreqSketch, LruOrder, SlotMap

__all__ = ["DynamicEmbeddingShard", "make_dynamic_shards", "zero_init_rows"]


def zero_init_rows(ids: np.ndarray, lanes: int = PACK_LANES) -> np.ndarray:
    """The default deterministic init: all-zero packed rows (0.0 visible
    columns, zero optimizer state) — the standard cold-start for online
    CTR ids, and trivially reproducible across evict/re-touch cycles."""
    return np.zeros((np.asarray(ids).shape[0], lanes), dtype=np.uint16)


class DynamicEmbeddingShard(EmbeddingShard):
    """A ``[lo, hi)`` range served out of a ``capacity``-row slab.

    ``hi - lo`` (the id space) may vastly exceed ``capacity`` (the
    provisioned rows, i.e. the memory cap: ``capacity * lanes * 2``
    bytes). When the slab is full, admitting a new id evicts the
    coldest unpinned resident on demand; ``sweep()`` does the same
    proactively on a TTL/watermark policy so steady-state stays under
    the high watermark instead of thrashing at 100%.
    """

    def __init__(self, name: str, lo: int, hi: int, capacity: int,
                 lanes: int = PACK_LANES,
                 init_row_fn: Optional[Callable[[np.ndarray], np.ndarray]]
                 = None,
                 ttl_s: Optional[float] = None,
                 high_watermark: float = 0.95,
                 low_watermark: float = 0.80,
                 keep_freq: int = 0):
        if capacity < 1:
            raise ValueError(
                f"DynamicEmbeddingShard {name!r}: capacity must be >= 1")
        if not (0.0 < low_watermark <= high_watermark <= 1.0):
            raise ValueError(
                f"DynamicEmbeddingShard {name!r}: need 0 < low <= high <= 1 "
                f"watermarks, got {low_watermark}/{high_watermark}")
        # base init allocates [hi-lo, lanes]; bypass it — the whole point
        # is that the dense range never exists in memory. Re-implement the
        # small amount of base state instead.
        if hi <= lo:
            raise ValueError(f"DynamicEmbeddingShard {name!r}: empty range "
                             f"[{lo}, {hi})")
        self.name = str(name)
        self.lo, self.hi = int(lo), int(hi)
        self.capacity = int(capacity)
        self.lanes = int(lanes)
        self.rows = np.zeros((self.capacity, lanes), dtype=np.uint16)  # slab
        import threading
        self._lock = threading.Lock()
        self.bytes_pulled = 0
        self.bytes_pushed = 0
        self.n_pulls = 0
        self.n_pushes = 0
        self._init_row_fn = init_row_fn or (
            lambda ids: zero_init_rows(ids, self.lanes))
        self.ttl_s = (float(ttl_s) if ttl_s is not None else
                      float(os.environ.get("PDTPU_PS_VOCAB_TTL_S", "0")) or
                      None)
        self.high_watermark = float(high_watermark)
        self.low_watermark = float(low_watermark)
        self.keep_freq = int(keep_freq)
        self._slots = SlotMap(self.capacity)          # global id -> slot
        self._lru = LruOrder()
        self._freq = FreqSketch(width=1 << 12)
        self._touched = np.zeros(self.capacity, np.float64)  # per-slot ts
        self._born = np.zeros(self.capacity, np.float64)
        self._pins: dict = {}                          # global id -> refcount
        self.materialized_total = 0
        self.evicted_total = 0
        reg = get_registry()
        rng = f"{self.lo}:{self.hi}"
        self._g_rows = reg.gauge("ps/vocab_rows", table=self.name, shard=rng)
        self._g_cap = reg.gauge("ps/vocab_capacity", table=self.name,
                                shard=rng)
        self._g_oldest = reg.gauge("ps/vocab_oldest_age_s", table=self.name,
                                   shard=rng)
        self._c_mat = reg.counter("ps/materialized_rows", table=self.name,
                                  shard=rng)
        self._c_evict = reg.counter("ps/evicted_rows", table=self.name,
                                    shard=rng)
        self._g_cap.set(float(self.capacity))
        self._g_rows.set(0.0)

    # ------------------------------------------------------------ internals
    def _init_rows_for(self, gids: np.ndarray) -> np.ndarray:
        rows = np.asarray(self._init_row_fn(np.asarray(gids, np.int64)),
                          dtype=np.uint16)
        if rows.shape != (np.asarray(gids).shape[0], self.lanes):
            raise ValueError(
                f"shard {self.name!r}: init_row_fn returned {rows.shape}, "
                f"expected ({np.asarray(gids).shape[0]}, {self.lanes})")
        return rows

    def _evict_one_locked(self, now: float) -> bool:
        """Evict the coldest unpinned resident; False when every resident
        is pinned. Caller holds the lock."""
        skipped = []
        evicted = False
        while len(self._lru):
            uid = self._lru.pop_coldest()
            if self._pins.get(uid):
                skipped.append(uid)  # pinned: re-insert, keep looking
                continue
            self._slots.pop(uid)
            self.evicted_total += 1
            self._c_evict.inc()
            evicted = True
            break
        # pinned uids go back at the COLD end in original order so their
        # relative recency is preserved once unpinned
        for i, uid in enumerate(reversed(skipped)):
            self._od_prepend(uid)
        return evicted

    def _od_prepend(self, uid: int) -> None:
        od = self._lru._od
        od[uid] = None
        od.move_to_end(uid, last=False)

    def _materialize_locked(self, gids: np.ndarray, now: float) -> np.ndarray:
        """Assign slots + write init rows for absent global ids (caller
        holds the lock). Returns the slot per id."""
        init = self._init_rows_for(gids)
        slots = np.empty(gids.shape[0], np.int64)
        for j, uid in enumerate(gids.tolist()):
            if not self._slots.free_slots and not self._evict_one_locked(now):
                raise RuntimeError(
                    f"shard {self.name!r}: slab full ({self.capacity} rows) "
                    "and every resident row is pinned — raise the capacity "
                    "or unpin before admitting new ids")
            s = self._slots.assign(uid)
            self.rows[s] = init[j]
            self._born[s] = now
            self._touched[s] = now
            self._lru.touch(uid)
            slots[j] = s
        self.materialized_total += gids.shape[0]
        self._c_mat.inc(gids.shape[0])
        return slots

    def _resolve_locked(self, gids: np.ndarray, now: float) -> np.ndarray:
        """Slot per global id, materializing the absent ones.

        The ids already resident are touched BEFORE the absent ones
        materialize: a materialization at capacity evicts from the cold
        end, and an id of this same batch must never be that victim (its
        slot would be handed to another id while this call reads or
        writes it). So a batch needs no more unpinned slots than it has
        distinct ids; each distinct absent id materializes once."""
        slots = self._slots.get_many(gids).astype(np.int64)
        missing = slots < 0
        present = ~missing
        if present.any():
            self._touched[slots[present]] = now
            for uid in gids[present].tolist():
                self._lru.touch(uid)
        if missing.any():
            uniq, inv = np.unique(gids[missing], return_inverse=True)
            if np.unique(gids).size > self.capacity:
                raise RuntimeError(
                    f"shard {self.name!r}: one call touches "
                    f"{np.unique(gids).size} distinct ids, more than the "
                    f"slab holds ({self.capacity} rows)")
            slots[missing] = self._materialize_locked(uniq, now)[inv]
        self._freq.observe(gids)
        self._g_rows.set(float(len(self._slots)))
        return slots

    # ------------------------------------------------------------- pull/push
    def pull(self, ids: np.ndarray) -> np.ndarray:
        gids = self._local(ids) + self.lo  # range-validate, keep global
        now = time.monotonic()
        with self._lock:
            slots = self._resolve_locked(gids, now)
            out = self.rows[slots]  # fancy index: already a copy
            self.bytes_pulled += out.nbytes
            self.n_pulls += 1
        return out

    def push(self, ids: np.ndarray, rows: np.ndarray) -> None:
        gids = self._local(ids) + self.lo
        rows = np.asarray(rows, dtype=np.uint16)
        if rows.shape != (gids.shape[0], self.lanes):
            raise ValueError(
                f"shard {self.name!r}: push rows shape {rows.shape} != "
                f"({gids.shape[0]}, {self.lanes})")
        now = time.monotonic()
        with self._lock:
            slots = self._resolve_locked(gids, now)
            self.rows[slots] = rows
            self.bytes_pushed += rows.nbytes
            self.n_pushes += 1

    # ---------------------------------------------------------------- pins
    def pin(self, ids: np.ndarray) -> None:
        """Protect global ids from eviction (in-flight async push / dirty
        hot-cache rows). Refcounted; pinning a non-resident id is legal
        (it guards the id through a future materialize)."""
        with self._lock:
            for uid in np.asarray(ids, np.int64).tolist():
                self._pins[uid] = self._pins.get(uid, 0) + 1

    def unpin(self, ids: np.ndarray) -> None:
        with self._lock:
            for uid in np.asarray(ids, np.int64).tolist():
                n = self._pins.get(uid, 0) - 1
                if n <= 0:
                    self._pins.pop(uid, None)
                else:
                    self._pins[uid] = n

    # --------------------------------------------------------------- sweep
    def sweep(self, now: Optional[float] = None) -> int:
        """One TTL/frequency eviction pass; returns rows evicted.

        Policy, under the mutation lock (never interleaves a push):

        1. TTL: every unpinned resident not touched within ``ttl_s`` is
           evicted (skipped when no TTL is configured);
        2. watermark: while occupancy exceeds ``high_watermark`` ×
           capacity, evict from the cold end down to ``low_watermark`` —
           except a cold row whose sketch frequency is still >=
           ``keep_freq`` gets ONE second chance (re-touched instead of
           evicted) per pass.
        """
        now = time.monotonic() if now is None else float(now)
        evicted = 0
        with self._lock:
            if self.ttl_s is not None:
                uids, slots = self._slots.residents()
                expired = uids[(now - self._touched[slots])
                               > self.ttl_s].tolist()
                for uid in expired:
                    if self._pins.get(uid):
                        continue
                    self._slots.pop(uid)
                    self._lru.discard(uid)
                    self.evicted_total += 1
                    evicted += 1
            target = int(self.low_watermark * self.capacity)
            spared: List[int] = []
            if len(self._slots) > int(self.high_watermark * self.capacity):
                while len(self._slots) > target and len(self._lru):
                    uid = self._lru.pop_coldest()
                    if self._pins.get(uid):
                        spared.append(uid)
                        continue
                    if (self.keep_freq > 0 and int(
                            self._freq.estimate(
                                np.asarray([uid]))[0]) >= self.keep_freq):
                        # still hot by frequency: one second chance
                        self._lru.touch(uid)
                        spared.append(-1)  # sentinel: progress guard below
                        if len(spared) >= len(self._slots):
                            break
                        continue
                    self._slots.pop(uid)
                    self.evicted_total += 1
                    evicted += 1
                for uid in reversed([u for u in spared if u >= 0]):
                    self._od_prepend(uid)
            if evicted:
                self._c_evict.inc(evicted)
            self._g_rows.set(float(len(self._slots)))
            if len(self._slots):
                _, slots = self._slots.residents()
                self._g_oldest.set(float(now - self._touched[slots].min()))
            else:
                self._g_oldest.set(0.0)
        return evicted

    # ------------------------------------------------------------ dump/load
    def dump(self) -> np.ndarray:
        """Dense ``[hi-lo, lanes]`` slice for the checkpoint path: init
        rows everywhere, live rows scattered on top. Guarded by
        ``PDTPU_PS_DYNAMIC_DUMP_MAX_MB`` (default 512) — a huge id space
        should checkpoint through ``Checkpointer.save_delta`` instead."""
        cap_mb = float(os.environ.get("PDTPU_PS_DYNAMIC_DUMP_MAX_MB", "512"))
        nbytes = (self.hi - self.lo) * self.lanes * 2
        if nbytes > cap_mb * (1 << 20):
            raise RuntimeError(
                f"shard {self.name!r}: dense dump of [{self.lo}, {self.hi}) "
                f"is {nbytes / (1 << 20):.0f} MB > "
                f"PDTPU_PS_DYNAMIC_DUMP_MAX_MB={cap_mb:.0f} — use "
                "Checkpointer.save_delta for dynamic tables this large")
        with self._lock:
            out = self._init_rows_for(
                np.arange(self.lo, self.hi, dtype=np.int64))
            uids, slots = self._slots.residents()
            if uids.size:
                out[uids - self.lo] = self.rows[slots]
            return out

    def load(self, rows: np.ndarray) -> None:
        """Replace the slice from a dense checkpoint: drop every resident
        row, then materialize exactly the rows that differ from their
        init row (bitwise-equal-to-init rows stay virtual — pulling them
        yields identical bytes either way, and slab occupancy stays
        proportional to genuinely-trained ids)."""
        rows = np.ascontiguousarray(rows, dtype=np.uint16)
        if rows.shape != (self.hi - self.lo, self.lanes):
            raise ValueError(
                f"shard {self.name!r}: load shape {rows.shape} != "
                f"({self.hi - self.lo}, {self.lanes})")
        gids = np.arange(self.lo, self.hi, dtype=np.int64)
        init = self._init_rows_for(gids)
        touched = np.flatnonzero((rows != init).any(axis=1))
        if touched.size > self.capacity:
            raise ValueError(
                f"shard {self.name!r}: checkpoint slice holds "
                f"{touched.size} non-init rows > capacity {self.capacity}")
        now = time.monotonic()
        with self._lock:
            self._slots.clear()
            self._lru.clear()
            self._touched.fill(0.0)
            self._born.fill(0.0)
            if touched.size:
                slots = self._materialize_locked(gids[touched], now)
                self.rows[slots] = rows[touched]
            self._g_rows.set(float(len(self._slots)))

    # --------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._lock:
            live = len(self._slots)
            oldest = 0.0
            if live:
                _, slots = self._slots.residents()
                oldest = float(time.monotonic() - self._touched[slots].min())
            return {"name": self.name, "lo": self.lo, "hi": self.hi,
                    "rows": self.hi - self.lo,
                    "bytes_pulled": self.bytes_pulled,
                    "bytes_pushed": self.bytes_pushed,
                    "n_pulls": self.n_pulls, "n_pushes": self.n_pushes,
                    "dynamic": True,
                    "live_rows": live, "capacity": self.capacity,
                    "materialized": self.materialized_total,
                    "evicted": self.evicted_total,
                    "pinned": len(self._pins),
                    "oldest_age_s": oldest,
                    "slab_bytes": int(self.rows.nbytes)}


def make_dynamic_shards(name: str, spec: RangeSpec, capacity_per_shard: int,
                        lanes: int = PACK_LANES,
                        **kw) -> List[DynamicEmbeddingShard]:
    """The dynamic analog of :func:`.shard.make_shards`: one slab-backed
    shard per range of `spec`, each provisioned `capacity_per_shard`
    resident rows. Extra kwargs flow to every shard (ttl_s, watermarks,
    init_row_fn, keep_freq)."""
    return [DynamicEmbeddingShard(name, *spec.bounds(i),
                                  capacity=capacity_per_shard, lanes=lanes,
                                  **kw)
            for i in range(spec.num_shards)]
