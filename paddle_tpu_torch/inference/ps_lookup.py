"""PS-backed CTR inference: serve a big-table model from small replicas
(counterpart of ``paddle_tpu.inference.ps_lookup``).

The trained CTR model's embedding table ([vocab, 128] packed uint16 rows,
33.5M rows at production vocab = ~8.6 GB) lives on the parameter-server
tier (paddle_tpu.ps). Loading it into every inference replica would cap
the fleet size at table-bytes-per-host; instead each replica holds a
**cache-sized** table param (`cache_rows` x 128 uint16) plus an LRU row
cache, and pulls only the rows each request actually touches from the
live `ShardedTable`.

Bitwise identity with the local-table Predictor is by construction, not
luck: the `lookup_table` op with `row_pack_dt` is a per-row gather
followed by a bit-exact unpack (`take_rows` + `unpack_rows`), so remapping
global ids to cache-local positions and gathering from a small table
holding the *same row bytes* produces the same output bits. Per request:

1. concatenate the binding's id feeds, `np.unique(return_inverse=True)`
   → sorted unique global ids + the inverse map,
2. serve hits from the replica's LRU `RowCache`, pull misses from the
   `ShardedTable` (the unique-id list is ascending — the table's pull
   contract — and the miss subset of a sorted list stays sorted),
3. assemble the fixed-shape `[cache_rows, 128]` cache param on the host
   and upload it to the predictor's device (constant shape: the served
   signatures stay exactly the bucketed set),
4. rewrite the id feeds to cache-local positions and run the base
   Predictor with the cache param swapped into its state.

Read-only by design: serving never pushes. Staleness is whatever the row
cache holds — `invalidate()` drops it (e.g. after the training side
publishes a new checkpoint).
"""
from __future__ import annotations

import collections
import os
import threading
import time

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.dtypes import dtype_str, from_numpy
from ..ps.slab import LruOrder, SlotMap

__all__ = ["PsLookupBinding", "PsLookupPredictor", "RowCache"]


class RowCache:
    """LRU cache of packed embedding rows (global id → `[lanes]` uint16).

    Slab storage: one preallocated `[capacity, lanes]` array plus the
    shared `ps.slab.SlotMap`/`LruOrder` bookkeeping (the training-side
    `ps.hot_cache.HotRowCache` sits on the same core — the policies
    differ, the uid→slot mechanics don't), so memory is bounded and
    visible (`nbytes`) — the number the replica-footprint assertion in
    the fleet tests keys on.
    """

    def __init__(self, capacity: int, lanes: int, dtype=np.uint16):
        if capacity < 1:
            raise ValueError("RowCache capacity must be >= 1")
        self.capacity = int(capacity)
        self.lanes = int(lanes)
        # uint16 for packed-f32 wire rows; int8 when the resident
        # predictor is quantized and rows are stored post-requantization
        self._store = np.zeros((self.capacity, self.lanes), dtype)
        self._slots = SlotMap(self.capacity)
        self._lru = LruOrder()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._slots)

    @property
    def nbytes(self) -> int:
        return self._store.nbytes

    @property
    def dtype(self):
        return self._store.dtype

    def lookup(self, uids: np.ndarray):
        """rows `[k, lanes]` (hit rows filled) + boolean miss mask."""
        k = len(uids)
        rows = np.zeros((k, self.lanes), self._store.dtype)
        miss = np.zeros(k, bool)
        for j, u in enumerate(np.asarray(uids).tolist()):
            s = self._slots.get(u)
            if s is None:
                miss[j] = True
            else:
                rows[j] = self._store[s]
                self._lru.touch(u)
        nm = int(miss.sum())
        self.misses += nm
        self.hits += k - nm
        return rows, miss

    def insert(self, uids: np.ndarray, rows: np.ndarray) -> None:
        for j, u in enumerate(np.asarray(uids).tolist()):
            s = self._slots.get(u)
            if s is None:
                if not self._slots.free_slots:
                    self._slots.pop(self._lru.pop_coldest())
                    self.evictions += 1
                s = self._slots.assign(u)  # LIFO: reuses the victim's slot
            self._store[s] = rows[j]
            self._lru.touch(u)

    def update(self, uids: np.ndarray, rows: np.ndarray) -> int:
        """Refresh rows already resident (delta-push path): a uid the
        cache doesn't hold is skipped — never inserted — so a publisher
        streaming the whole training working set can't evict the rows
        this replica's requests actually touch. Returns #refreshed."""
        n = 0
        for j, u in enumerate(np.asarray(uids).tolist()):
            s = self._slots.get(u)
            if s is not None:
                self._store[s] = rows[j]
                n += 1
        return n

    def clear(self) -> None:
        self._slots.clear()
        self._lru.clear()

    def stats(self) -> dict:
        return {"rows": len(self._slots), "capacity": self.capacity,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "bytes": self.nbytes}


class PsLookupBinding:
    """One PS-resident table in the serving program: the (cache-sized)
    param it binds to, the ShardedTable (or any object with
    ``pull(sorted_uids) -> [k, lanes] uint16``), and the feeds carrying
    its global row ids."""

    def __init__(self, param: str, table, id_feeds: Sequence[str]):
        if not id_feeds:
            raise ValueError(f"binding for {param!r}: no id feeds")
        self.param = param
        self.table = table
        self.id_feeds = list(id_feeds)


class PsLookupPredictor:
    """Read-only Predictor wrapper that resolves embedding rows through
    the PS tier (module docstring has the contract). The wrapped
    predictor's table params must be cache-sized (`[cache_rows, lanes]`)
    — save the serving model with a small table; this class fills it per
    request. Drop-in for `serving.InferenceServer` (run / run_padded /
    clone / the warmup surface)."""

    def __init__(self, predictor, bindings: Sequence[PsLookupBinding],
                 cache_rows_per_table: Optional[int] = None):
        self._pred = predictor
        # private state *mapping* (the arrays stay shared): per-request
        # cache-param swaps must never leak into sibling clones mid-flight
        self._pred._state = dict(self._pred._state)
        self._bindings = list(bindings)
        self._lock = threading.RLock()
        if cache_rows_per_table is None:
            cache_rows_per_table = int(
                os.environ.get("PDTPU_PS_SERVE_CACHE_ROWS", "65536"))
        self._shapes: Dict[str, tuple] = {}
        self._caches: Dict[str, RowCache] = {}
        # staleness auditor: recent train→serve e2e samples (ms)
        self._e2e_samples: "collections.deque" = collections.deque(
            maxlen=4096)
        # quantized resident tables: binding param → {"param": renamed
        # int8 state param, "scale": per-table abs-max, "dt": f32 row dim}
        self._quant: Dict[str, dict] = {}
        qmeta = getattr(predictor, "quant_meta", None) or {}
        qtables = qmeta.get("tables") or {}
        for b in self._bindings:
            qt = qtables.get(b.param)
            if qt is not None and qt.get("packed"):
                # int8_quantize_pass renamed the param and dequantizes at
                # gather time; the row cache stores int8 rows requantized
                # from the PS tier's packed-u16 wire format
                qp = qt["param"]
                st = self._pred._state.get(qp)
                if st is None or st.ndim != 2 or dtype_str(st.dtype) != "int8":
                    raise ValueError(
                        f"PsLookupPredictor: quantized param {qp!r} (for "
                        f"binding {b.param!r}) missing or not an int8 "
                        f"[cache_rows, dim] table")
                self._quant[b.param] = {"param": qp,
                                        "scale": float(qt["scale"]),
                                        "dt": int(st.shape[1])}
                self._shapes[b.param] = tuple(int(d) for d in st.shape)
                self._caches[b.param] = RowCache(
                    max(cache_rows_per_table, st.shape[0]),
                    int(st.shape[1]), dtype=np.int8)
                continue
            st = self._pred._state.get(b.param)
            if st is None:
                raise ValueError(
                    f"PsLookupPredictor: param {b.param!r} not in the "
                    f"predictor's state; persistable vars: "
                    f"{sorted(self._pred._state)}")
            if st.ndim != 2 or dtype_str(st.dtype) != "uint16":
                raise ValueError(
                    f"PsLookupPredictor: param {b.param!r} is "
                    f"{st.shape}/{st.dtype}, expected a packed "
                    f"[cache_rows, lanes] uint16 table")
            self._shapes[b.param] = tuple(int(d) for d in st.shape)
            self._caches[b.param] = RowCache(
                max(cache_rows_per_table, st.shape[0]), int(st.shape[1]))

    # -- serving surface (what InferenceServer/warmup/batcher touch) -------
    @property
    def _program(self):
        return self._pred._program

    @property
    def _cache(self):
        return self._pred._cache

    @property
    def _device(self):
        return self._pred._device

    @property
    def _feed_names(self):
        return self._pred._feed_names

    @property
    def _fetch_names(self):
        return self._pred._fetch_names

    def get_input_names(self) -> List[str]:
        return self._pred.get_input_names()

    def get_output_names(self) -> List[str]:
        return self._pred.get_output_names()

    def clone(self) -> "PsLookupPredictor":
        """Clone for a sibling serve worker: shares program + dense
        weights (zero-copy) and the ShardedTable connections, but gets
        its own row cache (caches are per-worker working sets)."""
        return PsLookupPredictor(
            self._pred.clone(), self._bindings,
            cache_rows_per_table=next(iter(self._caches.values())).capacity)

    # -- the lookup path ----------------------------------------------------
    def _localize(self, feed: Dict[str, np.ndarray]):
        feed2 = {k: np.asarray(v) for k, v in feed.items()}
        overrides: Dict[str, np.ndarray] = {}
        for b in self._bindings:
            cache_rows, lanes = self._shapes[b.param]
            parts = []
            for n in b.id_feeds:
                if n not in feed2:
                    raise ValueError(
                        f"PsLookupPredictor: id feed {n!r} (binding "
                        f"{b.param!r}) missing from the request")
                parts.append(feed2[n].reshape(-1).astype(np.int64))
            flat = np.concatenate(parts)
            uids, inverse = np.unique(flat, return_inverse=True)
            if uids.size > cache_rows:
                raise ValueError(
                    f"PsLookupPredictor: request touches {uids.size} "
                    f"distinct rows of {b.param!r} but the cache param "
                    f"holds {cache_rows}; resave the serving model with "
                    f"a larger cache table")
            cache = self._caches[b.param]
            q = self._quant.get(b.param)
            rows, miss = cache.lookup(uids)
            if miss.any():
                pulled = np.asarray(b.table.pull(uids[miss]))
                if q is not None:
                    # wire format is packed u16; the int8 cache/param
                    # want rows requantized at the table's stored scale
                    from .quant import requantize_packed_rows
                    pulled = requantize_packed_rows(
                        np.asarray(pulled, np.uint16), q["dt"], q["scale"])
                rows[miss] = pulled
                cache.insert(uids[miss], pulled)
            arr = np.zeros((cache_rows, lanes), cache.dtype)
            arr[:uids.size] = rows
            overrides[b.param if q is None else q["param"]] = arr
            off = 0
            for n in b.id_feeds:
                a = feed2[n]
                feed2[n] = (inverse[off:off + a.size]
                            .reshape(a.shape).astype(a.dtype))
                off += a.size
        return feed2, overrides

    def _apply(self, overrides: Dict[str, np.ndarray]) -> None:
        """Upload each assembled cache table to the predictor's device."""
        for p, arr in overrides.items():
            self._pred._state[p] = from_numpy(arr, device=self._pred._device)

    def run(self, feed: Dict[str, np.ndarray]) -> List[np.ndarray]:
        with self._lock:
            feed2, overrides = self._localize(feed)
            self._apply(overrides)
            return self._pred.run(feed2)

    def run_padded(self, feed: Dict[str, np.ndarray],
                   batch_size: int) -> List[np.ndarray]:
        # localize BEFORE padding: edge padding then replicates the last
        # row's cache-local ids, which are valid positions by construction
        with self._lock:
            feed2, overrides = self._localize(feed)
            self._apply(overrides)
            return self._pred.run_padded(feed2, batch_size)

    def apply_delta(self, table_name: str, uids: np.ndarray,
                    rows: np.ndarray, meta: Optional[dict] = None) -> int:
        """Online-learning delta push: overwrite the cached copies of
        `uids` with freshly-trained `rows` for every binding backed by
        `table_name`. Resident rows are refreshed in place; absent rows
        are left to fault in on the next request (the table already holds
        the new bytes, so the pull is coherent). Returns #rows refreshed
        — the staleness window for a cached row is the publisher's flush
        cadence, not checkpoint cadence.

        Quantized residents: pushed rows arrive in the trainer's packed
        u16 wire format regardless of serving precision, so they are
        re-quantized here with the table's stored scale before touching
        the int8 cache — raw u16 bytes must never land in an int8
        table.

        Staleness auditor (`meta` — what a meta-aware `DeltaPublisher`
        subscription passes): ``meta["enqueue_t"]`` carries each row's
        trainer-side push time, so this end of the pipe can record the
        TRUE train→serve latency — push to visible-in-serving-cache —
        into ``staleness/e2e_ms{table=}``, and stamp the freshness clock
        ``staleness/last_visible_ts{table=}`` (unix time) whose *age* is
        what the ``DeltaStaleness`` SLO alerts on: when delta flow
        stalls, no histogram samples arrive at all, but the clock keeps
        aging."""
        uids = np.asarray(uids, np.int64)
        rows = np.asarray(rows, np.uint16)
        n = 0
        with self._lock:
            for b in self._bindings:
                if getattr(b.table, "name", None) != table_name:
                    continue
                q = self._quant.get(b.param)
                if q is not None:
                    from .quant import requantize_packed_rows
                    r = requantize_packed_rows(rows, q["dt"], q["scale"])
                else:
                    r = rows
                n += self._caches[b.param].update(uids, r)
        if meta is not None:
            self._audit_visibility(table_name, meta)
        return n

    def _audit_visibility(self, table_name: str, meta: dict) -> None:
        """Record the serving end of the staleness audit for one delta
        batch (outside the serve lock — observability must not extend
        the request critical section)."""
        from ..observability import get_registry
        now = time.monotonic()
        reg = get_registry()
        enq = np.asarray(meta.get("enqueue_t", ()), np.float64)
        if enq.size:
            e2e_ms = (now - enq) * 1e3
            h = reg.histogram("staleness/e2e_ms", table=table_name)
            for v in e2e_ms.tolist():
                h.observe(v)
            self._e2e_samples.extend(e2e_ms.tolist())
        reg.gauge("staleness/last_visible_ts", table=table_name).set(
            time.time())

    def staleness_e2e_percentiles(self) -> dict:
        """{p50, p99, max} over recent end-to-end staleness samples (ms,
        trainer push → visible in this replica's cache); all-None until
        a meta-aware publisher subscription delivers a batch."""
        s = list(self._e2e_samples)
        if not s:
            return {"p50": None, "p99": None, "max": None}
        arr = np.asarray(s, np.float64)
        return {"p50": float(np.percentile(arr, 50)),
                "p99": float(np.percentile(arr, 99)),
                "max": float(arr.max())}

    # -- introspection -------------------------------------------------------
    def invalidate(self) -> None:
        """Drop every cached row (next requests re-pull — call after the
        training side publishes fresher table bytes)."""
        with self._lock:
            for c in self._caches.values():
                c.clear()

    def resident_table_bytes(self) -> int:
        """Bytes of table data this replica actually holds: the
        cache-sized device param(s) + the host LRU slab. The fleet test
        asserts this is a small fraction of the full table."""
        dev = sum(rows * lanes * (1 if p in self._quant else 2)
                  for p, (rows, lanes) in self._shapes.items())
        return dev + sum(c.nbytes for c in self._caches.values())

    def stats(self) -> dict:
        return {p: c.stats() for p, c in self._caches.items()}
