"""HotRowCache — device-resident hot rows between the tier and the shards
(the port's copy of ``paddle_tpu.ps.hot_cache``).

CTR id streams are heavily Zipfian — a small fraction of a 33.5M-row table
absorbs almost all touches — so the tier keeps those rows resident in
device memory and lets the PS shards hold only the cold tail.

Layout. The program's table param becomes one persistent
``[capacity + step_rows, lanes] uint16`` slab:

* rows ``[0, capacity)`` — the RESIDENT region, managed by LFU admission
  (``FreqSketch`` over the recent uid stream; one-touch ids never enter);
* rows ``[capacity, capacity + step_rows)`` — the STAGING tail, reused
  every step for bypass rows exactly like today's per-step pull cache.

Each step the tier remaps global ids to slab rows, scatters only the
*miss* rows in, runs the program unchanged (``uniq_merge``'s update math
depends on id equality structure, not id values, so an arbitrary
monotone->slab remap leaves every float op bit-identical), and pushes
back only what left the slab: eviction victims and staging rows. Hits
never cross device<->host — that is the entire win.

Plan/commit protocol (the concurrency contract). With a prefetching
loader (``pull_ahead >= 1``) batches are converted on a
worker thread while the main thread dispatches earlier ones, so cache
decisions are split:

* ``plan(uids)`` runs on the CONVERT thread: metadata only — classify
  hit/miss, admit or bypass each miss (evicting victims from the map),
  and hand back slab slots. No device work, no slab bytes move.
* the tier DISPATCHES plans in order on the main thread: write back the
  plan's victims, scatter its pulled miss rows, run, then ``commit``.

Two rules make a concurrent ``flush()`` (checkpoint save) exact between
a plan and its dispatch:

* dirty bits are set at COMMIT, not at plan time — a flush between plan
  and dispatch must push the row's *current* slab bytes, not assume the
  not-yet-run update already happened;
* a victim's bytes stay in its old slot until the admitting plan's
  dispatch scatters over it, so planned-but-uncommitted evictions are
  carried in a pending list that ``flush_rows`` also drains, and slots
  referenced by any in-flight plan are never chosen as victims
  (``_inflight`` refcounts).

Write-backs ride the tier's ``_Pusher`` and therefore the push journal:
they are ordinary pushes to every reader of the shards.

Device ops (gather for write-back, scatter for admission) go through the
row kernels of ``ops.kernels.sparse_adagrad`` (rows 13 and 14): on a CUDA
slab the kernels, on a CPU slab their plain versions; with
``PDTPU_FUSED_SPARSE=0`` the plain versions everywhere. All index vectors
are padded to power-of-two buckets by repeating their last element —
identical-value duplicate writes keep the scatter deterministic. The slab
is one torch tensor that the program updates in place; the rows handed to
the pusher are always gathered copies, never the slab itself.

Metrics (process-wide, unlabeled so multiple tables sum):
``ps/cache_hits|misses|admitted|evictions|bypass|writeback_bytes``
counters and ``ps/cache_resident_rows|dirty_rows|capacity`` gauges —
surfaced by ``tools/ps_admin stats``/``dump-health`` and the bench.
``hits``/``misses`` count UNIQUE rows per step (the tier dedups before
planning — that is the unit of pull/push traffic); the
``lookup_hits``/``lookup_misses`` pair weights each uid by its raw
occurrence count, i.e. the fraction of embedding LOOKUPS served from
resident device rows — the number the Zipfian bench claim is stated in.
"""
from __future__ import annotations

import os
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..observability import get_registry
from .slab import FreqSketch, SlotMap

__all__ = ["HotRowCache", "CachePlan"]


def _bucket(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(0, int(n) - 1).bit_length()


class CachePlan:
    """One step's cache decisions (metadata only; made on the convert
    thread, applied in order on the dispatch thread).

    ``slots[j]`` is the slab row of ``uids[j]``: resident ``[0, capacity)``
    for hits and admitted misses, staging tail for bypass misses.
    ``miss_*`` aligns with the pulled miss buffer (ascending uids, row i
    of the pull lands in ``miss_slots[i]``); ``evict_*`` are this plan's
    victims, uid-ascending for the push contract.
    """
    __slots__ = ("uids", "slots", "miss_uids", "miss_slots",
                 "bypass_uids", "bypass_slots", "evict_uids", "evict_slots",
                 "n_hit", "n_admit", "touched_resident")

    def __init__(self, uids, slots, miss_uids, miss_slots, bypass_uids,
                 bypass_slots, evict_uids, evict_slots, n_hit, n_admit,
                 touched_resident):
        self.uids = uids
        self.slots = slots
        self.miss_uids = miss_uids
        self.miss_slots = miss_slots
        self.bypass_uids = bypass_uids
        self.bypass_slots = bypass_slots
        self.evict_uids = evict_uids
        self.evict_slots = evict_slots
        self.n_hit = n_hit
        self.n_admit = n_admit
        self.touched_resident = touched_resident


class HotRowCache:
    """LFU-admitted, write-back, device-resident row cache for one table.

    ``capacity`` resident rows + ``step_rows`` staging rows; the program's
    cache param must be ``[capacity + step_rows, lanes]``. ``vocab`` sizes
    the dense uid->slot index (4 bytes/row host-side). Admission needs an
    estimated frequency >= ``min_freq`` (``PDTPU_PS_ADMIT_MIN_FREQ``,
    default 2 — one-touch ids bypass) and, when full, strictly above the
    sampled-LFU victim's estimate.
    """

    def __init__(self, capacity: int, step_rows: int, lanes: int = 128, *,
                 vocab: int, name: str = "", min_freq: Optional[int] = None,
                 sample: int = 16, seed: int = 0, device="cpu"):
        if capacity < 1 or step_rows < 1:
            raise ValueError(
                f"HotRowCache: capacity={capacity}/step_rows={step_rows} "
                "must both be >= 1")
        self.capacity = int(capacity)
        self.step_rows = int(step_rows)
        self.lanes = int(lanes)
        self.name = str(name)
        if min_freq is None:
            min_freq = int(os.environ.get("PDTPU_PS_ADMIT_MIN_FREQ", "2"))
        self.min_freq = max(1, int(min_freq))
        self.sample = max(1, int(sample))
        self._slots = SlotMap(self.capacity, vocab=int(vocab))
        self._sketch = FreqSketch(seed=0x9E3779B9 + seed)
        self._dirty = np.zeros(self.capacity, bool)
        self._inflight = np.zeros(self.capacity, np.int32)
        self._uncommitted: List[CachePlan] = []
        self._lock = threading.Lock()
        self._rng = np.random.RandomState(0x5EED + seed)
        self.device = torch.device(device)
        self.slab = None          # device [capacity+step_rows, lanes] u16
        # local mirrors for per-table stats(); registry gets the same
        # increments process-wide
        self.hits = self.misses = self.admitted = 0
        self.evictions = self.bypass = self.writeback_bytes = 0
        self.lookup_hits = self.lookup_misses = 0
        reg = get_registry()
        self._c_hits = reg.counter("ps/cache_hits")
        self._c_misses = reg.counter("ps/cache_misses")
        self._c_lhits = reg.counter("ps/cache_lookup_hits")
        self._c_lmisses = reg.counter("ps/cache_lookup_misses")
        self._c_admitted = reg.counter("ps/cache_admitted")
        self._c_evictions = reg.counter("ps/cache_evictions")
        self._c_bypass = reg.counter("ps/cache_bypass")
        self._c_wb = reg.counter("ps/cache_writeback_bytes")
        self._g_resident = reg.gauge("ps/cache_resident_rows")
        self._g_dirty = reg.gauge("ps/cache_dirty_rows")
        reg.gauge("ps/cache_capacity").add(float(self.capacity))
        self._last_resident = 0
        self._last_dirty = 0

    # ------------------------------------------------------------- planning
    def plan(self, uids: np.ndarray,
             counts: Optional[np.ndarray] = None) -> CachePlan:
        """Classify one step's ascending unique `uids`; returns the plan.
        Mutates only host metadata (map/sketch/inflight/pending).
        `counts` (optional, aligned with `uids`) are raw occurrence
        counts — they feed the lookup-weighted hit metrics only, never
        the admission decisions."""
        uids = np.asarray(uids, np.int64)
        with self._lock:
            self._sketch.observe(uids)
            slots = self._slots.get_many(uids)
            hit = slots >= 0
            n_hit = int(hit.sum())
            if counts is None:
                l_hit, l_miss = n_hit, int(uids.size) - n_hit
            else:
                counts = np.asarray(counts, np.int64)
                l_hit = int(counts[hit].sum())
                l_miss = int(counts.sum()) - l_hit
            miss_idx = np.flatnonzero(~hit)
            n_miss = int(miss_idx.size)
            if n_miss > self.step_rows:
                raise ValueError(
                    f"batch touches {n_miss} non-resident rows of table "
                    f"{self.name!r} but the slab has only {self.step_rows} "
                    "staging rows; rebuild the program with a larger "
                    "[hot_rows + per-step rows] cache param")
            # slots THIS plan touches: never valid eviction victims
            # (evicting a row the same step reads/updates it would hand
            # one slab row to two uids at dispatch time)
            mine = set(slots[hit].tolist())
            est = (self._sketch.estimate(uids[miss_idx]) if n_miss
                   else np.zeros(0, np.uint32))
            evict_uids: List[int] = []
            evict_slots: List[int] = []
            n_stage = 0
            n_admit = 0
            for k in range(n_miss):
                j = int(miss_idx[k])
                f = int(est[k])
                s = -1
                if f >= self.min_freq:
                    if self._slots.free_slots:
                        s = self._slots.assign(int(uids[j]))
                    else:
                        victim = self._pick_victim(mine, f)
                        if victim is not None:
                            vu, vs = victim
                            self._slots.pop(vu)
                            # the victim's post-eviction truth is whatever
                            # the slab holds when the admitting dispatch
                            # writes it back; its dirty bit is retired
                            # here so flush_rows reports it exactly once
                            # (via the pending-evict list, below)
                            self._dirty[vs] = False
                            evict_uids.append(vu)
                            evict_slots.append(vs)
                            s = self._slots.assign(int(uids[j]))  # reuses vs
                if s >= 0:
                    n_admit += 1
                    mine.add(s)
                else:
                    s = self.capacity + n_stage
                    n_stage += 1
                slots[j] = s
            resident = slots[slots < self.capacity].astype(np.int64)
            np.add.at(self._inflight, resident, 1)
            miss_uids = uids[miss_idx]
            miss_slots = slots[miss_idx].astype(np.int32)
            byp = miss_slots >= self.capacity
            ev_u = np.asarray(evict_uids, np.int64)
            ev_s = np.asarray(evict_slots, np.int32)
            order = np.argsort(ev_u, kind="stable")
            plan = CachePlan(
                uids=uids, slots=slots.astype(np.int32),
                miss_uids=miss_uids, miss_slots=miss_slots,
                bypass_uids=miss_uids[byp], bypass_slots=miss_slots[byp],
                evict_uids=ev_u[order], evict_slots=ev_s[order],
                n_hit=n_hit, n_admit=n_admit,
                touched_resident=resident.astype(np.int32))
            self._uncommitted.append(plan)
            self.hits += n_hit
            self.misses += n_miss
            self.lookup_hits += l_hit
            self.lookup_misses += l_miss
            self.admitted += n_admit
            self.evictions += len(evict_uids)
            self.bypass += n_stage
            self._c_hits.inc(n_hit)
            self._c_misses.inc(n_miss)
            self._c_lhits.inc(l_hit)
            self._c_lmisses.inc(l_miss)
            self._c_admitted.inc(n_admit)
            self._c_evictions.inc(len(evict_uids))
            self._c_bypass.inc(n_stage)
            self._publish_gauges()
        return plan

    def _pick_victim(self, exclude, cand_freq: int
                     ) -> Optional[Tuple[int, int]]:
        """Sampled LFU: random resident slots, skipping any slot an
        in-flight plan references; evict the lowest-estimate one iff the
        candidate is strictly hotter (ties keep the incumbent — churn
        without evidence costs two row moves for nothing)."""
        cand_slots = []
        for s in self._rng.randint(0, self.capacity,
                                   size=4 * self.sample).tolist():
            if self._inflight[s] or s in exclude:
                continue
            if self._slots.uid_of(s) is None:
                continue
            cand_slots.append(s)
            if len(cand_slots) >= self.sample:
                break
        if not cand_slots:
            return None
        cand_slots = np.asarray(cand_slots, np.int64)
        cand_uids = self._slots.uids_at(cand_slots)
        ests = self._sketch.estimate(cand_uids)
        k = int(np.argmin(ests))
        if int(ests[k]) >= cand_freq:
            return None
        return int(cand_uids[k]), int(cand_slots[k])

    # ------------------------------------------------------------- dispatch
    def commit(self, plan: CachePlan) -> None:
        """Retire a dispatched plan: its resident rows now hold post-step
        bytes (dirty), its slots are no longer pinned, its evictions have
        been written back."""
        with self._lock:
            np.add.at(self._inflight, plan.touched_resident.astype(np.int64),
                      -1)
            self._dirty[plan.touched_resident] = True
            self._uncommitted.remove(plan)
            self._publish_gauges()

    def note_writeback(self, n_rows: int) -> None:
        nb = int(n_rows) * self.lanes * 2
        self.writeback_bytes += nb
        self._c_wb.inc(nb)

    def flush_rows(self) -> Tuple[np.ndarray, np.ndarray]:
        """(uids, slots), uid-ascending, of every row whose newest bytes
        exist only in the slab: dirty residents plus planned-but-not-yet-
        dispatched eviction victims (their bytes still sit in their old
        slots). Clears the dirty bits — the caller gathers and pushes."""
        with self._lock:
            ds = np.flatnonzero(self._dirty)
            du = self._slots.uids_at(ds)
            extra_u: List[int] = []
            extra_s: List[int] = []
            for p in self._uncommitted:
                extra_u.extend(p.evict_uids.tolist())
                extra_s.extend(p.evict_slots.tolist())
            self._dirty[:] = False
            self._publish_gauges()
        u = np.concatenate([du, np.asarray(extra_u, np.int64)])
        s = np.concatenate([ds.astype(np.int32),
                            np.asarray(extra_s, np.int32)])
        order = np.argsort(u, kind="stable")
        return u[order], s[order]

    def drop_rows(self, uids: np.ndarray) -> int:
        """Delta-subscriber invalidation: another writer published fresher
        PS bytes for `uids`, so drop their CLEAN, not-in-flight resident
        entries — the next touch misses and re-pulls the new bytes. A
        dirty row holds a local update the shards haven't seen (dropping
        it would lose the write) and an in-flight row is referenced by a
        planned-but-undispatched step, so both are kept; so is a pending
        eviction victim (its write-back is already scheduled). Returns
        #dropped."""
        n = 0
        with self._lock:
            pending = set()
            for p in self._uncommitted:
                pending.update(p.evict_uids.tolist())
            for u in np.asarray(uids, np.int64).tolist():
                if u in pending:
                    continue
                s = self._slots.get(u)
                if (s is not None and not self._dirty[s]
                        and not self._inflight[s]):
                    self._slots.pop(u)
                    n += 1
            self._publish_gauges()
        return n

    def _publish_gauges(self) -> None:
        res, dirt = len(self._slots), int(self._dirty.sum())
        self._g_resident.add(float(res - self._last_resident))
        self._g_dirty.add(float(dirt - self._last_dirty))
        self._last_resident, self._last_dirty = res, dirt

    # ----------------------------------------------------------- device ops
    def ensure_slab(self):
        if self.slab is None:
            self.slab = torch.zeros(
                (self.capacity + self.step_rows, self.lanes),
                dtype=torch.int16, device=self.device).view(torch.uint16)
        return self.slab

    def _bind_ops(self):
        """(gather, scatter): rows 13–14, or their plain versions where
        ``PDTPU_FUSED_SPARSE=0`` asks for them (read per call)."""
        from ..ops.kernels import sparse_adagrad as fsa

        if fsa.rows_enabled(self.lanes):
            return fsa.fused_row_gather, fsa.fused_row_scatter
        return fsa.fused_row_gather_plain, fsa.fused_row_scatter_plain

    def _index(self, idx: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(idx.astype(np.int64)).to(self.device)

    def take_rows(self, slots: np.ndarray) -> torch.Tensor:
        """Gather ``slab[slots]`` -> device ``[bucket(n), lanes]`` (a copy);
        pad rows repeat the last slot (the pusher slices ``[:n]``)."""
        gather, _ = self._bind_ops()
        idx = np.asarray(slots, np.int64)
        n = int(idx.shape[0])
        pad = _bucket(n) - n
        if pad:
            idx = np.concatenate([idx, np.full(pad, idx[-1], np.int64)])
        return gather(self.ensure_slab(), self._index(idx))

    def insert_rows(self, tgt_slots: np.ndarray, rows) -> None:
        """Scatter ``rows[:n]`` into ``slab[tgt_slots]`` in place (n =
        len(tgt)); index vectors pad to a power-of-two bucket by repeating
        the last (tgt, src) pair — identical-value rewrites,
        deterministic."""
        _, scatter = self._bind_ops()
        tgt = np.asarray(tgt_slots, np.int64)
        n = int(tgt.shape[0])
        src = np.arange(n, dtype=np.int64)
        pad = _bucket(n) - n
        if pad:
            tgt = np.concatenate([tgt, np.full(pad, tgt[-1], np.int64)])
            src = np.concatenate([src, np.full(pad, src[-1], np.int64)])
        scatter(self.ensure_slab(), self._index(tgt), rows, self._index(src))

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            ltotal = self.lookup_hits + self.lookup_misses
            return {
                "capacity": self.capacity, "step_rows": self.step_rows,
                "resident": len(self._slots),
                "dirty": int(self._dirty.sum()),
                "hits": self.hits, "misses": self.misses,
                "hit_rate": (self.hits / total) if total else None,
                "lookup_hits": self.lookup_hits,
                "lookup_misses": self.lookup_misses,
                "lookup_hit_rate": ((self.lookup_hits / ltotal)
                                    if ltotal else None),
                "admitted": self.admitted, "evictions": self.evictions,
                "bypass": self.bypass,
                "writeback_bytes": self.writeback_bytes,
            }
