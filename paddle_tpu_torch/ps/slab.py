"""Shared slab bookkeeping for packed-row caches.

The port's copy of ``paddle_tpu.ps.slab``. Caches that pin packed
``[*, lanes] uint16`` rows into a fixed-capacity slab need the same
uid->slot accounting underneath: the training side's
``ps.hot_cache.HotRowCache`` (device-resident LFU with write-back) and,
once ported, the serving side's host LRU. This module is that common core —
numpy-only and policy-free: eviction *choice* stays with the caller, the classes here
only answer "where does this uid live", "who was touched least recently",
and "how often has this uid been seen lately".

* :class:`SlotMap` — uid -> slot over a fixed pool, with a free list and
  a reverse slot -> uid view. Backed by a dict, or by a dense int32
  array when the id universe (``vocab``) is known — the dense form makes
  ``get_many`` a single vectorized gather, which is what keeps the hot
  cache's per-step planning off the training critical path.
* :class:`LruOrder` — recency list (the serving cache's eviction policy).
* :class:`FreqSketch` — Count-Min sketch with periodic counter halving
  (TinyLFU-style aging); the hot cache's admission filter. Approximate by
  design: collisions only ever OVER-estimate a frequency, so a sketch
  decision can admit a cold row early but never silently starve a hot
  one, and no correctness property anywhere rests on its answers.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

__all__ = ["SlotMap", "LruOrder", "FreqSketch"]


class SlotMap:
    """uid -> slot bookkeeping over ``capacity`` fixed slots.

    Slots are recycled LIFO: ``pop`` returns a slot to the free list and
    the next ``assign`` hands that same slot back — callers that evict
    then admit in one breath reuse the victim's slot, which is what both
    caches' slab-storage invariants assume.
    """

    def __init__(self, capacity: int, vocab: Optional[int] = None):
        if capacity < 1:
            raise ValueError("SlotMap capacity must be >= 1")
        self.capacity = int(capacity)
        self.vocab = None if vocab is None else int(vocab)
        self._free = list(range(self.capacity - 1, -1, -1))
        self._uid_of = np.full(self.capacity, -1, np.int64)
        if self.vocab is None:
            self._dense = None
            self._slot: Optional[dict] = {}
        else:
            self._dense = np.full(self.vocab, -1, np.int32)
            self._slot = None

    def __len__(self) -> int:
        return self.capacity - len(self._free)

    def __contains__(self, uid: int) -> bool:
        return self.get(int(uid)) is not None

    @property
    def free_slots(self) -> int:
        return len(self._free)

    def get(self, uid: int) -> Optional[int]:
        if self._dense is not None:
            s = int(self._dense[uid])
            return None if s < 0 else s
        return self._slot.get(uid)

    def get_many(self, uids: np.ndarray) -> np.ndarray:
        """Slot per uid, -1 where absent — vectorized in dense mode."""
        uids = np.asarray(uids, np.int64)
        if self._dense is not None:
            return self._dense[uids].astype(np.int32, copy=True)
        out = np.empty(uids.shape[0], np.int32)
        get = self._slot.get
        for j, u in enumerate(uids.tolist()):
            out[j] = get(u, -1)
        return out

    def assign(self, uid: int) -> int:
        """Bind `uid` to a free slot; the caller evicts first when full."""
        if not self._free:
            raise RuntimeError("SlotMap is full — pop a resident uid first")
        s = self._free.pop()
        self._uid_of[s] = uid
        if self._dense is not None:
            self._dense[uid] = s
        else:
            self._slot[uid] = s
        return s

    def pop(self, uid: int) -> int:
        """Unbind `uid`, returning its (now free) slot."""
        if self._dense is not None:
            s = int(self._dense[uid])
            if s < 0:
                raise KeyError(uid)
            self._dense[uid] = -1
        else:
            s = self._slot.pop(uid)
        self._uid_of[s] = -1
        self._free.append(s)
        return s

    def uid_of(self, slot: int) -> Optional[int]:
        u = int(self._uid_of[slot])
        return None if u < 0 else u

    def uids_at(self, slots: np.ndarray) -> np.ndarray:
        """Vectorized reverse lookup (every slot must be occupied)."""
        return self._uid_of[np.asarray(slots, np.int64)].copy()

    def residents(self) -> Tuple[np.ndarray, np.ndarray]:
        """(uids, slots) of every occupied slot, in slot order."""
        occ = np.flatnonzero(self._uid_of >= 0)
        return self._uid_of[occ].copy(), occ.astype(np.int32)

    def clear(self) -> None:
        self._free = list(range(self.capacity - 1, -1, -1))
        self._uid_of.fill(-1)
        if self._dense is not None:
            self._dense.fill(-1)
        else:
            self._slot.clear()


class LruOrder:
    """Recency order over uids; coldest pops first."""

    def __init__(self):
        self._od: "OrderedDict[int, None]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._od)

    def touch(self, uid: int) -> None:
        self._od[uid] = None
        self._od.move_to_end(uid)

    def discard(self, uid: int) -> None:
        self._od.pop(uid, None)

    def pop_coldest(self) -> int:
        return self._od.popitem(last=False)[0]

    def clear(self) -> None:
        self._od.clear()


class FreqSketch:
    """Count-Min sketch with halving decay (the TinyLFU aging trick).

    ``depth`` counter rows of ``width`` uint32 cells, indexed by
    multiply-shift hashes (odd 64-bit multiplier, top ``log2(width)``
    bits). An estimate is the min over rows, so it can only over-count.
    Every ``decay_every`` observations all counters halve — recency
    keeps mattering and one ancient hot streak cannot pin a dead id's
    frequency forever.
    """

    def __init__(self, width: int = 1 << 15, depth: int = 4,
                 decay_every: Optional[int] = None, seed: int = 0x9E3779B9):
        if width < 2 or width & (width - 1):
            raise ValueError("FreqSketch width must be a power of two >= 2")
        self.width = int(width)
        self.depth = int(depth)
        self._shift = np.uint64(64 - (int(width).bit_length() - 1))
        self._c = np.zeros((self.depth, self.width), np.uint32)
        rng = np.random.RandomState(seed)
        self._salt = (rng.randint(1, 1 << 62, size=self.depth,
                                  dtype=np.int64).astype(np.uint64)
                      * np.uint64(2) + np.uint64(1))
        self.decay_every = (int(decay_every) if decay_every
                            else 8 * self.width)
        self._seen = 0

    def _hash(self, uids: np.ndarray) -> np.ndarray:
        u = np.asarray(uids, np.int64).astype(np.uint64)
        return (u[None, :] * self._salt[:, None]) >> self._shift

    def observe(self, uids: np.ndarray) -> None:
        uids = np.asarray(uids)
        if uids.size == 0:
            return
        h = self._hash(uids)
        for d in range(self.depth):
            np.add.at(self._c[d], h[d], 1)
        self._seen += int(uids.size)
        if self._seen >= self.decay_every:
            self._c >>= 1
            self._seen //= 2

    def estimate(self, uids: np.ndarray) -> np.ndarray:
        uids = np.asarray(uids)
        if uids.size == 0:
            return np.zeros(0, np.uint32)
        h = self._hash(uids)
        est = self._c[0][h[0]]
        for d in range(1, self.depth):
            est = np.minimum(est, self._c[d][h[d]])
        return est
