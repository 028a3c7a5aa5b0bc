"""Range-partitioned embedding shards — the server half of the PS tier.

Reference analog: the Downpour-style sparse tables behind ``FleetWrapper``
(pslib DownpourSparseTable: rows live on pserver processes, workers pull
the touched rows and push updates through the Communicator). Here a shard
holds a contiguous row range of ONE table in the packed row-major
state-in-row layout (``ops/deferred_rows.py``: ``[n, 128] uint16`` rows,
each bit-splitting up to 64 f32 values — embedding columns plus optimizer
state columns in the same row), so the exact-Adagrad contract of the
packed single-table path is preserved per shard: the worker computes the
identical update math on the pulled bytes and pushes whole new rows back
(scatter-set semantics), and a shard never reinterprets them.

Shards are plain numpy + stdlib on purpose: host DRAM — not device memory —
is what bounds table size, which is the entire point of the tier. The
port's copy of ``paddle_tpu.ps.shard``. A shard's rows start as
``np.zeros``, which the OS commits lazily: an in-process 33.5M-row table
costs only the pages its ids touch.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["RangeSpec", "EmbeddingShard", "make_shards"]

PACK_LANES = 128  # ops.deferred_rows.PACK_LANES (shards import no torch)


class RangeSpec:
    """Range partition of ``[0, vocab)`` row ids into N contiguous shards.

    ``boundaries`` is the N+1 ascending cut vector ``[0, b1, …, vocab]``;
    row id ``r`` lives on shard ``i`` iff ``boundaries[i] <= r <
    boundaries[i+1]`` — an id exactly on a cut ``b_i`` belongs to shard
    ``i`` (the right-hand side), which the tests pin down. ``even()``
    builds the balanced split (first ``vocab % n`` shards get the extra
    row, so every id is covered with no empty tail shard).
    """

    def __init__(self, vocab: int, boundaries: Sequence[int]):
        b = [int(x) for x in boundaries]
        if len(b) < 2 or b[0] != 0 or b[-1] != int(vocab):
            raise ValueError(
                f"RangeSpec boundaries must run [0, …, vocab={vocab}]; "
                f"got {b}")
        if any(y <= x for x, y in zip(b, b[1:])):
            raise ValueError(f"RangeSpec boundaries must be strictly "
                             f"ascending (no empty shards); got {b}")
        self.vocab = int(vocab)
        self.boundaries = np.asarray(b, dtype=np.int64)

    @classmethod
    def even(cls, vocab: int, num_shards: int) -> "RangeSpec":
        if num_shards < 1 or num_shards > vocab:
            raise ValueError(
                f"RangeSpec.even: need 1 <= num_shards <= vocab, got "
                f"num_shards={num_shards}, vocab={vocab}")
        base, rem = divmod(int(vocab), int(num_shards))
        cuts = [0]
        for i in range(num_shards):
            cuts.append(cuts[-1] + base + (1 if i < rem else 0))
        return cls(vocab, cuts)

    @property
    def num_shards(self) -> int:
        return len(self.boundaries) - 1

    def bounds(self, shard: int):
        return int(self.boundaries[shard]), int(self.boundaries[shard + 1])

    def shard_of(self, ids: np.ndarray) -> np.ndarray:
        """Shard index per id (vectorized)."""
        ids = np.asarray(ids)
        if ids.size and (ids.min() < 0 or ids.max() >= self.vocab):
            bad = ids[(ids < 0) | (ids >= self.vocab)]
            raise ValueError(
                f"ids out of range [0, {self.vocab}): {bad[:8].tolist()}")
        return np.searchsorted(self.boundaries, ids, side="right") - 1

    def cuts_into(self, sorted_ids: np.ndarray) -> np.ndarray:
        """Cut points of an ASCENDING id vector at the shard boundaries:
        shard ``i``'s slice is ``sorted_ids[cuts[i]:cuts[i+1]]``. Because
        the partition is by contiguous range, a sorted pull re-assembles
        by plain concatenation in shard order — no scatter needed."""
        return np.searchsorted(sorted_ids, self.boundaries, side="left")

    def to_dict(self) -> dict:
        return {"vocab": self.vocab,
                "boundaries": self.boundaries.tolist()}

    @classmethod
    def from_dict(cls, d: dict) -> "RangeSpec":
        return cls(d["vocab"], d["boundaries"])

    def __eq__(self, other):
        return (isinstance(other, RangeSpec)
                and self.vocab == other.vocab
                and np.array_equal(self.boundaries, other.boundaries))

    def __repr__(self):
        return (f"RangeSpec(vocab={self.vocab}, "
                f"shards={self.num_shards})")


class EmbeddingShard:
    """One table's contiguous row slice ``[lo, hi)`` as packed u16 rows.

    ``pull``/``push`` speak GLOBAL row ids (the shard subtracts its own
    ``lo``), so the transport and the client never translate. ``push`` is
    scatter-SET of whole rows — the worker owns the optimizer math; the
    shard is storage with byte accounting. A lock serializes mutation:
    the in-process client may be driven from the trainer thread and the
    async pusher concurrently, and the socket server is one-thread-per-
    connection.
    """

    def __init__(self, name: str, lo: int, hi: int,
                 rows: Optional[np.ndarray] = None,
                 lanes: int = PACK_LANES):
        if hi <= lo:
            raise ValueError(f"EmbeddingShard {name!r}: empty range "
                             f"[{lo}, {hi})")
        self.name = str(name)
        self.lo, self.hi = int(lo), int(hi)
        n = self.hi - self.lo
        if rows is None:
            rows = np.zeros((n, lanes), dtype=np.uint16)
        rows = np.ascontiguousarray(rows, dtype=np.uint16)
        if rows.shape != (n, lanes):
            raise ValueError(
                f"EmbeddingShard {self.name!r}: rows shape {rows.shape} "
                f"!= ({n}, {lanes}) for range [{lo}, {hi})")
        self.rows = rows
        self._lock = threading.Lock()
        self.bytes_pulled = 0
        self.bytes_pushed = 0
        self.n_pulls = 0
        self.n_pushes = 0

    def _local(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, dtype=np.int64)
        if ids.size and (ids.min() < self.lo or ids.max() >= self.hi):
            bad = ids[(ids < self.lo) | (ids >= self.hi)]
            raise ValueError(
                f"shard {self.name!r}[{self.lo}:{self.hi}): ids outside "
                f"range: {bad[:8].tolist()}")
        return ids - self.lo

    def pull(self, ids: np.ndarray) -> np.ndarray:
        """Rows for global ids (a fresh copy — later pushes never alias
        into a buffer the caller is still reading)."""
        loc = self._local(ids)
        with self._lock:
            out = self.rows[loc]  # fancy index: already a copy
            self.bytes_pulled += out.nbytes
            self.n_pulls += 1
        return out

    def push(self, ids: np.ndarray, rows: np.ndarray) -> None:
        """Scatter-set whole rows at global ids."""
        loc = self._local(ids)
        rows = np.asarray(rows, dtype=np.uint16)
        if rows.shape != (loc.shape[0], self.rows.shape[1]):
            raise ValueError(
                f"shard {self.name!r}: push rows shape {rows.shape} != "
                f"({loc.shape[0]}, {self.rows.shape[1]})")
        with self._lock:
            self.rows[loc] = rows
            self.bytes_pushed += rows.nbytes
            self.n_pushes += 1

    def dump(self) -> np.ndarray:
        """The full slice (copy) — the checkpoint save path."""
        with self._lock:
            return self.rows.copy()

    def load(self, rows: np.ndarray) -> None:
        """Replace the full slice — the checkpoint restore path."""
        rows = np.ascontiguousarray(rows, dtype=np.uint16)
        if not rows.flags.writeable:
            # socket transport hands us np.frombuffer views (read-only, and
            # ascontiguousarray passes them through); the slice must stay
            # pushable after restore
            rows = rows.copy()
        if rows.shape != self.rows.shape:
            raise ValueError(
                f"shard {self.name!r}: load shape {rows.shape} != "
                f"{self.rows.shape}")
        with self._lock:
            self.rows = rows

    def stats(self) -> dict:
        with self._lock:
            # live_rows/capacity mirror the dynamic shard's vocab fields
            # (a dense shard is always at 100% occupancy by construction)
            # so health/vocab tooling reads every shard kind uniformly
            return {"name": self.name, "lo": self.lo, "hi": self.hi,
                    "rows": self.hi - self.lo,
                    "bytes_pulled": self.bytes_pulled,
                    "bytes_pushed": self.bytes_pushed,
                    "n_pulls": self.n_pulls, "n_pushes": self.n_pushes,
                    "dynamic": False,
                    "live_rows": self.hi - self.lo,
                    "capacity": self.hi - self.lo}


def make_shards(name: str, spec: RangeSpec,
                full_rows: Optional[np.ndarray] = None,
                lanes: int = PACK_LANES) -> List[EmbeddingShard]:
    """Build the shard set for one table, optionally slicing an existing
    full ``[vocab, lanes]`` packed table (each shard copies its slice, so
    the source array can be dropped)."""
    if full_rows is not None:
        full_rows = np.asarray(full_rows, dtype=np.uint16)
        if full_rows.shape != (spec.vocab, lanes):
            raise ValueError(
                f"make_shards: full_rows shape {full_rows.shape} != "
                f"({spec.vocab}, {lanes})")
    out = []
    for i in range(spec.num_shards):
        lo, hi = spec.bounds(i)
        rows = full_rows[lo:hi].copy() if full_rows is not None else None
        out.append(EmbeddingShard(name, lo, hi, rows, lanes=lanes))
    return out
