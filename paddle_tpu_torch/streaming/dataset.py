"""StreamingDataset — unbounded ingestion for online learning (the port's
copy of ``paddle_tpu.streaming.dataset``).

Reference analog: QueueDataset over a data pipe (dataset.py:613 +
data_feed.cc MultiSlotDataFeed): the trainer never sees "an epoch", it
sees a socket/pipe that keeps producing MultiSlot records. Here the
source is any Python iterable/callable — a kafka consumer wrapper, a log
tailer, ``DataGenerator.iter_samples`` over raw lines, or MultiSlot text
lines — normalized into per-sample slot dicts and collated into the same
padded feed-dict batches ``QueueDataset.batches()`` emits, so
``Executor.train_from_dataset`` and ``PsEmbeddingTier.steps`` consume it
unchanged (it speaks the full DatasetBase protocol: ``set_batch_size`` /
``set_thread`` / ``set_use_var`` / ``batches()``).

Held-out eval WITHOUT a second pipeline: every ``held_out_every``-th
sample is diverted into a bounded window (``eval_window`` newest held-out
samples) instead of the training batch. ``eval_batches()`` snapshots the
window — a rolling, time-local validation set, which is what online AUC
must be measured on (yesterday's eval set tells you nothing about drift).
"""
from __future__ import annotations

import collections
import threading
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..data_feeder import pad_batch_column
from ..observability import get_registry

__all__ = ["StreamingDataset", "parse_multislot_line"]


def parse_multislot_line(line: str, slots: Sequence[str],
                         slot_types: str = "") -> List[tuple]:
    """One MultiSlot text line → ``[(slot, values), ...]`` (the inverse of
    ``MultiSlotDataGenerator._gen_str``, same framing as the native C++
    parser): for each slot in order, a length then that many values."""
    toks = line.split()
    out = []
    pos = 0
    for i, name in enumerate(slots):
        if pos >= len(toks):
            raise ValueError(
                f"MultiSlot line ends before slot {name!r}: {line!r}")
        n = int(toks[pos])
        pos += 1
        if n < 1 or pos + n > len(toks):
            raise ValueError(
                f"slot {name!r} claims {n} values but the line has "
                f"{len(toks) - pos} left: {line!r}")
        kind = slot_types[i] if i < len(slot_types) else "i"
        conv = int if kind == "i" else float
        out.append((name, [conv(t) for t in toks[pos:pos + n]]))
        pos += n
    if pos != len(toks):
        raise ValueError(
            f"{len(toks) - pos} trailing tokens after the declared slots "
            f"({list(slots)}): {line!r}")
    return out


class StreamingDataset:
    """An unbounded sample stream with the Dataset batching protocol.

    ``source`` is a callable returning an iterator (re-invoked by every
    ``batches()`` call — a live tail), or a plain iterable (consumed
    once). Each item is one SAMPLE in any of three shapes:

    - a dict ``{slot: values}``,
    - a ``[(slot, values), ...]`` pair list (the ``DataGenerator``
      protocol — wire a reference generator via
      ``StreamingDataset(source=lambda: gen.iter_samples(lines))``),
    - a MultiSlot text line (requires ``slots=[...]``; parsed with the
      exact native framing).

    ``max_batches`` bounds one ``batches()`` drain (an online trainer
    alternates: drain a bounded slice, sweep/checkpoint/eval, drain
    again) — ``None`` streams until the source ends.
    """

    def __init__(self, source, *, slots: Optional[Sequence[str]] = None,
                 slot_types: str = "", batch_size: int = 1,
                 held_out_every: int = 0, eval_window: int = 1024,
                 max_batches: Optional[int] = None, drop_last: bool = True):
        self._source = source
        self._slots = list(slots) if slots else None
        self._slot_types = slot_types
        self._batch_size = int(batch_size)
        if held_out_every < 0:
            raise ValueError(f"held_out_every must be >= 0 (0 = no "
                             f"held-out split), got {held_out_every}")
        self._held_out_every = int(held_out_every)
        self._eval_win: "collections.deque" = collections.deque(
            maxlen=int(eval_window))
        self._eval_lock = threading.Lock()
        self._seen = 0
        self.max_batches = max_batches
        # online streams drop ragged tails by default: a one-off batch
        # shape costs a full XLA recompile mid-serving
        self._drop_last = bool(drop_last)
        self._use_var_names: List[str] = []
        self._thread_num = 1
        reg = get_registry()
        self._c_samples = reg.counter("stream/samples")
        self._c_held = reg.counter("stream/held_out_samples")
        self._c_batches = reg.counter("stream/batches")

    # -- DatasetBase protocol (train_from_dataset compatibility) ------------
    def set_batch_size(self, batch_size: int):
        if int(batch_size) < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self._batch_size = int(batch_size)

    def set_drop_last(self, drop_last: bool):
        self._drop_last = bool(drop_last)

    def set_thread(self, thread_num: int):
        # parse threading belongs to the upstream source here (the pipe /
        # consumer is the parallel part); recorded for protocol parity
        self._thread_num = int(thread_num)

    def set_use_var(self, var_list):
        self._use_var_names = [v.name for v in var_list]

    # -- normalization -------------------------------------------------------
    def _as_pairs(self, sample) -> List[tuple]:
        if isinstance(sample, str):
            if not self._slots:
                raise ValueError(
                    "StreamingDataset got a text line but no slots=[...] "
                    "schema to parse it with")
            return parse_multislot_line(sample, self._slots,
                                        self._slot_types)
        if isinstance(sample, dict):
            return list(sample.items())
        if isinstance(sample, (list, tuple)):
            return list(sample)
        raise ValueError(
            f"StreamingDataset sample must be a dict, a (slot, values) "
            f"pair list, or a MultiSlot text line; got {type(sample)}")

    def _samples(self):
        src = self._source() if callable(self._source) else self._source
        for sample in src:
            pairs = self._as_pairs(sample)
            self._seen += 1
            self._c_samples.inc()
            if (self._held_out_every
                    and self._seen % self._held_out_every == 0):
                with self._eval_lock:
                    self._eval_win.append(pairs)
                self._c_held.inc()
                continue
            yield pairs

    def _collate(self, batch: List[List[tuple]]) -> Dict[str, np.ndarray]:
        cols: Dict[str, list] = {}
        for pairs in batch:
            for name, values in pairs:
                cols.setdefault(name, []).append(np.asarray(values))
        want = self._use_var_names or list(cols)
        out: Dict[str, np.ndarray] = {}
        for name in want:
            if name not in cols:
                raise ValueError(
                    f"slot {name!r} (from set_use_var) missing from the "
                    f"stream; sample slots: {sorted(cols)}")
            if len(cols[name]) != len(batch):
                raise ValueError(
                    f"slot {name!r} present in only {len(cols[name])}/"
                    f"{len(batch)} samples — every sample must carry "
                    "every slot")
            arr, lens = pad_batch_column(cols[name])
            out[name] = arr
            if lens is not None:
                out[name + "_len"] = lens
        return out

    # -- the two taps --------------------------------------------------------
    def batches(self):
        """Training batches (held-out samples already diverted). Bounded
        by ``max_batches`` per call when set; the NEXT call resumes the
        same callable-source stream where this one left off only if the
        source itself is stateful (a generator object is; re-invoking a
        fresh list comprehension is not)."""
        it = self._samples()
        n = 0
        batch: List[List[tuple]] = []
        for pairs in it:
            batch.append(pairs)
            if len(batch) == self._batch_size:
                yield self._collate(batch)
                self._c_batches.inc()
                batch = []
                n += 1
                if self.max_batches is not None and n >= self.max_batches:
                    return
        if batch and not self._drop_last:
            yield self._collate(batch)
            self._c_batches.inc()

    def reader(self) -> Callable:
        """``PsEmbeddingTier.steps(dataset.reader())`` adapter."""
        return self.batches

    def eval_batches(self, batch_size: Optional[int] = None):
        """Collated batches over a SNAPSHOT of the held-out window (the
        stream keeps appending while eval runs; the snapshot keeps one
        eval internally consistent). Ragged tail kept — eval wants every
        sample, and it runs off the hot path."""
        with self._eval_lock:
            window = list(self._eval_win)
        bs = int(batch_size or self._batch_size)
        for i in range(0, len(window), bs):
            yield self._collate(window[i:i + bs])

    @property
    def eval_size(self) -> int:
        with self._eval_lock:
            return len(self._eval_win)

    def stats(self) -> dict:
        return {"samples": self._seen, "eval_window": self.eval_size,
                "batch_size": self._batch_size,
                "held_out_every": self._held_out_every}
