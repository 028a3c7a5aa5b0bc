"""Reader decorators, PyReader and sequence packing (the port's copy of
``paddle_tpu.reader``; plain Python and numpy, with PyReader's double
buffer on the port's ``dataio.DeviceLoader``).

Reference analog: ``python/paddle/reader/decorator.py`` (batch/shuffle/
buffered/map_readers/xmap_readers/compose/chain/firstn/cache,
multiprocess_reader, Fake, creator) and ``python/paddle/fluid/reader.py``
PyReader:47 (background thread feeding a blocking queue, double-buffered
H2D — buffered_reader.cc). ``bucket_by_sequence_length`` groups
variable-length samples into padded length buckets.
"""
from __future__ import annotations

import itertools
import random as _random
import threading
from queue import Queue
from typing import Callable, Iterable, List, Optional

import numpy as np


# ---------------------------------------------------------------------------
# decorators (paddle.reader.* parity)
# ---------------------------------------------------------------------------

def batch(reader: Callable, batch_size: int, drop_last: bool = False):
    def batch_reader():
        b = []
        for item in reader():
            b.append(item)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b
    return batch_reader


def shuffle(reader: Callable, buf_size: int):
    def shuffle_reader():
        buf = []
        for item in reader():
            buf.append(item)
            if len(buf) >= buf_size:
                _random.shuffle(buf)
                yield from buf
                buf = []
        _random.shuffle(buf)
        yield from buf
    return shuffle_reader


def buffered(reader: Callable, size: int):
    """Prefetch into a bounded queue on a background thread. Reader errors
    re-raise in the consumer (no silent dataset truncation)."""
    end = object()

    def buffered_reader():
        q: Queue = Queue(maxsize=size)
        error: List[BaseException] = []

        def worker():
            try:
                for item in reader():
                    q.put(item)
            except BaseException as e:  # propagate to consumer
                error.append(e)
            finally:
                q.put(end)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is end:
                if error:
                    raise error[0]
                break
            yield item
    return buffered_reader


def map_readers(func: Callable, *readers):
    def reader():
        for items in zip(*[r() for r in readers]):
            yield func(*items)
    return reader


def xmap_readers(mapper: Callable, reader: Callable, process_num: int,
                 buffer_size: int, order: bool = False):
    """Parallel map via threads (the reference uses processes; threads
    avoid forking a process that holds a CUDA context)."""
    end = object()

    def xreader():
        in_q: Queue = Queue(buffer_size)
        out_q: Queue = Queue(buffer_size)

        def feed():
            for i, item in enumerate(reader()):
                in_q.put((i, item))
            for _ in range(process_num):
                in_q.put(end)

        def work():
            while True:
                item = in_q.get()
                if item is end:
                    out_q.put(end)
                    break
                i, x = item
                out_q.put((i, mapper(x)))

        threading.Thread(target=feed, daemon=True).start()
        workers = [threading.Thread(target=work, daemon=True) for _ in range(process_num)]
        for w in workers:
            w.start()
        done = 0
        pending = {}
        next_i = 0
        while done < process_num:
            item = out_q.get()
            if item is end:
                done += 1
                continue
            if not order:
                yield item[1]
            else:
                pending[item[0]] = item[1]
                while next_i in pending:
                    yield pending.pop(next_i)
                    next_i += 1
        if order:
            for i in sorted(pending):
                yield pending[i]
    return xreader


def compose(*readers):
    def reader():
        for items in zip(*[r() for r in readers]):
            out = []
            for it in items:
                if isinstance(it, tuple):
                    out.extend(it)
                else:
                    out.append(it)
            yield tuple(out)
    return reader


def chain(*readers):
    def reader():
        for r in readers:
            yield from r()
    return reader


def firstn(reader: Callable, n: int):
    def firstn_reader():
        yield from itertools.islice(reader(), n)
    return firstn_reader


def cache(reader: Callable):
    all_data: Optional[List] = None

    def cache_reader():
        nonlocal all_data
        if all_data is None:
            all_data = list(reader())
        yield from all_data
    return cache_reader


# ---------------------------------------------------------------------------
# PyReader (fluid.reader.PyReader:47 parity)
# ---------------------------------------------------------------------------

class PyReader:
    """Iterable prefetching reader bound to feed vars.

    with iterable=True (the only mode here): `for data in reader():
    exe.run(feed=data, ...)`. Decorate with sample/batch generators like
    the reference.

    use_double_buffer=True (the reference default, buffered_reader.cc):
    batches are converted, pinned and copied to the card on a background
    :class:`~paddle_tpu_torch.dataio.DeviceLoader` thread and side stream,
    so the H2D copy of batch N+1 overlaps step N; they arrive as device
    tensors on `place` (``CUDAPlace(0)`` unless the caller passes another
    place, here or through ``decorate_*(places=...)``; with no GPU and no
    place, iterating raises). use_double_buffer=False keeps the host-side
    `buffered` prefetch only (batches stay numpy).
    """

    def __init__(self, feed_list=None, capacity: int = 64, use_double_buffer=True,
                 iterable: bool = True, shapes=None, dtypes=None,
                 lod_levels=None, name=None, place=None):
        self._feed_names = [v.name for v in (feed_list or [])]
        self._capacity = capacity
        self._use_double_buffer = bool(use_double_buffer)
        # shapes/dtypes: the layers.py_reader construction form — feed
        # names come from the decorated generator's dicts (or slot order)
        self._shapes = shapes
        self._dtypes = dtypes
        self._batch_reader = None
        self._place = place
        self._loader = None  # active DeviceLoader (double-buffer mode)

    def _set_place(self, places):
        if isinstance(places, (list, tuple)):
            places = places[0] if places else None
        self._place = places or self._place

    def decorate_sample_list_generator(self, reader, places=None):
        from .data_feeder import pad_batch_column
        names = self._feed_names
        if self._use_double_buffer and places is not None:
            self._set_place(places)

        def gen():
            for samples in reader():
                feed = {}
                arrays = list(zip(*samples))
                for name, col in zip(names, arrays):
                    arr, lens = pad_batch_column(col)
                    feed[name] = arr
                    if lens is not None:
                        feed[name + "_len"] = lens
                yield feed
        self._batch_reader = gen

    def decorate_batch_generator(self, reader, places=None):
        names = self._feed_names
        if self._use_double_buffer and places is not None:
            self._set_place(places)

        def gen():
            for b in reader():
                if isinstance(b, dict):
                    yield b
                else:
                    yield {n: np.asarray(v) for n, v in zip(names, b)}
        self._batch_reader = gen

    def __call__(self):
        if self._batch_reader is None:
            raise RuntimeError(
                "PyReader: decorate_sample_list_generator / "
                "decorate_batch_generator must be called before iterating")
        if not self._use_double_buffer:
            return buffered(self._batch_reader, self._capacity)()
        # double-buffer mode: host prefetch (capacity) feeds a device
        # prefetch stage (the classic 2-deep double buffer) — batches
        # arrive as device tensors, Executor.run skips conversion
        from .dataio import DeviceLoader
        self.reset()
        # with no place: CUDA device 0, and no GPU raises here
        loader = DeviceLoader(
            buffered(self._batch_reader, self._capacity),
            capacity=2, name="py_reader", place=self._place)
        self._loader = loader
        return iter(loader)

    def __iter__(self):
        return self()

    def start(self):
        """Non-iterable API compat: spin up the prefetch pipeline now
        (iterable mode does this lazily on iteration)."""
        if self._use_double_buffer and self._batch_reader is not None:
            if self._loader is None or not self._loader.running:
                self()

    def reset(self):
        """Tear down the active prefetch thread/queue. A mid-epoch
        ``break`` otherwise leaks a worker still holding device buffers
        (reference PyReader.reset drained its blocking queue the same
        way)."""
        if self._loader is not None:
            self._loader.close()
            self._loader = None


def bucket_by_sequence_length(reader, bucket_boundaries, batch_sizes,
                              pad_value=0, length_fn=None):
    """Length-bucketing batch reader (keeps most of the reference's
    padding-free LoD efficiency with a few static shapes).

    Groups samples into buckets by length, pads every sample in a bucket to
    the bucket's boundary, and yields `(padded_batch, lengths)` once a
    bucket fills. The bucket count bounds the feed shapes a program sees
    (one prepared plan each), while the padding waste stays
    ≤ (boundary gap / boundary).

    reader: yields samples; a sample is a 1-D sequence (list/np array) or a
    tuple whose first element is the sequence. bucket_boundaries: ascending
    max lengths, e.g. [16, 32, 64]; longer samples are dropped.
    batch_sizes: per-bucket batch size (int = same for all).
    length_fn: custom sample→length (default: len of first element)."""
    bounds = list(bucket_boundaries)
    if isinstance(batch_sizes, int):
        batch_sizes = [batch_sizes] * len(bounds)
    if len(batch_sizes) != len(bounds):
        raise ValueError("batch_sizes must match bucket_boundaries")

    def _len(sample):
        if length_fn is not None:
            return length_fn(sample)
        seq = sample[0] if isinstance(sample, (tuple, list)) and not np.isscalar(sample[0]) else sample
        return len(seq)

    def _field_bound(maxlen, bound):
        # pad to the bucketed bound when the field fits it, else to the next
        # boundary up (keeps the shape set small)
        if maxlen <= bound:
            return bound
        for b in bounds:
            if maxlen <= b:
                return b
        return maxlen

    def _pad_batch(samples, bound):
        first = samples[0]
        multi = isinstance(first, (tuple, list)) and not np.isscalar(first[0])
        n_fields = len(first) if multi else 1
        fields = []
        for f in range(n_fields):
            rows = [np.asarray(s[f] if multi else s) for s in samples]
            if rows[0].ndim == 0:        # scalar field (e.g. a label)
                fields.append(np.stack(rows))
                continue
            fb = _field_bound(max(len(r) for r in rows), bound)
            padded = np.full((len(rows), fb) + rows[0].shape[1:],
                             pad_value, rows[0].dtype)
            for i, r in enumerate(rows):
                padded[i, :len(r)] = r
            fields.append(padded)
        lengths = np.asarray([_len(s) for s in samples], np.int64)
        return (tuple(fields) if multi else fields[0]), lengths

    def bucketed():
        pending = [[] for _ in bounds]
        for sample in reader():
            L = _len(sample)
            for bi, bound in enumerate(bounds):
                if L <= bound:
                    pending[bi].append(sample)
                    if len(pending[bi]) == batch_sizes[bi]:
                        yield _pad_batch(pending[bi], bound)
                        pending[bi] = []
                    break
            # samples longer than the last boundary are dropped (reference
            # readers truncate or drop equivalently)
        for bi, bucket in enumerate(pending):
            if bucket:
                yield _pad_batch(bucket, bounds[bi])

    return bucketed


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """reader/decorator.py multiprocess_reader: run each reader in its own
    process, interleave results through a queue (order not preserved).

    Workers ALWAYS enqueue a terminal sentinel — `None` on success, an
    error marker on failure — and the consumer polls with a bounded
    timeout while checking worker liveness, so a dead worker can't hang
    the loop. Fork context (readers are usually closures, which spawn
    cannot pickle — same tradeoff as the reference); note Python 3.12
    warns about forking a threaded parent, hence the liveness guard. A
    forked worker must not touch CUDA: readers yield host data."""
    import multiprocessing as mp
    import queue as _queue

    ctx = mp.get_context("fork")

    def reader():
        q = ctx.Queue(queue_size)
        procs = [ctx.Process(target=_mp_reader_worker, args=(r, q),
                             daemon=True) for r in readers]
        for p in procs:
            p.start()
        finished = 0
        try:
            while finished < len(readers):
                try:
                    sample = q.get(timeout=5)
                except _queue.Empty:
                    # a worker died without its sentinel (SIGKILL, fork
                    # deadlock): fail loudly instead of hanging forever
                    if all(not p.is_alive() for p in procs) and q.empty():
                        raise RuntimeError(
                            "multiprocess_reader: all workers exited "
                            "without completing")
                    continue
                if sample is None:
                    finished += 1
                elif isinstance(sample, _MpReaderError):
                    raise RuntimeError(
                        f"multiprocess_reader worker failed: {sample.msg}")
                else:
                    yield sample
        finally:
            for p in procs:
                p.join(timeout=5)
                if p.is_alive():
                    p.terminate()

    return reader


class _MpReaderError:
    def __init__(self, msg):
        self.msg = msg


def _mp_reader_worker(r, q):
    try:
        for sample in r():
            q.put(sample)
        q.put(None)
    except BaseException as e:  # sentinel must reach the consumer
        q.put(_MpReaderError(repr(e)))


class Fake:
    """reader/decorator.py Fake: replay the first epoch's samples forever —
    the reference's data-independent throughput-testing reader."""

    def __init__(self):
        self.data = None

    def __call__(self, reader, length):
        def fake_reader():
            if self.data is None:
                self.data = list(reader())
            total = 0
            while total < length:
                for sample in self.data:
                    if total >= length:
                        break
                    total += 1
                    yield sample

        return fake_reader


class _CreatorModule:
    """paddle.reader.creator (reader/creator.py): readers from raw
    sources."""

    @staticmethod
    def np_array(x):
        def reader():
            for row in x:
                yield row

        return reader

    @staticmethod
    def text_file(path):
        def reader():
            with open(path) as f:
                for line in f:
                    yield line.rstrip("\n")

        return reader


creator = _CreatorModule()


def pack_by_tokens(reader, src_budget, tgt_budget, pad_value=0):
    """Packs consecutive sentence pairs into fixed-shape rows of
    ``src_budget``/``tgt_budget`` tokens, so that one shape carries little
    pad. Segment ids keep attention block-diagonal (see
    :func:`packed_attention_masks` and the block-sparse attention op), so
    packed sentences never see each other, exactly like separate rows.

    Yields dict rows (all 1-D numpy):
      src_ids  [Ts] int32   packed source tokens
      tgt_ids  [Tt] int32   packed decoder INPUT tokens (per-sentence
                            shift: sentence tokens t0..t_{l-2})
      lbl_ids  [Tt] int32   labels (t1..t_{l-1}); 0 = pad/ignore
      src_seg  [Ts] int32   1-based segment id per source token, 0 = pad
      tgt_seg  [Tt] int32   ditto for target positions
      src_pos  [Ts] int32   position WITHIN the segment (restarts at 0)
      tgt_pos  [Tt] int32   ditto

    A pair is added to the current row while both budgets hold; pairs longer
    than a whole row are dropped (bucketing's drop rule)."""
    def gen():
        def new_row():
            return {
                "src_ids": np.full(src_budget, pad_value, "int32"),
                "tgt_ids": np.full(tgt_budget, pad_value, "int32"),
                "lbl_ids": np.full(tgt_budget, pad_value, "int32"),
                "src_seg": np.zeros(src_budget, "int32"),
                "tgt_seg": np.zeros(tgt_budget, "int32"),
                "src_pos": np.zeros(src_budget, "int32"),
                "tgt_pos": np.zeros(tgt_budget, "int32"),
            }

        row, sp, tp, seg = new_row(), 0, 0, 0
        for sample in reader():
            src, tgt = sample[0], sample[1]
            ls, lt = len(src), len(tgt) - 1  # lt decoder positions
            if ls > src_budget or lt > tgt_budget or lt < 1:
                continue  # cannot fit any row
            if sp + ls > src_budget or tp + lt > tgt_budget:
                if seg:
                    yield row
                row, sp, tp, seg = new_row(), 0, 0, 0
            seg += 1
            row["src_ids"][sp:sp + ls] = src
            row["src_seg"][sp:sp + ls] = seg
            row["src_pos"][sp:sp + ls] = np.arange(ls)
            row["tgt_ids"][tp:tp + lt] = tgt[:-1][:lt]
            row["lbl_ids"][tp:tp + lt] = tgt[1:][:lt]
            row["tgt_seg"][tp:tp + lt] = seg
            row["tgt_pos"][tp:tp + lt] = np.arange(lt)
            sp += ls
            tp += lt
        if seg:
            yield row

    return gen


def packed_attention_masks(src_seg, tgt_seg, neg=-1e4):
    """Additive attention masks for a batch of packed rows
    (:func:`pack_by_tokens`): 0 where attention is allowed, ``neg``
    elsewhere. Tokens only see their own sentence, so a packed batch computes
    what separate padded rows would.

    src_seg [B,Ts], tgt_seg [B,Tt]  →
      enc_mask   [B,1,Ts,Ts]  block-diagonal self-attention
      self_mask  [B,1,Tt,Tt]  block-diagonal AND causal
      cross_mask [B,1,Tt,Ts]  target segment k ↔ source segment k
    """
    src_seg = np.asarray(src_seg)
    tgt_seg = np.asarray(tgt_seg)
    Tt = tgt_seg.shape[1]
    sv = src_seg[:, :, None]  # [B,Ts,1]
    tv = tgt_seg[:, :, None]  # [B,Tt,1]
    enc = (sv == src_seg[:, None, :]) & (sv > 0)
    causal = np.tril(np.ones((Tt, Tt), bool))
    dec = (tv == tgt_seg[:, None, :]) & (tv > 0) & causal
    cross = (tv == src_seg[:, None, :]) & (tv > 0)
    to_add = lambda m: np.where(m, 0.0, neg).astype("float32")[:, None]
    return to_add(enc), to_add(dec), to_add(cross)
