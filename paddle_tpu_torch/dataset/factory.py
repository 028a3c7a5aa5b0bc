"""Dataset — file-list-sharded bulk training input (the port's copy of
``paddle_tpu.dataset.factory``).

Reference analog: ``python/paddle/fluid/dataset.py`` (DatasetFactory,
InMemoryDataset:269 with load_into_memory/local_shuffle/global_shuffle,
QueueDataset:613 streaming) over the C++ MultiSlotDataFeed/Dataset
(framework/data_set.cc, data_feed.cc).

The native C++ loader (paddle_tpu_torch/native) does threaded file
parsing into a blocking queue. ``global_shuffle`` across trainers routes
each record to a rank of the ``torch.distributed`` group over the TCP
all-to-all of ``shuffle_service`` (the JAX package's routing).
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence

import numpy as np

import torch

from ..core.dtypes import convert_dtype
from ..native import NativeDataLoader


class DatasetBase:
    def __init__(self):
        self._filelist: List[str] = []
        self._slots: List[str] = []
        self._slot_types: str = ""
        self._batch_size = 1
        self._thread_num = 1
        self._use_var_names: List[str] = []
        # a ragged epoch-tail batch is a new feed signature (a new plan).
        # Default keeps the tail (reference semantics); set_drop_last(True)
        # for shape stability.
        self._drop_last = False

    def set_batch_size(self, batch_size: int):
        self._batch_size = batch_size

    def set_drop_last(self, drop_last: bool):
        self._drop_last = bool(drop_last)

    def set_thread(self, thread_num: int):
        self._thread_num = thread_num

    def set_use_var(self, var_list):
        self._use_var_names = [v.name for v in var_list]
        types = []
        for v in var_list:
            dt = convert_dtype(v.dtype)
            integer = not dt.is_floating_point and dt != torch.bool
            types.append("i" if integer else "f")
        self._slot_types = "".join(types)

    def set_pipe_command(self, cmd: str):
        """data_feed.h pipe_command: each input file is streamed through
        this shell command before MultiSlot parsing (the reference pipes
        via framework/io/shell.cc; here the preprocessing runs ONCE into
        temp files — cached across epochs — then the native loader parses
        as usual)."""
        self._pipe_command = cmd
        self._piped_cache = None

    def set_filelist(self, filelist: Sequence[str]):
        self._filelist = list(filelist)
        self._piped_cache = None

    def _piped_filelist(self):
        cmd = getattr(self, "_pipe_command", None)
        if not cmd or cmd.strip() == "cat":  # reference default: identity
            return self._filelist
        if getattr(self, "_piped_cache", None) is not None:
            return self._piped_cache
        import atexit
        import shutil
        import subprocess
        import tempfile
        d = tempfile.mkdtemp(prefix="paddle_tpu_torch_pipe_")
        atexit.register(shutil.rmtree, d, ignore_errors=True)
        piped = []
        try:
            for i, f in enumerate(self._filelist):
                out = f"{d}/part-{i}"
                with open(f, "rb") as src, open(out, "wb") as dst:
                    r = subprocess.run(cmd, shell=True, stdin=src,
                                       stdout=dst)
                if r.returncode != 0:
                    raise RuntimeError(
                        f"pipe_command {cmd!r} failed on {f} "
                        f"(rc={r.returncode})")
                piped.append(out)
        except BaseException:
            shutil.rmtree(d, ignore_errors=True)
            raise
        self._piped_cache = piped
        return piped

    def _make_loader(self) -> NativeDataLoader:
        return NativeDataLoader(self._piped_filelist(), self._slot_types,
                                num_threads=self._thread_num)


class QueueDataset(DatasetBase):
    """Streaming dataset (dataset.py:613): iterate batches straight from the
    native loader queue."""

    def batches(self):
        loader = self._make_loader()
        batch: List = []
        for sample in loader:
            batch.append(sample)
            if len(batch) == self._batch_size:
                yield self._collate(batch)
                batch = []
        if batch and not self._drop_last:
            yield self._collate(batch)
        loader.close()

    def _collate(self, samples) -> Dict[str, np.ndarray]:
        from ..data_feeder import pad_batch_column
        out = {}
        for i, name in enumerate(self._use_var_names):
            arr, lens = pad_batch_column([s[i] for s in samples])
            out[name] = arr
            if lens is not None:
                out[name + "_len"] = lens
        return out


class InMemoryDataset(QueueDataset):
    """dataset.py:269 parity: load once, shuffle in memory, iterate."""

    def __init__(self):
        super().__init__()
        self._memory: Optional[List] = None

    def load_into_memory(self):
        loader = self._make_loader()
        self._memory = list(loader)
        loader.close()

    def local_shuffle(self):
        if self._memory is None:
            raise RuntimeError("call load_into_memory() first")
        random.shuffle(self._memory)

    def global_shuffle(self, fleet=None, thread_num: int = 12):
        """Reference routes records between trainers via fleet RPC
        (data_set.cc GlobalShuffle, data_set.h:165). Multi-trainer here does
        the same over a TCP all-to-all shuffle service: every record is
        hash-routed by content (+epoch salt) to its destination trainer, so
        records a trainer never loaded can land on it — the true cross-
        trainer semantics, not a local partition. Collective contract: all
        trainers must call global_shuffle together (as in the reference).
        The trainers are the ranks of the ``torch.distributed`` group; the
        routing is the JAX package's (an md5 of the pickled record, its
        position, the rank and the epoch), so the same records on the same
        ranks land where they land there.

        Single-process falls back to keeping the hash-mod shard of a
        deterministic permutation (no network hop, same statistics)."""
        if self._memory is None:
            raise RuntimeError("call load_into_memory() first")
        import torch.distributed as dist
        nranks, rank = 1, 0
        if dist.is_available() and dist.is_initialized():
            nranks, rank = dist.get_world_size(), dist.get_rank()
        self._shuffle_epoch = getattr(self, "_shuffle_epoch", 0) + 1
        rng = random.Random(12345 + self._shuffle_epoch)
        if nranks > 1:
            import hashlib
            import pickle

            from .shuffle_service import exchange_records
            # deterministic routing (md5, not the per-process-salted
            # builtin hash) keyed by (content, local position, epoch) —
            # duplicates spread instead of piling onto one trainer, and a
            # relaunched job reproduces the same distribution
            buckets = [[] for _ in range(nranks)]
            for i, rec in enumerate(self._memory):
                digest = hashlib.md5(
                    pickle.dumps((rec, i, rank, self._shuffle_epoch),
                                 protocol=4)).digest()
                h = int.from_bytes(digest[:8], "little")
                buckets[h % nranks].append(rec)
            self._memory = exchange_records(buckets, rank, nranks)
            rng = random.Random(12345 + self._shuffle_epoch + rank)
            rng.shuffle(self._memory)
            self._sharded = True
            return
        if not getattr(self, "_sharded", False):
            order = list(range(len(self._memory)))
            rng.shuffle(order)
            self._memory = [self._memory[i] for i in order if i % nranks == rank]
            self._sharded = True
        else:
            rng.shuffle(self._memory)

    def release_memory(self):
        self._memory = None

    def get_memory_data_size(self, fleet=None) -> int:
        return len(self._memory or [])

    def batches(self):
        if self._memory is None:
            yield from super().batches()
            return
        n = len(self._memory)
        if self._drop_last:
            n -= n % self._batch_size
        for i in range(0, n, self._batch_size):
            yield self._collate(self._memory[i:i + self._batch_size])


class FileInstantDataset(QueueDataset):
    pass


class DatasetFactory:
    """dataset.py DatasetFactory parity."""

    def create_dataset(self, datafeed_class: str = "QueueDataset"):
        classes = {
            "QueueDataset": QueueDataset,
            "InMemoryDataset": InMemoryDataset,
            "FileInstantDataset": FileInstantDataset,
        }
        if datafeed_class not in classes:
            raise ValueError(f"unknown dataset class {datafeed_class}")
        return classes[datafeed_class]()
