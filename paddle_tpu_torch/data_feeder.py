"""DataFeeder — numpy batch assembly (the port's copy of
``paddle_tpu.data_feeder``; reference python/paddle/fluid/data_feeder.py:
converts a list of samples into per-var feed arrays; the LoDTensor path
becomes padded-dense + optional length arrays)."""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .core.program import Variable


def pad_batch_column(col):
    """Stack one column of samples; ragged first-dims are padded to the batch
    max (LoDTensor replacement). Returns (array, lengths-or-None)."""
    first = np.asarray(col[0])
    ragged = any(np.asarray(c).shape != first.shape for c in col)
    if not ragged:
        return np.stack([np.asarray(c) for c in col]), None
    maxlen = max(np.asarray(c).shape[0] for c in col)
    batch = np.zeros((len(col), maxlen) + first.shape[1:], dtype=first.dtype)
    lens = np.zeros((len(col),), dtype="int64")
    for i, c in enumerate(col):
        c = np.asarray(c)
        batch[i, :c.shape[0]] = c
        lens[i] = c.shape[0]
    return batch, lens


class DataFeeder:
    def __init__(self, feed_list: Sequence, place=None, program=None):
        self.feed_vars = feed_list
        self.place = place

    def feed(self, iterable) -> Dict[str, np.ndarray]:
        """iterable: list of samples, each a tuple aligned with feed_list.
        Variable-length samples (lod_level>0 in the reference) are padded to
        the batch max and a '<name>_len' entry is added."""
        cols = list(zip(*iterable))
        out = {}
        for var, col in zip(self.feed_vars, cols):
            name = var.name if isinstance(var, Variable) else str(var)
            arr, lens = pad_batch_column(col)
            if lens is not None:
                out[name] = arr
                out[name + "_len"] = lens
                continue
            if isinstance(var, Variable) and var.shape is not None:
                want = [d for d in var.shape]
                # allow implicit trailing [1] (paddle label convention)
                if len(want) == arr.ndim + 1 and want[-1] == 1:
                    arr = arr[..., None]
            out[name] = arr
        return out
