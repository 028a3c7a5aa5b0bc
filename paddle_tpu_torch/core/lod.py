"""LoDTensor compatibility types (the port's copy of
``paddle_tpu.core.lod``; numpy only).

Reference analog: ``paddle/fluid/framework/lod_tensor.h:52`` (`LoD` — level
-of-detail offsets) / ``:104`` (`LoDTensor`), the pybind surface
(pybind.cc:279), and ``python/paddle/fluid/lod_tensor.py``
(create_lod_tensor / create_random_int_lodtensor).

As in the JAX package, variable-length data rides padded-dense tensors
plus a per-row length array (``ops/sequence_ops.py``), so inside programs
there is no LoD. These types exist at the *feeding* API
boundary for reference-code migration: a `LoDTensor` carries the flat
concatenated data + recursive sequence lengths exactly like the reference,
and converts to the padded+length form the ops consume via `to_padded()`.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def _lengths_to_offsets(lengths: Sequence[int]) -> List[int]:
    off = [0]
    for n in lengths:
        off.append(off[-1] + int(n))
    return off


class LoDTensor:
    """Flat data + recursive sequence lengths (reference LoDTensor)."""

    def __init__(self, data=None, recursive_seq_lens: Optional[list] = None):
        self._arr = None if data is None else np.asarray(data)
        self._seq_lens: List[List[int]] = [
            [int(x) for x in lvl] for lvl in (recursive_seq_lens or [])]

    # -- reference API ------------------------------------------------------
    def set(self, data, place=None):
        self._arr = np.asarray(data)

    def set_recursive_sequence_lengths(self, lens):
        self._seq_lens = [[int(x) for x in lvl] for lvl in lens]

    def recursive_sequence_lengths(self) -> List[List[int]]:
        return [list(lvl) for lvl in self._seq_lens]

    def set_lod(self, lod):
        """Offset-form setter (lod_tensor.h LoD is offsets)."""
        self._seq_lens = [[b - a for a, b in zip(lvl, lvl[1:])] for lvl in lod]

    def lod(self) -> List[List[int]]:
        return [_lengths_to_offsets(lvl) for lvl in self._seq_lens]

    def has_valid_recursive_sequence_lengths(self) -> bool:
        if self._arr is None:
            return False
        total = self._arr.shape[0] if self._arr.ndim else 0
        lens = self._seq_lens
        if not lens:
            return True
        # each deeper level's entry count must equal the sum of the level
        # above; the last level must cover the rows
        for i in range(len(lens) - 1):
            if len(lens[i + 1]) != sum(lens[i]):
                return False
        return sum(lens[-1]) == total

    def shape(self):
        return tuple(self._arr.shape) if self._arr is not None else ()

    def __array__(self, dtype=None):
        a = self._arr
        return a.astype(dtype) if dtype is not None else a

    def numpy(self) -> np.ndarray:
        return self._arr

    # -- bridge to the padded form -------------------------------------------
    def to_padded(self, pad_value=0):
        """[(num_seqs, max_len, *feat), lengths] from the LAST LoD level —
        the padded+mask representation every sequence op here consumes."""
        if not self._seq_lens:
            return self._arr, None
        lens = self._seq_lens[-1]
        off = _lengths_to_offsets(lens)
        maxlen = max(lens) if lens else 0
        feat = self._arr.shape[1:]
        out = np.full((len(lens), maxlen) + tuple(feat), pad_value,
                      self._arr.dtype)
        for i, (a, b) in enumerate(zip(off, off[1:])):
            out[i, :b - a] = self._arr[a:b]
        return out, np.asarray(lens, np.int64)

    def __repr__(self):
        return (f"LoDTensor(shape={self.shape()}, "
                f"recursive_seq_lens={self._seq_lens})")


class LoDTensorArray(list):
    """reference LoDTensorArray (pybind.cc) — a list of LoDTensors."""


def create_lod_tensor(data, recursive_seq_lens, place=None) -> LoDTensor:
    """python/paddle/fluid/lod_tensor.py:create_lod_tensor parity: accepts a
    numpy array, a list-of-lists, or another LoDTensor."""
    if isinstance(data, LoDTensor):
        return create_lod_tensor(data.numpy(), recursive_seq_lens, place)
    if isinstance(data, list):
        # list of per-sequence rows; flatten (reference asserts consistency)
        flat = [np.asarray(seq).reshape(len(seq), -1) for seq in data]
        lens = [len(seq) for seq in data]
        if recursive_seq_lens and recursive_seq_lens[-1] != lens:
            raise ValueError("recursive_seq_lens inconsistent with data")
        data = np.concatenate(flat, axis=0)
    t = LoDTensor(np.asarray(data), recursive_seq_lens)
    if not t.has_valid_recursive_sequence_lengths():
        raise ValueError(f"invalid recursive_seq_lens {recursive_seq_lens} "
                         f"for data with {np.asarray(data).shape[0]} rows")
    return t


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place=None,
                                low=0, high=1) -> LoDTensor:
    """lod_tensor.py:create_random_int_lodtensor parity."""
    total = sum(recursive_seq_lens[-1])
    shape = (total,) + tuple(base_shape)
    data = np.random.randint(low, high + 1, shape).astype("int64")
    return create_lod_tensor(data, recursive_seq_lens, place)
