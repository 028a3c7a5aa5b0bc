"""SelectedRows — sparse row-gradient carrier.

Counterpart of ``paddle_tpu.core.selected_rows`` (reference
``paddle/fluid/framework/selected_rows.h`` and the lookup_table sparse-grad
path, lookup_table_op.cc LookupTableGradKernel with is_sparse=True).

A plain (ids, rows, height) record over tensors: ``rows[i]`` is the gradient
of table row ``ids[i]``, duplicates allowed and meaning "add". The executor's
sparse hook builds one from an ``is_sparse`` lookup's output cotangent, so a
``[height, dim]`` dense gradient is never made; the optimizer ops consume it
row-wise, and anything else can call ``to_dense()``.
"""
from __future__ import annotations

import torch


def segment_sums(ids: torch.Tensor, rows: torch.Tensor):
    """Sort `ids` stably and sum the rows of each run of equal ids in
    occurrence order, sequentially: the bits do not depend on the device or
    on how many other ids the batch holds.

    Returns (order, seg, sums): the stable sort permutation, the run index
    of each sorted position, and [len(ids), D] run sums (rows past the last
    run are zero)."""
    n = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    sids = ids[order]
    first = torch.ones(n, dtype=torch.bool, device=ids.device)
    first[1:] = sids[1:] != sids[:-1]
    seg = torch.cumsum(first, 0) - 1
    counts = torch.zeros(n, dtype=torch.int64, device=ids.device)
    counts.scatter_add_(0, seg, torch.ones_like(seg))
    sums = torch.segment_reduce(rows[order], "sum", lengths=counts,
                                unsafe=True)
    return order, seg, sums


class SelectedRows:
    """rows: [N, D] gradient rows; ids: [N] int64 row indices into a
    [height, D] table. Duplicate ids are allowed and mean "add"."""

    def __init__(self, ids, rows, height: int):
        self.ids = ids
        self.rows = rows
        self.height = int(height)

    @property
    def dtype(self):
        return self.rows.dtype

    @property
    def shape(self):
        return (self.height,) + tuple(self.rows.shape[1:])

    def to_dense(self):
        dense = self.rows.new_zeros(self.shape)
        return dense.index_add_(0, self.ids, self.rows)

    def __add__(self, other):
        if isinstance(other, SelectedRows):
            if other.height != self.height:
                raise ValueError("SelectedRows height mismatch")
            return SelectedRows(torch.cat([self.ids, other.ids]),
                                torch.cat([self.rows, other.rows]),
                                self.height)
        # dense + sparse → dense
        return other.index_add(0, self.ids, self.rows.to(other.dtype))

    __radd__ = __add__

    def merged(self):
        """(sorted ids, rows) where every duplicate position carries the
        FULL per-id sum, so a scatter of values computed from the rows is
        deterministic under duplicates."""
        order, seg, sums = segment_sums(self.ids, self.rows)
        return self.ids[order], sums[seg]

    def __repr__(self):
        return (f"SelectedRows(height={self.height}, "
                f"rows={getattr(self.rows, 'shape', None)})")
