"""Deep Gradient Compression — top-k sparsified gradient exchange (the
port's counterpart of ``paddle_tpu.parallel.dgc``).

Reference analog: the DGC stack (``DGCMomentumOptimizer``
python/paddle/fluid/optimizer.py:799, ``SparseAllReduceOpHandle``
paddle/fluid/framework/details/sparse_all_reduce_op_handle.cc): keep the
top k% of each gradient by magnitude, accumulate the rest locally as an
error-feedback residual, exchange only the sparse entries.

Each rank holds its own gradient and residual (one process a GPU):

- ``top_k_sparsify``: residual += grad; keep the top-k |values| (ranked as
  ``lax.top_k`` ranks them: ties to the lower index); the rest carries
  over (DGC's error feedback);
- ``dgc_allreduce``: the masked tensor summed by a dense all-reduce, as in
  the JAX package: the wire carries every zero;
- ``sparse_allgather_exchange``: the bandwidth-saving form: one all-gather
  of the rank's [k] values and one of its [k] int64 indices, then an
  ``index_add_`` of every rank's entries (O(k·world) bytes on the wire,
  the reference's encoded SparseAllReduce).

`mesh` is a ``DeviceMesh`` whose `axis` dim holds the ranks that
exchange, or None for the whole process group.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from ..ops.optimizer_ops import top_k_order, top_k_set
from .collective import all_gather_into

__all__ = ["top_k_sparsify", "dgc_allreduce", "sparse_allgather_exchange"]


def _group(mesh, axis: str):
    return mesh.get_group(axis) if mesh is not None else None


def top_k_sparsify(g: torch.Tensor, ratio: float
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sparse_grad, new_residual): keep the top `ratio` fraction of |g|,
    the rest becomes the carried residual. k = max(1, int(n·ratio))."""
    flat = g.reshape(-1)
    k = max(1, int(flat.shape[0] * ratio))
    mask = top_k_set(flat.abs(), k).to(flat.dtype)
    sparse = (flat * mask).reshape(g.shape)
    return sparse, g - sparse


def dgc_allreduce(grad: torch.Tensor, residual: torch.Tensor, mesh=None,
                  axis: str = "dp", ratio: float = 0.01):
    """One DGC exchange: error-feedback accumulate, top-k select, and a
    dense all-reduce of the masked tensor. Returns (the group's summed
    sparse gradient, this rank's new residual)."""
    sparse, new_r = top_k_sparsify(grad + residual, ratio)
    summed = sparse.contiguous().clone()
    dist.all_reduce(summed, group=_group(mesh, axis))
    return summed, new_r


def sparse_allgather_exchange(grad: torch.Tensor, residual: torch.Tensor,
                              mesh=None, axis: str = "dp",
                              ratio: float = 0.01):
    """The DCN-shaped variant: each rank sends only its [k] values and [k]
    indices (two all-gathers), and adds every rank's entries into a zero
    tensor locally. Returns (the summed sparse gradient, this rank's new
    residual)."""
    group = _group(mesh, axis)
    world = dist.get_world_size(group)
    acc = (grad + residual).reshape(-1)
    k = max(1, int(acc.shape[0] * ratio))
    idx = top_k_order(acc.abs(), k)
    vals = acc[idx].contiguous()
    new_r = acc.index_fill(0, idx, 0.0).reshape(grad.shape)
    all_vals = vals.new_empty(world * k)
    all_gather_into(all_vals, vals, group)
    all_idx = idx.new_empty(world * k)
    all_gather_into(all_idx, idx.contiguous(), group)
    out = torch.zeros_like(acc).index_add_(0, all_idx, all_vals)
    return out.reshape(grad.shape), new_r
