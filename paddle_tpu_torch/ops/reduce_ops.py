"""Reduction ops (counterpart of ``paddle_tpu.ops.reduce_ops``; reference
operators/reduce_ops/, mean_op.cc).

On a data-parallel mesh (``core/mesh_step.py``) a reduction over dim 0 of a
batch-sharded input is global: the local sums are summed over the dp
group and a mean divides by the global count, as GSPMD reduces the JAX
package's global batch."""
from __future__ import annotations

import torch

from ..core.mesh_step import batch_group
from ..core.registry import GLOBAL, P, ROWS, TP, register_op
from ..parallel.collective import axis_size, psum
from .common import one


def _reduce_dp(attrs, sharded):
    """Global when the reduction covers dim 0, else row by row."""
    if attrs.get("reduce_all", False):
        return GLOBAL
    dims = attrs.get("dim", [0])
    dims = dims if isinstance(dims, (list, tuple)) else [dims]
    return GLOBAL if any(int(d) % max(sharded["X"], 1) == 0
                         for d in dims) else ROWS


def _reduce_sp(mean: bool):
    """A sum over the sliced dim leaves each rank a summand (P); a mean
    over it gets its input whole; over other dims the slice stays."""
    def decl(attrs, lay, shapes, n):
        (d,) = lay["X"]
        nd = max(len(shapes["X"][0]), 1)
        dims = attrs.get("dim", [0])
        dims = [int(x) % nd for x in (dims if isinstance(dims, (list, tuple))
                                      else [dims])]
        if attrs.get("reduce_all", False) or d in dims:
            return None if mean else TP(out={"Out": P})
        if not attrs.get("keep_dim", False):
            d -= sum(1 for x in dims if x < d)
        return TP(out={"Out": d})
    return decl


def _reduce(name, mean: bool):
    fn = torch.mean if mean else torch.sum

    @register_op(name, dp=_reduce_dp, sp=_reduce_sp(mean))
    def _impl(ctx, inputs, attrs):
        (x,) = inputs["X"]
        keep = attrs.get("keep_dim", False)
        if attrs.get("reduce_all", False):
            dim = tuple(range(x.ndim))
        else:
            dim = attrs.get("dim", [0])
            dim = tuple(dim) if isinstance(dim, (list, tuple)) else (dim,)
        dp = batch_group(ctx, "X")
        if dp is not None and any(d % max(x.ndim, 1) == 0 for d in dim):
            out = psum(torch.sum(x, dim=dim, keepdim=keep), dp)
            if mean:
                count = x.shape[0] * axis_size(dp)
                for d in dim:
                    if d % x.ndim:
                        count *= x.shape[d]
                out = out / count
        elif attrs.get("reduce_all", False):
            out = fn(x)
            return one(out.reshape((1,) * x.ndim) if keep else out)
        else:
            out = fn(x, dim=dim, keepdim=keep)
        if attrs.get("reduce_all", False) and keep:
            out = out.reshape((1,) * x.ndim)
        return one(out)
    return _impl


_reduce("reduce_sum", mean=False)
_reduce("reduce_mean", mean=True)


@register_op("mean", dp=GLOBAL)
def _mean(ctx, inputs, attrs):
    (x,) = inputs["X"]
    dp = batch_group(ctx, "X")
    if dp is not None:
        total = psum(torch.sum(x, dtype=torch.float32), dp)
        return one((total / (x.numel() * axis_size(dp))).to(x.dtype))
    return one(torch.mean(x))
