"""Reduction ops (counterpart of ``paddle_tpu.ops.reduce_ops``; reference
operators/reduce_ops/, mean_op.cc)."""
from __future__ import annotations

import torch

from ..core.registry import register_op
from .common import one


def _reduce(name, fn):
    @register_op(name)
    def _impl(ctx, inputs, attrs, _fn=fn):
        (x,) = inputs["X"]
        keep = attrs.get("keep_dim", False)
        if attrs.get("reduce_all", False):
            out = _fn(x)
            return one(out.reshape((1,) * x.ndim) if keep else out)
        dim = attrs.get("dim", [0])
        dim = tuple(dim) if isinstance(dim, (list, tuple)) else (dim,)
        return one(_fn(x, dim=dim, keepdim=keep))
    return _impl


_reduce("reduce_sum", torch.sum)
_reduce("reduce_mean", torch.mean)


@register_op("mean")
def _mean(ctx, inputs, attrs):
    (x,) = inputs["X"]
    return one(torch.mean(x))
