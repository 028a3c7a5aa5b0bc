"""Comparison and logical ops (counterpart of ``paddle_tpu.ops.compare_ops``;
reference operators/controlflow/compare_op.cc, logical_op.cc)."""
from __future__ import annotations

import torch

from ..core.registry import ROWS, register_op
from .common import bcast_y, one
from .math_ops import _elementwise_tp


def _cmp(name, fn):
    @register_op(name, differentiable=False, dp=ROWS, sp=_elementwise_tp)
    def _impl(ctx, inputs, attrs, _fn=fn):
        (x,) = inputs["X"]
        (y,) = inputs["Y"]
        return one(_fn(x, bcast_y(x, y, attrs.get("axis", -1))))
    return _impl


_cmp("equal", torch.eq)
_cmp("not_equal", torch.ne)
_cmp("less_than", torch.lt)
_cmp("less_equal", torch.le)
_cmp("greater_than", torch.gt)
_cmp("greater_equal", torch.ge)
_cmp("logical_and", torch.logical_and)
_cmp("logical_or", torch.logical_or)
_cmp("logical_xor", torch.logical_xor)


@register_op("logical_not", differentiable=False, dp=ROWS)
def _logical_not(ctx, inputs, attrs):
    (x,) = inputs["X"]
    return one(torch.logical_not(x))
