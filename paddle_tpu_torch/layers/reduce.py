"""Reduce layers (counterpart of ``paddle_tpu.layers.reduce``; reference
layers/nn.py reduce_* family)."""
from __future__ import annotations

from ..layer_helper import LayerHelper


def _reduce_layer(op_type, input, dim=None, keep_dim=False, name=None):
    helper = LayerHelper(op_type, name=name)
    shape = None
    if dim is None:
        attrs = {"reduce_all": True, "keep_dim": keep_dim}
        if input.shape is not None:
            # runtime truth: full reduce without keep_dim yields a scalar
            shape = [1] * len(input.shape) if keep_dim else []
    else:
        dims = dim if isinstance(dim, (list, tuple)) else [dim]
        attrs = {"dim": list(dims), "keep_dim": keep_dim, "reduce_all": False}
        if input.shape is not None:
            nd = len(input.shape)
            axes = {d % nd for d in dims}
            if keep_dim:
                shape = [1 if i in axes else s
                         for i, s in enumerate(input.shape)]
            else:
                shape = [s for i, s in enumerate(input.shape)
                         if i not in axes]
    out = helper.create_variable_for_type_inference(input.dtype, shape=shape)
    helper.append_op(type=op_type, inputs={"X": [input.name]},
                     outputs={"Out": [out.name]}, attrs=attrs)
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_sum", input, dim, keep_dim, name)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_mean", input, dim, keep_dim, name)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_max", input, dim, keep_dim, name)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_min", input, dim, keep_dim, name)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_prod", input, dim, keep_dim, name)


def reduce_all(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_all", input, dim, keep_dim, name)


def reduce_any(input, dim=None, keep_dim=False, name=None):
    return _reduce_layer("reduce_any", input, dim, keep_dim, name)
