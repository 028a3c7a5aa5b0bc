"""Operator overloading on static-graph Variable: the port's copy of
``paddle_tpu.layers.math_op_patch`` (reference
python/paddle/fluid/layers/math_op_patch.py). `monkey_patch_variable`
attaches __add__/__sub__/... to Variable so `a - b`, `x * 2.0`, `x < y`
build elementwise ops in the **current** block (sub-blocks included).

Delegates to the layer wrappers (layers/ops.py elementwise/compare layers,
layers/nn.py matmul), so block selection, stop_gradient marking and shape
inference stay in one place. The static dtype of a mixed-dtype result
follows ``core.dtypes.promote_types``, the JAX package's rule.
"""
from __future__ import annotations

import numpy as np

from ..core.dtypes import dtype_str, is_floating as _is_float, promote_types
from ..core.program import Variable


def _scalar_to_var(value, dtype):
    from . import tensor as tensor_layers
    out = tensor_layers.fill_constant(shape=[1], dtype=dtype_str(dtype),
                                      value=float(value))
    out.stop_gradient = True
    return out


def _coerce(other, ref: Variable):
    if isinstance(other, Variable):
        return other
    if isinstance(other, (int, float, np.floating, np.integer)):
        dtype = ref.dtype
        # int_var / 2 and int_var ** -1 produce floats at runtime; keep the
        # static dtype honest (newer reference math_op_patch does the same)
        if isinstance(other, (float, np.floating)) and not _is_float(dtype):
            dtype = "float32"
        return _scalar_to_var(other, dtype)
    raise TypeError(f"cannot combine Variable with {type(other)!r}")


def _broadcast_shape(x, y):
    """numpy broadcast rules, tolerating -1 (unknown batch) dims."""
    if x.shape is None or y.shape is None:
        return None
    xs, ys = tuple(x.shape), tuple(y.shape)
    try:
        shape = list(np.broadcast_shapes(
            tuple(1 if d == -1 else d for d in xs),
            tuple(1 if d == -1 else d for d in ys)))
    except ValueError:
        return None
    n = len(shape)
    for src in (xs, ys):
        for i, d in enumerate(src):
            if d == -1:
                shape[n - len(src) + i] = -1
    return tuple(shape)


def _binary(op_type, reverse=False):
    def fn(self: Variable, other):
        try:
            other = _coerce(other, self)
        except TypeError:
            return NotImplemented
        x, y = (other, self) if reverse else (self, other)
        if op_type == "elementwise_div" and not _is_float(x.dtype):
            from . import tensor as tensor_layers
            x = tensor_layers.cast(x, "float32")
            if not _is_float(y.dtype):
                y = tensor_layers.cast(y, "float32")
        from . import ops as ops_layers
        out = getattr(ops_layers, op_type)(x, y)
        out.shape = _broadcast_shape(x, y)
        # mixed-dtype operands promote at runtime; keep the static dtype in
        # sync so dtype-keyed feeds/casts don't truncate
        out.dtype = promote_types(x.dtype, y.dtype)
        return out
    fn.__name__ = f"__{op_type}__"
    return fn


def _compare(op_type):
    # no reverse form: Python itself reflects comparisons by swapping operands
    def fn(self: Variable, other):
        try:
            other = _coerce(other, self)
        except TypeError:
            return NotImplemented
        from . import ops as ops_layers
        return getattr(ops_layers, op_type)(self, other)
    fn.__name__ = f"__{op_type}__"
    return fn


def _neg(self: Variable):
    from . import ops as ops_layers
    return ops_layers.scale(self, scale=-1.0)


def _matmul(self: Variable, other):
    from . import nn as nn_layers
    try:
        other = _coerce(other, self)
    except TypeError:
        return NotImplemented
    return nn_layers.matmul(self, other)


def monkey_patch_variable():
    Variable.__add__ = _binary("elementwise_add")
    Variable.__radd__ = _binary("elementwise_add", reverse=True)
    Variable.__sub__ = _binary("elementwise_sub")
    Variable.__rsub__ = _binary("elementwise_sub", reverse=True)
    Variable.__mul__ = _binary("elementwise_mul")
    Variable.__rmul__ = _binary("elementwise_mul", reverse=True)
    Variable.__truediv__ = _binary("elementwise_div")
    Variable.__rtruediv__ = _binary("elementwise_div", reverse=True)
    Variable.__pow__ = _binary("elementwise_pow")
    Variable.__rpow__ = _binary("elementwise_pow", reverse=True)
    Variable.__mod__ = _binary("elementwise_mod")
    Variable.__rmod__ = _binary("elementwise_mod", reverse=True)
    Variable.__floordiv__ = _binary("elementwise_floordiv")
    Variable.__rfloordiv__ = _binary("elementwise_floordiv", reverse=True)
    Variable.__neg__ = _neg
    Variable.__matmul__ = _matmul
    # comparisons build boolean ops; __eq__/__ne__ stay Python identity so
    # Variables remain hashable / usable as dict keys
    Variable.__lt__ = _compare("less_than")
    Variable.__le__ = _compare("less_equal")
    Variable.__gt__ = _compare("greater_than")
    Variable.__ge__ = _compare("greater_equal")


monkey_patch_variable()
