"""Operator overloading on VarBase (the port's counterpart of
``paddle_tpu.dygraph.math_ops_patch``; reference layers/math_op_patch.py,
applied to dygraph vars). A Python scalar operand becomes a 0-d tensor of
the other operand's dtype on its device."""
from __future__ import annotations

import torch

from .varbase import VarBase


def _to_var(other, ref: VarBase) -> VarBase:
    if isinstance(other, VarBase):
        return other
    t = torch.tensor(other, dtype=ref.value.dtype, device=ref.value.device)
    return VarBase(t, stop_gradient=True)


def _binary(op_type, reverse=False):
    def fn(self, other):
        from .tracer import trace_op
        other = _to_var(other, self)
        x, y = (other, self) if reverse else (self, other)
        return trace_op(op_type, {"X": [x], "Y": [y]}, {"axis": -1})["Out"][0]
    return fn


def _matmul(self, other):
    from .tracer import trace_op
    return trace_op("matmul", {"X": [self], "Y": [_to_var(other, self)]},
                    {})["Out"][0]


VarBase.__add__ = _binary("elementwise_add")
VarBase.__radd__ = _binary("elementwise_add", reverse=True)
VarBase.__sub__ = _binary("elementwise_sub")
VarBase.__rsub__ = _binary("elementwise_sub", reverse=True)
VarBase.__mul__ = _binary("elementwise_mul")
VarBase.__rmul__ = _binary("elementwise_mul", reverse=True)
VarBase.__truediv__ = _binary("elementwise_div")
VarBase.__rtruediv__ = _binary("elementwise_div", reverse=True)
VarBase.__pow__ = _binary("elementwise_pow")
VarBase.__mod__ = _binary("elementwise_mod")
VarBase.__floordiv__ = _binary("elementwise_floordiv")
VarBase.__neg__ = lambda self: self * -1.0
VarBase.__matmul__ = _matmul
