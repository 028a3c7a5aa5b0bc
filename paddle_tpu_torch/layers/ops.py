"""Single-op layers — the subset of ``paddle_tpu.layers.ops`` the port's
ops cover (reference ``python/paddle/fluid/layers/ops.py``)."""
from __future__ import annotations

import sys

from ..layer_helper import LayerHelper


def _activation_layer(op_type, x, attrs, name=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(type=op_type, inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs=attrs or {})
    return out


def gelu(x, approximate=False, name=None):
    return _activation_layer("gelu", x, {"approximate": approximate}, name)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(type="scale", inputs={"X": [x.name]}, outputs={"Out": [out.name]},
                     attrs={"scale": scale, "bias": bias, "bias_after_scale": bias_after_scale})
    return helper.append_activation(out, act)


def _elementwise_layer(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(type=op_type, inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis})
    return helper.append_activation(out, act)


def _compare_layer(op_type, x, y, cond=None, name=None):
    helper = LayerHelper(op_type, name=name)
    out = cond if cond is not None else helper.create_variable_for_type_inference(
        "bool", x.shape, stop_gradient=True)
    helper.append_op(type=op_type, inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]}, attrs={})
    return out


_mod = sys.modules[__name__]
for _op in ["sigmoid", "tanh", "sqrt", "square", "sign"]:
    def _make(op_type):
        def layer(x, name=None):
            return _activation_layer(op_type, x, {}, name)
        layer.__name__ = op_type
        return layer
    setattr(_mod, _op, _make(_op))

for _op in ["elementwise_add", "elementwise_sub", "elementwise_mul",
            "elementwise_div", "elementwise_min", "elementwise_max",
            "elementwise_pow", "elementwise_mod", "elementwise_floordiv"]:
    def _make_ew(op_type):
        def layer(x, y, axis=-1, act=None, name=None):
            return _elementwise_layer(op_type, x, y, axis, act, name)
        layer.__name__ = op_type
        return layer
    setattr(_mod, _op, _make_ew(_op))

for _op in ["equal", "not_equal", "less_than", "less_equal", "greater_than",
            "greater_equal"]:
    def _make_cmp(op_type):
        def layer(x, y, cond=None, name=None):
            return _compare_layer(op_type, x, y, cond, name)
        layer.__name__ = op_type
        return layer
    setattr(_mod, _op, _make_cmp(_op))
