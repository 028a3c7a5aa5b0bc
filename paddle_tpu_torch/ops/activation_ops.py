"""Activation ops (counterpart of ``paddle_tpu.ops.activation_ops``;
reference ``operators/activation_op.cc``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.registry import ROWS, TP, Whole, register_op, same_layout
from .common import one


def _act(name, fn):
    @register_op(name, dp=ROWS, tp=same_layout, sp=same_layout)
    def _impl(ctx, inputs, attrs, _fn=fn):
        (x,) = inputs["X"]
        return one(_fn(x, attrs))
    return _impl


def _gelu(x, a):
    # erf form unless approximate (jax.nn.gelu(approximate=False) parity)
    return F.gelu(x, approximate="tanh" if a.get("approximate", False)
                  else "none")


_act("relu", lambda x, a: torch.relu(x))
_act("sigmoid", lambda x, a: torch.sigmoid(x))
_act("tanh", lambda x, a: torch.tanh(x))
_act("softplus", lambda x, a: F.softplus(x))
_act("softsign", lambda x, a: F.softsign(x))
_act("relu6", lambda x, a: torch.clamp(x, 0.0, a.get("threshold", 6.0)))
_act("leaky_relu", lambda x, a: F.leaky_relu(x, a.get("alpha", 0.02)))
_act("elu", lambda x, a: F.elu(x, a.get("alpha", 1.0)))
_act("gelu", _gelu)
_act("swish", lambda x, a: x * torch.sigmoid(a.get("beta", 1.0) * x))
_act("logsigmoid", lambda x, a: F.logsigmoid(x))
_act("silu", lambda x, a: F.silu(x))


def _softmax_tp(attrs, lay, shapes, n):
    """A slice along another dim than the softmax's keeps its layout."""
    (d,) = lay["X"]
    return None if attrs.get("axis", -1) % len(shapes["X"][0]) == d \
        else TP(out={"Out": d})


# along dim 0 on a data axis: over the whole batch, each rank keeping its
# rows of the result (core/registry.py's Whole)
@register_op("softmax", dp=lambda a, s: Whole(rows=("Out",))
             if a.get("axis", -1) % s["X"] == 0 else ROWS, tp=_softmax_tp)
def _softmax(ctx, inputs, attrs):
    (x,) = inputs["X"]
    return one(torch.softmax(x, dim=attrs.get("axis", -1)))
