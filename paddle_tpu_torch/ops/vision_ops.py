"""Vision ops of ``paddle_tpu.ops.vision_ops`` (reference
conv_transpose_op.cc): ``conv3d_transpose``, which the dygraph layer zoo
traces. The rest of the module is not ported yet (ROADMAP A12)."""
from __future__ import annotations

from ..core.registry import ROWS, register_op
from .common import one
from .nn_ops import conv_transpose_nd


@register_op("conv3d_transpose", dp=ROWS)
def _conv3d_transpose(ctx, inputs, attrs):
    """conv_transpose_op.cc 3-D case, through conv2d_transpose's core
    (output_size → trailing output padding included)."""
    (x,) = inputs["Input"]
    (w,) = inputs["Filter"]        # [C_in, C_out/groups, D, H, W]
    return one(conv_transpose_nd(x, w, attrs, 3))
