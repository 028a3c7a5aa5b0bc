"""Image-layout ops of ``paddle_tpu.ops.misc_ops`` (reference
``space_to_depth_op.cc``): only ``space_to_depth`` so far, which the
space-to-depth ResNet stem uses. The rest of the module is not ported yet
(ROADMAP A12)."""
from __future__ import annotations

from ..core.registry import ROWS, register_op
from .common import one


@register_op("space_to_depth", dp=ROWS)
def _space_to_depth(ctx, inputs, attrs):
    """[N, C, H, W] -> [N, C·bs², H/bs, W/bs]: each bs×bs spatial block
    into channels, block row and column outermost (the JAX package's
    order)."""
    (x,) = inputs["X"]
    bs = int(attrs["blocksize"])
    n, c, h, w = x.shape
    out = x.reshape(n, c, h // bs, bs, w // bs, bs)
    out = out.permute(0, 3, 5, 1, 2, 4)
    return one(out.reshape(n, c * bs * bs, h // bs, w // bs))
