"""Ops of ``paddle_tpu.ops.misc_ops`` (reference ``space_to_depth_op.cc``,
``bilinear_tensor_product_op.cc``, ``row_conv_op.cc``,
``spectral_norm_op.h``): ``space_to_depth``, which the space-to-depth
ResNet stem uses, and the three the dygraph layer zoo traces. The rest of
the module is not ported yet (ROADMAP A12)."""
from __future__ import annotations

import torch

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


@register_op("bilinear_tensor_product", dp=ROWS)
def _bilinear_tensor_product(ctx, inputs, attrs):
    """out[b, k] = x[b]·W_k·y[b] (+ bias)."""
    (x,) = inputs["X"]
    (y,) = inputs["Y"]
    (w,) = inputs["Weight"]
    out = torch.einsum("bi,kij,bj->bk", x, w, y)
    bias = inputs.get("Bias")
    if bias:
        out = out + bias[0]
    return one(out)


@register_op("row_conv", dp=ROWS)
def _row_conv(ctx, inputs, attrs):
    """row_conv_op.cc (lookahead conv, batch-major [B, T, D] redesign of
    the LoD form): out[t] = Σ_{i<future_len} x[t+i]·w[i]."""
    (x,) = inputs["X"]
    (w,) = inputs["Filter"]          # [future_len, D]
    fl = w.shape[0]
    b, t, d = x.shape
    pad = torch.cat([x, x.new_zeros((b, fl - 1, d))], dim=1)
    out = sum(pad[:, i:i + t] * w[i][None, None, :] for i in range(fl))
    return one(out)


@register_op("spectral_norm")
def _spectral_norm(ctx, inputs, attrs):
    """spectral_norm_op.h: weight / sigma_max, sigma from `power_iters`
    steps of power iteration from U and V (no gradient through them)."""
    (w,) = inputs["Weight"]
    (u,) = inputs["U"]
    (v,) = inputs["V"]
    dim = attrs.get("dim", 0)
    iters = attrs.get("power_iters", 1)
    eps = attrs.get("eps", 1e-12)
    wm = torch.movedim(w, dim, 0).reshape(w.shape[dim], -1)
    uu, vv = u.reshape(-1), v.reshape(-1)
    with torch.no_grad():
        for _ in range(max(iters, 0)):
            vv = wm.T @ uu
            vv = vv / (torch.linalg.norm(vv) + eps)
            uu = wm @ vv
            uu = uu / (torch.linalg.norm(uu) + eps)
    sigma = uu.detach() @ wm @ vv.detach()
    return one(w / sigma)
