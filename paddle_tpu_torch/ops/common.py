"""Shared helpers for op implementations (counterpart of
``paddle_tpu.ops.common``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def bcast_y(x, y, axis: int = -1):
    """Paddle elementwise broadcast rule (operators/elementwise/
    elementwise_op_function.h): `y`'s shape is aligned to `x` starting at
    `axis`; axis==-1 means align trailing dims (numpy rule)."""
    if x.ndim == y.ndim or y.ndim == 0:
        return y
    if axis == -1:
        axis = x.ndim - y.ndim
    new_shape = (1,) * axis + tuple(y.shape) + (1,) * (x.ndim - axis - y.ndim)
    return y.reshape(new_shape)


def one(outs):
    return {"Out": [outs]}


def opt_input(inputs, slot):
    """Optional input slot: missing key or empty list -> None."""
    vs = inputs.get(slot) or [None]
    return vs[0]


def conv2d_nchw(x, w, strides=(1, 1), padding=(0, 0), dilations=(1, 1),
                groups: int = 1):
    """F.conv2d of an NCHW x by an OIHW w, with x kept channels-last in
    memory: cuDNN then returns a channels-last output, the layout in which
    the fused batch-norm kernels read an activation's (N·H·W, C) matrix
    without a copy. `padding` is (ph, pw) or (top, bottom, left, right).
    The conv2d op and fused_conv_bn's plain composition both call this, so
    they compute bitwise the same."""
    x = x.contiguous(memory_format=torch.channels_last)
    if len(padding) == 4:
        top, bottom, left, right = padding
        if top != bottom or left != right:
            x = F.pad(x, (left, right, top, bottom))
            padding = (0, 0)
        else:
            padding = (top, left)
    return F.conv2d(x, w, None, tuple(strides), tuple(padding),
                    tuple(dilations), groups)


def bn_batch_stats_xla1(x, axes):
    """Training batch norm's default statistics (the "xla1" mode): f32 mean
    and one-pass var = max(E[x²] − mean², 0) over `axes`."""
    xf = x.float()
    mean = torch.mean(xf, dim=axes)
    var = torch.clamp_min(torch.mean(xf * xf, dim=axes) - mean * mean, 0.0)
    return mean, var


def bn_normalize(x, mean, var, scale, bias, eps, shape):
    """((x − mean)·rsqrt(var + eps)·scale + bias) in f32, returned in x's
    dtype; the per-channel vectors are reshaped to `shape`."""
    inv = torch.rsqrt(var.float().reshape(shape) + eps)
    return ((x.float() - mean.float().reshape(shape)) * inv
            * scale.reshape(shape) + bias.reshape(shape)).to(x.dtype)


def _identity(x):
    return x


def _gelu_tanh(x):
    # jax.nn.gelu's default (approximate=True) form, which the JAX package's
    # act_map uses for fused ops
    return F.gelu(x, approximate="tanh")


# Shared activation-name → fn map (activation_op.cc functor registry), used
# by the fused ops; "" / "identity" = no-op.
def act_map():
    return {
        "": _identity,
        "identity": _identity,
        "relu": torch.relu,
        "tanh": torch.tanh,
        "sigmoid": torch.sigmoid,
        "gelu": _gelu_tanh,
    }
