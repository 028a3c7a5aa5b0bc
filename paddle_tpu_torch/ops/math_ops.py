"""Elementwise + linear-algebra ops (counterpart of
``paddle_tpu.ops.math_ops``; reference ``operators/elementwise/``,
``matmul_op.cc``, ``mul_op.cc``, ``scale_op.cc``, ``sum_op.cc``,
``clip_op.cc``, ``clip_by_norm_op.cc``, ``squared_l2_norm_op.cc``)."""
from __future__ import annotations

import math

import torch

from ..core.mesh_step import batch_group
from ..core.registry import GLOBAL, P, ROWS, TP, register_op, same_layout
from ..parallel.collective import psum
from .common import bcast_y, one


def _elementwise_tp(attrs, lay, shapes, n):
    """X and Y sliced along the same dim (Y aligned to X at ``axis``), or
    a sliced X with a replicated Y: Y broadcast along that dim, or taken
    as this rank's slice when it spans it."""
    (dx,), (dy,) = lay["X"], lay["Y"]
    xs, ys = shapes["X"][0], shapes["Y"][0]
    axis = attrs.get("axis", -1)
    off = len(xs) - len(ys) if axis == -1 or len(xs) == len(ys) else axis
    if dx is None:
        return None
    if dy is not None:
        return TP(out={"Out": dx}) if dy + off == dx else None
    j = dx - off
    if not 0 <= j < len(ys) or ys[j] == 1:
        return TP(out={"Out": dx})
    if ys[j] == xs[dx] * n:
        return TP(out={"Out": dx}, slice_in={"Y": j})
    return None


def _elementwise(name, fn):
    @register_op(name, dp=ROWS, tp=_elementwise_tp, sp=_elementwise_tp)
    def _impl(ctx, inputs, attrs, _fn=fn):
        (x,) = inputs["X"]
        (y,) = inputs["Y"]
        return one(_fn(x, bcast_y(x, y, attrs.get("axis", -1))))
    return _impl


_elementwise("elementwise_add", torch.add)
_elementwise("elementwise_sub", torch.sub)
_elementwise("elementwise_mul", torch.mul)
_elementwise("elementwise_div", torch.div)
_elementwise("elementwise_min", torch.minimum)
_elementwise("elementwise_max", torch.maximum)
_elementwise("elementwise_pow", torch.pow)
# jnp.mod / jnp.floor_divide follow Python's sign rule, as torch's do
_elementwise("elementwise_mod", torch.remainder)
_elementwise("elementwise_floordiv", torch.floor_divide)


@register_op("scale", dp=ROWS, tp=same_layout, sp=same_layout)
def _scale(ctx, inputs, attrs):
    (x,) = inputs["X"]
    scale = attrs.get("scale", 1.0)
    bias = attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        return one(x * scale + bias)
    return one((x + bias) * scale)


def _matmul_dp(attrs, sharded):
    """Row by row when every batch-sharded operand's dim 0 stays dim 0 of
    the product: a batch dim of a batched product, or the rows of an
    untransposed 2-D X. A 2-D Y's dim 0 is contracted."""
    x, y = sharded.get("X"), sharded.get("Y")
    if y is not None and y < 3:
        return None
    if x is not None and x < 3 and (x < 2 or attrs.get("transpose_X")):
        return None
    return ROWS


def _matmul_tp(attrs, lay, shapes, n):
    """Megatron's two products on a 2-D Y (column parallel: R × S(out) →
    S(last); row parallel: S(last) × S(in) → P), and batched products
    sliced along one batch dim of both operands (attention on this rank's
    heads)."""
    (dx,), (dy,) = lay["X"], lay["Y"]
    xs, ys = shapes["X"][0], shapes["Y"][0]
    tx, ty = attrs.get("transpose_X", False), attrs.get("transpose_Y", False)
    if len(ys) == 2 and len(xs) >= 2:
        col, row = (0, 1) if ty else (1, 0)
        if dx is None and dy == col:
            return TP(out={"Out": len(xs) - 1})
        if dy == row and dx == len(xs) - 1 and not tx:
            return TP(out={"Out": P})
        if dy is None and dx is not None and dx < len(xs) - 2:
            return TP(out={"Out": dx})
        return None
    if (len(xs) == len(ys) >= 3 and dx is not None and dx == dy
            and dx < len(xs) - 2):
        return TP(out={"Out": dx})
    return None


@register_op("matmul", dp=_matmul_dp, tp=_matmul_tp)
def _matmul(ctx, inputs, attrs):
    """matmul_op.cc semantics: optional transpose flags + alpha, batched via
    leading dims."""
    (x,) = inputs["X"]
    (y,) = inputs["Y"]
    tx, ty = attrs.get("transpose_X", False), attrs.get("transpose_Y", False)
    alpha = attrs.get("alpha", 1.0)
    if x.ndim == 1:
        x = x[None, :]
    if y.ndim == 1:
        y = y[:, None]
    if tx:
        x = x.transpose(-1, -2)
    if ty:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    if alpha != 1.0:
        out = out * alpha
    return one(out)


def _mul_tp(attrs, lay, shapes, n):
    """Megatron's column- and row-parallel products of a 2-D Y, and a Y
    applied to X sliced along a dim it keeps (a row dim)."""
    (dx,), (dy,) = lay["X"], lay["Y"]
    xs, ys = shapes["X"][0], shapes["Y"][0]
    xnc = attrs.get("x_num_col_dims", 1)
    if len(ys) != 2 or attrs.get("y_num_col_dims", 1) != 1:
        return None
    if dx is None and dy == 1:
        return TP(out={"Out": xnc})
    if dy == 0 and dx == len(xs) - 1 and xnc == len(xs) - 1:
        return TP(out={"Out": P})
    if dy is None and dx is not None and dx < xnc:
        return TP(out={"Out": dx})
    return None


def _mul_sp(attrs, lay, shapes, n):
    """A replicated 2-D Y applied to X sliced along a dim it keeps (the
    sequence dim of [B, T, H] activations)."""
    (dx,), (dy,) = lay["X"], lay["Y"]
    if (len(shapes["Y"][0]) == 2 and attrs.get("y_num_col_dims", 1) == 1
            and dy is None and dx is not None
            and dx < attrs.get("x_num_col_dims", 1)):
        return TP(out={"Out": dx})
    return None


@register_op("mul", dp=lambda a, s: None if "Y" in s else ROWS, tp=_mul_tp,
             sp=_mul_sp)
def _mul(ctx, inputs, attrs):
    """mul_op.cc: flatten X to 2-D at x_num_col_dims, Y at y_num_col_dims,
    then gemm; output keeps X's leading dims."""
    (x,) = inputs["X"]
    (y,) = inputs["Y"]
    xnc = attrs.get("x_num_col_dims", 1)
    ync = attrs.get("y_num_col_dims", 1)
    x2 = x.reshape(-1, math.prod(x.shape[xnc:]))
    y2 = y.reshape(math.prod(y.shape[:ync]), -1)
    out = torch.matmul(x2, y2)
    return one(out.reshape(tuple(x.shape[:xnc]) + tuple(y.shape[ync:])))


def _sum_tp(attrs, lay, shapes, n):
    dims = set(lay["X"])
    return TP(out={"Out": dims.pop()}) if len(dims) == 1 else None


@register_op("sum", dp=ROWS, tp=_sum_tp, sp=_sum_tp)
def _sum(ctx, inputs, attrs):
    xs = inputs["X"]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return one(out)


@register_op("clip", dp=ROWS, tp=same_layout)
def _clip(ctx, inputs, attrs):
    (x,) = inputs["X"]
    return one(torch.clamp(x, attrs.get("min"), attrs.get("max")))


def _sum_squares(ctx, x):
    """sum(x²): on a batch-sharded x, the global sum (a psum over the data
    axis)."""
    sq = torch.sum(x * x)
    dp = batch_group(ctx, "X")
    return sq if dp is None else psum(sq, dp)


# the norm is the whole batch's (a collective inside); the rows scale by it
@register_op("clip_by_norm", dp=ROWS)
def _clip_by_norm(ctx, inputs, attrs):
    (x,) = inputs["X"]
    max_norm = attrs["max_norm"]
    norm = torch.sqrt(_sum_squares(ctx, x))
    return one(torch.where(norm > max_norm, x * (max_norm / norm), x))


@register_op("squared_l2_norm", dp=GLOBAL)
def _squared_l2_norm(ctx, inputs, attrs):
    (x,) = inputs["X"]
    return one(_sum_squares(ctx, x).reshape((1,)))


def _unary(name, fn):
    @register_op(name, dp=ROWS)
    def _impl(ctx, inputs, attrs, _fn=fn):
        (x,) = inputs["X"]
        return one(_fn(x))
    return _impl


_unary("sqrt", torch.sqrt)
_unary("square", torch.square)
_unary("sign", torch.sign)
