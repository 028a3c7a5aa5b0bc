"""Tensor manipulation + creation ops (counterpart of
``paddle_tpu.ops.tensor_ops``; reference reshape_op.cc, transpose_op.cc,
concat_op.cc, slice_op.cc, split_op.cc, unsqueeze_op.cc, gather_op.cc, cast_op.cc, assign_op.cc,
fill_constant_op.cc, assign_value_op.cc and the random initializer ops).

The random ops draw from the run's seeded ``torch.Generator``
(``ctx.rng()``); the same seed gives other numbers than the JAX package's
PRNG keys, so parity checks copy the initialized scope instead.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.dtypes import convert_dtype
from ..core.registry import ROWS, TP, register_op, same_layout
from .common import one


def _not_dim0(*axes):
    """A ``dp`` declaration (``core/registry.py``): row by row unless one of
    `axes` (attrs -> axes, given the sharded input's ndim) is dim 0."""
    def dp(attrs, sharded):
        ndim = max(sharded.values())
        return None if any(int(a) % max(ndim, 1) == 0
                           for a in axes[0](attrs, ndim)) else ROWS
    return dp


def _reshape_tp(attrs, lay, shapes, n):
    """A slice of dim d stays a slice when d leads the input dims that
    become one group of output dims, and that group's leading dim divides
    over the axis (the head split [B, T, H] → [B, T, nh, hd] and the head
    merge back). The shape attribute becomes this rank's."""
    import math

    (d,) = lay["X"]
    xs = list(shapes["X"][0])
    xs[d] *= n
    want = list(attrs["shape"])
    out = [xs[i] if s == 0 else s for i, s in enumerate(want)]
    if -1 in out:
        known = math.prod(s for s in out if s != -1)
        out[out.index(-1)] = math.prod(xs) // known
    before = math.prod(xs[:d])
    k = next((i for i in range(len(out))
              if math.prod(out[:i]) == before and out[i] > 1), None)
    # a copied dim (0) must be the sliced one where it sits
    if k is None or out[k] % n or (d < len(want) and want[d] == 0
                                   and d != k) or (want[k] == 0 and k != d):
        return None
    local = list(want)
    if want[k] > 0:
        local[k] = want[k] // n
    return TP(out={"Out": k}, attrs={"shape": local})


# a shape whose dim 0 is copied (0) or inferred (-1) keeps each rank's rows
# at the front: the ranks' results laid end to end are the global reshape
@register_op("reshape", dp=lambda a, s: ROWS if a["shape"][0] in (0, -1)
             else None, tp=_reshape_tp)
def _reshape(ctx, inputs, attrs):
    (x,) = inputs["X"]
    # paddle rule: 0 means copy input dim at that position; -1 infers
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(attrs["shape"])]
    return one(x.reshape(shape))


@register_op("transpose", dp=lambda a, s: ROWS
             if int(a["axis"][0]) % s["X"] == 0 else None,
             tp=lambda a, lay, sh, n: TP(out={"Out": [int(x) for x in a[
                 "axis"]].index(lay["X"][0])}))
def _transpose(ctx, inputs, attrs):
    (x,) = inputs["X"]
    return one(x.permute(*attrs["axis"]))


@register_op("concat", dp=_not_dim0(lambda a, n: [a.get("axis", 0)]))
def _concat(ctx, inputs, attrs):
    return one(torch.cat(inputs["X"], dim=attrs.get("axis", 0)))


@register_op("slice", dp=_not_dim0(lambda a, n: a["axes"]))
def _slice(ctx, inputs, attrs):
    """slice_op.cc: [start, end) along each of `axes`; negative bounds
    count from the end and both are clamped to the dim."""
    (x,) = inputs["Input"]
    idx = [slice(None)] * x.ndim
    for a, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        dim = x.shape[a]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[a] = slice(s, e)
    return one(x[tuple(idx)])


def _split_tp(attrs, lay, shapes, n):
    """A split along another dim keeps the slice in every output. A split
    along the sliced dim (BERT's fused qkv: its column slice holds whole
    heads of q but not of k and v) gathers X whole and gives each output's
    slice of that dim to this rank: every output then holds this rank's
    heads."""
    (d,) = lay["X"]
    axis = attrs.get("axis", 0) % len(shapes["X"][0])
    k = len(attrs.get("sections") or ()) or attrs.get("num", 0)
    if axis != d:
        return TP(out={"Out": [d] * k})
    return TP(regather={"X": d})


@register_op("split", dp=_not_dim0(lambda a, n: [a.get("axis", 0)]),
             tp=_split_tp, sp=_split_tp)
def _split(ctx, inputs, attrs):
    """Outputs are views of X: the flash-attention kernel reads the q/k/v
    thirds of the fused qkv projection through their strides."""
    (x,) = inputs["X"]
    axis = attrs.get("axis", 0)
    sections = attrs.get("sections")
    if sections:
        return {"Out": list(torch.split(x, list(sections), dim=axis))}
    num = attrs.get("num", 0)
    if x.shape[axis] % num:
        raise ValueError(f"split: dim {axis} of size {x.shape[axis]} does "
                         f"not divide into {num} equal parts")
    return {"Out": list(torch.split(x, x.shape[axis] // num, dim=axis))}


def _unsqueeze_sp(attrs, lay, shapes, n):
    """A sliced dim moves past the new axes inserted at or before it."""
    (d,) = lay["X"]
    nd = len(shapes["X"][0]) + len(attrs["axes"])
    for a in sorted(int(x) % nd for x in attrs["axes"]):
        if a <= d:
            d += 1
    return TP(out={"Out": d})


# row by row unless a new axis lands at dim 0 (the axes count in the
# output's dims)
@register_op("unsqueeze", dp=lambda a, s: None if any(
    int(x) % (max(s.values()) + len(a["axes"])) == 0 for x in a["axes"])
    else ROWS, sp=_unsqueeze_sp)
def _unsqueeze(ctx, inputs, attrs):
    (x,) = inputs["X"]
    out = x
    for a in sorted(attrs["axes"]):
        out = out.unsqueeze(a)
    return one(out)


def _gather_dp(attrs, sharded):
    """Rows of a non-batch X picked by batch ids (axis 0), or a batch X
    gathered along another axis."""
    if "X" in sharded:
        return None if attrs.get("axis", 0) % sharded["X"] == 0 else ROWS
    return ROWS if attrs.get("axis", 0) == 0 else None


@register_op("gather", nondiff_inputs=["Index"], dp=_gather_dp)
def _gather(ctx, inputs, attrs):
    """Rows of X at Index (an [N, 1] index is squeezed to [N]). XLA clamps
    an out-of-range index silently; torch raises. The NMT model sizes its
    position table to cover the longest row, so neither happens there."""
    (x,) = inputs["X"]
    (index,) = inputs["Index"]
    idx = index[..., 0] if index.ndim == 2 and index.shape[-1] == 1 else index
    axis = attrs.get("axis", 0) % x.ndim
    rows = torch.index_select(x, axis, idx.reshape(-1).long())
    return one(rows.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:]))


@register_op("cast", dp=ROWS, tp=same_layout, sp=same_layout)
def _cast(ctx, inputs, attrs):
    (x,) = inputs["X"]
    return one(x.to(convert_dtype(attrs["out_dtype"])))


@register_op("assign", dp=ROWS, tp=same_layout, sp=same_layout)
def _assign(ctx, inputs, attrs):
    (x,) = inputs["X"]
    return one(x)


@register_op("pad", dp=lambda a, s: None if any(a["paddings"][:2])
             else ROWS)
def _pad(ctx, inputs, attrs):
    """pad_op.cc: constant padding, [before, after] per dim in order."""
    (x,) = inputs["X"]
    p = attrs["paddings"]
    flat = []
    for i in reversed(range(x.ndim)):  # F.pad lists the last dim first
        flat += [p[2 * i], p[2 * i + 1]]
    return one(F.pad(x, flat, value=attrs.get("pad_value", 0.0)))


@register_op("pad2d", dp=ROWS)
def _pad2d(ctx, inputs, attrs):
    """pad2d_op.cc: [top, bottom, left, right] of an NCHW x; constant,
    reflect (no edge repeat) or edge."""
    (x,) = inputs["X"]
    t, b, l, r = attrs["paddings"]
    mode = attrs.get("mode", "constant")
    if mode == "constant":
        return one(F.pad(x, [l, r, t, b], value=attrs.get("pad_value", 0.0)))
    tmode = {"reflect": "reflect", "edge": "replicate"}[mode]
    return one(F.pad(x, [l, r, t, b], mode=tmode))


@register_op("fill_constant", differentiable=False)
def _fill_constant(ctx, inputs, attrs):
    dtype = convert_dtype(attrs.get("dtype", "float32"))
    return one(torch.full(list(attrs.get("shape", [1])),
                          attrs.get("value", 0.0), dtype=dtype,
                          device=ctx.device))


@register_op("assign_value", differentiable=False)
def _assign_value(ctx, inputs, attrs):
    dtype = convert_dtype(attrs.get("dtype", "float32"))
    values = np.asarray(attrs["values"]).reshape(attrs["shape"])
    return one(torch.as_tensor(values, device=ctx.device).to(dtype))


def _rand_shape(attrs):
    return [int(s) for s in attrs["shape"]]


@register_op("uniform_random", differentiable=False)
def _uniform_random(ctx, inputs, attrs):
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    u = torch.rand(_rand_shape(attrs), generator=ctx.rng(), device=ctx.device)
    return one((lo + (hi - lo) * u).to(convert_dtype(attrs.get("dtype",
                                                               "float32"))))


@register_op("gaussian_random", differentiable=False)
def _gaussian_random(ctx, inputs, attrs):
    mean, std = attrs.get("mean", 0.0), attrs.get("std", 1.0)
    r = torch.randn(_rand_shape(attrs), generator=ctx.rng(), device=ctx.device)
    return one((mean + std * r).to(convert_dtype(attrs.get("dtype",
                                                           "float32"))))


@register_op("truncated_gaussian_random", differentiable=False)
def _truncated_gaussian_random(ctx, inputs, attrs):
    """Normal truncated to [-2, 2] standard deviations (the bounds
    jax.random.truncated_normal(-2, 2) gives the JAX package), drawn by
    inverting the normal CDF over the kept interval."""
    mean, std = attrs.get("mean", 0.0), attrs.get("std", 1.0)
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(_rand_shape(attrs), generator=ctx.rng(), device=ctx.device)
    p = lo + (1.0 - 2.0 * lo) * u
    r = (math.sqrt(2.0) * torch.erfinv(2.0 * p - 1.0)).clamp(-2.0, 2.0)
    return one((mean + std * r).to(convert_dtype(attrs.get("dtype",
                                                           "float32"))))
