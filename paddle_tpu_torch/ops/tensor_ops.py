"""Tensor manipulation + creation ops (counterpart of
``paddle_tpu.ops.tensor_ops``; reference reshape_op.cc, transpose_op.cc,
split_op.cc, unsqueeze_op.cc, gather_op.cc, cast_op.cc, assign_op.cc,
fill_constant_op.cc, assign_value_op.cc and the random initializer ops).

The random ops draw from the run's seeded ``torch.Generator``
(``ctx.rng()``); the same seed gives other numbers than the JAX package's
PRNG keys, so parity checks copy the initialized scope instead.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.dtypes import convert_dtype
from ..core.registry import register_op
from .common import one


@register_op("reshape")
def _reshape(ctx, inputs, attrs):
    (x,) = inputs["X"]
    # paddle rule: 0 means copy input dim at that position; -1 infers
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(attrs["shape"])]
    return one(x.reshape(shape))


@register_op("transpose")
def _transpose(ctx, inputs, attrs):
    (x,) = inputs["X"]
    return one(x.permute(*attrs["axis"]))


@register_op("split")
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


@register_op("unsqueeze")
def _unsqueeze(ctx, inputs, attrs):
    (x,) = inputs["X"]
    out = x
    for a in sorted(attrs["axes"]):
        out = out.unsqueeze(a)
    return one(out)


@register_op("gather", nondiff_inputs=["Index"])
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


@register_op("cast")
def _cast(ctx, inputs, attrs):
    (x,) = inputs["X"]
    return one(x.to(convert_dtype(attrs["out_dtype"])))


@register_op("assign")
def _assign(ctx, inputs, attrs):
    (x,) = inputs["X"]
    return one(x)


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
