"""Quantization ops (counterpart of ``paddle_tpu.ops.quant_ops``).

Reference analogs: ``paddle/fluid/operators/fake_quantize_op.cc`` (
fake_quantize_abs_max, fake_quantize_range_abs_max,
fake_quantize_moving_average_abs_max, fake_channel_wise_quantize_abs_max,
moving_average_abs_max_scale) and ``fake_dequantize_op.cc``.

The fake-quant family (quantization-aware training) keeps the quant-dequant
round trip in float and uses the straight-through estimator: the cotangent
passes through the rounding untouched. Each fake-quantize op carries the STE
as its ``grad_fn`` (applied when its input is an autodiff target) and forms
its output through `_ste`, whose backward is the identity, when autograd
records through it. The two fake-dequantize ops differentiate as the
products they are, as in the JAX package.

``quantized_fc`` and ``quantized_lookup_table`` are the REAL int8 runtime
ops that ``inference/quant.py`` rewrites a serving program into. Symmetric
scheme: x ≈ xq·sx/127 (per tensor, sx calibrated), w ≈ wq·sw/127 (per
out-channel), so x@w ≈ (xq@wq)·sx·sw/127². The int8 product runs as
``torch._int_mm`` (int8×int8→int32) on a CUDA tensor and as an exact int32
product on the CPU; the activation quantizer and the dequant factor follow
the JAX package's arithmetic order, so the int32 accumulators are bitwise
the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.registry import register_op
from .common import act_map, one, opt_input

_ACTS = act_map()


class _STE(torch.autograd.Function):
    """Forward: the quantized value; backward: the cotangent unchanged."""

    @staticmethod
    def forward(ctx, x, q):
        return q

    @staticmethod
    def backward(ctx, g):
        return g, None


def _ste(x, q):
    return _STE.apply(x, q.detach()) if x.requires_grad else q


def _quant_dequant(x, scale, bits):
    bnt = (1 << (bits - 1)) - 1
    s = torch.clamp_min(scale, 1e-8)
    return torch.round(torch.clamp(x / s, -1.0, 1.0) * bnt) / bnt * s


def _ste_grad(attrs):
    """Straight-through estimator: dX = dOut (rounding treated as id)."""
    def grad(ctx, inputs, attrs2, outputs, out_cots):
        return {"X": [out_cots["Out"][0]]}
    return grad


def _absmax(x):
    return torch.max(torch.abs(x.detach()))


@register_op("fake_quantize_abs_max", grad_fn=_ste_grad, nondiff_inputs=[])
def _fake_quantize_abs_max(ctx, inputs, attrs):
    (x,) = inputs["X"]
    bits = int(attrs.get("bit_length", 8))
    scale = _absmax(x)
    return {"Out": [_ste(x, _quant_dequant(x.detach(), scale, bits))],
            "OutScale": [scale.reshape(1)]}


@register_op("fake_channel_wise_quantize_abs_max", grad_fn=_ste_grad)
def _fake_cw_quantize_abs_max(ctx, inputs, attrs):
    (x,) = inputs["X"]
    bits = int(attrs.get("bit_length", 8))
    xd = x.detach()
    scale = (torch.amax(torch.abs(xd), dim=tuple(range(1, x.ndim)))
             if x.ndim > 1 else torch.abs(xd))
    shape = (-1,) + (1,) * (x.ndim - 1)
    return {"Out": [_ste(x, _quant_dequant(xd, scale.reshape(shape), bits))],
            "OutScale": [scale]}


@register_op("fake_quantize_moving_average_abs_max", grad_fn=_ste_grad,
             nondiff_inputs=["InScale", "InAccum", "InState"])
def _fake_quantize_ma_abs_max(ctx, inputs, attrs):
    """activation quant: scale tracked by moving average of |x|max."""
    (x,) = inputs["X"]
    (in_scale,) = inputs["InScale"]
    in_scale = in_scale.detach()
    bits = int(attrs.get("bit_length", 8))
    momentum = attrs.get("moving_rate", 0.9)
    if attrs.get("is_test", False) or ctx.is_test:
        scale = in_scale.reshape(())
        new_scale = in_scale
    else:
        scale = (momentum * in_scale.reshape(())
                 + (1.0 - momentum) * _absmax(x))
        new_scale = scale.reshape(1)
    return {"Out": [_ste(x, _quant_dequant(x.detach(), scale, bits))],
            "OutScale": [new_scale.reshape(1)]}


@register_op("fake_quantize_range_abs_max", grad_fn=_ste_grad,
             nondiff_inputs=["InScale", "Iter"])
def _fake_quantize_range_abs_max(ctx, inputs, attrs):
    (x,) = inputs["X"]
    (in_scale,) = inputs["InScale"]
    in_scale = in_scale.detach()
    bits = int(attrs.get("bit_length", 8))
    if attrs.get("is_test", False) or ctx.is_test:
        scale = in_scale.reshape(())
    else:
        scale = torch.maximum(in_scale.reshape(()), _absmax(x))
    return {"Out": [_ste(x, _quant_dequant(x.detach(), scale, bits))],
            "OutScale": [scale.reshape(1)]}


@register_op("moving_average_abs_max_scale", differentiable=False)
def _moving_average_abs_max_scale(ctx, inputs, attrs):
    (x,) = inputs["X"]
    (in_scale,) = inputs["InScale"]
    momentum = attrs.get("moving_rate", 0.9)
    scale = momentum * in_scale.reshape(()) + (1.0 - momentum) * _absmax(x)
    # no gradient through a non-differentiable op, as in the JAX package
    return {"Out": [x.detach()], "OutScale": [scale.reshape(1)]}


@register_op("fake_dequantize_max_abs")
def _fake_dequantize_max_abs(ctx, inputs, attrs):
    (x,) = inputs["X"]
    (scale,) = inputs["Scale"]
    bnt = (1 << (int(attrs.get("max_range_bits", 8)) - 1)) - 1
    max_range = attrs.get("max_range", float(bnt))
    return one(x * scale.reshape(()) / max_range)


@register_op("fake_channel_wise_dequantize_max_abs")
def _fake_cw_dequantize_max_abs(ctx, inputs, attrs):
    (x,) = inputs["X"]
    quant_bits = attrs.get("quant_bits", [8])
    out = x
    for s, b in zip(inputs["Scales"], quant_bits):
        shape = ((-1,) + (1,) * (x.ndim - 1)
                 if s.ndim == 1 and s.shape[0] == x.shape[0]
                 else (1,) * x.ndim)
        out = out * s.reshape(shape) / float((1 << (int(b) - 1)) - 1)
    return one(out)


# -- real int8 runtime ops (inference/quant.py) --------------------------


def quantize_act(x, scale: float):
    """float activations → int8 at the calibrated per-tensor scale: the
    inverse scale 127/max(f32(scale), 1e-8) in f32, round half to even,
    clip to ±127."""
    inv = float(np.float32(127.0) / np.maximum(np.float32(scale),
                                               np.float32(1e-8)))
    return torch.clamp(torch.round(x.float() * inv),
                       -127.0, 127.0).to(torch.int8)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_matmul(xq, w):
    """int8 [m, k] × int8 [k, n] → int32 [m, n]. On a CUDA tensor it is
    ``torch._int_mm``, which wants m > 16 and k, n multiples of 8: the
    operands are padded with zero rows and columns (exact in integers) and
    the product sliced back. On the CPU an exact int32 product."""
    if xq.device.type != "cuda":
        return xq.to(torch.int32) @ w.to(torch.int32)
    m, k = xq.shape
    n = w.shape[1]
    mp, kp, np_ = max(_round_up(m, 8), 24), _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        xq = torch.nn.functional.pad(xq, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        w = torch.nn.functional.pad(w, (0, np_ - n, 0, kp - k))
    acc = torch._int_mm(xq.contiguous(), w.contiguous())
    return acc[:m, :n]


@register_op("quantized_fc", differentiable=False)
def _quantized_fc(ctx, inputs, attrs):
    """fused_fc rewritten by int8_quantize_pass: quantize the activation
    at the calibrated scale, int8 gemm into int32, dequant by
    sx·sw/127² per out-channel, then float bias + activation."""
    (x,) = inputs["Input"]
    (w,) = inputs["W"]                 # int8 [k, n]
    (w_scale,) = inputs["WScale"]      # f32 [n] (per out-channel abs-max)
    b = opt_input(inputs, "Bias")
    act_scale = float(attrs["act_scale"])
    ncol = int(attrs.get("in_num_col_dims", 1))
    if ncol < 0:                       # matmul-style: all-but-last lead
        ncol = x.ndim - 1
    lead = tuple(x.shape[:ncol])
    m = int(np.prod(lead)) if lead else 1
    acc = int8_matmul(quantize_act(x.reshape(m, -1), act_scale), w)
    # a tensor divisor: CUDA divides by a host scalar through its
    # reciprocal, one ulp off the JAX package's f32 quotient
    ws = w_scale.float()
    deq = (float(np.float32(act_scale / 127.0))
           * (ws / torch.full_like(ws, 127.0)))
    out = acc.float() * deq.reshape(1, -1)
    if b is not None:
        out = out + b.float().reshape(1, -1)
    out = _ACTS[attrs.get("activation_type", "")](out)
    return one(out.reshape(lead + (w.shape[-1],)))


@register_op("quantized_lookup_table", differentiable=False)
def _quantized_lookup_table(ctx, inputs, attrs):
    """lookup_table(/_v2) rewritten by int8_quantize_pass: gather int8
    rows and dequant with the per-table scale. `squeeze_last` keeps
    lookup_table's trailing-1 id squeeze; `table_scale` is the table's
    abs-max."""
    (w,) = inputs["W"]                 # int8 [V, D]
    (ids,) = inputs["Ids"]
    scale = float(np.float32(float(attrs["table_scale"]) / 127.0))
    idx = ids
    if attrs.get("squeeze_last") and ids.ndim >= 2 and ids.shape[-1] == 1:
        idx = ids[..., 0]
    out = w[idx.long()].float() * scale
    padding_idx = attrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = out.masked_fill((idx == padding_idx)[..., None], 0.0)
    return one(out)
