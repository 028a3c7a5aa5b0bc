"""Fused ops produced by the IR fuse passes, and flash attention
(counterpart of the matching registrations in ``paddle_tpu.ops.fused_ops``;
reference ``operators/fused/``)."""
from __future__ import annotations

import math
import os

import torch

from ..core.registry import register_op
from .common import act_map, bcast_y, one, opt_input
from .kernels import flash_attention as _fa
from .kernels import flash_attention_sparse as _fas
from .kernels import fused_bn as _fbn

_ACTS = act_map()


@register_op("fused_elemwise_activation")
def _fused_elemwise_activation(ctx, inputs, attrs):
    """act(add(x, y)) in one op (fused_elemwise_activation_op.cc)."""
    (x,) = inputs["X"]
    (y,) = inputs["Y"]
    binary, unary = attrs["functor_list"]
    y = bcast_y(x, y, attrs.get("axis", -1))
    binop = {"elementwise_add": torch.add,
             "elementwise_mul": torch.mul}[binary]
    return one(_ACTS[unary](binop(x, y)))


@register_op("fused_fc")
def _fused_fc(ctx, inputs, attrs):
    """gemm + bias + activation as one unit (fc_fuse_pass.cc)."""
    (x,) = inputs["Input"]
    (w,) = inputs["W"]
    b = opt_input(inputs, "Bias")
    lead = tuple(x.shape[:attrs.get("in_num_col_dims", 1)])
    x2 = x.reshape(math.prod(lead), -1)
    out = torch.matmul(x2, w) if b is None else torch.addmm(
        b.reshape(1, -1), x2, w)
    out = _ACTS[attrs.get("activation_type", "")](out)
    return one(out.reshape(lead + (w.shape[-1],)))


@register_op("fused_conv_bn", nondiff_inputs=["Mean", "Variance"])
def _fused_conv_bn(ctx, inputs, attrs):
    """1×1-conv + batch_norm (+relu, +residual) as one op, the ResNet
    bottleneck tail: the Hopper kernels on a CUDA tensor, their plain
    versions on a CPU tensor (ops/kernels/fused_bn.py), for the shapes
    ``conv_bn_supports`` admits; otherwise the plain composition with the
    exact math of the separate conv2d + batch_norm ("xla1") (+add+relu)
    ops, bitwise equal end to end. ``PDTPU_CONV_BN_FUSION=xla`` (read at
    run time) forces the composition."""
    (x,) = inputs["Input"]
    (w,) = inputs["Filter"]
    (scale,) = inputs["Scale"]
    (bias,) = inputs["Bias"]
    (mean,) = inputs["Mean"]
    (var,) = inputs["Variance"]
    residual = opt_input(inputs, "Residual")
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    act = attrs.get("act", "")
    stride = int(attrs.get("stride", 1))
    is_test = attrs.get("is_test", False) or ctx.is_test
    mode = os.environ.get("PDTPU_CONV_BN_FUSION", "pallas")
    # AMP casts the activations at the op boundary but does not know this
    # op's Filter slot: round the f32 master weight to the compute dtype
    # here, as the unfused conv2d gets it from its cast (scale, bias and the
    # statistics stay f32)
    w = w.to(x.dtype)

    if is_test:
        y, _, _ = _fbn.conv_bn_xla(x, w, scale, bias, eps, act, stride,
                                   residual, use_mean=mean, use_var=var)
        return {"Y": [y], "MeanOut": [mean], "VarianceOut": [var],
                "SavedMean": [mean], "SavedVariance": [var]}

    if mode != "xla" and _fbn.conv_bn_supports(x.shape, w.shape, stride):
        y, bmean, bvar = _fbn.fused_conv_bn_act(
            x, w, scale, bias, eps, act, stride, residual is not None,
            residual)
    else:
        y, bmean, bvar = _fbn.conv_bn_xla(x, w, scale, bias, eps, act,
                                          stride, residual)
    mean_out = momentum * mean + (1.0 - momentum) * bmean
    var_out = momentum * var + (1.0 - momentum) * bvar
    return {"Y": [y], "MeanOut": [mean_out.detach()],
            "VarianceOut": [var_out.detach()],
            "SavedMean": [bmean.detach()], "SavedVariance": [bvar.detach()]}


def _attention_dropout(ctx, attrs):
    """(rate, seed) of an attention op's dropout: rate 0 in test; in training
    one seed per call drawn from the run's generator on the run's device (no
    host sync), from which the backward regenerates the same mask."""
    is_test = attrs.get("is_test", False) or ctx.is_test
    rate = 0.0 if is_test else attrs.get("dropout_prob", 0.0)
    seed = 0
    if rate > 0.0:
        seed = torch.randint(0, 2 ** 62, (1,), generator=ctx.rng(),
                             device=ctx.device, dtype=torch.int64)
    return rate, seed


@register_op("flash_attention", nondiff_inputs=["BiasQK"])
def _flash_attention(ctx, inputs, attrs):
    """Memory-efficient fused attention: the Hopper kernels on a CUDA tensor,
    their plain versions on a CPU tensor; see ops/kernels/flash_attention.py.
    With dropout in training, one seed per call is drawn from the run's
    generator (on the run's device, so no host sync) and the backward
    regenerates the same mask from it."""
    (q,) = inputs["Q"]
    (k,) = inputs["K"]
    (v,) = inputs["V"]
    bias = opt_input(inputs, "BiasQK")
    rate, seed = _attention_dropout(ctx, attrs)
    if q.ndim == 3:
        # packed [B, T, H] layout, read in place through strides
        if "num_heads" not in attrs:
            raise ValueError(
                "flash_attention: 3D (packed [B,T,H]) q/k/v requires the "
                "num_heads attr — pass num_heads= to layers.flash_attention")
        return one(_fa.flash_attention_packed(
            q, k, v, attrs["num_heads"], bias=bias,
            causal=attrs.get("causal", False), dropout_rate=rate, seed=seed))
    return one(_fa.flash_attention(
        q, k, v, bias=bias, causal=attrs.get("causal", False),
        dropout_rate=rate, seed=seed))


@register_op("flash_attention_sparse", nondiff_inputs=["QSeg", "KSeg"])
def _flash_attention_sparse(ctx, inputs, attrs):
    """Block-sparse packed-segment attention on [B, T, H] q/k/v: visibility
    travels as the int32 segment-id rows QSeg [B, Tq] and KSeg [B, Tk]
    instead of a dense [B, 1, Tq, Tk] mask, and fully masked 64x64 tiles are
    skipped by the forward and both backward kernels (the Hopper kernels on
    a CUDA tensor, their plain versions on a CPU tensor); see
    ops/kernels/flash_attention_sparse.py. Dropout as flash_attention's."""
    (q,) = inputs["Q"]
    (k,) = inputs["K"]
    (v,) = inputs["V"]
    (q_seg,) = inputs["QSeg"]
    (k_seg,) = inputs["KSeg"]
    rate, seed = _attention_dropout(ctx, attrs)
    return one(_fas.flash_attention_packed_sparse(
        q, k, v, attrs["num_heads"], q_seg, k_seg,
        causal=attrs.get("causal", False), dropout_rate=rate, seed=seed))
