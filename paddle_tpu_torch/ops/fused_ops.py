"""Fused ops produced by the IR fuse passes, and flash attention
(counterpart of the matching registrations in ``paddle_tpu.ops.fused_ops``;
reference ``operators/fused/``)."""
from __future__ import annotations

import math

import torch

from ..core.registry import register_op
from .common import act_map, bcast_y, one, opt_input
from .kernels import flash_attention as _fa

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
    is_test = attrs.get("is_test", False) or ctx.is_test
    rate = 0.0 if is_test else attrs.get("dropout_prob", 0.0)
    seed = 0
    if rate > 0.0:
        seed = torch.randint(0, 2 ** 62, (1,), generator=ctx.rng(),
                             device=ctx.device, dtype=torch.int64)
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
