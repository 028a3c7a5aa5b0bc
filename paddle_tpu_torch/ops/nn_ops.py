"""Conv, pooling, normalization, dropout, embedding and loss ops
(counterpart of the matching registrations in ``paddle_tpu.ops.nn_ops``;
reference conv_op.cc, pool_op.cc, batch_norm_op.cc, layer_norm_op.cc,
dropout_op.cc, lookup_table_op.cc, softmax_with_cross_entropy_op.cc).

Convolutions are ``F.conv2d`` (cuDNN on the card), as the JAX package leaves
them to XLA outside any Pallas kernel; 4-D activations are kept channels-last
in memory (``common.conv2d_nchw``) so that the fused batch-norm kernels read
them in place."""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from ..core.registry import register_op
from .common import (act_map, bn_batch_stats_xla1, bn_normalize, conv2d_nchw,
                     one)
from .kernels import fused_bn


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _same_pads(size, k, s, d):
    """lax "SAME" padding of one spatial dim: (low, high)."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


@register_op("conv2d", nondiff_inputs=[])
def _conv2d(ctx, inputs, attrs):
    (x,) = inputs["Input"]
    (w,) = inputs["Filter"]
    strides = _pair(attrs.get("strides", [1, 1]))
    pads = _pair(attrs.get("paddings", [0, 0]))
    dilations = _pair(attrs.get("dilations", [1, 1]))
    groups = int(attrs.get("groups", 1))
    pad_alg = attrs.get("padding_algorithm", "EXPLICIT")
    if pad_alg == "SAME":
        (t, b), (l, r) = (_same_pads(x.shape[2 + i], w.shape[2 + i],
                                     strides[i], dilations[i])
                          for i in range(2))
        padding = (t, b, l, r)
    elif pad_alg == "VALID":
        padding = (0, 0)
    else:
        padding = pads  # (ph, pw) or (top, bottom, left, right)
    return one(conv2d_nchw(x, w, strides, padding, dilations, groups))


@register_op("pool2d")
def _pool2d(ctx, inputs, attrs):
    """pool_op.cc: max pools pad with -inf; exclusive average pools divide
    by the count of real elements in the window."""
    (x,) = inputs["X"]
    ptype = attrs.get("pooling_type", "max")
    ksize = _pair(attrs.get("ksize", [2, 2]))
    strides = _pair(attrs.get("strides", ksize))
    pads = _pair(attrs.get("paddings", [0, 0]))
    if attrs.get("global_pooling", False) or attrs.get("adaptive", False) \
            and _pair(attrs.get("ksize")) == (1, 1):
        if ptype == "max":
            return one(torch.amax(x, dim=(2, 3), keepdim=True))
        return one(torch.mean(x, dim=(2, 3), keepdim=True))
    if ptype == "max":
        return one(F.max_pool2d(x, ksize, strides, pads))
    return one(F.avg_pool2d(
        x, ksize, strides, pads,
        count_include_pad=not attrs.get("exclusive", True)))


@register_op("batch_norm", nondiff_inputs=["Mean", "Variance"])
def _batch_norm(ctx, inputs, attrs):
    """batch_norm_op.cc: batch statistics and a running-stat update in
    training, frozen statistics in test. ``PDTPU_BN_MODE`` (read at run
    time, as in the JAX package) picks the training statistics:
    "xla1" (default) one-pass f32, "xla2" two-pass, "pallas" the fused-BN
    kernels (``fused_bn_act``, relu folded in), "pallas_stats" the
    statistics kernel with a frozen-stats gradient (a perf probe). The
    kernels take only NCHW inputs that pass ``fused_bn.supports``; on a CPU
    tensor they run as their plain versions."""
    (x,) = inputs["X"]
    (scale,) = inputs["Scale"]
    (bias,) = inputs["Bias"]
    (mean,) = inputs["Mean"]
    (var,) = inputs["Variance"]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    is_test = attrs.get("is_test", False) or ctx.is_test
    layout = attrs.get("data_layout", "NCHW")
    act = attrs.get("act", "")  # folded by layers.batch_norm (fused-BN path)
    bn_mode = os.environ.get("PDTPU_BN_MODE", "xla1")
    ch_axis = 1 if layout == "NCHW" else x.ndim - 1
    axes = tuple(i for i in range(x.ndim) if i != ch_axis)
    shape = [1] * x.ndim
    shape[ch_axis] = x.shape[ch_axis]

    def outs(y, mean_out, var_out, saved_mean, saved_var):
        return {"Y": [y], "MeanOut": [mean_out.detach()],
                "VarianceOut": [var_out.detach()],
                "SavedMean": [saved_mean.detach()],
                "SavedVariance": [saved_var.detach()]}

    if is_test:
        y = bn_normalize(x, mean, var, scale, bias, eps, shape)
        return outs(act_map()[act](y), mean, var, mean, var)
    if (bn_mode.startswith("pallas") and layout == "NCHW"
            and act in ("", "relu") and fused_bn.supports(x.shape, x.dtype)):
        if bn_mode == "pallas_stats":
            bmean, bvar = fused_bn.bn_stats(x.detach())
            y = bn_normalize(x, bmean, bvar, scale, bias, eps, shape)
            y = act_map()[act](y)
        else:
            y, bmean, bvar = fused_bn.fused_bn_act(x, scale, bias, eps, act,
                                                   False)
        return outs(y, momentum * mean + (1.0 - momentum) * bmean,
                    momentum * var + (1.0 - momentum) * bvar, bmean, bvar)
    # statistics always in f32; x itself stays in its own dtype (the op is
    # AMP-gray, so a bf16 conv trunk never round-trips through f32 memory)
    if bn_mode == "xla2":
        use_mean = torch.mean(x.float(), dim=axes)
        use_var = torch.var(x.float(), dim=axes, correction=0)
    else:
        use_mean, use_var = bn_batch_stats_xla1(x, axes)
    y = bn_normalize(x, use_mean, use_var, scale, bias, eps, shape)
    return outs(act_map()[act](y), momentum * mean + (1.0 - momentum)
                * use_mean, momentum * var + (1.0 - momentum) * use_var,
                use_mean, use_var)


@register_op("layer_norm")
def _layer_norm(ctx, inputs, attrs):
    """Accepts bf16 activations and computes the statistics and the
    normalization in f32, returning the input dtype."""
    (x,) = inputs["X"]
    scale = inputs.get("Scale", [None])[0]
    bias = inputs.get("Bias", [None])[0]
    eps = attrs.get("epsilon", 1e-5)
    bna = attrs.get("begin_norm_axis", 1)
    axes = tuple(range(bna, x.ndim))
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=axes, correction=0, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    norm_shape = (1,) * bna + tuple(x.shape[bna:])
    if scale is not None:
        y = y * scale.float().reshape(norm_shape)
    if bias is not None:
        y = y + bias.float().reshape(norm_shape)
    return {"Y": [y.to(x.dtype)], "Mean": [mean.reshape(x.shape[:bna])],
            "Variance": [var.reshape(x.shape[:bna])]}


@register_op("dropout")
def _dropout(ctx, inputs, attrs):
    (x,) = inputs["X"]
    p = attrs.get("dropout_prob", 0.5)
    is_test = attrs.get("is_test", False) or ctx.is_test
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if is_test or p == 0.0:
        # reference dropout_op.cc: at inference, downgrade_in_infer scales by
        # (1-p); upscale_in_train is identity (scaling happened in training).
        y = (x * (1.0 - p) if (impl == "downgrade_in_infer" and is_test
                               and p > 0.0) else x)
        return {"Out": [y], "Mask": [torch.ones_like(x)]}
    mask = torch.bernoulli(torch.full_like(x, 1.0 - p), generator=ctx.rng())
    y = x * mask / (1.0 - p) if impl == "upscale_in_train" else x * mask
    return {"Out": [y], "Mask": [mask]}


def _check_dense(w, attrs):
    """A sparse table's gradient is a SelectedRows of the touched rows in the
    JAX package; the port has only the dense gradient so far."""
    if attrs.get("is_sparse") and w.requires_grad:
        raise NotImplementedError(
            "lookup_table: training an is_sparse table (SelectedRows "
            "gradients and the row-update optimizers) is not ported yet; it "
            "arrives with the DeepFM slice — build the embedding with "
            "is_sparse=False")


def _gather_rows(w, idx, attrs):
    out = w[idx]
    padding_idx = attrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = out.masked_fill((idx == padding_idx)[..., None], 0.0)
    return out


@register_op("lookup_table", nondiff_inputs=["Ids"])
def _lookup_table(ctx, inputs, attrs):
    """lookup_table_op.cc: W[ids]; padding_idx rows produce zeros. Only the
    dense table: packed row-major tables and the deferred-row inputs come
    with the DeepFM slice."""
    if attrs.get("row_pack_dt") or "PendingPos" in inputs:
        raise NotImplementedError(
            "lookup_table: packed / deferred-row tables are not ported yet")
    (w,) = inputs["W"]
    (ids,) = inputs["Ids"]
    _check_dense(w, attrs)
    squeeze_last = ids.ndim >= 2 and ids.shape[-1] == 1
    return one(_gather_rows(w, ids[..., 0] if squeeze_last else ids, attrs))


@register_op("lookup_table_v2", nondiff_inputs=["Ids"])
def _lookup_table_v2(ctx, inputs, attrs):
    (w,) = inputs["W"]
    (ids,) = inputs["Ids"]
    _check_dense(w, attrs)
    return one(_gather_rows(w, ids, attrs))


class _HardLabelCE(torch.autograd.Function):
    """Memory-lean hard-label cross entropy (``_hard_label_ce`` of the JAX
    package): takes low-precision logits as they are, reduces in f32, and
    saves only (logits, idx, lse) for the backward, which rebuilds
    p = exp(logits − lse) and returns (p − onehot)·g in the logits' dtype.
    Rows whose label is `ignore` get loss 0 and gradient 0."""

    @staticmethod
    def forward(ctx, logits, idx, axis, ignore):
        ax = axis % logits.ndim
        m = logits.amax(dim=ax, keepdim=True).float()
        lse = m + torch.log(torch.exp(logits.float() - m).sum(ax, True))
        safe = idx if ignore is None else idx.masked_fill(idx == ignore, 0)
        picked = torch.gather(logits, ax, safe.unsqueeze(ax)).float()
        loss = lse - picked
        if ignore is not None:
            loss = loss.masked_fill((idx == ignore).unsqueeze(ax), 0.0)
        ctx.save_for_backward(logits, safe, lse)
        ctx.ax = ax
        ctx.dropped = None if ignore is None else (idx == ignore)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, safe, lse = ctx.saved_tensors
        ax = ctx.ax
        p = torch.exp(logits.float() - lse)
        p.scatter_add_(ax, safe.unsqueeze(ax),
                       -torch.ones_like(safe, dtype=p.dtype).unsqueeze(ax))
        if ctx.dropped is not None:
            g = g.masked_fill(ctx.dropped.unsqueeze(ax), 0.0)
        return (p * g).to(logits.dtype), None, None, None


@register_op("softmax_with_cross_entropy", nondiff_inputs=["Label"])
def _softmax_with_cross_entropy(ctx, inputs, attrs):
    """Loss keeps a singleton class axis. The Softmax output is computed
    only when a later op or a fetch reads it (XLA drops it in the JAX
    package): at BERT's MLM head it is a full-vocab f32 tensor."""
    (logits,) = inputs["Logits"]
    (label,) = inputs["Label"]
    axis = attrs.get("axis", -1)
    ax = axis % logits.ndim
    if not attrs.get("soft_label", False):
        idx = label
        if idx.ndim == logits.ndim and idx.shape[ax] == 1:
            idx = idx.squeeze(ax)
        loss = _HardLabelCE.apply(logits, idx.long(), axis,
                                  attrs.get("ignore_index", -100))
        softmax = (torch.softmax(logits.float(), dim=ax)
                   if ctx.wants("Softmax") else None)
        return {"Loss": [loss], "Softmax": [softmax]}
    # soft-label path: the op is AMP-white-listed (inputs may arrive bf16),
    # so upcast — a vocab-length bf16 accumulation would lose ~3 digits
    logp = torch.log_softmax(logits.float(), dim=ax)
    loss = -torch.sum(label.float() * logp, dim=ax, keepdim=True)
    return {"Loss": [loss], "Softmax": [torch.exp(logp)]}
