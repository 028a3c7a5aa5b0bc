"""Normalization, dropout, embedding and loss ops (counterpart of the
matching registrations in ``paddle_tpu.ops.nn_ops``; reference
layer_norm_op.cc, dropout_op.cc, lookup_table_op.cc,
softmax_with_cross_entropy_op.cc)."""
from __future__ import annotations

import torch

from ..core.registry import register_op
from .common import one


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
