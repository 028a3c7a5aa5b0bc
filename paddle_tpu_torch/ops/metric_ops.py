"""top_k, accuracy and auc (counterparts of ``paddle_tpu.ops.reduce_ops``'s
``top_k`` and ``paddle_tpu.ops.metric_ops``'s ``accuracy`` and ``auc``;
reference top_k_op.cc, operators/metrics/accuracy_op.cc, auc_op.cc). On a
data-parallel mesh ``accuracy``'s counts and ``auc``'s histograms are the
whole group's."""
from __future__ import annotations

import torch

from ..core.mesh_step import batch_group
from ..core.registry import GLOBAL, ROWS, register_op
from ..parallel.collective import psum


@register_op("top_k", dp=ROWS)
def _top_k(ctx, inputs, attrs):
    """The k largest values along the last axis and their int64 indices.
    Ties go to the lower index, as ``lax.top_k`` breaks them: a stable
    descending sort, then the first k (``torch.topk`` orders ties
    differently, and differently on the CPU and the card)."""
    (x,) = inputs["X"]
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    k = attrs["k"]
    return {"Out": [vals[..., :k]], "Indices": [idx[..., :k]]}


@register_op("accuracy", differentiable=False, dp=GLOBAL)
def _accuracy(ctx, inputs, attrs):
    """accuracy_op.cc: fraction of samples whose top-k indices contain the
    label; Correct and Total are int32."""
    (indices,) = inputs["Indices"]
    (label,) = inputs["Label"]
    lab = label[..., 0] if label.ndim == 2 and label.shape[-1] == 1 else label
    correct = (indices == lab[:, None]).any(dim=1)
    total = torch.tensor(indices.shape[0], dtype=torch.int32,
                         device=indices.device)
    num_correct = correct.sum(dtype=torch.int32)
    dp = batch_group(ctx, "Indices")
    if dp is not None:  # the group's counts on a data-parallel mesh
        both = psum(torch.stack([num_correct, total]), dp)
        num_correct, total = both[0], both[1]
    acc = num_correct.float() / total.float()
    return {"Accuracy": [acc], "Correct": [num_correct], "Total": [total]}


@register_op("auc", differentiable=False, dp=GLOBAL)
def _auc(ctx, inputs, attrs):
    """auc_op.cc: streaming AUC via threshold-bucketed confusion counters.
    StatPos/StatNeg are persistable accumulator vars updated each step. The
    histograms are ``index_add_`` sums of 0/1 values: exact in float32 up to
    2^24 a bucket, so the stat buffers are bitwise the same on the CPU, on
    the card (whatever order its atomic adds take) and in the JAX
    package."""
    (predict,) = inputs["Predict"]
    (label,) = inputs["Label"]
    (stat_pos,) = inputs["StatPos"]
    (stat_neg,) = inputs["StatNeg"]
    num_thresholds = attrs.get("num_thresholds", 4095)
    pos_prob = (predict[:, 1] if predict.ndim == 2 and predict.shape[1] == 2
                else predict.reshape(-1))
    lab = label.reshape(-1).to(torch.float32)
    bucket = (pos_prob * num_thresholds).to(torch.int32).clamp(
        0, num_thresholds).long()
    zeros = torch.zeros(num_thresholds + 1, dtype=torch.float32,
                        device=predict.device)
    pos_hist = zeros.index_add(0, bucket, lab)
    neg_hist = zeros.index_add(0, bucket, 1.0 - lab)
    dp = batch_group(ctx, "Predict")
    if dp is not None:  # the group's histograms on a data-parallel mesh
        pos_hist, neg_hist = psum(torch.stack([pos_hist, neg_hist]), dp)
    new_pos = stat_pos + pos_hist
    new_neg = stat_neg + neg_hist
    # integrate: walking thresholds high→low accumulates TP/FP
    tp = torch.cumsum(new_pos.flip(0), 0).flip(0)
    fp = torch.cumsum(new_neg.flip(0), 0).flip(0)
    tot_pos = tp[0]
    tot_neg = fp[0]
    # trapezoid over unique thresholds
    tp_prev = torch.cat([tp[1:], zeros[:1]])
    fp_prev = torch.cat([fp[1:], zeros[:1]])
    area = torch.sum((fp - fp_prev) * (tp + tp_prev) / 2.0)
    auc = torch.where((tot_pos > 0) & (tot_neg > 0),
                      area / (tot_pos * tot_neg + 1e-12),
                      torch.zeros_like(area))
    return {"AUC": [auc], "StatPosOut": [new_pos], "StatNegOut": [new_neg]}
