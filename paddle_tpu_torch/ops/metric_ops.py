"""top_k and accuracy (counterparts of ``paddle_tpu.ops.reduce_ops``'s
``top_k`` and ``paddle_tpu.ops.metric_ops``'s ``accuracy``; reference
top_k_op.cc, operators/metrics/accuracy_op.cc)."""
from __future__ import annotations

import torch

from ..core.registry import register_op


@register_op("top_k")
def _top_k(ctx, inputs, attrs):
    """The k largest values along the last axis and their int64 indices.
    Ties go to the lower index, as ``lax.top_k`` breaks them: a stable
    descending sort, then the first k (``torch.topk`` orders ties
    differently, and differently on the CPU and the card)."""
    (x,) = inputs["X"]
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    k = attrs["k"]
    return {"Out": [vals[..., :k]], "Indices": [idx[..., :k]]}


@register_op("accuracy", differentiable=False)
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
    acc = num_correct.float() / total.float()
    return {"Accuracy": [acc], "Correct": [num_correct], "Total": [total]}
