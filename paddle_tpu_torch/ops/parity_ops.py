"""Ops of ``paddle_tpu.ops.parity_ops`` (reference tree_conv_op.cc):
``tree_conv``, which the dygraph layer zoo traces. The rest of the module
is not ported yet (ROADMAP A12)."""
from __future__ import annotations

import torch

from ..core.registry import ROWS, register_op
from .common import one


@register_op("tree_conv", nondiff_inputs=["EdgeSet"], dp=ROWS)
def _tree_conv(ctx, inputs, attrs):
    """tree_conv_op.cc (continuous binary tree convolution, simplified to
    one propagation step, the JAX package's form): each node aggregates
    itself + its children (normalized) through three role weight matrices
    W[D, 3, C] (self / left half / right half of the child list by
    position). NodesVector [B, N, D]; EdgeSet [B, E, 2] (parent, child)
    rows, (-1, -1) padded. Out [B, N, C], tanh applied."""
    (nodes,) = inputs["NodesVector"]
    (edges,) = inputs["EdgeSet"]
    (w,) = inputs["Filter"]              # [D, 3, C]
    bsz, n, _ = nodes.shape
    edges = edges.long()
    parent, child = edges[..., 0], edges[..., 1]
    valid = parent >= 0
    p = torch.where(valid, parent, torch.full_like(parent, n))
    c = child.clamp(0, n - 1)
    bidx = torch.arange(bsz, device=edges.device)[:, None].expand_as(p)
    adj = nodes.new_zeros((bsz, n + 1, n))
    adj = adj.index_put((bidx, p, c), valid.to(nodes.dtype),
                        accumulate=True)[:, :n]
    deg = adj.sum(2, keepdim=True).clamp(min=1.0)
    halves = torch.cumsum(adj, dim=2)
    left = torch.where(halves <= deg / 2, adj, torch.zeros_like(adj))
    right = adj - left
    lmean = (left @ nodes) / left.sum(2, keepdim=True).clamp(min=1.0)
    rmean = (right @ nodes) / right.sum(2, keepdim=True).clamp(min=1.0)
    out = nodes @ w[:, 0] + lmean @ w[:, 1] + rmean @ w[:, 2]
    return one(torch.tanh(out))
