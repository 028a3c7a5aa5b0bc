"""Linear-chain CRF ops: log-likelihood and Viterbi decoding (counterpart
of ``paddle_tpu.ops.crf_ops``; reference linear_chain_crf_op.cc,
crf_decoding_op.cc).

The transition parameter is the reference's ``[D+2, D]``: row 0 the start
weights, row 1 the end weights, rows 2.. the ``[D, D]`` pairwise
transitions. Batches are padded ``[B, T, D]`` with a ``Length [B]``; a
step past a row's length keeps its carry. The JAX package runs both
recursions as ``lax.scan``s of plain ops; the port runs them as Python
loops over T of eager ops with no host read. The forward algorithm is
``torch.logsumexp`` over ``[B, D, D]`` and differentiable through
autograd (Label and Length are not); Viterbi keeps the first maximum on
ties (the lower tag, as ``jnp.argmax`` does).
"""
from __future__ import annotations

import torch

from ..core.registry import register_op
from .common import opt_input
from .rnn_ops import length_mask


def _split_transition(trans):
    return trans[0], trans[1], trans[2:]


def _lengths(length, B: int, T: int, device):
    if length is None:
        return torch.full((B,), T, dtype=torch.int64, device=device)
    return length.reshape(-1).to(torch.int64)


@register_op("linear_chain_crf", nondiff_inputs=["Label", "Length"])
def _linear_chain_crf(ctx, inputs, attrs):
    """Emission [B, T, D], Transition [D+2, D], Label [B, T] (or [B, T, 1]),
    Length [B]. LogLikelihood [B, 1] = gold path score − log partition."""
    (emission,) = inputs["Emission"]
    (trans,) = inputs["Transition"]
    (label,) = inputs["Label"]
    B, T, D = emission.shape
    if label.ndim == 3:
        label = label[..., 0]
    label = label.to(torch.int64)
    length = _lengths(opt_input(inputs, "Length"), B, T, emission.device)
    mask = length_mask(length, B, T, emission.device)
    start_w, end_w, pairwise = _split_transition(trans)

    # log partition: the forward algorithm
    alpha = start_w[None, :] + emission[:, 0, :]
    for t in range(1, T):
        new = torch.logsumexp(alpha[:, :, None] + pairwise[None], dim=1) \
            + emission[:, t]
        alpha = torch.where(mask[:, t, None], new, alpha)
    log_z = torch.logsumexp(alpha + end_w[None, :], dim=-1)

    # the gold path's score
    fmask = mask.to(emission.dtype)
    em_score = (emission.gather(-1, label[..., None])[..., 0]
                * fmask).sum(-1)
    trans_score = (pairwise[label[:, :-1], label[:, 1:]]
                   * fmask[:, 1:]).sum(-1)
    last = label.gather(1, (length - 1).clamp_min(0)[:, None])[:, 0]
    path = em_score + trans_score + start_w[label[:, 0]] + end_w[last]
    out = {"LogLikelihood": [(path - log_z).reshape(B, 1)],
           "EmissionExps": [None], "TransitionExps": [None], "Alpha": [None]}
    if ctx.wants("EmissionExps"):
        out["EmissionExps"] = [torch.exp(emission)]
    if ctx.wants("TransitionExps"):
        out["TransitionExps"] = [torch.exp(trans)]
    if ctx.wants("Alpha"):
        out["Alpha"] = [alpha]
    return out


@register_op("crf_decoding", differentiable=False)
def _crf_decoding(ctx, inputs, attrs):
    """Viterbi decode: Emission [B, T, D], Transition [D+2, D], Length [B].
    ViterbiPath [B, T] int64 (0 past a row's length); with a Label, 1 where
    the path matches it inside the row, else 0 (the reference's scoring
    mode)."""
    (emission,) = inputs["Emission"]
    (trans,) = inputs["Transition"]
    label = opt_input(inputs, "Label")
    B, T, D = emission.shape
    length = _lengths(opt_input(inputs, "Length"), B, T, emission.device)
    mask = length_mask(length, B, T, emission.device)
    start_w, end_w, pairwise = _split_transition(trans)
    stay = torch.arange(D, device=emission.device)[None, :].expand(B, D)

    alpha = start_w[None, :] + emission[:, 0, :]
    bps = []
    for t in range(1, T):
        best, prev = torch.max(alpha[:, :, None] + pairwise[None], dim=1)
        m = mask[:, t, None]
        alpha = torch.where(m, best + emission[:, t], alpha)
        # a step past the row's end points each tag at itself
        bps.append(torch.where(m, prev, stay))
    tag = torch.argmax(alpha + end_w[None, :], dim=-1)
    tags = [tag]
    for bp in reversed(bps):
        tag = bp.gather(1, tag[:, None])[:, 0]
        tags.append(tag)
    path = torch.stack(tags[::-1], dim=1)
    path = torch.where(mask, path, torch.zeros_like(path))
    if label is not None:
        if label.ndim == 3:
            label = label[..., 0]
        path = ((path == label.to(torch.int64)) & mask).to(torch.int64)
    return {"ViterbiPath": [path]}
