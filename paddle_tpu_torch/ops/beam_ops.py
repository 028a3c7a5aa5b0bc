"""Beam-search ops: one expansion step and the final backtrack (the port's
copy of ``paddle_tpu.ops.beam_ops``).

Reference analog: ``paddle/fluid/operators/beam_search_op.cc`` (one step:
expand candidates, prune to the beam width, LoD bookkeeping of the parent
links) and ``beam_search_decode_op.cc`` (walk the sentence trees backwards
to emit token sequences). As in the JAX package, beams are dense
``[batch, beam, ...]`` tensors with the parent index of each step stored
beside its ids.

On a data-parallel mesh one step works row by row (each batch row's beams
are its own); the decode reads steps stacked along dim 0, so it declares
nothing and runs on the whole batch (``core/registry.py``).
"""
from __future__ import annotations

import torch

from ..core.registry import ROWS, register_op
from .common import opt_input

NEG = -1e9


@register_op("beam_search", differentiable=False, dp=ROWS)
def _beam_search(ctx, inputs, attrs):
    """One expansion step.

    inputs: Scores [batch, beam, vocab] log-probs of this step,
            PreScores [batch, beam] accumulated log-probs,
            PreFinished [batch, beam] (0/1): a finished beam only carries
            its end-token continuation, at score 0.
    attrs: beam_size, end_id.
    outputs: SelectedIds [batch, beam] int64, SelectedScores [batch, beam]
             accumulated, ParentIdx [batch, beam] int64 (the previous beam
             each selected candidate extends), Finished [batch, beam].
    Ties go to the lower flat index, as ``lax.top_k`` breaks them."""
    (scores,) = inputs["Scores"]
    (pre_scores,) = inputs["PreScores"]
    pre_fin = opt_input(inputs, "PreFinished")
    beam = attrs["beam_size"]
    end_id = attrs["end_id"]
    batch, cur_beam, vocab = scores.shape
    if pre_fin is None:
        pre_fin = torch.zeros((batch, cur_beam), dtype=torch.bool,
                              device=scores.device)
    else:
        pre_fin = pre_fin.to(torch.bool)
    fin_row = torch.full((vocab,), NEG, dtype=scores.dtype,
                         device=scores.device)
    fin_row[end_id] = 0.0
    step = torch.where(pre_fin[..., None], fin_row[None, None, :], scores)
    total = pre_scores[..., None] + step                     # [b, cur, V]
    flat = total.reshape(batch, cur_beam * vocab)
    vals, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    top_scores, top_idx = vals[:, :beam], idx[:, :beam]
    parent = top_idx // vocab
    ids = top_idx % vocab
    finished = torch.gather(pre_fin, 1, parent) | (ids == end_id)
    return {"SelectedIds": [ids], "SelectedScores": [top_scores],
            "ParentIdx": [parent], "Finished": [finished]}


@register_op("beam_search_decode", differentiable=False)
def _beam_search_decode(ctx, inputs, attrs):
    """Backtrack the stored steps into token sequences.

    inputs: Ids [T, batch, beam] int64 selected ids of each step,
            ParentIdx [T, batch, beam] int64,
            Scores [batch, beam] final accumulated scores.
    outputs: SentenceIds [batch, beam, T] (each final beam's path followed
             back), SentenceScores [batch, beam]."""
    (ids,) = inputs["Ids"]
    (parents,) = inputs["ParentIdx"]
    (scores,) = inputs["Scores"]
    steps, batch, beam = ids.shape
    cursor = torch.arange(beam, device=ids.device).expand(batch, beam)
    toks = [None] * steps
    for t in reversed(range(steps)):
        toks[t] = torch.gather(ids[t], 1, cursor)
        cursor = torch.gather(parents[t].long(), 1, cursor)
    sentences = torch.stack(toks, dim=-1)                    # [b, beam, T]
    return {"SentenceIds": [sentences], "SentenceScores": [scores]}
