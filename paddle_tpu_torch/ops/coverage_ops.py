"""Part of ``paddle_tpu.ops.coverage_ops``: ``chunk_eval`` (reference
chunk_eval_op.cc/.h), the op behind ``layers.chunk_eval`` and
``metrics.ChunkEvaluator``. The rest of that module is not ported yet
(ROADMAP A12).

Tags follow chunk_eval_op.h: tag = type · n + position, with n = 2 for
IOB (B, I) and IOE (I, E), 4 for IOBES (B, I, E, S), 1 for plain; a tag
≥ num_chunk_types · n is outside any chunk. A label chunk is correct when
the inference starts a chunk at the same position with the same type and
both end at the same position. Everything stays on the device: the end of
the chunk at or after each position comes from a reverse running max, as
the JAX package's ``lax.associative_scan`` does.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op

_TAGS = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}


def _shift(a, fill, right: bool):
    """`a` moved one position along dim 1 (right: a[t-1] lands at t),
    the freed position set to `fill`."""
    pad = torch.full_like(a[:, :1], fill)
    return torch.cat([pad, a[:, :-1]] if right else [a[:, 1:], pad], dim=1)


def _chunk_bounds(tags, num_chunk_types: int, scheme: str, lengths):
    """(start, end, type) per position: bool, bool, int (−1 outside)."""
    n_tag = _TAGS[scheme]
    steps = torch.arange(tags.shape[1], device=tags.device)[None, :]
    valid = (steps < lengths.reshape(-1, 1)) & (tags < num_chunk_types * n_tag)
    typ = torch.where(valid, tags // n_tag, torch.full_like(tags, -1))
    pos = torch.where(valid, tags % n_tag, torch.full_like(tags, -1))
    prev_typ, next_typ = _shift(typ, -1, True), _shift(typ, -1, False)
    if scheme == "IOB":         # position 0 = B, 1 = I
        start = valid & ((pos == 0) | (typ != prev_typ))
        end = valid & ((next_typ != typ) | (_shift(pos, -1, False) == 0))
    elif scheme == "IOE":       # position 0 = I, 1 = E
        end = valid & ((pos == 1) | (typ != next_typ))
        start = valid & (typ != prev_typ)
    elif scheme == "IOBES":     # 0 = B, 1 = I, 2 = E, 3 = S
        start = valid & ((pos == 0) | (pos == 3))
        end = valid & ((pos == 2) | (pos == 3))
    else:                       # plain: maximal runs of one type
        start = valid & (typ != prev_typ)
        end = valid & (typ != next_typ)
    return start, end, typ


def _next_end(end):
    """Per position, the index of the first end flag at or after it
    (the row's length in positions if none)."""
    T = end.shape[1]
    steps = torch.arange(T, device=end.device)[None, :].expand_as(end)
    rev = torch.flip(end, dims=[1])
    idx = torch.flip(torch.cummax(torch.where(rev, steps, torch.full_like(
        steps, -1)), dim=1).values, dims=[1])
    return T - 1 - idx


@register_op("chunk_eval", differentiable=False)
def _chunk_eval(ctx, inputs, attrs):
    """Precision, recall and F1 ([1] f32 each) and the inferred, labelled
    and correct chunk counts ([1] int64 each) of Inference against Label
    ([B, T] or [B, T, 1] tags), within Length [B] when given."""
    (inf,) = inputs["Inference"]
    (lab,) = inputs["Label"]
    length = (inputs.get("Length") or [None])[0]
    num_types = int(attrs["num_chunk_types"])
    scheme = attrs.get("chunk_scheme", "IOB")
    b = inf.shape[0] if inf.ndim > 1 else 1
    inf2 = inf.reshape(b, -1).to(torch.int64)
    lab2 = lab.reshape(b, -1).to(torch.int64)
    lengths = (length.reshape(-1).to(torch.int64) if length is not None
               else torch.full((b,), inf2.shape[1], dtype=torch.int64,
                               device=inf2.device))
    si, ei, ti = _chunk_bounds(inf2, num_types, scheme, lengths)
    sl, el, tl = _chunk_bounds(lab2, num_types, scheme, lengths)
    correct = si & sl & (ti == tl) & (_next_end(ei) == _next_end(el))
    n_inf, n_lab, n_cor = si.sum(), sl.sum(), correct.sum()
    f32 = torch.float32
    p = n_cor.to(f32) / n_inf.clamp_min(1).to(f32)
    r = n_cor.to(f32) / n_lab.clamp_min(1).to(f32)
    f1 = 2 * p * r / (p + r).clamp_min(1e-12)
    return {"Precision": [p.reshape(1)], "Recall": [r.reshape(1)],
            "F1-Score": [f1.reshape(1)],
            "NumInferChunks": [n_inf.reshape(1)],
            "NumLabelChunks": [n_lab.reshape(1)],
            "NumCorrectChunks": [n_cor.reshape(1)]}
