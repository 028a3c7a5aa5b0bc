"""Sequence ops over padded-dense batches (the port's copy of
``paddle_tpu.ops.sequence_ops``).

Reference analog: ``paddle/fluid/operators/sequence_ops/`` (LoD-aware ops
over lod_tensor.h variable-length batches). As in the JAX package, a
variable-length batch is **padded dense [batch, max_len, ...] plus an
explicit length var**: each op takes a Length input instead of reading LoD
metadata, and its output keeps a static shape (positions past a length are
zero or the pad value).

On a data-parallel mesh every op here works row by row (``ROWS`` in
``core/registry.py``): each batch row's output reads only that row and its
length (im2sequence's rows come image by image), so a rank runs its own
rows with their lengths.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.dtypes import convert_dtype
from ..core.registry import ROWS, register_op
from .common import one


def _mask_from_len(length, maxlen, dtype=torch.float32):
    return (torch.arange(maxlen, device=length.device)[None, :]
            < length.reshape(-1, 1)).to(dtype)


def _trail(mask, ndim):
    """[B, T] -> [B, T, 1, ...] against an ndim-rank [B, T, ...] tensor."""
    return mask.reshape(tuple(mask.shape) + (1,) * (ndim - 2))


def _take_steps(x, idx):
    """x[b, idx[b, t], ...] for idx [B, T'] (``take_along_axis`` on axis 1
    with the trailing dims broadcast)."""
    idx = idx.long().reshape(tuple(idx.shape) + (1,) * (x.ndim - 2))
    return torch.gather(x, 1, idx.expand(tuple(idx.shape[:2])
                                         + tuple(x.shape[2:])))


@register_op("sequence_mask", differentiable=False, dp=ROWS)
def _sequence_mask(ctx, inputs, attrs):
    (x,) = inputs["X"]
    maxlen = attrs.get("maxlen", -1)
    if maxlen is None or maxlen < 0:
        raise ValueError("sequence_mask requires a static maxlen attr")
    dtype = convert_dtype(attrs.get("out_dtype", "int64"))
    return {"Y": [_mask_from_len(x, maxlen, dtype)]}


@register_op("sequence_pool", nondiff_inputs=["Length"], dp=ROWS)
def _sequence_pool(ctx, inputs, attrs):
    """sequence_pool_op.cc over padded [B, T, ...] + Length."""
    (x,) = inputs["X"]
    (length,) = inputs["Length"]
    ptype = attrs.get("pooltype", "SUM").upper()
    mask = _trail(_mask_from_len(length, x.shape[1], x.dtype), x.ndim)
    lens = length.reshape((-1,) + (1,) * (x.ndim - 2)).to(x.dtype)
    if ptype == "SUM":
        out = torch.sum(x * mask, dim=1)
    elif ptype == "AVERAGE":
        out = torch.sum(x * mask, dim=1) / torch.clamp(lens, min=1)
    elif ptype == "SQRT":
        out = torch.sum(x * mask, dim=1) / torch.sqrt(torch.clamp(lens,
                                                                  min=1))
    elif ptype == "MAX":
        neg = torch.finfo(x.dtype).min
        out = torch.amax(torch.where(mask > 0, x, neg), dim=1)
    elif ptype == "LAST":
        idx = torch.clamp(length - 1, min=0).reshape(-1, 1)
        out = _take_steps(x, idx)[:, 0]
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        raise ValueError(f"unknown pooltype {ptype}")
    return one(out)


@register_op("sequence_softmax", nondiff_inputs=["Length"], dp=ROWS)
def _sequence_softmax(ctx, inputs, attrs):
    (x,) = inputs["X"]
    (length,) = inputs["Length"]
    mask = _mask_from_len(length, x.shape[1], x.dtype)
    logits = torch.where(mask > 0, x, torch.finfo(x.dtype).min)
    return one(torch.softmax(logits, dim=1) * mask)


@register_op("sequence_expand", nondiff_inputs=["Length"], dp=ROWS)
def _sequence_expand(ctx, inputs, attrs):
    (x,) = inputs["X"]
    (y,) = inputs["Y"]
    if x.ndim <= 1:
        return one(x)
    return one(torch.repeat_interleave(x, y.shape[1], dim=0).reshape(
        tuple(y.shape[:2]) + tuple(x.shape[1:])))


@register_op("sequence_reverse", nondiff_inputs=["Length"], dp=ROWS)
def _sequence_reverse(ctx, inputs, attrs):
    (x,) = inputs["X"]
    length = inputs.get("Length", [None])[0]
    t = x.shape[1]
    if length is None:
        return {"Y": [torch.flip(x, dims=[1])]}
    idx = torch.arange(t, device=x.device)[None, :]
    lens = length.reshape(-1, 1)
    rev = torch.where(idx < lens, lens - 1 - idx, idx)
    return {"Y": [_take_steps(x, rev)]}


@register_op("sequence_concat", dp=ROWS)
def _sequence_concat(ctx, inputs, attrs):
    return one(torch.cat(list(inputs["X"]), dim=1))


@register_op("im2sequence", dp=ROWS)
def _im2sequence(ctx, inputs, attrs):
    """im2sequence_op.h:33: the kernel patches of NCHW images as sequence
    rows — Out[N·OH·OW, C·kh·kw], each image's output positions row-major,
    each row its (C, kh, kw)-ordered patch (the im2col layout)."""
    (x,) = inputs["X"]
    kh, kw = attrs["kernels"]
    sh, sw = attrs.get("strides", [1, 1])
    up, left, down, right = list(attrs.get("paddings", [0, 0, 0, 0]))
    xp = F.pad(x, [left, right, up, down])
    patches = F.unfold(xp, (kh, kw), stride=(sh, sw))  # [N, C·kh·kw, L]
    return one(patches.transpose(1, 2).reshape(-1, patches.shape[1]))


@register_op("sequence_pad", nondiff_inputs=["Length", "PadValue"],
             dp=ROWS)
def _sequence_pad(ctx, inputs, attrs):
    """sequence_pad_op.cc: re-pad [B, T, ...] + Length to `padded_length`
    time steps filled with PadValue beyond each length."""
    (x,) = inputs["X"]
    (pad_value,) = inputs["PadValue"]
    (length,) = inputs["Length"]
    padded_len = attrs.get("padded_length", -1)
    t = x.shape[1]
    if padded_len is None or padded_len < 0:
        padded_len = t
    if padded_len >= t:
        out = F.pad(x, [0, 0] * (x.ndim - 2) + [0, padded_len - t])
    else:
        out = x[:, :padded_len]
    mask = _trail(_mask_from_len(length, padded_len, torch.bool), out.ndim)
    pv = torch.as_tensor(pad_value, dtype=out.dtype,
                         device=out.device).reshape(
        (1, 1) + (1,) * (out.ndim - 2))
    out = torch.where(mask, out, pv)
    return {"Out": [out], "Length": [torch.clamp(length, max=padded_len)]}


@register_op("sequence_unpad", nondiff_inputs=["Length"], dp=ROWS)
def _sequence_unpad(ctx, inputs, attrs):
    """sequence_unpad_op.cc: drop the pad region. Static shapes keep
    [B, T, ...]; padding positions are zeroed."""
    (x,) = inputs["X"]
    (length,) = inputs["Length"]
    return one(x * _trail(_mask_from_len(length, x.shape[1], x.dtype),
                          x.ndim))


@register_op("sequence_conv", nondiff_inputs=["Length"], dp=ROWS)
def _sequence_conv(ctx, inputs, attrs):
    """sequence_conv_op.cc: context-window projection over the time axis:
    a [ctx·D] window per step (zero beyond the sequence), then one
    [B·T, ctx·D]×[ctx·D, M] product (math/context_project.h's im2col)."""
    (x,) = inputs["X"]                      # [B, T, D]
    (filt,) = inputs["Filter"]              # [ctx*D, M]
    length = inputs.get("Length", [None])[0]
    ctx_len = int(attrs.get("contextLength", 3))
    ctx_start = int(attrs.get("contextStart", -((ctx_len - 1) // 2)))
    t = x.shape[1]
    mask = None
    if length is not None:
        mask = _mask_from_len(length, t, x.dtype)[..., None]
        x = x * mask
    steps = torch.arange(t, device=x.device)
    cols = []
    for j in range(ctx_len):
        off = ctx_start + j
        shifted = torch.roll(x, -off, dims=1)
        valid = ((steps + off >= 0) & (steps + off < t))[None, :, None]
        cols.append(torch.where(valid, shifted, torch.zeros((), dtype=x.dtype,
                                                            device=x.device)))
    windows = torch.cat(cols, dim=-1)                  # [B, T, ctx*D]
    out = torch.matmul(windows.float(), filt.float()).to(x.dtype)
    if mask is not None:
        out = out * mask
    return one(out)


@register_op("sequence_slice", nondiff_inputs=["Offset", "Length"],
             dp=ROWS)
def _sequence_slice(ctx, inputs, attrs):
    """sequence_slice_op.cc: per-row (offset, length) slice along time.
    Output stays [B, T, ...]; positions >= length are zeroed."""
    (x,) = inputs["X"]
    (offset,) = inputs["Offset"]
    (length,) = inputs["Length"]
    t = x.shape[1]
    idx = offset.reshape(-1, 1).long() + torch.arange(t, device=x.device)
    out = _take_steps(x, torch.clamp(idx, 0, t - 1))
    return one(out * _trail(_mask_from_len(length, t, x.dtype), x.ndim))


@register_op("sequence_erase", differentiable=False, dp=ROWS)
def _sequence_erase(ctx, inputs, attrs):
    """sequence_erase_op.cc: remove the tokens in `tokens` and left-compact
    the rest. Output stays [B, T] zero-padded, with the new lengths."""
    (x,) = inputs["X"]                      # [B, T] int
    length = inputs.get("Length", [None])[0]
    tokens = torch.as_tensor(list(attrs.get("tokens", [])), dtype=x.dtype,
                             device=x.device)
    b, t = x.shape
    in_range = (torch.arange(t, device=x.device)[None, :]
                < length.reshape(-1, 1)) if length is not None \
        else torch.ones((b, t), dtype=torch.bool, device=x.device)
    keep = in_range & ~torch.isin(x, tokens)
    new_pos = torch.cumsum(keep.long(), dim=1) - 1      # target index
    # a dropped token adds 0 at the previous kept slot (before the first
    # kept one, at slot 0); kept tokens land left-compacted
    out = torch.zeros_like(x).scatter_add_(
        1, torch.clamp(new_pos, min=0), torch.where(keep, x,
                                                    torch.zeros_like(x)))
    new_len = keep.sum(dim=1).to(
        length.dtype if length is not None else torch.int32)
    return {"Out": [out], "Length": [new_len]}


@register_op("sequence_expand_as", nondiff_inputs=["Y", "Length"], dp=ROWS)
def _sequence_expand_as(ctx, inputs, attrs):
    """sequence_expand_as_op.cc: each row of X across Y's time axis, masked
    by Y's length."""
    (x,) = inputs["X"]                      # [B, ...]
    (y,) = inputs["Y"]                      # [B, T, ...]
    length = inputs.get("Length", [None])[0]
    t = y.shape[1]
    out = x[:, None].expand((x.shape[0], t) + tuple(x.shape[1:]))
    if length is not None:
        out = out * _trail(_mask_from_len(length, t, out.dtype), out.ndim)
    return one(out)


@register_op("sequence_enumerate", differentiable=False, dp=ROWS)
def _sequence_enumerate(ctx, inputs, attrs):
    """sequence_enumerate_op.cc: sliding win_size-grams along time;
    positions past the end take pad_value."""
    (x,) = inputs["X"]                      # [B, T] int
    length = inputs.get("Length", [None])[0]
    win = int(attrs.get("win_size", 2))
    pad_value = torch.as_tensor(attrs.get("pad_value", 0), dtype=x.dtype,
                                device=x.device)
    t = x.shape[1]
    lens = length.reshape(-1, 1) if length is not None else t
    steps = torch.arange(t, device=x.device)
    grams = [torch.where((steps + j)[None, :] < lens,
                         torch.roll(x, -j, dims=1), pad_value)
             for j in range(win)]
    return one(torch.stack(grams, dim=-1))   # [B, T, win]


@register_op("sequence_reshape", nondiff_inputs=["Length"], dp=ROWS)
def _sequence_reshape(ctx, inputs, attrs):
    """sequence_reshape_op.cc: re-chunk each sequence's row-major [T, D]
    stream into [T·D/new_dim, new_dim]; the tail padding stays contiguous,
    so a plain reshape is exact. New length = len·D/new_dim."""
    (x,) = inputs["X"]                      # [B, T, D]
    length = inputs.get("Length", [None])[0]
    new_dim = int(attrs["new_dim"])
    b, t, d = x.shape
    if (t * d) % new_dim:
        raise ValueError(f"sequence_reshape: T*D={t*d} not divisible by "
                         f"new_dim={new_dim}")
    outs = {"Out": [x.reshape(b, (t * d) // new_dim, new_dim)]}
    if length is not None:
        outs["Length"] = [(length * d) // new_dim]
    return outs


@register_op("sequence_scatter", nondiff_inputs=["Ids", "Length"], dp=ROWS)
def _sequence_scatter(ctx, inputs, attrs):
    """sequence_scatter_op.cc: out[b, ids[b, s]] += updates[b, s] for
    s < length[b]."""
    (x,) = inputs["X"]                      # [B, N]
    (ids,) = inputs["Ids"]                  # [B, S] int
    (upd,) = inputs["Updates"]              # [B, S]
    length = inputs.get("Length", [None])[0]
    b, s = ids.shape
    if length is not None:
        valid = (torch.arange(s, device=x.device)[None, :]
                 < length.reshape(-1, 1))
        upd = torch.where(valid, upd, torch.zeros((), dtype=upd.dtype,
                                                  device=upd.device))
    rows = torch.arange(b, device=x.device)[:, None].expand(b, s)
    return one(x.index_put((rows, ids.long()), upd.to(x.dtype),
                           accumulate=True))


@register_op("sequence_topk_avg_pooling", differentiable=False,
             nondiff_inputs=["Length"], dp=ROWS)
def _sequence_topk_avg_pooling(ctx, inputs, attrs):
    """sequence_topk_avg_pooling_op.cc: per (batch, channel), the average
    of the top-k values over the unmasked steps, one column per k."""
    (x,) = inputs["X"]                      # [B, C, T]
    length = inputs.get("Length", [None])[0]
    topks = list(attrs.get("topks", [1]))
    b, c, t = x.shape
    if length is not None:
        mask = _mask_from_len(length, t, x.dtype)[:, None, :]
        x = torch.where(mask > 0, x, torch.finfo(x.dtype).min)
    sorted_desc = torch.sort(x, dim=-1, descending=True).values
    cols = []
    for k in topks:
        k = min(int(k), t)
        top = sorted_desc[..., :k]
        if length is not None:
            kk = torch.clamp(length, max=k).reshape(-1, 1, 1).to(x.dtype)
            valid = torch.arange(k, device=x.device)[None, None, :] < kk
            top = torch.where(valid, top, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
            cols.append(top.sum(-1) / torch.clamp(kk[..., 0], min=1))
        else:
            cols.append(top.mean(-1))
    return one(torch.stack(cols, dim=-1).reshape(b, c * len(topks)))
