"""Conv, pooling, normalization, dropout, embedding and loss ops
(counterpart of the matching registrations in ``paddle_tpu.ops.nn_ops``;
reference conv_op.cc, pool_op.cc, batch_norm_op.cc, layer_norm_op.cc,
dropout_op.cc, lookup_table_op.cc, softmax_with_cross_entropy_op.cc).

Convolutions are ``F.conv2d`` (cuDNN on the card), as the JAX package leaves
them to XLA outside any Pallas kernel; 4-D activations are kept channels-last
in memory (``common.conv2d_nchw``) so that the fused batch-norm kernels read
them in place."""
from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from ..core.mesh_step import batch_group, sp_shard, tp_shard
from ..core.registry import P, ROWS, TP, Whole, register_op
from ..core.selected_rows import SelectedRows
from ..parallel.collective import axis_size, psum
from .common import (BN_GLOBAL_OUT, act_map, bn_batch_stats_xla1,
                     bn_global_moments, bn_normalize, conv2d_nchw, one)
from .deferred_rows import lookup_join
from .kernels import fused_bn
from .kernels.sparse_adagrad import take_rows, unpack_rows


def _pair(v, n=2):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _same_pads(size, k, s, d):
    """lax "SAME" padding of one spatial dim: (low, high)."""
    out = -(-size // s)
    total = max((out - 1) * s + (k - 1) * d + 1 - size, 0)
    return total // 2, total - total // 2


@register_op("conv2d", nondiff_inputs=[], dp=ROWS)
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


def _out_pads_from_output_size(x, w, attrs, nd):
    """Resolve the reference's output_size attr into trailing output
    padding (the JAX package's rule): output_size must lie in
    [default, default + stride)."""
    output_size = attrs.get("output_size")
    if not output_size:
        return (0,) * nd
    strides = _pair(attrs.get("strides", [1] * nd), nd)
    pads = _pair(attrs.get("paddings", [0] * nd), nd)
    dils = _pair(attrs.get("dilations", [1] * nd), nd)
    ks = w.shape[2:]
    out_pads = []
    for i, want in enumerate(_pair(output_size, nd)):
        default = ((x.shape[2 + i] - 1) * strides[i] - 2 * pads[i]
                   + dils[i] * (ks[i] - 1) + 1)
        extra = int(want) - default
        if not 0 <= extra < strides[i]:
            raise ValueError(
                f"conv_transpose output_size[{i}]={want} must be in "
                f"[{default}, {default + strides[i] - 1}]")
        out_pads.append(extra)
    return tuple(out_pads)


def conv_transpose_nd(x, w, attrs, nd):
    """conv_transpose_op.cc: out = (i-1)·s − 2p + d·(k−1) + 1 (+ the
    output_size's trailing padding); `w` is the reference layout
    [C_in, C_out/groups, *k], torch's own for a transposed conv."""
    fn = {2: F.conv_transpose2d, 3: F.conv_transpose3d}[nd]
    return fn(x, w, None, _pair(attrs.get("strides", [1] * nd), nd),
              _pair(attrs.get("paddings", [0] * nd), nd),
              _out_pads_from_output_size(x, w, attrs, nd),
              int(attrs.get("groups", 1)),
              _pair(attrs.get("dilations", [1] * nd), nd))


@register_op("conv2d_transpose", dp=ROWS)
def _conv2d_transpose(ctx, inputs, attrs):
    (x,) = inputs["Input"]
    (w,) = inputs["Filter"]
    return one(conv_transpose_nd(x, w, attrs, 2))


@register_op("conv3d", dp=ROWS)
def _conv3d(ctx, inputs, attrs):
    (x,) = inputs["Input"]
    (w,) = inputs["Filter"]
    return one(F.conv3d(x, w, None, _pair(attrs.get("strides", [1] * 3), 3),
                        _pair(attrs.get("paddings", [0] * 3), 3),
                        _pair(attrs.get("dilations", [1] * 3), 3),
                        int(attrs.get("groups", 1))))


@register_op("pool2d", dp=ROWS)
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


@register_op("batch_norm", nondiff_inputs=["Mean", "Variance"],
             dp=BN_GLOBAL_OUT)
def _batch_norm(ctx, inputs, attrs):
    """batch_norm_op.cc: batch statistics and a running-stat update in
    training, frozen statistics in test. ``PDTPU_BN_MODE`` (read at run
    time, as in the JAX package) picks the training statistics:
    "xla1" (default) one-pass f32, "xla2" two-pass, "pallas" the fused-BN
    kernels (``fused_bn_act``, relu folded in), "pallas_stats" the
    statistics kernel with a frozen-stats gradient (a perf probe). The
    kernels take only NCHW inputs that pass ``fused_bn.supports``; on a CPU
    tensor they run as their plain versions. On a data-parallel mesh the
    training statistics are the whole group's batch
    (``mesh_step.batch_group``)."""
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
    dp = batch_group(ctx, "X")
    if (bn_mode.startswith("pallas") and layout == "NCHW"
            and act in ("", "relu") and fused_bn.supports(x.shape, x.dtype)):
        if bn_mode == "pallas_stats":
            bmean, bvar = fused_bn.bn_stats(x.detach())
            if dp is not None:
                bmean, bvar = bn_global_moments(dp, bmean, bvar)
            y = bn_normalize(x, bmean, bvar, scale, bias, eps, shape)
            y = act_map()[act](y)
        else:
            y, bmean, bvar = fused_bn.fused_bn_act(x, scale, bias, eps, act,
                                                   False, dp=dp)
        return outs(y, momentum * mean + (1.0 - momentum) * bmean,
                    momentum * var + (1.0 - momentum) * bvar, bmean, bvar)
    # statistics always in f32; x itself stays in its own dtype (the op is
    # AMP-gray, so a bf16 conv trunk never round-trips through f32 memory)
    if bn_mode == "xla2" and dp is not None:
        count = axis_size(dp) * math.prod(x.shape[a] for a in axes)
        use_mean = psum(x.float().sum(dim=axes), dp) / count
        c = x.float() - use_mean.reshape(shape)
        use_var = psum((c * c).sum(dim=axes), dp) / count
    elif bn_mode == "xla2":
        use_mean = torch.mean(x.float(), dim=axes)
        use_var = torch.var(x.float(), dim=axes, correction=0)
    else:
        use_mean, use_var = bn_batch_stats_xla1(x, axes, dp)
    y = bn_normalize(x, use_mean, use_var, scale, bias, eps, shape)
    return outs(act_map()[act](y), momentum * mean + (1.0 - momentum)
                * use_mean, momentum * var + (1.0 - momentum) * use_var,
                use_mean, use_var)


def _layer_norm_sp(attrs, lay, shapes, n):
    """Normalized over the dims from begin_norm_axis: a slice of a dim
    before them stays (the statistics are the slice's rows)."""
    (d,) = lay["X"]
    if d is not None and d < attrs.get("begin_norm_axis", 1) % len(
            shapes["X"][0]):
        return TP(out={"Y": d, "Mean": d, "Variance": d})
    return None


# normalized from dim 0 on a data axis: the whole batch's statistics, each
# rank keeping its rows of Y (core/registry.py's Whole)
@register_op("group_norm", dp=ROWS)
def _group_norm(ctx, inputs, attrs):
    """group_norm_op.cc: each sample's channels in `groups` groups,
    normalised over (channels of the group, spatial); NHWC is normalised
    channels-first and restored."""
    (x,) = inputs["X"]
    scale = inputs.get("Scale", [None])[0]
    bias = inputs.get("Bias", [None])[0]
    eps = attrs.get("epsilon", 1e-5)
    groups = attrs["groups"]
    nhwc = attrs.get("data_layout", "NCHW") == "NHWC"
    if nhwc:
        x = torch.movedim(x, -1, 1)
    n, c = x.shape[0], x.shape[1]
    rest = tuple(x.shape[2:])
    xg = x.reshape((n, groups, c // groups) + rest)
    axes = tuple(range(2, xg.ndim))
    mean = xg.mean(dim=axes, keepdim=True)
    var = xg.var(dim=axes, unbiased=False, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    cshape = (1, c) + (1,) * len(rest)
    if scale is not None:
        y = y * scale.reshape(cshape)
    if bias is not None:
        y = y + bias.reshape(cshape)
    if nhwc:
        y = torch.movedim(y, 1, -1)
    return {"Y": [y], "Mean": [mean.reshape(n, groups)],
            "Variance": [var.reshape(n, groups)]}


@register_op("layer_norm", dp=lambda a, s: Whole(rows=("Y",)) if a.get(
    "begin_norm_axis", 1) % s["X"] == 0 else ROWS, sp=_layer_norm_sp)
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


@register_op("dropout", dp=ROWS, tp=lambda a, lay, sh, n: TP(
    out={"Out": lay["X"][0], "Mask": lay["X"][0]}),
    sp=lambda a, lay, sh, n: TP(
        out={"Out": lay["X"][0], "Mask": lay["X"][0]}))
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
    cuts = [sh for sh in (tp_shard(ctx, "X"), sp_shard(ctx, "X"))
            if sh is not None]
    if not cuts:
        mask = torch.bernoulli(torch.full_like(x, 1.0 - p),
                               generator=ctx.rng())
    else:
        # this rank's slice of the whole value's mask (on a model and a
        # sequence axis at once, its block): the ranks of the axes draw
        # the same numbers, and every rank advances the generator alike
        shape = list(x.shape)
        for sh in cuts:
            shape[sh.dim] *= sh.size
        mask = torch.bernoulli(x.new_full(shape, 1.0 - p),
                               generator=ctx.rng())
        for sh in cuts:
            mask = mask.narrow(sh.dim, sh.rank * x.shape[sh.dim],
                               x.shape[sh.dim])
    y = x * mask / (1.0 - p) if impl == "upscale_in_train" else x * mask
    return {"Out": [y], "Mask": [mask]}


def _lookup_sparse_grad(attrs):
    """lookup_table_op.cc is_sparse=True GradOpMaker analog: the table's
    cotangent is SelectedRows (ids, dOut rows), never a [vocab, dim] dense
    gradient. The executor differentiates with respect to the lookup's
    output and hands its cotangent here, which is also how a packed uint16
    table (no autograd through integers) gets its rows. Packed tables keep
    f32 gradient rows; padding_idx rows get zero gradient."""
    if not attrs.get("is_sparse"):
        return None  # dense path: autograd through the gather

    def grad(ctx, inputs, attrs2, outputs, out_cots):
        (w,) = inputs["W"]
        (ids,) = inputs["Ids"]
        (g,) = out_cots["Out"]
        flat_ids = _squeezed(ids).reshape(-1).long()
        rows = g.reshape(-1, g.shape[-1])
        if not attrs2.get("row_pack_dt"):
            rows = rows.to(w.dtype)
        padding_idx = attrs2.get("padding_idx", -1)
        if padding_idx is not None and padding_idx >= 0:
            rows = rows.masked_fill((flat_ids == padding_idx)[:, None], 0.0)
        out = {"W": [SelectedRows(flat_ids, rows, w.shape[0])],
               "Ids": [None]}
        # the pending deferred-row state is optimizer state, not a
        # differentiable input
        for slot in ("PendingPos", "PendingCum"):
            if slot in inputs:
                out[slot] = [None]
        return out

    return grad


def _squeezed(ids):
    return ids[..., 0] if ids.ndim >= 2 and ids.shape[-1] == 1 else ids


def _gather_rows(w, idx, attrs, ctx=None):
    slots, mine = _local_ids(ctx, w, idx)
    out = w[slots]
    if mine is not None:
        out = out.masked_fill(~mine[..., None], 0.0)
    padding_idx = attrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = out.masked_fill((idx == padding_idx)[..., None], 0.0)
    return out


def _lookup_dp(attrs, sharded):
    """Rows of the table for each id: row by row in the ids."""
    return None if "W" in sharded else ROWS


def _lookup_tp(attrs, lay, shapes, n):
    """A vocab-sharded table (W sliced along its rows): each rank reads
    the ids of its rows and zeros for the rest, so the output is the sum
    over the axis (P). Row-wise ids keep their slice."""
    (dw,) = lay["W"]
    (di,) = lay["Ids"]
    if dw == 0 and di is None and "PendingPos" not in lay:
        return TP(out={"Out": P})
    if dw is None and di is not None and di < len(shapes["Ids"][0]) - 1:
        return TP(out={"Out": di})
    return None


def _local_ids(ctx, w, idx):
    """(ids in this rank's slots, clamped, and the mask of the ids that are
    this rank's) for a vocab-sharded W, or (idx, None)."""
    sh = tp_shard(ctx, "W")
    if sh is None or sh.dim != 0:
        return idx, None
    local = idx - sh.rank * w.shape[0]
    mine = (local >= 0) & (local < w.shape[0])
    return local.clamp(0, w.shape[0] - 1), mine


def _lookup_sp(attrs, lay, shapes, n):
    """Ids sliced along a dim (the sequence) give the rows of that slice;
    a trailing ids dim of 1 is not one of the output's."""
    (dw,) = lay["W"]
    (di,) = lay["Ids"]
    ids = shapes["Ids"][0]
    if dw is None and di is not None and (di < len(ids) - 1 or ids[-1] != 1):
        return TP(out={"Out": di})
    return None


@register_op("lookup_table", nondiff_inputs=["Ids", "PendingPos", "PendingCum"],
             grad_fn=_lookup_sparse_grad, dp=_lookup_dp, tp=_lookup_tp,
             sp=_lookup_sp)
def _lookup_table(ctx, inputs, attrs):
    """lookup_table_op.cc: W[ids]; padding_idx rows produce zeros. With
    ``row_pack_dt`` the table is a packed row-major [V, 128] uint16 array
    (``ops/deferred_rows.py``): a full-row gather (a copy), then a
    bit-exact unpack of the dt f32 values.

    With PendingPos/PendingCum inputs (wired by a deferred-row optimizer,
    ``ops/deferred_rows.py``) the read adds each id's pending cumulative
    delta to the base gather (``lookup_join``), so a lookup sees the exact
    serial-update value whatever the fold cadence — the analog of the
    reference's distributed_lookup_table prefetch rewrite
    (parameter_prefetch.cc). Out is formed as the JAX package forms it,
    ``(cur - base).detach() + base`` (the same bits, and the gradient stays
    on the base gather); CumOut feeds the deferred optimizer op, which
    reuses these gathers instead of issuing its own."""
    (w,) = inputs["W"]
    (ids,) = inputs["Ids"]
    idx = _squeezed(ids)
    rp_dt = attrs.get("row_pack_dt")
    if "PendingPos" in inputs:
        (postab,) = inputs["PendingPos"]
        (log_cum,) = inputs["PendingCum"]
        out = w[idx]
        q = idx.reshape(-1)
        cur, cum = lookup_join(postab, log_cum,
                               out.reshape(q.shape[0], -1), q)
        shp = tuple(idx.shape) + (w.shape[-1],)
        out = (cur.reshape(shp) - out).detach() + out
        padding_idx = attrs.get("padding_idx", -1)
        if padding_idx is not None and padding_idx >= 0:
            out = out.masked_fill((idx == padding_idx)[..., None], 0.0)
        return {"Out": [out], "CumOut": [cum.reshape(shp).detach()]}
    if not rp_dt:
        return one(_gather_rows(w, idx, attrs, ctx))
    slots, mine = _local_ids(ctx, w, idx)
    out = unpack_rows(take_rows(w, slots.reshape(-1)), int(rp_dt))
    out = out.reshape(tuple(idx.shape) + (int(rp_dt),))
    if mine is not None:
        out = out.masked_fill(~mine[..., None], 0.0)
    padding_idx = attrs.get("padding_idx", -1)
    if padding_idx is not None and padding_idx >= 0:
        out = out.masked_fill((idx == padding_idx)[..., None], 0.0)
    return one(out)


@register_op("lookup_table_v2", nondiff_inputs=["Ids"],
             grad_fn=_lookup_sparse_grad, dp=_lookup_dp, tp=_lookup_tp)
def _lookup_table_v2(ctx, inputs, attrs):
    (w,) = inputs["W"]
    (ids,) = inputs["Ids"]
    return one(_gather_rows(w, ids, attrs, ctx))


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


class _VocabParallelCE(torch.autograd.Function):
    """`_HardLabelCE` on logits sliced along the class axis (a vocab-
    parallel head): the global max is taken before ``exp`` (bf16 logits
    would overflow otherwise), then the sums of exp and the target logits
    are summed over the group; each rank's slice of the gradient is
    p − onehot on its classes. The loss is the same on every rank."""

    @staticmethod
    def forward(ctx, logits, idx, axis, ignore, sh):
        from ..parallel.collective import summed

        ax = axis % logits.ndim
        width = logits.shape[ax]
        m = logits.amax(dim=ax, keepdim=True).float()
        torch.distributed.all_reduce(m, torch.distributed.ReduceOp.MAX,
                                     group=sh.group)
        e = summed(torch.exp(logits.float() - m).sum(ax, True), sh.group)
        lse = m + torch.log(e)
        safe = idx if ignore is None else idx.masked_fill(idx == ignore, 0)
        local = safe - sh.rank * width
        mine = (local >= 0) & (local < width)
        slot = local.clamp(0, width - 1)
        picked = torch.gather(logits, ax, slot.unsqueeze(ax)).float()
        picked = summed(picked.masked_fill(~mine.unsqueeze(ax), 0.0),
                        sh.group)
        loss = lse - picked
        if ignore is not None:
            loss = loss.masked_fill((idx == ignore).unsqueeze(ax), 0.0)
        ctx.save_for_backward(logits, slot, mine, lse)
        ctx.mark_non_differentiable(lse)
        ctx.ax = ax
        ctx.dropped = None if ignore is None else (idx == ignore)
        return loss, lse

    @staticmethod
    def backward(ctx, g, _glse):
        logits, slot, mine, lse = ctx.saved_tensors
        ax = ctx.ax
        p = torch.exp(logits.float() - lse)
        p.scatter_add_(ax, slot.unsqueeze(ax),
                       -mine.to(p.dtype).unsqueeze(ax))
        if ctx.dropped is not None:
            g = g.masked_fill(ctx.dropped.unsqueeze(ax), 0.0)
        return (p * g).to(logits.dtype), None, None, None, None


def _ce_tp(attrs, lay, shapes, n):
    """Hard labels on logits sliced along the class axis: the vocab-
    parallel exchange (`_VocabParallelCE`); the loss is whole, the
    softmax keeps the slice."""
    (d,) = lay["Logits"]
    ax = attrs.get("axis", -1) % len(shapes["Logits"][0])
    if attrs.get("soft_label", False) or lay["Label"][0] is not None:
        return None
    if d == ax:
        return TP(out={"Loss": None, "Softmax": d})
    return TP(out={"Loss": d, "Softmax": d})


def _ce_sp(attrs, lay, shapes, n):
    """Logits and hard labels sliced along the same row dim: the loss and
    the softmax keep the slice."""
    (d,) = lay["Logits"]
    ax = attrs.get("axis", -1) % len(shapes["Logits"][0])
    if (attrs.get("soft_label", False) or d is None or d == ax
            or lay["Label"][0] != d):
        return None
    return TP(out={"Loss": d, "Softmax": d})


@register_op("softmax_with_cross_entropy", nondiff_inputs=["Label"],
             dp=lambda a, s: None if a.get("axis", -1)
             % s.get("Logits", 2) == 0 else ROWS, tp=_ce_tp, sp=_ce_sp)
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
        sh = tp_shard(ctx, "Logits")
        if sh is not None and sh.dim == ax:
            loss, lse = _VocabParallelCE.apply(
                logits, idx.long(), axis, attrs.get("ignore_index", -100), sh)
            softmax = (torch.exp(logits.float() - lse.detach())
                       if ctx.wants("Softmax") else None)
            return {"Loss": [loss], "Softmax": [softmax]}
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


@register_op("sigmoid_cross_entropy_with_logits", nondiff_inputs=["Label"],
             dp=lambda a, s: None if a.get("normalize", False) else ROWS)
def _sigmoid_ce(ctx, inputs, attrs):
    """max(x, 0) − x·label + log(1 + exp(−|x|)); label == ignore_index gives
    0; `normalize` divides by the count of labels that are not ignored."""
    (x,) = inputs["X"]
    (label,) = inputs["Label"]
    loss = (torch.maximum(x, torch.zeros_like(x)) - x * label
            + torch.log1p(torch.exp(-torch.abs(x))))
    ignore = attrs.get("ignore_index", -100)
    loss = torch.where(label == ignore, torch.zeros_like(loss), loss)
    if attrs.get("normalize", False):
        n = torch.clamp_min((label != ignore).to(loss.dtype).sum(), 1.0)
        loss = loss / n
    return one(loss)


@register_op("square_error_cost", nondiff_inputs=["Label"], dp=ROWS)
def _square_error_cost(ctx, inputs, attrs):
    (x,) = inputs["X"]
    (label,) = inputs["Label"]
    return one(torch.square(x - label))
