"""Packed row-major tables — O(touched-rows) sparse embedding optimization
(the packed half of ``paddle_tpu.ops.deferred_rows``).

Reference analog: the SelectedRows sparse-apply path (sgd_op.cc SelectedRows
branch, adagrad_op.cc SparseAdagradFunctor, adam_op.cc SparseAdamFunctor
lazy_mode, math/selected_rows_functor.cc MergeAdd) and the Downpour sparse
table's row layout, which keeps the optimizer accumulator beside the
embedding in the same row (g2sum in pslib's DownpourSparseTable).

A packed table is ``[V, 128]`` uint16: each row bit-splits up to 64 f32
values — the visible columns, then the optimizer's state columns — so one
row gather reads a row's parameters and state together. Each step the
``*_row_packed`` ops merge the step's SelectedRows gradient by id
(``uniq_merge``), compute the exact optimizer update on the touched rows and
write those rows back: serial-exact semantics with no pending state.

The port writes the rows back in place (the JAX package's ``.at[].set``
returns a new table): the table is the scope's tensor, and the lookup's
forward gather is a copy, so nothing else holds the old bytes.
``adagrad_row_packed`` runs the fused kernel (row 12,
``kernels/sparse_adagrad.py``) unless the op was built with ``fused=False``
or ``PDTPU_FUSED_SPARSE=0``; on a CPU tensor the kernel's plain version
runs. The deferred-row log (``lookup_join``, ``*_row_deferred``,
``deferred_fold``) is not ported.
"""
from __future__ import annotations

import torch

from ..core.registry import register_op
from ..core.selected_rows import SelectedRows, segment_sums
from .kernels import sparse_adagrad as _fused_adagrad
from .kernels.sparse_adagrad import (PACK_LANES, SENTINEL, i16,  # noqa: F401
                                     pack_rows, sqrt_rn, take_rows,
                                     unpack_rows)

# ---------------------------------------------------------------------------
# unique-merge (MergeAdd parity, selected_rows_functor.cc)
# ---------------------------------------------------------------------------


def uniq_merge(ids, rows, r: int):
    """Combine duplicate ids; also return a representative original
    position per unique id (for reusing forward-gathered rows).

    ids [Q], rows [Q, D] -> (uids [r] ascending + SENTINEL pads, utot
    [r, D] summed rows, rep [r] original index of one occurrence). r >= Q
    is required (static capacity). Duplicates are summed in occurrence
    order, one after another, as the JAX package's scatter-add does on
    the CPU, so the sums are the same bits on every device."""
    qn = ids.shape[0]
    d = rows.shape[-1]
    if qn > r:
        raise ValueError(
            f"deferred rows_per_step={r} is smaller than this step's "
            f"{qn} lookup rows — raise rows_per_step (static capacity)")
    dev = rows.device
    uids = torch.full((r,), SENTINEL, dtype=torch.int64, device=dev)
    utot = torch.zeros((r, d), dtype=rows.dtype, device=dev)
    rep = torch.zeros((r,), dtype=torch.int64, device=dev)
    if qn == 0:
        return uids, utot, rep
    ids = ids.long()
    order, seg, sums = segment_sums(ids, rows)
    rep[:qn].scatter_reduce_(0, seg, order, "amax")
    nu = seg[-1] + 1
    uids[:qn] = torch.where(torch.arange(qn, device=dev) < nu, ids[rep[:qn]],
                            SENTINEL)
    utot[:qn] = sums
    return uids, utot, rep


def _grad_rows(g):
    if not isinstance(g, SelectedRows):
        raise TypeError(
            "packed-row optimizer ops need a SelectedRows gradient "
            "(embedding built with is_sparse=True); got a dense array")
    return g.ids, g.rows


def _lr(inputs):
    (lr,) = inputs["LearningRate"]
    return lr.reshape(())


# ---------------------------------------------------------------------------
# table initialization (startup ops)
# ---------------------------------------------------------------------------

_CHUNK = 1 << 20  # rows per init chunk: a whole-table f32 temporary of a
# 33.5M-row table would need ~2.5x the packed table's 8.59 GB


@register_op("rowpack_init", differentiable=False)
def _rowpack_init(ctx, inputs, attrs):
    """Initialize a packed table: visible columns ~ U(low, high), state
    columns = state_value, packed to [V, lanes] uint16, in row chunks.

    The chunks draw from a generator of their own, seeded by one draw of
    the run's generator (the JAX package folds the chunk index into one
    key): the table's height does not shift the numbers the ops after it
    draw, so two programs that differ only in the table's height (a PS
    cache of another size) initialize their other parameters alike."""
    v = int(attrs["height"])
    vis = int(attrs["vis"])
    dt = int(attrs["dt"])
    low, high = attrs.get("low", -0.1), attrs.get("high", 0.1)
    sv = attrs.get("state_value", 0.0)
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=ctx.rng(),
                             device=ctx.device))
    gen = torch.Generator(ctx.device).manual_seed(seed)
    out = torch.empty((v, PACK_LANES), dtype=torch.int16, device=ctx.device)
    for start in range(0, v, _CHUNK):
        n = min(_CHUNK, v - start)
        rows = torch.full((n, dt), sv, dtype=torch.float32, device=ctx.device)
        rows[:, :vis] = low + (high - low) * torch.rand(
            (n, vis), generator=gen, device=ctx.device)
        out[start:start + n] = i16(pack_rows(rows))
    return {"Out": [out.view(torch.uint16)]}


@register_op("rowpack_init_state_cols", differentiable=False)
def _rowpack_init_state_cols(ctx, inputs, attrs):
    """Startup-time re-init of a packed table's state columns, in place and
    in row chunks: columns [vis:dt] take the optimizer's initial value
    (adagrad initial_accumulator_value / adam 0) whatever the table
    initializer wrote there."""
    (p,) = inputs["Param"]
    vis = int(attrs["vis"])
    dt = int(attrs["dt"])
    val = attrs.get("value", 0.0)
    for start in range(0, p.shape[0], _CHUNK):
        chunk = p[start:start + _CHUNK]
        rows = unpack_rows(chunk, dt)
        rows[:, vis:] = val
        i16(chunk).copy_(i16(pack_rows(rows, p.shape[1])))
    return {"ParamOut": [p]}


# ---------------------------------------------------------------------------
# optimizer ops
# ---------------------------------------------------------------------------

def _packed_common(inputs, attrs):
    """uniq-merge the SelectedRows grad and pull the current rows out of
    the lookup's forward output (no second table gather)."""
    (g,) = inputs["Grad"]
    (fwd_rows,) = inputs["FwdRows"]
    r = int(attrs["rows_per_step"])
    vis = int(attrs["vis"])
    dt = fwd_rows.shape[-1]
    ids, grows = _grad_rows(g)
    uids, utot, rep = uniq_merge(ids, grows[:, :vis].to(torch.float32), r)
    cur_u = fwd_rows.reshape(-1, dt)[rep].to(torch.float32)
    valid = (uids != SENTINEL)[:, None]
    return uids, utot, cur_u, valid, vis, dt


def _packed_write(p, uids, new_rows):
    """Write the valid slots' rows back into the table in place."""
    valid = uids != SENTINEL
    i16(p).index_copy_(0, uids[valid], i16(pack_rows(new_rows))[valid])
    return p


@register_op("sgd_row_packed", differentiable=False)
def _sgd_row_packed(ctx, inputs, attrs):
    """sgd_op.cc SelectedRows branch on a packed table: touched rows get
    p -= lr * merged_g."""
    (p,) = inputs["Param"]
    uids, utot, cur_u, valid, vis, dt = _packed_common(inputs, attrs)
    new = torch.where(valid, cur_u[:, :vis] - _lr(inputs) * utot,
                      cur_u[:, :vis])
    return {"ParamOut": [_packed_write(p, uids, new)]}


@register_op("adagrad_row_packed", differentiable=False)
def _adagrad_row_packed(ctx, inputs, attrs):
    """adagrad_op.cc SparseAdagradFunctor on a packed table: G rides in the
    state columns; touched rows advance G += g², p -= lr·g/(√G+eps).

    The fused branch is one pass of row 12 over the touched rows, read
    straight from the table (the same bytes FwdRows was gathered from: the
    table does not change between the forward and the update). The
    unfused branch reuses the forward's rows and writes with an indexed
    store. Both give the same bits."""
    (p,) = inputs["Param"]
    eps = attrs.get("epsilon", 1e-6)
    vis = int(attrs["vis"])
    if attrs.get("fused", True) and _fused_adagrad.enabled(vis, p.shape[-1]):
        (g,) = inputs["Grad"]
        ids, grows = _grad_rows(g)
        uids, utot, _rep = uniq_merge(ids, grows[:, :vis].to(torch.float32),
                                      int(attrs["rows_per_step"]))
        return {"ParamOut": [_fused_adagrad.fused_adagrad_update(
            p, uids, utot, _lr(inputs), vis=vis, eps=eps)]}
    uids, utot, cur_u, valid, vis, dt = _packed_common(inputs, attrs)
    g_new = cur_u[:, vis:2 * vis] + utot * utot
    p_new = cur_u[:, :vis] - _lr(inputs) * utot / (sqrt_rn(g_new) + eps)
    rows = torch.where(valid, torch.cat([p_new, g_new], dim=-1),
                       cur_u[:, :2 * vis])
    return {"ParamOut": [_packed_write(p, uids, rows)]}


@register_op("adam_row_packed", differentiable=False)
def _adam_row_packed(ctx, inputs, attrs):
    """adam_op.cc SparseAdamFunctor lazy_mode on a packed table: m/v ride
    in state columns; beta powers advance per step as scalars."""
    (p,) = inputs["Param"]
    uids, utot, cur_u, valid, vis, dt = _packed_common(inputs, attrs)
    (b1p,) = inputs["Beta1Pow"]
    (b2p,) = inputs["Beta2Pow"]
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr_t = _lr(inputs) * torch.sqrt(1 - b2p.reshape(())) / (
        1 - b1p.reshape(()))
    m_new = b1 * cur_u[:, vis:2 * vis] + (1 - b1) * utot
    v_new = b2 * cur_u[:, 2 * vis:3 * vis] + (1 - b2) * utot * utot
    p_new = cur_u[:, :vis] - lr_t * m_new / (torch.sqrt(v_new) + eps)
    rows = torch.where(valid, torch.cat([p_new, m_new, v_new], dim=-1),
                       cur_u[:, :3 * vis])
    return {"ParamOut": [_packed_write(p, uids, rows)],
            "Beta1PowOut": [b1p * b1], "Beta2PowOut": [b2p * b2]}
