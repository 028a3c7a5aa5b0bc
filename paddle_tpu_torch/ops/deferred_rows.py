"""Sparse row updates — O(touched-rows) sparse embedding optimization (the
port's copy of ``paddle_tpu.ops.deferred_rows``).

Reference analog: the SelectedRows sparse-apply path (sgd_op.cc SelectedRows
branch, adagrad_op.cc SparseAdagradFunctor, adam_op.cc SparseAdamFunctor
lazy_mode, math/selected_rows_functor.cc MergeAdd) and the Downpour sparse
table's row layout, which keeps the optimizer accumulator beside the
embedding in the same row (g2sum in pslib's DownpourSparseTable).

Two representations, chosen by the optimizer's config:

The deferred-row log (``deferred_rows=``). A position table ``postab [V]
int32`` maps an id to its latest pending entry (-1 = none); an append-only
log holds ``log_ids [C] int32``, ``log_raw [C, Lw]`` (each step's deltas)
and ``log_cum [C, Lw]`` (the delta accumulated since the last fold, what a
reader adds to the base row), its rows padded to ``Lw = ceil(Dt/128)·128``
as the JAX package declares them, so a JAX scope loads unchanged. Every
lookup returns ``base[ids] + log_cum[postab[ids]]`` (``lookup_join``), the
exact serial-update value whatever the fold cadence; the ``*_row_deferred``
ops compute each touched row's delta against those current values (reused
from the lookup through the unique-merge permutation), append it and move
``postab``; ``deferred_fold`` (its own program, run by the executor's
epilogue every K steps) adds the logged deltas into the table and clears
the log. The port writes the log, ``postab`` and the fold in place (the
JAX package returns new arrays) and reads nothing back to the host: the
append lands at a device index (``clamp(count, 0, C-R) + arange(R)``, the
clamp of XLA's ``dynamic_update_slice``), ``postab``'s SENTINEL pads are
masked rather than dropped by an out-of-range index, and the fold sums each
id's entries in log order after a stable sort and adds once per id, so two
runs on the card give the same bits.

Packed row-major tables (``packed_rows=``). A packed table is ``[V, 128]``
uint16: each row bit-splits up to 64 f32 values — the visible columns, then
the optimizer's state columns — so one row gather reads a row's parameters
and state together. Each step the ``*_row_packed`` ops merge the step's
SelectedRows gradient by id (``uniq_merge``), compute the exact optimizer
update on the touched rows and write those rows back: serial-exact
semantics with no pending state. ``adagrad_row_packed`` runs the fused
kernel (row 12, ``kernels/sparse_adagrad.py``) unless the op was built with
``fused=False`` or ``PDTPU_FUSED_SPARSE=0``; on a CPU tensor the kernel's
plain version runs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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
            "sparse row-update ops need a SelectedRows gradient "
            "(embedding built with is_sparse=True); got a dense array")
    return g.ids, g.rows


def _lr(inputs):
    (lr,) = inputs["LearningRate"]
    return lr.reshape(())


# ---------------------------------------------------------------------------
# the deferred-row log: forward join (used by the lookup_table op)
# ---------------------------------------------------------------------------

def lookup_join(postab, log_cum, base_rows, q):
    """Current rows for query ids: the base gather plus the postab-indexed
    cum rows.

    postab: [V] int32; log_cum: [C, Lw] (Lw >= Dt, lane-padded); base_rows:
    [Q, Dt] (= table[q]); q: [Q] ids. Returns (cur_rows [Q, Dt], cum_rows
    [Q, Dt]). The JAX package narrows the padded log rows with a 0/1
    projection dot (a layout trick XLA needed); the column slice is the
    same function, exactly."""
    dt = base_rows.shape[-1]
    pos = postab[q.long()]
    hit = (pos >= 0)[:, None]
    cum = log_cum.index_select(0, pos.clamp(min=0).long())[:, :dt]
    cum = torch.where(hit, cum, torch.zeros((), dtype=cum.dtype,
                                            device=cum.device))
    return base_rows + cum.to(base_rows.dtype), cum


# ---------------------------------------------------------------------------
# the deferred-row log: optimizer-op machinery
# ---------------------------------------------------------------------------

def _deferred_common(inputs, attrs):
    """(uids [R], utot [R, vis], rep [R], cur_u [R, Dt], cum_u [R, Dt],
    valid [R, 1], postab, log_ids, count, R, vis, Dt): no large random
    access — the current and cum rows come from the lookup's outputs
    through the unique-merge permutation."""
    (g,) = inputs["Grad"]
    (fwd_rows,) = inputs["FwdRows"]
    (fwd_cum,) = inputs["FwdCum"]
    (postab,) = inputs["PendingPos"]
    (log_ids,) = inputs["LogIds"]
    (count,) = inputs["Count"]
    r = int(attrs["rows_per_step"])
    vis = int(attrs["vis"])
    dt = fwd_rows.shape[-1]
    ids, grows = _grad_rows(g)
    if grows.shape[-1] not in (vis, dt):
        raise ValueError(
            f"deferred op: grad rows have {grows.shape[-1]} cols, "
            f"expected vis={vis} (or padded {dt})")
    (log_raw,) = inputs["LogRaw"]
    cdt = log_raw.dtype  # compute dtype follows the table/log precision
    uids, utot, rep = uniq_merge(ids, grows[:, :vis].to(cdt), r)
    flat_rows = fwd_rows.reshape(-1, dt)
    flat_cum = fwd_cum.reshape(-1, dt)
    if flat_rows.shape[0] != ids.shape[0]:
        raise ValueError(
            f"deferred op: FwdRows carries {flat_rows.shape[0]} rows but "
            f"the gradient has {ids.shape[0]} — the rewrite requires the "
            f"single lookup site's output")
    cur_u = flat_rows[rep].to(cdt)
    cum_u = flat_cum[rep].to(cdt)
    valid = (uids != SENTINEL)[:, None]
    return (uids, utot, rep, cur_u, cum_u, valid,
            postab, log_ids, count, r, vis, dt)


def _append(inputs, outputs_extra, postab, log_ids, count, uids, raw_new,
            cum_new, valid):
    """Append the step's entries at [count, count+R) and repoint postab, in
    place and without a host read. Contract: the fold epilogue runs before
    the log wraps (the optimizer attaches it at cadence C/R); entries are
    never overwritten live. As XLA's dynamic_update_slice, the write's
    start is clamped to [0, C-R]; postab takes the unclamped positions, as
    in the JAX package."""
    (log_raw,) = inputs["LogRaw"]
    (log_cum,) = inputs["LogCum"]
    dev = log_raw.device
    c = count.reshape(()).long()
    r, dt = raw_new.shape
    lw = log_raw.shape[-1]
    zero = torch.zeros((), dtype=log_raw.dtype, device=dev)
    raw_new = torch.where(valid, raw_new, zero).to(log_raw.dtype)
    cum_new = torch.where(valid, cum_new, zero).to(log_cum.dtype)
    if lw > dt:  # lane-padded log rows
        raw_new = F.pad(raw_new, (0, lw - dt))
        cum_new = F.pad(cum_new, (0, lw - dt))
    step = torch.arange(r, device=dev)
    at = c.clamp(0, log_raw.shape[0] - r) + step
    log_ids.index_copy_(0, at, uids.to(log_ids.dtype))
    log_raw.index_copy_(0, at, raw_new)
    log_cum.index_copy_(0, at, cum_new)
    # postab[uids] = count + arange(R) for the valid slots, as an integer
    # add of (new - old): pad slot j adds 0 to row j mod V, so no row takes
    # more than one nonzero change (the valid uids are unique) and none
    # takes many adds
    v = valid[:, 0]
    safe = torch.where(v, uids, step % postab.shape[0])
    new_pos = (c + step).to(postab.dtype)
    change = torch.where(v, new_pos - postab[safe], torch.zeros_like(new_pos))
    postab.scatter_add_(0, safe, change)
    out = {"LogIdsOut": [log_ids], "LogRawOut": [log_raw],
           "LogCumOut": [log_cum], "PendingPosOut": [postab],
           "CountOut": [count + r]}
    out.update(outputs_extra)
    return out


@register_op("sgd_row_deferred", differentiable=False)
def _sgd_row_deferred(ctx, inputs, attrs):
    """sgd_op.cc SelectedRows branch, deferred: delta = -lr * merged_g."""
    (uids, utot, rep, cur_u, cum_u, valid, postab, log_ids, count,
     r, vis, dt) = _deferred_common(inputs, attrs)
    delta = -_lr(inputs) * utot
    return _append(inputs, {}, postab, log_ids, count, uids,
                   delta, cum_u + delta, valid)


@register_op("adagrad_row_deferred", differentiable=False)
def _adagrad_row_deferred(ctx, inputs, attrs):
    """adagrad_op.cc SparseAdagradFunctor, deferred: G rides in state
    columns [vis:2vis] of the row; touched rows advance G += g² and
    p -= lr·g/(√G+eps) against exact current values."""
    (uids, utot, rep, cur_u, cum_u, valid, postab, log_ids, count,
     r, vis, dt) = _deferred_common(inputs, attrs)
    if dt != 2 * vis:
        raise ValueError(
            f"adagrad_row_deferred: table row has {dt} cols, expected "
            f"2*vis={2*vis} (param | accumulator state columns)")
    eps = attrs.get("epsilon", 1e-6)
    g_now = cur_u[:, vis:]
    g_delta = utot * utot
    g_new = g_now + g_delta
    p_delta = -_lr(inputs) * utot / (sqrt_rn(g_new) + eps)
    raw = torch.cat([p_delta, g_delta], dim=-1)
    return _append(inputs, {}, postab, log_ids, count, uids,
                   raw, cum_u + raw, valid)


@register_op("adam_row_deferred", differentiable=False)
def _adam_row_deferred(ctx, inputs, attrs):
    """adam_op.cc SparseAdamFunctor lazy_mode, deferred: m/v ride in state
    columns [vis:2vis] / [2vis:3vis]; only touched rows advance m/v; the
    beta powers advance every step as scalars."""
    (uids, utot, rep, cur_u, cum_u, valid, postab, log_ids, count,
     r, vis, dt) = _deferred_common(inputs, attrs)
    if dt != 3 * vis:
        raise ValueError(
            f"adam_row_deferred: table row has {dt} cols, expected "
            f"3*vis={3*vis} (param | moment1 | moment2 state columns)")
    (b1p,) = inputs["Beta1Pow"]
    (b2p,) = inputs["Beta2Pow"]
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr_t = _lr(inputs) * sqrt_rn(1 - b2p.reshape(())) / (
        1 - b1p.reshape(()))
    m_now = cur_u[:, vis:2 * vis]
    v_now = cur_u[:, 2 * vis:]
    m_new = b1 * m_now + (1 - b1) * utot
    v_new = b2 * v_now + (1 - b2) * utot * utot
    p_delta = -lr_t * m_new / (sqrt_rn(v_new) + eps)
    raw = torch.cat([p_delta, m_new - m_now, v_new - v_now], dim=-1)
    return _append(inputs, {"Beta1PowOut": [b1p * b1],
                            "Beta2PowOut": [b2p * b2]},
                   postab, log_ids, count, uids, raw, cum_u + raw, valid)


# ---------------------------------------------------------------------------
# the deferred-row log: fold and startup
# ---------------------------------------------------------------------------

@register_op("deferred_fold", differentiable=False)
def _deferred_fold(ctx, inputs, attrs):
    """Fold every pending raw delta into the table, in place, and clear
    postab and the log. Shadowed entries are safe (raw deltas add);
    SENTINEL ids (pads, and the stale rows a fold leaves behind) add
    nothing. A pure representation change: reads are exact before and
    after (base + cum == base').

    Deterministic on every device: the log is sorted by id (stably), each
    id's entries are summed in log order, and each id's row takes one add
    of its sum; the unused sum slots add +0 to distinct rows, so a row
    takes at most one nonzero add and the order of the adds cannot change
    its bits. The JAX package scatter-adds entry by entry, so an id logged
    more than once rounds its sum differently (within the f32 tolerance
    of its tests). The stale log rows are left in place (unreachable once
    log_ids is SENTINEL and postab is cleared)."""
    (p,) = inputs["Param"]
    (log_ids,) = inputs["LogIds"]
    (log_raw,) = inputs["LogRaw"]
    (postab,) = inputs["PendingPos"]
    (count,) = inputs["Count"]
    n, v = log_ids.shape[0], p.shape[0]
    slot = torch.arange(n, device=log_ids.device)
    # an unused entry (SENTINEL, or an id out of range) gets a key of its
    # own past the table, so no run is longer than an id's entries: the
    # segment sums walk a run serially, and a log that is mostly empty (a
    # fold ahead of its cadence) would otherwise be one run of ~C rows
    ids = log_ids.long()
    ids = torch.where((ids >= 0) & (ids < v), ids, v + slot)
    order, seg, sums = segment_sums(ids, log_raw[:, :p.shape[-1]])
    seg_ids = torch.zeros(n, dtype=torch.int64, device=ids.device)
    seg_ids.scatter_(0, seg, ids[order])  # every entry of a run: one id
    live = (slot <= seg[-1]) & (seg_ids < v)
    p.index_add_(0, torch.where(live, seg_ids, slot % v),
                 torch.where(live[:, None], sums.to(p.dtype),
                             torch.zeros((), dtype=p.dtype,
                                         device=p.device)))
    postab.fill_(-1)
    log_ids.fill_(SENTINEL)
    return {"ParamOut": [p], "PendingPosOut": [postab],
            "LogIdsOut": [log_ids], "LogRawOut": [log_raw],
            "LogCumOut": list(inputs["LogCum"]),
            "CountOut": [torch.zeros_like(count)]}


@register_op("deferred_init_state_cols", differentiable=False)
def _deferred_init_state_cols(ctx, inputs, attrs):
    """Startup-time init of a table's state columns (Downpour g2sum
    layout), in place: keep the visible [:vis] initializer output, fill
    [vis:] with the moment initial value (adagrad
    initial_accumulator_value / adam 0)."""
    (p,) = inputs["Param"]
    p[:, int(attrs["vis"]):] = attrs.get("value", 0.0)
    return {"ParamOut": [p]}


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

def _packed_common(ctx, inputs, attrs):
    """uniq-merge the SelectedRows grad and pull the current rows out of
    the lookup's forward output (no second table gather). On a mesh the
    gradient's rows are every data-parallel rank's, in this rank's table
    slots, so the current rows come from the table itself."""
    (g,) = inputs["Grad"]
    (fwd_rows,) = inputs["FwdRows"]
    r = int(attrs["rows_per_step"])
    vis = int(attrs["vis"])
    dt = fwd_rows.shape[-1]
    ids, grows = _grad_rows(g)
    uids, utot, rep = uniq_merge(ids, grows[:, :vis].to(torch.float32), r)
    if getattr(ctx, "mesh", None) is not None:
        (p,) = inputs["Param"]
        slots = uids.clamp(0, p.shape[0] - 1)
        cur_u = unpack_rows(take_rows(p, slots), dt)
    else:
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
    uids, utot, cur_u, valid, vis, dt = _packed_common(ctx, inputs, attrs)
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
    uids, utot, cur_u, valid, vis, dt = _packed_common(ctx, inputs, attrs)
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
    uids, utot, cur_u, valid, vis, dt = _packed_common(ctx, inputs, attrs)
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
