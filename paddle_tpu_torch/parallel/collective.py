"""Collectives over the named dims of a ``DeviceMesh`` (the port's
counterpart of ``paddle_tpu.parallel.collective``; reference
operators/collective/ c_* ops and layers/collective.py).

The JAX package is single-controller: a collective is a ``lax`` primitive
inside a ``shard_map`` body, over a named mesh axis. The port is SPMD: one
process a device under a ``torch.distributed`` group (NCCL on the card,
gloo on the CPU), so the per-device body is ordinary per-rank code and a
mesh axis is the process group of a ``DeviceMesh`` dim.

Two usage contexts, as in the JAX package:

- inside per-rank code, on local tensors: ``psum``, ``pmean``,
  ``ppermute``, ``axis_index`` and ``axis_size``. ``axis`` is a
  ``(mesh, dim_name)`` pair or a process group. ``psum`` and ``pmean`` are
  differentiable (their transpose is ``psum``, as ``lax.psum``'s is);
  ``ppermute`` is ``dist.batch_isend_irecv`` on the dim's group, the
  identity on a group of one, and differentiable (its transpose is the
  reverse permutation, as ``lax.ppermute``'s is). On a gloo group a CUDA
  tensor goes through a host copy (``exchange``): gloo's point-to-point
  ops take CPU tensors;
- at the array level, on ``DTensor``s (the port's sharded ``jax.Array``):
  ``all_reduce``, ``all_gather``, ``reduce_scatter``, ``broadcast``,
  ``all_to_all`` and ``barrier``, with the JAX functions' in and out
  placements (``Shard(0)`` for ``P(axis)``, ``Replicate()`` for ``P()``).

``reduce_scatter_into`` and ``all_gather_into`` are the flat-buffer forms
the executor's mesh step uses (``core/mesh_step.py``). For tensor and
expert parallelism it also uses the Megatron conjugate pair ``copy_to``
(f: identity forward, sum of the cotangent backward) and ``reduce_from``
(g: sum forward, identity backward), ``gather_along`` (an all-gather along
a dim whose backward takes this rank's slice), ``gather_summed`` (the same
all-gather whose backward is a reduce-scatter: the sequence axis's keys
and values, read by every rank's queries), ``gather_rows`` (several
values' dim-0 rows made whole at once, each rank's row count its own,
one all-gather a dtype; the backward a reduce-scatter a dtype: an op that
works across the batch dim on a data axis) and ``all_to_all_diff`` (whose
backward is the transposed exchange). The pipelines
(``parallel/pipeline.py``) use ``exchange`` (point-to-point sends and
receives) and ``broadcast_from`` (one rank's value on every rank; its
backward keeps only the root's cotangent).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["psum", "pmean", "ppermute", "axis_index", "axis_size",
           "all_reduce", "all_gather", "reduce_scatter", "broadcast",
           "all_to_all", "barrier", "axis_group", "reduce_scatter_into",
           "all_gather_into", "copy_to", "reduce_from", "gather_along",
           "gather_summed", "all_to_all_diff", "exchange", "broadcast_from",
           "row_counts", "gather_rows", "summed_coalesced"]

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}
# the flat-buffer collectives under their newer names where torch has them
# (the older ones warn there), else the older ones
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def axis_group(axis):
    """The process group of `axis`: a ``(mesh, dim_name)`` pair, a
    ``DeviceMesh`` with one dim, or a group (None is the default group)."""
    if isinstance(axis, tuple):
        mesh, name = axis
        return mesh.get_group(name)
    if hasattr(axis, "get_group"):
        return axis.get_group()
    return axis


def axis_size(axis) -> int:
    return dist.get_world_size(axis_group(axis))


def axis_index(axis) -> int:
    """This rank's index along `axis` (``lax.axis_index``)."""
    return dist.get_rank(axis_group(axis))


def reduce_scatter_into(out: torch.Tensor, buf: torch.Tensor, group,
                        op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``out`` = this rank's chunk of the sum over the group of ``buf``
    ([size · len(out)], contiguous): one reduce-scatter (recorded by no
    graph)."""
    with torch.no_grad():
        _REDUCE_SCATTER(out, buf, op=op, group=group)
    return out


def all_gather_into(out: torch.Tensor, local: torch.Tensor,
                    group) -> torch.Tensor:
    """``out`` ([size · len(local)]) = every rank's ``local`` in rank
    order: one all-gather (recorded by no graph)."""
    with torch.no_grad():
        _ALL_GATHER(out, local.contiguous(), group=group)
    return out


def gathered(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim` in rank order, contiguous
    (no graph)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    x = x.contiguous()
    out = x.new_empty((n,) + tuple(x.shape))
    all_gather_into(out.view(-1), x.view(-1), group)
    if dim % x.ndim == 0:
        return out.view((n * x.shape[0],) + tuple(x.shape[1:]))
    return torch.cat(out.unbind(0), dim)


def summed(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group of `x`, a new tensor (no graph)."""
    y = x.detach().contiguous().clone()
    if dist.get_world_size(group) > 1:
        dist.all_reduce(y, group=group)
    return y


def summed_coalesced(xs, group=None):
    """The sums over the group of the tensors `xs` (new tensors, no graph),
    through one all-reduce a dtype over a flat buffer of that dtype's
    tensors in order (the reference's coalesced gradient buckets)."""
    by_dtype = {}
    for i, x in enumerate(xs):
        by_dtype.setdefault(x.dtype, []).append(i)
    out = [None] * len(xs)
    for idx in by_dtype.values():
        with torch.no_grad():
            flat = torch.cat([xs[i].detach().reshape(-1) for i in idx])
            if dist.get_world_size(group) > 1:
                dist.all_reduce(flat, group=group)
        pos = 0
        for i in idx:
            n = xs[i].numel()
            out[i] = flat[pos:pos + n].view(xs[i].shape)
            pos += n
    return out


class _CopyTo(torch.autograd.Function):
    """Megatron's f: the identity forward; the cotangent, which each rank
    holds a part of, summed over the group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return summed(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    """Megatron's g: the sum over the group forward (each rank holds a
    summand); the cotangent of a replicated value unchanged backward."""

    @staticmethod
    def forward(ctx, x, group):
        return summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherAlong(torch.autograd.Function):
    """Every rank's slice along `dim` made whole; the backward takes this
    rank's slice of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.width = dim, x.shape[dim]
        ctx.rank = dist.get_rank(group)
        return gathered(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.rank * ctx.width, ctx.width)
                .contiguous(), None, None)


class _GatherSummed(torch.autograd.Function):
    """Every rank's slice along `dim` made whole; the backward sums the
    cotangent over the group and keeps this rank's slice (a
    reduce-scatter): each rank's cotangent of the whole value is a part
    (its own queries' share of the keys' cotangent)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return gathered(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        parts = g.movedim(ctx.dim, 0)
        w = parts.shape[0] // n
        buf = parts.contiguous().view(-1)
        out = buf.new_empty(buf.numel() // n)
        reduce_scatter_into(out, buf, ctx.group)
        local = out.view((w,) + tuple(parts.shape[1:]))
        return local.movedim(0, ctx.dim).contiguous(), None, None


class _AllToAll(torch.autograd.Function):
    """``all_to_all_local``; its transpose (the concat and split axes
    swapped) backward."""

    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, concat_axis, split_axis)
        return all_to_all_local(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_local(g.contiguous(), *ctx.args), None, None, None


def copy_to(x: torch.Tensor, axis) -> torch.Tensor:
    """f on `axis`: where a replicated value enters a computation whose
    output each rank holds a part of (a column-parallel product)."""
    group = axis_group(axis)
    if dist.get_world_size(group) == 1 or not x.requires_grad:
        return x
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, axis) -> torch.Tensor:
    """g on `axis`: a value each rank holds a summand of, made whole."""
    group = axis_group(axis)
    if dist.get_world_size(group) == 1:
        return x
    return _ReduceFrom.apply(x, group)


def gather_along(x: torch.Tensor, dim: int, axis) -> torch.Tensor:
    """Every rank's slice of dim `dim` made whole, differentiably (the
    backward takes this rank's slice)."""
    group = axis_group(axis)
    if dist.get_world_size(group) == 1:
        return x
    return _GatherAlong.apply(x, dim % x.ndim, group)


def gather_summed(x: torch.Tensor, dim: int, axis) -> torch.Tensor:
    """Every rank's slice of dim `dim` made whole, differentiably, with a
    reduce-scatter of the cotangent backward (see ``_GatherSummed``)."""
    group = axis_group(axis)
    if dist.get_world_size(group) == 1:
        return x
    return _GatherSummed.apply(x, dim % x.ndim, group)


def row_counts(xs, group):
    """``counts[r][i]``: dim 0 of ``xs[i]`` on rank r of `group` (one
    all-gather of every value's row count)."""
    n = dist.get_world_size(group)
    mine = torch.tensor([int(x.shape[0]) for x in xs], dtype=torch.int64,
                        device=xs[0].device)
    every = mine.new_empty(n * len(xs))
    all_gather_into(every, mine, group)
    return every.view(n, len(xs)).cpu().tolist()


def _wire(dt):
    # gloo gathers no bool tensors: they travel as bytes
    return torch.uint8 if dt == torch.bool else dt


def _rows_whole(xs, counts, group):
    """Every rank's rows of each of `xs` laid end to end in rank order:
    one all-gather a dtype over the values padded to the most rows any
    rank holds."""
    n = dist.get_world_size(group)
    most = [max(c[i] for c in counts) for i in range(len(xs))]
    out = [None] * len(xs)
    by_dtype = {}
    for i, x in enumerate(xs):
        by_dtype.setdefault(_wire(x.dtype), []).append(i)
    for dt, idx in by_dtype.items():
        parts = []
        for i in idx:
            x = xs[i].detach().to(dt)
            pad = most[i] - x.shape[0]
            if pad:
                x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
            parts.append(x.reshape(-1))
        widths = [p.numel() for p in parts]
        mine = torch.cat(parts) if len(parts) > 1 else parts[0]
        every = mine.new_empty(n * mine.numel())
        all_gather_into(every, mine, group)
        for i, col in zip(idx, every.view(n, -1).split(widths, dim=1)):
            blocks = col.reshape((n, most[i]) + tuple(xs[i].shape[1:]))
            whole = torch.cat([blocks[r, :counts[r][i]] for r in range(n)])
            out[i] = whole.to(xs[i].dtype)
    return out


class _GatherRows(torch.autograd.Function):
    """``_rows_whole``; backward, each value's cotangent (every rank holds
    a part of it) summed over the group with this rank's rows kept: one
    reduce-scatter a dtype."""

    @staticmethod
    def forward(ctx, group, counts, *xs):
        ctx.group, ctx.counts = group, counts
        ctx.tails = [tuple(x.shape[1:]) for x in xs]
        ctx.dtypes = [x.dtype for x in xs]
        outs = tuple(_rows_whole(xs, counts, group))
        ctx.mark_non_differentiable(*[o for o in outs
                                      if not o.is_floating_point()])
        return outs

    @staticmethod
    def backward(ctx, *gs):
        counts, group = ctx.counts, ctx.group
        n, me = len(counts), dist.get_rank(group)
        grads = [None] * len(gs)
        by_dtype = {}
        for i in range(len(gs)):
            if ctx.needs_input_grad[2 + i]:
                by_dtype.setdefault(ctx.dtypes[i], []).append(i)
        for dt, idx in by_dtype.items():
            rows, widths = [], []
            for i in idx:
                most = max(c[i] for c in counts)
                g = gs[i]
                if g is None:
                    g = torch.zeros((sum(c[i] for c in counts),)
                                    + ctx.tails[i], dtype=dt,
                                    device=_device_of(gs))
                blocks = []
                for r, piece in enumerate(g.split([c[i] for c in counts])):
                    pad = most - piece.shape[0]
                    if pad:
                        piece = torch.cat([piece, piece.new_zeros(
                            (pad,) + ctx.tails[i])])
                    blocks.append(piece.reshape(1, -1))
                rows.append(torch.cat(blocks))
                widths.append(rows[-1].shape[1])
            buf = torch.cat(rows, dim=1).contiguous()
            out = buf.new_empty(buf.shape[1])
            reduce_scatter_into(out, buf.view(-1), group)
            for i, part in zip(idx, out.split(widths)):
                most = max(c[i] for c in counts)
                grads[i] = part.view((most,) + ctx.tails[i])[
                    :counts[me][i]].contiguous()
        return (None, None) + tuple(grads)


def _device_of(gs):
    return next(g.device for g in gs if g is not None)


def gather_rows(xs, group, counts=None):
    """Each of `xs` (this rank's rows of a value sharded along dim 0) made
    whole over `group`, every rank's rows in rank order, differentiably:
    the backward sums each cotangent over the group and keeps this rank's
    rows (``lax.all_gather``'s transpose). `counts` (``row_counts``) lets
    ranks hold different row counts; it is gathered when not given.
    Returns (the whole values, counts)."""
    if dist.get_world_size(group) == 1 or not xs:
        return list(xs), [[int(x.shape[0]) for x in xs]]
    if counts is None:
        counts = row_counts(xs, group)
    if any(x.requires_grad for x in xs) and torch.is_grad_enabled():
        return list(_GatherRows.apply(group, counts, *xs)), counts
    return _rows_whole(xs, counts, group), counts


def all_to_all_diff(x: torch.Tensor, axis, split_axis: int,
                    concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(tiled=True)`` on local tensors, differentiable."""
    group = axis_group(axis)
    if dist.get_world_size(group) == 1:
        return x
    return _AllToAll.apply(x, group, split_axis, concat_axis)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the cotangent is summed the same way (each rank
    holds a part of it), which is ``lax.psum``'s transpose."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def psum(x: torch.Tensor, axis) -> torch.Tensor:
    """Sum of `x` over `axis` on every rank (``lax.psum``)."""
    return _AllReduceSum.apply(x, axis_group(axis))


def pmean(x: torch.Tensor, axis) -> torch.Tensor:
    """Mean of `x` over `axis` on every rank (``lax.pmean``)."""
    return psum(x, axis) / axis_size(axis)


def _host_staged(t: torch.Tensor, group) -> bool:
    """Whether a point-to-point op of `t` on `group` goes through a host
    copy: gloo's send and receive take CPU tensors."""
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def exchange(sends, recvs, group) -> None:
    """Point-to-point on `group`: `sends` are (tensor, group rank) pairs,
    `recvs` (buffer, group rank) pairs filled in place; all of them are
    posted in one ``batch_isend_irecv`` and waited for. Every rank of a
    pair posts its half in the same call, so the pairs cannot wait on each
    other. A CUDA tensor on a gloo group is sent and received through a
    host copy."""
    ops, back = [], []
    for t, r in sends:
        t = t.detach().contiguous()
        if _host_staged(t, group):
            t = t.cpu()
        ops.append(dist.P2POp(dist.isend, t, dist.get_global_rank(group, r),
                              group))
    for buf, r in recvs:
        into = buf
        if _host_staged(buf, group) or not buf.is_contiguous():
            into = torch.empty(buf.shape, dtype=buf.dtype,
                               device="cpu" if _host_staged(buf, group)
                               else buf.device)
            back.append((buf, into))
        ops.append(dist.P2POp(dist.irecv, into,
                              dist.get_global_rank(group, r), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for buf, got in back:
        buf.copy_(got)


def _ppermute_local(x: torch.Tensor, group, perm) -> torch.Tensor:
    me = dist.get_rank(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if dst == [me] and src == [me]:
        return x
    out = torch.zeros_like(x)
    exchange([(x, d) for d in dst], [(out, s) for s in src], group)
    return out


class _PPermute(torch.autograd.Function):
    """``lax.ppermute``; the reverse permutation backward."""

    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, [(d, s) for s, d in perm]
        return _ppermute_local(x.detach(), group, perm)

    @staticmethod
    def backward(ctx, g):
        return _ppermute_local(g.contiguous(), ctx.group, ctx.perm), None, None


def ppermute(x: torch.Tensor, axis, perm) -> torch.Tensor:
    """``lax.ppermute``: `perm` is a list of (source, destination) pairs of
    axis indices; a rank that no pair sends to gets zeros. One
    ``batch_isend_irecv`` on the axis's group; a pair that maps a rank to
    itself, or a group of one, is the identity. Differentiable: the
    cotangent goes back along the reverse pairs."""
    group = axis_group(axis)
    if dist.get_world_size(group) == 1:
        return x
    perm = [(int(s), int(d)) for s, d in perm]
    if x.requires_grad and torch.is_grad_enabled():
        return _PPermute.apply(x, group, perm)
    return _ppermute_local(x, group, perm)


class _BroadcastFrom(torch.autograd.Function):
    """The root's value on every rank; backward, the root keeps its own
    cotangent and the other ranks' inputs get zeros (every rank holds the
    whole cotangent of a replicated value, so it is taken once)."""

    @staticmethod
    def forward(ctx, x, root, group):
        ctx.root = root
        ctx.mine = dist.get_rank(group) == root
        y = x.detach().contiguous().clone()
        dist.broadcast(y, dist.get_global_rank(group, root), group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.mine else torch.zeros_like(g)), None, None


def broadcast_from(x: torch.Tensor, root: int, axis) -> torch.Tensor:
    """Rank `root`'s `x` on every rank of `axis` (every rank passes a
    tensor of the same shape and dtype); differentiable, the cotangent
    goes to the root only."""
    group = axis_group(axis)
    if dist.get_world_size(group) == 1:
        return x
    return _BroadcastFrom.apply(x, int(root), group)


# -- array level (DTensor in, DTensor out) ----------------------------------

def _dtensor(local, mesh, axis, sharded: bool):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    names = list(mesh.mesh_dim_names or ())
    place = [Replicate()] * mesh.ndim
    if sharded:
        place[names.index(axis)] = Shard(0)
    return DTensor.from_local(local, mesh, place, run_check=False)


def _local(x):
    return x.to_local() if hasattr(x, "to_local") else x


def all_reduce(x, mesh, axis: str, op: str = "sum"):
    """c_allreduce_{sum,max,min,mean} on a dim-0 sharded array: every shard
    becomes the elementwise reduction of all the shards (in and out
    ``Shard(0)``, as ``P(axis)``)."""
    group = mesh.get_group(axis)
    y = _local(x).contiguous().clone()
    if op == "mean":
        dist.all_reduce(y, group=group)
        y = y / dist.get_world_size(group)
    else:
        dist.all_reduce(y, op=_REDUCE_OPS[op], group=group)
    return _dtensor(y, mesh, axis, True)


def all_gather(x, mesh, axis: str):
    """c_allgather: the dim-0 shards concatenated in rank order, on every
    rank (``Shard(0)`` in, ``Replicate()`` out)."""
    group = mesh.get_group(axis)
    local = _local(x).contiguous()
    n = dist.get_world_size(group)
    out = local.new_empty((n * local.shape[0],) + tuple(local.shape[1:]))
    all_gather_into(out, local, group)
    return _dtensor(out, mesh, axis, False)


def reduce_scatter(x, mesh, axis: str):
    """c_reducescatter: a replicated array summed over the axis, each rank
    keeping its dim-0 chunk (``Replicate()`` in, ``Shard(0)`` out)."""
    group = mesh.get_group(axis)
    full = _local(x).contiguous()
    n = dist.get_world_size(group)
    if full.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 ({full.shape[0]}) does not "
                         f"divide over {n} ranks")
    out = full.new_empty((full.shape[0] // n,) + tuple(full.shape[1:]))
    reduce_scatter_into(out, full, group)
    return _dtensor(out, mesh, axis, True)


def broadcast(x, mesh, axis: str, root: int = 0):
    """c_broadcast: the root's shard, replicated (``Shard(0)`` in,
    ``Replicate()`` out)."""
    group = mesh.get_group(axis)
    y = _local(x).contiguous().clone()
    dist.broadcast(y, dist.get_global_rank(group, root), group=group)
    return _dtensor(y, mesh, axis, False)


def all_to_all(x, mesh, axis: str, split_axis: int, concat_axis: int):
    """Ulysses' exchange: each rank splits its shard along `split_axis`
    into one chunk a rank, sends chunk j to rank j, and concatenates what
    it receives along `concat_axis` (``lax.all_to_all`` with tiled=True;
    ``Shard(0)`` in and out)."""
    return _dtensor(all_to_all_local(_local(x), mesh.get_group(axis),
                                     split_axis, concat_axis),
                    mesh, axis, True)


def all_to_all_local(x: torch.Tensor, group, split_axis: int,
                     concat_axis: int) -> torch.Tensor:
    """The per-rank body of `all_to_all` on a local tensor."""
    n = dist.get_world_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} ({x.shape[split_axis]})"
                         f" does not divide over {n} ranks")
    send = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_axis)


def barrier(mesh, axis: Optional[str] = None):
    """A sync point over `axis` (every dim when None): a sum of one element,
    which works the same on NCCL and gloo."""
    names = [axis] if axis else list(mesh.mesh_dim_names or ())
    for name in names:
        t = torch.zeros(1, device=mesh.device_type)
        dist.all_reduce(t, group=mesh.get_group(name))
    if mesh.device_type == "cuda":
        torch.cuda.synchronize()
