"""Pipeline parallelism over a ``pp`` mesh axis: GPipe, 1F1B and
heterogeneous stages (counterpart of ``paddle_tpu.parallel.pipeline``;
reference PipelineOptimizer, optimizer.py:2677, and SectionWorker,
section_worker.cc:141).

The JAX package holds every stage's parameters in one stacked array
sharded on ``pp`` and runs the schedule as a ``lax.scan`` over ticks with
``ppermute`` between them; autodiff through the scan gives the backward
pipeline. The port runs one process a device: the rank at ``pp``
coordinate i holds stage i's parameters only (its ``stage_params``), runs
stage i on each microbatch and sends the stage's output to rank i + 1.

- **GPipe** (``pipeline_step``, ``GPipe``): rank i runs microbatch f at
  tick f + i, m + n − 1 ticks in all. The forward keeps each microbatch's
  stage graph (the stage runs under ``enable_grad`` on a detached input);
  the backward is an explicit schedule, the same on every rank: for each
  microbatch, last first, receive the output cotangent from rank i + 1
  (the last stage takes its own), ``torch.autograd.grad`` on the saved
  graph, and send the input cotangent to rank i − 1. So every send meets
  its receive in one order, whatever order the autograd engine would walk
  the microbatches in. The last stage's outputs go to every rank
  (``collective.broadcast_from``, whose backward keeps the cotangent on
  the last stage only: every rank holds the same cotangent of a
  replicated output, so it is taken once); stage 0's input cotangent goes
  to every rank (its input is replicated over ``pp``).
- **1F1B** (``pipeline_1f1b``): each tick runs one forward and one
  backward microbatch, m + 2n − 1 ticks; the backward recomputes the
  stage from its saved input, so at most 2n − 1 inputs are held.
- **Heterogeneous stages** (``pipeline_hetero``): stage i is its own
  callable with its own parameters and boundary shapes; the payload
  between ranks is the flat, zero-padded [mb, pay] buffer of the JAX
  package (``flat_pad``).

The exchanges are ``collective.exchange`` (point-to-point, one
``batch_isend_irecv``; a CUDA tensor on a gloo group goes through a host
copy). Side inputs of a microbatch (``xs``' other leaves, ``caps``) are
replicated over ``pp`` and indexed by each rank; their cotangents are
summed over the axis.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from .collective import axis_group, broadcast_from, exchange, summed

__all__ = ["pipeline_step", "pipeline_1f1b", "pipeline_hetero", "GPipe",
           "schedule_info", "run_stages", "flat_pad"]


def schedule_info(kind: str, n: int, m: int) -> dict:
    """Ticks and bubble fraction of a schedule: GPipe runs m + n − 1 ticks
    with one stage a tick on every rank, so n − 1 of them idle a rank
    ((n − 1)/(m + n − 1)); 1F1B runs m + 2n − 1 ticks of one forward and
    one backward, (2n − 1)/(m + 2n − 1), with at most 2n − 1 microbatch
    inputs held a rank."""
    if kind == "1f1b":
        ticks = m + 2 * n - 1
        return {"ticks": ticks, "bubble_fraction": (2 * n - 1) / ticks,
                "max_inflight_microbatches": 2 * n - 1}
    ticks = m + n - 1
    return {"ticks": ticks, "bubble_fraction": (n - 1) / ticks if ticks
            else 0.0, "max_inflight_microbatches": m}


def _group(mesh, axis):
    """The process group of `axis` on `mesh` (a ``DeviceMesh``), or `mesh`
    itself when it is a group."""
    return axis_group((mesh, axis) if hasattr(mesh, "mesh_dim_names")
                      else mesh)


def _flat_params(params):
    """(list of tensors, rebuild) of a tensor or a flat list/tuple."""
    if isinstance(params, torch.Tensor):
        return [params], lambda ps: ps[0]
    if isinstance(params, (list, tuple)):
        kind = type(params)
        return list(params), lambda ps: kind(ps)
    raise TypeError(f"stage parameters must be a tensor or a list/tuple of "
                    f"tensors, got {type(params).__name__}")


class _Stages:
    """What ``_Pipe`` needs of a pipeline: this rank's stage as a function
    of (parameters, input, microbatch index) returning the value it sends
    on, the input buffer it receives, and the payload packing."""

    def __init__(self, group, m, run, recv_like, out_like, pack=None,
                 unpack=None):
        self.group = group
        self.n = dist.get_world_size(group)
        self.i = dist.get_rank(group)
        self.m = m
        self.grad = False
        self.run = run              # (params, inp, f, side) -> y
        self.recv_like = recv_like  # () -> an empty input payload buffer
        self.out_like = out_like    # (shape, dtype) of the last stage's y
        self.pack = pack or (lambda y: y)
        self.unpack = unpack or (lambda b: b)

    def unpack_cot(self, c, y):
        """A received payload cotangent as the cotangent of `y`."""
        if c.shape == y.shape:
            return c
        return c[:, :y[0].numel()].reshape(y.shape)


class _Pipe(torch.autograd.Function):
    """The GPipe schedule of one rank (see the module docstring). Inputs:
    the spec, the number of parameters, this rank's parameters, the
    microbatched input [m, mb, ...] and the side inputs [m, ...]. Output:
    the last stage's outputs [m, ...] on the last rank (zeros elsewhere;
    ``broadcast_from`` replicates them)."""

    @staticmethod
    def forward(ctx, st, n_params, *flat):
        params, x, side = flat[:n_params], flat[n_params], flat[n_params + 1:]
        grad = st.grad
        i, n, m = st.i, st.n, st.m
        leaves = [p.detach().requires_grad_(p.requires_grad) for p in params]
        side_l = [s.detach().requires_grad_(s.requires_grad) for s in side]
        saved, outs = [], []
        with torch.set_grad_enabled(grad):
            for f in range(m):
                if i == 0:
                    inp = x[f].detach()
                    inp.requires_grad_(grad and x.requires_grad)
                    val = inp
                else:
                    buf = st.recv_like()
                    exchange([], [(buf, i - 1)], st.group)
                    inp = buf.requires_grad_(grad and buf.is_floating_point())
                    val = st.unpack(inp)
                y = st.run(leaves, val, f, [s[f] for s in side_l])
                if i < n - 1:
                    exchange([(st.pack(y), i + 1)], [], st.group)
                else:
                    outs.append(y)
                saved.append((inp, y))
        ctx.st, ctx.saved = st, saved
        ctx.leaves, ctx.side_l = leaves, side_l
        ctx.x_meta = (tuple(x.shape), x.dtype, x.device)
        if i == n - 1:
            return torch.stack([o.detach() for o in outs])
        shape, dtype = st.out_like
        return x.new_zeros((m,) + tuple(shape), dtype=dtype)

    @staticmethod
    def backward(ctx, g):
        st, saved = ctx.st, ctx.saved
        i, n, m = st.i, st.n, st.m
        leaves, side_l = ctx.leaves, ctx.side_l
        pgrads = [None] * len(leaves)
        sgrads = [None] * len(side_l)
        dx = [None] * m
        want = [t for t in leaves + side_l if t.requires_grad]
        for f in reversed(range(m)):
            inp, y = saved[f]
            if i == n - 1:
                cot = g[f]
            else:
                cot = torch.empty_like(st.pack(y.detach()))
                exchange([], [(cot, i + 1)], st.group)
                cot = st.unpack_cot(cot, y)
            wrt = ([inp] if inp.requires_grad else []) + want
            got = (torch.autograd.grad(y, wrt, cot.to(y.dtype),
                                       allow_unused=True)
                   if wrt and y.requires_grad else [None] * len(wrt))
            saved[f] = None
            k = 0
            dinp = None
            if inp.requires_grad:
                dinp, k = got[0], 1
            for j, t in enumerate(leaves):
                if t.requires_grad:
                    gj = got[k]
                    k += 1
                    if gj is not None:
                        pgrads[j] = gj if pgrads[j] is None else pgrads[j] + gj
            for j, t in enumerate(side_l):
                if t.requires_grad:
                    gj = got[k]
                    k += 1
                    if gj is not None:
                        sgrads[j] = gj if sgrads[j] is None else sgrads[j] + gj
            if i > 0:
                if dinp is None:
                    dinp = torch.zeros_like(inp)
                exchange([(dinp, i - 1)], [], st.group)
            else:
                dx[f] = dinp
        shape, dtype, device = ctx.x_meta
        x_grad = None
        if ctx.needs_input_grad[2 + len(leaves)]:
            if i == 0:
                x_grad = torch.stack([torch.zeros(shape[1:], dtype=dtype,
                                                  device=device)
                                      if d is None else d.to(dtype)
                                      for d in dx]).contiguous()
            else:
                x_grad = torch.empty(shape, dtype=dtype, device=device)
            dist.broadcast(x_grad, dist.get_global_rank(st.group, 0),
                           group=st.group)
        side_out = []
        for j, t in enumerate(side_l):
            if not t.requires_grad:
                side_out.append(None)
                continue
            gj = sgrads[j] if sgrads[j] is not None else torch.zeros_like(t)
            side_out.append(summed(gj, st.group))
        return (None, None, *pgrads, x_grad, *side_out)


def run_stages(group, params, x, side, run, recv_like=None, out_like=None,
               pack=None, unpack=None):
    """The GPipe schedule for a caller that runs its own stage:
    ``run(params, inp, f, side_f) -> y`` is this rank's stage on
    microbatch f (``ops/pipeline_ops.py`` runs a sub-block there); `x` is
    [m, mb, ...], `side` a list of [m, ...] side inputs. Returns the last
    stage's outputs [m, ...] on every rank (``pipeline_step``'s
    backward)."""
    m = x.shape[0]
    st = _Stages(group, m, run,
                 recv_like or (lambda: torch.empty_like(x[0])),
                 out_like or (tuple(x.shape[1:]), x.dtype), pack, unpack)
    return _run_pipe(st, list(params), x, list(side))


def _run_pipe(st: _Stages, params, x, side):
    st.grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in list(params) + [x] + list(side))
    out = _Pipe.apply(st, len(params), *params, x, *side)
    return broadcast_from(out, st.n - 1, st.group)


def pipeline_step(stage_fn: Callable, stage_params, xs, mesh,
                  axis: str = "pp", data_axis: Optional[str] = None):
    """Run microbatches [m, mb, ...] through the n = size(`axis`) stages
    of a GPipe schedule; returns the last stage's outputs [m, mb, ...] on
    every rank of the axis.

    ``stage_fn(params, payload) -> payload``: a payload is `xs`' structure
    for one microbatch (a tensor, or a tuple whose first leaf is the value
    passed between stages and whose other leaves are the microbatch's side
    inputs, such as an attention mask). ``stage_params`` are THIS rank's
    stage's parameters (a tensor or a list/tuple of tensors). Every
    stage's output has its input's shape and dtype (the JAX package's ring
    constraint). `data_axis`, when given, must be a mesh axis (the batch
    dim of each rank's microbatches is its own rows there).
    Differentiable: gradients reach this rank's parameters, `xs`' first
    leaf (stage 0's input cotangent, on every rank) and the side inputs
    (summed over the stages)."""
    names = tuple(getattr(mesh, "mesh_dim_names", ()) or ())
    if data_axis is not None and data_axis not in names:
        raise ValueError(
            f"pipeline_step: data_axis {data_axis!r} is not a mesh axis "
            f"{names} — a typo here would silently all-gather the "
            f"batch and lose data parallelism")
    group = _group(mesh, axis)
    single = isinstance(xs, torch.Tensor)
    leaves = [xs] if single else list(xs)
    x, side = leaves[0], leaves[1:]
    plist, rebuild = _flat_params(stage_params)
    m = x.shape[0]

    def run(ps, inp, f, side_f):
        out = stage_fn(rebuild(ps), inp if single else (inp, *side_f))
        y = out if isinstance(out, torch.Tensor) else out[0]
        if tuple(y.shape) != tuple(inp.shape) or y.dtype != inp.dtype:
            raise ValueError(
                f"pipeline_step: a stage's output {tuple(y.shape)} "
                f"{y.dtype} differs from its input {tuple(inp.shape)} "
                f"{inp.dtype}; GPipe stages keep the boundary shape (use "
                f"pipeline_hetero)")
        return y

    st = _Stages(group, m, run, lambda: torch.empty_like(x[0]),
                 (tuple(x.shape[1:]), x.dtype))
    if st.n == 1:
        outs = []
        for f in range(m):
            outs.append(run(plist, x[f], f, [s[f] for s in side]))
        return torch.stack(outs)
    return _run_pipe(st, plist, x, side)


class GPipe:
    """PipelineOptimizer-parity convenience wrapper::

        pipe = GPipe(block_fn, mesh, axis="pp")
        out = pipe(my_stage_params, x_microbatches)
        loss = pipe.loss(my_stage_params, x_microbatches, loss_fn)
        loss.backward()   # gradients of this rank's stage parameters
    """

    def __init__(self, stage_fn: Callable, mesh, axis: str = "pp"):
        self.stage_fn = stage_fn
        self.mesh = mesh
        self.axis = axis

    def __call__(self, stage_params, xs):
        return pipeline_step(self.stage_fn, stage_params, xs, self.mesh,
                             self.axis)

    def loss(self, stage_params, xs, loss_fn):
        return loss_fn(self(stage_params, xs))


def pipeline_1f1b(stage_fn, stage_params, xs, loss_fn, mesh,
                  axis: str = "pp"):
    """1F1B pipelined train step: returns (loss, grads, info).

    ``stage_fn(params, payload) -> payload`` with payload ``(x, *caps)``
    (the stage keeps x's shape); `xs` is that payload's [m, mb, ...]
    microbatches: the first leaf goes from rank to rank, the others are
    indexed by microbatch on every rank. ``loss_fn`` maps the last stage's
    [mb, ...] output to a scalar; the loss is the mean over microbatches,
    on every rank, and `grads` are this rank's stage parameters' gradients
    in ``stage_params``' structure. Rank i runs the forward of microbatch
    f at tick f + i and its backward (recomputed from the saved input) at
    tick f + n + (n − 1 − i); `info` is ``schedule_info("1f1b", n, m)``
    plus the most inputs this rank held at once."""
    group = _group(mesh, axis)
    n, i = dist.get_world_size(group), dist.get_rank(group)
    leaves = [xs] if isinstance(xs, torch.Tensor) else list(xs)
    x, caps = leaves[0], leaves[1:]
    m = x.shape[0]
    plist, rebuild = _flat_params(stage_params)
    params = [p.detach().requires_grad_() for p in plist]
    grads = [torch.zeros_like(p) for p in params]
    loss_acc = torch.zeros((), dtype=torch.float32, device=x.device)
    resid, held = {}, 0
    fwd_in = cot_in = prev_out = None

    def stage(inp, f):
        return stage_fn(rebuild(params), (inp, *[c[f] for c in caps]))[0]

    for t in range(m + 2 * n - 1):
        sends, recvs = [], []
        dout = None
        lmb = t - n
        if i == n - 1 and 0 <= lmb < m:
            with torch.enable_grad():
                po = prev_out.detach().requires_grad_()
                lval = loss_fn(po)
                (dout,) = torch.autograd.grad(lval, [po])
            loss_acc = loss_acc + lval.detach().float() / m
        b = t - n - (n - 1 - i)
        if 0 <= b < m:
            inp_b = resid.pop(b).requires_grad_()
            cot = dout / m if i == n - 1 else cot_in
            with torch.enable_grad():
                out = stage(inp_b, b)
                got = torch.autograd.grad(out, [inp_b] + params, cot)
            for gacc, gj in zip(grads, got[1:]):
                gacc.add_(gj)
            if i > 0:
                sends.append((got[0], i - 1))
        f = t - i
        if 0 <= f < m:
            inp = x[f] if i == 0 else fwd_in
            resid[f] = inp.detach()
            held = max(held, len(resid))
            with torch.no_grad():
                out = stage(inp, f)
            prev_out = out
            if i < n - 1:
                sends.append((out, i + 1))
        fwd_in = cot_in = None
        if i > 0 and 0 <= t + 1 - i < m:
            fwd_in = torch.empty_like(x[0])
            recvs.append((fwd_in, i - 1))
        bn = t + 1 - n - (n - 1 - i)
        if i < n - 1 and 0 <= bn < m:
            cot_in = torch.empty_like(x[0])
            recvs.append((cot_in, i + 1))
        exchange(sends, recvs, group)
    if n > 1:
        dist.broadcast(loss_acc, dist.get_global_rank(group, n - 1),
                       group=group)
    info = schedule_info("1f1b", n, m)
    info["held_inputs"] = held
    return loss_acc, rebuild(grads), info


def flat_pad(v: torch.Tensor, pay: int) -> torch.Tensor:
    """[mb, ...] -> [mb, pay] (zero-padded flat payload)."""
    f = v.reshape(v.shape[0], -1)
    return torch.nn.functional.pad(f, (0, pay - f.shape[1]))


def _meta(t):
    return t.detach().to("meta") if isinstance(t, torch.Tensor) else t


def _chain_shapes(stage_fns, per_stage_params, mb_shape, dtype, caps):
    """(boundary shapes, dtypes) by running every stage on meta tensors
    (the JAX package's shape chaining through ``eval_shape``)."""
    shapes, dtypes = [tuple(mb_shape)], [dtype]
    for k, fn in enumerate(stage_fns):
        ps, rebuild = _flat_params(per_stage_params[k])
        cap0 = tuple(_meta(c[0]) for c in caps[k])
        out = fn(rebuild([_meta(p) for p in ps]),
                 torch.empty(shapes[-1], dtype=dtype, device="meta"), cap0)
        shapes.append(tuple(out.shape))
        dtypes.append(out.dtype)
    return shapes, dtypes


def pipeline_hetero(stage_fns: Sequence[Callable], per_stage_params, xs,
                    mesh, axis: str = "pp", caps=None, shapes=None):
    """GPipe over heterogeneous stages (different ops, parameters and
    boundary shapes a stage — the reference's per-section programs).

    ``stage_fns[k](params_k, x, caps_k) -> y``; ``per_stage_params[k]`` is
    stage k's parameters (a tensor or a list/tuple); this rank (``pp``
    coordinate i) runs stage i and differentiates its parameters only.
    `xs`: [m, mb, ...] microbatches of stage 0's input; `caps` (optional):
    a tuple a stage of [m, ...] side inputs, indexed by microbatch. The
    boundary shapes are chained through the stages (on meta tensors, or
    given as `shapes`: a list of n + 1 microbatch shapes); every boundary
    keeps xs' dtype and microbatch dim (ValueError otherwise, as in the
    JAX package). Between ranks the payload is a flat zero-padded [mb,
    pay] buffer. Returns [m, ...] of the last stage's outputs on every
    rank; differentiable like ``pipeline_step``."""
    group = _group(mesh, axis)
    n, i = dist.get_world_size(group), dist.get_rank(group)
    if len(stage_fns) != n:
        raise ValueError(
            f"pipeline_hetero: {len(stage_fns)} stages but mesh axis "
            f"{axis!r} has {n} devices")
    m = xs.shape[0]
    if caps is None:
        caps = tuple(() for _ in range(n))
    mb_shape = tuple(xs.shape[1:])
    if shapes is None:
        shapes, dtypes = _chain_shapes(stage_fns, per_stage_params,
                                       mb_shape, xs.dtype, caps)
    else:
        shapes = [tuple(s) for s in shapes]
        dtypes = [xs.dtype] * len(shapes)
    for k in range(n):
        if dtypes[k + 1] != xs.dtype:
            raise ValueError(
                f"pipeline_hetero: stage {k} output dtype {dtypes[k + 1]} "
                f"!= payload dtype {xs.dtype}")
        if shapes[k + 1][0] != mb_shape[0]:
            raise ValueError(
                f"pipeline_hetero: stage {k} changed the microbatch dim "
                f"({shapes[k + 1][0]} vs {mb_shape[0]})")
    pay = max(int(torch.Size(s[1:]).numel()) for s in shapes)
    plist, rebuild = _flat_params(per_stage_params[i])
    mine = tuple(caps[i])

    def run(ps, inp, f, side_f):
        return stage_fns[i](rebuild(ps), inp, tuple(side_f))

    def unpack(buf):
        size = int(torch.Size(shapes[i][1:]).numel())
        return buf[:, :size].reshape(shapes[i])

    st = _Stages(group, m, run,
                 lambda: xs.new_empty((mb_shape[0], pay)),
                 (shapes[-1], xs.dtype),
                 pack=lambda y: flat_pad(y, pay), unpack=unpack)
    if n == 1:
        return torch.stack([run(plist, xs[f], f, [c[f] for c in mine])
                            for f in range(m)])
    return _run_pipe(st, plist, xs, list(mine))
