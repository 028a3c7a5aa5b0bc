"""The executor's step on a mesh: a data-parallel axis with ZeRO stages 0–3,
model axes (tensor parallelism), a sequence axis and a pipeline axis, any
of them at once.

Counterpart of the mesh half of ``paddle_tpu.core.compiler``
(``_make_step``/``_build``/``_run``). The JAX package runs one jitted
program over a global batch and lets GSPMD place every value; the port
runs the same program on every rank of a ``torch.distributed`` group, each
on its own rows, and places the values itself. What GSPMD makes global,
the step makes global with an explicit collective on the dp axis's group:

- **Feeds.** Each rank feeds its LOCAL batch rows (the JAX package's
  multi-process contract, compiler.py:536-558); every rank must feed the
  same number of rows, checked by a small all-gather of the row counts at
  the start of every step (a rank whose count differs, a ragged last
  batch, would otherwise mis-pair the step's collectives). A value
  computed from a feed is batch-sharded: its dim 0 holds this rank's rows
  (``batch``, a set of names propagated op by op).
- **What an op does with a batch-sharded input is its own declaration**
  (``dp`` in ``core/registry.py``): it works row by row (its outputs are
  batch-sharded), or it reduces over the batch itself and its outputs (or
  some of them) are global. ``mean``, ``reduce_sum`` and ``reduce_mean``
  over dim 0, the batch-norm statistics (the plain ones and the fused
  kernels' sums, K1/K3/K4), ``accuracy`` and ``auc`` read
  ``batch_group(ctx, slot)`` and sum over its group
  (``parallel.collective.psum``, whose transpose is the same sum, as
  ``lax.psum``'s is). So a loss, a statistic or a metric is the global one
  on every rank. **Rule A:** any other op with a batch-sharded input
  (one that declares nothing, or a concat, split, slice, transpose,
  softmax, gather or contraction along dim 0: its callable returns None or
  a ``registry.Whole``) works across the batch dim: its batch-sharded
  inputs are gathered whole over the data axis (``collective.gather_rows``:
  one all-gather of their row counts, which may differ from rank to rank,
  then one a dtype), it runs on the whole batch, drawing from a stream
  every rank of the axis shares (``shared_gen``), and its outputs are
  global, but for the slots its ``Whole`` names, which keep the batch's
  rows and are cut back to this rank's. The gather's backward is a
  reduce-scatter, so each rank's cotangents stay its parts of the global
  ones and the usual gradient sum counts a parameter on either side of
  the op once. A global output with the whole batch's rows that a
  row-by-row op later reads beside a batch-sharded value is cut to this
  rank's rows for that op.
- **Gradients.** Every cotangent a rank computes is its part of the
  global one: a loss that is the same on every rank is seeded with 1/N,
  and each parameter's gradient is summed over the group. The sum is a
  reduce-scatter of one flat buffer a dtype, each gradient laid out by its
  ZeRO axis (``compiler._zero_axis``, dim 0 padded to a multiple of N),
  followed at stages 0 and 1 by an all-gather: the same reduction in every
  stage, so stages 1–3 are bitwise equal to stage 0 at the same world
  size. Gradients with no ZeRO axis (tiny leaves) are all-reduced.
- **ZeRO.** Stage 1 keeps the optimizer state sharded (each rank its
  ⌈d/N⌉ slice along the leaf's ZeRO axis, the last slice zero-padded as
  the JAX package pads it); stage 2 also keeps the gradients sharded;
  stage 3 also the parameters, gathered whole (one all-gather a dtype) at
  the first use of one of them in the step and kept to the step's end
  (autograd holds them for the backward). The
  updates after the ``autodiff`` op run on the shard when they are
  elementwise (``_ELEMENTWISE``); any other op there gets its inputs
  gathered whole and its outputs sliced back. At the step's end stages 1
  and 2 all-gather the updated parameters. Sharded state lives in the
  scope as a ``DTensor`` with a ``Shard(axis)`` placement of the padded
  global shape; the program records the logical shapes in
  ``_zero_padded``, as the JAX package's does.
- **Fetches are global:** a batch-sharded value is all-gathered along dim
  0, a sharded state value along its axis (pad dropped).
- **Random draws differ across ranks.** The scope's generator is folded
  with the rank once (rank 0 keeps the plain executor's stream, so a world
  of one draws what the plain executor draws), so dropout masks and the
  flash kernels' Philox seeds differ from rank to rank.

A group of one needs no exchange: ``batch_group`` is None there, so the
ops take their one-device code and a world of one is bitwise the plain
executor. The gradient collectives still run (on one rank they copy).

**Model axes** (``tp``; each mesh dim of size > 1 that a parameter's
``shard_spec`` names, other than the data, sequence and pipeline axes,
``compiled._model_axes``) and **the sequence axis** (``with_mesh(
seq_axis=)``: dim 1 of the feeds sliced). A rank's group on an axis is the
ranks that differ from it on that dim only (``DeviceMesh.get_group``).
Each value has a layout on each of these axes: replicated (R, the
default), S(d) (each rank holds its slice of dim d) or P (each rank holds
a summand; ``registry.P``), kept in each axis's ``lay`` (``_Axis``). An
op's ``tp``/``sp`` declarations apply axis by axis, in order, each on the
local shapes the axes before it left; a declaration that would keep a
slice of a dim another axis keeps sliced for the op (or a second
model-axis slice of one input) gets that axis's inputs gathered whole
instead. So BERT on tp×sp runs its attention on a rank's heads and a
rank's query rows at once.

- **Parameters with a ``shard_spec``** naming such an axis, and the
  optimizer state of the same shape that their update ops read, live as
  this rank's slice: a whole value in the scope (a startup, a restore) is
  sliced at load, and the step stores a ``DTensor`` with a ``Shard(d)``
  placement on each of their mesh dims. ZeRO leaves the parameters as
  they are (the JAX package's ``_fsdp_param`` and ``shard_grad`` skip them
  too) and their gradients are summed over the data axis only. At stage
  ≥ 1 their optimizer state is also cut over the data axis between steps,
  along the largest dim of the slice that no other axis cuts and the
  axis divides (``tpz``: 1/(dp·tp) a rank; the JAX package holds that
  state at 1/dp). The step keeps that part (``zpart``): an elementwise
  update runs on it, the parameter's and gradient's slices cut to this
  rank's part beside it, and the updated parameter's part is all-gathered
  over the data axis back to its slice, so the numbers are stage off's
  and only the parameter crosses the wire; any other op that reads a part
  gets it gathered to the slice. A spec
  that names the data axis is ZeRO stage 3 for its parameter on the
  spec's dim, at any stage: stored sharded, gathered whole at first use,
  its gradient reduce-scattered and kept as a shard, its update run on
  the shard. A
  spec naming an axis the mesh lacks, or a dim its axis does not divide,
  raises ValueError, as the JAX package's placement does.
- **Ops.** Before an op runs, a P input is summed over the tp group
  (``collective.reduce_from``, Megatron's g); the op's ``tp`` declaration
  (``core/registry.py``) then says what it makes of the other layouts. An
  op that declares nothing for them gets each sharded input gathered
  whole (``gather_along``, whose backward takes the rank's slice) and runs
  on the whole value. A replicated input that requires a gradient and
  enters an op with a sharded or partial output passes through
  ``collective.copy_to`` (Megatron's f: its cotangent is summed over the
  group), so every replicated parameter gets the same gradient on every
  tp rank and stays bitwise equal across the group. The conversions are
  this op's own: the env keeps the value as it was for the next reader.
- **Updates** run on the slices (the optimizer ops work element by
  element); an update-section op that reads a slice and does not, gets
  the slices gathered whole and its sliced outputs cut back.
- **Fetches** come back global: an S value is gathered, a P value summed.
- **Random draws.** The generator is folded with the dp coordinate only,
  so the tp ranks of one data row draw the same masks for R values; a
  mask on an S value is drawn whole and sliced (the ``dropout`` op).
- **Pipeline stages.** The rank at pp coordinate s holds stage s's
  parameters and their state, and runs their update ops
  (``_stage_owner``, ``skip``). An update op that reads several stages'
  values (the sum of a global-norm clip's squared norms) runs on every
  rank: its foreign inputs come from their owners in one all-gather over
  the pp axis (``_from_stages``), so it sums them in the program's order,
  and its outputs are replicated.
- **SelectedRows gradients** (``is_sparse`` lookups): on a vocab-sharded
  table each rank keeps the rows of its range, offset to local slots;
  then each rank's ids and rows are all-gathered over the data axis (the
  row counts first: they differ) and laid end to end in rank order, so
  the update's stable merge sums duplicates in one order on every rank.
"""
from __future__ import annotations

import collections
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..observability.registry import get_registry
from ..parallel.collective import (all_gather_into, copy_to, gather_along,
                                   gather_rows, gathered, reduce_from,
                                   reduce_scatter_into, summed)
from .dtypes import to_device
from .registry import GLOBAL, P, ROWS, Whole, get_op, has_op

__all__ = ["MeshStep", "batch_group", "is_dtensor", "logical_value",
           "tp_shard", "sp_shard", "TPShard", "StageValue"]

_RNG_RANK = "@RNG_RANK@"
_RNG_SHARED = "@RNG_SHARED@"  # the stream every rank of the data axis draws

_WHOLE = Whole()  # the dp rule of an undeclared op (core/registry.py)

# an update op's input that crosses the pipeline axis (``_from_stages``):
# its dtype by index in this list and at most this many dims
_WIRE_DTYPES = [torch.float32, torch.float64, torch.float16, torch.bfloat16,
                torch.int64, torch.int32, torch.int16, torch.int8,
                torch.uint8, torch.bool]
_MAX_NDIM = 8

# update-section ops that are elementwise in every tensor input of the
# parameter's shape: they run on the ZeRO shard as they are. The optimizer
# updates write their inputs' names (ParamOut is Param); the math ops may
# write new names, which then hold shards too
_MATH = frozenset({
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "scale", "sum", "cast", "assign",
})
_ELEMENTWISE = _MATH | {
    "sgd", "momentum", "adam", "adamw", "adagrad", "adamax",
    "decayed_adagrad", "adadelta", "rmsprop", "ftrl",
}

# the packed-table updates: a SelectedRows gradient in local slots and the
# table's own slice (``ops/deferred_rows.py``)
_ROW_UPDATES = frozenset({"sgd_row_packed", "adagrad_row_packed",
                          "adam_row_packed"})

_OBS = get_registry()
_STATE_BYTES = _OBS.gauge("memory/state_bytes_per_device")


def is_dtensor(v) -> bool:
    return type(v).__name__ == "DTensor" and hasattr(v, "to_local")


def logical_value(program, name: str, v):
    """A scope value as one device sees it: a ``DTensor`` is gathered whole
    and a pipeline stage's value (``StageValue``) broadcast from its owner
    (collectives: every rank reads it at the same point), and the ZeRO
    pad rows are dropped (``program._zero_padded``); anything else is
    returned."""
    if isinstance(v, StageValue):
        v = v.full()
    if not is_dtensor(v):
        return v
    full = dtensor_whole(v)
    shape = (getattr(program, "_zero_padded", None) or {}).get(name)
    if shape is not None and tuple(full.shape) != tuple(shape):
        full = full[tuple(slice(0, d) for d in shape)]
    return full


def dtensor_whole(v) -> torch.Tensor:
    """A ``DTensor`` gathered whole with the port's own all-gathers, one a
    sharded mesh dim (``DTensor.full_tensor``'s functional collectives
    were seen to crash on a gloo group over CUDA tensors); pad rows
    kept."""
    local = v.to_local()
    mesh = v.device_mesh
    for dim, place in enumerate(v.placements):
        if place.is_shard():
            local = gathered(local.contiguous(), place.dim,
                             mesh.get_group(dim))
    return local


def batch_group(ctx, slot: str, index: int = 0):
    """The dp axis's process group when the running op's input `slot` is
    batch-sharded over more than one rank (its reductions over dim 0 must
    be global), else None."""
    mesh = getattr(ctx, "mesh", None)
    if mesh is None or mesh.size == 1:
        return None
    names = (getattr(ctx, "in_names", None) or {}).get(slot) or []
    return mesh.group if len(names) > index and names[index] in mesh.batch \
        else None


def tp_shard(ctx, slot: str, index: int = 0):
    """The running op's input `slot` on the model axis: a :class:`TPShard`
    when this rank holds a slice of it, else None (the op sees the whole
    value)."""
    got = (getattr(ctx, "tp_in", None) or {}).get(slot)
    return got[index] if got is not None and len(got) > index else None


def sp_shard(ctx, slot: str, index: int = 0):
    """The running op's input `slot` on the sequence axis: a
    :class:`TPShard` when this rank holds a slice of it, else None."""
    got = (getattr(ctx, "sp_in", None) or {}).get(slot)
    return got[index] if got is not None and len(got) > index else None


# a value sliced on the model (or sequence) axis: the dim, this rank's
# index, the axis size and its process group
TPShard = collections.namedtuple("TPShard", "dim rank size group")

# a leaf's layout over N ranks: its ZeRO axis, the logical extent there and
# that extent padded to a multiple of N
_Plan = collections.namedtuple("_Plan", "axis extent padded")


def _flat(rows):
    for r in rows:
        if isinstance(r, list):
            yield from r
        else:
            yield r


class _Axis:
    """The layouts of values on one axis of the mesh: a model axis
    (``kind`` "tp": one a mesh dim that a parameter's ``shard_spec``
    names) or the sequence axis ("sp"): R (absent from ``lay``), S(d) (an
    int) or P. ``before``/``after`` apply the running op's declaration
    (its ``tp``/``sp`` attribute in ``core/registry.py``; see the module
    docstring) on the local shapes the axes before it left, and return
    the op's inputs' slices for ``ctx.tp_in``/``ctx.sp_in``."""

    def __init__(self, kind: str, name: str, group):
        self.kind, self.name, self.group = kind, name, group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.lay: Dict[str, object] = {}
        self._undo: Dict[int, tuple] = {}

    def begin(self):
        self.lay = {}
        self._undo = {}

    def slice(self, full: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice of dim `dim` of a whole value (a view)."""
        c = full.shape[dim] // self.size
        return full.narrow(dim, self.rank * c, c)

    def _layouts(self, op, env):
        """(slot -> [layout a value]) of the op's inputs, None for R; every
        P input summed first (g), in the env, for every later reader."""
        lay = {}
        for slot, names in op.inputs.items():
            row = []
            for n in names:
                got = self.lay.get(n)
                if got == P:
                    env[n] = reduce_from(env[n], self.group)
                    del self.lay[n]
                    got = None
                row.append(got)
            lay[slot] = row
        return lay

    def before(self, op, env, held=None):
        """Apply the op's declaration: the conversions of its inputs go
        into the env for this op only. `held` (slot -> [{(kind, dim)}])
        is what the axes before this one keep sliced of each input for
        the op: a declaration that would keep a slice of the same dim, or
        a second model-axis slice of one input, is not applied and this
        axis's inputs are gathered whole. Returns this axis's slices of
        the inputs (slot -> [TPShard or None]) or None."""
        if not any(n in self.lay for n in op.input_names()):
            return None
        lay = self._layouts(op, env)
        if not any(d is not None for row in lay.values() for d in row):
            return None
        decl = getattr(get_op(op.type), self.kind) if has_op(op.type) \
            else None
        shapes = {slot: [tuple(env[n].shape)
                         if isinstance(env.get(n), torch.Tensor) else ()
                         for n in names] for slot, names in op.inputs.items()}
        rule = decl(op.attrs, lay, shapes, self.size) \
            if callable(decl) else None
        if rule is not None and not rule.regather and held and \
                self._clashes(lay, rule, held):
            rule = None
        swaps = {}

        def swap(n, v):
            swaps.setdefault(n, env[n])
            env[n] = v

        if rule is None or rule.regather:
            for slot, names in op.inputs.items():
                for n, d in zip(names, lay[slot]):
                    if d is not None:
                        swap(n, gather_along(env[n], d, self.group))
            self._undo[id(op)] = (swaps, None, rule)
            return None
        sharded_out = not rule.inner and any(
            v is not None for v in _flat(rule.out.values()))
        for slot, names in op.inputs.items():
            for i, (n, d) in enumerate(zip(names, lay[slot])):
                v = env.get(n)
                if d is not None or not isinstance(v, torch.Tensor):
                    continue
                cut = rule.slice_in.get(slot)
                if sharded_out and v.requires_grad:
                    v = copy_to(v, self.group)
                if cut is not None:
                    v = self.slice(v, cut)
                    lay[slot][i] = cut
                if v is not env[n]:
                    swap(n, v)
        attrs = None
        if rule.attrs:
            attrs = op.attrs
            op.attrs = {**op.attrs, **rule.attrs}
        self._undo[id(op)] = (swaps, attrs, rule)
        return {slot: [None if d is None else
                       TPShard(d, self.rank, self.size, self.group)
                       for d in row] for slot, row in lay.items()}

    def _clashes(self, lay, rule, held) -> bool:
        """Whether `rule` keeps a slice of an input that an axis before
        this one keeps sliced along the same dim, or that another model
        axis keeps sliced at all (an op reads one model-axis slice of an
        input, ``tp_shard``)."""
        for slot, row in lay.items():
            prior = held.get(slot)
            if not prior:
                continue
            cut = rule.slice_in.get(slot)
            for i, d in enumerate(row):
                d = cut if d is None else d
                if d is None or d == P:
                    continue
                if any(dim == d or kind == self.kind
                       for kind, dim in prior[i]):
                    return True
        return False

    def after(self, op, env):
        """Restore what `before` swapped and record the outputs'
        layouts."""
        outs = op.output_names()
        undo = self._undo.pop(id(op), None)
        if undo is None:
            for n in outs:
                self.lay.pop(n, None)
            return
        swaps, attrs, rule = undo
        for n, v in swaps.items():
            if n not in outs:
                env[n] = v
        if attrs is not None:
            op.attrs = attrs
        if rule is not None and rule.regather:
            (d,) = set(rule.regather.values())
            for n in outs:
                v = env.get(n)
                if isinstance(v, torch.Tensor):
                    if v.requires_grad:
                        v = copy_to(v, self.group)
                    env[n] = self.slice(v, d)
                    self.lay[n] = d
            return
        for slot, names in op.outputs.items():
            got = (rule.out.get(slot) if rule is not None else None)
            row = got if isinstance(got, list) else [got] * len(names)
            for n, d in zip(names, row):
                if d is None:
                    self.lay.pop(n, None)
                else:
                    self.lay[n] = d

    def restore(self, op, env):
        undo = self._undo.pop(id(op), None)
        if undo is not None:
            swaps, attrs, _ = undo
            env.update(swaps)
            if attrs is not None:
                op.attrs = attrs

    def whole(self, v, name):
        """A fetched value made global on this axis (S gathered, P
        summed)."""
        d = self.lay.get(name)
        if d == P:
            return summed(v, self.group)
        if d is not None:
            return gathered(v.detach(), d, self.group)
        return v


def _unwrap(v):
    return v.local if isinstance(v, StageValue) else v


def _dtype_of(program, name):
    from .dtypes import convert_dtype

    var = program.global_block()._find_var_recursive(name)
    return convert_dtype(var.dtype if var is not None else "float32")


class StageValue:
    """A persistable that one pipeline stage's rank holds (see
    ``MeshStep._stage_owner``), as every rank's scope keeps it: `local`
    is the value on the owning rank (a tensor, or a DTensor on the model
    axis) and None elsewhere. ``full()`` makes it whole on every rank of
    the pipeline axis (a broadcast from the owner: every rank calls it at
    the same point, as ``DTensor.full_tensor``)."""

    __slots__ = ("owner", "mesh", "axis", "group", "rank", "shape", "dtype",
                 "device", "local")

    def __init__(self, step, name, local):
        self.owner = step.owner[name]
        self.mesh, self.axis = step.mesh, step.pp_axis
        self.group = step.pp_group
        self.rank = step.pp_rank
        var = step.program.global_block()._find_var_recursive(name)
        self.shape = tuple(var.shape)
        self.dtype = _dtype_of(step.program, name)
        self.device = step.device
        self.local = local

    @property
    def mine(self) -> bool:
        return self.owner == self.rank

    def full(self) -> torch.Tensor:
        """The whole value (a ZeRO slice's pad rows dropped) on every rank
        of the pipeline axis."""
        if self.mine:
            v = self.local
            if is_dtensor(v):
                v = dtensor_whole(v)
                v = v[tuple(slice(0, d) for d in self.shape)]
            v = v.detach().contiguous().clone()
        else:
            v = torch.empty(self.shape, dtype=self.dtype, device=self.device)
        dist.broadcast(v, dist.get_global_rank(self.group, self.owner),
                       group=self.group)
        return v


class MeshStep:
    """One CompiledProgram's per-rank step on its data axis (built by the
    executor; see the module docstring)."""

    def __init__(self, compiled, device):
        from .compiler import ShardingStrategy, _zero_axis

        self.program = compiled._program
        self.mesh = compiled._mesh
        self.axis = compiled._data_axis
        # no data axis: every rank feeds the whole batch, and the other
        # dims compute it alike (the JAX package's data_axis=None)
        self.group = (self.mesh.get_group(self.axis)
                      if self.axis is not None else None)
        self.size = (dist.get_world_size(self.group)
                     if self.group is not None else 1)
        self.rank = dist.get_rank(self.group) if self.group is not None else 0
        self.device = device
        self.stage = compiled._zero_stage()
        # one _Axis a model axis (each mesh dim a parameter's spec names),
        # then the sequence axis; the first model axis is the one of
        # tp_state, tp_group and tp_rank (a vocab-sharded table's
        # SelectedRows gradient)
        self.tps = [_Axis("tp", a, self.mesh.get_group(a))
                    for a in compiled._model_axes]
        self.tpx = self.tps[0] if self.tps else None
        self.tp_group = self.tpx.group if self.tpx is not None else None
        self.tp_rank = self.tpx.rank if self.tpx is not None else 0
        self.sp_axis = compiled._seq_axis
        self.spx = (_Axis("sp", self.sp_axis,
                          self.mesh.get_group(self.sp_axis))
                    if self.sp_axis is not None else None)
        self.axes = self.tps + ([self.spx] if self.spx is not None else [])
        self.pp_axis = compiled._pp_axis
        self.pp_group = (self.mesh.get_group(self.pp_axis)
                         if self.pp_axis is not None else None)
        self.pp_size = (dist.get_world_size(self.pp_group)
                        if self.pp_group is not None else 1)
        self.pp_rank = (dist.get_rank(self.pp_group)
                        if self.pp_group is not None else 0)
        # name -> [(axis, sliced dim)] and name -> its dim on the data axis
        self.sliced, self.dp_spec = self._sliced_state()
        self.tp_state = {n: d for n, cuts in self.sliced.items()
                         for ax, d in cuts if ax is self.tpx}
        self.owner = self._stage_owner()  # name -> its pp coordinate
        # sliced optimizer state that ZeRO also shards over the data axis:
        # name -> the dim of this rank's slice it is cut along
        self.tpz = self._sliced_zero(compiled)
        self.dpx = collections.namedtuple("DataAxis", "name size")(
            self.axis, self.size)
        compiled._zero_pad_map()  # records program._zero_padded
        self.stored: Dict[str, _Plan] = {}   # sharded between steps
        self.param_plan: Dict[str, _Plan] = {}  # update / reduction layout
        for v in self.program.list_vars():
            if not v.persistable or v.name in self.sliced:
                continue
            if v.name in self.dp_spec:
                plan = self._plan(v.shape, self.dp_spec[v.name])
                self.stored[v.name] = plan
                if getattr(v, "trainable", False):
                    self.param_plan[v.name] = plan
                continue
            plan = compiled._zero_plan(v)
            if plan is not None:
                self.stored[v.name] = self._plan(v.shape, plan[0])
            if compiled._fsdp_param(v):
                axis = _zero_axis(v.shape, self.size)
                if axis is not None:
                    self.param_plan[v.name] = self._plan(v.shape, axis)
        self.fsdp = ({n for n in self.stored if n in self.param_plan}
                     if self.stage >= ShardingStrategy.stage3
                     else {n for n in self.param_plan if n in self.dp_spec})
        self._held: Dict[str, tuple] = {}   # name -> (DTensor, its local)
        self.shared_gen = None
        self.begin()

    def _plan(self, shape, axis) -> _Plan:
        d = int(shape[axis])
        return _Plan(axis, d, -(-d // self.size) * self.size)

    def _sliced_state(self):
        """({name: [(axis, dim)]}, {name: dim}): the persistables this rank
        holds a slice of on a model or sequence axis, and those sharded
        over the data axis by their spec (ZeRO stage 3 for them, on the
        spec's dim): the parameters whose shard_spec names the axis, and
        the inputs of their update ops with the parameter's shape
        (optimizer state, gradient buffers). Raises ValueError for a spec
        that names an axis the mesh lacks or a dim its axis does not
        divide (the JAX package's placement raises the same)."""
        names = tuple(self.mesh.mesh_dim_names)
        sizes = dict(zip(names, self.mesh.shape))
        by_name = {ax.name: ax for ax in self.axes}
        sliced: Dict[str, list] = {}
        on_dp: Dict[str, int] = {}
        shapes = {}
        for v in self.program.list_vars():
            spec = getattr(v, "shard_spec", None)
            if not v.persistable or spec is None:
                continue
            for i, a in enumerate(spec):
                if a is None:
                    continue
                if a not in sizes:
                    raise ValueError(
                        f"Resource axis: {a} of PartitionSpec{tuple(spec)} "
                        f"(parameter {v.name!r}) is not found in mesh: "
                        f"{names}.")
                if int(v.shape[i]) % sizes[a]:
                    raise ValueError(
                        f"parameter {v.name!r} was given the sharding "
                        f"PartitionSpec{tuple(spec)}, which implies that the "
                        f"global size of its dimension {i} should be "
                        f"divisible by {sizes[a]}, but it is equal to "
                        f"{v.shape[i]} (full shape: {tuple(v.shape)})")
                if sizes[a] == 1:
                    continue
                if a == self.pp_axis:
                    raise NotImplementedError(
                        f"parameter {v.name!r} is sharded over the pipeline "
                        f"axis {a!r}, whose ranks hold one stage's "
                        f"parameters each; give it a spec on another axis")
                if a == self.axis:
                    on_dp[v.name] = i
                elif a in by_name:
                    sliced.setdefault(v.name, []).append((by_name[a], i))
            if v.name in on_dp and v.name in sliced:
                raise NotImplementedError(
                    f"parameter {v.name!r}: a spec that names the data axis "
                    f"beside another axis ({tuple(spec)}); shard it over "
                    f"one of them")
            if v.name in on_dp or v.name in sliced:
                shapes[v.name] = tuple(v.shape)
        if not shapes:
            return sliced, on_dp
        block = self.program.global_block()
        for op in block.ops:
            ps = op.inputs.get("Param") or []
            if len(ps) != 1 or ps[0] not in shapes:
                continue
            for slot, ns in op.inputs.items():
                for n in ns:
                    var = block._find_var_recursive(n)
                    if (slot not in ("Param", "Grad") and var is not None
                            and var.persistable
                            and tuple(var.shape) == shapes[ps[0]]):
                        if ps[0] in sliced:
                            sliced[n] = sliced[ps[0]]
                        else:
                            on_dp[n] = on_dp[ps[0]]
        return sliced, on_dp

    def _sliced_zero(self, compiled) -> Dict[str, int]:
        """{name: dim}: the sliced persistables that the ZeRO stage shards
        (optimizer state, as ``compiled._zero_plan`` decides for a whole
        leaf) with a dim of this rank's slice that the data axis divides
        and no model or sequence axis cuts (the largest such dim). Each
        rank then holds 1/(dp·tp) of them, between steps and through the
        update (``_parts_before``)."""
        out: Dict[str, int] = {}
        if self.group is None or self.size == 1:
            return out
        block = self.program.global_block()
        for n, cuts in self.sliced.items():
            var = block._find_var_recursive(n)
            if var is None or n in self.owner or \
                    compiled._zero_plan(var) is None:
                continue
            shape = [int(d) for d in var.shape]
            for ax, d in cuts:
                shape[d] //= ax.size
            cut = {d for _, d in cuts}
            dims = [i for i, d in enumerate(shape)
                    if i not in cut and d % self.size == 0]
            if dims:
                out[n] = max(dims, key=lambda i: shape[i])
        return out

    def _stage_owner(self) -> Dict[str, int]:
        """{name: pp coordinate} of every persistable one pipeline stage
        holds: the parameters of stage s of each ``pipeline`` or
        ``pipeline_hetero`` op on the pp axis, and the persistables that
        only that parameter's update ops read (its optimizer state). The
        rank at coordinate s holds and updates them; the others hold none
        of their bytes. A program whose stage count differs from the axis
        size raises ValueError."""
        if self.pp_axis is None:
            return {}
        block = self.program.global_block()
        out: Dict[str, int] = {}
        for op in block.ops:
            if op.type not in ("pipeline", "pipeline_hetero") or \
                    op.attrs.get("axis", "pp") != self.pp_axis:
                continue
            n = int(op.attrs["n_stages"])
            if n != self.pp_size:
                raise ValueError(
                    f"{op.type}: {n} stages on the {self.pp_axis!r} mesh "
                    f"axis of {self.pp_size} devices; the program's stage "
                    f"count must equal the axis size")
            flat = op.inputs["Params"]
            if op.type == "pipeline":
                k = int(op.attrs["n_params"])
                stages = [flat[s * k:(s + 1) * k] for s in range(n)]
            else:
                stages = [list(ns) for ns in op.attrs["param_names"]]
            for s, names in enumerate(stages):
                for name in names:
                    if out.get(name, s) != s:
                        raise ValueError(
                            f"{op.type}: parameter {name!r} is read by "
                            f"stages {out[name]} and {s}; a pipeline "
                            f"stage's parameters are its own")
                    out[name] = s
        if not out:
            return out
        readers: Dict[str, set] = {}
        for op in block.ops:
            ps = op.inputs.get("Param") or []
            if len(ps) != 1:
                continue
            for n in op.input_names():
                readers.setdefault(n, set()).add(ps[0])
        for n, params in readers.items():
            var = block._find_var_recursive(n)
            if (n not in out and len(params) == 1 and var is not None
                    and var.persistable):
                (p,) = params
                if p in out:
                    out[n] = out[p]
        return out

    def foreign(self, name: str) -> bool:
        """Whether `name` belongs to another pipeline stage's rank."""
        s = self.owner.get(name)
        return s is not None and s != self.pp_rank

    def alias_layouts(self, dst: List[str], src: List[str]):
        """The layouts of `src` names on every axis given to `dst` names
        (a pipeline's template sub-block runs this rank's stage
        parameters under stage 0's names, and its input under its own)."""
        for ax in self.axes:
            for d, s_ in zip(dst, src):
                if s_ in ax.lay:
                    ax.lay[d] = ax.lay[s_]
                else:
                    ax.lay.pop(d, None)

    def relayout(self, name: str, v: torch.Tensor, like: str):
        """`v`, the value of `name`, laid out on every axis as `like` is
        (a pipeline stage's output on its input's layout): sliced or
        gathered along the dims that differ, differentiably."""
        for ax in self.axes:
            have, want = ax.lay.get(name), ax.lay.get(like)
            if have == want:
                continue
            if have == P:
                v = reduce_from(v, ax.group)
            elif have is not None:
                v = gather_along(v, have, ax.group)
            if want is not None:
                if v.requires_grad:
                    v = copy_to(v, ax.group)
                v = ax.slice(v, want)
                ax.lay[name] = want
            else:
                ax.lay.pop(name, None)
        return v

    # -- per-step state ----------------------------------------------------
    def begin(self):
        self.batch = set()
        self.local: Dict[str, _Plan] = {}   # env names holding a shard
        self.after_ad = False
        self.mode: Dict[int, str] = {}      # update op -> "shard" | "whole"
        self.spec: Dict[int, object] = {}   # op -> its dp declaration
        for ax in self.axes:
            ax.begin()
        self.staged: Dict[str, int] = {}    # outputs of one stage's updates
        self.mixing = set()                 # updates that read two stages
        # rule A: op -> (its inputs' own values, (first row, rows, whole
        # rows) of this rank, the inputs it took out of `batch`), and the
        # global values whose dim 0 is the whole batch -> that triple
        self.gathered: Dict[int, tuple] = {}
        # ``tpz``: env names holding this rank's part over the data axis of
        # their slice -> the dim; update op -> (that dim, the slices of
        # non-tpz persistables it read, cut for it)
        self.zpart: Dict[str, int] = {}
        self.pmode: Dict[int, tuple] = {}
        self.whole_rows: Dict[str, tuple] = {}
        self.gens: Dict[int, object] = {}   # op -> the generator it swapped

    def plan_of(self, name: str) -> Optional[_Plan]:
        """The layout a value of `name` is sliced by in the update section:
        its own when it is stored sharded, its parameter's for a parameter
        or its gradient (stages 1–3), else None."""
        if name in self.local:
            return self.local[name]
        if name in self.stored:
            return self.stored[name]
        base = name[:-5] if name.endswith("@GRAD") else name
        if self.stage >= 1 or base in self.dp_spec:
            if base in self.param_plan:
                return self.param_plan[base]
        return None

    # -- shards ------------------------------------------------------------
    def shard(self, full: torch.Tensor, plan: _Plan) -> torch.Tensor:
        """This rank's padded slice of a whole value (the value itself on a
        group of one)."""
        if self.size == 1:
            return full
        axis, d, padded = plan
        c = padded // self.size
        x = full.movedim(axis, 0)
        lo, hi = min(self.rank * c, d), min((self.rank + 1) * c, d)
        piece = x[lo:hi]
        if hi - lo < c:
            pad = piece.new_zeros((c - (hi - lo),) + tuple(x.shape[1:]))
            piece = torch.cat([piece, pad])
        return piece.movedim(0, axis).contiguous()

    def gather(self, local: torch.Tensor, plan: _Plan) -> torch.Tensor:
        """The whole value from every rank's slice, pad dropped."""
        axis, d, pd = plan
        x = local.movedim(axis, 0).contiguous()
        out = x.new_empty((pd,) + tuple(x.shape[1:]))
        all_gather_into(out, x, self.group)
        return out[:d].movedim(0, axis)

    def gather_many(self, items):
        """[(name, whole value)] of [(name, shard, plan)]: one all-gather a
        dtype over the shards laid end to end (each rank's part of the
        buffer is its slices in order)."""
        by_dtype: Dict[torch.dtype, List[tuple]] = {}
        for item in items:
            by_dtype.setdefault(item[1].dtype, []).append(item)
        out = []
        for group in by_dtype.values():
            parts = [v.movedim(p.axis, 0).reshape(-1) for _, v, p in group]
            widths = [x.numel() for x in parts]
            mine = torch.cat(parts)
            every = mine.new_empty(self.size * mine.numel())
            all_gather_into(every, mine, self.group)
            cols = every.view(self.size, -1).split(widths, dim=1)
            for (n, v, p), col in zip(group, cols):
                moved = v.movedim(p.axis, 0).shape
                whole = col.reshape((p.padded,) + tuple(moved[1:]))
                out.append((n, whole[:p.extent].movedim(0, p.axis)
                            .contiguous()))
        return out

    def _store_shard(self, scope, name, local, plan):
        """Put a shard in the scope as a ``DTensor``: the bytes go into the
        one this step stored there before (a device copy, where a new
        ``DTensor``, or a call into one, costs host time each step), else
        a new one. ``_held`` keeps each stored DTensor with its local
        tensor, so a step reads and writes them without DTensor calls."""
        held = self._held.get(name)
        if (held is not None and _unwrap(scope.find_var(name)) is held[0]
                and held[1].shape == local.shape
                and held[1].dtype == local.dtype):
            if held[1].data_ptr() != local.data_ptr():
                held[1].copy_(local)
            return
        dt = self.to_dtensor(local, plan)
        scope.set_var(name, dt)
        self._held[name] = (dt, dt.to_local())

    def _store_sliced(self, scope, name, local):
        """`_store_shard` for a slice on model or sequence axes."""
        held = self._held.get(name)
        if (held is not None and _unwrap(scope.find_var(name)) is held[0]
                and held[1].shape == local.shape
                and held[1].dtype == local.dtype):
            if held[1].data_ptr() != local.data_ptr():
                held[1].copy_(local)
            return
        cuts = list(self.sliced[name])
        if name in self.tpz:
            cuts.append((self.dpx, self.tpz[name]))
        dt = self.sliced_dtensor(local, cuts)
        scope.set_var(name, dt)
        self._held[name] = (dt, dt.to_local())

    def to_dtensor(self, local: torch.Tensor, plan: _Plan):
        from torch.distributed.tensor import DTensor, Replicate, Shard

        place = [Replicate()] * self.mesh.ndim
        place[list(self.mesh.mesh_dim_names).index(self.axis)] = \
            Shard(plan.axis)
        shape = list(local.shape)
        shape[plan.axis] = plan.padded
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(local, self.mesh, place, run_check=False,
                                  shape=torch.Size(shape), stride=stride)

    # -- model and sequence axes ------------------------------------------
    def sliced_dtensor(self, local: torch.Tensor, cuts):
        """A ``DTensor`` of this rank's slice: ``Shard(d)`` on the mesh dim
        of each (axis, d) of `cuts`."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        names = list(self.mesh.mesh_dim_names)
        place = [Replicate()] * self.mesh.ndim
        shape = list(local.shape)
        for ax, d in cuts:
            place[names.index(ax.name)] = Shard(d)
            shape[d] *= ax.size
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(local, self.mesh, place, run_check=False,
                                  shape=torch.Size(shape), stride=stride)

    def _fits(self, v, cuts, zd=None) -> bool:
        """Whether a scope ``DTensor`` holds this rank's slices of `cuts`
        (and its part along `zd` over the data axis) as its local
        tensor."""
        if not is_dtensor(v):
            return False
        names = list(self.mesh.mesh_dim_names)
        local = v.to_local()
        cuts = list(cuts) + ([(self.dpx, zd)] if zd is not None else [])
        for ax, d in cuts:
            place = v.placements[names.index(ax.name)]
            if (not place.is_shard(d)
                    or local.shape[d] * ax.size != v.shape[d]):
                return False
        return True

    def restore(self, op, env, ctx):
        """Undo an op's input swaps and attribute overrides after it
        raised (the program's attributes must not keep this rank's)."""
        ctx.tp_in = ctx.sp_in = None
        for ax in reversed(self.axes):
            ax.restore(op, env)
        undo = self.gathered.pop(id(op), None)
        if undo is not None:
            env.update(undo[0])
            self.batch.update(undo[2] or ())
        gen = self.gens.pop(id(op), None)
        if gen is not None:
            ctx._gen = gen

    def _axes_update(self, op, env) -> bool:
        """An update-section op that reads a slice on some axis: the
        optimizer ops and elementwise math run on the slices as they are;
        any other op gets the slices gathered whole, and its outputs that
        are sliced state are cut back (``after_op``)."""
        names = op.input_names()
        modes = []
        for ax in self.axes:
            dims = {ax.lay[n] for n in names if n in ax.lay}
            if not dims:
                continue
            if op.type in _ROW_UPDATES:
                modes.append((ax, dims.pop()))
                continue
            if op.type in _ELEMENTWISE and len(dims) == 1 and all(
                    n in ax.lay or not isinstance(env.get(n), torch.Tensor)
                    or env[n].numel() <= 1 for n in names):
                modes.append((ax, dims.pop()))
                continue
            for n in names:
                if n in ax.lay:
                    env[n] = ax.whole(env[n], n)
                    del ax.lay[n]
            modes.append((ax, None))
        if not modes:
            return False
        self.mode[id(op)] = ("tp", modes)
        return True

    # -- the step ----------------------------------------------------------
    def check_feeds(self, feed_vals):
        """Every rank feeds the same number of rows: one all-gather of the
        row counts, run by every rank at the start of every step, so a
        rank that feeds another count (a ragged last batch) raises on
        every rank before the step's first collective. On a sequence axis
        every feed of rank ≥ 2 has a dim 1 that the axis divides, the same
        on each rank of it."""
        if self.spx is not None and feed_vals:
            lens = [int(v.shape[1]) for _, v in sorted(feed_vals.items())
                    if v.ndim >= 2]
            mine = torch.tensor(lens or [0], dtype=torch.int64,
                                device=self.device)
            every = mine.new_empty(self.spx.size * mine.numel())
            all_gather_into(every, mine, self.spx.group)
            every = every.view(self.spx.size, -1).cpu()
            bad = [t for t in lens if t % self.spx.size]
            if not bool((every == every[0]).all()) or bad:
                raise ValueError(
                    f"sequence-parallel feeds: dim 1 of every feed of rank "
                    f">= 2 must be the same on each rank of the "
                    f"{self.sp_axis!r} axis and divisible by its size "
                    f"{self.spx.size}; got {every.tolist()} for "
                    f"{sorted(n for n, v in feed_vals.items() if v.ndim >= 2)}")
        if self.size == 1 or not feed_vals:
            return
        rows = [int(v.shape[0]) if v.ndim else 1
                for _, v in sorted(feed_vals.items())]
        mine = torch.tensor(rows, dtype=torch.int64, device=self.device)
        every = mine.new_empty(self.size * len(rows))
        all_gather_into(every, mine, self.group)
        every = every.view(self.size, len(rows)).cpu()
        if not bool((every == every[0]).all()):
            raise ValueError(
                f"data-parallel feeds: every rank must feed the same number "
                f"of rows (its local batch); got {every.tolist()} for "
                f"{sorted(feed_vals)}")

    def place_feeds(self, feed_vals):
        """The feeds as this rank holds them: on a sequence axis, dim 1 of
        every feed of rank ≥ 2 is sliced (S(1)); the rest as fed."""
        if self.spx is None:
            return feed_vals
        out = {}
        for n, v in feed_vals.items():
            if v.ndim >= 2:
                v = self.spx.slice(v, 1)
                self.spx.lay[n] = 1
            out[n] = v
        return out

    def load_state(self, env, scope, state_names):
        """Scope → env: sharded leaves as this rank's slice, the rest whole
        on the step's device; another pipeline stage's persistables as an
        empty placeholder (this rank holds none of their bytes)."""
        for n in state_names:
            v = scope.find_var(n)
            if n in self.owner:
                if isinstance(v, StageValue):
                    v = v.local
                if self.foreign(n):
                    env[n] = torch.empty(0, device=self.device,
                                         dtype=_dtype_of(self.program, n))
                    continue
            cuts = self.sliced.get(n)
            if cuts is not None:
                for ax, d in cuts:
                    ax.lay[n] = d
                held = self._held.get(n)
                zd = self.tpz.get(n)
                if held is not None and v is held[0]:
                    env[n] = held[1]
                elif self._fits(v, cuts, zd):
                    env[n] = to_device(v.to_local(), self.device)
                else:
                    full = to_device(logical_value(self.program, n, v),
                                     self.device)
                    for ax, d in cuts:
                        full = ax.slice(full, d)
                    if zd is not None:
                        full = full.chunk(self.size, zd)[self.rank]
                    env[n] = full.contiguous()
                if zd is not None:  # this rank's part of the slice
                    self.zpart[n] = zd
                continue
            plan = self.stored.get(n)
            held = self._held.get(n)
            if held is not None and v is held[0]:
                env[n] = held[1]   # the DTensor this step stored
                self.local[n] = plan
                continue
            if (plan is not None and is_dtensor(v)
                    and tuple(v.shape)[plan.axis] == plan.padded
                    and v.to_local().shape[plan.axis] == plan.padded
                    // self.size):
                env[n] = to_device(v.to_local(), self.device)
                self.local[n] = plan
                continue
            full = to_device(logical_value(self.program, n, v), self.device)
            if plan is not None:
                env[n] = self.shard(full, plan)
                self.local[n] = plan
            else:
                env[n] = full

    def generator(self, scope, gen):
        """The step's generator: the scope's, folded once with this rank
        (rank 0 keeps its stream). The base seed is rank 0's, broadcast.
        Beside it, ``shared_gen``: a stream every rank of the data axis
        draws alike, for an op that reads no rank's own rows (rule A's,
        and the global ops after it: one draw for every rank, as the JAX
        package's one program draws once)."""
        from .executor import _RNG_STATE

        if scope.find_var(_RNG_RANK) == (self.rank, self.size, id(gen)):
            self.shared_gen = scope.find_var(_RNG_SHARED) or gen
            return gen
        self.shared_gen = gen
        if self.group is not None and self.size > 1:
            seed = torch.tensor([int(self.program.random_seed or 0)],
                                dtype=torch.int64, device=self.device)
            dist.broadcast(seed, dist.get_global_rank(self.group, 0),
                           group=self.group)
            base = int(seed.item())
            self.shared_gen = torch.Generator(self.device).manual_seed(
                (base * 0x2545F491 + 0x5EED) % (2 ** 63))
            scope.set_var(_RNG_SHARED, self.shared_gen)
            if self.rank:
                folded = (base * 0x9E3779B1
                          + self.rank * 0x7F4A7C15) % (2 ** 63)
                gen = torch.Generator(self.device).manual_seed(folded)
                scope.set_var(_RNG_STATE, gen)
        scope.set_var(_RNG_RANK, (self.rank, self.size, id(gen)))
        return gen

    def _stage_of(self, n: str):
        """The pp coordinate that holds `n` in the update section (a
        stage's persistable, its gradient, or what an update op that reads
        one stage's values wrote), or None (replicated)."""
        s = self.staged.get(n, self.owner.get(n))
        if s is None and n.endswith("@GRAD"):
            s = self.owner.get(n[:-5])
        return s

    def skip(self, op) -> bool:
        """Whether this rank leaves out an update-section op: one that
        reads or writes another pipeline stage's values (its parameters,
        their gradients and optimizer state, or what a left-out op wrote).
        An op that mixes two stages' values (the sum of a global-norm
        clip's squared norms) runs on every rank: ``before_op`` brings its
        foreign inputs from their owners, and its outputs are replicated."""
        if not self.owner or not self.after_ad:
            return False
        owners = set()
        for n in op.input_names() + op.output_names():
            s = self._stage_of(n)
            if s is not None:
                owners.add(s)
        if len(owners) > 1:
            self.mixing.add(id(op))
            for n in op.output_names():
                self.staged.pop(n, None)
            return False
        if owners:
            (s,) = owners
            for n in op.output_names():
                self.staged[n] = s
            return s != self.pp_rank
        return False

    def _from_stages(self, op, env):
        """The inputs of an update op that reads several stages' values,
        on every rank of the pipeline axis: each rank makes its stage's
        inputs whole, one all-gather over the axis brings their dtypes and
        shapes (only the owners know them) and a second their values, as
        f64 (exact for every float dtype of the list and for integers
        below 2^53). The op then reads them in its input order, so it
        sums them in the plain program's order on every rank."""
        names = [n for n in dict.fromkeys(op.input_names())
                 if self._stage_of(n) is not None]
        if not names:
            return
        stage = {n: self._stage_of(n) for n in names}
        width = 2 + _MAX_NDIM
        meta = torch.zeros(len(names) * width, dtype=torch.int64)
        mine = []
        for i, n in enumerate(names):
            if stage[n] != self.pp_rank:
                continue
            v = self._whole_here(n, env)
            if v.ndim > _MAX_NDIM:
                raise ValueError(f"update op {op.type!r}: input {n!r} has "
                                 f"{v.ndim} dims; at most {_MAX_NDIM} cross "
                                 f"the pipeline axis")
            meta[i * width] = _WIRE_DTYPES.index(v.dtype)
            meta[i * width + 1] = v.ndim
            meta[i * width + 2:i * width + 2 + v.ndim] = torch.tensor(
                v.shape, dtype=torch.int64)
            mine.append(v.reshape(-1).to(torch.float64))
        meta = meta.to(self.device)
        every = meta.new_empty(self.pp_size * meta.numel())
        all_gather_into(every, meta, self.pp_group)
        every = every.view(self.pp_size, len(names), width).cpu().tolist()
        shapes = {n: tuple(every[stage[n]][i][2:2 + every[stage[n]][i][1]])
                  for i, n in enumerate(names)}
        sizes = [sum(math.prod(shapes[n]) for n in names if stage[n] == s)
                 for s in range(self.pp_size)]
        most = max(sizes)
        buf = torch.zeros(most, dtype=torch.float64, device=self.device)
        if mine:
            flat = torch.cat(mine)
            buf[:flat.numel()] = flat
        got = buf.new_empty(self.pp_size * most)
        all_gather_into(got, buf, self.pp_group)
        got = got.view(self.pp_size, most)
        offset = [0] * self.pp_size
        for i, n in enumerate(names):
            s = stage[n]
            k = math.prod(shapes[n])
            if s != self.pp_rank:
                dt = _WIRE_DTYPES[every[s][i][0]]
                env[n] = got[s, offset[s]:offset[s] + k].reshape(
                    shapes[n]).to(dt)
            offset[s] += k

    def _whole_here(self, n, env) -> torch.Tensor:
        """This rank's value of `n` made whole on its own stage's axes (a
        ZeRO shard gathered over the data axis, a slice over its axis)."""
        v = env[n]
        if n in self.local:
            v = self.gather(v, self.local[n])
        for ax in self.axes:
            v = ax.whole(v, n)
        return v.detach()

    def before_op(self, op, env, ctx):
        ctx.in_names = op.inputs
        ctx.tp_in = ctx.sp_in = None
        if not self.after_ad:
            if self.fsdp:
                self.gather_params(op.input_names(), env, ctx)
            for n in op.input_names():
                if n in self.zpart:
                    env[n] = gathered(env[n], self.zpart.pop(n), self.group)
            spec = self._spec(op, env)
            if spec is not None:
                self.spec[id(op)] = spec
                if isinstance(spec, Whole):
                    self._gather_whole(op, env)
                elif self.whole_rows:
                    self._cut_whole_rows(op, env)
            if (spec is None or isinstance(spec, Whole)) and \
                    self.shared_gen is not None:
                self.gens[id(op)] = ctx._gen
                ctx._gen = self.shared_gen
            held: Dict[str, list] = {}
            for ax in self.axes:
                got = ax.before(op, env, held)
                if got is None:
                    continue
                key = ax.kind + "_in"
                merged = getattr(ctx, key) or {}
                for slot, row in got.items():
                    have = merged.get(slot) or [None] * len(row)
                    merged[slot] = [h or g for h, g in zip(have, row)]
                    marks = held.setdefault(slot, [set() for _ in row])
                    for i, g in enumerate(row):
                        if g is not None:
                            marks[i].add((ax.kind, g.dim))
                setattr(ctx, key, merged)
            return
        if id(op) in self.mixing:
            self._from_stages(op, env)
        if self.batch and any(n in self.batch for n in op.input_names()):
            # an update that reads a rank's rows (the deferred-row ops read
            # the lookup's rows beside the gradient's global ids): the rows
            # gathered whole in rank order, the SelectedRows gradient's order
            self._gather_whole(op, env)
        if self.zpart:
            self._parts_before(op, env)
        if any(ax.lay for ax in self.axes) and self._axes_update(op, env):
            return
        names = op.input_names()
        if not any(self.plan_of(n) is not None for n in names):
            self.mode.pop(id(op), None)
            return
        if op.type in _ELEMENTWISE and self._elementwise_ok(op, env):
            for n in names:
                plan = self.plan_of(n)
                if plan is not None and n not in self.local:
                    env[n] = self.shard(env[n], plan)
                    self.local[n] = plan
            self.mode[id(op)] = "shard"
        else:
            for n in names:
                if n in self.local:
                    env[n] = self.gather(env[n], self.local.pop(n))
            self.mode[id(op)] = "whole"

    def _parts_before(self, op, env):
        """An update op that reads a part over the data axis (``zpart``):
        elementwise, with every other input of more than one element the
        parts' slice shape, it runs on the parts, those inputs cut to this
        rank's part (``after_op`` gathers the parameters it writes back to
        their slices); any other op gets the parts gathered to slices."""
        names = op.input_names()
        dims = {self.zpart[n] for n in names if n in self.zpart}
        if not dims:
            return
        if op.type in _ELEMENTWISE and len(dims) == 1:
            zd = dims.pop()
            part = next(env[n] for n in names if n in self.zpart)
            shape = list(part.shape)
            shape[zd] *= self.size
            cut = [n for n in names if n not in self.zpart
                   and isinstance(env.get(n), torch.Tensor)
                   and env[n].numel() > 1]
            if all(list(env[n].shape) == shape for n in cut):
                kept = {}
                for n in cut:
                    if n in self.sliced:
                        kept[n] = env[n]
                    env[n] = env[n].chunk(self.size, zd)[self.rank] \
                        .contiguous()
                    self.zpart[n] = zd
                self.pmode[id(op)] = (zd, kept)
                return
        for n in names:
            if n in self.zpart:
                env[n] = gathered(env[n], self.zpart.pop(n), self.group)

    def _parts_after(self, op, env):
        """After an update on parts: a non-tpz persistable it wrote is
        all-gathered over the data axis to its slice, one it only read
        gets its slice back; tpz state and new values stay parts."""
        zd, kept = self.pmode.pop(id(op))
        outs = op.output_names()
        for n in outs:
            v = env.get(n)
            if not isinstance(v, torch.Tensor):
                continue
            if n in self.sliced and n not in self.tpz:
                env[n] = gathered(v, zd, self.group)
                self.zpart.pop(n, None)
            else:
                self.zpart[n] = zd
        for n, v in kept.items():
            if n not in outs:
                env[n] = v
                self.zpart.pop(n, None)

    def _elementwise_ok(self, op, env) -> bool:
        """All planned inputs share one plan; every other tensor input is
        a scalar (a learning rate, a beta power)."""
        plans = set()
        for n in op.input_names():
            plan = self.plan_of(n)
            if plan is not None:
                plans.add(plan)
            else:
                v = env.get(n)
                if isinstance(v, torch.Tensor) and v.numel() > 1:
                    return False
        return len(plans) == 1

    def after_op(self, op, env, ctx=None):
        if not self.after_ad:
            gen = self.gens.pop(id(op), None)
            if ctx is not None:
                ctx.tp_in = ctx.sp_in = None
                if gen is not None:
                    ctx._gen = gen
            for ax in reversed(self.axes):
                ax.after(op, env)
            spec = self.spec.pop(id(op), None)
            if isinstance(spec, Whole):
                self._after_whole(op, env, spec)
                return
            undo = self.gathered.pop(id(op), None)
            if undo is not None:  # whole rows cut for the op
                outs = op.output_names()
                env.update((n, v) for n, v in undo[0].items()
                           if n not in outs)
            if spec is None or spec == GLOBAL:
                return
            for slot, outs in op.outputs.items():
                if spec == ROWS or slot not in spec:
                    self.batch.update(outs)
            return
        undo = self.gathered.pop(id(op), None)
        if undo is not None:  # the update's rows back to this rank's
            outs = op.output_names()
            for n, v in undo[0].items():
                if n not in outs:
                    env[n] = v
                    self.batch.add(n)
        if id(op) in self.pmode:
            self._parts_after(op, env)
        mode = self.mode.get(id(op))
        if isinstance(mode, tuple):  # ("tp", [(axis, dim or None)])
            ins = op.input_names()
            for ax, d in mode[1]:
                for n in op.output_names():
                    cut = dict((a.name, c) for a, c in
                               self.sliced.get(n, ())).get(ax.name)
                    if d is not None:
                        ax.lay[n] = d
                    elif cut is not None:
                        env[n] = ax.slice(env[n], cut)
                        ax.lay[n] = cut
                    elif n not in ins:
                        ax.lay.pop(n, None)
            return
        if mode == "shard" and op.type in _MATH:
            # an updated input keeps the layout before_op gave it; a new
            # value of elementwise math on a shard is a shard
            ins = op.input_names()
            plan = next(self.plan_of(n) for n in ins
                        if self.plan_of(n) is not None)
            for n in op.output_names():
                if n not in ins:
                    self.local[n] = plan
        elif mode == "whole":
            for n in op.output_names():
                plan = self.plan_of(n)
                if plan is not None and n not in self.local:
                    env[n] = self.shard(env[n], plan)
                    self.local[n] = plan

    def _spec(self, op, env):
        """How `op` treats its batch-sharded inputs: its ``dp`` declaration
        (``core/registry.py``) for this op's attrs, or None when no input
        is batch-sharded. An op that declares nothing, or whose callable
        returns None, takes ``Whole()``: it runs on the whole batch."""
        sharded = {}
        for slot, names in op.inputs.items():
            for n in names:
                if n in self.batch:
                    v = env.get(n)
                    sharded[slot] = v.ndim if isinstance(v, torch.Tensor) \
                        else 1
                    break
        if not sharded:
            return None
        decl = get_op(op.type).dp if has_op(op.type) else None
        spec = decl(op.attrs, sharded) if callable(decl) else decl
        return _WHOLE if spec is None else spec

    # -- rule A: an op across the batch dim -------------------------------
    def _gather_whole(self, op, env):
        """Gather the op's batch-sharded inputs whole over the data axis
        (one all-gather of their row counts, then one a dtype; the
        backward is a reduce-scatter, so each rank's cotangents stay its
        parts of the global ones). Inputs that an earlier such op made
        whole are whole already."""
        names = [n for n in dict.fromkeys(op.input_names())
                 if n in self.batch and isinstance(env.get(n), torch.Tensor)
                 and env[n].ndim]
        swaps = {n: env[n] for n in names}
        # while the op runs (a sub-block's ops too) its inputs are whole
        self.batch.difference_update(names)
        if self.size == 1 or not names:
            rows = int(env[names[0]].shape[0]) if names else 0
            self.gathered[id(op)] = (swaps, (0, rows, rows), names)
            return
        wholes, counts = gather_rows([env[n] for n in names], self.group)
        for n, w in zip(names, wholes):
            env[n] = w
        col = [c[0] for c in counts]
        span = (sum(col[:self.rank]), col[self.rank], sum(col))
        self.gathered[id(op)] = (swaps, span, names)

    def _after_whole(self, op, env, spec):
        """Rule A's end: the op's inputs back to this rank's rows; the
        outputs that `spec` names cut to this rank's rows (batch-sharded),
        the rest global, those with the whole batch's rows noted for
        ``_cut_whole_rows``."""
        undo = self.gathered.pop(id(op), None)
        if undo is None:
            return
        swaps, span, _ = undo
        outs = op.output_names()
        for n, v in swaps.items():
            if n not in outs:
                env[n] = v
                self.batch.add(n)
        start, mine, total = span
        for slot, names in op.outputs.items():
            for n in names:
                v = env.get(n)
                self.whole_rows.pop(n, None)
                if not isinstance(v, torch.Tensor) or not v.ndim \
                        or v.shape[0] != total:
                    continue
                if slot in spec.rows:
                    env[n] = v.narrow(0, start, mine)
                    self.batch.add(n)
                elif self.size > 1:
                    self.whole_rows[n] = span

    def _cut_whole_rows(self, op, env):
        """A row-by-row op that reads a batch-sharded value beside a
        global one with the whole batch's rows (a rule-A output): the
        global one is cut to this rank's rows for this op."""
        swaps = {}
        for n in dict.fromkeys(op.input_names()):
            span = self.whole_rows.get(n)
            v = env.get(n)
            if span is None or n in self.batch or \
                    not isinstance(v, torch.Tensor) or v.shape[0] != span[2]:
                continue
            swaps[n] = v
            env[n] = v.narrow(0, span[0], span[1])
        if swaps:
            self.gathered[id(op)] = (swaps, None, None)

    def gather_params(self, names, env, ctx):
        """Stage 3: at the first use of a sharded parameter among `names`,
        gather every sharded parameter whole for the rest of the step, one
        all-gather a dtype (an autodiff target becomes a fresh leaf). A
        collective costs the host ~0.5 ms on the card, so one a parameter
        would cost more than the step's kernels."""
        if not any(n in self.fsdp and n in self.local for n in names):
            return
        todo = [(n, env[n], self.local.pop(n)) for n in sorted(self.fsdp)
                if n in self.local and n in env]
        for n, full in self.gather_many(todo):
            if n in ctx.targets and full.is_floating_point():
                full = full.detach().requires_grad_()
            env[n] = full

    def seed_scale(self, loss_name: str) -> float:
        """A loss the same on every rank is seeded with 1/N: each rank's
        cotangents are then its parts of the global ones."""
        return 1.0 if loss_name in self.batch else 1.0 / self.size

    def reduce_grads(self, env, targets, ctx):
        """Sum the targets' gradients over the group (see the module
        docstring); stages 2 and 3, and the parameters a spec shards over
        the data axis, keep the planned ones as shards."""
        from .executor import grad_var_name
        from .selected_rows import SelectedRows

        self.after_ad = True
        planned: Dict[tuple, List[tuple]] = {}
        flat: Dict[torch.dtype, List[tuple]] = {}
        for t in dict.fromkeys(targets):
            if t in self.batch or self.foreign(t):
                continue  # a rank's own rows, or another stage's
            g = env.get(grad_var_name(t))
            if isinstance(g, SelectedRows):
                env[grad_var_name(t)] = self.selected_rows(t, g)
                continue
            for ax, d in self.sliced.get(t, ()):
                ax.lay[grad_var_name(t)] = d
            if (not isinstance(g, torch.Tensor) or not g.is_floating_point()
                    or self.group is None):
                continue
            plan = self.param_plan.get(t)
            if plan is None:
                flat.setdefault(g.dtype, []).append((grad_var_name(t), g, None))
                continue
            keep = self.stage >= 2 or t in self.dp_spec
            planned.setdefault((g.dtype, keep), []).append(
                (grad_var_name(t), g, plan))
        n = self.size
        for (dt, keep_shards), items in planned.items():
            rows = []
            for _, g, plan in items:
                axis, d, pd = plan
                x = g.movedim(axis, 0)
                if pd != d:
                    x = torch.cat([x, x.new_zeros((pd - d,)
                                                  + tuple(x.shape[1:]))])
                rows.append(x.reshape(n, -1))
            widths = [r.shape[1] for r in rows]
            buf = torch.cat(rows, dim=1).contiguous()
            out = buf.new_empty(buf.shape[1])
            reduce_scatter_into(out, buf.view(-1), self.group)
            if not keep_shards:
                whole = out.new_empty(n * out.shape[0])
                all_gather_into(whole, out, self.group)
                parts = whole.view(n, -1).split(widths, dim=1)
            else:
                parts = out.split(widths)
            for (name, g, plan), part in zip(items, parts):
                axis, d, pd = plan
                moved = g.movedim(axis, 0).shape
                if keep_shards:
                    local = part.reshape((pd // n,) + tuple(moved[1:]))
                    env[name] = local.movedim(0, axis)
                    self.local[name] = plan
                else:
                    full = part.reshape((pd,) + tuple(moved[1:]))[:d]
                    env[name] = full.movedim(0, axis).contiguous()
        for dt, items in flat.items():
            buf = torch.cat([g.reshape(-1) for _, g, _ in items])
            dist.all_reduce(buf, group=self.group)
            for (name, g, _), part in zip(
                    items, buf.split([g.numel() for _, g, _ in items])):
                env[name] = part.view(g.shape)

    def selected_rows(self, name, g):
        """A table's SelectedRows gradient made global (see the module
        docstring): on a vocab-sharded table the rows of this rank's range,
        offset to local slots; then every dp rank's rows laid end to end in
        rank order."""
        from .selected_rows import SelectedRows

        ids, rows = g.ids.reshape(-1), g.rows
        if self.tp_state.get(name) == 0:
            lo = self.tp_rank * g.height
            keep = (ids >= lo) & (ids < lo + g.height)
            ids, rows = ids[keep] - lo, rows[keep]
        if self.size == 1:
            return SelectedRows(ids, rows, g.height)
        count = torch.tensor([ids.shape[0]], dtype=torch.int64,
                             device=ids.device)
        counts = count.new_empty(self.size)
        all_gather_into(counts, count, self.group)
        counts = counts.cpu().tolist()
        most = max(counts)
        pad = most - ids.shape[0]
        if pad:
            ids = torch.cat([ids, ids.new_zeros(pad)])
            rows = torch.cat([rows, rows.new_zeros((pad,) + rows.shape[1:])])
        every_ids = ids.new_empty(self.size * most)
        all_gather_into(every_ids, ids.contiguous(), self.group)
        every_rows = rows.new_empty((self.size * most,) + rows.shape[1:])
        all_gather_into(every_rows, rows.contiguous(), self.group)
        take = torch.cat([torch.arange(r * most, r * most + c,
                                       device=ids.device)
                          for r, c in enumerate(counts)])
        return SelectedRows(every_ids[take], every_rows[take], g.height)

    def finish(self, env, scope, persistables, fetch_names):
        """env → scope and the global fetches. Returns (fetches, new
        state)."""
        new_state = {}
        gathers = []
        for n in persistables:
            if n not in env:
                continue
            if self.foreign(n):
                if not isinstance(scope.find_var(n), StageValue):
                    scope.set_var(n, StageValue(self, n, None))
                continue
            v = env[n]
            if isinstance(v, torch.Tensor):
                v = v.detach()
            plan = self.local.get(n)
            if n in self.sliced:
                for ax, d in self.sliced[n]:
                    if ax.lay.get(n) != d:
                        v = ax.slice(v, d)
                if n in self.tpz and n not in self.zpart:
                    v = v.chunk(self.size, self.tpz[n])[self.rank]
                new_state[n] = v
                self._store_sliced(scope, n, v.contiguous())
            elif plan is not None and n in self.stored:
                new_state[n] = v
                self._store_shard(scope, n, v, plan)
            elif plan is not None:
                gathers.append((n, v, self.local.pop(n)))
            else:
                new_state[n] = v
                scope.set_var(n, v)
        for n, v in self.gather_many(gathers):
            env[n] = new_state[n] = v
            scope.set_var(n, v)
        for n in self.owner:
            cur = scope.find_var(n)
            if n in new_state and not isinstance(cur, StageValue):
                scope.set_var(n, StageValue(self, n, cur))
        self.state_bytes = sum(v.numel() * v.element_size()
                               for v in new_state.values()
                               if isinstance(v, torch.Tensor))
        fetches = []
        for n in fetch_names:
            v = env[n]
            if n in self.zpart:  # the slice, then the whole
                v = gathered(v.detach(), self.zpart[n], self.group)
            for ax in self.axes:
                v = ax.whole(v, n)
            if n in self.local:
                v = self.gather(v.detach(), self.local[n])
            elif (n in self.batch and isinstance(v, torch.Tensor) and v.ndim
                  and self.group is not None):
                # each rank's rows (their counts may differ), in rank order
                v = gather_rows([v.detach()], self.group)[0][0]
            if n in self.owner:
                v = self._from_owner(n, v)
            fetches.append(v)
        return fetches, new_state

    def _from_owner(self, n, v):
        """A stage's value on every rank of the pipeline axis: broadcast
        from the rank that holds it."""
        s = self.owner[n]
        if s != self.pp_rank:
            var = self.program.global_block()._find_var_recursive(n)
            v = torch.empty(tuple(var.shape), dtype=_dtype_of(
                self.program, n), device=self.device)
        else:
            v = v.detach().contiguous().clone()
        dist.broadcast(v, dist.get_global_rank(self.pp_group, s),
                       group=self.pp_group)
        return v

    def record_state_bytes(self):
        """``memory/state_bytes_per_device``: the persistable bytes this
        rank holds after a step (what ZeRO shrinks)."""
        _STATE_BYTES.set(float(getattr(self, "state_bytes", 0)))


def mesh_key(compiled) -> Tuple:
    """What a MeshStep is built for: a new one when any of it changes."""
    return (id(compiled._mesh), compiled._data_axis,
            tuple(compiled._model_axes),
            compiled._pp_axis, compiled._seq_axis, compiled._zero_stage(),
            compiled._program._version)
