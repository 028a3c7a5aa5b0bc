"""The executor's step on a mesh: a data-parallel axis with ZeRO stages 0–3,
and a model axis (tensor parallelism).

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
  on every rank. Any other op with a batch-sharded input (one that
  declares nothing, or a concat, split, slice, transpose, softmax, gather
  or contraction along dim 0) raises.
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

**The model axis** (``tp``; any mesh dim of size > 1 that is not the data
axis, ``compiled._model_axis``). A rank's dp group is its row of the mesh
and its tp group its column (``DeviceMesh.get_group``). Each value has a
layout on the model axis as well: replicated (R, the default), S(d) (each
rank holds its slice of dim d) or P (each rank holds a summand;
``registry.P``), kept in ``lay``:

- **Parameters with a ``shard_spec``** naming the axis, and the optimizer
  state of the same shape that their update ops read, live as this rank's
  slice: a whole value in the scope (a startup, a restore) is sliced at
  load, and the step stores a ``DTensor`` with a ``Shard(d)`` placement on
  the model dim. ZeRO does not touch them (the JAX package's
  ``_fsdp_param`` and ``shard_grad`` skip them too); their gradients are
  summed over the data axis only. A spec naming an axis the mesh lacks, or
  a dim its axis does not divide, raises ValueError, as the JAX package's
  placement does.
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
- **SelectedRows gradients** (``is_sparse`` lookups): on a vocab-sharded
  table each rank keeps the rows of its range, offset to local slots;
  then each rank's ids and rows are all-gathered over the data axis (the
  row counts first: they differ) and laid end to end in rank order, so
  the update's stable merge sums duplicates in one order on every rank.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..observability.registry import get_registry
from ..parallel.collective import (all_gather_into, copy_to, gather_along,
                                   gathered, reduce_from, reduce_scatter_into,
                                   summed)
from .dtypes import to_device
from .registry import GLOBAL, P, ROWS, get_op, has_op

__all__ = ["MeshStep", "batch_group", "is_dtensor", "logical_value",
           "tp_shard", "sp_shard", "TPShard", "StageValue"]

_RNG_RANK = "@RNG_RANK@"

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


def _spec_dim(spec, axis):
    """The dim of a shard_spec that names `axis`, or None."""
    for i, s in enumerate(spec or ()):
        if s == axis:
            return i
    return None


class _Axis:
    """The layouts of values on one axis of the mesh, the model axis
    (``kind`` "tp") or the sequence axis ("sp"): R (absent from ``lay``),
    S(d) (an int) or P. ``before``/``after`` apply the running op's
    declaration (its ``tp``/``sp`` attribute in ``core/registry.py``; see
    the module docstring) and hand the op its inputs' slices in
    ``ctx.tp_in``/``ctx.sp_in``."""

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

    def _set_in(self, ctx, val):
        setattr(ctx, self.kind + "_in", val)

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

    def before(self, op, env, ctx):
        """Apply the op's declaration: the conversions of its inputs go
        into the env for this op only."""
        self._set_in(ctx, None)
        if not any(n in self.lay for n in op.input_names()):
            return
        lay = self._layouts(op, env)
        if not any(d is not None for row in lay.values() for d in row):
            return
        decl = getattr(get_op(op.type), self.kind) if has_op(op.type) \
            else None
        shapes = {slot: [tuple(env[n].shape)
                         if isinstance(env.get(n), torch.Tensor) else ()
                         for n in names] for slot, names in op.inputs.items()}
        rule = decl(op.attrs, lay, shapes, self.size) \
            if callable(decl) else None
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
            return
        sharded_out = any(v is not None for v in _flat(rule.out.values()))
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
        self._set_in(ctx, {slot: [None if d is None else
                                  TPShard(d, self.rank, self.size,
                                          self.group) for d in row]
                           for slot, row in lay.items()})
        attrs = None
        if rule.attrs:
            attrs = op.attrs
            op.attrs = {**op.attrs, **rule.attrs}
        self._undo[id(op)] = (swaps, attrs, rule)

    def after(self, op, env, ctx):
        """Restore what `before` swapped and record the outputs'
        layouts."""
        self._set_in(ctx, None)
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

    def restore(self, op, env, ctx):
        undo = self._undo.pop(id(op), None)
        self._set_in(ctx, None)
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
        self.tp_axis = compiled._model_axis
        self.tpx = (_Axis("tp", self.tp_axis,
                          self.mesh.get_group(self.tp_axis))
                    if self.tp_axis is not None else None)
        self.tp_group = self.tpx.group if self.tpx is not None else None
        self.tp_size = self.tpx.size if self.tpx is not None else 1
        self.tp_rank = self.tpx.rank if self.tpx is not None else 0
        self.sp_axis = compiled._seq_axis
        self.spx = (_Axis("sp", self.sp_axis,
                          self.mesh.get_group(self.sp_axis))
                    if self.sp_axis is not None else None)
        self.axes = [ax for ax in (self.tpx, self.spx) if ax is not None]
        self.pp_axis = compiled._pp_axis
        self.pp_group = (self.mesh.get_group(self.pp_axis)
                         if self.pp_axis is not None else None)
        self.pp_size = (dist.get_world_size(self.pp_group)
                        if self.pp_group is not None else 1)
        self.pp_rank = (dist.get_rank(self.pp_group)
                        if self.pp_group is not None else 0)
        self.tp_state = self._tp_state()  # name -> sliced dim
        self.owner = self._stage_owner()  # name -> its pp coordinate
        compiled._zero_pad_map()  # records program._zero_padded
        self.stored: Dict[str, _Plan] = {}   # sharded between steps
        self.param_plan: Dict[str, _Plan] = {}  # update / reduction layout
        for v in self.program.list_vars():
            if not v.persistable or v.name in self.tp_state:
                continue
            plan = compiled._zero_plan(v)
            if plan is not None:
                self.stored[v.name] = self._plan(v.shape, plan[0])
            if compiled._fsdp_param(v):
                axis = _zero_axis(v.shape, self.size)
                if axis is not None:
                    self.param_plan[v.name] = self._plan(v.shape, axis)
        self.fsdp = ({n for n in self.stored if n in self.param_plan}
                     if self.stage >= ShardingStrategy.stage3 else set())
        self._held: Dict[str, tuple] = {}   # name -> (DTensor, its local)
        self.begin()

    def _plan(self, shape, axis) -> _Plan:
        d = int(shape[axis])
        return _Plan(axis, d, -(-d // self.size) * self.size)

    def _tp_state(self) -> Dict[str, int]:
        """{name: dim} of the persistables this rank holds a slice of: the
        parameters whose shard_spec names the model axis, and the inputs of
        their update ops with the parameter's shape (optimizer state,
        gradient buffers). Raises ValueError for a spec that names an axis
        the mesh lacks or a dim its axis does not divide (the JAX package's
        placement raises the same)."""
        names = tuple(self.mesh.mesh_dim_names)
        sizes = dict(zip(names, self.mesh.shape))
        out: Dict[str, int] = {}
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
                if sizes[a] > 1 and a != self.tp_axis:
                    raise NotImplementedError(
                        f"parameter {v.name!r} is sharded over the {a!r} "
                        f"axis; the port shards parameters over the model "
                        f"axis only (ROADMAP A9b3)")
            d = _spec_dim(spec, self.tp_axis)
            if d is not None and self.tp_size > 1:
                out[v.name] = d
                shapes[v.name] = tuple(v.shape)
        if not out:
            return out
        block = self.program.global_block()
        for op in block.ops:
            ps = op.inputs.get("Param") or []
            if len(ps) != 1 or ps[0] not in out:
                continue
            for slot, ns in op.inputs.items():
                for n in ns:
                    var = block._find_var_recursive(n)
                    if (slot not in ("Param", "Grad") and var is not None
                            and var.persistable
                            and tuple(var.shape) == shapes[ps[0]]):
                        out[n] = out[ps[0]]
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
        """The model-axis layouts of `src` names given to `dst` names (a
        pipeline's template sub-block runs this rank's stage parameters
        under stage 0's names)."""
        if self.tpx is None:
            return
        for d, s_ in zip(dst, src):
            if s_ in self.lay:
                self.lay[d] = self.lay[s_]
            else:
                self.lay.pop(d, None)

    # -- per-step state ----------------------------------------------------
    def begin(self):
        self.batch = set()
        self.local: Dict[str, _Plan] = {}   # env names holding a shard
        self.after_ad = False
        self.mode: Dict[int, str] = {}      # update op -> "shard" | "whole"
        self.spec: Dict[int, object] = {}   # op -> its dp declaration
        for ax in self.axes:
            ax.begin()
        # model-axis layouts (d or P) by name
        self.lay: Dict[str, object] = self.tpx.lay if self.tpx else {}
        self.skipped: Dict[str, int] = {}   # outputs of skipped updates

    def plan_of(self, name: str) -> Optional[_Plan]:
        """The layout a value of `name` is sliced by in the update section:
        its own when it is stored sharded, its parameter's for a parameter
        or its gradient (stages 1–3), else None."""
        if name in self.local:
            return self.local[name]
        if name in self.stored:
            return self.stored[name]
        if self.stage >= 1:
            if name in self.param_plan:
                return self.param_plan[name]
            if name.endswith("@GRAD") and name[:-5] in self.param_plan:
                return self.param_plan[name[:-5]]
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

    def _store_tp(self, scope, name, local):
        """`_store_shard` for a slice on the model axis."""
        held = self._held.get(name)
        if (held is not None and _unwrap(scope.find_var(name)) is held[0]
                and held[1].shape == local.shape
                and held[1].dtype == local.dtype):
            if held[1].data_ptr() != local.data_ptr():
                held[1].copy_(local)
            return
        dt = self.tp_dtensor(local, self.tp_state[name])
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

    # -- the model axis ----------------------------------------------------
    def tp_slice(self, full: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice of dim `dim` of a whole value (a view)."""
        c = full.shape[dim] // self.tp_size
        return full.narrow(dim, self.tp_rank * c, c)

    def tp_dtensor(self, local: torch.Tensor, dim: int):
        from torch.distributed.tensor import DTensor, Replicate, Shard

        place = [Replicate()] * self.mesh.ndim
        place[list(self.mesh.mesh_dim_names).index(self.tp_axis)] = \
            Shard(dim)
        shape = list(local.shape)
        shape[dim] *= self.tp_size
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(local, self.mesh, place, run_check=False,
                                  shape=torch.Size(shape), stride=stride)

    def restore(self, op, env, ctx):
        """Undo an op's input swaps and attribute overrides after it
        raised (the program's attributes must not keep this rank's)."""
        for ax in self.axes:
            ax.restore(op, env, ctx)

    def _tp_update(self, op, env) -> bool:
        """An update-section op that reads a slice: the optimizer ops and
        elementwise math run on the slices as they are; any other op gets
        the slices gathered whole, and its outputs that are sliced state
        are cut back (``_tp_update_after``)."""
        names = op.input_names()
        dims = {self.lay[n] for n in names if n in self.lay}
        if not dims:
            return False
        if op.type in _ROW_UPDATES:
            self.mode[id(op)] = ("tp", dims.pop())
            return True
        if op.type in _ELEMENTWISE and len(dims) == 1:
            ok = all(n in self.lay or not isinstance(env.get(n), torch.Tensor)
                     or env[n].numel() <= 1 for n in names)
            if ok:
                self.mode[id(op)] = ("tp", dims.pop())
                return True
        for n in names:
            if n in self.lay:
                env[n] = gathered(env[n], self.lay.pop(n), self.tp_group)
        self.mode[id(op)] = ("tp", None)
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
            if n in self.tp_state:
                d = self.tp_state[n]
                self.lay[n] = d
                held = self._held.get(n)
                if held is not None and v is held[0]:
                    env[n] = held[1]
                elif (is_dtensor(v) and v.to_local().shape[d] * self.tp_size
                      == v.shape[d] and any(
                          p.is_shard(d) for p in v.placements)):
                    env[n] = to_device(v.to_local(), self.device)
                else:
                    full = to_device(logical_value(self.program, n, v),
                                     self.device)
                    env[n] = self.tp_slice(full, d).contiguous()
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
        (rank 0 keeps its stream). The base seed is rank 0's, broadcast."""
        from .executor import _RNG_STATE

        if scope.find_var(_RNG_RANK) == (self.rank, self.size, id(gen)):
            return gen
        if self.group is not None:
            seed = torch.tensor([int(self.program.random_seed or 0)],
                                dtype=torch.int64, device=self.device)
            dist.broadcast(seed, dist.get_global_rank(self.group, 0),
                           group=self.group)
            if self.rank:
                folded = (int(seed.item()) * 0x9E3779B1
                          + self.rank * 0x7F4A7C15) % (2 ** 63)
                gen = torch.Generator(self.device).manual_seed(folded)
                scope.set_var(_RNG_STATE, gen)
        scope.set_var(_RNG_RANK, (self.rank, self.size, id(gen)))
        return gen

    def skip(self, op) -> bool:
        """Whether this rank leaves out an update-section op: one that
        reads or writes another pipeline stage's values (its parameters,
        their gradients and optimizer state, or what a left-out op wrote).
        An op that mixes two stages' values raises: no rank holds both."""
        if not self.owner or not self.after_ad:
            return False
        owners = set()
        for n in op.input_names() + op.output_names():
            s = self.skipped.get(n, self.owner.get(n))
            if s is None and n.endswith("@GRAD"):
                s = self.owner.get(n[:-5])
            if s is not None:
                owners.add(s)
        if len(owners) > 1:
            raise NotImplementedError(
                f"update op {op.type!r} reads the values of pipeline stages "
                f"{sorted(owners)}; each stage's rank holds only its own "
                f"(an update across stages, such as a global-norm clip, is "
                f"ROADMAP A9b3)")
        if owners and owners != {self.pp_rank}:
            (s,) = owners
            for n in op.output_names():
                self.skipped[n] = s
            return True
        return False

    def before_op(self, op, env, ctx):
        ctx.in_names = op.inputs
        if not self.after_ad:
            if self.fsdp:
                self.gather_params(op.input_names(), env, ctx)
            spec = self._spec(op, env)
            if spec is not None:
                self.spec[id(op)] = spec
            for ax in self.axes:
                ax.before(op, env, ctx)
            return
        if self.lay and self._tp_update(op, env):
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
            for ax in self.axes:
                ax.after(op, env, ctx)
            spec = self.spec.pop(id(op), None)
            if spec is None or spec == GLOBAL:
                return
            for slot, outs in op.outputs.items():
                if spec == ROWS or slot not in spec:
                    self.batch.update(outs)
            return
        mode = self.mode.get(id(op))
        if isinstance(mode, tuple):  # ("tp", dim or None)
            ins = op.input_names()
            for n in op.output_names():
                if mode[1] is not None:
                    self.lay[n] = mode[1]
                elif n in self.tp_state:
                    env[n] = self.tp_slice(env[n], self.tp_state[n])
                    self.lay[n] = self.tp_state[n]
                elif n not in ins:
                    self.lay.pop(n, None)
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
        is batch-sharded. An op that declares nothing raises: it would
        compute this rank's part of a value as if it were the whole."""
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
        if spec is None:
            name = next(n for ns in op.inputs.values() for n in ns
                        if n in self.batch)
            raise NotImplementedError(
                f"op {op.type!r} with these attributes is not known to work "
                f"row by row, and its input {name!r} is batch-sharded on the "
                f"data-parallel axis (each rank holds its own rows of dim "
                f"0); the port refuses it rather than compute one rank's "
                f"part as the whole (ROADMAP A9b3: ops across the batch "
                f"dim)")
        return spec

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
        docstring); stages 2 and 3 keep the planned ones as shards."""
        from .executor import grad_var_name
        from .selected_rows import SelectedRows

        self.after_ad = True
        planned: Dict[torch.dtype, List[tuple]] = {}
        flat: Dict[torch.dtype, List[tuple]] = {}
        for t in dict.fromkeys(targets):
            if t in self.batch or self.foreign(t):
                continue  # a rank's own rows, or another stage's
            g = env.get(grad_var_name(t))
            if isinstance(g, SelectedRows):
                env[grad_var_name(t)] = self.selected_rows(t, g)
                continue
            if t in self.tp_state:
                self.lay[grad_var_name(t)] = self.tp_state[t]
            if (not isinstance(g, torch.Tensor) or not g.is_floating_point()
                    or self.group is None):
                continue
            plan = self.param_plan.get(t)
            (planned if plan is not None else flat).setdefault(
                g.dtype, []).append((grad_var_name(t), g, plan))
        n = self.size
        keep_shards = self.stage >= 2
        for dt, items in planned.items():
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
            if n in self.tp_state:
                if self.lay.get(n) != self.tp_state[n]:
                    v = self.tp_slice(v, self.tp_state[n])
                new_state[n] = v
                self._store_tp(scope, n, v.contiguous())
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
            for ax in self.axes:
                v = ax.whole(v, n)
            if n in self.local:
                v = self.gather(v.detach(), self.local[n])
            elif (n in self.batch and isinstance(v, torch.Tensor) and v.ndim
                  and self.group is not None):
                v = v.detach().contiguous()
                out = v.new_empty((self.size * v.shape[0],)
                                  + tuple(v.shape[1:]))
                all_gather_into(out, v, self.group)
                v = out
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
    return (id(compiled._mesh), compiled._data_axis, compiled._model_axis,
            compiled._pp_axis, compiled._seq_axis, compiled._zero_stage(),
            compiled._program._version)
