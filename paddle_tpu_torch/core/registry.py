"""Op registry: op type -> PyTorch implementation + metadata.

Reference analog: ``paddle/fluid/framework/op_registry.h:199``
(REGISTER_OPERATOR / REGISTER_OP_CPU_KERNEL / REGISTER_OP_CUDA_KERNEL) and the
OpKernelType dispatch in operator.cc:970.

The same contract as ``paddle_tpu.core.registry``: an op has ONE
implementation, a function on torch tensors that runs on whatever device its
inputs live on. Ops that own a hand-written CUDA kernel pick it inside the
function (a CUDA tensor launches the kernel, a CPU tensor takes its plain
PyTorch version).

Implementation contract::

    @register_op("relu")                      # differentiable by default
    def relu(ctx, inputs, attrs):
        (x,) = inputs["X"]
        return {"Out": [torch.relu(x)]}

- `inputs`: dict slot -> list of torch tensors.
- `attrs`: static attr dict from the OpDesc.
- `ctx`:  ExecContext — device, seeded torch.Generator, is_test flag.
- returns dict slot -> list of values matching the op's output slots.

In training the executor reads the metadata: a non-differentiable op runs
under ``torch.no_grad()``, and inputs in `nondiff_inputs` are detached.
`differentiable` is a bool or a callable on the op's attrs (``while`` is
differentiable only with a trip bound): ``OpDef.is_differentiable(attrs)``
resolves it. The
`grad_fn` hook is kept for the sparse-row gradients (not ported yet).

`dp` declares what the op does with a batch-sharded input on a
data-parallel mesh (``core/mesh_step.py``, where each rank holds its own
rows of dim 0):

- ``ROWS``: the op works row by row; every output is batch-sharded.
- ``GLOBAL``: the op reduces over the batch with a collective itself
  (``mesh_step.batch_group``); every output is the global value.
- a tuple of output slots: those are global, the rest batch-sharded.
- a :class:`Whole`: the op works across the batch dim; its batch-sharded
  inputs are gathered whole over the data axis and it runs on the whole
  batch. The output slots it names keep the input's dim 0 row for row
  and are cut back to this rank's rows; the rest are global.
- a callable ``(attrs, sharded) -> one of those or None``, where `sharded`
  maps each input slot that holds a batch-sharded value to that value's
  ndim: for an op whose answer depends on its axes.

An op that declares nothing, or whose callable returns None, works across
the batch dim as far as the mesh step knows: it takes ``Whole()`` (every
output global), the rule GSPMD follows where it cannot keep a layout. A
global output whose dim 0 is the whole batch is cut to this rank's rows
where a row-by-row op reads it beside a batch-sharded value.

`tp` declares what the op does with values laid out on a model axis
(``tp``): each value is replicated (R: every rank holds it whole), sharded
(S(d): each rank holds its slice of dim d) or partial (P: each rank holds
a summand). A P input is summed first (Megatron's g); the declaration sees
the other inputs' layouts: ``tp(attrs, lay, shapes, n)`` with `lay` mapping
each input slot to a list of layouts (None for R, an int d for S(d)),
`shapes` to the local shapes and `n` the axis size, and returns a
:class:`TP` (the outputs' layouts, R inputs to slice, attribute overrides,
or "gather the input, slice the outputs"), or None. An op that declares
nothing, or whose callable returns None, gets every sharded input
gathered whole and runs on the whole value: always correct (GSPMD does
the same when it cannot keep a layout).

`sp` is the same declaration on a sequence axis (``with_mesh(seq_axis=)``:
the feeds' dim 1 sliced over it), with the same signature and the same
:class:`TP` answer; an op that declares nothing gets its sliced inputs
gathered whole. A declaration written for any dim (``same_layout``, the
elementwise rule) serves both axes.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

OpImpl = Callable[..., Dict[str, List[Any]]]

ROWS, GLOBAL = "rows", "global"

P = "P"  # a partial-sum layout on the model axis (see the docstring)


class Whole:
    """An op's answer on the data axis for a batch-sharded input that it
    reads across the batch dim: gather every batch-sharded input whole
    (the rows of every rank of the data axis, in rank order) and run on
    the whole batch; the output slots in `rows` keep the gathered dim 0
    row for row and are cut back to this rank's rows, the others are
    global (see the module docstring)."""

    __slots__ = ("rows",)

    def __init__(self, rows=()):
        self.rows = tuple(rows)


class TP:
    """An op's answer on the model axis (``core/mesh_step.py``):

    - `out`: output slot -> its layout (None = R, int d = S(d), ``P``), or
      a list with one a value; slots not named are R;
    - `slice_in`: input slot -> d: a replicated input this rank takes its
      slice of dim d from (its cotangent summed back, Megatron's f);
    - `attrs`: attribute overrides for this rank's call (a head count);
    - `regather`: input slot -> d: gather those inputs whole, run the op
      on the whole value and keep this rank's slice of dim d of every
      output (the fused qkv split);
    - `inner`: the op runs a sub-block whose ops see the slices through
      the mesh step's hooks and convert their own inputs (a pipeline's
      stages): its replicated inputs enter as they are (no f).
    """

    __slots__ = ("out", "slice_in", "attrs", "regather", "inner")

    def __init__(self, out=None, slice_in=None, attrs=None, regather=None,
                 inner=False):
        self.out = out or {}
        self.slice_in = slice_in or {}
        self.attrs = attrs
        self.regather = regather
        self.inner = inner


def same_layout(attrs, lay, shapes, n):
    """The tp declaration of an op that works element by element on its
    one input X: the output keeps X's layout."""
    (d,) = lay.get("X", [None])[:1] or [None]
    return TP(out={"Out": d})


class OpDef:
    __slots__ = ("type", "fn", "differentiable", "nondiff_inputs",
                 "mutable_persistables", "grad_fn", "dp", "tp", "sp")

    def __init__(self, type: str, fn: OpImpl, differentiable: bool = True,
                 nondiff_inputs: Optional[List[str]] = None, grad_fn=None,
                 dp=None, tp=None, sp=None):
        self.type = type
        self.fn = fn
        self.differentiable = differentiable
        # input slots that never receive gradients (e.g. integer indices)
        self.nondiff_inputs = set(nondiff_inputs or [])
        # hand-written gradient (GradOpMaker analog) for ops whose cotangent
        # is not a dense array — e.g. lookup_table's SelectedRows rows.
        # Signature: grad_fn(ctx, inputs, attrs, outputs, out_cots) ->
        # {slot: [cotangent or None, ...]}.
        self.grad_fn = grad_fn
        self.dp = dp  # the op on a data-parallel mesh (module docstring)
        self.tp = tp  # the op on a model axis (module docstring)
        self.sp = sp  # the op on a sequence axis (module docstring)

    def is_differentiable(self, attrs) -> bool:
        """`differentiable` under these attrs (a callable decides per op)."""
        diff = self.differentiable
        return bool(diff(attrs) if callable(diff) else diff)


_REGISTRY: Dict[str, OpDef] = {}


def register_op(type: str, differentiable: bool = True, nondiff_inputs=None,
                grad_fn=None, dp=None, tp=None, sp=None):
    def deco(fn: OpImpl):
        if type in _REGISTRY:
            raise ValueError(f"op {type!r} registered twice")
        _REGISTRY[type] = OpDef(type, fn, differentiable, nondiff_inputs,
                                grad_fn, dp, tp, sp)
        return fn

    return deco


def get_op(type: str) -> OpDef:
    if type not in _REGISTRY:
        raise KeyError(
            f"op {type!r} has no registered implementation in the port "
            f"({len(_REGISTRY)} ops registered)")
    return _REGISTRY[type]


def has_op(type: str) -> bool:
    return type in _REGISTRY


def registered_ops() -> List[str]:
    return sorted(_REGISTRY)
