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
under ``torch.no_grad()``, and inputs in `nondiff_inputs` are detached. The
`grad_fn` hook is kept for the sparse-row gradients (not ported yet).

`dp` declares what the op does with a batch-sharded input on a
data-parallel mesh (``core/mesh_step.py``, where each rank holds its own
rows of dim 0):

- ``ROWS``: the op works row by row; every output is batch-sharded.
- ``GLOBAL``: the op reduces over the batch with a collective itself
  (``mesh_step.batch_group``); every output is the global value.
- a tuple of output slots: those are global, the rest batch-sharded.
- a callable ``(attrs, sharded) -> one of those or None``, where `sharded`
  maps each input slot that holds a batch-sharded value to that value's
  ndim: for an op whose answer depends on its axes.

An op that declares nothing, or whose callable returns None, works across
the batch dim; the mesh step refuses it rather than compute a rank's part
as if it were the whole.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

OpImpl = Callable[..., Dict[str, List[Any]]]

ROWS, GLOBAL = "rows", "global"


class OpDef:
    __slots__ = ("type", "fn", "differentiable", "nondiff_inputs",
                 "mutable_persistables", "grad_fn", "dp")

    def __init__(self, type: str, fn: OpImpl, differentiable: bool = True,
                 nondiff_inputs: Optional[List[str]] = None, grad_fn=None,
                 dp=None):
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


_REGISTRY: Dict[str, OpDef] = {}


def register_op(type: str, differentiable: bool = True, nondiff_inputs=None,
                grad_fn=None, dp=None):
    def deco(fn: OpImpl):
        if type in _REGISTRY:
            raise ValueError(f"op {type!r} registered twice")
        _REGISTRY[type] = OpDef(type, fn, differentiable, nondiff_inputs,
                                grad_fn, dp)
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
