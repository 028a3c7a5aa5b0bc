"""Eager op dispatch — the dygraph analog of PreparedOp (the port's
counterpart of ``paddle_tpu.ops.eager``).

Reference analog: ``paddle/fluid/imperative/prepared_operator.h`` — run a
single op immediately through the same kernel library as the static graph,
with a per-op prepared entry so that repeated dispatches skip the setup.

The JAX package's entry is a ``jax.jit`` executable per (op, input
signature, attrs, is_test). PyTorch has nothing to compile: an op's
registered function runs on the tensors it is given. What the port prepares
once is the rest of the dispatch — the registered op, its attrs normalised
into a dict the op reads from, whether it is differentiable under those
attrs and its ``nondiff_inputs`` — keyed on (op, attrs, is_test). Ops in
`_NO_JIT` (host effects, sub-blocks, value-dependent shapes) and any op
with a non-scalar attr take the direct path, as in the JAX package, and so
does every op under ``PDTPU_EAGER_JIT=0``. Both paths run the same function
on the same context, so they compute the same values.

`call()` runs one op eagerly on tensors; the dygraph ``Tracer`` reads a
prepared entry through `resolve()` and runs the op under torch autograd.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch

from ..core import registry
from ..core.executor import ExecContext

_eager_seed = [0]
_eager_ctx: Dict[str, ExecContext] = {}   # device -> its eager context
_jit_cache: Dict[tuple, "Prepared"] = {}

# ops that must NOT take the prepared cache: host-side effects, program
# sub-blocks, or value-dependent python control flow inside the impl
_NO_JIT = frozenset({
    "print", "py_func", "save", "save_combine", "load", "load_combine",
    "while", "cond", "conditional_block", "conditional_block_infer",
    "switch", "recurrent", "static_rnn", "pipeline", "pipeline_hetero",
    "feed", "fetch", "read", "delete_var", "py_reader",
    # output shape depends on input VALUES
    "range", "linspace", "where_index", "unique", "unique_with_counts",
})


class Prepared:
    """One op's dispatch, resolved once: the registered function, the attrs
    it reads, whether it is differentiable under them and the input slots
    that never get a gradient."""

    __slots__ = ("opdef", "attrs", "differentiable", "nondiff_inputs")

    def __init__(self, op_type: str, attrs: Dict):
        self.opdef = registry.get_op(op_type)
        self.attrs = dict(attrs)
        self.differentiable = self.opdef.is_differentiable(self.attrs)
        self.nondiff_inputs = frozenset(self.opdef.nondiff_inputs)


def _ctx(device) -> ExecContext:
    key = str(device)
    ctx = _eager_ctx.get(key)
    if ctx is None:
        dev = torch.device(device)
        ctx = _eager_ctx[key] = ExecContext(
            dev, torch.Generator(dev).manual_seed(_eager_seed[0]))
    return ctx


def set_eager_seed(seed: int):
    """Seed the generators `call()` draws from (one a device, each made on
    its device at its first use, as the port's ExecContext makes one)."""
    _eager_seed[0] = int(seed)
    _eager_ctx.clear()


def _attrs_key(attrs: Dict):
    try:
        return tuple(sorted(
            (k, tuple(v) if isinstance(v, (list, tuple)) else v)
            for k, v in attrs.items()
            if isinstance(v, (int, float, bool, str))
            or (isinstance(v, (list, tuple))
                and all(isinstance(x, (int, float, bool, str)) for x in v))))
    except Exception:
        return None


def _prepare(op_type: str, attrs: Optional[Dict], is_test: bool):
    """The cached entry for this dispatch, or None when the op or its attrs
    must take the direct path (or ``PDTPU_EAGER_JIT=0``)."""
    attrs = attrs or {}
    if op_type in _NO_JIT or os.environ.get("PDTPU_EAGER_JIT") == "0":
        return None
    akey = _attrs_key(attrs)
    if akey is None or len(akey) != len(attrs):
        return None  # non-scalar attr (e.g. a sub-block) → direct path
    key = (op_type, akey, bool(is_test))
    entry = _jit_cache.get(key)
    if entry is None:
        entry = _jit_cache[key] = Prepared(op_type, attrs)
    return entry


def resolve(op_type: str, attrs: Optional[Dict], is_test: bool) -> Prepared:
    """The prepared entry: the cached one, or one made for this call alone
    on the direct path."""
    return (_prepare(op_type, attrs, is_test)
            or Prepared(op_type, attrs or {}))


def _device_of(inputs: Dict[str, List]):
    for vs in inputs.values():
        for v in vs:
            if isinstance(v, torch.Tensor):
                return v.device
    return torch.device("cpu")


def call(op_type: str, inputs: Dict[str, List], attrs: Optional[Dict] = None,
         is_test: bool = False) -> Dict[str, List]:
    """Run one op eagerly. inputs: slot -> list of tensors (on one device,
    whose eager generator the op draws from)."""
    prep = resolve(op_type, attrs, is_test)
    ctx = _ctx(_device_of(inputs))
    old = ctx.is_test
    ctx.is_test = is_test
    try:
        return prep.opdef.fn(ctx, inputs, prep.attrs)
    finally:
        ctx.is_test = old
