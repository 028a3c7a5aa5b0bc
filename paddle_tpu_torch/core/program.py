"""Program IR: define-then-run graph of operators over named variables.

Capability parity with the reference's ProgramDesc stack
(``paddle/fluid/framework/framework.proto:43-188`` — OpDesc/VarDesc/BlockDesc/
ProgramDesc; python surface ``python/paddle/fluid/framework.py`` — Program:2826,
Block:1483, Operator:1034, Variable:383, Parameter:3635).

The port keeps ``paddle_tpu.core.program`` as it is: a lightweight in-Python
graph whose ops name registered implementations. The Executor runs the block
op by op on torch tensors. Protobuf round-tripping is replaced by a simple
serializable dict form (`Program.to_dict`/`from_dict`) used by
save/load_inference_model, so a model directory the JAX package saved loads
here unchanged.
"""
from __future__ import annotations

import contextlib
import copy
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from . import unique_name
from .dtypes import convert_dtype, dtype_str


class Variable:
    """A named symbolic tensor in a Block.

    Mirrors reference ``framework.py:383`` Variable semantics: shape may use -1
    for the batch dim; `persistable` vars live in the Scope across steps;
    `stop_gradient` cuts autodiff.
    """

    def __init__(
        self,
        block: "Block",
        name: Optional[str] = None,
        shape: Optional[Sequence[int]] = None,
        dtype: Any = "float32",
        persistable: bool = False,
        stop_gradient: bool = False,
        trainable: bool = False,
        is_data: bool = False,
        lod_level: int = 0,
    ):
        self.block = block
        self.name = name if name is not None else unique_name.generate("_generated_var")
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = convert_dtype(dtype)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.trainable = trainable
        self.is_data = is_data
        # lod_level kept for API parity with LoDTensor-style variable-length
        # data (reference lod_tensor.h:104). In the TPU build, ragged data is
        # carried as (padded values + explicit mask/length vars) instead.
        self.lod_level = lod_level
        self.op: Optional[Operator] = None  # producer op (last writer)

    # -- paddle-like sugar -------------------------------------------------
    @property
    def grad_name(self) -> str:
        return grad_var_name(self.name)

    def astype(self, dtype):
        from ..layers import tensor as tensor_layers

        return tensor_layers.cast(self, dtype)

    def __repr__(self):
        return f"Variable(name={self.name}, shape={self.shape}, dtype={dtype_str(self.dtype)})"

    __str__ = __repr__

    def to_dict(self):
        return {
            "name": self.name,
            "shape": list(self.shape) if self.shape is not None else None,
            "dtype": dtype_str(self.dtype),
            "persistable": self.persistable,
            "stop_gradient": self.stop_gradient,
            "trainable": self.trainable,
            "is_data": self.is_data,
            "lod_level": self.lod_level,
        }


class Parameter(Variable):
    """Trainable persistable variable (reference framework.py:3635)."""

    def __init__(self, block, name=None, shape=None, dtype="float32", **kw):
        self.initializer = kw.pop("initializer", None)
        self.regularizer = kw.pop("regularizer", None)
        self.need_clip = kw.pop("need_clip", True)
        self.is_distributed = kw.pop("is_distributed", False)
        # TPU-native extension: optional PartitionSpec-like sharding annotation
        # consumed by CompiledProgram / pjit lowering (no reference analog —
        # replaces per-op `device` attrs + pserver param slicing).
        self.shard_spec = kw.pop("shard_spec", None)
        super().__init__(
            block, name=name, shape=shape, dtype=dtype,
            persistable=True, stop_gradient=False, trainable=kw.pop("trainable", True),
        )


class Operator:
    """One op node: type + named input/output slots + attrs.

    Mirrors reference ``framework.py:1034`` Operator / OpDesc
    (framework.proto:43). Inputs/outputs map slot name -> list of var names.
    """

    def __init__(
        self,
        block: "Block",
        type: str,
        inputs: Optional[Dict[str, List[str]]] = None,
        outputs: Optional[Dict[str, List[str]]] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ):
        self.block = block
        self.type = type
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})

    def input_names(self) -> List[str]:
        return [n for vs in self.inputs.values() for n in vs]

    def output_names(self) -> List[str]:
        return [n for vs in self.outputs.values() for n in vs]

    def input(self, slot: str) -> List[str]:
        return self.inputs.get(slot, [])

    def output(self, slot: str) -> List[str]:
        return self.outputs.get(slot, [])

    def attr(self, name: str, default=None):
        return self.attrs.get(name, default)

    def __repr__(self):
        return f"Op({self.type}: {self.inputs} -> {self.outputs})"

    def to_dict(self):
        attrs = {}
        for k, v in self.attrs.items():
            if isinstance(v, np.ndarray):
                attrs[k] = {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
            elif isinstance(v, Block):
                attrs[k] = {"__block__": v.idx}
            else:
                attrs[k] = v
        return {"type": self.type, "inputs": self.inputs, "outputs": self.outputs, "attrs": attrs}


class Block:
    """Ordered op list + var table (reference framework.py:1483, BlockDesc)."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    @property
    def parent_block(self) -> Optional["Block"]:
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    # -- var management ----------------------------------------------------
    def create_var(self, **kw) -> Variable:
        name = kw.get("name")
        if name is not None and name in self.vars:
            return self.vars[name]
        v = Variable(self, **kw)
        self.vars[v.name] = v
        self.program._bump_version()
        return v

    def create_parameter(self, **kw) -> Parameter:
        p = Parameter(self, **kw)
        # parameters always live in the global block (reference behavior)
        gb = self.program.global_block()
        gb.vars[p.name] = p
        p.block = gb
        self.program._bump_version()
        return p

    def var(self, name: str) -> Variable:
        v = self._find_var_recursive(name)
        if v is None:
            raise KeyError(f"Variable {name!r} not found in block {self.idx}")
        return v

    def has_var(self, name: str) -> bool:
        return self._find_var_recursive(name) is not None

    def _find_var_recursive(self, name: str) -> Optional[Variable]:
        b: Optional[Block] = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent_block
        return None

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    # -- op management -----------------------------------------------------
    def append_op(self, type: str, inputs=None, outputs=None, attrs=None) -> Operator:
        def _norm(d):
            out = {}
            for k, v in (d or {}).items():
                if v is None:
                    continue
                if isinstance(v, (Variable,)):
                    out[k] = [v.name]
                elif isinstance(v, str):
                    out[k] = [v]
                else:
                    out[k] = [x.name if isinstance(x, Variable) else x for x in v]
            return out

        op = Operator(self, type, _norm(inputs), _norm(outputs), attrs)
        if _REMAT_UNIT_STACK and REMAT_UNIT_ATTR not in op.attrs:
            op.attrs[REMAT_UNIT_ATTR] = _REMAT_UNIT_STACK[-1]
        self.ops.append(op)
        for name in op.output_names():
            if name in self.vars:
                self.vars[name].op = op
        self.program._bump_version()
        return op

    def prepend_op(self, type: str, inputs=None, outputs=None, attrs=None) -> Operator:
        op = self.append_op(type, inputs, outputs, attrs)
        self.ops.pop()
        self.ops.insert(0, op)
        return op

    def to_dict(self):
        return {
            "idx": self.idx,
            "parent_idx": self.parent_idx,
            "vars": [v.to_dict() for v in self.vars.values()],
            "ops": [op.to_dict() for op in self.ops],
        }


class Program:
    """A whole computation: list of blocks (reference framework.py:2826).

    `_version` increments on any mutation (passes bump it when they edit the
    op list).
    """

    def __init__(self):
        self.blocks: List[Block] = [Block(self, 0)]
        self.current_block_idx = 0
        self._version = 0
        self._seed = 0
        self.random_seed = 0
        # op_role bookkeeping kept minimal: backward insertion point markers
        self._appended_backward = False

    def _bump_version(self):
        self._version += 1

    def global_block(self) -> Block:
        return self.blocks[0]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def create_block(self) -> Block:
        b = Block(self, len(self.blocks), parent_idx=self.current_block_idx)
        self.blocks.append(b)
        self.current_block_idx = b.idx
        self._bump_version()
        return b

    def rollback(self):
        self.current_block_idx = self.current_block().parent_idx

    def all_parameters(self) -> List[Parameter]:
        return self.global_block().all_parameters()

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    def clone(self, for_test: bool = False) -> "Program":
        """Deep-copy the program. With for_test=True, ops flagged by
        `is_test`-sensitive kernels (dropout, batch_norm) flip to inference
        behavior (reference Program.clone framework.py:~3000)."""
        p = copy.deepcopy(self)
        if for_test:
            for b in p.blocks:
                for op in b.ops:
                    if "is_test" in op.attrs or op.type in ("dropout", "batch_norm"):
                        op.attrs["is_test"] = True
        p._bump_version()
        return p

    def _prune_for_inference(self, feed_names: Sequence[str], fetch_names: Sequence[str]) -> "Program":
        """Keep only ops needed to compute fetches from feeds (reference
        Program._prune). Used by save_inference_model (io.py:933)."""
        p = self.clone(for_test=True)
        blk = p.global_block()
        needed = set(fetch_names)
        kept: List[Operator] = []
        for op in reversed(blk.ops):
            if op.type in ("fetch", "feed"):
                continue
            if set(op.output_names()) & needed:
                kept.append(op)
                needed |= {n for n in op.input_names()}
        blk.ops = list(reversed(kept))
        live = set()
        for op in blk.ops:
            live |= set(op.input_names()) | set(op.output_names())
        live |= set(feed_names) | set(fetch_names)
        blk.vars = {k: v for k, v in blk.vars.items() if k in live}
        p._bump_version()
        return p

    def to_dict(self):
        return {"blocks": [b.to_dict() for b in self.blocks], "random_seed": self.random_seed}

    @staticmethod
    def from_dict(d) -> "Program":
        p = Program()
        p.random_seed = d.get("random_seed", 0)
        # first block exists; create the rest
        for bd in d["blocks"][1:]:
            nb = Block(p, bd["idx"], bd["parent_idx"])
            p.blocks.append(nb)
        for bd in d["blocks"]:
            blk = p.blocks[bd["idx"]]
            for vd in bd["vars"]:
                blk.create_var(
                    name=vd["name"], shape=vd["shape"], dtype=vd["dtype"],
                    persistable=vd["persistable"], stop_gradient=vd["stop_gradient"],
                    is_data=vd.get("is_data", False), lod_level=vd.get("lod_level", 0),
                )
                if vd.get("trainable"):
                    v = blk.vars[vd["name"]]
                    v.trainable = True
            for od in bd["ops"]:
                attrs = {}
                for k, v in od["attrs"].items():
                    if isinstance(v, dict) and "__ndarray__" in v:
                        attrs[k] = np.array(v["__ndarray__"], dtype=v["dtype"])
                    elif isinstance(v, dict) and "__block__" in v:
                        attrs[k] = p.blocks[v["__block__"]]
                    else:
                        attrs[k] = v
                blk.append_op(od["type"], od["inputs"], od["outputs"], attrs)
        return p


# ---------------------------------------------------------------------------
# default programs + guards (reference framework.py default_main_program etc.)
# ---------------------------------------------------------------------------

_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


@contextlib.contextmanager
def program_guard(main_program: Program, startup_program: Optional[Program] = None):
    global _main_program, _startup_program
    old_main, old_startup = _main_program, _startup_program
    _main_program = main_program
    if startup_program is not None:
        _startup_program = startup_program
    try:
        yield
    finally:
        _main_program = old_main
        _startup_program = old_startup


def grad_var_name(name: str) -> str:
    """Reference framework: grad var suffix '@GRAD'."""
    return name + "@GRAD"


# ---------------------------------------------------------------------------
# Remat units: model-block boundaries. Ops appended inside `remat_unit(name)`
# are tagged with `__remat_unit__ = name`, exactly as in the JAX package, so
# both DSLs emit the same attrs. In the port the tag is only a tag so far;
# turning a unit into one torch.utils.checkpoint region is queued (ROADMAP).
_REMAT_UNIT_STACK: List[str] = []

REMAT_UNIT_ATTR = "__remat_unit__"


@contextlib.contextmanager
def remat_unit(name: str):
    """Tag every op appended in this scope as part of remat block `name`."""
    _REMAT_UNIT_STACK.append(str(name))
    try:
        yield
    finally:
        _REMAT_UNIT_STACK.pop()


def current_remat_unit() -> Optional[str]:
    return _REMAT_UNIT_STACK[-1] if _REMAT_UNIT_STACK else None


# ---------------------------------------------------------------------------
# Dygraph mode: ``dygraph.guard`` installs its tracer here, as in the JAX
# package; ``Optimizer.minimize`` takes its dygraph path while one is set.
_dygraph_tracer = None


def in_dygraph_mode() -> bool:
    return _dygraph_tracer is not None


def _set_dygraph_tracer(tracer):
    global _dygraph_tracer
    _dygraph_tracer = tracer


def _current_tracer():
    return _dygraph_tracer
