"""Control-flow layers: the port's ``ConditionalBlock`` and the sub-block
capture analysis it needs, copied from ``paddle_tpu.layers.control_flow``
(reference ``python/paddle/fluid/layers/control_flow.py`` ConditionalBlock
over conditional_block_op.cc). While, Switch, IfElse, StaticRNN,
DynamicRNN, cond and the tensor arrays are not ported yet.
"""
from __future__ import annotations

from typing import List

from ..core.program import Block, Variable
from ..layer_helper import LayerHelper

__all__ = ["ConditionalBlock"]


# ---------------------------------------------------------------------------
# sub-block capture analysis
# ---------------------------------------------------------------------------

def _external_reads(block: Block, parent: Block) -> List[str]:
    """Names read by `block` ops before any local definition, resolvable in
    the parent scope (loop carries, params, captured activations)."""
    defined = set(block.vars.keys())
    reads: List[str] = []
    seen = set()
    for op in block.ops:
        for n in op.input_names():
            if n not in defined and n not in seen and parent.has_var(n):
                seen.add(n)
                reads.append(n)
        for n in op.output_names():
            defined.add(n)
    return reads


def _parent_writes(block: Block, parent: Block) -> List[str]:
    """Names written by `block` ops that live in the parent scope."""
    writes: List[str] = []
    seen = set()
    for op in block.ops:
        for n in op.output_names():
            if n not in block.vars and n not in seen and parent.has_var(n):
                seen.add(n)
                writes.append(n)
    return writes


class ConditionalBlock:
    """``with ConditionalBlock(cond):`` — body ops run only when `cond` is
    True; parent vars written inside keep their old value otherwise
    (reference layers/control_flow.py ConditionalBlock →
    conditional_block_op.cc)."""

    def __init__(self, cond: Variable, is_scalar_condition: bool = True,
                 name=None):
        self.helper = LayerHelper("conditional_block", name=name)
        self.cond_var = cond
        self._parent = None
        self._block = None

    def block(self):
        return self

    def __enter__(self):
        prog = self.helper.main_program
        self._parent = prog.current_block()
        self._block = prog.create_block()
        return self

    def __exit__(self, exc_type, exc, tb):
        prog = self.helper.main_program
        prog.rollback()
        if exc_type is not None:
            return False
        reads = _external_reads(self._block, self._parent)
        writes = _parent_writes(self._block, self._parent)
        carried = list(dict.fromkeys(reads + writes))
        self._parent.append_op(
            type="conditional_block",
            inputs={"Cond": [self.cond_var.name], "X": carried},
            outputs={"Out": carried},
            attrs={"sub_block": self._block, "var_names": carried})
        return False
