"""Control-flow layers: While, ConditionalBlock, Switch, cond, IfElse,
StaticRNN, DynamicRNN and the tensor arrays (counterpart of
``paddle_tpu.layers.control_flow``; reference
``python/paddle/fluid/layers/control_flow.py`` over while_op.cc,
conditional_block_op.cc, recurrent_op.cc and the array ops).

The builders are the JAX package's: each records one block-attribute op
(``while``, ``conditional_block``, ``switch``, ``cond``, ``static_rnn``)
whose carried values are what its sub-block reads from and writes to the
parent (``_external_reads``/``_parent_writes``); ``ops/control_flow_ops.py``
says how the port runs them. Sequences are padded ``[B, T, ...]`` with a
length: DynamicRNN masks its memory updates and outputs by length, so a
row's final memory is its value at the row's last valid step. IfElse
computes both branches on the whole batch and merges rows with a
``select``. Tensor arrays are preallocated ``[max_len, ...]`` buffers with
an int64 length.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from ..core.program import Block, Variable
from ..layer_helper import LayerHelper
from . import tensor as tensor_layers

__all__ = [
    "While", "ConditionalBlock", "Switch", "cond", "IfElse", "StaticRNN",
    "DynamicRNN", "create_array", "array_write", "array_read",
    "array_length", "increment", "max_sequence_len",
]

increment = tensor_layers.increment


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


# ---------------------------------------------------------------------------
# While
# ---------------------------------------------------------------------------

class While:
    """``with While(cond) as w:`` — body ops run until `cond` is False.

    `cond` must be a boolean scalar Variable recomputed inside the body
    (reference layers/control_flow.py While). All parent vars read or written
    in the body are carried from iteration to iteration; their shapes must
    be loop-invariant.
    """

    def __init__(self, cond: Variable, is_test: bool = False, name=None,
                 max_iters: Optional[int] = None):
        """`max_iters` (an extension of the JAX package): a static trip
        bound. When given, the body runs that many times with masked
        updates and no host read, and the loop is differentiable
        (the reference's WhileGradOp capability)."""
        self.helper = LayerHelper("while", name=name)
        self.cond_var = cond
        self.max_iters = max_iters
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
        if self.cond_var.name not in carried:
            carried.append(self.cond_var.name)
        attrs = {"sub_block": self._block,
                 "loop_vars": carried,
                 "cond_name": self.cond_var.name}
        if self.max_iters is not None:
            attrs["max_iters"] = int(self.max_iters)
        self._parent.append_op(
            type="while",
            inputs={"X": carried},
            outputs={"Out": carried},
            attrs=attrs)
        return False


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


# ---------------------------------------------------------------------------
# Switch
# ---------------------------------------------------------------------------

class _SwitchCase:
    def __init__(self, switch: "Switch", cond: Optional[Variable]):
        self.switch = switch
        self.cond = cond

    def __enter__(self):
        prog = self.switch.helper.main_program
        self._block = prog.create_block()
        return self

    def __exit__(self, exc_type, exc, tb):
        prog = self.switch.helper.main_program
        prog.rollback()
        if exc_type is not None:
            return False
        if self.cond is None:
            self.switch._default = self._block
        else:
            self.switch._cases.append((self.cond, self._block))
        return False


class Switch:
    """First-matching-case switch (reference layers/control_flow.py:~1460).

    ``with Switch() as sw: with sw.case(c): ...assign...`` — case bodies
    write parent vars (typically via `layers.assign`); on exit one `switch`
    op is emitted selecting the first true case (else default).
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self._cases = []
        self._default = None
        self._parent = None

    def case(self, condition: Variable):
        return _SwitchCase(self, condition)

    def default(self):
        return _SwitchCase(self, None)

    def __enter__(self):
        self._parent = self.helper.main_program.current_block()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            return False
        blocks = [b for _, b in self._cases]
        if self._default is not None:
            blocks.append(self._default)
        carried: List[str] = []
        for b in blocks:
            for n in _external_reads(b, self._parent) + _parent_writes(b, self._parent):
                if n not in carried:
                    carried.append(n)
        # drop the case conditions themselves from the carry
        cond_names = {c.name for c, _ in self._cases}
        carried = [n for n in carried if n not in cond_names]
        self._parent.append_op(
            type="switch",
            inputs={"Conds": [c.name for c, _ in self._cases], "X": carried},
            outputs={"Out": carried},
            attrs={"case_blocks": [b for _, b in self._cases],
                   "default_block": self._default,
                   "var_names": carried})
        return False


# ---------------------------------------------------------------------------
# cond (functional two-branch)
# ---------------------------------------------------------------------------

def cond(pred: Variable, true_fn, false_fn, name=None):
    """Functional two-branch conditional: returns true_fn() or false_fn()
    outputs (a Variable or list of Variables; both branches must match)."""
    helper = LayerHelper("cond", name=name)
    prog = helper.main_program
    parent = prog.current_block()

    def build(fn):
        blk = prog.create_block()
        out = fn()
        prog.rollback()
        outs = list(out) if isinstance(out, (list, tuple)) else [out]
        env = _external_reads(blk, parent)
        # A branch may return a pre-existing parent var untouched
        # (e.g. cond(flag, lambda: x, ...)); carry it into the branch env so
        # the lowered fn can emit it as an output.
        produced = {n for op in blk.ops for n in op.output_names()}
        for v in outs:
            if v.name not in produced and v.name not in env and parent.has_var(v.name):
                env.append(v.name)
        return blk, outs, env

    tb, t_outs, t_env = build(true_fn)
    fb, f_outs, f_env = build(false_fn)
    if len(t_outs) != len(f_outs):
        raise ValueError("cond: branch output arity mismatch "
                         f"({len(t_outs)} vs {len(f_outs)})")

    results = [parent.create_var(
        name=helper.name + f".out{i}", dtype=v.dtype, shape=v.shape)
        for i, v in enumerate(t_outs)]
    parent.append_op(
        type="cond",
        inputs={"Pred": [pred.name], "TrueIn": t_env, "FalseIn": f_env},
        outputs={"Out": [r.name for r in results]},
        attrs={"true_block": tb, "false_block": fb,
               "true_env_names": t_env,
               "false_env_names": f_env,
               "true_out_names": [v.name for v in t_outs],
               "false_out_names": [v.name for v in f_outs]})
    return results[0] if len(results) == 1 else results


# ---------------------------------------------------------------------------
# IfElse (per-row branch + merge)
# ---------------------------------------------------------------------------

class _IfElseBlockGuard:
    def __init__(self, ie: "IfElse", is_true: bool):
        self.ie = ie
        self.is_true = is_true

    def __enter__(self):
        self.ie._in_true = self.is_true
        return self

    def __exit__(self, *a):
        self.ie._in_true = None
        return False


class IfElse:
    """Per-row two-branch computation (reference layers/control_flow.py
    IfElse: split rows by a [B,1] bool condition, run branch nets, merge).

    Both branches compute on the full batch (static shapes);
    `ie()` merges each output pair rowwise with a `select` op. Semantics match
    for row-independent branch nets — the reference's supported use."""

    def __init__(self, cond: Variable, name=None):
        self.helper = LayerHelper("ifelse", name=name)
        self.cond = cond
        self._in_true: Optional[bool] = None
        self._true_outs: List[Variable] = []
        self._false_outs: List[Variable] = []

    def true_block(self):
        return _IfElseBlockGuard(self, True)

    def false_block(self):
        return _IfElseBlockGuard(self, False)

    def input(self, x: Variable) -> Variable:
        if self._in_true is None:
            raise RuntimeError("IfElse.input() outside of a branch block")
        return x

    def output(self, *outs: Variable):
        if self._in_true is None:
            raise RuntimeError("IfElse.output() outside of a branch block")
        (self._true_outs if self._in_true else self._false_outs).extend(outs)

    def __call__(self) -> List[Variable]:
        if len(self._true_outs) != len(self._false_outs):
            raise ValueError("IfElse: branch output arity mismatch")
        merged = []
        for t, f in zip(self._true_outs, self._false_outs):
            out = self.helper.create_variable_for_type_inference(t.dtype, t.shape)
            self.helper.append_op(
                type="select",
                inputs={"Cond": [self.cond.name], "X": [t.name], "Y": [f.name]},
                outputs={"Out": [out.name]}, attrs={})
            merged.append(out)
        return merged


# ---------------------------------------------------------------------------
# StaticRNN / DynamicRNN
# ---------------------------------------------------------------------------

class _RNNStepGuard:
    def __init__(self, rnn):
        self.rnn = rnn

    def __enter__(self):
        self.rnn._enter_step()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.rnn._exit_step(exc_type is None)
        return False


class StaticRNN:
    """Unrolled-over-time RNN builder (reference layers/control_flow.py:~400,
    recurrent_op.cc) recorded as one differentiable `static_rnn` op.

    Usage::

        rnn = StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)            # x: [B, T, D] -> x_t [B, D]
            h = rnn.memory(init=h0)            # or memory(shape=..., value=0)
            nh = layers.fc(concat([x_t, h]), size)
            rnn.update_memory(h, nh)
            rnn.output(nh)
        out = rnn()                            # [B, T, size]
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self._parent: Optional[Block] = None
        self._block: Optional[Block] = None
        self._seq_inputs: List[tuple] = []      # (parent var, step var)
        self._memories: List[dict] = []         # {init, pre, post}
        self._outputs: List[Variable] = []
        self._done = False

    def step(self):
        return _RNNStepGuard(self)

    def _enter_step(self):
        prog = self.helper.main_program
        self._parent = prog.current_block()
        self._block = prog.create_block()

    def _exit_step(self, ok: bool):
        self.helper.main_program.rollback()
        self._done = ok

    # -- step-building API --------------------------------------------------
    def step_input(self, x: Variable) -> Variable:
        if x.shape is None or len(x.shape) < 2:
            raise ValueError("step_input needs [B, T, ...] shaped input")
        step_shape = [x.shape[0]] + list(x.shape[2:])
        v = self._block.create_var(
            name=self.helper.name + f".seq{len(self._seq_inputs)}",
            dtype=x.dtype, shape=step_shape)
        self._seq_inputs.append((x, v))
        return v

    def memory(self, init: Optional[Variable] = None, shape=None,
               batch_ref: Optional[Variable] = None, value: float = 0.0,
               dtype="float32") -> Variable:
        if init is None:
            if shape is None:
                raise ValueError("memory() needs init= or shape=")
            full_shape = list(shape)
            if batch_ref is not None and (not full_shape or full_shape[0] in (None, -1)):
                full_shape = [batch_ref.shape[0]] + full_shape[1:] if full_shape else None
            # Build the init constant in the PARENT block (we are inside the
            # step sub-block) so the static_rnn op's State input resolves.
            prog = self.helper.main_program
            sub_idx = prog.current_block_idx
            prog.current_block_idx = self._parent.idx
            try:
                init = tensor_layers.fill_constant(full_shape, dtype, value)
            finally:
                prog.current_block_idx = sub_idx
        pre = self._block.create_var(
            name=self.helper.name + f".mem{len(self._memories)}",
            dtype=init.dtype, shape=init.shape)
        self._memories.append({"init": init, "pre": pre, "post": None})
        return pre

    def update_memory(self, mem: Variable, new: Variable):
        for m in self._memories:
            if m["pre"].name == mem.name:
                m["post"] = new
                return
        raise ValueError(f"update_memory: {mem.name} is not a memory")

    def output(self, *outputs: Variable):
        self._outputs.extend(outputs)

    # -- finalize -----------------------------------------------------------
    def __call__(self):
        if not self._done:
            raise RuntimeError("StaticRNN used before its step block closed")
        for m in self._memories:
            if m["post"] is None:
                raise ValueError("memory without update_memory()")
        parent = self._parent
        B = self._seq_inputs[0][0].shape[0] if self._seq_inputs else None
        T = self._seq_inputs[0][0].shape[1] if self._seq_inputs else None

        param_names = [n for n in _external_reads(self._block, parent)
                       if n not in {v.name for v, _ in self._seq_inputs}
                       and n not in {m["init"].name for m in self._memories}]

        outs = []
        for i, o in enumerate(self._outputs):
            shape = None
            if o.shape is not None and B is not None:
                shape = [B, T] + list(o.shape[1:])
            outs.append(parent.create_var(
                name=self.helper.name + f".out{i}", dtype=o.dtype, shape=shape))
        finals = [parent.create_var(
            name=self.helper.name + f".final{i}", dtype=m["init"].dtype,
            shape=m["init"].shape) for i, m in enumerate(self._memories)]

        parent.append_op(
            type="static_rnn",
            inputs={"State": [m["init"].name for m in self._memories],
                    "Seq": [v.name for v, _ in self._seq_inputs],
                    "Param": param_names},
            outputs={"Out": [o.name for o in outs],
                     "FinalState": [f.name for f in finals]},
            attrs={"sub_block": self._block,
                   "state_names": [m["pre"].name for m in self._memories],
                   "state_out_names": [m["post"].name for m in self._memories],
                   "seq_in_names": [v.name for _, v in self._seq_inputs],
                   "out_names": [o.name for o in self._outputs],
                   "param_names": param_names})
        if len(outs) == 1:
            return outs[0]
        return outs

    def final_states(self) -> List[Variable]:
        """Final memory values (shape of init) — an extension of the JAX
        package; the reference reads the last array slot instead."""
        parent = self._parent
        return [parent.var(self.helper.name + f".final{i}")
                for i in range(len(self._memories))]


class DynamicRNN(StaticRNN):
    """Variable-length RNN builder (reference layers/control_flow.py:~1700).

    The reference shrinks the batch as short rows finish (LoD sort); here each
    row's memory update is masked by its length so the carried state freezes
    at the row's last valid step — identical final states / outputs under
    padding, with static shapes.

    ``step_input(x, length)``: the first call must pass `length` [B]."""

    def __init__(self, name=None):
        super().__init__(name=name)
        self.helper = LayerHelper("dynamic_rnn", name=name)
        self._length: Optional[Variable] = None
        self._mask_step: Optional[Variable] = None

    def step_input(self, x: Variable, length: Optional[Variable] = None) -> Variable:
        v = super().step_input(x)
        if length is not None and self._length is None:
            self._length = length
            # Build the [B, T, 1] mask in the PARENT block (we are inside the
            # step sub-block here), feed it as a seq input so each step sees
            # its [B, 1] validity column.
            from . import sequence as seq_layers
            prog = self.helper.main_program
            sub_idx = prog.current_block_idx
            prog.current_block_idx = self._parent.idx
            try:
                T = x.shape[1]
                mask = seq_layers.sequence_mask(length, maxlen=T, dtype="float32")
                mask3 = tensor_layers.reshape(mask, [x.shape[0], T, 1])
            finally:
                prog.current_block_idx = sub_idx
            self._mask_step = super().step_input(mask3)
        return v

    def update_memory(self, mem: Variable, new: Variable):
        if self._mask_step is None:
            super().update_memory(mem, new)
            return
        # masked carry: post = mask*new + (1-mask)*pre  (built inside block)
        from . import ops as op_layers
        keep = op_layers.elementwise_mul(new, self._mask_step, axis=0)
        inv = op_layers.scale(self._mask_step, scale=-1.0, bias=1.0)
        old = op_layers.elementwise_mul(mem, inv, axis=0)
        merged = op_layers.elementwise_add(keep, old)
        super().update_memory(mem, merged)

    def output(self, *outputs: Variable):
        if self._mask_step is None:
            super().output(*outputs)
            return
        # Padded positions emit zeros (the padded+mask convention standing in
        # for the reference's absent LoD rows).
        from . import ops as op_layers
        masked = [op_layers.elementwise_mul(o, self._mask_step, axis=0)
                  for o in outputs]
        super().output(*masked)

    def block(self):
        return self.step()


# ---------------------------------------------------------------------------
# tensor arrays
# ---------------------------------------------------------------------------

def create_array(dtype, element_shape: Sequence[int] = None,
                 max_len: int = None, name=None):
    """Preallocated tensor array (LoDTensorArray capability): a
    [max_len, *element_shape] buffer + int64 length scalar. Unlike the
    reference (dynamically growing C++ vector), the buffer is
    preallocated — pass element_shape and max_len."""
    if element_shape is None or max_len is None:
        raise ValueError(
            "create_array needs element_shape= and max_len= (a "
            "preallocated buffer stands in for the reference's "
            "dynamically-growing LoDTensorArray)")
    buf = tensor_layers.fill_constant([max_len] + list(element_shape), dtype, 0.0)
    n = tensor_layers.fill_constant([1], "int64", 0)
    buf._array_length_var = n
    return buf


def array_write(x: Variable, i: Variable, array: Variable) -> Variable:
    helper = LayerHelper("array_write")
    n = getattr(array, "_array_length_var", None)
    if n is None:
        raise ValueError("array_write target must come from create_array()")
    helper.append_op(
        type="array_write",
        inputs={"Array": [array.name], "I": [i.name], "X": [x.name],
                "Length": [n.name]},
        outputs={"Out": [array.name], "LengthOut": [n.name]}, attrs={})
    return array


def array_read(array: Variable, i: Variable) -> Variable:
    helper = LayerHelper("array_read")
    out = helper.create_variable_for_type_inference(
        array.dtype, list(array.shape[1:]) if array.shape else None)
    helper.append_op(
        type="array_read",
        inputs={"Array": [array.name], "I": [i.name]},
        outputs={"Out": [out.name]}, attrs={})
    return out


def array_length(array: Variable) -> Variable:
    helper = LayerHelper("array_length")
    n = getattr(array, "_array_length_var", None)
    if n is None:
        raise ValueError("array_length target must come from create_array()")
    out = helper.create_variable_for_type_inference("int64", [1])
    helper.append_op(type="array_length", inputs={"Length": [n.name]},
                     outputs={"Out": [out.name]}, attrs={})
    return out


def max_sequence_len(length: Variable) -> Variable:
    """Reference max_sequence_len op over a rank table; here simply the max
    of the [B] length vector."""
    from . import reduce as reduce_layers
    return reduce_layers.reduce_max(length)
