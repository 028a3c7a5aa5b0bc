"""Eager tracer and autograd engine (the port's counterpart of
``paddle_tpu.dygraph.tracer``).

Reference analog: Tracer::TraceOp (imperative/tracer.cc:35 — run the kernel,
then record the grad ops) and BasicEngine (engine.cc:42 — the reverse walk
with a GradientAccumulator).

The JAX package runs each op under ``jax.vjp`` and keeps a tape of vjp
closures that ``run_backward`` walks in reverse. The port's registered ops
are forward functions on torch tensors, so torch autograd records the graph
as the op runs (the static executor differentiates the same functions with
``torch.autograd.grad``). ``trace_op`` runs an op under
``torch.enable_grad()`` when the JAX package would tape it — grad enabled,
the op differentiable under its attrs, some input not stopping gradient —
and under ``torch.no_grad()`` otherwise. Inputs in the op's
``nondiff_inputs`` and inputs that stop gradient enter detached.

Gradient semantics are the JAX package's where a user can see them. Its
tape is a list of the VarBases that taped ops read without stopping
gradient (parameters, user inputs and intermediates alike), held by weak
reference: a VarBase nobody holds cannot be asked for its gradient.
``run_backward`` asks ``torch.autograd.grad`` for the loss's gradient with
respect to every live one and adds it into its ``grad_value``, so a
gradient sums over backward calls until ``clear_gradient``. Without
``retain_graph`` the tape is then emptied and torch frees the graph; a
second backward walks the empty tape and does nothing, as in the JAX
package.
"""
from __future__ import annotations

import weakref
from typing import Dict, List, Optional

import torch

from ..core.executor import ExecContext
from ..ops import eager as _eager
from .varbase import VarBase

_PRUNE_EVERY = 512


class Tracer:
    def __init__(self, train_mode: bool = True, seed: int = 0, device=None):
        self._seed = seed
        self.device = torch.device(device or "cpu")
        self._op_counter = 0
        # id -> weakref of each VarBase a taped op read with gradient
        self.tape: Dict[int, weakref.ref] = {}
        self._train_mode = train_mode
        self._no_grad_depth = 0
        self._ctx = ExecContext(
            self.device, torch.Generator(self.device).manual_seed(seed))

    @property
    def grad_enabled(self) -> bool:
        return self._train_mode and self._no_grad_depth == 0

    def train_mode(self):
        self._train_mode = True

    def eval_mode(self):
        self._train_mode = False

    def reset(self):
        self.tape = {}

    # -- op dispatch -------------------------------------------------------
    def trace_op(self, op_type: str, inputs: Dict[str, List[VarBase]],
                 attrs: Optional[Dict] = None) -> Dict[str, List[VarBase]]:
        is_test = not self._train_mode
        prep = _eager.resolve(op_type, attrs, is_test)
        ctx = self._ctx
        ctx.is_test = is_test
        self._op_counter += 1
        need_grad = (self.grad_enabled and prep.differentiable
                     and any(not v.stop_gradient
                             for vs in inputs.values() for v in vs))
        if not need_grad:
            in_vals = {s: [v.value for v in vs] for s, vs in inputs.items()}
            with torch.no_grad():
                out = prep.opdef.fn(ctx, in_vals, prep.attrs)
            return {s: [None if v is None else VarBase._wrap(v, True)
                        for v in vs] for s, vs in out.items()}

        in_vals = {}
        tape = self.tape
        for slot, vs in inputs.items():
            nondiff = slot in prep.nondiff_inputs
            vals = []
            for v in vs:
                t = v.value
                if nondiff or v.stop_gradient:
                    vals.append(t.detach() if t.requires_grad else t)
                    continue
                vals.append(t)
                if t.requires_grad:
                    tape[id(v)] = weakref.ref(v)
            in_vals[slot] = vals
        with torch.enable_grad():
            out = prep.opdef.fn(ctx, in_vals, prep.attrs)
        # amortized pruning: forward-only loops (eval without no_grad) must
        # not grow the tape forever
        if self._op_counter % _PRUNE_EVERY == 0:
            self.tape = {k: r for k, r in tape.items() if r() is not None}
        return {s: [None if v is None else VarBase._wrap(v, False)
                    for v in vs] for s, vs in out.items()}

    # -- backward (BasicEngine parity) --------------------------------------
    def run_backward(self, loss: VarBase, retain_graph: bool = False):
        live = [v for v in (r() for r in self.tape.values())
                if v is not None and not v.stop_gradient
                and v.value.requires_grad]
        if not retain_graph:
            self.tape = {}
        if not live or not loss.value.requires_grad:
            return
        grads = torch.autograd.grad(
            [loss.value], [v.value for v in live],
            grad_outputs=[torch.ones_like(loss.value)],
            retain_graph=retain_graph, allow_unused=True)
        for var, g in zip(live, grads):
            if g is None:
                continue
            # GradientAccumulator parity: sum into the gradient of every var
            # that requires grad (params AND user inputs AND intermediates)
            var.grad_value = g if var.grad_value is None \
                else var.grad_value + g


_tracer: Optional[Tracer] = None


def _active_tracer() -> Optional[Tracer]:
    return _tracer


def _set_tracer(t: Optional[Tracer]):
    global _tracer
    _tracer = t


def trace_op(op_type, inputs, attrs=None):
    tr = _active_tracer()
    if tr is None:
        raise RuntimeError(
            f"op {op_type} called in dygraph style outside dygraph.guard()")
    return tr.trace_op(op_type, inputs, attrs)
