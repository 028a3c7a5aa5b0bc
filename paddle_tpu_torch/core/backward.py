"""append_backward / gradients — autodiff surface over the Program IR.

The port's copy of ``paddle_tpu.core.backward`` (reference
``python/paddle/fluid/backward.py``: append_backward:558, calc_gradient:820,
gradients:938). There, backward is a graph-rewrite pass emitting one grad-op
per forward op with explicit accumulation ops; here the same contract (grad
variables named ``<var>@GRAD`` appear in the block and can be consumed by
optimizer ops) is met by inserting a single `autodiff` pseudo-op, with the
same inputs, outputs and attrs as the JAX package's. The port's executor
runs the forward with torch.autograd recording and evaluates that op with
``torch.autograd.grad`` over its targets.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from .program import Parameter, Program, Variable, grad_var_name


def _collect_params(program: Program, parameter_list, no_grad_set) -> List[str]:
    if parameter_list is not None:
        names = [p.name if isinstance(p, Variable) else p for p in parameter_list]
    else:
        names = [p.name for p in program.all_parameters() if p.trainable]
    no_grad = {v.name if isinstance(v, Variable) else v for v in (no_grad_set or set())}
    return [n for n in names if n not in no_grad]


def append_backward(
    loss: Variable,
    parameter_list: Optional[Sequence] = None,
    no_grad_set=None,
    callbacks=None,
) -> List[Tuple[Variable, Variable]]:
    """Create ``param@GRAD`` vars for every trainable parameter reachable from
    `loss` and schedule the reverse pass. Returns [(param, grad_var)] like the
    reference (backward.py:558)."""
    block = loss.block
    program = block.program
    targets = _collect_params(program, parameter_list, no_grad_set)

    grad_vars = []
    for t in targets:
        tv = block.var(t)
        gv = block.create_var(
            name=grad_var_name(t), shape=tv.shape, dtype=tv.dtype,
            persistable=False, stop_gradient=True)
        grad_vars.append((tv, gv))

    loss_grad = block.create_var(
        name=grad_var_name(loss.name), shape=loss.shape, dtype=loss.dtype,
        persistable=False, stop_gradient=True)

    block.append_op(
        type="autodiff",
        inputs={"Loss": [loss.name]},
        outputs={"Grads": [grad_var_name(t) for t in targets] + [loss_grad.name]},
        attrs={"loss_name": loss.name, "targets": list(targets) + [loss.name]},
    )
    program._appended_backward = True
    return grad_vars


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """Reference backward.py:938 `calc_gradient` — grads of one or more
    `targets` w.r.t. arbitrary `inputs`, summed over targets. Each entry of
    `target_gradients` (if given) seeds the corresponding target's cotangent;
    None entries (or omitting the list) seed with ones."""
    if isinstance(targets, Variable):
        targets = [targets]
    if isinstance(inputs, Variable):
        inputs = [inputs]
    if not targets:
        raise ValueError("gradients() needs at least one target")
    if target_gradients is None:
        target_gradients = [None] * len(targets)
    elif isinstance(target_gradients, Variable):
        target_gradients = [target_gradients]
    if len(target_gradients) != len(targets):
        raise ValueError(
            f"target_gradients has {len(target_gradients)} entries for "
            f"{len(targets)} targets")
    block = targets[0].block
    names = [v.name if isinstance(v, Variable) else v for v in inputs]
    no_grad = {v.name if isinstance(v, Variable) else v for v in (no_grad_set or set())}
    names = [n for n in names if n not in no_grad]

    outs = []
    for n in names:
        v = block.var(n)
        gv = block.create_var(name=grad_var_name(n), shape=v.shape, dtype=v.dtype,
                              persistable=False, stop_gradient=True)
        outs.append(gv)

    loss_names = [t.name for t in targets]
    init_names = [None if g is None else g.name for g in target_gradients]
    attrs = {"loss_names": loss_names, "init_grad_names": init_names,
             "targets": names,
             # single-target aliases for backward compatibility
             "loss_name": loss_names[0]}
    inputs_map = {"Loss": loss_names}
    seeds = [n for n in init_names if n is not None]
    if seeds:
        inputs_map["InitGrad"] = seeds
    block.append_op(
        type="autodiff",
        inputs=inputs_map,
        outputs={"Grads": [grad_var_name(n) for n in names]},
        attrs=attrs,
    )
    return outs


calc_gradient = gradients
