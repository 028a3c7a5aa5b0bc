"""Control-flow ops (counterpart of ``paddle_tpu.ops.control_flow_ops``;
reference ``paddle/fluid/operators/controlflow/`` while_op.cc,
conditional_block_op.cc, recurrent_op.cc and the tensor-array ops).

The JAX package lowers each sub-block to a pure function inside its one
jitted step (``lax.while_loop``, ``lax.cond``, ``lax.switch``,
``lax.scan``). The port runs eagerly, so a sub-block is run op by op
through ``core/executor.run_sub_block`` (a shallow copy of the run's
context each step, the run's generator shared, so a dropout inside a loop
draws a new mask every step), and the loops are Python loops:

- ``conditional_block``, unbounded ``while``, ``cond`` and ``switch`` read
  their condition(s) back to the host: once a run, or once an iteration
  for ``while``. That read is the op's cost on the card (one sync). The
  other way, predication, would run every branch (or a bound's worth of
  iterations) every step and select with ``torch.where``.
- ``while`` with ``max_iters=N`` runs its body N times and keeps each
  carried value where the condition still held (``torch.where`` on the
  device, no host read), as the JAX package's masked ``lax.scan`` does; it
  is differentiable through autograd. Unbounded, it is not differentiable
  (what feeds it gets no gradient through it), as in the JAX package.
- ``static_rnn`` runs its step block once per time step, carrying the
  states and stacking the step outputs along T; differentiable.

Tensor arrays are the JAX package's dense design: a ``[max_len, ...]``
buffer plus an int64 length. ``array_write`` returns a new buffer (out of
place, so autograd never sees a saved tensor written) and takes its index
as a device tensor; indices wrap once if negative and are then clamped
into the buffer, as ``lax.dynamic_update_index_in_dim`` /
``dynamic_index_in_dim`` do, so an index past the end never reaches a
device-side bounds assert.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..core.registry import register_op


def _run(block, env: Dict[str, torch.Tensor], ctx):
    from ..core.executor import run_sub_block

    run_sub_block(block, env, ctx)
    return env


@register_op("conditional_block", differentiable=False)
def _conditional_block(ctx, inputs, attrs):
    """conditional_block_op.cc: run `sub_block` over the carried values
    (`var_names`, read and written by the block) when `Cond` is true."""
    names: List[str] = attrs["var_names"]
    (cond,) = inputs["Cond"]
    xs = inputs["X"]
    if not bool(cond.reshape(())):   # the op's one host read
        return {"Out": list(xs)}
    env = _run(attrs["sub_block"], dict(zip(names, xs)), ctx)
    return {"Out": [env[n] for n in names]}


@register_op("while",
             differentiable=lambda attrs: attrs.get("max_iters") is not None)
def _while(ctx, inputs, attrs):
    """while_op.cc over the carried values `loop_vars` (the body reads and
    writes them; `cond_name` is among them). Without `max_iters`: run the
    body while the condition holds, reading it once an iteration. With
    `max_iters=N`: run the body N times, each carried value advancing only
    while the condition held before that iteration."""
    block = attrs["sub_block"]
    names: List[str] = attrs["loop_vars"]
    ci = names.index(attrs["cond_name"])
    vals = list(inputs["X"])
    max_iters = attrs.get("max_iters")
    if max_iters is None:
        while bool(vals[ci].reshape(())):   # one host read an iteration
            env = _run(block, dict(zip(names, vals)), ctx)
            vals = [env[n] for n in names]
        return {"Out": vals}
    for _ in range(int(max_iters)):
        alive = vals[ci].reshape(()).to(torch.bool)
        env = _run(block, dict(zip(names, vals)), ctx)
        vals = [torch.where(alive, env[n].to(v.dtype), v)
                for n, v in zip(names, vals)]
    return {"Out": vals}


@register_op("static_rnn")
def _static_rnn(ctx, inputs, attrs):
    """StaticRNN / recurrent_op.cc: sequence inputs [B, T, ...] stepped
    over T; `state_names` carry (their new values are `state_out_names`);
    `out_names` are stacked along T; `Param` inputs are bound every step.
    Outputs: Out [B, T, ...] each, FinalState (the carried values)."""
    block = attrs["sub_block"]
    state_names = attrs["state_names"]
    state_out_names = attrs["state_out_names"]
    seq_in_names = attrs["seq_in_names"]
    out_names = attrs["out_names"]
    param_names = attrs.get("param_names", [])
    states = list(inputs["State"])
    seqs = inputs["Seq"]
    params = inputs.get("Param", [])
    steps: List[List[torch.Tensor]] = [[] for _ in out_names]
    for t in range(seqs[0].shape[1]):
        env = dict(zip(state_names, states))
        env.update((n, s[:, t]) for n, s in zip(seq_in_names, seqs))
        env.update(zip(param_names, params))
        _run(block, env, ctx)
        states = [env[n] for n in state_out_names]
        for ys, n in zip(steps, out_names):
            ys.append(env[n])
    return {"Out": [torch.stack(ys, dim=1) for ys in steps],
            "FinalState": states}


@register_op("cond", differentiable=False)
def _cond(ctx, inputs, attrs):
    """Two-branch functional cond: read `Pred` once, run that branch's
    block over its own captured values, return its outputs."""
    (pred,) = inputs["Pred"]
    side = "true" if bool(pred.reshape(())) else "false"   # one host read
    vals = inputs.get("TrueIn" if side == "true" else "FalseIn", [])
    env = _run(attrs[f"{side}_block"],
               dict(zip(attrs[f"{side}_env_names"], vals)), ctx)
    return {"Out": [env[n] for n in attrs[f"{side}_out_names"]]}


@register_op("switch", differentiable=False)
def _switch(ctx, inputs, attrs):
    """First-matching-case switch over shared carried values: the cases'
    conditions come to the host in one read; the first true case runs,
    else the default (none: the values pass through)."""
    names = attrs["var_names"]
    xs = list(inputs["X"])
    conds = inputs["Conds"]
    flags = (torch.stack([c.reshape(()).to(torch.bool) for c in conds])
             .tolist() if conds else [])   # the op's one host read
    blocks = attrs["case_blocks"]
    block = next((b for b, f in zip(blocks, flags) if f),
                 attrs.get("default_block"))
    if block is None:
        return {"Out": xs}
    env = _run(block, dict(zip(names, xs)), ctx)
    return {"Out": [env[n] for n in names]}


@register_op("select")
def _select(ctx, inputs, attrs):
    """Rowwise select (the IfElse merge): where(Cond, X, Y), Cond
    broadcast from [B, 1] over the trailing dims."""
    (cond,) = inputs["Cond"]
    (x,) = inputs["X"]
    (y,) = inputs["Y"]
    c = cond.to(torch.bool)
    while c.ndim < x.ndim:
        c = c[..., None]
    return {"Out": [torch.where(c.expand(x.shape), x, y)]}


def _array_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """A [1] index tensor into a buffer of `n` slots: a negative index
    wraps once, then the index is clamped into [0, n-1], on the device."""
    idx = i.reshape(1).to(torch.int64)
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


@register_op("array_write", nondiff_inputs=["I", "Length"])
def _array_write(ctx, inputs, attrs):
    """A new buffer with slot I set to X; LengthOut = max(Length, I + 1)
    (the unclamped I, as the JAX package counts)."""
    (arr,) = inputs["Array"]
    (i,) = inputs["I"]
    (x,) = inputs["X"]
    (n,) = inputs["Length"]
    idx = _array_index(i, arr.shape[0])
    new = arr.index_copy(0, idx, x.to(arr.dtype).unsqueeze(0))
    grown = torch.maximum(n, (i.reshape(()).to(torch.int64) + 1).to(n.dtype))
    return {"Out": [new], "LengthOut": [grown]}


@register_op("array_read", nondiff_inputs=["I"])
def _array_read(ctx, inputs, attrs):
    (arr,) = inputs["Array"]
    (i,) = inputs["I"]
    return {"Out": [arr.index_select(0, _array_index(i, arr.shape[0]))[0]]}


@register_op("array_length", differentiable=False)
def _array_length(ctx, inputs, attrs):
    (n,) = inputs["Length"]
    return {"Out": [n.reshape(1).to(torch.int64)]}
