"""Control-flow ops: the port's ``conditional_block`` (counterpart of
``paddle_tpu.ops.control_flow_ops``'s; reference
``paddle/fluid/operators/controlflow/conditional_block_op.cc``). The rest
of the JAX package's control flow (while, static_rnn, cond, switch) is not
ported yet.

The JAX package lowers the sub-block through ``lax.cond`` into its one
jitted step. The port runs eagerly, so it reads the condition, a
one-element tensor, back to the host once a run and runs the sub-block
only when it holds; otherwise ``Out`` passes the carried values through.
That host read is the op's cost on the card (one sync a step). The other
way, predication, would run the sub-block every step and select with
``torch.where``: every carried parameter and accumulator would need a copy
a step, and the sub-block's work would be paid on the steps that skip it.
"""
from __future__ import annotations

from typing import List

from ..core.registry import register_op


@register_op("conditional_block", differentiable=False)
def _conditional_block(ctx, inputs, attrs):
    """conditional_block_op.cc: run `sub_block` over the carried values
    (`var_names`, read and written by the block) when `Cond` is true."""
    from ..core.executor import run_sub_block

    names: List[str] = attrs["var_names"]
    (cond,) = inputs["Cond"]
    xs = inputs["X"]
    if not bool(cond.reshape(())):   # the op's one host read
        return {"Out": list(xs)}
    env = dict(zip(names, xs))
    run_sub_block(attrs["sub_block"], env, ctx)
    return {"Out": [env[n] for n in names]}
