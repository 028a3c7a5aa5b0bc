"""The Mixture-of-Experts op (counterpart of ``paddle_tpu.ops.moe_ops``; no
reference analog): ``parallel/moe.py``'s machinery as one ``moe_ffn`` op.
On a mesh with the op's ``ep_axis`` (when the experts and the tokens
divide over it) it takes the expert-parallel path, else the dense path;
both differentiate through torch.autograd.

On a data-parallel mesh:

- ``ep_axis`` is the data axis: each rank routes its own tokens (its rows),
  expert-parallel over the axis; the aux loss is the global one.
- any other case routes the whole batch, as the JAX package's global
  program does: the tokens are gathered whole over the data axis (rule A
  of ``core/registry.py``, the backward a reduce-scatter), and each rank
  keeps its rows of ``Out``. The dense path then takes its capacity from
  the global token count; with an ``ep`` axis that is not the data axis
  the rank at ep coordinate j routes chunk j of the global token order
  (the JAX package's ``shard_map`` with ``P(axis)``), expert-parallel over
  the ep axis, with the chunk's capacity.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.mesh_step import batch_group
from ..core.registry import register_op
from ..parallel import moe as _moe
from ..parallel.collective import gather_rows

_ACTS = {"gelu": _moe._gelu, "relu": torch.relu, "silu": F.silu}


def _ep_group(ctx, axis, experts):
    """The process group of the mesh's `axis` when the op can run expert-
    parallel on it (the mesh has the axis, of more than one rank, and the
    experts divide over it), else None."""
    step = getattr(ctx, "mesh", None)
    if step is None or axis not in tuple(step.mesh.mesh_dim_names or ()):
        return None
    group = step.mesh.get_group(axis)
    size = torch.distributed.get_world_size(group)
    if size == 1 or experts % size:
        return None
    return group


# on the data axis: the tokens are row by row and the load-balance loss is
# global; otherwise the op gathers the whole batch itself (module docstring)
@register_op("moe_ffn", dp=("AuxLoss",))
def _moe_ffn(ctx, inputs, attrs):
    (x,) = inputs["X"]                 # [B, T, D] or [N, D]
    (gate_w,) = inputs["GateW"]        # [D, E]
    (w1,) = inputs["W1"]               # [E, D, H]
    (b1,) = inputs["B1"]               # [E, H]
    (w2,) = inputs["W2"]               # [E, H, D]
    (b2,) = inputs["B2"]               # [E, D]
    k = int(attrs.get("k", 2))
    cf = float(attrs.get("capacity_factor", 1.25))
    act = _ACTS[attrs.get("act", "gelu")]
    shape = x.shape
    flat = x.reshape(-1, shape[-1])
    params = (gate_w, w1, b1, w2, b2)
    axis = attrs.get("ep_axis", "ep")
    group = _ep_group(ctx, axis, gate_w.shape[1])
    if group is not None and axis == ctx.mesh.axis:
        y, aux = _moe.moe_ffn_expert_parallel(
            flat, *params, group, k=k, capacity_factor=cf, act=act)
        return {"Out": [y.reshape(shape)], "AuxLoss": [aux.to(x.dtype)]}
    dp = batch_group(ctx, "X")
    tokens, rows = flat, None
    if dp is not None:
        (tokens,), counts = gather_rows([flat], dp)
        col = [c[0] for c in counts]
        me = torch.distributed.get_rank(dp)
        rows = (sum(col[:me]), col[me])
    ep = torch.distributed.get_world_size(group) if group is not None else 1
    if group is not None and tokens.shape[0] % ep == 0:
        y, aux = _moe.moe_ffn_ep_chunks(tokens, *params, group, k=k,
                                        capacity_factor=cf, act=act)
    else:
        y, aux = _moe.moe_ffn(tokens, *params, k=k, capacity_factor=cf,
                              act=act)
    if rows is not None:
        y = y.narrow(0, *rows)
    return {"Out": [y.reshape(shape)], "AuxLoss": [aux.to(x.dtype)]}
