"""The Mixture-of-Experts op (counterpart of ``paddle_tpu.ops.moe_ops``; no
reference analog): ``parallel/moe.py``'s machinery as one ``moe_ffn`` op.
On a mesh whose data axis is the op's ``ep_axis`` it takes the expert-
parallel path (when the experts divide over the axis), else the dense
path; both differentiate through torch.autograd.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.mesh_step import batch_group
from ..core.registry import register_op
from ..parallel import moe as _moe

_ACTS = {"gelu": _moe._gelu, "relu": torch.relu, "silu": F.silu}


def _ep_group(ctx, axis, experts):
    """The process group of the mesh's `axis` when the op runs expert-
    parallel on it (the JAX op's test: the mesh has the axis and the
    experts and the global tokens divide over it), else None."""
    step = getattr(ctx, "mesh", None)
    if step is None or axis not in tuple(step.mesh.mesh_dim_names or ()):
        return None
    group = step.mesh.get_group(axis)
    size = torch.distributed.get_world_size(group)
    if size == 1 or experts % size:
        return None
    if axis != step.axis:
        raise NotImplementedError(
            f"moe_ffn: an {axis!r} axis that is not the data axis "
            f"{step.axis!r} is ROADMAP A9b3")
    return group


# the tokens are row by row; the load-balance loss is global
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
    group = _ep_group(ctx, attrs.get("ep_axis", "ep"), gate_w.shape[1])
    if group is not None:
        y, aux = _moe.moe_ffn_expert_parallel(
            flat, gate_w, w1, b1, w2, b2, group, k=k, capacity_factor=cf,
            act=act)
    elif batch_group(ctx, "X") is not None:
        raise NotImplementedError(
            "moe_ffn's dense path routes over the whole batch; on a batch "
            "sharded over a data axis that is not its ep_axis it is "
            "ROADMAP A9b3")
    else:
        y, aux = _moe.moe_ffn(flat, gate_w, w1, b1, w2, b2, k=k,
                              capacity_factor=cf, act=act)
    return {"Out": [y.reshape(shape)], "AuxLoss": [aux.to(x.dtype)]}
