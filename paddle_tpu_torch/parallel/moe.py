"""Mixture-of-Experts with expert parallelism over a named mesh axis (the
port's counterpart of ``paddle_tpu.parallel.moe``).

- Static capacity dispatch (GShard/Switch style): tokens route into an
  [E, C, D] buffer through one-hot einsums, every shape fixed by the token
  count, the expert count and the capacity factor.
- Expert parallelism: tokens are sharded over the ``ep`` axis (the data
  axis doubles as the expert axis, or, with ``moe_ffn_ep_chunks``, the
  rank at ep coordinate j routes chunk j of tokens every rank of the axis
  holds whole), and so are the experts: each rank keeps E/ep of them. One all-to-all sends each expert's token slots to
  its rank, a second brings the results home (``collective.
  all_to_all_diff``, whose backward is the transposed exchange).
- Load-balance aux loss (Switch: E · Σ_e f_e·P_e) with the statistics
  averaged over the axis, so the loss is the same however the batch is
  sharded.

The JAX package runs the expert-parallel path as one ``shard_map`` body
over the global batch; the port runs the same body on each rank, where
``axis`` is the process group of the mesh dim (a ``(mesh, name)`` pair or a
group). Capacity comes from each rank's own tokens, as in the JAX package,
so the two paths agree while no token is dropped.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .collective import (all_to_all_diff, axis_index, axis_size, copy_to,
                         gather_along, pmean)


class GateOutput(NamedTuple):
    combine: torch.Tensor   # [N, E, C] float — combine weights (0 = dropped)
    dispatch: torch.Tensor  # [N, E, C] bool  — dispatch mask
    aux_loss: torch.Tensor  # []  load-balance loss
    probs: torch.Tensor     # [N, E] softmax router probabilities


def top_k_gating(x, gate_w, k: int = 2, capacity: int = 0,
                 capacity_factor: float = 1.25, renormalize: bool = True,
                 axis=None) -> GateOutput:
    """Static-capacity top-k router.

    x: [N, D] tokens, gate_w: [D, E]. Returns combine/dispatch tensors with
    a fixed per-expert capacity C (from capacity_factor when capacity is
    0). With `axis`, the aux-loss statistics are averaged over the axis so
    the loss matches the unsharded run."""
    n = x.shape[0]
    e = gate_w.shape[1]
    if capacity <= 0:
        capacity = max(1, int(math.ceil(k * n / e * capacity_factor)))
    c = capacity

    logits = x.float() @ gate_w.float()
    probs = torch.softmax(logits, dim=-1)                          # [N, E]
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)             # [N, k]
    if renormalize:
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(-1, keepdim=True), min=1e-9)

    # slot-major priority: every slot-0 assignment claims capacity before
    # any slot-1 assignment (GShard ordering)
    combine = x.new_zeros((n, e, c), dtype=torch.float32)
    counts = torch.zeros((e,), dtype=torch.int64, device=x.device)
    for j in range(k):
        onehot = F.one_hot(gate_idx[:, j], e)                      # [N, E]
        pos = torch.cumsum(onehot, 0) - onehot + counts[None, :]
        pos_j = (pos * onehot).sum(1)                              # [N]
        keep = pos_j < c
        counts = counts + onehot.sum(0)
        # a position past the capacity one-hots to nothing, as
        # jax.nn.one_hot does
        pos_oh = F.one_hot(pos_j.clamp(max=c), c + 1)[:, :c].float()
        combine = combine + (gate_vals[:, j] * keep)[:, None, None] \
            * onehot.float()[:, :, None] * pos_oh[:, None, :]
    dispatch = combine > 0.0

    # Switch load-balance loss on the top-1 assignment
    top1 = F.one_hot(gate_idx[:, 0], e).float()
    frac_tokens = top1.mean(0)                                     # f_e
    frac_probs = probs.mean(0)                                     # P_e
    if axis is not None:
        frac_tokens = pmean(frac_tokens, axis)
        frac_probs = pmean(frac_probs, axis)
    aux = e * torch.sum(frac_tokens * frac_probs)
    return GateOutput(combine.to(x.dtype), dispatch, aux, probs)


def _expert_ffn(h, w1, b1, w2, b2, act):
    """h: [E_local, C', D]; w1: [E_local, D, H]; w2: [E_local, H, D]."""
    u = torch.einsum("ecd,edh->ech", h, w1) + b1[:, None, :]
    u = act(u)
    return torch.einsum("ech,ehd->ecd", u, w2) + b2[:, None, :]


def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def moe_ffn(x, gate_w, w1, b1, w2, b2, k: int = 2,
            capacity_factor: float = 1.25, act=_gelu):
    """Dense (one device) MoE FFN. x: [N, D] → ([N, D], aux loss).

    gate_w: [D, E]; w1: [E, D, H]; b1: [E, H]; w2: [E, H, D]; b2: [E, D]."""
    gate = top_k_gating(x, gate_w, k=k, capacity_factor=capacity_factor)
    expert_in = torch.einsum("nec,nd->ecd", gate.dispatch.to(x.dtype), x)
    expert_out = _expert_ffn(expert_in, w1, b1, w2, b2, act)
    y = torch.einsum("nec,ecd->nd", gate.combine, expert_out)
    return y, gate.aux_loss


def moe_ffn_expert_parallel(x, gate_w, w1, b1, w2, b2, axis,
                            k: int = 2, capacity_factor: float = 1.25,
                            act=_gelu, local_experts: bool = False):
    """Expert-parallel MoE FFN on this rank's tokens x ([N/ep, D]) over
    `axis` (a ``(mesh, name)`` pair or a process group).

    The expert weights are the whole [E, ...] arrays (this rank takes its
    E/ep experts of them; their gradient is nonzero on that slice only and
    the data axis's gradient sum completes it), or, with
    `local_experts`, this rank's [E/ep, ...] slices already. Two
    all-to-alls move token slots to their experts' ranks and back;
    capacity comes from this rank's tokens."""
    ep = axis_size(axis)
    e = gate_w.shape[1]
    if e % ep != 0:
        raise ValueError(f"num experts {e} not divisible by mesh axis {ep}")
    if not local_experts:
        r, m = axis_index(axis), e // ep
        w1, b1, w2, b2 = (t[r * m:(r + 1) * m] for t in (w1, b1, w2, b2))
    gate = top_k_gating(x, gate_w, k=k, capacity_factor=capacity_factor,
                        axis=axis)
    exp_in = torch.einsum("nec,nd->ecd", gate.dispatch.to(x.dtype), x)
    # [E, C, D] → each rank keeps its E/ep experts with every rank's token
    # slots along capacity: [E/ep, C·ep, D]
    exp_in = all_to_all_diff(exp_in, axis, 0, 1)
    exp_out = _expert_ffn(exp_in, w1, b1, w2, b2, act)
    # home: [E/ep, C·ep, D] → [E, C, D]
    exp_out = all_to_all_diff(exp_out, axis, 1, 0)
    y = torch.einsum("nec,ecd->nd", gate.combine, exp_out)
    return y, gate.aux_loss


class _ScaleGrad(torch.autograd.Function):
    """The identity forward; the cotangent times `factor` backward."""

    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


def moe_ffn_ep_chunks(x, gate_w, w1, b1, w2, b2, axis, k: int = 2,
                      capacity_factor: float = 1.25, act=_gelu):
    """Expert-parallel MoE FFN over `axis` on tokens every rank of it
    holds whole (x: [N, D]; an ``ep`` axis that is not the data axis): the
    rank at coordinate j routes chunk j of N/ep tokens with the chunk's
    capacity (the JAX package's ``shard_map`` over ``P(axis)``), and the
    chunks' outputs are gathered whole. Returns ([N, D], aux loss).

    Every rank of the axis holds the whole inputs and outputs, each one
    the whole cotangent of them: the inputs and weights enter through
    ``copy_to`` (each rank's gradient is its chunk's part, summed over the
    axis), the output leaves through ``gather_along`` (each rank's chunk
    of the cotangent) and the aux loss with its cotangent divided among
    the ranks (``pmean``'s transpose sums their parts)."""
    ep = axis_size(axis)
    n = x.shape[0] // ep
    j = axis_index(axis)
    x, gate_w, w1, b1, w2, b2 = (copy_to(t, axis)
                                 for t in (x, gate_w, w1, b1, w2, b2))
    y, aux = moe_ffn_expert_parallel(
        x.narrow(0, j * n, n), gate_w, w1, b1, w2, b2, axis, k=k,
        capacity_factor=capacity_factor, act=act)
    return gather_along(y, 0, axis), _ScaleGrad.apply(aux, 1.0 / ep)


def init_moe_params(generator: Optional[torch.Generator], d_model: int,
                    d_hidden: int, num_experts: int, dtype=torch.float32,
                    device=None):
    """(gate_w, w1, b1, w2, b2), normal draws from `generator` scaled by
    1/√fan-in, zero biases."""
    s1 = 1.0 / math.sqrt(d_model)
    s2 = 1.0 / math.sqrt(d_hidden)

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device)

    return (normal(d_model, num_experts) * s1,
            normal(num_experts, d_model, d_hidden) * s1,
            torch.zeros((num_experts, d_hidden), dtype=dtype, device=device),
            normal(num_experts, d_hidden, d_model) * s2,
            torch.zeros((num_experts, d_model), dtype=dtype, device=device))


__all__ = ["GateOutput", "top_k_gating", "moe_ffn",
           "moe_ffn_expert_parallel", "moe_ffn_ep_chunks", "init_moe_params"]
