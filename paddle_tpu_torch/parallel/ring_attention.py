"""Ring attention and Ulysses attention over a sequence axis (the port's
counterpart of ``paddle_tpu.parallel.ring_attention``).

Q/K/V are sharded along the sequence dim over the ``sp`` axis: rank
``idx`` holds rows ``[idx·Tl, (idx+1)·Tl)``. K/V blocks travel around the
ring while each rank merges the attention of its queries against the
block it holds, so the longest context grows with the ring.

- ``impl="plain"`` (the JAX package's ``"jnp"``) is the oracle
  (``_ring_attn_local``): f32 running max, denominator and output over
  einsum-style blocks; differentiable by autograd through ``ppermute``.
- ``impl="kernel"`` (the JAX package's ``"pallas"``) runs the flash
  kernels per block (``flash_block_fwd``/``flash_block_bwd``, kernel rows
  1–4 on the card, their plain versions on the CPU) inside one
  ``torch.autograd.Function``. The forward merges each block's normalized
  output by f32 log-sum-exp weights; the diagonal block is causal, earlier
  blocks dense, future blocks skipped. The next hop's K/V send is posted
  (``isend``/``irecv``) before the block's kernel. The backward reuses the
  dq/dk/dv kernels with the GLOBAL out and lse; the f32 dk/dv accumulators
  travel with their block and arrive home after N hops.
- ``impl="auto"`` takes the kernels where the JAX package's ``_pallas_ok``
  would take Pallas: on the card, for a local block of a power-of-two
  divisor ≥ 64 and a head dim that is a multiple of 64.

Each hop's work is a pure function of (rank, source block) —
``ring_fwd_hop`` and ``ring_bwd_hop`` — and ``ring_simulate`` /
``ring_simulate_bwd`` drive every (rank, hop) pair in one process, so a
single card can run exactly the code each rank runs.

``ulysses_attention`` exchanges sequence shards for head shards with an
all-to-all, attends whole sequences locally (``torch.matmul``, as the JAX
package's einsum) and exchanges back.
"""
from __future__ import annotations

import math
from typing import List

import torch
import torch.distributed as dist

from .collective import all_to_all_diff, axis_group, ppermute

__all__ = ["ring_self_attention", "ring_attention", "ulysses_attention",
           "ring_fwd_hop", "ring_bwd_hop", "ring_simulate",
           "ring_simulate_bwd", "resolve_impl"]

_NEG = -1e9


# -- one hop, pure ------------------------------------------------------------

def _oracle_block(qf, k, v, diag: bool, scale: float, future: bool):
    tl = qf.shape[2]
    s = torch.matmul(qf, k.float().transpose(-1, -2)) * scale
    if future:
        s = torch.full_like(s, _NEG) + 0.0 * s
    elif diag:
        pos = torch.arange(tl, device=qf.device)
        s = s.masked_fill(~(pos[:, None] >= pos[None, :]), _NEG)
    m_b = s.amax(-1, keepdim=True)
    p = torch.exp(s - m_b)
    return m_b, p.sum(-1, keepdim=True), torch.matmul(p, v.float())


def ring_fwd_hop(carry, q, k_cur, v_cur, idx: int, src: int, causal: bool,
                 impl: str):
    """Merge rank `idx`'s attention against source block `src` into
    `carry`. The kernel route's carry is (out, lse), f32, and it skips a
    future block under `causal`; the oracle's is (m, l, out), f32, and it
    computes a future block fully masked, which merges with weight exactly
    0 (every rank's graph then holds every hop, so each hop's backward
    exchange runs on every rank)."""
    if causal and src > idx and impl == "kernel":
        return carry
    diag = causal and src == idx
    scale = 1.0 / math.sqrt(q.shape[-1])
    if impl == "kernel":
        from ..ops.kernels.flash_attention import flash_block_fwd

        o_b, lse_b = flash_block_fwd(q, k_cur, v_cur, scale, diag)
        o_acc, lse_acc = carry
        o_b, lse_b = o_b.float(), lse_b.float()
        # o_b is block-normalized: the running form keeps o normalized
        # w.r.t. lse, so each merge is a convex combination
        m = torch.maximum(lse_acc, lse_b)
        w_acc = torch.exp(lse_acc - m)
        w_b = torch.exp(lse_b - m)
        denom = w_acc + w_b
        o = (o_acc * w_acc[..., None] + o_b * w_b[..., None]) \
            / denom[..., None]
        return o, m + torch.log(denom)
    m, l, o = carry
    m_b, l_b, o_b = _oracle_block(q.float(), k_cur, v_cur, diag, scale,
                                  future=causal and src > idx)
    m_new = torch.maximum(m, m_b)
    corr, corr_b = torch.exp(m - m_new), torch.exp(m_b - m_new)
    return m_new, l * corr + l_b * corr_b, o * corr + o_b * corr_b


def _fwd_init(q, impl: str):
    b, h, tl, d = q.shape
    if impl == "kernel":
        return (torch.zeros(b, h, tl, d, dtype=torch.float32,
                            device=q.device),
                torch.full((b, h, tl), _NEG, dtype=torch.float32,
                           device=q.device))
    return (torch.full((b, h, tl, 1), _NEG, dtype=torch.float32,
                       device=q.device),
            torch.zeros(b, h, tl, 1, dtype=torch.float32, device=q.device),
            torch.zeros(b, h, tl, d, dtype=torch.float32, device=q.device))


def _fwd_result(carry, q, impl: str):
    """(out in q's dtype, lse f32 or None)."""
    if impl == "kernel":
        o, lse = carry
        return o.to(q.dtype), lse
    m, l, o = carry
    return (o / torch.clamp_min(l, 1e-20)).to(q.dtype), None


def ring_bwd_hop(acc, q, k_cur, v_cur, out, lse, g, idx: int, src: int,
                 causal: bool):
    """Add rank `idx`'s block-`src` gradients (the per-block backward
    kernels, global out and lse) to `acc` = (dq, dk, dv), f32; a future
    block under `causal` adds nothing."""
    if causal and src > idx:
        return acc
    from ..ops.kernels.flash_attention import flash_block_bwd

    dqb, dkb, dvb = flash_block_bwd(q, k_cur, v_cur, g.to(q.dtype), lse,
                                    out, 1.0 / math.sqrt(q.shape[-1]),
                                    causal and src == idx)
    dq, dk, dv = acc
    return dq + dqb.float(), dk + dkb.float(), dv + dvb.float()


# -- one process over every (rank, hop) --------------------------------------

def ring_simulate(qs: List[torch.Tensor], ks: List[torch.Tensor],
                  vs: List[torch.Tensor], causal: bool, impl: str = "kernel"):
    """Every rank's forward in one process: at hop t rank idx holds block
    (idx − t) mod N, as on the ring. Returns [(out, lse)] a rank."""
    n = len(qs)
    carries = [_fwd_init(q, impl) for q in qs]
    for t in range(n):
        for idx in range(n):
            src = (idx - t) % n
            carries[idx] = ring_fwd_hop(carries[idx], qs[idx], ks[src],
                                        vs[src], idx, src, causal, impl)
    return [_fwd_result(c, q, impl) for c, q in zip(carries, qs)]


def ring_simulate_bwd(qs, ks, vs, outs, lses, gs, causal: bool):
    """Every rank's backward in one process (the kernel route): dq stays
    home, each block's dk/dv accumulate as it travels. Returns
    [(dq, dk, dv)] a rank, in the inputs' dtypes."""
    n = len(qs)
    dq = [torch.zeros_like(q, dtype=torch.float32) for q in qs]
    dkv = [(torch.zeros_like(k, dtype=torch.float32),
            torch.zeros_like(k, dtype=torch.float32)) for k in ks]
    for t in range(n):
        for idx in range(n):
            src = (idx - t) % n
            dq[idx], dk, dv = ring_bwd_hop(
                (dq[idx],) + dkv[src], qs[idx], ks[src], vs[src], outs[idx],
                lses[idx], gs[idx], idx, src, causal)
            dkv[src] = (dk, dv)
    return [(dq[i].to(qs[i].dtype), dkv[i][0].to(ks[i].dtype),
             dkv[i][1].to(vs[i].dtype)) for i in range(n)]


# -- on the ring ---------------------------------------------------------------

def _post(xs, group, n, me):
    """Post the send of `xs` to the next rank and the receive from the
    previous one; returns (receive buffers, requests)."""
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    xs = [x.contiguous() for x in xs]
    bufs = [torch.empty_like(x) for x in xs]
    ops = [dist.P2POp(dist.isend, x, nxt, group) for x in xs]
    ops += [dist.P2POp(dist.irecv, b, prv, group) for b in bufs]
    return bufs, dist.batch_isend_irecv(ops)


def _hop(xs, group, n, me):
    """Send `xs` one rank on and return what the previous rank sent."""
    if n == 1:
        return list(xs)
    bufs, reqs = _post(xs, group, n, me)
    for r in reqs:
        r.wait()
    return bufs


def _ring_attn_flash_local(q, k, v, group, causal: bool):
    """Rank-local kernel ring forward: (out, lse)."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    carry = _fwd_init(q, "kernel")
    k_cur, v_cur = k.contiguous(), v.contiguous()
    for t in range(n):
        src = (me - t) % n
        pending = None
        if t + 1 < n and n > 1:
            pending = _post([k_cur, v_cur], group, n, me)  # overlaps
        carry = ring_fwd_hop(carry, q, k_cur, v_cur, me, src, causal,
                             "kernel")
        if pending is not None:
            for r in pending[1]:
                r.wait()
            k_cur, v_cur = pending[0]
    return _fwd_result(carry, q, "kernel")


def _ring_flash_bwd_local(q, k, v, out, lse, g, group, causal: bool):
    """Rank-local kernel ring backward: (dq, dk, dv)."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    dq = torch.zeros_like(q, dtype=torch.float32)
    dk = torch.zeros_like(k, dtype=torch.float32)
    dv = torch.zeros_like(v, dtype=torch.float32)
    k_cur, v_cur = k.contiguous(), v.contiguous()
    for t in range(n):
        src = (me - t) % n
        dq, dk, dv = ring_bwd_hop((dq, dk, dv), q, k_cur, v_cur, out, lse,
                                  g, me, src, causal)
        if t + 1 < n:
            k_cur, v_cur = _hop([k_cur, v_cur], group, n, me)
        # the accumulators travel with their block; the last hop brings
        # each block's sums home
        dk, dv = _hop([dk, dv], group, n, me)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        out, lse = _ring_attn_flash_local(q, k, v, group, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal = group, causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _ring_flash_bwd_local(q, k, v, out, lse, g, ctx.group,
                                           ctx.causal)
        return dq, dk, dv, None, None


class _Shift(torch.autograd.Function):
    """One hop of the ring (``ppermute`` i → i+1), differentiable: the
    cotangent goes one hop back (``lax.ppermute``'s transpose)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def _shift(x, group, step: int):
    n = dist.get_world_size(group)
    return ppermute(x, group, [(i, (i + step) % n) for i in range(n)])


def _ring_attn_local(q, k, v, group, causal: bool):
    """Rank-local oracle (autograd differentiates it, hops included)."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    carry = _fwd_init(q, "plain")
    k_cur, v_cur = k, v
    for t in range(n):
        src = (me - t) % n
        carry = ring_fwd_hop(carry, q, k_cur, v_cur, me, src, causal,
                             "plain")
        if t + 1 < n:
            k_cur = _Shift.apply(k_cur, group)
            v_cur = _Shift.apply(v_cur, group)
    return _fwd_result(carry, q, "plain")[0]


def resolve_impl(impl: str, q_local) -> str:
    """"plain" or "kernel" for `impl` ("auto" decides as ``_pallas_ok``:
    the kernels on the card for a block of a power-of-two divisor ≥ 64
    and a head dim that is a multiple of 64)."""
    if impl == "auto":
        from ..ops.kernels.flash_attention import pick_block

        tl, d = q_local.shape[2], q_local.shape[-1]
        ok = (q_local.device.type == "cuda" and d % 64 == 0
              and (pick_block(tl) or 0) >= 64)
        return "kernel" if ok else "plain"
    if impl not in ("plain", "kernel"):
        raise ValueError(f"ring_self_attention: impl must be 'auto', "
                         f"'plain' or 'kernel' (the JAX package's 'jnp' and "
                         f"'pallas'), got {impl!r}")
    return impl


def _locals(mesh, axis, seq_dim, *xs):
    """This rank's sequence shards of `xs` (DTensors are redistributed to
    Shard(seq_dim) on `axis`; plain tensors are taken as the local shard),
    and whether the inputs were DTensors."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(xs[0], DTensor):
        return list(xs), False
    names = list(mesh.mesh_dim_names)
    place = [Replicate()] * mesh.ndim
    place[names.index(axis)] = Shard(seq_dim)
    return [x.redistribute(mesh, place).to_local() for x in xs], True


def _wrap(local, mesh, axis, seq_dim, as_dtensor):
    if not as_dtensor:
        return local
    from torch.distributed.tensor import DTensor, Replicate, Shard

    names = list(mesh.mesh_dim_names)
    place = [Replicate()] * mesh.ndim
    place[names.index(axis)] = Shard(seq_dim)
    return DTensor.from_local(local, mesh, place, run_check=False)


def ring_self_attention(q, k, v, mesh, axis: str = "sp",
                        causal: bool = False, impl: str = "auto"):
    """q/k/v [B, H, T, D] with T sharded over `axis`: DTensors (the result
    is a DTensor sharded the same way) or this rank's local shards (the
    result is this rank's shard of the output)."""
    group = axis_group((mesh, axis))
    (ql, kl, vl), as_dt = _locals(mesh, axis, 2, q, k, v)
    route = resolve_impl(impl, ql)
    if route == "kernel":
        out = _RingFlash.apply(ql, kl, vl, group, causal)
    else:
        out = _ring_attn_local(ql, kl, vl, group, causal)
    return _wrap(out, mesh, axis, 2, as_dt)


ring_attention = ring_self_attention


def ulysses_attention(q, k, v, mesh, axis: str = "sp", causal: bool = False):
    """Ulysses decomposition: the all-to-all turns sequence shards into head
    shards ([B, H/n, T, D]), attention runs whole locally, and a second
    all-to-all turns the result back. Needs num_heads % axis size == 0."""
    group = axis_group((mesh, axis))
    (ql, kl, vl), as_dt = _locals(mesh, axis, 2, q, k, v)
    qg, kg, vg = (all_to_all_diff(x.contiguous(), group, 1, 2)
                  for x in (ql, kl, vl))
    scale = 1.0 / math.sqrt(qg.shape[-1])
    s = torch.matmul(qg, kg.transpose(-1, -2)) * scale
    if causal:
        t = s.shape[-1]
        keep = torch.ones(t, t, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, _NEG)
    og = torch.matmul(torch.softmax(s, dim=-1), vg)
    out = all_to_all_diff(og.contiguous(), group, 2, 1)
    return _wrap(out, mesh, axis, 2, as_dt)
