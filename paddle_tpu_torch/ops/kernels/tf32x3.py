"""A plain CPU model of the 3xTF32 arithmetic of the f32 kernels.

``csrc/tf32x3.cuh`` runs every f32 product of the f32 flash forwards and
backwards (the wide ones of ``flash_attention_wide.cu`` too) and of K4
(``fused_bn.cu``) on the tensor cores: each operand is
split into big = x rounded to TF32 and small = x − big, and big·small,
small·big and big·big are summed by ``mma.sync.m16n8k8``, whose sums round
toward zero. These functions compute the same arithmetic on the CPU, so the
tests can hold each kernel's design to the f32 tolerance of the card before
it runs there. Nothing in the port calls them.
"""
from __future__ import annotations

import torch


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as cvt.rna.tf32.f32 rounds it: nearest, ties away
    from zero (0x1000 added to the magnitude bits, the low 13 cleared)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32)


def trunc_tf32(x: torch.Tensor) -> torch.Tensor:
    """The TF32 value the tensor core reads from an f32 register: its low 13
    bits cleared."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def rz_f32(x: torch.Tensor) -> torch.Tensor:
    """f64 x rounded to f32 toward zero, as the tensor core rounds its
    sums."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(),
                       torch.nextafter(y, torch.zeros_like(y)), y)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor, partial_depth=None
              ) -> torch.Tensor:
    """a @ b as the kernels compute it on mma.sync.m16n8k8: each operand
    split into big = rna(x) and small = x − big (read by the tensor core as
    its top 11 bits); per 8-deep step, big·small, small·big and big·big
    each summed exactly and rounded toward zero into the running sum (one
    mma each). With `partial_depth`, the running sum starts from 0 every
    that many columns and is added to the f32 result with one
    round-to-nearest add; without, the whole depth is one running sum from
    0 (a flash output tile's partial sum)."""
    ab, bb = rna_tf32(a), rna_tf32(b)
    as_, bs = trunc_tf32(a - ab), trunc_tf32(b - bb)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    step = partial_depth or a.shape[-1]
    for k0 in range(0, a.shape[-1], step):
        t = torch.zeros_like(acc, dtype=torch.float64) if partial_depth \
            else acc.double()
        for k in range(k0, k0 + step, 8):
            for x, y in ((ab, bs), (as_, bb), (ab, bb)):
                t = rz_f32(t + x[..., k:k + 8].double()
                           @ y[..., k:k + 8, :].double()).double()
        acc = acc + t.float() if partial_depth else t.float()
    return acc


def _mm_3xtf32_pairs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in 3xTF32, 16 columns at a time: each 8-deep step's three
    products summed from 0 with round-toward-zero sums (one mma chain), the
    two steps of a 16-column pair added, and that added to the running f32
    sum (both round to nearest)."""
    ab, bb = rna_tf32(a), rna_tf32(b)
    as_, bs = trunc_tf32(a - ab), trunc_tf32(b - bb)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)

    def chain(k):
        t = torch.zeros_like(acc, dtype=torch.float64)
        for x, y in ((ab, bs), (as_, bb), (ab, bb)):
            t = rz_f32(t + x[..., k:k + 8].double()
                       @ y[..., k:k + 8, :].double()).double()
        return t.float()

    for k0 in range(0, a.shape[-1], 16):
        acc = acc + (chain(k0) + chain(k0 + 8))
    return acc


def mm_3xtf32_groups(a: torch.Tensor, b: torch.Tensor, groups: int = 4,
                     block: int = 64) -> torch.Tensor:
    """a @ b as the f32 wide flash kernels form S and dP, whose column warps
    split the depth: block j of `block` columns goes to group j % `groups`;
    each group is one running f32 sum over its blocks' columns in order, 16
    at a time, each 8-deep step's mma chain from 0 and the pair's two sums
    added before they join the running sum (_mm_3xtf32_pairs); the groups
    are added in one order, ((G0 + G1) + G2) + G3."""
    nblk = a.shape[-1] // block
    total = None
    for q in range(groups):
        cols = [c for j in range(q, nblk, groups)
                for c in range(block * j, block * (j + 1))]
        if not cols:
            continue
        idx = torch.tensor(cols)
        part = _mm_3xtf32_pairs(a[..., idx], b[..., idx, :])
        total = part if total is None else total + part
    return total
