"""Flash attention, forward and backward: hand-written Hopper kernels, their
plain versions, and the autograd function that joins them.

Replaces the TPU kernels of ``paddle_tpu/ops/pallas_kernels/flash_attention.py``:

- forward: ``_fwd_kernel`` (via ``_flash_fwd_pallas``) and
  ``_fwd_kernel_onepass`` (via ``_flash_fwd_pallas_onepass``), reached through
  ``_flash_fwd_dispatch``; CUDA source ``csrc/flash_attention_fwd.cu``.
- backward: ``_bwd_dq_kernel`` + ``_bwd_dkv_kernel`` (via
  ``_flash_bwd_pallas``) and ``_bwd_kernel_onepass`` (via
  ``_flash_bwd_pallas_onepass``); CUDA source ``csrc/flash_attention_bwd.cu``.

Each source's header says how it is laid out for the card and what bounds it.

- ``flash_attention_fwd_plain`` / ``flash_attention_bwd_plain`` are the plain
  PyTorch versions with the JAX package's edge semantics: masked scores are
  -1e30, the running max starts at -1e30, a zero row sum divides by 1,
  lse = m + log(l); the backward mirrors ``_flash_bwd_jax`` (delta = Σ dO·out,
  p recomputed from lse, ds = p·(dp − delta), operands rounded to the input
  dtype where the TPU kernels round them, f32 accumulation). The CPU tests use
  them; on the card they are the kernels' yardstick.
  ``flash_attention_ds_f64`` is the backward's ds in f64, the yardstick of an
  f32 per-query dbias.
- ``flash_attention_fwd`` / ``flash_attention_bwd`` are the wrappers.
  ``flash_route`` decides from the shape, dtype and device type, as the JAX
  package's ``_pallas_ok`` does: a CPU tensor takes the plain version; on
  the card a head dim that is not a multiple of 64 takes the plain version
  (the JAX package's XLA path; counted in ``.plain_on_cuda``) and every
  multiple of 64 launches a kernel: d = 64, 128, 192 or 256 the tuned
  family, a larger one the wide kernels of ``csrc/flash_attention_wide.cu``
  (shared memory that does not grow with d). A launch that fails raises:
  there is no fallback. Each counts its calls that launch in ``.launches``
  (the backward's delta, dq and dk/dv kernels count one), those on the wide
  kernels also in ``.wide_launches``.
- ``flash_attention_delta_plain`` is ``_bwd_host_prep``'s delta; on the
  card both backwards compute it with a kernel of their own
  (``flash_attention_delta``), so the plain version serves the CPU and the
  checks.
- bf16 tensors reach the kernels through TMA tensor maps (``_tma_desc``:
  dims and byte strides; a tensor off the 16-byte grid is copied first), the
  bias as its compact broadcast shape (``_bias_tile``), lse and delta as
  rows on the 16-byte grid (``_padded_rows``).
- ``_FlashAttention`` is the ``torch.autograd.Function`` that joins them, as
  ``_flash_core``'s ``custom_vjp`` does in the JAX package. The public
  entries (``flash_attention_packed``, ``flash_attention``) raise the JAX
  entries' ``ValueError`` for a sequence length with no power-of-two block
  divisor ≥ 8 (``check_block_divisor``); the wrappers take any T.

Attention dropout: the keep bit of score (bh, i, j) is a pure function of
(seed, bh, i, j): word j % 4 of Philox-4x32-10 with key (seed mod 2³², seed >>
32) and counter (j // 4, i, bh, 0), kept iff it is ≥ round(rate·2³²) (the JAX
rule, ``_keep_mask``), and a kept p is scaled by 1/(1 − rate). The indices are
the whole run's: `seed` may be the kernels' key ``[seed, heads_total, head0,
row0]`` (``dropout_key``), and a call over nh heads of its own then
draws the bits of (b·heads_total + head0 + h, row0 + i, j): a rank's
heads on a model axis, or its rows on a sequence axis, get the unsharded
run's mask (heads_total 0 means nh; a plain seed means no offsets). The
kernels and the plain versions draw the same mask bit for bit, whatever
their tiling. The TPU kernels' core-PRNG bits cannot be reproduced, so
dropout is never compared bit for bit with the JAX package. lse is taken
over the undropped p.

Tensors are [B, nh, T, d] views with a contiguous head dim, so the packed
[B, T, nh·d] layout is read in place (the TPU needed head fold/unfold copies
only because Mosaic cannot take a 64-wide minor block).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ...observability import kernel_counts

NEG_INF = -1e30
# the tuned kernels' head dims; the wide kernels take the other multiples
# of 64
HEAD_DIMS = (64, 128, 192, 256)
# _pick_blocks' block candidates in the JAX package: every one is a
# multiple of 8, so a length has one iff it is a multiple of 8
_BLOCKS = (512, 256, 128, 64, 32, 16, 8)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_M32 = 0xFFFFFFFF

# Philox-4x32-10 constants (Salmon et al., SC'11; Random123)
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of a·m for int64 tensors a < 2³² and a 32-bit
    constant m, without overflowing int64: m is split into 16-bit halves."""
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _M32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox-4x32-10 on int64 tensors holding 32-bit counter words
    (broadcastable); the key is two 32-bit ints. Returns the 4 output words
    as int64 tensors. The CUDA kernels run the same rounds (csrc/philox.cuh)."""
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _M32
            k1 = (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_threshold(rate: float) -> int:
    """Drop iff the 32-bit word is below this (``_keep_mask``'s rule)."""
    return int(round(rate * 4294967296.0)) & _M32


def _seed_int(seed) -> int:
    return int(seed.reshape(-1)[0]) if isinstance(seed, torch.Tensor) \
        else int(seed)


_KEY_TAILS = {}


def dropout_key(seed, heads_total: int = 0, head0: int = 0,
                row0: int = 0) -> torch.Tensor:
    """A dropout key: int64 ``[seed, heads_total, head0, row0]`` on
    `seed`'s device (see the module docstring), carrying the three offsets
    on the host too (``.drop_offsets``: what the kernels' C entries take,
    with no device read). `seed` is an int or a tensor whose first element
    is the seed; the offsets' words are cached on each device, so a key
    made on the card costs one concatenation and no host copy."""
    offs = (heads_total, head0, row0)
    if not isinstance(seed, torch.Tensor):
        key = torch.tensor([int(seed), *offs], dtype=torch.int64)
    else:
        s = seed.reshape(-1)[:1].to(torch.int64)
        tail = _KEY_TAILS.get((s.device, offs))
        if tail is None:
            tail = _KEY_TAILS[(s.device, offs)] = torch.tensor(
                offs, dtype=torch.int64, device=s.device)
        key = torch.cat([s, tail])
    key.drop_offsets = offs
    return key


def _offsets(seed):
    """(heads_total, head0, row0) of a key, or None for a seed."""
    got = getattr(seed, "drop_offsets", None)
    if got is not None:
        return tuple(got)
    if isinstance(seed, torch.Tensor) and seed.numel() >= 4:
        return tuple(int(v) for v in seed.reshape(-1)[1:4].tolist())
    return None


def _key_parts(seed):
    """(seed, heads_total, head0, row0) of a seed or a key."""
    return (_seed_int(seed),) + (_offsets(seed) or (0, 0, 0))


def dropout_keep_mask(seed, rate: float, b: int, nh: int, tq: int, tk: int,
                      device=None) -> torch.Tensor:
    """The [B, nh, Tq, Tk] keep mask of attention dropout, in plain PyTorch
    integer arithmetic; the kernels draw the same bits. `seed` may be a key
    (``dropout_key``): the mask is then the (b, head0.., row0..) slice of
    the whole run's."""
    s, ht, h0, r0 = _key_parts(seed)
    ht = ht or nh
    dev = torch.device(device or "cpu")
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=dev)
    j4 = (tk + 3) // 4
    bh = (ar(b)[:, None] * ht + h0 + ar(nh)[None, :]).reshape(-1)
    words = philox4x32(ar(j4)[None, None, :],
                       (ar(tq) + r0)[None, :, None],
                       bh[:, None, None],
                       torch.zeros((), dtype=torch.int64, device=dev),
                       s & _M32, (s >> 32) & _M32)
    words = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    bits = words.reshape(b * nh, tq, 4 * j4)[..., :tk]
    return (bits >= dropout_threshold(rate)).reshape(b, nh, tq, tk)


def _scores(q, k, bias, causal, sm_scale, dtype=torch.float32):
    s = torch.matmul(q.to(dtype), k.to(dtype).transpose(-1, -2)) * sm_scale
    if bias is not None:
        s = s + bias.to(dtype)
    if causal:
        tq, tk = s.shape[-2:]
        keep = torch.ones(tq, tk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    return s


def _dropped(x, keep, rate):
    return torch.where(keep, x * (1.0 / (1.0 - rate)), torch.zeros_like(x))


def flash_attention_fwd_plain(q, k, v, bias=None, causal: bool = False,
                              sm_scale: Optional[float] = None,
                              dropout_rate: float = 0.0, seed=0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """softmax(q·kᵀ·sm_scale + bias [, causal]) [, dropout] · v in plain
    PyTorch.

    q [B, nh, Tq, d], k/v [B, nh, Tk, d]; bias broadcastable to
    [B, nh, Tq, Tk]. Scores, sums and lse are f32; p is rounded to v's dtype
    before p·v, as the TPU kernels do. Returns (out [B, nh, Tq, d] in q's
    dtype, lse [B, nh, Tq] f32)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = _scores(q, k, bias, causal, sm_scale)
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    if dropout_rate > 0.0:
        b, nh, tq, tk = s.shape
        p = _dropped(p, dropout_keep_mask(seed, dropout_rate, b, nh, tq, tk,
                                          q.device), dropout_rate)
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / l_safe
    return out.to(q.dtype), (m + torch.log(l_safe)).squeeze(-1)


def flash_attention_delta_plain(out, g) -> torch.Tensor:
    """delta = Σ_d dO·out in f32 ([B, nh, T]), as ``_bwd_host_prep``
    computes it; the backward's delta kernel computes the same from the
    f32 or bf16 tensors."""
    return (g.float() * out.float()).sum(-1)


def flash_attention_bwd_plain(q, k, v, out, lse, g, bias=None,
                              causal: bool = False,
                              sm_scale: Optional[float] = None,
                              dropout_rate: float = 0.0, seed=0,
                              dbias: Optional[str] = None):
    """The flash backward in plain PyTorch, mirroring ``_flash_bwd_jax``.

    delta = Σ dO·out; p = exp(s − lse); dv = p_dropᵀ·dO; dp = dO·vᵀ
    (drop-scaled); ds = p·(dp − delta); dq = ds·k·scale; dk = dsᵀ·q·scale.
    p_drop, ds and dO are rounded to q's dtype before their products, the
    accumulation is f32. `dbias` is None, "per_q" ([B, nh, Tq, Tk] f32, ds
    itself) or "col" ([B, nh, Tk] f32, ds summed over the queries).
    Returns (dq, dk, dv, dbias) with dq/dk/dv in the input dtypes."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    cdt = q.dtype
    gc = g.to(cdt).float()
    delta = flash_attention_delta_plain(out, g)[..., None]
    p = torch.exp(_scores(q, k, bias, causal, sm_scale) - lse[..., None])
    dp = torch.matmul(gc, v.to(cdt).float().transpose(-1, -2))
    p_d = p
    if dropout_rate > 0.0:
        b, nh, tq, tk = p.shape
        keep = dropout_keep_mask(seed, dropout_rate, b, nh, tq, tk, q.device)
        p_d = _dropped(p, keep, dropout_rate)
        dp = _dropped(dp, keep, dropout_rate)
    dv = torch.matmul(p_d.to(cdt).float().transpose(-1, -2), gc)
    ds = p * (dp - delta)
    ds_c = ds.to(cdt).float()
    dk = torch.matmul(ds_c.transpose(-1, -2), q.float()) * sm_scale
    dq = torch.matmul(ds_c, k.float()) * sm_scale
    db = {None: None, "per_q": ds, "col": ds.sum(-2)}[dbias]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), db


def flash_attention_ds_f64(q, k, v, out, lse, g, bias=None,
                           causal: bool = False,
                           sm_scale: Optional[float] = None,
                           dropout_rate: float = 0.0, seed=0) -> torch.Tensor:
    """ds = p·(dp − delta), the plain backward's per-query dbias, with every
    product and sum in f64 from the given tensors ([B, nh, Tq, Tk] f64).

    The reference for a per-query dbias (f32 whatever the inputs' dtype):
    flash_attention_bwd_plain takes dp and delta in f32, and where the two
    cancel (a causal row that sees one key, p = 1) its dp is off by more
    than the f32 tolerance at d = 512 on f32 inputs and at d = 1024 on bf16
    ones."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    f64 = torch.float64
    p = torch.exp(_scores(q, k, bias, causal, sm_scale, f64)
                  - lse.to(f64)[..., None])
    dp = torch.matmul(g.to(f64), v.to(f64).transpose(-1, -2))
    if dropout_rate > 0.0:
        b, nh, tq, tk = p.shape
        keep = dropout_keep_mask(seed, dropout_rate, b, nh, tq, tk, q.device)
        dp = _dropped(dp, keep, dropout_rate)
    return p * (dp - (out.to(f64) * g.to(f64)).sum(-1, keepdim=True))


def _check(q, k, v, bias, name="flash_attention_fwd"):
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: q, k, v on different devices "
                         f"({q.device}, {k.device}, {v.device})")
    if q.dtype not in _DTYPE_CODE or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{name}: q, k, v must share one dtype of "
                        f"float32/bfloat16, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"{name}: q, k, v must be [B, nh, T, d]")
    b, nh, _, d = q.shape
    if (k.shape[:2] != (b, nh) or k.shape[-1] != d or v.shape != k.shape):
        raise ValueError(f"{name}: shapes do not match: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if bias is not None and bias.device != q.device:
        raise ValueError(f"{name}: bias on {bias.device}, q on {q.device}")


def _check_rate(dropout_rate: float):
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"flash_attention: dropout_rate must be in [0, 1), "
                         f"got {dropout_rate}")


def flash_route(q_shape, dtype, device_type: str) -> str:
    """Where a call on q of `q_shape` ([B, nh, Tq, d]), `dtype` and device
    type goes: "kernel", "plain", or a ValueError before any launch.

    A CPU tensor takes the plain version. On the card the head dim decides,
    as ``_pallas_ok`` decides in the JAX package: d % 64 != 0 takes the plain
    version (the JAX package's blockwise XLA path), every multiple of 64 a
    kernel (the tuned family for d in HEAD_DIMS, the wide kernels above
    them). B·nh has no limit: the grids are flat."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention: no kernel for dtype {dtype}")
    if device_type == "cpu":
        return "plain"
    if device_type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device type "
                         f"{device_type}")
    return "plain" if q_shape[-1] % 64 else "kernel"


def pick_block(t: int) -> Optional[int]:
    """The largest of _pick_blocks' candidates dividing t, or None."""
    return next((b for b in _BLOCKS if t % b == 0), None)


def check_block_divisor(t: int, name: str) -> None:
    """The JAX entries' raise (``_flash_fwd_dispatch``,
    ``_flash_sparse_fwd_dispatch``) for a sequence length that has no
    power-of-two block divisor ≥ 8, on either device, before any launch."""
    if pick_block(t) is None:
        raise ValueError(f"{name}: seq len {t} has no power-of-two block "
                         f"divisor ≥8; pad the sequence")


def _use_kernel(fn, q) -> bool:
    """flash_route for q; a plain call on the card is counted on `fn`."""
    route = flash_route(q.shape, q.dtype, q.device.type)
    if route == "plain" and q.device.type == "cuda":
        fn.plain_on_cuda += 1
    return route == "kernel"


def _bias_bytes(bias) -> int:
    return 0 if bias is None else bias.numel() * bias.element_size()


def fwd_counts(q, k, bias=None) -> Tuple[float, int]:
    """(flops, bytes) of one attention forward launch: QKᵀ and PV,
    4·B·nh·Tq·Tk·d flops; q, k, v read and out written once, the f32 lse
    written, the bias read once. The chip check's bound and the perf
    ledger's declared count read this."""
    b, nh, tq, d = q.shape
    tk = k.shape[2]
    return (4.0 * b * nh * tq * tk * d,
            (2 * tq + 2 * tk) * b * nh * d * q.element_size()
            + b * nh * tq * 4 + _bias_bytes(bias))


def bwd_counts(q, k, bias=None) -> Tuple[float, int]:
    """(flops, bytes) of one attention backward launch: S, dP, dV, dK, dQ,
    10·B·nh·Tq·Tk·d flops; q, k, v, out, dO read and dq, dk, dv written
    once, lse read and delta written (f32), the bias read once."""
    b, nh, tq, d = q.shape
    tk = k.shape[2]
    return (10.0 * b * nh * tq * tk * d,
            (4 * tq + 4 * tk) * b * nh * d * q.element_size()
            + 2 * b * nh * tq * 4 + _bias_bytes(bias))


def launch_kernels(entry: str, dtype, d: int, sparse: bool = False):
    """(row name, base names of the CUDA kernels) of one launch of the
    `entry` ("fwd" or "bwd") wrapper at this dtype and head dim."""
    t = "bf16" if dtype == torch.bfloat16 else "f32"
    wide = d not in HEAD_DIMS
    row = (f"flash_attention{'_sparse' if sparse else ''}_{entry}"
           f"[{t}{',wide' if wide else ''}]")
    if entry == "fwd":
        if wide:
            return row, (f"wide_fwd_{t}_kernel",)
        return row, (f"{'sparse' if sparse else 'flash'}_fwd_{t}_kernel",)
    if wide:
        return row, (("flash_bwd_delta_kernel", "wide_bwd_bf16_kernel")
                     if t == "bf16" else
                     ("flash_bwd_delta_kernel", "wide_role_f32_kernel",
                      "wide_bwd_f32_kernel"))
    if sparse:
        return row, ("flash_bwd_delta_kernel", f"sparse_bwd_{t}_kernel")
    if t == "bf16":
        return row, ("flash_bwd_delta_kernel", "flash_bwd_dq_bf16_kernel",
                     "flash_bwd_dkv_bf16_kernel")
    return row, ("flash_bwd_delta_kernel", "flash_bwd_f32_kernel")


def _declare(entry, q, counts, sparse=False):
    row, kernels = launch_kernels(entry, q.dtype, q.shape[-1], sparse)
    kernel_counts.declare(row, kernels, *counts)


def flash_attention_fwd(q, k, v, bias=None, causal: bool = False,
                        sm_scale: Optional[float] = None,
                        dropout_rate: float = 0.0, seed=0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention forward: the plain version for a CPU tensor or a head dim
    `flash_route` sends there, else the Hopper kernel (or an error; never a
    fallback). Same arguments and results as `flash_attention_fwd_plain`;
    `seed` is an int or a one-element int64 tensor (on the card it stays
    there: the kernel reads it, so drawing it needs no host sync)."""
    _check(q, k, v, bias)
    _check_rate(dropout_rate)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if not _use_kernel(flash_attention_fwd, q):
        return flash_attention_fwd_plain(q, k, v, bias, causal, sm_scale,
                                         dropout_rate, seed)
    if kernel_counts.active():
        _declare("fwd", q, fwd_counts(q, k, bias))
    if q.shape[-1] not in HEAD_DIMS:
        return launch_wide_fwd(flash_attention_fwd, q, k, v, bias, None,
                               None, causal, sm_scale, dropout_rate, seed)
    if q.dtype == torch.bfloat16:
        return _launch_fwd_bf16(q, k, v, bias, causal, sm_scale, dropout_rate,
                                seed)
    return _launch_fwd_f32(q, k, v, bias, causal, sm_scale, dropout_rate,
                           seed)


flash_attention_fwd.launches = 0
flash_attention_fwd.wide_launches = 0
flash_attention_fwd.plain_on_cuda = 0


def flash_attention_bwd(q, k, v, out, lse, g, bias=None, causal: bool = False,
                        sm_scale: Optional[float] = None,
                        dropout_rate: float = 0.0, seed=0,
                        dbias: Optional[str] = None):
    """Attention backward: routed as `flash_attention_fwd`; on the card the
    Hopper kernels (the delta kernel, the dq kernel and the dk/dv kernel,
    counted as one launch), or an error. Same arguments and results as
    `flash_attention_bwd_plain`."""
    _check(q, k, v, bias, "flash_attention_bwd")
    _check_rate(dropout_rate)
    if dbias not in (None, "per_q", "col"):
        raise ValueError(f"flash_attention_bwd: dbias must be None, 'per_q' "
                         f"or 'col', got {dbias!r}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if not _use_kernel(flash_attention_bwd, q):
        return flash_attention_bwd_plain(q, k, v, out, lse, g, bias, causal,
                                         sm_scale, dropout_rate, seed, dbias)
    if kernel_counts.active():
        _declare("bwd", q, bwd_counts(q, k, bias))
    if q.shape[-1] not in HEAD_DIMS:
        return launch_wide_bwd(flash_attention_bwd, q, k, v, out, lse, g,
                               bias, None, None, causal, sm_scale,
                               dropout_rate, seed, dbias)
    if q.dtype == torch.bfloat16:
        return _launch_bwd_bf16(q, k, v, out, lse, g, bias, causal, sm_scale,
                                dropout_rate, seed, dbias)
    return _launch_bwd_f32(q, k, v, out, lse, g, bias, causal, sm_scale,
                           dropout_rate, seed, dbias)


flash_attention_bwd.launches = 0
flash_attention_bwd.wide_launches = 0
flash_attention_bwd.plain_on_cuda = 0


def flash_block_fwd(q, k, v, sm_scale: Optional[float] = None,
                    causal: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ring's per-block forward (JAX ``_flash_fwd_dispatch`` with no
    bias and no dropout): (out, lse) of q against one resident K/V block,
    on the rows 1–2 kernels for a CUDA tensor and the plain version for a
    CPU one. A sequence length with no power-of-two block divisor ≥ 8
    raises, as the JAX entry does."""
    check_block_divisor(q.shape[2], "flash_attention")
    return flash_attention_fwd(q, k, v, None, causal, sm_scale, 0.0, 0)


def flash_block_bwd(q, k, v, g, lse, out, sm_scale: Optional[float] = None,
                    causal: bool = False):
    """The ring's per-block backward (JAX ``_flash_bwd_block_dispatch``):
    (dq, dk, dv) of one K/V block on the rows 3–4 kernels (the plain
    version on the CPU), given the GLOBAL `lse` and `out` of q's rows. The
    kernels' delta = Σ dO·out is then the global one and p = exp(s − lse)
    is the block's share of the global softmax, so the block's
    contributions sum to the exact gradient."""
    dq, dk, dv, _ = flash_attention_bwd(q, k, v, out, lse, g, None, causal,
                                        sm_scale, 0.0, 0)
    return dq, dk, dv


def flash_attention_delta(out, g) -> torch.Tensor:
    """delta = Σ_d dO·out ([B, nh, T] f32): the backward's first kernel for
    f32 or bf16 CUDA tensors, the plain version for CPU tensors; another
    dtype or device raises. `flash_attention_bwd` runs the kernel itself;
    this entry lets a check hold it against `flash_attention_delta_plain`.
    Its own launches count in ``.launches``."""
    if out.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention_delta: no kernel for dtype "
                        f"{out.dtype}")
    if out.device.type == "cpu":
        return flash_attention_delta_plain(out, g)
    if out.device.type != "cuda":
        raise ValueError(f"flash_attention_delta: the kernel takes CUDA "
                         f"tensors, got {out.device}")
    b, nh, t, _ = out.shape
    out, g = (x if _kernel_layout_ok(x) else x.contiguous()
              for x in (out, g.to(out.dtype)))
    with torch.cuda.device(out.device):
        rows = _launch_delta(out, g, torch.cuda.current_stream(
            out.device).cuda_stream)
    flash_attention_delta.launches += 1
    return rows[:, :t].view(b, nh, t)


flash_attention_delta.launches = 0


# ---------------------------------------------------------------------------
# Kernel launches (ctypes; the libraries are built at first use)
# ---------------------------------------------------------------------------

_PTR, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_U32, _F32 = ctypes.c_uint, ctypes.c_float
# seed pointer, threshold, 1/(1 - rate), dropout on, offsets (NULL or a
# host int[3]: heads_total, head0, row0; csrc/philox.cuh set_offsets)
_DROPOUT_ARGS = [_PTR, _U32, _F32, _I32, _PTR]
_DESC_LEN = 8  # csrc/hopper.cuh kDescLen


def _bind(lib_name, fn_name, argtypes):
    from . import build

    lib = build.load(lib_name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _kernel_layout_ok(t) -> bool:
    vec = 16 // t.element_size()  # the f32 kernels load 16-byte vectors
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % vec == 0 for s in t.stride()[:3]))


def _tma_desc(t) -> Optional[list]:
    """How the bf16 kernels' TMA reads the 4-D tensor t in place: [data
    pointer, the 4 dims innermost first, the byte strides of dims 1..3], as
    csrc/hopper.cuh's make_map takes it. None where TMA cannot: a last dim
    that is not contiguous, a base or a stride off the 16-byte grid, or a
    stride of 0 on a dim longer than 1. A dim of size 1 is given the stride a
    contiguous tensor would have (TMA never steps along it)."""
    if t.ndim != 4 or t.stride(-1) != 1 or t.data_ptr() % 16:
        return None
    es = t.element_size()
    strides, span = [], t.shape[3] * es
    for ax in (2, 1, 0):
        n, s = t.shape[ax], t.stride(ax) * es
        if n == 1:
            s = -(-span // 16) * 16
        elif s <= 0 or s % 16 or s >= 1 << 40:
            return None
        strides.append(s)
        span = s * n
    return [t.data_ptr(), t.shape[3], t.shape[2], t.shape[1], t.shape[0],
            *strides]


def _padded_rows(x, rows: int, cols: int):
    """x (rows·cols f32 values, row-major) as a [1, 1, rows, cols] view whose
    rows start on the 16-byte grid, as TMA reads them; copied only when x's
    own layout is not one."""
    try:
        v = x.view(1, 1, rows, cols)
        if _tma_desc(v) is not None:
            return v
    except RuntimeError:
        pass
    buf = torch.empty((rows, -(-cols // 4) * 4), dtype=x.dtype,
                      device=x.device)[:, :cols]
    buf.copy_(x.reshape(rows, cols))
    return buf.view(1, 1, rows, cols)


def _bias_tile(bias, q, tq, tk):
    """(mode, description, tensor) of the additive bias for the bf16
    kernels. Mode 0 = none, 1 = one row of Tk for every query (the BERT
    mask), 2 = a row per query. The tensor keeps its broadcast dims at size
    1, so the mask is read per batch; it is copied only to put its rows on
    the 16-byte grid TMA reads (a ragged Tk, a broadcast key dim)."""
    if bias is None:
        return 0, [0] * _DESC_LEN, None
    b, nh = q.shape[:2]
    bias = bias.to(q.dtype)
    bias = bias.reshape((1,) * (4 - bias.ndim) + tuple(bias.shape))
    if any(n not in (1, want) for n, want in zip(bias.shape,
                                                  (b, nh, tq, tk))):
        raise ValueError(f"flash_attention: bias of shape {tuple(bias.shape)}"
                         f" does not broadcast to {(b, nh, tq, tk)}")
    for ax in range(3):  # an expanded dim is read as the one row it repeats
        if bias.stride(ax) == 0:
            bias = bias.narrow(ax, 0, 1)
    bias = bias.expand(*bias.shape[:3], tk)
    desc = _tma_desc(bias)
    if desc is None:
        pad = torch.empty((*bias.shape[:3], -(-tk // 8) * 8),
                          dtype=bias.dtype, device=bias.device)[..., :tk]
        bias = pad.copy_(bias)
        desc = _tma_desc(bias)
    return (2 if bias.shape[2] > 1 else 1), desc, bias


def _descs(*tensors):
    return (ctypes.c_longlong * (_DESC_LEN * len(tensors)))(
        *(x for t in tensors for x in t))


def _packed_like(b, nh, t, d, dtype, device):
    """An empty [B, nh, T, d] view of [B, T, nh, d] memory: the packed layout
    the next op reads without a copy."""
    return torch.empty((b, t, nh, d), dtype=dtype,
                       device=device).transpose(1, 2)


def _dropout_args(q, dropout_rate, seed):
    """(seed pointer, threshold, 1/(1 − rate), on, offsets pointer, what
    keeps them alive): the seed word on q's device and the key's offsets
    (``dropout_key``) as a host int[3], NULL for a plain seed."""
    if dropout_rate <= 0.0:
        return None, 0, 1.0, 0, None, None
    offs = _offsets(seed)
    if isinstance(seed, torch.Tensor):
        seed_t = seed.to(device=q.device, dtype=torch.int64).reshape(-1)[:1]
    else:
        seed_t = torch.tensor([int(seed)], dtype=torch.int64, device=q.device)
    arr = (ctypes.c_int * 3)(*offs) if offs is not None else None
    return (seed_t.data_ptr(), dropout_threshold(dropout_rate),
            1.0 / (1.0 - dropout_rate), 1,
            ctypes.addressof(arr) if arr is not None else None,
            (seed_t, arr))


def _bias_args(bias, q, tq, tk):
    b, nh = q.shape[:2]
    if bias is None:
        return None, (0, 0, 0, 0), None
    bias = bias.to(q.dtype).expand(b, nh, tq, tk)
    return bias.data_ptr(), bias.stride(), bias


def _raise_on(lib, err, name):
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed: "
                           f"{lib.flash_attention_error_string(err).decode()}")


def _layout_error(name, which, t, needs):
    return ValueError(f"{name}: {which} needs {needs}; got strides "
                      f"{t.stride()}")


def _launch_fwd_f32(q, k, v, bias, causal, sm_scale, dropout_rate, seed):
    b, nh, tq, d = q.shape
    tk = k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not _kernel_layout_ok(t):
            raise _layout_error(
                "flash_attention_fwd", name, t, "a contiguous head dim, a "
                "16-byte aligned base and strides that are multiples of 16 "
                "bytes")
    out = _packed_like(b, nh, tq, d, q.dtype, q.device)
    lse = torch.empty((b, nh, tq), dtype=torch.float32, device=q.device)
    bias_ptr, bias_strides, _bias = _bias_args(bias, q, tq, tk)
    seed_ptr, thr, inv, drop, offs, _k = _dropout_args(q, dropout_rate, seed)
    lib = _bind("flash_attention_fwd", "flash_attention_fwd_f32",
                [_PTR] * 6 + [_I32] * 5 + [_I64] * 16 + [_F32, _I32]
                + _DROPOUT_ARGS + [_PTR])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr,
            out.data_ptr(), lse.data_ptr(), b, nh, tq, tk, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], *bias_strides, float(sm_scale), int(causal),
            seed_ptr, thr, inv, drop, offs, stream)
    _raise_on(lib, err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


def _launch_fwd_bf16(q, k, v, bias, causal, sm_scale, dropout_rate, seed):
    b, nh, tq, d = q.shape
    tk = k.shape[2]
    descs = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        desc = _tma_desc(t)
        if desc is None:
            raise _layout_error(
                "flash_attention_fwd", name, t, "a contiguous head dim, a "
                "16-byte aligned base and non-zero strides that are "
                "multiples of 16 bytes")
        descs.append(desc)
    out = _packed_like(b, nh, tq, d, q.dtype, q.device)
    # lse rows start on the 16-byte grid, so the backward's TMA reads them
    pitch = -(-tq // 4) * 4
    lse_rows = torch.empty((b * nh, pitch), dtype=torch.float32,
                           device=q.device)
    mode, bias_desc, _bias = _bias_tile(bias, q, tq, tk)
    seed_ptr, thr, inv, drop, offs, _k = _dropout_args(q, dropout_rate, seed)
    lib = _bind("flash_attention_fwd", "flash_attention_fwd_bf16",
                [_PTR, _PTR, _PTR] + [_I32] * 6 + [_I64] * 3
                + [_I32, _F32, _I32] + _DROPOUT_ARGS + [_PTR])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd_bf16(
            _descs(*descs, bias_desc), out.data_ptr(), lse_rows.data_ptr(),
            pitch, b, nh, tq, tk, d, *out.stride()[:3], mode,
            float(sm_scale), int(causal), seed_ptr, thr, inv, drop,
            offs, stream)
    _raise_on(lib, err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse_rows[:, :tq].view(b, nh, tq)


def _dbias_out(dbias, b, nh, tq, tk, device):
    if dbias == "per_q":
        return torch.empty((b, nh, tq, tk), dtype=torch.float32,
                           device=device)
    if dbias == "col":
        return torch.empty((b, nh, tk), dtype=torch.float32, device=device)
    return None


def _launch_bwd_f32(q, k, v, out, lse, g, bias, causal, sm_scale,
                    dropout_rate, seed, dbias):
    b, nh, tq, d = q.shape
    tk = k.shape[2]
    # q/k/v arrive as views of the fused qkv projection and dO in whatever
    # layout autograd built (an expanded or transposed gradient included):
    # a tensor whose strides break the kernels' 16-byte vector loads is
    # copied to a contiguous one here, never handed to the plain version
    q, k, v, g, out = (t if _kernel_layout_ok(t) else t.contiguous()
                       for t in (q, k, v, g.to(q.dtype), out))
    lse = lse.reshape(b * nh, tq)   # rows lse.stride(0) floats apart
    lse = lse if lse.stride(1) == 1 else lse.contiguous()
    dq = _packed_like(b, nh, tq, d, q.dtype, q.device)
    dk = _packed_like(b, nh, tk, d, k.dtype, q.device)
    dv = _packed_like(b, nh, tk, d, v.dtype, q.device)
    db = _dbias_out(dbias, b, nh, tq, tk, q.device)
    bias_ptr, bias_strides, _bias = _bias_args(bias, q, tq, tk)
    seed_ptr, thr, inv, drop, offs, _k = _dropout_args(q, dropout_rate, seed)
    lib = _bind("flash_attention_bwd", "flash_attention_bwd_f32",
                [_PTR] * 12 + [_I32] * 7 + [_I64] * 25 + [_F32, _I32]
                + _DROPOUT_ARGS + [_PTR])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        # delta = Σ_d dO·out by the delta kernel, before the dq and dk/dv
        # kernels, as the JAX package computes it outside its kernels
        # (_bwd_host_prep)
        delta = _launch_delta(out, g, stream)
        err = lib.flash_attention_bwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), bias_ptr, dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            db.data_ptr() if dbias == "per_q" else None,
            db.data_ptr() if dbias == "col" else None,
            b, nh, tq, tk, d, lse.stride(0), delta.stride(0),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *g.stride()[:3], *dq.stride()[:3], *dk.stride()[:3],
            *dv.stride()[:3], *bias_strides, float(sm_scale), int(causal),
            seed_ptr, thr, inv, drop, offs, stream)
    _raise_on(lib, err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv, db


def _launch_delta(out, g, stream):
    """The delta kernel (f32 or bf16 out and dO of one dtype, 16-byte
    aligned rows) into [B·nh, pitch] f32 rows (pitch = Tq rounded up to 4
    floats: the 16-byte grid the bf16 dk/dv kernels' TMA reads)."""
    b, nh, t, d = out.shape
    pitch = -(-t // 4) * 4
    rows = torch.empty((b * nh, pitch), dtype=torch.float32,
                       device=out.device)
    lib = _bind("flash_attention_bwd", "flash_attention_bwd_delta",
                [_PTR] * 3 + [_I32] * 6 + [_I64] * 6 + [_PTR])
    err = lib.flash_attention_bwd_delta(
        out.data_ptr(), g.data_ptr(), rows.data_ptr(), _DTYPE_CODE[out.dtype],
        b, nh, t, d, pitch, *out.stride()[:3], *g.stride()[:3], stream)
    _raise_on(lib, err, "flash_attention_bwd")
    return rows


def _launch_bwd_bf16(q, k, v, out, lse, g, bias, causal, sm_scale,
                     dropout_rate, seed, dbias):
    b, nh, tq, d = q.shape
    tk = k.shape[2]
    # a tensor TMA cannot read in place (an expanded or transposed gradient)
    # is copied to a contiguous one, never handed to the plain version
    q, k, v, g, out = (t if _tma_desc(t) else t.contiguous()
                       for t in (q, k, v, g.to(q.dtype), out))
    dq = _packed_like(b, nh, tq, d, q.dtype, q.device)
    dk = _packed_like(b, nh, tk, d, k.dtype, q.device)
    dv = _packed_like(b, nh, tk, d, v.dtype, q.device)
    db = _dbias_out(dbias, b, nh, tq, tk, q.device)
    mode, bias_desc, _bias = _bias_tile(bias, q, tq, tk)
    seed_ptr, thr, inv, drop, offs, _k = _dropout_args(q, dropout_rate, seed)
    lse_v = _padded_rows(lse, b * nh, tq)
    lib = _bind("flash_attention_bwd", "flash_attention_bwd_bf16",
                [_PTR] * 6 + [_I32] * 5 + [_I64] * 9 + [_I32, _F32, _I32]
                + _DROPOUT_ARGS + [_PTR])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        delta_v = _launch_delta(out, g, stream)[:, :tq].view(1, 1, b * nh,
                                                             tq)
        descs = _descs(*(_tma_desc(t) for t in (q, k, v, g)), bias_desc,
                       _tma_desc(lse_v), _tma_desc(delta_v))
        err = lib.flash_attention_bwd_bf16(
            descs, dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            db.data_ptr() if dbias == "per_q" else None,
            db.data_ptr() if dbias == "col" else None,
            b, nh, tq, tk, d, *dq.stride()[:3], *dk.stride()[:3],
            *dv.stride()[:3], mode, float(sm_scale), int(causal), seed_ptr,
            thr, inv, drop, offs, stream)
    _raise_on(lib, err, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv, db


def _wide_strides(tensors, bias_strides):
    """(batch, head, token) strides of each tensor, then the four of the
    bias (zeros without one), as the wide kernels' int64 array."""
    vals = [x for t in tensors for x in t.stride()[:3]] + list(bias_strides)
    return (ctypes.c_longlong * len(vals))(*vals)


def _wide_fwd_bf16_tensors(q, k, v, bias):
    """q, k, v and the bias as the bf16 wide forward's TMA reads them: in
    place where ``_tma_desc`` describes them (the [B, nh, T, d] head views of
    a packed [B, T, nh·d] projection, at any T), else copied to contiguous
    ones; the bias in its compact broadcast shape (``_bias_tile``). Returns
    (tensors, descriptions, bias mode)."""
    ts = [t if _tma_desc(t) else t.contiguous() for t in (q, k, v)]
    mode, bias_desc, bias_t = _bias_tile(bias, ts[0], q.shape[2], k.shape[2])
    return ts + [bias_t], [_tma_desc(t) for t in ts] + [bias_desc], mode


def launch_wide_fwd(counter, q, k, v, bias, se, vis, causal, sm_scale,
                    dropout_rate, seed):
    """The wide forward (any head dim d = 64·k; the wrappers send it those
    above 256): dense with `bias` (se is None) or block-sparse with the
    descriptor `se` and the 64x64 tile table `vis`. f32 tensors whose
    strides break 16-byte loads, and bf16 ones TMA cannot read in place,
    are copied first. Counts one launch on `counter`."""
    b, nh, tq, d = q.shape
    tk = k.shape[2]
    out = _packed_like(b, nh, tq, d, q.dtype, q.device)
    lse = torch.empty((b, nh, tq), dtype=torch.float32, device=q.device)
    seed_ptr, thr, inv, drop, offs, _k = _dropout_args(q, dropout_rate, seed)
    se_ptr = se.data_ptr() if se is not None else None
    vis_ptr = vis.data_ptr() if vis is not None else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if q.dtype == torch.bfloat16:
            _ts, descs, mode = _wide_fwd_bf16_tensors(q, k, v, bias)
            lib = _bind("flash_attention_wide",
                        "flash_attention_wide_fwd_bf16",
                        [_PTR] * 5 + [_I32] * 5 + [_I64] * 3
                        + [_I32, _F32] + [_I32] * 2 + _DROPOUT_ARGS + [_PTR])
            err = lib.flash_attention_wide_fwd_bf16(
                _descs(*descs), se_ptr, vis_ptr, out.data_ptr(),
                lse.data_ptr(), b, nh, tq, tk, d, *out.stride()[:3], mode,
                float(sm_scale), int(causal), int(se is not None), seed_ptr,
                thr, inv, drop, offs, stream)
        else:
            q, k, v = (t if _kernel_layout_ok(t) else t.contiguous()
                       for t in (q, k, v))
            bias_ptr, bias_strides, _bias = _bias_args(bias, q, tq, tk)
            lib = _bind("flash_attention_wide", "flash_attention_wide_fwd",
                        [_PTR] * 8 + [_I32] * 5 + [_PTR, _F32] + [_I32] * 2
                        + _DROPOUT_ARGS + [_PTR])
            err = lib.flash_attention_wide_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_ptr, se_ptr,
                vis_ptr, out.data_ptr(), lse.data_ptr(), b, nh, tq, tk, d,
                _wide_strides((q, k, v, out), bias_strides), float(sm_scale),
                int(causal), int(se is not None), seed_ptr, thr, inv, drop,
                offs, stream)
    _raise_on(lib, err, "flash_attention_fwd")
    counter.launches += 1
    counter.wide_launches += 1
    return out, lse


def _wide_bwd_bf16_tensors(q, k, v, g, bias, lse, delta, se):
    """q, k, v, dO, the bias, lse, delta and se as the bf16 wide backward's
    TMA reads them: q, k, v and dO in place where ``_tma_desc`` describes
    them (the [B, nh, T, d] head views of a packed [B, T, nh·d] projection,
    at any T), else copied to contiguous ones; the bias in its compact
    broadcast shape (``_bias_tile``); lse and delta ([B·nh, Tq] rows, e.g.
    the delta kernel's, whose pitch is a multiple of 4 floats) as [1, 1,
    B·nh, Tq] views read by their pitch (``_padded_rows``: copied only off
    the 16-byte grid); se ([B, Tq] int32, sparse) as [1, 1, B, Tq]. Returns
    (tensors, descriptions, bias mode)."""
    b, nh, tq = q.shape[:3]
    ts = [t if _tma_desc(t) else t.contiguous() for t in (q, k, v, g)]
    mode, bias_desc, bias_t = _bias_tile(bias, ts[0], tq, k.shape[2])
    rows = [_padded_rows(x, b * nh, tq) for x in (lse, delta)]
    se_v = None if se is None else se.contiguous().view(1, 1, b, tq)
    descs = ([_tma_desc(t) for t in ts] + [bias_desc]
             + [_tma_desc(r) for r in rows]
             + [[0] * _DESC_LEN if se_v is None else _tma_desc(se_v)])
    return ts + [bias_t] + rows + [se_v], descs, mode


def launch_wide_bwd(counter, q, k, v, out, lse, g, bias, se, vis, causal,
                    sm_scale, dropout_rate, seed, dbias=None):
    """The wide backward: the delta kernel, then the backward's kernels
    (one launch of the dk, dq and dv CTAs in bf16; f32: f32w::run_bwd),
    counted as one launch on `counter`; dense or block-sparse as
    `launch_wide_fwd`. f32 tensors whose strides break 16-byte loads, and
    bf16 ones TMA cannot read in place, are copied first. Returns (dq, dk,
    dv, dbias)."""
    b, nh, tq, d = q.shape
    tk = k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    g = g.to(q.dtype)
    out = out if _kernel_layout_ok(out) else out.contiguous()
    if not bf16:
        q, k, v, g = (t if _kernel_layout_ok(t) else t.contiguous()
                      for t in (q, k, v, g))
    dq = _packed_like(b, nh, tq, d, q.dtype, q.device)
    dk = _packed_like(b, nh, tk, d, k.dtype, q.device)
    dv = _packed_like(b, nh, tk, d, v.dtype, q.device)
    # zeros: the per-query dbias of the key tiles a causal walk skips
    db = (torch.zeros((b, nh, tq, tk), dtype=torch.float32, device=q.device)
          if dbias == "per_q" else _dbias_out(dbias, b, nh, tq, tk,
                                               q.device))
    db_ptrs = (db.data_ptr() if dbias == "per_q" else None,
               db.data_ptr() if dbias == "col" else None)
    seed_ptr, thr, inv, drop, offs, _k = _dropout_args(q, dropout_rate, seed)
    vis_ptr = vis.data_ptr() if vis is not None else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if bf16:
            g = g if _tma_desc(g) else g.contiguous()  # one layout for both
            delta = _launch_delta(out, g, stream)
            _ts, descs, mode = _wide_bwd_bf16_tensors(
                q, k, v, g, bias, lse, delta[:, :tq], se)
            lib = _bind("flash_attention_wide",
                        "flash_attention_wide_bwd_bf16",
                        [_PTR] * 7 + [_I32] * 5 + [_I64] * 9
                        + [_I32, _F32] + [_I32] * 2 + _DROPOUT_ARGS + [_PTR])
            err = lib.flash_attention_wide_bwd_bf16(
                _descs(*descs), vis_ptr, dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), *db_ptrs, b, nh, tq, tk, d, *dq.stride()[:3],
                *dk.stride()[:3], *dv.stride()[:3], mode, float(sm_scale),
                int(causal), int(se is not None), seed_ptr, thr, inv, drop,
                offs, stream)
        else:
            lse = lse.reshape(b * nh, tq)   # rows lse.stride(0) floats apart
            lse = lse if lse.stride(1) == 1 else lse.contiguous()
            bias_ptr, bias_strides, _bias = _bias_args(bias, q, tq, tk)
            lib = _bind("flash_attention_wide", "flash_attention_wide_bwd",
                        [_PTR] * 5 + [_I64, _PTR, _I64] + [_PTR] * 8
                        + [_I32] * 5 + [_PTR, _F32] + [_I32] * 2
                        + _DROPOUT_ARGS + [_PTR])
            delta = _launch_delta(out, g, stream)
            err = lib.flash_attention_wide_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                lse.data_ptr(), lse.stride(0), delta.data_ptr(),
                delta.stride(0), bias_ptr,
                se.data_ptr() if se is not None else None, vis_ptr,
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *db_ptrs, b, nh,
                tq, tk, d, _wide_strides((q, k, v, g, dq, dk, dv),
                                         bias_strides),
                float(sm_scale), int(causal), int(se is not None), seed_ptr,
                thr, inv, drop, offs, stream)
    _raise_on(lib, err, "flash_attention_bwd")
    counter.launches += 1
    counter.wide_launches += 1
    return dq, dk, dv, db


# ---------------------------------------------------------------------------
# Autograd: forward and backward joined (``_flash_core``'s custom_vjp)
# ---------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """out = flash_attention_fwd(q, k, v, bias, ...); the backward runs
    flash_attention_bwd with the same dropout seed, so it regenerates the
    forward's mask. dbias is computed only when the bias needs a gradient,
    in the column-sum form for a bias broadcast over the queries, and summed
    back over every broadcast dim to the bias's shape."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal, sm_scale, dropout_rate, seed):
        out, lse = flash_attention_fwd(q, k, v, bias, causal, sm_scale,
                                       dropout_rate, seed)
        ctx.save_for_backward(q, k, v, bias, out, lse, seed)
        ctx.args = (causal, sm_scale, dropout_rate)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, out, lse, seed = ctx.saved_tensors
        causal, sm_scale, rate = ctx.args
        form = None
        if bias is not None and ctx.needs_input_grad[3]:
            form = "col" if bias.shape[-2] == 1 else "per_q"
        dq, dk, dv, db = flash_attention_bwd(q, k, v, out, lse, g, bias,
                                             causal, sm_scale, rate, seed,
                                             form)
        if db is not None:
            if form == "col":
                db = db.unsqueeze(-2)
            for ax in range(4):
                if bias.shape[ax] == 1 and db.shape[ax] != 1:
                    db = db.sum(ax, keepdim=True)
            db = db.to(bias.dtype)
        return dq, dk, dv, db, None, None, None, None


def _attend(q, k, v, bias, causal, sm_scale, dropout_rate, seed):
    _check_rate(dropout_rate)
    check_block_divisor(q.shape[2], "flash_attention")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if not isinstance(seed, torch.Tensor):
        seed = torch.tensor([int(seed)], dtype=torch.int64)
    if bias is not None:
        bias = bias.reshape((1,) * (4 - bias.ndim) + tuple(bias.shape))
    return _FlashAttention.apply(q, k, v, bias, bool(causal),
                                 float(sm_scale), float(dropout_rate), seed)


def flash_attention_packed(q, k, v, num_heads: int, bias=None,
                           causal: bool = False,
                           sm_scale: Optional[float] = None,
                           dropout_rate: float = 0.0, seed=0):
    """Attention on packed [B, T, H] tensors (H = nh·d), read in place
    through strides; differentiable. bias (optional) is the additive
    [B, 1, T] mask, indexed per batch. Returns [B, T, H]."""
    b_, t, hdim = q.shape
    if hdim % num_heads:
        raise ValueError(f"hidden {hdim} not divisible by heads {num_heads}")
    if bias is not None:
        if bias.ndim != 3 or bias.shape[1] != 1:
            raise ValueError(
                f"packed flash_attention bias must be [B, 1, T], got "
                f"{tuple(bias.shape)}")
        bias = bias[:, None]  # [B, 1, 1, T]: one mask row for every head
    d = hdim // num_heads

    def heads(x):  # [B, T, nh·d] -> [B, nh, T, d] view
        return x.unflatten(-1, (num_heads, d)).transpose(1, 2)

    out = _attend(heads(q), heads(k), heads(v), bias, causal, sm_scale,
                  dropout_rate, seed)
    return out.transpose(1, 2).reshape(b_, t, hdim)


def flash_attention(q, k, v, bias=None, causal: bool = False,
                    sm_scale: Optional[float] = None,
                    dropout_rate: float = 0.0, seed=0):
    """Attention on [B, H, T, D] tensors; bias is additive and broadcastable
    to [B, H, T, T] (e.g. the BERT mask [B, 1, 1, T]); differentiable.
    Returns [B, H, T, D]."""
    return _attend(q, k, v, bias, causal, sm_scale, dropout_rate, seed)
