"""Block-sparse packed-segment flash attention: hand-written Hopper kernels,
their plain versions, and the autograd function that joins them.

Replaces the TPU kernels of the block-sparse section of
``paddle_tpu/ops/pallas_kernels/flash_attention.py``:

- forward: ``_fwd_kernel_sparse`` (via ``_flash_fwd_pallas_sparse``);
- backward: ``_bwd_dq_kernel_sparse`` + ``_bwd_dkv_kernel_sparse`` (via
  ``_flash_bwd_pallas_sparse``);

CUDA source ``csrc/flash_attention_sparse.cu``, whose header says how the
kernels are laid out for the card and what bounds them.

Packed rows (``reader.pack_by_tokens``) hold several sentences; their
segment-id rows (1-based, contiguous, ascending; 0 = pad tail) say who sees
whom. No [B, 1, Tq, Tk] mask exists: ``pack_se`` turns the rows into one
int32 per query, (start << 16) | end, the range of keys of its own segment,
and ``compute_block_vis`` turns that into a [B, nq, nk] table of the 64x64
(q tile, k tile) pairs that hold any visible element. The kernels skip the
other tiles. Masked probabilities are set to exactly 0, so a skipped tile is
bitwise the same as a processed one (the table may even be all ones), a pad
query gets out = 0 and lse = -1e30, and pad rows get zero gradients.

- ``flash_attention_sparse_fwd_plain`` / ``flash_attention_sparse_bwd_plain``
  are the plain PyTorch versions, mirroring ``_flash_fwd_jax_sparse`` and
  ``_flash_bwd_jax_sparse`` (element mask from the descriptor, AND the tile
  table, so they honour a skip exactly as the kernels do). The CPU tests use
  them; on the card they are the kernels' yardstick.
- ``flash_attention_sparse_fwd`` / ``flash_attention_sparse_bwd`` are the
  wrappers. ``sparse_route`` decides from the shapes, dtype and device type,
  as the JAX package's ``_sparse_pallas_ok`` does: a CPU tensor takes the
  plain version; on the card Tq or Tk not a multiple of 64, or a head dim
  that is not a multiple of 64, takes the plain version too (the JAX
  package's blockwise XLA path; counted in ``.plain_on_cuda``), d = 64, 128,
  192 or 256 launches the kernels of ``csrc/flash_attention_sparse.cu``, and
  a larger multiple of 64 the wide kernels of ``csrc/flash_attention_wide.cu``
  in their sparse mode. Each counts its launches in ``.launches`` (a
  backward counts one: the dense backward's delta kernel, then one kernel
  whose CTAs compute dk/dv or dq), those on the wide kernels also in
  ``.wide_launches``. The C entries are ``flash_attention_sparse_fwd`` and
  ``flash_attention_sparse_bwd`` (f32: strides and pointers) and
  ``flash_attention_sparse_fwd_bf16`` and ``flash_attention_sparse_bwd_bf16``
  (bf16: the tensors described for TMA tensor maps by ``_tma_desc``).
- ``_FlashAttentionSparse`` is the ``torch.autograd.Function`` that joins
  them, as the ``custom_vjp`` ``_flash_sparse_core`` does in the JAX package;
  ``flash_attention_packed_sparse`` is the [B, T, nh·d] entry point.

Dropout draws the same Philox bits as the dense kernels
(``flash_attention.dropout_keep_mask``), keyed by (seed, b·nh + h, i, j).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from ...observability import kernel_counts
from .flash_attention import (HEAD_DIMS, NEG_INF, _DROPOUT_ARGS, _DTYPE_CODE,
                              _I64, _check_rate, _descs, _dropout_args,
                              _dropped, _kernel_layout_ok, _launch_delta,
                              _packed_like, _padded_rows, _raise_on,
                              _tma_desc, check_block_divisor,
                              dropout_keep_mask, flash_route,
                              launch_wide_bwd, launch_wide_fwd)

TILE = 64  # q rows and keys per tile of the CUDA kernels


def sparse_route(q_shape, tk: int, dtype, device_type: str) -> str:
    """Where a call on q of `q_shape` ([B, nh, Tq, d]) and Tk keys goes:
    "kernel", "plain", or an error before any launch, as
    ``_sparse_pallas_ok`` decides in the JAX package: on the card Tq or Tk
    without a power-of-two block divisor ≥ 64 (not a multiple of 64) takes
    the plain version whatever the head dim (the JAX package's blockwise
    XLA path); otherwise `flash_route`'s rule. The forward and the backward
    of a call take the same route. B·nh has no limit."""
    if device_type == "cuda" and (q_shape[2] % TILE or tk % TILE):
        return "plain"
    return flash_route(q_shape, dtype, device_type)


def _use_kernel(fn, q, tk) -> bool:
    """sparse_route for q; a plain call on the card is counted on `fn`."""
    route = sparse_route(q.shape, tk, q.dtype, q.device.type)
    if route == "plain" and q.device.type == "cuda":
        fn.plain_on_cuda += 1
    return route == "kernel"


def pack_se(q_seg: torch.Tensor, k_seg: torch.Tensor) -> torch.Tensor:
    """[B, Tq], [B, Tk] segment-id rows (1-based contiguous ascending, 0 =
    pad) → the per-query key range [B, Tq] int32, (start << 16) | end. Pad
    queries get the empty range [0, 0). Twin of ``_pack_se``."""
    if k_seg.shape[1] >= (1 << 15):
        raise ValueError(
            f"block-sparse flash_attention: Tk={k_seg.shape[1]} overflows "
            f"the 16-bit packed range descriptor")
    q_seg = q_seg.to(torch.int32)
    k_seg = k_seg.to(torch.int32)
    # pad keys (0) must sort AFTER every real segment id
    kk = torch.where(k_seg > 0, k_seg, torch.full_like(k_seg, 1 << 30))
    start = torch.searchsorted(kk, q_seg, right=False).to(torch.int32)
    end = torch.searchsorted(kk, q_seg, right=True).to(torch.int32)
    zero = torch.zeros_like(start)
    start = torch.where(q_seg > 0, start, zero)
    end = torch.where(q_seg > 0, end, zero)
    return (start << 16) | end


def compute_block_vis(se: torch.Tensor, tq: int, tk: int,
                      block_q: int = TILE, block_k: int = TILE,
                      causal: bool = False) -> torch.Tensor:
    """[B, nq, nk] int32: 1 where the (q tile, k tile) pair holds a visible
    element of the descriptor `se` [B, Tq]. Conservative: a false positive
    costs work, never correctness (masked probabilities are zeroed). Twin of
    ``_compute_block_vis``; a ragged last tile is counted as a tile."""
    b = se.shape[0]
    nq, nk = -(-tq // block_q), -(-tk // block_k)
    start, end = se >> 16, se & 0xFFFF
    has = start < end
    pad = nq * block_q - tq
    sblk = torch.where(has, start, torch.full_like(start, tk))
    eblk = torch.where(has, end, torch.zeros_like(end))
    if pad:
        sblk = torch.nn.functional.pad(sblk, (0, pad), value=tk)
        eblk = torch.nn.functional.pad(eblk, (0, pad), value=0)
    sblk = sblk.reshape(b, nq, block_q).amin(-1)
    eblk = eblk.reshape(b, nq, block_q).amax(-1)
    k0 = torch.arange(nk, dtype=torch.int32, device=se.device) * block_k
    vis = ((sblk[:, :, None] < k0[None, None, :] + block_k)
           & (eblk[:, :, None] > k0[None, None, :]))
    if causal:
        # the same block-level test as the dense kernels' causal skip
        q_end = (torch.arange(nq, dtype=torch.int32, device=se.device)
                 * block_q + block_q - 1)
        vis &= k0[None, None, :] <= q_end[None, :, None]
    return vis.to(torch.int32)


def _mask(se, vis, tq, tk, causal):
    """[B, 1, Tq, Tk] bool: the element mask of the descriptor AND the tile
    table, as the kernels apply them (a skipped tile is wholly masked)."""
    start = (se >> 16)[:, None, :, None]
    end = (se & 0xFFFF)[:, None, :, None]
    k_pos = torch.arange(tk, device=se.device)
    mask = (k_pos >= start) & (k_pos < end)
    if causal:
        q_pos = torch.arange(tq, device=se.device)[:, None]
        mask = mask & (q_pos >= k_pos)
    if vis is not None:
        tiles = vis.bool().repeat_interleave(TILE, 1)[:, :tq]
        tiles = tiles.repeat_interleave(TILE, 2)[:, :, :tk]
        mask = mask & tiles[:, None]
    return mask


def _masked_scores(q, k, mask, sm_scale):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    return s.masked_fill(~mask, NEG_INF)


def flash_attention_sparse_fwd_plain(q, k, v, se, vis=None,
                                     causal: bool = False,
                                     sm_scale: Optional[float] = None,
                                     dropout_rate: float = 0.0, seed=0
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block-sparse forward in plain PyTorch, mirroring
    ``_flash_fwd_jax_sparse``: masked scores -1e30, masked p exactly 0, a
    zero row sum divides by 1, lse = m + log(l) over the undropped p; p is
    rounded to v's dtype before p·v, as the TPU kernels do.

    q [B, nh, Tq, d], k/v [B, nh, Tk, d], se [B, Tq] from ``pack_se``, vis
    [B, nq, nk] from ``compute_block_vis`` (None = every tile). Returns (out
    [B, nh, Tq, d] in q's dtype, lse [B, nh, Tq] f32)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    b, nh, tq, _ = q.shape
    tk = k.shape[2]
    mask = _mask(se, vis, tq, tk, causal)
    s = _masked_scores(q, k, mask, sm_scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    if dropout_rate > 0.0:
        p = _dropped(p, dropout_keep_mask(seed, dropout_rate, b, nh, tq, tk,
                                          q.device), dropout_rate)
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / l_safe
    return out.to(q.dtype), (m + torch.log(l_safe)).squeeze(-1)


def flash_attention_sparse_bwd_plain(q, k, v, out, lse, g, se, vis=None,
                                     causal: bool = False,
                                     sm_scale: Optional[float] = None,
                                     dropout_rate: float = 0.0, seed=0):
    """The block-sparse backward in plain PyTorch, mirroring
    ``_flash_bwd_jax_sparse``: delta = Σ dO·out; p = exp(s − lse) where
    visible, else exactly 0; dv = p_dropᵀ·dO; dp = dO·vᵀ (drop-scaled);
    ds = p·(dp − delta); dq = ds·k·scale; dk = dsᵀ·q·scale. p_drop, ds and
    dO are rounded to q's dtype before their products, the accumulation is
    f32. Returns (dq, dk, dv) in the input dtypes."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    b, nh, tq, _ = q.shape
    tk = k.shape[2]
    cdt = q.dtype
    gc = g.to(cdt).float()
    delta = (g.float() * out.float()).sum(-1, keepdim=True)
    mask = _mask(se, vis, tq, tk, causal)
    s = _masked_scores(q, k, mask, sm_scale)
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dp = torch.matmul(gc, v.to(cdt).float().transpose(-1, -2))
    p_d = p
    if dropout_rate > 0.0:
        keep = dropout_keep_mask(seed, dropout_rate, b, nh, tq, tk, q.device)
        p_d = _dropped(p, keep, dropout_rate)
        dp = _dropped(dp, keep, dropout_rate)
    dv = torch.matmul(p_d.to(cdt).float().transpose(-1, -2), gc)
    ds_c = (p * (dp - delta)).to(cdt).float()
    dk = torch.matmul(ds_c.transpose(-1, -2), q.float()) * sm_scale
    dq = torch.matmul(ds_c, k.float()) * sm_scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, se, vis, causal, name):
    if not (q.device == k.device == v.device == se.device):
        raise ValueError(f"{name}: q, k, v, se on different devices "
                         f"({q.device}, {k.device}, {v.device}, {se.device})")
    if q.dtype not in _DTYPE_CODE or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{name}: q, k, v must share one dtype of "
                        f"float32/bfloat16, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"{name}: q, k, v must be [B, nh, T, d]")
    b, nh, tq, d = q.shape
    if k.shape[:2] != (b, nh) or k.shape[-1] != d or v.shape != k.shape:
        raise ValueError(f"{name}: shapes do not match: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if se.shape != (b, tq) or se.dtype != torch.int32:
        raise ValueError(f"{name}: se must be [B, Tq] = [{b}, {tq}] int32, "
                         f"got {tuple(se.shape)} {se.dtype}")
    if causal and tq != k.shape[2]:
        raise ValueError(f"{name}: causal requires Tq == Tk")
    want = (b, -(-tq // TILE), -(-k.shape[2] // TILE))
    if vis is not None and (vis.device != q.device
                            or tuple(vis.shape) != want):
        raise ValueError(f"{name}: vis must be the {TILE}x{TILE} tile table "
                         f"{want} on {q.device}, got {tuple(vis.shape)} on "
                         f"{vis.device}")


def visible_pairs(se, tq: int, tk: int, causal: bool, nh: int):
    """(query, key) pairs a sparse launch attends to over its heads, a
    0-dim tensor on se's device (no host read)."""
    return _mask(se, None, tq, tk, causal).sum() * nh


def fwd_counts(q, k, se, vis, pairs) -> Tuple[float, float]:
    """(flops, bytes) of one sparse forward launch over `pairs` visible
    (query, key) pairs: 4·d per pair; q, k, v read and out written once,
    the f32 lse written, se and the tile table read."""
    b, nh, tq, d = q.shape
    tk = k.shape[2]
    small = se.numel() * 4 + vis.numel() * 4
    return (4.0 * d * pairs,
            (2 * tq + 2 * tk) * b * nh * d * q.element_size()
            + b * nh * tq * 4 + small)


def bwd_counts(q, k, se, vis, pairs) -> Tuple[float, float]:
    """(flops, bytes) of one sparse backward launch: 10·d per visible pair;
    q, k, v, out, dO read and dq, dk, dv written once, lse read and delta
    written (f32), se and the tile table read."""
    b, nh, tq, d = q.shape
    tk = k.shape[2]
    small = se.numel() * 4 + vis.numel() * 4
    return (10.0 * d * pairs,
            (4 * tq + 4 * tk) * b * nh * d * q.element_size()
            + 2 * b * nh * tq * 4 + small)


def _declare(entry, q, k, se, vis, causal):
    from .flash_attention import launch_kernels

    row, kernels = launch_kernels(entry, q.dtype, q.shape[-1], sparse=True)
    pairs = visible_pairs(se, q.shape[2], k.shape[2], causal, q.shape[1])
    counts = (fwd_counts if entry == "fwd" else bwd_counts)(q, k, se, vis,
                                                             pairs)
    kernel_counts.declare(row, kernels, *counts)


def flash_attention_sparse_fwd(q, k, v, se, vis, causal: bool = False,
                               sm_scale: Optional[float] = None,
                               dropout_rate: float = 0.0, seed=0
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-sparse forward: the plain version for a CPU tensor or a shape
    `sparse_route` sends there, else the Hopper kernel (or an error; never a
    fallback). Same arguments and results as
    `flash_attention_sparse_fwd_plain`; on the card `vis` must be the 64x64
    table and `seed` may be a one-element int64 tensor there (the kernel
    reads it, so drawing it needs no host sync)."""
    _check(q, k, v, se, vis, causal, "flash_attention_sparse_fwd")
    _check_rate(dropout_rate)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if not _use_kernel(flash_attention_sparse_fwd, q, k.shape[2]):
        return flash_attention_sparse_fwd_plain(q, k, v, se, vis, causal,
                                                sm_scale, dropout_rate, seed)
    if kernel_counts.active():
        _declare("fwd", q, k, se, vis, causal)
    if q.shape[-1] not in HEAD_DIMS:
        _kernel_checks("flash_attention_sparse_fwd", vis)
        return launch_wide_fwd(flash_attention_sparse_fwd, q, k, v, None,
                               se.contiguous(),
                               vis.to(torch.int32).contiguous(), causal,
                               sm_scale, dropout_rate, seed)
    return _launch_fwd(q, k, v, se, vis, causal, sm_scale, dropout_rate,
                       seed)


flash_attention_sparse_fwd.launches = 0
flash_attention_sparse_fwd.wide_launches = 0
flash_attention_sparse_fwd.plain_on_cuda = 0


def flash_attention_sparse_bwd(q, k, v, out, lse, g, se, vis,
                               causal: bool = False,
                               sm_scale: Optional[float] = None,
                               dropout_rate: float = 0.0, seed=0):
    """Block-sparse backward: routed as `flash_attention_sparse_fwd`; on
    the card the Hopper kernels (counted as one launch), or an error. Same
    arguments and results as `flash_attention_sparse_bwd_plain`."""
    _check(q, k, v, se, vis, causal, "flash_attention_sparse_bwd")
    _check_rate(dropout_rate)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if not _use_kernel(flash_attention_sparse_bwd, q, k.shape[2]):
        return flash_attention_sparse_bwd_plain(q, k, v, out, lse, g, se,
                                                vis, causal, sm_scale,
                                                dropout_rate, seed)
    if kernel_counts.active():
        _declare("bwd", q, k, se, vis, causal)
    if q.shape[-1] not in HEAD_DIMS:
        _kernel_checks("flash_attention_sparse_bwd", vis)
        return launch_wide_bwd(flash_attention_sparse_bwd, q, k, v, out, lse,
                               g, None, se.contiguous(),
                               vis.to(torch.int32).contiguous(), causal,
                               sm_scale, dropout_rate, seed)[:3]
    launch = _launch_bwd_bf16 if q.dtype == torch.bfloat16 else _launch_bwd
    return launch(q, k, v, out, lse, g, se, vis, causal, sm_scale,
                  dropout_rate, seed)


flash_attention_sparse_bwd.launches = 0
flash_attention_sparse_bwd.wide_launches = 0
flash_attention_sparse_bwd.plain_on_cuda = 0


# ---------------------------------------------------------------------------
# Kernel launches (ctypes; the library is built at first use)
# ---------------------------------------------------------------------------

_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STRIDES = ctypes.c_longlong * 3
_STRIDES_PTR = ctypes.POINTER(ctypes.c_longlong)


def _lib():
    from . import build

    lib = build.load("flash_attention_sparse")
    if lib.flash_attention_sparse_fwd.argtypes is None:
        lib.flash_attention_sparse_fwd.argtypes = (
            [_PTR] * 7 + [_I32] * 5 + [_STRIDES_PTR] * 4 + [_F32, _I32]
            + _DROPOUT_ARGS + [_PTR])
        lib.flash_attention_sparse_fwd_bf16.argtypes = (
            [_PTR] * 4 + [_I32] * 5 + [_I64] * 3 + [_F32, _I32]
            + _DROPOUT_ARGS + [_PTR])
        lib.flash_attention_sparse_bwd.argtypes = (
            [_PTR] * 11 + [_I32] * 7 + [_STRIDES_PTR] * 7 + [_F32, _I32]
            + _DROPOUT_ARGS + [_PTR])
        lib.flash_attention_sparse_bwd_bf16.argtypes = (
            [_PTR] * 5 + [_I32] * 5 + [_I64] * 9 + [_F32, _I32]
            + _DROPOUT_ARGS + [_PTR])
        for fn in (lib.flash_attention_sparse_fwd,
                   lib.flash_attention_sparse_fwd_bf16,
                   lib.flash_attention_sparse_bwd,
                   lib.flash_attention_sparse_bwd_bf16):
            fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        # the f32 forward's launch: CTAs for (B, nh, Tq, d), shared memory
        lib.flash_attention_sparse_fwd_ctas.argtypes = [_I32] * 4
        lib.flash_attention_sparse_fwd_ctas.restype = ctypes.c_uint
        lib.flash_attention_sparse_fwd_smem.argtypes = [_I32]
        lib.flash_attention_sparse_fwd_smem.restype = ctypes.c_int
    return lib


def _strides(t):
    return _STRIDES(*t.stride()[:3])


def _kernel_checks(name, vis):
    """What sparse_route leaves to the launch: the kernels walk the tile
    table, so it must be given."""
    if vis is None:
        raise ValueError(f"{name}: the kernels need the tile table of "
                         f"compute_block_vis")


def _layout(ts):
    """Each tensor as the f32 kernels read it: a view whose strides allow
    16-byte vector loads is passed as is, any other is copied (a gradient
    autograd built in another layout); never the plain version."""
    return [t if _kernel_layout_ok(t) else t.contiguous() for t in ts]


def _tma_ready(ts):
    """Each tensor as the bf16 kernels' TMA reads it: in place where
    ``_tma_desc`` describes it (the [B, nh, T, d] head views of a packed
    [B, T, nh·d] projection, a contiguous [1, 1, B, Tq] view of se), else
    copied to a contiguous one (an expanded or transposed gradient); never
    handed to the plain version."""
    return [t if _tma_desc(t) else t.contiguous() for t in ts]


def _fwd_bf16_tensors(q, k, v, se):
    """q, k, v and se ([B, Tq] int32, seen as [1, 1, B, Tq]) as the bf16
    forward reads them, with their tensor-map descriptions."""
    b, tq = se.shape
    ts = _tma_ready((q, k, v, se.contiguous().view(1, 1, b, tq)))
    return ts, [_tma_desc(t) for t in ts]


def _launch_fwd(q, k, v, se, vis, causal, sm_scale, dropout_rate, seed):
    name = "flash_attention_sparse_fwd"
    _kernel_checks(name, vis)
    b, nh, tq, d = q.shape
    tk = k.shape[2]
    vis = vis.to(torch.int32).contiguous()
    out = _packed_like(b, nh, tq, d, q.dtype, q.device)
    lse = torch.empty((b, nh, tq), dtype=torch.float32, device=q.device)
    seed_ptr, thr, inv, drop, offs, _k = _dropout_args(q, dropout_rate, seed)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if q.dtype == torch.bfloat16:
            _ts, descs = _fwd_bf16_tensors(q, k, v, se)
            err = lib.flash_attention_sparse_fwd_bf16(
                _descs(*descs), vis.data_ptr(), out.data_ptr(),
                lse.data_ptr(), b, nh, tq, tk, d, *out.stride()[:3],
                float(sm_scale), int(causal), seed_ptr, thr, inv, drop, offs,
                stream)
        else:
            q, k, v = _layout((q, k, v))
            se = se.contiguous()
            err = lib.flash_attention_sparse_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), se.data_ptr(),
                vis.data_ptr(), out.data_ptr(), lse.data_ptr(), b, nh, tq,
                tk, d, _strides(q), _strides(k), _strides(v), _strides(out),
                float(sm_scale), int(causal), seed_ptr, thr, inv, drop, offs,
                stream)
    _raise_on(lib, err, name)
    flash_attention_sparse_fwd.launches += 1
    return out, lse


def _launch_bwd(q, k, v, out, lse, g, se, vis, causal, sm_scale,
                dropout_rate, seed):
    name = "flash_attention_sparse_bwd"
    _kernel_checks(name, vis)
    b, nh, tq, d = q.shape
    tk = k.shape[2]
    q, k, v, g = _layout((q, k, v, g.to(q.dtype)))
    out = out if _kernel_layout_ok(out) else out.contiguous()
    se, vis = se.contiguous(), vis.to(torch.int32).contiguous()
    lse = lse.reshape(b * nh, tq)   # rows lse.stride(0) floats apart
    lse = lse if lse.stride(1) == 1 else lse.contiguous()
    dq = _packed_like(b, nh, tq, d, q.dtype, q.device)
    dk = _packed_like(b, nh, tk, d, k.dtype, q.device)
    dv = _packed_like(b, nh, tk, d, v.dtype, q.device)
    seed_ptr, thr, inv, drop, offs, _k = _dropout_args(q, dropout_rate, seed)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        # delta = Σ_d dO·out by the dense backward's delta kernel, as the
        # JAX package computes it outside its kernels (_bwd_host_prep)
        delta = _launch_delta(out, g, stream)
        err = lib.flash_attention_sparse_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), se.data_ptr(), vis.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, nh, tq, tk, d,
            lse.stride(0), delta.stride(0), _strides(q), _strides(k),
            _strides(v), _strides(g), _strides(dq), _strides(dk),
            _strides(dv), float(sm_scale),
            int(causal), seed_ptr, thr, inv, drop, offs, stream)
    _raise_on(lib, err, name)
    flash_attention_sparse_bwd.launches += 1
    return dq, dk, dv


def _launch_bwd_bf16(q, k, v, out, lse, g, se, vis, causal, sm_scale,
                     dropout_rate, seed):
    """The bf16 backward: the delta kernel, then one wgmma kernel of dk/dv
    and dq CTAs, which read q, k, v, dO, lse, delta and se through TMA
    maps."""
    name = "flash_attention_sparse_bwd"
    _kernel_checks(name, vis)
    b, nh, tq, d = q.shape
    tk = k.shape[2]
    q, k, v, g, out = _tma_ready((q, k, v, g.to(q.dtype), out))
    se, vis = se.contiguous(), vis.to(torch.int32).contiguous()
    dq = _packed_like(b, nh, tq, d, q.dtype, q.device)
    dk = _packed_like(b, nh, tk, d, k.dtype, q.device)
    dv = _packed_like(b, nh, tk, d, v.dtype, q.device)
    seed_ptr, thr, inv, drop, offs, _k = _dropout_args(q, dropout_rate, seed)
    lse_v = _padded_rows(lse, b * nh, tq)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        delta_v = _launch_delta(out, g, stream)[:, :tq].view(1, 1, b * nh,
                                                             tq)
        descs = _descs(*(_tma_desc(t) for t in (q, k, v, g, lse_v, delta_v,
                                                se.view(1, 1, b, tq))))
        err = lib.flash_attention_sparse_bwd_bf16(
            descs, vis.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), b, nh, tq, tk, d, *dq.stride()[:3],
            *dk.stride()[:3], *dv.stride()[:3], float(sm_scale), int(causal),
            seed_ptr, thr, inv, drop, offs, stream)
    _raise_on(lib, err, name)
    flash_attention_sparse_bwd.launches += 1
    return dq, dk, dv


# ---------------------------------------------------------------------------
# Autograd: forward and backward joined (``_flash_sparse_core``'s custom_vjp)
# ---------------------------------------------------------------------------

class _FlashAttentionSparse(torch.autograd.Function):
    """out = flash_attention_sparse_fwd(q, k, v, se, vis, ...); the backward
    runs flash_attention_sparse_bwd on the same descriptor and tile table
    (computed once per call) and the same dropout seed, so it regenerates
    the forward's mask. se, vis and the seed get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, se, vis, causal, sm_scale, dropout_rate, seed):
        out, lse = flash_attention_sparse_fwd(q, k, v, se, vis, causal,
                                              sm_scale, dropout_rate, seed)
        ctx.save_for_backward(q, k, v, se, vis, out, lse, seed)
        ctx.args = (causal, sm_scale, dropout_rate)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, se, vis, out, lse, seed = ctx.saved_tensors
        causal, sm_scale, rate = ctx.args
        dq, dk, dv = flash_attention_sparse_bwd(q, k, v, out, lse, g, se, vis,
                                                causal, sm_scale, rate, seed)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_packed_sparse(q, k, v, num_heads: int, q_seg, k_seg,
                                  causal: bool = False,
                                  sm_scale: Optional[float] = None,
                                  dropout_rate: float = 0.0, seed=None):
    """Block-sparse packed-segment attention on [B, T, H] tensors (H =
    nh·d), read in place through strides; differentiable in q, k, v.

    q_seg [B, Tq] / k_seg [B, Tk] are the packed segment-id rows
    (``reader.pack_by_tokens``: 1-based contiguous ascending ids, 0 = pad
    tail). Self attention (q_seg is k_seg, optionally causal) and cross
    attention (Tq ≠ Tk). Pad queries return exactly 0. `seed` (an int or a
    one-element int64 tensor) is required with dropout. Returns [B, Tq, H].
    """
    b_, tq, hdim = q.shape
    tk = k.shape[1]
    if hdim % num_heads:
        raise ValueError(f"hidden {hdim} not divisible by heads {num_heads}")
    d = hdim // num_heads
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(
            f"flash_attention_sparse: dropout_rate must be in [0, 1), got "
            f"{dropout_rate}")
    if dropout_rate > 0.0 and seed is None:
        raise ValueError(
            "flash_attention_sparse: dropout_rate > 0 requires a seed; pass "
            "one or set dropout_rate=0 for inference")
    if causal and tq != tk:
        raise ValueError("flash_attention_sparse: causal requires Tq == Tk")
    if tuple(q_seg.shape) != (b_, tq) or tuple(k_seg.shape) != (b_, tk):
        raise ValueError(
            f"flash_attention_sparse: seg shapes {tuple(q_seg.shape)}/"
            f"{tuple(k_seg.shape)} do not match q/k [{b_}, {tq}]/[{b_}, {tk}]")
    check_block_divisor(tk, "flash_attention_sparse")
    if dropout_rate == 0.0:
        seed = 0
    if not isinstance(seed, torch.Tensor):
        seed = torch.tensor([int(seed)], dtype=torch.int64)
    se = pack_se(q_seg.to(q.device), k_seg.to(q.device))
    vis = compute_block_vis(se, tq, tk, TILE, TILE, causal)

    def heads(x):  # [B, T, nh·d] -> [B, nh, T, d] view
        return x.unflatten(-1, (num_heads, d)).transpose(1, 2)

    out = _FlashAttentionSparse.apply(heads(q), heads(k), heads(v), se, vis,
                                      bool(causal), float(sm_scale),
                                      float(dropout_rate), seed)
    return out.transpose(1, 2).reshape(b_, tq, hdim)
