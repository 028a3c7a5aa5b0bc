"""Fused training batch norm and fused 1×1-conv + batch norm: hand-written
Hopper kernels, their plain versions, and the autograd functions that join
them.

Replaces the TPU kernels of ``paddle_tpu/ops/pallas_kernels/fused_bn.py``
(CUDA source ``csrc/fused_bn.cu``, whose header says how each is laid out for
the card and what bounds it):

- ``bn_stats`` (K1) ← ``bn_stats`` / ``_stats_kernel``: per-channel mean and
  var in one pass, var = max(E[x²] − mean², 0).
- ``bn_apply`` and ``apply2d`` (K2) ← ``bn_apply`` and ``_apply2d`` /
  ``_apply_kernel``: (x − mean)·inv·scale + bias (+ residual) (relu).
- ``bn_bwd_reduce`` + ``bn_bwd_dx`` (K3) ← ``_bn_bwd_2d`` /
  ``_bwd_reduce_kernel`` + ``_bwd_dx_kernel``: dbeta = Σg, dgamma = Σg·x̂
  (g = dy·(y > 0) under relu), dx = inv·scale·(g − dbeta/m − x̂·dgamma/m),
  dres = g.
- ``conv_stats`` (K4) ← ``_conv_stats`` / ``_conv_stats_kernel``: the 1×1
  conv as an (M, Ci) @ (Ci, Co) product stored in x's dtype, with the
  statistics of the stored, rounded values.

Each ``*_plain`` function is the plain PyTorch version of a kernel, with the
kernel's arithmetic (f32 accumulation, the same formulas). The wrappers take
the plain version for a CPU tensor and launch the kernel for a CUDA tensor
(or raise; never a fallback), and count their launches in ``.launches``.
``_FusedBN`` and ``_FusedConvBN`` are the ``torch.autograd.Function``\\ s of
``fused_bn_act`` and ``fused_conv_bn_act`` (the JAX package's custom_vjps);
``conv_bn_xla`` is the plain composition of conv2d + batch_norm (+ add +
relu), bitwise equal to the unfused ops.

Layout. The kernels work on the channel-minor (M, C) = (N·H·W, C) view. It
is free only for an NCHW tensor stored channels-last, which is how the port
keeps conv activations (``ops.common.conv2d_nchw``); results come back as
NCHW-shaped views of channels-last memory. Any other layout is copied once
by ``to2d``. The TPU's lane fold (``_fold``, C < 128) has no counterpart: the
sums are taken without it, so they agree with the JAX package within
tolerance, not bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..common import bn_batch_stats_xla1, bn_normalize, conv2d_nchw

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_CONV_BM = 128      # K4 output rows per CTA (kConvBM in csrc/fused_bn.cu)
_MAX_REDUCE_BLOCKS = 1024

# The (Ci, Co) weight panel had to fit the TPU's VMEM beside the streaming
# blocks; kept only so that the same ops take the kernel as in the JAX
# package (ResNet-50's largest, the stage-4 shortcut 1024×2048 f32, is
# exactly 8 MiB and passes).
_MAX_W_BYTES = 8 * 1024 * 1024


def supports(x_shape, dtype) -> bool:
    """Static gate of the fused-BN path (``fused_bn.supports``): 4-D,
    lane-friendly C, and enough rows that kernel launch overhead
    amortizes."""
    if len(x_shape) != 4:
        return False
    n, c, h, w = x_shape
    if c < 8 or c > 8192 or (c < 128 and 128 % c != 0) or \
            (c >= 128 and c % 128 != 0):
        return False
    m = n * h * w
    k = 128 // c if c < 128 else 1
    mk = m // k
    return m % max(k, 1) == 0 and mk >= 1024 and mk % 8 == 0


def conv_bn_supports(x_shape, w_shape, stride) -> bool:
    """Static gate of the fused conv+BN path (``fused_bn.conv_bn_supports``):
    1×1 kernel, stride 1/2, lane-friendly channel counts, enough output rows
    to tile."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    n, ci, h, w = x_shape
    co, wci, kh, kw = w_shape
    if (kh, kw) != (1, 1) or wci != ci or stride not in (1, 2):
        return False
    if ci < 8 or co < 8 or ci > 8192 or co > 8192 or ci % 8 or co % 8:
        return False
    if ci * co * 4 > _MAX_W_BYTES:
        return False
    m = n * -(-h // stride) * -(-w // stride)
    return m >= 1024 and m % 8 == 0


def to2d(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) → the contiguous (N·H·W, C) channel-minor matrix: a view
    of a channels-last tensor, a copy of any other."""
    n, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(n * h * w, c).contiguous()


def from2d(y2: torch.Tensor, shape) -> torch.Tensor:
    """(N·H·W, C) → an (N, C, H, W) view of channels-last memory."""
    n, c, h, w = shape
    return y2.view(n, h, w, c).permute(0, 3, 1, 2)


def _subsample(x, stride):
    return x[:, :, ::stride, ::stride] if stride > 1 else x


# ---------------------------------------------------------------------------
# Plain versions (the kernels' arithmetic on (M, C) matrices)
# ---------------------------------------------------------------------------

def stats_plain(x2) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: per-column (mean, var) in f32, one-pass E[x²] − mean², clamped."""
    xf = x2.float()
    m = float(x2.shape[0])
    mean = xf.sum(0) / m
    var = torch.clamp_min((xf * xf).sum(0) / m - mean * mean, 0.0)
    return mean, var


def apply_plain(x2, mean, isc, bias, act="", res2=None):
    """K2: (x − mean)·isc + bias (+ res) (relu) in f32, rounded to x's
    dtype; isc = inv·scale."""
    y = (x2.float() - mean) * isc + bias.float()
    if res2 is not None:
        y = y + res2.float()
    if act == "relu":
        y = torch.clamp_min(y, 0.0)
    return y.to(x2.dtype)


def _relu_grad(dy2, y2):
    g = dy2.float()
    return g if y2 is None else torch.where(y2.float() > 0, g, 0.0)


def bwd_reduce_plain(dy2, x2, y2, mean, inv):
    """K3 reduce: (dbeta, dgamma) = (Σg, Σg·x̂); y2 (the saved output) is
    given only when relu was fused."""
    g = _relu_grad(dy2, y2)
    xhat = (x2.float() - mean) * inv
    return g.sum(0), (g * xhat).sum(0)


def bwd_dx_plain(dy2, x2, y2, mean, inv, isc, dbeta, dgamma, m: float,
                 has_res: bool):
    """K3 dx: dx = isc·(g − dbeta/m − x̂·dgamma/m) in x's dtype, and
    dres = g when a residual was fused."""
    g = _relu_grad(dy2, y2)
    xhat = (x2.float() - mean) * inv
    dx = isc * (g - dbeta * (1.0 / m) - xhat * (dgamma * (1.0 / m)))
    return dx.to(x2.dtype), (g.to(x2.dtype) if has_res else None)


def conv_stats_plain(xs, w):
    """K4: y2 = (M, Ci) @ (Ci, Co) with f32 accumulation, stored in xs's
    dtype, and the (mean, var) of the stored values. xs is the (subsampled)
    NCHW input, w the [Co, Ci, 1, 1] weight in xs's dtype."""
    co, ci = w.shape[:2]
    y = torch.matmul(to2d(xs).float(), w.reshape(co, ci).float().t())
    y2 = y.to(xs.dtype)
    mean, var = stats_plain(y2)
    return y2, mean, var


# ---------------------------------------------------------------------------
# Wrappers: the plain version for a CPU tensor, the kernel for a CUDA tensor
# ---------------------------------------------------------------------------

def _route(t, name) -> bool:
    """True for the kernel (a CUDA tensor), False for the plain version (a
    CPU tensor); any other device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return True


def bn_stats(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (mean, var) of NCHW x, f32 [C] (row 7, K1)."""
    x2 = to2d(x)
    if not _route(x2, "bn_stats"):
        return stats_plain(x2)
    out = _launch_stats(x2)
    bn_stats.launches += 1
    return out


bn_stats.launches = 0


def bn_apply(x, mean, inv, scale, bias, act="", residual=None):
    """act((x − mean)·inv·scale + bias [+ residual]) of NCHW x (row 8, K2)."""
    res2 = to2d(residual) if residual is not None else None
    y2 = _apply(to2d(x), mean, inv, scale, bias, act, res2, bn_apply)
    return from2d(y2, x.shape)


bn_apply.launches = 0


def apply2d(x2, mean, inv, scale, bias, act="", res2=None):
    """The same apply on the conv output's (M, Co) matrix (row 11, K2)."""
    return _apply(x2, mean, inv, scale, bias, act, res2, apply2d)


apply2d.launches = 0


def _apply(x2, mean, inv, scale, bias, act, res2, counter):
    isc = inv * scale.float()
    if not _route(x2, "bn_apply"):
        return apply_plain(x2, mean, isc, bias, act, res2)
    y2 = _launch_apply(x2, mean, isc, bias, act, res2)
    counter.launches += 1
    return y2


def bn_bwd_reduce(dy2, x2, y2, mean, inv):
    """(dbeta, dgamma) f32 [C] (row 9, K3's reduction pass)."""
    if not _route(x2, "bn_bwd_reduce"):
        return bwd_reduce_plain(dy2, x2, y2, mean, inv)
    out = _launch_bwd_reduce(dy2, x2, y2, mean, inv)
    bn_bwd_reduce.launches += 1
    return out


bn_bwd_reduce.launches = 0


def bn_bwd_dx(dy2, x2, y2, mean, inv, isc, dbeta, dgamma, m, has_res):
    """(dx2, dres2 or None) in x's dtype (row 9, K3's dx pass)."""
    if not _route(x2, "bn_bwd_dx"):
        return bwd_dx_plain(dy2, x2, y2, mean, inv, isc, dbeta, dgamma, m,
                            has_res)
    out = _launch_bwd_dx(dy2, x2, y2, mean, inv, isc, dbeta, dgamma, m,
                         has_res)
    bn_bwd_dx.launches += 1
    return out


bn_bwd_dx.launches = 0


def bn_bwd_2d(dy2, x2, y2, mean, inv, scale, has_res: bool, m: float):
    """The 2-D core of both fused backwards (``_bn_bwd_2d``): one reduction
    pass, then one dx pass. y2 is the saved output when relu was fused, else
    None. Returns (dx2, dgamma, dbeta, dres2 or None)."""
    dy2 = dy2.to(x2.dtype)
    dbeta, dgamma = bn_bwd_reduce(dy2, x2, y2, mean, inv)
    isc = inv * scale.float()
    dx2, dres2 = bn_bwd_dx(dy2, x2, y2, mean, inv, isc, dbeta, dgamma, m,
                           has_res)
    return dx2, dgamma, dbeta, dres2


def conv_stats(xs, w):
    """(y2 [M, Co] in xs's dtype, mean, var) of the 1×1 conv of the
    (subsampled) NCHW xs by w [Co, Ci, 1, 1] (row 10, K4)."""
    if not _route(xs, "conv_stats"):
        return conv_stats_plain(xs, w)
    out = _launch_conv_stats(xs, w)
    conv_stats.launches += 1
    return out


conv_stats.launches = 0


# ---------------------------------------------------------------------------
# Kernel launches (ctypes; the library is built at first use)
# ---------------------------------------------------------------------------

_PTR, _I32, _I64, _F32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
_ARGTYPES = {
    "fused_bn_stats": [_PTR, _I64, _I32, _I32, _I32, _PTR, _PTR, _PTR, _PTR],
    "fused_bn_apply": [_PTR] * 6 + [_I64, _I32, _I32, _I32, _PTR],
    "fused_bn_bwd_reduce": [_PTR] * 5 + [_I64, _I32, _I32, _I32, _I32]
    + [_PTR] * 4,
    "fused_bn_bwd_dx": [_PTR] * 10 + [_I64, _I32, _I32, _F32, _I32, _PTR],
    "fused_conv_stats": [_PTR] * 3 + [_I32] * 3 + [_I64] * 3 + [_I32] * 3
    + [_PTR] * 4,
}


def _lib():
    from . import build

    lib = build.load("fused_bn")
    if lib.fused_bn_error_string.restype is not ctypes.c_char_p:
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.fused_bn_error_string.argtypes = [ctypes.c_int]
        lib.fused_bn_error_string.restype = ctypes.c_char_p
    return lib


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(lib, err, name):
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed: "
                           f"{lib.fused_bn_error_string(err).decode()}")


def _check2d(name, *ts):
    """The kernels take contiguous (M, C) matrices of one dtype on one
    device, C a whole number of 16-byte vectors, 16-byte aligned."""
    ref = ts[0]
    if ref.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {ref.dtype} has no kernel; "
                        f"supported: float32, bfloat16")
    vec = 16 // ref.element_size()
    for t in ts:
        if t is None:
            continue
        if t.device != ref.device or t.dtype != ref.dtype or \
                t.shape != ref.shape:
            raise ValueError(f"{name}: operands differ in device, dtype or "
                             f"shape: {t.device} {t.dtype} {tuple(t.shape)} "
                             f"vs {ref.device} {ref.dtype} "
                             f"{tuple(ref.shape)}")
        if t.ndim != 2 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: needs contiguous 16-byte aligned "
                             f"(M, C) matrices")
    if ref.shape[1] % vec:
        raise ValueError(f"{name}: C = {ref.shape[1]} is not a multiple of "
                         f"{vec} ({ref.dtype})")


def _vec(v, like):
    """A per-channel vector as a contiguous f32 tensor on `like`'s device."""
    return v.to(device=like.device, dtype=torch.float32).contiguous()


def _nblocks(m, c, itemsize) -> int:
    """Row blocks of a K1/K3 reduction: about four passes of a CTA's rows
    each, and at most ~1024 CTAs over all channel chunks."""
    vec = 16 // itemsize
    nvec = c // vec
    per = min(nvec, 32)
    chunks = -(-nvec // per)
    rows = 256 // per
    return max(1, min(-(-m // (4 * rows)),
                      max(1, _MAX_REDUCE_BLOCKS // chunks)))


def _launch_stats(x2):
    _check2d("bn_stats", x2)
    m, c = x2.shape
    nb = _nblocks(m, c, x2.element_size())
    part = torch.empty((2, nb, c), dtype=torch.float32, device=x2.device)
    mean = torch.empty(c, dtype=torch.float32, device=x2.device)
    var = torch.empty_like(mean)
    lib = _lib()
    with torch.cuda.device(x2.device):
        err = lib.fused_bn_stats(x2.data_ptr(), m, c, _DTYPE_CODE[x2.dtype],
                                 nb, part.data_ptr(), mean.data_ptr(),
                                 var.data_ptr(), _stream(x2))
    _raise_on(lib, err, "bn_stats")
    return mean, var


def _launch_apply(x2, mean, isc, bias, act, res2):
    _check2d("bn_apply", x2, res2)
    m, c = x2.shape
    mean, isc, bias = (_vec(v, x2) for v in (mean, isc, bias))
    y2 = torch.empty_like(x2)
    lib = _lib()
    with torch.cuda.device(x2.device):
        err = lib.fused_bn_apply(
            x2.data_ptr(), res2.data_ptr() if res2 is not None else None,
            y2.data_ptr(), mean.data_ptr(), isc.data_ptr(), bias.data_ptr(),
            m, c, int(act == "relu"), _DTYPE_CODE[x2.dtype], _stream(x2))
    _raise_on(lib, err, "bn_apply")
    return y2


def _launch_bwd_reduce(dy2, x2, y2, mean, inv):
    _check2d("bn_bwd_reduce", x2, dy2, y2)
    m, c = x2.shape
    mean, inv = _vec(mean, x2), _vec(inv, x2)
    nb = _nblocks(m, c, x2.element_size())
    part = torch.empty((2, nb, c), dtype=torch.float32, device=x2.device)
    dbeta = torch.empty(c, dtype=torch.float32, device=x2.device)
    dgamma = torch.empty_like(dbeta)
    lib = _lib()
    with torch.cuda.device(x2.device):
        err = lib.fused_bn_bwd_reduce(
            dy2.data_ptr(), x2.data_ptr(),
            y2.data_ptr() if y2 is not None else None, mean.data_ptr(),
            inv.data_ptr(), m, c, int(y2 is not None), _DTYPE_CODE[x2.dtype],
            nb, part.data_ptr(), dbeta.data_ptr(), dgamma.data_ptr(),
            _stream(x2))
    _raise_on(lib, err, "bn_bwd_reduce")
    return dbeta, dgamma


def _launch_bwd_dx(dy2, x2, y2, mean, inv, isc, dbeta, dgamma, m_rows,
                   has_res):
    _check2d("bn_bwd_dx", x2, dy2, y2)
    m, c = x2.shape
    mean, inv, isc, dbeta, dgamma = (_vec(v, x2) for v in
                                     (mean, inv, isc, dbeta, dgamma))
    dx2 = torch.empty_like(x2)
    dres2 = torch.empty_like(x2) if has_res else None
    lib = _lib()
    with torch.cuda.device(x2.device):
        err = lib.fused_bn_bwd_dx(
            dy2.data_ptr(), x2.data_ptr(),
            y2.data_ptr() if y2 is not None else None, mean.data_ptr(),
            inv.data_ptr(), isc.data_ptr(), dbeta.data_ptr(),
            dgamma.data_ptr(), dx2.data_ptr(),
            dres2.data_ptr() if has_res else None, m, c,
            int(y2 is not None), float(1.0 / m_rows), _DTYPE_CODE[x2.dtype],
            _stream(x2))
    _raise_on(lib, err, "bn_bwd_dx")
    return dx2, dres2


def _launch_conv_stats(xs, w):
    name = "conv_stats"
    if xs.dtype not in _DTYPE_CODE or w.dtype != xs.dtype:
        raise TypeError(f"{name}: x and w must share one dtype of float32/"
                        f"bfloat16, got {xs.dtype}, {w.dtype}")
    if w.device != xs.device:
        raise ValueError(f"{name}: x on {xs.device}, w on {w.device}")
    vec = 16 // xs.element_size()
    n, ci, hs, ws = xs.shape
    co = w.shape[0]
    if ci % vec or co % 2:
        raise ValueError(f"{name}: Ci = {ci} must be a multiple of {vec} and "
                         f"Co = {co} even")
    if xs.stride(1) != 1:
        # the kernel reads rows of contiguous channels: a copy to
        # channels-last for an input in any other layout
        xs = xs.contiguous(memory_format=torch.channels_last)
    sn, _, sh, sw = xs.stride()
    if xs.data_ptr() % 16 or any(s % vec for s in (sn, sh, sw)):
        raise ValueError(f"{name}: x rows must be 16-byte aligned, got "
                         f"strides {xs.stride()}")
    w2 = w.reshape(co, ci).contiguous()
    m = n * hs * ws
    mtiles = -(-m // _CONV_BM)
    y2 = torch.empty((m, co), dtype=xs.dtype, device=xs.device)
    part = torch.empty((2, mtiles, co), dtype=torch.float32, device=xs.device)
    mean = torch.empty(co, dtype=torch.float32, device=xs.device)
    var = torch.empty_like(mean)
    lib = _lib()
    with torch.cuda.device(xs.device):
        err = lib.fused_conv_stats(
            xs.data_ptr(), w2.data_ptr(), y2.data_ptr(), n, hs, ws, sn, sh, sw,
            ci, co, _DTYPE_CODE[xs.dtype], part.data_ptr(), mean.data_ptr(),
            var.data_ptr(), _stream(xs))
    _raise_on(lib, err, name)
    return y2, mean, var


# ---------------------------------------------------------------------------
# Autograd: the fused ops (the JAX package's custom_vjps)
# ---------------------------------------------------------------------------

class _FusedBN(torch.autograd.Function):
    """(y, mean, var) = fused_bn_act(x, scale, bias, residual); saves what
    ``_fused_fwd`` saves: x, scale, mean, inv and y under relu."""

    @staticmethod
    def forward(ctx, x, scale, bias, residual, eps, act):
        if residual is not None:
            # the kernels read one dtype; autograd casts dres back
            residual = residual.to(x.dtype)
        mean, var = bn_stats(x)
        inv = torch.rsqrt(var + eps)
        y = bn_apply(x, mean, inv, scale, bias, act, residual)
        ctx.save_for_backward(x, scale, mean, inv,
                              y if act == "relu" else None)
        ctx.has_res = residual is not None
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, mean, inv, y = ctx.saved_tensors
        n, c, h, w = x.shape
        dx2, dgamma, dbeta, dres2 = bn_bwd_2d(
            to2d(dy), to2d(x), to2d(y) if y is not None else None, mean, inv,
            scale, ctx.has_res, float(n * h * w))
        dres = from2d(dres2, x.shape) if ctx.has_res else None
        return (from2d(dx2, x.shape), dgamma.to(scale.dtype),
                dbeta.to(scale.dtype), dres, None, None)


def fused_bn_act(x, scale, bias, eps, act, residual_tag, residual=None):
    """Training-mode fused BN: y = act(x̂·scale + bias [+ residual]).
    Returns (y, mean, var) with mean/var the f32 batch statistics (for the
    running-stat update; they carry no gradient). `residual_tag` records
    whether a residual is fused, as in the JAX package."""
    if bool(residual_tag) != (residual is not None):
        raise ValueError("fused_bn_act: residual_tag must say whether a "
                         "residual is given")
    return _FusedBN.apply(x, scale, bias, residual, float(eps), act)


class _FusedConvBN(torch.autograd.Function):
    """(y, mean, var) = fused_conv_bn_act(x, w, scale, bias, residual);
    saves what ``_conv_bn_fwd`` saves: x, w, scale, mean, inv, the rounded
    conv output and y under relu. The backward's two GEMMs are
    ``torch.matmul``, as the JAX package leaves them to XLA; the stride-2 dx
    is scattered into zeros."""

    @staticmethod
    def forward(ctx, x, w, scale, bias, residual, eps, act, stride):
        xs = _subsample(x, stride)
        n, _, hs, ws = xs.shape
        co = w.shape[0]
        yc2, mean, var = conv_stats(xs, w)
        inv = torch.rsqrt(var + eps)
        # the kernels read one dtype; autograd casts dres back
        res2 = to2d(residual.to(x.dtype)) if residual is not None else None
        y2 = apply2d(yc2, mean, inv, scale, bias, act, res2)
        ctx.save_for_backward(x, w, scale, mean, inv, yc2,
                              y2 if act == "relu" else None)
        ctx.args = (stride, residual is not None)
        ctx.mark_non_differentiable(mean, var)
        return from2d(y2, (n, co, hs, ws)), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, w, scale, mean, inv, yc2, y2 = ctx.saved_tensors
        stride, has_res = ctx.args
        co, ci = w.shape[:2]
        dyc2, dgamma, dbeta, dres2 = bn_bwd_2d(
            to2d(dy), yc2, y2, mean, inv, scale, has_res,
            float(yc2.shape[0]))
        xs = _subsample(x, stride)
        w2 = w.reshape(co, ci)
        dx_sub = from2d(torch.matmul(dyc2, w2).to(x.dtype), xs.shape)
        if stride > 1:
            dx = torch.zeros_like(x, memory_format=torch.channels_last)
            dx[:, :, ::stride, ::stride] = dx_sub
        else:
            dx = dx_sub
        dw = torch.matmul(dyc2.t(), to2d(xs)).reshape(w.shape).to(w.dtype)
        dres = from2d(dres2, dy.shape) if has_res else None
        return (dx, dw, dgamma.to(scale.dtype), dbeta.to(scale.dtype), dres,
                None, None, None)


def fused_conv_bn_act(x, w, scale, bias, eps, act, stride, residual_tag,
                      residual=None):
    """Fused 1×1-conv + training BN: y = act(BN(conv(x, w)) [+ residual]).
    x is NCHW, w is OIHW with a 1×1 kernel in x's dtype; returns (y, mean,
    var) with mean/var the f32 batch statistics of the conv output."""
    if bool(residual_tag) != (residual is not None):
        raise ValueError("fused_conv_bn_act: residual_tag must say whether a "
                         "residual is given")
    return _FusedConvBN.apply(x, w, scale, bias, residual, float(eps), act,
                              int(stride))


def conv_bn_xla(x, w, scale, bias, eps, act, stride, residual=None,
                use_mean: Optional[torch.Tensor] = None,
                use_var: Optional[torch.Tensor] = None):
    """The plain composition with the exact math of the separate conv2d +
    batch_norm ("xla1") (+ elementwise_add + relu) ops: bitwise equal to
    them, which is what makes the fused op safe to enable per model.
    `use_mean`/`use_var` switch to frozen (inference) statistics. Returns
    (y, mean, var)."""
    y = conv2d_nchw(x, w, (stride, stride))
    if use_mean is None:
        mean, var = bn_batch_stats_xla1(y, (0, 2, 3))
    else:
        mean, var = use_mean.float(), use_var.float()
    out = bn_normalize(y, mean, var, scale, bias, eps, (1, -1, 1, 1))
    if residual is not None:
        out = out + residual
    if act == "relu":
        out = torch.relu(out)
    return out, mean, var
