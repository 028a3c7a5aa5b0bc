"""Dtype utilities bridging Paddle-style dtype strings and torch dtypes.

Counterpart of ``paddle_tpu.core.dtypes``. ``dtype_str`` gives the same
strings as the JAX package, because ``Program.to_dict`` writes them and a
model directory saved by either package must load in the other.

int64 stays int64: torch indexes natively in 64 bits, so the port has no
x32 narrowing policy (the JAX package narrows int64 feeds to int32).
"""
from __future__ import annotations

import numpy as np
import torch

_STR2DTYPE = {
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "uint8": torch.uint8,
    "uint16": torch.uint16,  # packed row-major tables
    "bool": torch.bool,
}
_DTYPE2STR = {v: k for k, v in _STR2DTYPE.items()}


def convert_dtype(dtype) -> torch.dtype:
    """Normalize a dtype spec (str | torch dtype | numpy dtype) to a torch
    dtype."""
    if dtype is None:
        return torch.float32
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        if dtype not in _STR2DTYPE:
            raise ValueError(f"unsupported dtype string: {dtype}")
        return _STR2DTYPE[dtype]
    name = np.dtype(dtype).name  # numpy dtype, scalar type, ml_dtypes bf16
    if name not in _STR2DTYPE:
        raise ValueError(f"unsupported dtype: {dtype!r}")
    return _STR2DTYPE[name]


def dtype_str(dtype) -> str:
    return _DTYPE2STR[convert_dtype(dtype)]


def is_floating(dtype) -> bool:
    return convert_dtype(dtype).is_floating_point


def promote_types(a, b) -> torch.dtype:
    """The dtype of a binary op on `a` and `b`: the JAX package's
    ``jnp.promote_types`` over the port's dtypes (bfloat16 with float16 is
    float32, int8 with uint8 is int16). torch's own rule agrees but has no
    uint16 promotion, which is written out here as JAX's lattice has it:
    with bool, uint8 or uint16 it stays uint16, with a signed integer it
    widens to at least int32; floats win."""
    a, b = convert_dtype(a), convert_dtype(b)
    if torch.uint16 not in (a, b) or a == b:
        return torch.promote_types(a, b)
    other = b if a == torch.uint16 else a
    if other.is_floating_point:
        return other
    if other in (torch.bool, torch.uint8):
        return torch.uint16
    return torch.promote_types(other, torch.int32)


def itemsize(dtype) -> int:
    return torch.empty((), dtype=convert_dtype(dtype)).element_size()


def to_device(t: torch.Tensor, device) -> torch.Tensor:
    """`t` on `device` (itself when it is there already). A uint16 tensor
    (a packed row table) moves as an int16 view of the same bits: torch's
    uint16 has few kernels."""
    if t.dtype == torch.uint16:
        return t.view(torch.int16).to(device).view(torch.uint16)
    return t.to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy of a tensor (a copy on the CPU too: packed tables are
    updated in place). bfloat16 comes back as an ml_dtypes bfloat16 array
    (the type the JAX package pickles), through a uint16 view; uint16 comes
    back as uint16, through an int16 view."""
    t = t.detach()
    if t.dtype == torch.uint16:
        return t.view(torch.int16).to("cpu", copy=True).numpy().view(
            np.uint16)
    t = t.to("cpu", copy=True)
    if t.dtype != torch.bfloat16:
        return t.numpy()
    import ml_dtypes  # only needed for bf16 state; raises if absent

    return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)


def from_numpy(a, device=None, dtype=None) -> torch.Tensor:
    """Tensor from a numpy array (ml_dtypes bfloat16 included, through a
    uint16 view), optionally cast and moved."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if dtype is not None and convert_dtype(dtype) != t.dtype:
        t = t.to(convert_dtype(dtype))
    return t if device is None else to_device(t, device)
