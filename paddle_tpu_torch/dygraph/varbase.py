"""VarBase — an eager tensor with autograd linkage (the port's counterpart
of ``paddle_tpu.dygraph.varbase``; reference imperative/layer.h:55).

`value` is a ``torch.Tensor`` on the guard's device. A VarBase the user
makes (``to_variable``, a layer's parameter) holds a leaf: ``stop_gradient``
False makes a floating leaf require grad, True stops it. An op's output
holds what the op returned (a non-leaf when autograd recorded it), and its
``stop_gradient`` flag is what the tracer reads, as in the JAX package.
`grad_value` is the gradient the tracer's backward summed into it
(``dygraph/tracer.py``); torch's own ``.grad`` is not used.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import unique_name
from ..core.dtypes import from_numpy, to_numpy


def as_tensor(value, device=None) -> torch.Tensor:
    """`value` as a tensor: a tensor stays where it is unless `device` is
    given; an array goes to `device` (the active guard's, else the CPU).
    float64 becomes float32 as the JAX package's arrays do; int64 stays
    int64 (the port's dtype rule)."""
    if isinstance(value, torch.Tensor):
        return value if device is None else value.to(device)
    if device is None:
        from .tracer import _active_tracer
        tr = _active_tracer()
        device = tr.device if tr is not None else torch.device("cpu")
    arr = np.asarray(value)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return from_numpy(arr, device=device)


class VarBase:
    def __init__(self, value, name: Optional[str] = None,
                 stop_gradient: bool = False, persistable: bool = False):
        self.value = as_tensor(value)
        self.name = name or unique_name.generate("dy_var")
        self.stop_gradient = stop_gradient
        self.persistable = persistable
        self.grad_value = None  # the summed gradient (a tensor)
        self.trainable = not stop_gradient

    @classmethod
    def _wrap(cls, value: torch.Tensor, stop_gradient: bool) -> "VarBase":
        """An op's output: the flag is set without touching the tensor's
        requires_grad (autograd decided it)."""
        v = cls.__new__(cls)
        v.value = value
        v.name = unique_name.generate("dy_var")
        v._stop_gradient = stop_gradient
        v.persistable = False
        v.grad_value = None
        v.trainable = not stop_gradient
        return v

    @property
    def stop_gradient(self) -> bool:
        return self._stop_gradient

    @stop_gradient.setter
    def stop_gradient(self, flag: bool):
        self._stop_gradient = bool(flag)
        t = self.value
        if t.is_leaf and (t.is_floating_point() or t.is_complex()):
            t.requires_grad_(not flag)

    # -- paddle api --------------------------------------------------------
    @property
    def shape(self):
        return tuple(self.value.shape)

    @property
    def dtype(self):
        return self.value.dtype

    def numpy(self) -> np.ndarray:
        return to_numpy(self.value)

    @property
    def gradient(self):
        return None if self.grad_value is None else to_numpy(self.grad_value)

    def clear_gradient(self):
        self.grad_value = None

    def detach(self) -> "VarBase":
        return VarBase(self.value.detach(), stop_gradient=True)

    def backward(self, backward_strategy=None):
        from .tracer import _active_tracer
        tr = _active_tracer()
        if tr is None:
            raise RuntimeError("backward() outside dygraph guard")
        tr.run_backward(self)

    def astype(self, dtype):
        from .tracer import trace_op
        return trace_op("cast", {"X": [self]},
                        {"out_dtype": str(np.dtype(dtype))})["Out"][0]

    def __repr__(self):
        return (f"VarBase(name={self.name}, shape={self.shape}, "
                f"stop_gradient={self.stop_gradient})\n{self.numpy()}")

    # math dunders are attached by math_ops_patch (imported by dygraph.base)
