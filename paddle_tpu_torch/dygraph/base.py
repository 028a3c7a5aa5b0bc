"""dygraph.guard / to_variable / no_grad (the port's counterpart of
``paddle_tpu.dygraph.base``; reference dygraph/base.py).

``guard()`` runs on the card unless the caller asks for the CPU: with no
place it is ``CUDAPlace(0)``, which raises where torch sees no GPU. Every
VarBase made inside it (``to_variable``, parameters, op outputs) lives on
that device."""
from __future__ import annotations

import contextlib
import functools

from ..core import program as prog_mod
from ..core.executor import CUDAPlace
from .tracer import Tracer, _active_tracer, _set_tracer
from .varbase import VarBase, as_tensor
from . import math_ops_patch  # noqa: F401  (attaches dunders to VarBase)


def enabled() -> bool:
    return _active_tracer() is not None


@contextlib.contextmanager
def guard(place=None, seed: int = 0):
    from . import layers as _layers

    device = (place if place is not None else CUDAPlace(0)).torch_device()
    tracer = Tracer(seed=seed, device=device)
    old = _active_tracer()
    old_prog = prog_mod._current_tracer()
    _set_tracer(tracer)
    prog_mod._set_dygraph_tracer(tracer)
    _layers.seed(seed)  # deterministic layer init per guard
    try:
        yield
    finally:
        _set_tracer(old)
        prog_mod._set_dygraph_tracer(old_prog)


def to_variable(value, name=None, zero_copy=None) -> VarBase:
    """A VarBase on the active guard's device (the CPU outside one); feed
    data is a leaf that stops gradient until the user says otherwise."""
    if isinstance(value, VarBase):
        return value
    tr = _active_tracer()
    t = as_tensor(value, device=tr.device if tr is not None else None)
    return VarBase(t, name=name, stop_gradient=True)


class no_grad:
    """Context manager AND decorator disabling autograd taping."""

    def __enter__(self):
        tr = _active_tracer()
        if tr is not None:
            tr._no_grad_depth += 1
        return self

    def __exit__(self, *exc):
        tr = _active_tracer()
        if tr is not None:
            tr._no_grad_depth -= 1
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with no_grad():
                return fn(*a, **kw)
        return wrapper
