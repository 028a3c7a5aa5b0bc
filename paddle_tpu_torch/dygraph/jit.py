"""dygraph.jit — a Layer's forward as one function of its parameter and
buffer values (the port's counterpart of ``paddle_tpu.dygraph.jit``).

The wrapper swaps the given parameter and buffer values into the live
VarBases, runs the forward under ``no_grad`` and writes the new buffer
values back (a BatchNorm's running statistics in training mode), as the JAX
package's does. There the function is traced once into one XLA executable;
in the port it is the same functional forward run eagerly, op by op, so the
values are the same and only the single dispatch is missing: capturing it
into one CUDA graph per input signature is CUDA-graph work (ROADMAP A2).

Usage::

    model = MyLayer()
    fast = dygraph.jit(model)
    out = fast(x_varbase_or_array)      # same params, no autograd
"""
from __future__ import annotations

from typing import Dict

import torch

from .layers import Layer
from .varbase import VarBase, as_tensor


def _tree_map(fn, out):
    if isinstance(out, (list, tuple)):
        return type(out)(_tree_map(fn, o) for o in out)
    if isinstance(out, dict):
        return {k: _tree_map(fn, v) for k, v in out.items()}
    return fn(out)


def jit(layer: Layer, static_argnums=()):
    """The wrapper (module docstring). `static_argnums` is the JAX
    package's signature: nothing is traced here, so every argument is
    taken as it is."""
    params = dict(layer.named_parameters())
    buffers = dict(layer.named_buffers())

    def _functional(param_vals: Dict[str, torch.Tensor],
                    buffer_vals: Dict[str, torch.Tensor], *args):
        # swap values into the live VarBases and run the forward
        old_p = {k: p.value for k, p in params.items()}
        old_b = {k: b.value for k, b in buffers.items()}
        try:
            for k, p in params.items():
                p.value = param_vals[k]
            for k, b in buffers.items():
                b.value = buffer_vals[k]
            vargs = [a if isinstance(a, VarBase)
                     else VarBase(a, stop_gradient=True) for a in args]
            from .base import no_grad
            with no_grad():  # inference path: nothing is taped
                out = layer(*vargs)
            out_val = _tree_map(
                lambda o: o.value if isinstance(o, VarBase) else o, out)
            new_b = {k: b.value for k, b in buffers.items()}
            return out_val, new_b
        finally:
            for k, p in params.items():
                p.value = old_p[k]
            for k, b in buffers.items():
                b.value = old_b[k]

    def wrapper(*args):
        from .tracer import _active_tracer
        tr = _active_tracer()
        dev = tr.device if tr is not None else None
        arg_vals = [a.value if isinstance(a, VarBase) else as_tensor(a, dev)
                    for a in args]
        out_val, new_b = _functional(
            {k: p.value for k, p in params.items()},
            {k: b.value for k, b in buffers.items()}, *arg_vals)
        for k, b in buffers.items():
            b.value = new_b[k]
        return _tree_map(lambda v: VarBase(v, stop_gradient=True)
                         if isinstance(v, torch.Tensor) else v, out_val)

    return wrapper
