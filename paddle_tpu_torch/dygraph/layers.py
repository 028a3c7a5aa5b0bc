"""dygraph.Layer — the module base class (the port's counterpart of
``paddle_tpu.dygraph.layers``; reference dygraph/layers.py).

Parameters are initialised by the port's initializer ops (the startup
program's ops, run eagerly on a one-op block), each layer drawing from a
``torch.Generator`` on the guard's device seeded from the guard's seed and
the layer's number in it (``seed()``), so a guard initialises alike from
run to run. The streams are not the JAX package's (the RNGs differ by
design), so parity runs copy a JAX layer's ``state_dict()`` in with
``set_dict``. Parameter and layer names come from the port's
``unique_name``, the JAX package's generator, so two layers built alike in
the two packages name their state alike, in the same order.

A parameter's tensor is a leaf that requires grad and stays the same
tensor for the layer's life: ``set_dict`` and the optimizer copy new
values into it in place.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..core import unique_name
from ..core.dtypes import convert_dtype
from ..initializer import ConstantInitializer, XavierInitializer
from ..param_attr import ParamAttr
from .tracer import _active_tracer
from .varbase import VarBase, as_tensor


def _run_initializer(init, shape, dtype, generator, device):
    """Run a static-graph Initializer eagerly: build a one-op block and
    execute it (the same init op as the startup program)."""
    from ..core.executor import ExecContext, _run_block
    from ..core.program import Program

    prog = Program()
    blk = prog.global_block()
    v = blk.create_var(name="out", shape=list(shape),
                       dtype=convert_dtype(dtype))
    init(v, blk)
    env: Dict[str, torch.Tensor] = {}
    _run_block(blk, env, ExecContext(device, generator))
    return env["out"]


# deterministic layer-init seeding: a process-wide counter combined with the
# base seed (settable via dygraph.guard(seed=...) / seed()) — reproducible
# across interpreter runs
_INIT_SEED = [0]
_INIT_COUNTER = [0]


def seed(value: int):
    """Set the base seed for subsequent Layer parameter initialization."""
    _INIT_SEED[0] = int(value)
    _INIT_COUNTER[0] = 0


def _device():
    tr = _active_tracer()
    return tr.device if tr is not None else torch.device("cpu")


class Layer:
    def __init__(self, name_scope: Optional[str] = None, dtype="float32"):
        self._full_name = unique_name.generate(
            (name_scope or type(self).__name__.lower()))
        self._dtype = dtype
        self._parameters: "OrderedDict[str, VarBase]" = OrderedDict()
        self._sub_layers: "OrderedDict[str, Layer]" = OrderedDict()
        self._buffers: "OrderedDict[str, VarBase]" = OrderedDict()
        self.training = True
        _INIT_COUNTER[0] += 1
        self._init_seed = (_INIT_SEED[0] * 1_000_003
                           + _INIT_COUNTER[0]) % (1 << 63)
        self._init_gen = None

    def full_name(self) -> str:
        return self._full_name

    # -- parameter management ---------------------------------------------
    def create_parameter(self, shape, attr=None, dtype="float32",
                         is_bias=False, default_initializer=None) -> VarBase:
        attr = ParamAttr._to_attr(attr)
        if attr is None:
            return None
        if default_initializer is None:
            default_initializer = (ConstantInitializer(0.0) if is_bias
                                   else XavierInitializer())
        init = attr.initializer or default_initializer
        device = _device()
        if self._init_gen is None or self._init_gen.device != device:
            self._init_gen = torch.Generator(device).manual_seed(
                self._init_seed)
        value = _run_initializer(init, shape, dtype, self._init_gen, device)
        name = attr.name or unique_name.generate(
            self._full_name + (".b" if is_bias else ".w"))
        p = VarBase(value, name=name, stop_gradient=not attr.trainable,
                    persistable=True)
        p.is_parameter = True
        p.optimize_attr = {"learning_rate": attr.learning_rate}
        p.regularizer = attr.regularizer
        p.need_clip = attr.need_clip
        return p

    def register_buffer(self, name: str, value) -> VarBase:
        vb = value if isinstance(value, VarBase) else VarBase(
            value, stop_gradient=True, persistable=True)
        self._buffers[name] = vb
        return vb

    def add_parameter(self, name: str, param: VarBase) -> VarBase:
        self._parameters[name] = param
        return param

    def add_sublayer(self, name: str, layer: "Layer") -> "Layer":
        self._sub_layers[name] = layer
        return layer

    def __setattr__(self, name, value):
        if isinstance(value, VarBase) and getattr(value, "persistable", False):
            is_param = getattr(value, "is_parameter", False)
            params = self.__dict__.get("_parameters")
            if params is not None and is_param:
                params[name] = value
            bufs = self.__dict__.get("_buffers")
            if bufs is not None and not is_param:
                bufs[name] = value
        elif isinstance(value, Layer):
            subs = self.__dict__.get("_sub_layers")
            if subs is not None:
                subs[name] = value
        object.__setattr__(self, name, value)

    def parameters(self, include_sublayers: bool = True):
        out = list(self._parameters.values())
        if include_sublayers:
            for l in self._sub_layers.values():
                out.extend(l.parameters())
        return out

    def named_parameters(self, prefix="") -> Iterator[Tuple[str, VarBase]]:
        for k, v in self._parameters.items():
            yield (f"{prefix}.{k}" if prefix else k), v
        for lk, l in self._sub_layers.items():
            yield from l.named_parameters(f"{prefix}.{lk}" if prefix else lk)

    def named_buffers(self, prefix="") -> Iterator[Tuple[str, VarBase]]:
        for k, v in self._buffers.items():
            yield (f"{prefix}.{k}" if prefix else k), v
        for lk, l in self._sub_layers.items():
            yield from l.named_buffers(f"{prefix}.{lk}" if prefix else lk)

    def sublayers(self, include_self: bool = False):
        out = [self] if include_self else []
        for l in self._sub_layers.values():
            out.extend(l.sublayers(include_self=True))
        return out

    # -- modes -------------------------------------------------------------
    def train(self):
        self.training = True
        tr = _active_tracer()
        if tr is not None:
            tr.train_mode()
        for l in self._sub_layers.values():
            l.train()

    def eval(self):
        self.training = False
        tr = _active_tracer()
        if tr is not None:
            tr.eval_mode()
        for l in self._sub_layers.values():
            l.eval()

    def clear_gradients(self):
        for p in self.parameters():
            p.clear_gradient()

    # -- state dict --------------------------------------------------------
    def state_dict(self) -> Dict[str, np.ndarray]:
        out = {}
        for name, p in self.named_parameters():
            out[name] = p.numpy()
        for name, b in self.named_buffers():
            out[name] = b.numpy()
        return out

    def set_dict(self, state: Dict[str, np.ndarray]):
        """Copy `state`'s values in: a parameter's into its tensor in place
        (it stays the same autograd leaf), a buffer's as a new tensor on
        the buffer's device."""
        for name, p in self.named_parameters():
            if name in state:
                with torch.no_grad():
                    p.value.copy_(as_tensor(state[name], p.value.device))
        for name, b in self.named_buffers():
            if name in state:
                b.value = as_tensor(state[name], b.value.device)

    load_dict = set_dict

    # -- call --------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    def forward(self, *args, **kwargs):
        raise NotImplementedError
