"""Learning-rate schedules, emitted as ops over a step counter: the port's
copy of ``paddle_tpu.layers.learning_rate_scheduler`` (reference
``python/paddle/fluid/layers/learning_rate_scheduler.py``: noam,
exponential, natural_exp, inverse_time, polynomial, piecewise, cosine and
linear warmup).

One `lr_schedule` op computes lr(step) from a persistable step counter and
advances the counter; schedules compose (warmup wraps a base schedule, and
each op has a counter of its own, so each advances once a step).

The op computes in float32 on the step's own device and reads nothing back
to the host: the constants it indexes (piecewise's boundaries and values,
warmup's constant after-rate) are built once per op attributes and device
and cached, so a warm step makes no host-to-device copy. The counter is
int64, where the JAX package's is int32 (it runs without x64).
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from ..core.registry import register_op
from ..initializer import ConstantInitializer
from ..layer_helper import LayerHelper

_STEP_VAR = "@LR_DECAY_COUNTER@"

# (what, attr values, device) -> f32 tensor on that device
_CONSTS: Dict[tuple, torch.Tensor] = {}


def _const(key, values, device) -> torch.Tensor:
    k = (key, tuple(values), str(device))
    t = _CONSTS.get(k)
    if t is None:
        t = _CONSTS[k] = torch.tensor(list(values), dtype=torch.float32,
                                      device=device)
    return t


@register_op("lr_schedule", differentiable=False)
def _lr_schedule(ctx, inputs, attrs):
    (step,) = inputs["Step"]
    s = step.reshape(()).to(torch.float32)
    kind = attrs["kind"]
    lr = attrs.get("learning_rate", 1.0)
    if kind == "noam":
        d = attrs["d_model"]
        w = attrs["warmup_steps"]
        val = lr * (d ** -0.5) * torch.minimum((s + 1) ** -0.5,
                                               (s + 1) * (w ** -1.5))
    elif kind in ("exponential", "natural_exp", "inverse_time"):
        decay = attrs["decay_rate"]
        exp = s / attrs["decay_steps"]
        if attrs.get("staircase", False):
            exp = torch.floor(exp)
        if kind == "exponential":
            val = lr * (decay ** exp)
        elif kind == "natural_exp":
            val = lr * torch.exp(-decay * exp)
        else:
            val = lr / (1.0 + decay * exp)
    elif kind == "polynomial":
        end = attrs["end_learning_rate"]
        power = attrs["power"]
        steps = attrs["decay_steps"]
        if attrs.get("cycle", False):
            div = torch.ceil(s.clamp_min(1.0) / steps)
            steps_t = steps * div.clamp_min(1.0)
            frac = torch.minimum(s, steps_t) / steps_t
        else:
            frac = s.clamp_max(float(steps)) / steps
        val = (lr - end) * ((1.0 - frac) ** power) + end
    elif kind == "piecewise":
        bounds = _const("bounds", attrs["boundaries"], s.device)
        values = _const("values", attrs["values"], s.device)
        idx = (s >= bounds).to(torch.int64).sum()
        # index_select, not values[idx]: a 0-dim index tensor would be read
        # back to the host
        val = values.index_select(0, idx.reshape(1))
    elif kind == "cosine":
        cur_epoch = torch.floor(s / attrs["step_each_epoch"])
        val = lr * 0.5 * (torch.cos(cur_epoch * math.pi / attrs["epochs"])
                          + 1.0)
    elif kind == "warmup":
        w = attrs["warmup_steps"]
        start = attrs["start_lr"]
        end_lr = attrs["end_lr"]
        if "Base" in inputs:
            after = inputs["Base"][0].reshape(())
        else:
            after = _const("after", [attrs.get("after_lr", end_lr)],
                           s.device).reshape(())
        warm = start + (end_lr - start) * (s / w)
        val = torch.where(s < w, warm, after)
    else:
        raise ValueError(f"unknown schedule {kind}")
    return {"Out": [val.reshape((1,))], "StepOut": [step + 1]}


def _global_step(helper: LayerHelper):
    # one counter per schedule op: composed schedules (warmup over a base
    # decay) each advance their own counter exactly once per executed step
    return helper.create_global_variable(
        [1], "int64", name=f"{_STEP_VAR}{helper.name}",
        initializer=ConstantInitializer(0.0))


def _schedule(kind: str, base_lr_var=None, **attrs):
    helper = LayerHelper(f"lr_{kind}")
    step = _global_step(helper)
    lr = helper.create_global_variable([1], "float32",
                                       name=f"lr_{kind}_{helper.name}",
                                       initializer=ConstantInitializer(
                                           attrs.get("learning_rate", 0.0)))
    ins = {"Step": [step.name]}
    if base_lr_var is not None:
        ins["Base"] = [base_lr_var.name]
    helper.append_op(type="lr_schedule", inputs=ins,
                     outputs={"Out": [lr.name], "StepOut": [step.name]},
                     attrs=dict(attrs, kind=kind))
    return lr


def noam_decay(d_model, warmup_steps, learning_rate: float = 1.0):
    return _schedule("noam", d_model=d_model, warmup_steps=warmup_steps,
                     learning_rate=learning_rate)


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    return _schedule("exponential", learning_rate=learning_rate,
                     decay_steps=decay_steps, decay_rate=decay_rate,
                     staircase=staircase)


def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    return _schedule("natural_exp", learning_rate=learning_rate,
                     decay_steps=decay_steps, decay_rate=decay_rate,
                     staircase=staircase)


def inverse_time_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    return _schedule("inverse_time", learning_rate=learning_rate,
                     decay_steps=decay_steps, decay_rate=decay_rate,
                     staircase=staircase)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=1e-4,
                     power=1.0, cycle=False):
    return _schedule("polynomial", learning_rate=learning_rate,
                     decay_steps=decay_steps, end_learning_rate=end_learning_rate,
                     power=power, cycle=cycle)


def piecewise_decay(boundaries: List[int], values: List[float]):
    return _schedule("piecewise", boundaries=list(boundaries), values=list(values),
                     learning_rate=values[0])


def cosine_decay(learning_rate, step_each_epoch, epochs):
    return _schedule("cosine", learning_rate=learning_rate,
                     step_each_epoch=step_each_epoch, epochs=epochs)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    """Ramp start_lr→end_lr over warmup_steps, then use `learning_rate`
    (float or schedule var) — reference linear_lr_warmup semantics."""
    base = learning_rate if hasattr(learning_rate, "name") else None
    attrs = dict(warmup_steps=warmup_steps, start_lr=start_lr, end_lr=end_lr)
    if base is None:
        attrs["after_lr"] = float(learning_rate)
    return _schedule("warmup", base_lr_var=base, **attrs)
