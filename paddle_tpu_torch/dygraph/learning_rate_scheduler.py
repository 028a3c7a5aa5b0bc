"""Dygraph LR decay objects (the port's copy of
``paddle_tpu.dygraph.learning_rate_scheduler``, pure Python; reference
dygraph/learning_rate_scheduler.py:
NoamDecay, PiecewiseDecay, NaturalExpDecay, ExponentialDecay,
InverseTimeDecay, PolynomialDecay, CosineDecay).

Each decay is a stateful callable — `step()` advances and
returns the current lr; optimizers accept the float it produces. The math
mirrors layers/learning_rate_scheduler.py (the static-graph schedules),
reference semantics preserved.
"""
from __future__ import annotations

import math


class LearningRateDecay:
    def __init__(self, begin=0, step=1, dtype="float32"):
        self.step_num = begin
        self.step_size = step

    def __call__(self):
        lr = self.create_lr_var(self.step())
        self.step_num += self.step_size
        return lr

    def create_lr_var(self, lr):
        return float(lr)

    def step(self):
        raise NotImplementedError()


class NoamDecay(LearningRateDecay):
    def __init__(self, d_model, warmup_steps, begin=1, step=1,
                 dtype="float32"):
        super().__init__(begin, step, dtype)
        self.d_model = d_model
        self.warmup_steps = warmup_steps

    def step(self):
        a = self.step_num ** -0.5
        b = (self.warmup_steps ** -1.5) * self.step_num
        return (self.d_model ** -0.5) * min(a, b)


class PiecewiseDecay(LearningRateDecay):
    def __init__(self, boundaries, values, begin, step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.boundaries = list(boundaries)
        self.values = list(values)

    def step(self):
        for i, b in enumerate(self.boundaries):
            if self.step_num < b:
                return self.values[i]
        return self.values[len(self.boundaries)]


class NaturalExpDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, decay_rate,
                 staircase=False, begin=0, step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.learning_rate = learning_rate
        self.decay_steps = decay_steps
        self.decay_rate = decay_rate
        self.staircase = staircase

    def step(self):
        div = self.step_num / self.decay_steps
        if self.staircase:
            div = math.floor(div)
        return self.learning_rate * math.exp(-self.decay_rate * div)


class ExponentialDecay(NaturalExpDecay):
    def step(self):
        div = self.step_num / self.decay_steps
        if self.staircase:
            div = math.floor(div)
        return self.learning_rate * (self.decay_rate ** div)


class InverseTimeDecay(NaturalExpDecay):
    def step(self):
        div = self.step_num / self.decay_steps
        if self.staircase:
            div = math.floor(div)
        return self.learning_rate / (1.0 + self.decay_rate * div)


class PolynomialDecay(LearningRateDecay):
    def __init__(self, learning_rate, decay_steps, end_learning_rate=0.0001,
                 power=1.0, cycle=False, begin=0, step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.learning_rate = learning_rate
        self.decay_steps = decay_steps
        self.end_learning_rate = end_learning_rate
        self.power = power
        self.cycle = cycle

    def step(self):
        n = self.step_num
        steps = self.decay_steps
        if self.cycle:
            div = math.ceil(max(n, 1) / steps)
            steps = steps * max(div, 1)
        else:
            n = min(n, steps)
        frac = (1.0 - n / steps) ** self.power
        return ((self.learning_rate - self.end_learning_rate) * frac
                + self.end_learning_rate)


class CosineDecay(LearningRateDecay):
    def __init__(self, learning_rate, step_each_epoch, epochs, begin=0,
                 step=1, dtype="float32"):
        super().__init__(begin, step, dtype)
        self.learning_rate = learning_rate
        self.step_each_epoch = step_each_epoch
        self.epochs = epochs

    def step(self):
        cur_epoch = math.floor(self.step_num / self.step_each_epoch)
        return self.learning_rate * 0.5 * (
            math.cos(cur_epoch * math.pi / self.epochs) + 1)
