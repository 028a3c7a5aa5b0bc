"""fluid.average (reference python/paddle/fluid/average.py): the port's copy
of ``paddle_tpu.average``."""
from __future__ import annotations

import numpy as np

__all__ = ["WeightedAverage"]


def _is_number_or_matrix(var):
    return isinstance(var, (int, float, np.ndarray)) or np.isscalar(var)


class WeightedAverage:
    """average.py WeightedAverage: running weighted mean of numpy values."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.numerator = None
        self.denominator = None

    def add(self, value, weight):
        if not _is_number_or_matrix(value):
            value = np.asarray(value)
        if self.numerator is None:
            self.numerator = value * weight
            self.denominator = weight
        else:
            self.numerator = self.numerator + value * weight
            self.denominator = self.denominator + weight

    def eval(self):
        if self.numerator is None or np.all(self.denominator == 0):
            raise ValueError("add() must be called before eval()")
        return self.numerator / self.denominator
