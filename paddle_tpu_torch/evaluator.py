"""fluid.evaluator (reference python/paddle/fluid/evaluator.py — the
deprecated Evaluator classes; the modern equivalents live in
paddle_tpu_torch.metrics, which these delegate to): the port's copy of
``paddle_tpu.evaluator``."""
from __future__ import annotations

from . import metrics as _metrics

__all__ = ["Evaluator", "ChunkEvaluator", "EditDistance", "DetectionMAP"]


class Evaluator:
    """evaluator.py Evaluator base (deprecated in the reference too): keeps
    per-pass accumulator state; subclasses map onto metrics classes."""

    def __init__(self, name=None, **kwargs):
        self._name = name
        self.states = []
        self.metrics = []

    def reset(self, executor=None, reset_program=None):
        for m in self.metrics:
            if hasattr(m, "reset"):
                m.reset()

    def eval(self, executor=None, eval_program=None):
        raise NotImplementedError()


class ChunkEvaluator(Evaluator):
    def __init__(self, input=None, label=None, chunk_scheme=None,
                 num_chunk_types=None, excluded_chunk_types=None):
        super().__init__()
        self._impl = _metrics.ChunkEvaluator()
        self.metrics = [self._impl]

    def update(self, *args, **kw):
        return self._impl.update(*args, **kw)

    def eval(self, executor=None, eval_program=None):
        return self._impl.eval()


class EditDistance(Evaluator):
    def __init__(self, input=None, label=None, ignored_tokens=None,
                 **kwargs):
        super().__init__()
        self._impl = _metrics.EditDistance("edit_distance")
        self.metrics = [self._impl]

    def update(self, *args, **kw):
        return self._impl.update(*args, **kw)

    def eval(self, executor=None, eval_program=None):
        return self._impl.eval()


class DetectionMAP(Evaluator):
    def __init__(self, input=None, gt_label=None, gt_box=None,
                 gt_difficult=None, class_num=None, background_label=0,
                 overlap_threshold=0.5, evaluate_difficult=True,
                 ap_version="integral"):
        super().__init__()
        self._impl = _metrics.DetectionMAP(class_num=class_num,
                                           ap_version=ap_version)
        self.metrics = [self._impl]

    def update(self, *args, **kw):
        return self._impl.update(*args, **kw)

    def eval(self, executor=None, eval_program=None):
        return self._impl.eval()
