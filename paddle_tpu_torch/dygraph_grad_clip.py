"""fluid.dygraph_grad_clip (the port's counterpart of
``paddle_tpu.dygraph_grad_clip``; reference dygraph_grad_clip.py — the
dygraph clip classes, the same math as ``clip``, on VarBase gradients of
torch tensors)."""
from __future__ import annotations

import torch

__all__ = ["GradClipByValue", "GradClipByNorm", "GradClipByGlobalNorm"]


class _DygraphClipBase:
    def __call__(self, params_grads):
        return [(p, self._clip(g)) for p, g in params_grads]


class GradClipByValue(_DygraphClipBase):
    def __init__(self, min_value, max_value=None):
        if max_value is None:
            min_value, max_value = -abs(min_value), abs(min_value)
        self.min_value, self.max_value = min_value, max_value

    def _clip(self, g):
        from .dygraph.varbase import VarBase
        return VarBase(torch.clamp(g.value, self.min_value, self.max_value))


class GradClipByNorm(_DygraphClipBase):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def _clip(self, g):
        from .dygraph.varbase import VarBase
        norm = torch.sqrt(torch.sum(g.value ** 2))
        scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                            max=1.0)
        return VarBase(g.value * scale)


class GradClipByGlobalNorm:
    def __init__(self, max_global_norm):
        self.max_global_norm = max_global_norm

    def __call__(self, params_grads):
        from .dygraph.varbase import VarBase
        gn = torch.sqrt(sum(torch.sum(g.value ** 2) for _, g in params_grads))
        scale = torch.clamp(
            self.max_global_norm / torch.clamp(gn, min=1e-12), max=1.0)
        return [(p, VarBase(g.value * scale)) for p, g in params_grads]
