"""Gradient clipping.

The port's copy of ``paddle_tpu.clip`` (reference
``python/paddle/fluid/clip.py``) — GradientClipByValue, GradientClipByNorm,
GradientClipByGlobalNorm, passed as ``grad_clip=`` to an optimizer. Each
rewrites the (param, grad) list by appending clip ops. The global
``set_gradient_clip`` hook is not carried over: no optimizer reads it.
"""
from __future__ import annotations

from .layer_helper import LayerHelper


class GradientClipBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class GradientClipByValue(GradientClipBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def __call__(self, params_grads):
        helper = LayerHelper("clip_by_value")
        out = []
        for p, g in params_grads:
            if not getattr(p, "need_clip", True):
                out.append((p, g))
                continue
            new_g = helper.create_variable_for_type_inference(g.dtype)
            helper.append_op(type="clip", inputs={"X": [g.name]},
                             outputs={"Out": [new_g.name]},
                             attrs={"min": self.min, "max": self.max})
            out.append((p, new_g))
        return out


class GradientClipByNorm(GradientClipBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        helper = LayerHelper("clip_by_norm")
        out = []
        for p, g in params_grads:
            if not getattr(p, "need_clip", True):
                out.append((p, g))
                continue
            new_g = helper.create_variable_for_type_inference(g.dtype)
            helper.append_op(type="clip_by_norm", inputs={"X": [g.name]},
                             outputs={"Out": [new_g.name]},
                             attrs={"max_norm": self.clip_norm})
            out.append((p, new_g))
        return out


class GradientClipByGlobalNorm(GradientClipBase):
    """clip.py GradientClipByGlobalNorm: g *= clip_norm/max(global_norm, clip_norm)."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        helper = LayerHelper("global_norm_clip")
        block = helper.main_program.global_block()
        clipped_pairs = [(p, g) for p, g in params_grads if getattr(p, "need_clip", True)]
        passthrough = [(p, g) for p, g in params_grads if not getattr(p, "need_clip", True)]
        if not clipped_pairs:
            return list(passthrough)
        sq_norms = []
        for p, g in clipped_pairs:
            sq = helper.create_variable_for_type_inference(g.dtype)
            block.append_op(type="squared_l2_norm", inputs={"X": [g.name]},
                            outputs={"Out": [sq.name]}, attrs={})
            sq_norms.append(sq)
        total = helper.create_variable_for_type_inference("float32")
        block.append_op(type="sum", inputs={"X": [v.name for v in sq_norms]},
                        outputs={"Out": [total.name]}, attrs={})
        gnorm = helper.create_variable_for_type_inference("float32")
        block.append_op(type="sqrt", inputs={"X": [total.name]},
                        outputs={"Out": [gnorm.name]}, attrs={})
        # denom = max(gnorm, clip_norm); g_out = g * clip_norm / denom
        denom = helper.create_variable_for_type_inference("float32")
        block.append_op(type="clip", inputs={"X": [gnorm.name]},
                        outputs={"Out": [denom.name]},
                        attrs={"min": self.clip_norm, "max": 3.4e38})
        out = list(passthrough)
        for p, g in clipped_pairs:
            new_g = helper.create_variable_for_type_inference(g.dtype)
            block.append_op(type="elementwise_div",
                            inputs={"X": [g.name], "Y": [denom.name]},
                            outputs={"Out": [new_g.name]}, attrs={"axis": -1})
            scaled = helper.create_variable_for_type_inference(g.dtype)
            block.append_op(type="scale", inputs={"X": [new_g.name]},
                            outputs={"Out": [scaled.name]}, attrs={"scale": self.clip_norm})
            out.append((p, scaled))
        return out

