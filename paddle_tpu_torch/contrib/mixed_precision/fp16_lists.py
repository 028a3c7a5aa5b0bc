"""Op lists for mixed precision: the port's copy of
``paddle_tpu.contrib.mixed_precision.fp16_lists`` (reference
contrib/mixed_precision/fp16_lists.py). The low-precision dtype is bfloat16
by default."""
from __future__ import annotations

# ops whose inputs are cast to the compute dtype (matrix-unit bound).
# softmax_with_cross_entropy is here because its kernel reduces in f32
# internally (nn_ops._HardLabelCE) — casting the [B,T,vocab] logits input
# keeps the saved residual low-precision (2 GB instead of 4 GB on the
# BERT-base MLM head) with no f32 math lost.
WHITE_LIST = {"conv2d", "conv3d", "depthwise_conv2d", "conv2d_transpose",
              "matmul", "mul", "fused_fc", "fused_elemwise_activation",
              "flash_attention", "softmax_with_cross_entropy"}
# ops kept in float32 (numerically sensitive). softmax_with_cross_entropy is
# deliberately NOT here: its kernel takes low-precision logits and does the
# reductions in f32 internally (nn_ops._HardLabelCE) — black-listing it
# would materialize a full-vocab f32 logits copy just to feed it.
# batch_norm is gray (not listed): its kernel keeps x in the native dtype
# and does the statistics in f32 internally — black-listing it would bounce
# a bf16 conv trunk through f32 HBM at every layer.
# layer_norm is gray (not listed): its kernel takes bf16 activations and
# does the statistics in f32 internally (nn_ops._layer_norm) — black-listing
# it would bounce the residual stream through f32 HBM at every layer.
BLACK_LIST = {"cross_entropy", "mean",
              "reduce_mean", "softmax", "sum",
              "exp", "log", "rsqrt", "sqrt"}


class AutoMixedPrecisionLists:
    def __init__(self, custom_white_list=None, custom_black_list=None):
        self.white_list = set(WHITE_LIST)
        self.black_list = set(BLACK_LIST)
        if custom_white_list:
            self.white_list |= set(custom_white_list)
        if custom_black_list:
            self.black_list |= set(custom_black_list)
        self.white_list -= self.black_list
