"""ResNet-50/101/152 built with the port's DSL: the copy of
``paddle_tpu.models.resnet`` (reference image_classification recipe), same
ops, attrs and parameter names.

``PDTPU_CONV_BN_FUSION`` (read when the program is built) routes the
bottleneck 1×1 conv+BN(+residual+relu) tails through the ``fused_conv_bn``
op; ``PDTPU_BN_MODE=pallas`` (read when it runs) sends the remaining
batch norms through the fused-BN kernels. With both set, a training step
runs every fused-BN Hopper kernel of ``ops/kernels/fused_bn.py``."""
from __future__ import annotations

import os

from .. import layers
from ..core.program import Program, program_guard, remat_unit
from ..optimizer import Momentum
from ..param_attr import ParamAttr


def _fusion_on() -> bool:
    """PDTPU_CONV_BN_FUSION routes the bottleneck 1×1 conv+BN(+residual+relu)
    tails through the fused op ("pallas" or "xla" picks its lowering; unset
    keeps the unfused graph)."""
    return os.environ.get("PDTPU_CONV_BN_FUSION", "") not in ("", "0", "off")


def conv_bn(x, filters, ksize, stride=1, act=None, name="conv", is_test=False,
            residual=None):
    if ksize == 1 and _fusion_on():
        return layers.fused_conv_bn(
            x, filters, stride=stride, act=act, residual=residual,
            is_test=is_test, param_attr=ParamAttr(name=f"{name}.w"),
            bn_param_attr=ParamAttr(name=f"{name}.bn.scale"),
            bn_bias_attr=ParamAttr(name=f"{name}.bn.bias"),
            moving_mean_name=f"{name}.bn.mean",
            moving_variance_name=f"{name}.bn.var")
    conv = layers.conv2d(x, filters, ksize, stride=stride,
                         padding=(ksize - 1) // 2, bias_attr=False,
                         param_attr=ParamAttr(name=f"{name}.w"))
    bn = layers.batch_norm(conv, act=act if residual is None else None,
                           is_test=is_test,
                           param_attr=ParamAttr(name=f"{name}.bn.scale"),
                           bias_attr=ParamAttr(name=f"{name}.bn.bias"),
                           moving_mean_name=f"{name}.bn.mean",
                           moving_variance_name=f"{name}.bn.var")
    if residual is None:
        return bn
    out = layers.elementwise_add(bn, residual)
    return layers.relu(out) if act == "relu" else out


def bottleneck(x, filters, stride, name, is_test=False):
    shortcut = x
    in_c = x.shape[1]
    out_c = filters * 4
    if _fusion_on():
        # the shortcut is built first so the `.c` fused op can fold the
        # residual add + relu into its epilogue (one pass for the tail)
        if stride != 1 or in_c != out_c:
            shortcut = conv_bn(x, out_c, 1, stride=stride, name=f"{name}.sc",
                               is_test=is_test)
        y = conv_bn(x, filters, 1, act="relu", name=f"{name}.a",
                    is_test=is_test)
        y = conv_bn(y, filters, 3, stride=stride, act="relu",
                    name=f"{name}.b", is_test=is_test)
        return conv_bn(y, out_c, 1, act="relu", name=f"{name}.c",
                       is_test=is_test, residual=shortcut)
    y = conv_bn(x, filters, 1, act="relu", name=f"{name}.a", is_test=is_test)
    y = conv_bn(y, filters, 3, stride=stride, act="relu", name=f"{name}.b",
                is_test=is_test)
    y = conv_bn(y, out_c, 1, name=f"{name}.c", is_test=is_test)
    if stride != 1 or in_c != out_c:
        shortcut = conv_bn(x, out_c, 1, stride=stride, name=f"{name}.sc",
                           is_test=is_test)
    return layers.relu(layers.elementwise_add(y, shortcut))


_LAYOUT = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def _s2d_stem(img, is_test):
    """Space-to-depth stem (the JAX package's, from the MLPerf TPU ResNet):
    pad 224 -> 230, move 2x2 spatial blocks into channels ([B,3,230,230] ->
    [B,12,115,115]) and run a 4x4 stride-1 conv: the function family of
    the padded 7x7 stride-2 conv (an 8x8 kernel on 2x2 blocks) with
    C_in = 12 instead of 3. The BN after it is a plain batch_norm, which
    PDTPU_BN_MODE=pallas sends through the fused-BN kernels."""
    x = layers.pad(img, [0, 0, 0, 0, 3, 3, 3, 3])
    x = layers.space_to_depth(x, 2)
    conv = layers.conv2d(x, 64, 4, stride=1, padding=0, bias_attr=False,
                         param_attr=ParamAttr(name="stem.w"))
    return layers.batch_norm(conv, act="relu", is_test=is_test,
                             param_attr=ParamAttr(name="stem.bn.scale"),
                             bias_attr=ParamAttr(name="stem.bn.bias"),
                             moving_mean_name="stem.bn.mean",
                             moving_variance_name="stem.bn.var")


def resnet(img, depth: int = 50, num_classes: int = 1000, is_test: bool = False,
           stem_s2d: bool = False):
    blocks = _LAYOUT[depth]
    if stem_s2d:
        x = _s2d_stem(img, is_test)
    else:
        x = conv_bn(img, 64, 7, stride=2, act="relu", name="stem",
                    is_test=is_test)
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1)
    filters = [64, 128, 256, 512]
    for stage, (n, f) in enumerate(zip(blocks, filters)):
        for i in range(n):
            stride = 2 if i == 0 and stage > 0 else 1
            # one remat unit per bottleneck (a tag only, so far)
            with remat_unit(f"res{stage}.{i}"):
                x = bottleneck(x, f, stride, name=f"res{stage}.{i}",
                               is_test=is_test)
    x = layers.pool2d(x, global_pooling=True, pool_type="avg")
    return layers.fc(x, num_classes, param_attr=ParamAttr(name="fc.w"),
                     bias_attr=ParamAttr(name="fc.b"))


def build_train_program(depth=50, num_classes=1000, lr=0.1, momentum=0.9,
                        img_shape=(3, 224, 224)):
    main = Program()
    startup = Program()
    with program_guard(main, startup):
        img = layers.data("img", list(img_shape))
        label = layers.data("label", [1], dtype="int64")
        logits = resnet(img, depth, num_classes)
        loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
        acc = layers.accuracy(layers.softmax(logits), label)
        Momentum(lr, momentum).minimize(loss)
    return main, startup, ["img", "label"], loss, acc
