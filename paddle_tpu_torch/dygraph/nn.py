"""Dygraph layer zoo (the port's counterpart of ``paddle_tpu.dygraph.nn``;
reference python/paddle/fluid/dygraph/nn.py: Conv2D, FC, BatchNorm,
Embedding, GRUUnit, LayerNorm, PRelu, Pool2D ...). Each layer traces the
port's registered ops, the static graph's, through the dygraph tracer."""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..initializer import ConstantInitializer, NormalInitializer, XavierInitializer
from .layers import Layer
from .tracer import trace_op
from .varbase import VarBase


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


def _triple(v):
    return list(v) if isinstance(v, (list, tuple)) else [v] * 3


class Linear(Layer):
    def __init__(self, input_dim: int, output_dim: int, param_attr=None,
                 bias_attr=None, act: Optional[str] = None, dtype="float32"):
        super().__init__()
        self._act = act
        self.weight = self.create_parameter([input_dim, output_dim], param_attr, dtype)
        self.bias = (self.create_parameter([output_dim], bias_attr, dtype, is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, x):
        out = trace_op("mul", {"X": [x], "Y": [self.weight]},
                       {"x_num_col_dims": len(x.shape) - 1, "y_num_col_dims": 1})["Out"][0]
        if self.bias is not None:
            out = trace_op("elementwise_add", {"X": [out], "Y": [self.bias]},
                           {"axis": -1})["Out"][0]
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {})["Out"][0]
        return out


FC = Linear


class Conv2D(Layer):
    def __init__(self, num_channels: int, num_filters: int, filter_size,
                 stride=1, padding=0, dilation=1, groups: int = 1,
                 param_attr=None, bias_attr=None, act=None, dtype="float32",
                 use_cudnn=True):
        super().__init__()
        fh, fw = _pair(filter_size)
        self._attrs = {"strides": list(_pair(stride)), "paddings": list(_pair(padding)),
                       "dilations": list(_pair(dilation)), "groups": groups}
        self._act = act
        self.weight = self.create_parameter(
            [num_filters, num_channels // groups, fh, fw], param_attr, dtype,
            default_initializer=NormalInitializer(0.0, (2.0 / (fh * fw * num_channels)) ** 0.5))
        self.bias = (self.create_parameter([num_filters], bias_attr, dtype, is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, x):
        out = trace_op("conv2d", {"Input": [x], "Filter": [self.weight]}, self._attrs)["Out"][0]
        if self.bias is not None:
            out = trace_op("elementwise_add", {"X": [out], "Y": [self.bias]},
                           {"axis": 1})["Out"][0]
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {})["Out"][0]
        return out


class Pool2D(Layer):
    def __init__(self, pool_size=2, pool_type="max", pool_stride=None,
                 pool_padding=0, global_pooling=False, use_cudnn=True,
                 exclusive=True):
        super().__init__()
        self._attrs = {"pooling_type": pool_type, "ksize": list(_pair(pool_size)),
                       "strides": list(_pair(pool_stride if pool_stride is not None else pool_size)),
                       "paddings": list(_pair(pool_padding)),
                       "global_pooling": global_pooling, "exclusive": exclusive}

    def forward(self, x):
        return trace_op("pool2d", {"X": [x]}, self._attrs)["Out"][0]


class BatchNorm(Layer):
    def __init__(self, num_channels: int, act=None, is_test=False, momentum=0.9,
                 epsilon=1e-5, param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", use_global_stats=False):
        super().__init__()
        self._attrs = {"momentum": momentum, "epsilon": epsilon,
                       "data_layout": data_layout, "is_test": is_test or use_global_stats}
        self._act = act
        self.weight = self.create_parameter([num_channels], param_attr, dtype,
                                            default_initializer=ConstantInitializer(1.0))
        self.bias = self.create_parameter([num_channels], bias_attr, dtype, is_bias=True)
        self._mean = self.register_buffer("_mean", np.zeros(num_channels, dtype))
        self._variance = self.register_buffer("_variance", np.ones(num_channels, dtype))

    def forward(self, x):
        attrs = dict(self._attrs)
        if not self.training:
            attrs["is_test"] = True
        out = trace_op("batch_norm",
                       {"X": [x], "Scale": [self.weight], "Bias": [self.bias],
                        "Mean": [self._mean], "Variance": [self._variance]},
                       attrs)
        # functional state update: swap buffer values (the op returns them
        # detached, so the buffers never join the graph)
        self._mean.value = out["MeanOut"][0].value
        self._variance.value = out["VarianceOut"][0].value
        y = out["Y"][0]
        if self._act:
            y = trace_op(self._act, {"X": [y]}, {})["Out"][0]
        return y


class Embedding(Layer):
    def __init__(self, size, is_sparse=False, is_distributed=False,
                 padding_idx=None, param_attr=None, dtype="float32"):
        super().__init__()
        self._padding_idx = -1 if padding_idx is None else padding_idx
        self.weight = self.create_parameter(list(size), param_attr, dtype,
                                            default_initializer=XavierInitializer())

    def forward(self, ids):
        return trace_op("lookup_table",
                        {"W": [self.weight], "Ids": [ids]},
                        {"padding_idx": self._padding_idx})["Out"][0]


class LayerNorm(Layer):
    def __init__(self, normalized_shape, scale=True, shift=True, epsilon=1e-5,
                 param_attr=None, bias_attr=None, act=None, dtype="float32"):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        n = int(np.prod(normalized_shape))
        self._epsilon = epsilon
        self._act = act
        self.weight = (self.create_parameter([n], param_attr, dtype,
                                             default_initializer=ConstantInitializer(1.0))
                       if scale else None)
        self.bias = (self.create_parameter([n], bias_attr, dtype, is_bias=True)
                     if shift else None)

    def forward(self, x):
        ins = {"X": [x]}
        if self.weight is not None:
            ins["Scale"] = [self.weight]
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        out = trace_op("layer_norm", ins,
                       {"begin_norm_axis": len(x.shape) - 1, "epsilon": self._epsilon})
        y = out["Y"][0]
        if self._act:
            y = trace_op(self._act, {"X": [y]}, {})["Out"][0]
        return y


class Dropout(Layer):
    def __init__(self, p=0.5, dropout_implementation="downgrade_in_infer"):
        super().__init__()
        self._p = p
        self._impl = dropout_implementation

    def forward(self, x):
        return trace_op("dropout", {"X": [x]},
                        {"dropout_prob": self._p, "is_test": not self.training,
                         "dropout_implementation": self._impl})["Out"][0]


class PRelu(Layer):
    def __init__(self, mode="all", channel=None, input_shape=None, param_attr=None,
                 dtype="float32"):
        super().__init__()
        self._mode = mode
        if mode == "all":
            shape = [1]
        elif mode == "channel":
            shape = [channel]
        else:
            shape = list(input_shape)
        self.weight = self.create_parameter(shape, param_attr, dtype,
                                            default_initializer=ConstantInitializer(0.25))

    def forward(self, x):
        return trace_op("prelu", {"X": [x], "Alpha": [self.weight]},
                        {"mode": self._mode})["Out"][0]


class GRUUnit(Layer):
    """gru_unit_op.cc capability: single-step GRU cell."""

    def __init__(self, size: int, param_attr=None, bias_attr=None,
                 activation="tanh", gate_activation="sigmoid", dtype="float32"):
        super().__init__()
        self._hidden = size // 3
        h = self._hidden
        self._act = activation
        self._gate_act = gate_activation
        # paddle packs [h, 3h]: update/reset gates then candidate
        self.weight = self.create_parameter([h, 3 * h], param_attr, dtype)
        self.bias = (self.create_parameter([3 * h], bias_attr, dtype, is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, inputs, hidden):
        """inputs: [B, 3h] projected input; hidden: [B, h]."""
        h = self._hidden
        gate_w = trace_op("slice", {"Input": [self.weight]},
                          {"axes": [1], "starts": [0], "ends": [2 * h]})["Out"][0]
        cand_w = trace_op("slice", {"Input": [self.weight]},
                          {"axes": [1], "starts": [2 * h], "ends": [3 * h]})["Out"][0]
        xg = trace_op("slice", {"Input": [inputs]},
                      {"axes": [1], "starts": [0], "ends": [2 * h]})["Out"][0]
        xc = trace_op("slice", {"Input": [inputs]},
                      {"axes": [1], "starts": [2 * h], "ends": [3 * h]})["Out"][0]
        hg = trace_op("matmul", {"X": [hidden], "Y": [gate_w]}, {})["Out"][0]
        gates = xg + hg
        if self.bias is not None:
            bg = trace_op("slice", {"Input": [self.bias]},
                          {"axes": [0], "starts": [0], "ends": [2 * h]})["Out"][0]
            gates = gates + bg
        gates = trace_op(self._gate_act, {"X": [gates]}, {})["Out"][0]
        u = trace_op("slice", {"Input": [gates]},
                     {"axes": [1], "starts": [0], "ends": [h]})["Out"][0]
        r = trace_op("slice", {"Input": [gates]},
                     {"axes": [1], "starts": [h], "ends": [2 * h]})["Out"][0]
        rh = r * hidden
        c = xc + trace_op("matmul", {"X": [rh], "Y": [cand_w]}, {})["Out"][0]
        if self.bias is not None:
            bc = trace_op("slice", {"Input": [self.bias]},
                          {"axes": [0], "starts": [2 * h], "ends": [3 * h]})["Out"][0]
            c = c + bc
        c = trace_op(self._act, {"X": [c]}, {})["Out"][0]
        new_h = u * hidden + (c - u * c)
        return new_h, new_h, gates


class Conv2DTranspose(Layer):
    """Reference dygraph/nn.py Conv2DTranspose (:1981)."""

    def __init__(self, num_channels: int, num_filters: int, filter_size,
                 output_size=None, padding=0, stride=1, dilation=1, groups=1,
                 param_attr=None, bias_attr=None, act=None, dtype="float32",
                 use_cudnn=True):
        super().__init__()
        fh, fw = _pair(filter_size)
        self._attrs = {"strides": list(_pair(stride)),
                       "paddings": list(_pair(padding)),
                       "dilations": list(_pair(dilation)), "groups": groups}
        if output_size is not None:
            self._attrs["output_size"] = list(_pair(output_size))
        self._act = act
        self.weight = self.create_parameter(
            [num_channels, num_filters // groups, fh, fw], param_attr, dtype,
            default_initializer=XavierInitializer())
        self.bias = (self.create_parameter([num_filters], bias_attr, dtype,
                                           is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, x):
        out = trace_op("conv2d_transpose",
                       {"Input": [x], "Filter": [self.weight]},
                       self._attrs)["Out"][0]
        if self.bias is not None:
            out = trace_op("elementwise_add", {"X": [out], "Y": [self.bias]},
                           {"axis": 1})["Out"][0]
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {})["Out"][0]
        return out


class Conv3D(Layer):
    """Reference dygraph/nn.py Conv3D (:258)."""

    def __init__(self, num_channels: int, num_filters: int, filter_size,
                 stride=1, padding=0, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, act=None, dtype="float32", use_cudnn=True):
        super().__init__()
        fd, fh, fw = _triple(filter_size)
        self._attrs = {"strides": _triple(stride), "paddings": _triple(padding),
                       "dilations": _triple(dilation), "groups": groups}
        self._act = act
        fan_in = fd * fh * fw * num_channels
        self.weight = self.create_parameter(
            [num_filters, num_channels // groups, fd, fh, fw], param_attr,
            dtype, default_initializer=NormalInitializer(
                0.0, (2.0 / fan_in) ** 0.5))
        self.bias = (self.create_parameter([num_filters], bias_attr, dtype,
                                           is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, x):
        out = trace_op("conv3d", {"Input": [x], "Filter": [self.weight]},
                       self._attrs)["Out"][0]
        if self.bias is not None:
            out = trace_op("elementwise_add", {"X": [out], "Y": [self.bias]},
                           {"axis": 1})["Out"][0]
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {})["Out"][0]
        return out


class Conv3DTranspose(Layer):
    """Reference dygraph/nn.py Conv3DTranspose (:455)."""

    def __init__(self, num_channels: int, num_filters: int, filter_size,
                 padding=0, stride=1, dilation=1, groups=1, param_attr=None,
                 bias_attr=None, act=None, dtype="float32", use_cudnn=True):
        super().__init__()
        fd, fh, fw = _triple(filter_size)
        self._attrs = {"strides": _triple(stride), "paddings": _triple(padding),
                       "dilations": _triple(dilation), "groups": groups}
        self._act = act
        self.weight = self.create_parameter(
            [num_channels, num_filters // groups, fd, fh, fw], param_attr,
            dtype, default_initializer=XavierInitializer())
        self.bias = (self.create_parameter([num_filters], bias_attr, dtype,
                                           is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, x):
        out = trace_op("conv3d_transpose",
                       {"Input": [x], "Filter": [self.weight]},
                       self._attrs)["Out"][0]
        if self.bias is not None:
            out = trace_op("elementwise_add", {"X": [out], "Y": [self.bias]},
                           {"axis": 1})["Out"][0]
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {})["Out"][0]
        return out


class NCE(Layer):
    """Reference dygraph/nn.py NCE (:1579): noise-contrastive loss head."""

    def __init__(self, num_total_classes: int, dim: int, sample_weight=None,
                 param_attr=None, bias_attr=None, num_neg_samples=10,
                 sampler="uniform", custom_dist=None, seed=0,
                 is_sparse=False, dtype="float32"):
        super().__init__()
        if sampler != "uniform" or custom_dist is not None:
            raise NotImplementedError(
                "NCE: only the uniform noise sampler is implemented "
                f"(got sampler={sampler!r})")
        self._attrs = {"num_total_classes": num_total_classes,
                       "num_neg_samples": num_neg_samples}
        self.weight = self.create_parameter([num_total_classes, dim],
                                            param_attr, dtype)
        self.bias = (self.create_parameter([num_total_classes], bias_attr,
                                           dtype, is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, input, label):
        ins = {"Input": [input], "Label": [label], "Weight": [self.weight]}
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        return trace_op("nce", ins, self._attrs)["Cost"][0]


class BilinearTensorProduct(Layer):
    """Reference dygraph/nn.py BilinearTensorProduct (:1881)."""

    def __init__(self, input1_dim: int, input2_dim: int, output_dim: int,
                 name=None, act=None, param_attr=None, bias_attr=None,
                 dtype="float32"):
        super().__init__()
        self._act = act
        self.weight = self.create_parameter(
            [output_dim, input1_dim, input2_dim], param_attr, dtype)
        self.bias = (self.create_parameter([1, output_dim], bias_attr, dtype,
                                           is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, x, y):
        ins = {"X": [x], "Y": [y], "Weight": [self.weight]}
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        out = trace_op("bilinear_tensor_product", ins, {})["Out"][0]
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {})["Out"][0]
        return out


class SequenceConv(Layer):
    """Reference dygraph/nn.py SequenceConv (:2216). Takes the
    dense per-row `length` tensor in forward (LoD replacement)."""

    def __init__(self, input_dim: int, num_filters: int, filter_size=3,
                 filter_stride=1, padding=None, bias_attr=None,
                 param_attr=None, act=None, dtype="float32"):
        super().__init__()
        self._attrs = {"contextLength": filter_size,
                       "contextStride": filter_stride,
                       "contextStart": -((filter_size - 1) // 2)}
        self._act = act
        self.weight = self.create_parameter(
            [filter_size * input_dim, num_filters], param_attr, dtype)
        self.bias = (self.create_parameter([num_filters], bias_attr, dtype,
                                           is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, x, length=None):
        ins = {"X": [x], "Filter": [self.weight]}
        if length is not None:
            ins["Length"] = [length]
        out = trace_op("sequence_conv", ins, self._attrs)["Out"][0]
        if self.bias is not None:
            out = trace_op("elementwise_add", {"X": [out], "Y": [self.bias]},
                           {"axis": -1})["Out"][0]
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {})["Out"][0]
        return out


class RowConv(Layer):
    """Reference dygraph/nn.py RowConv (:2306): lookahead row convolution."""

    def __init__(self, input_dim: int, future_context_size: int,
                 param_attr=None, act=None, dtype="float32"):
        super().__init__()
        self._act = act
        self.weight = self.create_parameter(
            [future_context_size + 1, input_dim], param_attr, dtype)

    def forward(self, x):
        out = trace_op("row_conv", {"X": [x], "Filter": [self.weight]},
                       {})["Out"][0]
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {})["Out"][0]
        return out


class GroupNorm(Layer):
    """Reference dygraph/nn.py GroupNorm (:2382)."""

    def __init__(self, channels: int, groups: int, epsilon=1e-5,
                 param_attr=None, bias_attr=None, act=None,
                 data_layout="NCHW", dtype="float32"):
        super().__init__()
        if data_layout not in ("NCHW", "NHWC"):
            raise ValueError(f"unknown data_layout {data_layout!r}")
        self._attrs = {"groups": groups, "epsilon": epsilon,
                       "data_layout": data_layout}
        self._act = act
        self.weight = (self.create_parameter(
            [channels], param_attr, dtype,
            default_initializer=ConstantInitializer(1.0))
            if param_attr is not False else None)
        self.bias = (self.create_parameter([channels], bias_attr, dtype,
                                           is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, x):
        ins = {"X": [x]}
        if self.weight is not None:
            ins["Scale"] = [self.weight]
        if self.bias is not None:
            ins["Bias"] = [self.bias]
        out = trace_op("group_norm", ins, self._attrs)["Y"][0]
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {})["Out"][0]
        return out


class SpectralNorm(Layer):
    """Reference dygraph/nn.py SpectralNorm (:2481): power-iteration weight
    normalization. Holds the u/v vectors as buffers."""

    def __init__(self, weight_shape, dim: int = 0, power_iters: int = 1,
                 eps: float = 1e-12, dtype="float32"):
        super().__init__()
        self._attrs = {"dim": dim, "power_iters": power_iters, "eps": eps}
        h = weight_shape[dim]
        w = 1
        for i, s in enumerate(weight_shape):
            if i != dim:
                w *= s
        rng = np.random.RandomState(0)
        self._u = self.register_buffer(
            "_u", rng.normal(size=h).astype(dtype))
        self._v = self.register_buffer(
            "_v", rng.normal(size=w).astype(dtype))

    def forward(self, weight):
        return trace_op("spectral_norm",
                        {"Weight": [weight], "U": [self._u], "V": [self._v]},
                        self._attrs)["Out"][0]


class TreeConv(Layer):
    """Reference dygraph/nn.py TreeConv (:2581): tree-based convolution over
    (NodesVector, EdgeSet)."""

    def __init__(self, feature_size: int, output_size: int,
                 num_filters: int = 1, max_depth: int = 8, act="tanh",
                 param_attr=None, bias_attr=None, name=None, dtype="float32"):
        super().__init__()
        self._attrs = {"max_depth": max_depth}
        self._act = act
        self.weight = self.create_parameter(
            [feature_size, 3, output_size * num_filters], param_attr, dtype)
        self.bias = (self.create_parameter([output_size * num_filters],
                                           bias_attr, dtype, is_bias=True)
                     if bias_attr is not False else None)

    def forward(self, nodes_vector, edge_set):
        out = trace_op("tree_conv",
                       {"NodesVector": [nodes_vector], "EdgeSet": [edge_set],
                        "Filter": [self.weight]}, self._attrs)["Out"][0]
        if self.bias is not None:
            out = trace_op("elementwise_add", {"X": [out], "Y": [self.bias]},
                           {"axis": -1})["Out"][0]
        if self._act:
            out = trace_op(self._act, {"X": [out]}, {})["Out"][0]
        return out
