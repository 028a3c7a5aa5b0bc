"""Layers DSL — the subset of ``paddle_tpu.layers.nn`` the BERT, ResNet,
Transformer NMT and DeepFM slices use, emitting the same ops, attrs and var descs (reference
``python/paddle/fluid/layers/nn.py``)."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..core.dtypes import convert_dtype
from ..core.program import Variable, default_main_program
from ..initializer import (ConstantInitializer, NormalInitializer,
                           RowPackInitializer, XavierInitializer)
from ..layer_helper import LayerHelper


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (v, v)


def _conv_out_dim(size, k, pad, stride, dilation=1):
    if size is None or size < 0:
        return -1
    eff = dilation * (k - 1) + 1
    return (size + 2 * pad - eff) // stride + 1


def data(name: str, shape: Sequence[int], dtype="float32", lod_level: int = 0,
         append_batch_size: bool = True) -> Variable:
    """Input placeholder (reference layers/io.py data). With
    append_batch_size=True a leading -1 batch dim is added (paddle behavior)."""
    shape = list(shape)
    if append_batch_size and (not shape or shape[0] != -1):
        shape = [-1] + shape
    block = default_main_program().global_block()
    return block.create_var(name=name, shape=shape, dtype=convert_dtype(dtype),
                            is_data=True, stop_gradient=True, lod_level=lod_level)


def fc(input: Variable, size: int, num_flatten_dims: int = 1, param_attr=None,
       bias_attr=None, act: Optional[str] = None, name: Optional[str] = None) -> Variable:
    """Fully-connected (reference layers/nn.py fc): flattens input at
    num_flatten_dims, gemm, optional bias + activation."""
    helper = LayerHelper("fc", name=name)
    in_shape = input.shape
    reduced = int(np.prod([d for d in in_shape[num_flatten_dims:]])) if in_shape else None
    w = helper.create_parameter(param_attr, shape=[reduced, size], dtype=input.dtype)
    out = helper.create_variable_for_type_inference(
        input.dtype, shape=tuple(in_shape[:num_flatten_dims]) + (size,) if in_shape else None)
    helper.append_op(
        type="mul", inputs={"X": [input.name], "Y": [w.name]},
        outputs={"Out": [out.name]},
        attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, shape=[size], dtype=input.dtype, is_bias=True)
        tmp = helper.create_variable_for_type_inference(input.dtype, out.shape)
        helper.append_op(type="elementwise_add",
                         inputs={"X": [out.name], "Y": [b.name]},
                         outputs={"Out": [tmp.name]}, attrs={"axis": -1})
        out = tmp
    return helper.append_activation(out, act)


def embedding(input: Variable, size: Sequence[int], is_sparse: bool = False,
              is_distributed: bool = False, padding_idx: Optional[int] = None,
              param_attr=None, dtype="float32", name=None,
              row_pack: bool = False) -> Variable:
    """layers/nn.py embedding → lookup_table op. is_sparse=True makes the
    table's gradient a SelectedRows of the looked-up rows.

    row_pack=True stores the table as a [vocab, 128] uint16 packed
    row-major array: each row bit-splits up to 64 f32 values (embedding +
    optional optimizer state columns), updated row by row by a
    ``*_row_packed`` optimizer (SGD/Adagrad/Adam with packed_rows=...). It
    requires is_sparse=True; size[-1] counts the f32 values per row
    INCLUDING state columns."""
    helper = LayerHelper("embedding", name=name)
    attrs = {"padding_idx": -1 if padding_idx is None else padding_idx,
             "is_sparse": is_sparse, "is_distributed": is_distributed}
    if row_pack:
        from ..ops.deferred_rows import PACK_LANES
        if not is_sparse:
            raise ValueError("row_pack=True requires is_sparse=True")
        w = helper.create_parameter(
            param_attr, shape=[size[0], PACK_LANES], dtype="uint16",
            default_initializer=RowPackInitializer(size[-1], size[-1]))
        attrs["row_pack_dt"] = int(size[-1])
    else:
        w = helper.create_parameter(param_attr, shape=list(size), dtype=dtype,
                                    default_initializer=XavierInitializer())
    out_shape = None
    if input.shape is not None:
        ids_shape = input.shape[:-1] if input.shape[-1] == 1 else input.shape
        out_shape = tuple(ids_shape) + (size[-1],)
    out = helper.create_variable_for_type_inference(
        "float32" if row_pack else dtype, out_shape)
    helper.append_op(
        type="lookup_table", inputs={"W": [w.name], "Ids": [input.name]},
        outputs={"Out": [out.name]}, attrs=attrs)
    return out


def conv2d(input: Variable, num_filters: int, filter_size, stride=1, padding=0,
           dilation=1, groups: int = 1, param_attr=None, bias_attr=None,
           use_cudnn: bool = True, act: Optional[str] = None, name=None,
           data_format: str = "NCHW") -> Variable:
    helper = LayerHelper("conv2d", name=name)
    fh, fw = _pair(filter_size)
    num_channels = input.shape[1] if input.shape else None
    # fan-in init (reference layers/nn.py:2404: std = sqrt(2/(k*k*C_in)))
    w = helper.create_parameter(
        param_attr, shape=[num_filters, num_channels // groups, fh, fw],
        dtype=input.dtype,
        default_initializer=NormalInitializer(
            0.0, (2.0 / (fh * fw * num_channels)) ** 0.5))
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    out_shape = None
    if input.shape is not None and len(input.shape) == 4:
        out_shape = (input.shape[0], num_filters,
                     _conv_out_dim(input.shape[2], fh, ph, sh, dh),
                     _conv_out_dim(input.shape[3], fw, pw, sw, dw))
    out = helper.create_variable_for_type_inference(input.dtype, out_shape)
    helper.append_op(
        type="conv2d", inputs={"Input": [input.name], "Filter": [w.name]},
        outputs={"Out": [out.name]},
        attrs={"strides": [sh, sw], "paddings": [ph, pw],
               "dilations": [dh, dw], "groups": groups})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, shape=[num_filters],
                                    dtype=input.dtype, is_bias=True)
        tmp = helper.create_variable_for_type_inference(input.dtype, out_shape)
        helper.append_op(type="elementwise_add",
                         inputs={"X": [out.name], "Y": [b.name]},
                         outputs={"Out": [tmp.name]}, attrs={"axis": 1})
        out = tmp
    return helper.append_activation(out, act)


def pool2d(input: Variable, pool_size=2, pool_type: str = "max", pool_stride=None,
           pool_padding=0, global_pooling: bool = False, use_cudnn: bool = True,
           ceil_mode: bool = False, exclusive: bool = True, name=None) -> Variable:
    helper = LayerHelper("pool2d", name=name)
    kh, kw = _pair(pool_size)
    sh, sw = _pair(pool_stride if pool_stride is not None else pool_size)
    ph, pw = _pair(pool_padding)
    out_shape = None
    if input.shape is not None and len(input.shape) == 4:
        if global_pooling:
            out_shape = (input.shape[0], input.shape[1], 1, 1)
        else:
            out_shape = (input.shape[0], input.shape[1],
                         _conv_out_dim(input.shape[2], kh, ph, sh),
                         _conv_out_dim(input.shape[3], kw, pw, sw))
    out = helper.create_variable_for_type_inference(input.dtype, out_shape)
    helper.append_op(
        type="pool2d", inputs={"X": [input.name]}, outputs={"Out": [out.name]},
        attrs={"pooling_type": pool_type, "ksize": [kh, kw],
               "strides": [sh, sw], "paddings": [ph, pw],
               "global_pooling": global_pooling, "exclusive": exclusive})
    return out


def batch_norm(input: Variable, act: Optional[str] = None, is_test: bool = False,
               momentum: float = 0.9, epsilon: float = 1e-5, param_attr=None,
               bias_attr=None, data_layout: str = "NCHW", name=None,
               moving_mean_name=None, moving_variance_name=None,
               use_global_stats: bool = False) -> Variable:
    helper = LayerHelper("batch_norm", name=name)
    c = input.shape[1] if data_layout == "NCHW" else input.shape[-1]
    scale = helper.create_parameter(param_attr, shape=[c], dtype=input.dtype,
                                    default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(bias_attr, shape=[c], dtype=input.dtype, is_bias=True)
    mean = helper.create_global_variable([c], input.dtype, name=moving_mean_name,
                                         initializer=ConstantInitializer(0.0))
    var = helper.create_global_variable([c], input.dtype, name=moving_variance_name,
                                        initializer=ConstantInitializer(1.0))
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    shape=input.shape)
    saved_mean = helper.create_variable_for_type_inference(input.dtype, stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(input.dtype, stop_gradient=True)
    # relu folds into the op itself (fused_bn_add_activation analog): the
    # fused-BN kernel applies it in the same pass instead of a separate
    # elementwise op
    fold_act = act if act == "relu" else None
    helper.append_op(
        type="batch_norm",
        inputs={"X": [input.name], "Scale": [scale.name], "Bias": [bias.name],
                "Mean": [mean.name], "Variance": [var.name]},
        outputs={"Y": [out.name], "MeanOut": [mean.name], "VarianceOut": [var.name],
                 "SavedMean": [saved_mean.name], "SavedVariance": [saved_var.name]},
        attrs={"momentum": momentum, "epsilon": epsilon, "act": fold_act or "",
               "is_test": is_test or use_global_stats, "data_layout": data_layout})
    return out if fold_act else helper.append_activation(out, act)


def fused_conv_bn(input: Variable, num_filters: int, stride: int = 1,
                  act: Optional[str] = None,
                  residual: Optional[Variable] = None,
                  is_test: bool = False, momentum: float = 0.9,
                  epsilon: float = 1e-5, param_attr=None, bn_param_attr=None,
                  bn_bias_attr=None, moving_mean_name=None,
                  moving_variance_name=None, name=None) -> Variable:
    """Fused 1×1 conv (no bias) + batch_norm (+relu, +residual) as ONE op,
    for the ResNet bottleneck tail; run by the fused conv+BN Hopper kernels
    on the card and by a bitwise-equal composition where their gate does
    not admit the shapes (ops/kernels/fused_bn.py). Used by models/resnet.py
    when ``PDTPU_CONV_BN_FUSION`` is set."""
    helper = LayerHelper("fused_conv_bn", name=name)
    num_channels = input.shape[1]
    w = helper.create_parameter(
        param_attr, shape=[num_filters, num_channels, 1, 1],
        dtype=input.dtype,
        default_initializer=NormalInitializer(
            0.0, (2.0 / num_channels) ** 0.5))
    scale = helper.create_parameter(
        bn_param_attr, shape=[num_filters], dtype=input.dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(bn_bias_attr, shape=[num_filters],
                                   dtype=input.dtype, is_bias=True)
    mean = helper.create_global_variable(
        [num_filters], input.dtype, name=moving_mean_name,
        initializer=ConstantInitializer(0.0))
    var = helper.create_global_variable(
        [num_filters], input.dtype, name=moving_variance_name,
        initializer=ConstantInitializer(1.0))
    out_shape = None
    if input.shape is not None and len(input.shape) == 4:
        out_shape = (input.shape[0], num_filters,
                     _conv_out_dim(input.shape[2], 1, 0, stride),
                     _conv_out_dim(input.shape[3], 1, 0, stride))
    out = helper.create_variable_for_type_inference(input.dtype, out_shape)
    saved_mean = helper.create_variable_for_type_inference(
        input.dtype, stop_gradient=True)
    saved_var = helper.create_variable_for_type_inference(
        input.dtype, stop_gradient=True)
    ins = {"Input": [input.name], "Filter": [w.name], "Scale": [scale.name],
           "Bias": [bias.name], "Mean": [mean.name], "Variance": [var.name]}
    if residual is not None:
        ins["Residual"] = [residual.name]
    helper.append_op(
        type="fused_conv_bn", inputs=ins,
        outputs={"Y": [out.name], "MeanOut": [mean.name],
                 "VarianceOut": [var.name], "SavedMean": [saved_mean.name],
                 "SavedVariance": [saved_var.name]},
        attrs={"stride": int(stride), "epsilon": epsilon,
               "momentum": momentum, "act": act or "", "is_test": is_test})
    return out


def layer_norm(input: Variable, scale: bool = True, shift: bool = True,
               begin_norm_axis: int = 1, epsilon: float = 1e-5,
               param_attr=None, bias_attr=None, act=None, name=None) -> Variable:
    helper = LayerHelper("layer_norm", name=name)
    if input.shape is None:
        raise ValueError(
            f"layer_norm needs input shape metadata to size its scale/bias "
            f"(input var {input.name} has none — ensure upstream layers "
            f"propagate shapes)")
    norm_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    ins = {"X": [input.name]}
    if scale:
        s = helper.create_parameter(param_attr, shape=norm_shape, dtype=input.dtype,
                                    default_initializer=ConstantInitializer(1.0))
        ins["Scale"] = [s.name]
    if shift:
        b = helper.create_parameter(bias_attr, shape=norm_shape, dtype=input.dtype, is_bias=True)
        ins["Bias"] = [b.name]
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    mean = helper.create_variable_for_type_inference(input.dtype, stop_gradient=True)
    var = helper.create_variable_for_type_inference(input.dtype, stop_gradient=True)
    helper.append_op(type="layer_norm", inputs=ins,
                     outputs={"Y": [out.name], "Mean": [mean.name], "Variance": [var.name]},
                     attrs={"begin_norm_axis": begin_norm_axis, "epsilon": epsilon})
    return helper.append_activation(out, act)


def dropout(x: Variable, dropout_prob: float, is_test: bool = False, seed=None,
            name=None, dropout_implementation: str = "downgrade_in_infer") -> Variable:
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    mask = helper.create_variable_for_type_inference(x.dtype, stop_gradient=True)
    helper.append_op(type="dropout", inputs={"X": [x.name]},
                     outputs={"Out": [out.name], "Mask": [mask.name]},
                     attrs={"dropout_prob": dropout_prob, "is_test": is_test,
                            "dropout_implementation": dropout_implementation})
    return out


def relu(x, name=None):
    from .ops import _activation_layer
    return _activation_layer("relu", x, {}, name)


def topk(input: Variable, k: int, name=None):
    helper = LayerHelper("top_k", name=name)
    values = helper.create_variable_for_type_inference(input.dtype)
    indices = helper.create_variable_for_type_inference("int64", stop_gradient=True)
    helper.append_op(type="top_k", inputs={"X": [input.name]},
                     outputs={"Out": [values.name], "Indices": [indices.name]},
                     attrs={"k": k})
    return values, indices


def softmax(input: Variable, axis: int = -1, use_cudnn: bool = False, name=None) -> Variable:
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op(type="softmax", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis})
    return out


def matmul(x: Variable, y: Variable, transpose_x: bool = False,
           transpose_y: bool = False, alpha: float = 1.0, name=None) -> Variable:
    helper = LayerHelper("matmul", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="matmul", inputs={"X": [x.name], "Y": [y.name]},
                     outputs={"Out": [out.name]},
                     attrs={"transpose_X": transpose_x, "transpose_Y": transpose_y,
                            "alpha": alpha})
    return out


def flash_attention(q: Variable, k: Variable, v: Variable,
                    attn_bias: Optional[Variable] = None,
                    causal: bool = False, dropout_prob: float = 0.0,
                    is_test: bool = False, num_heads: Optional[int] = None,
                    name=None) -> Variable:
    """Fused memory-efficient attention (the hand-written Hopper kernel on
    the card; its plain PyTorch version on the CPU).

    Two layouts:
    - [B, H, T, D] 4D q/k/v; `attn_bias` broadcastable to [B, H, T, T].
    - packed [B, T, H·D] 3D q/k/v with `num_heads` (required for 3D) — the
      form for fused-qkv models, read in place. `attn_bias` is the [B, 1, T]
      mask."""
    helper = LayerHelper("flash_attention", name=name)
    out = helper.create_variable_for_type_inference(q.dtype, shape=q.shape)
    inputs = {"Q": [q.name], "K": [k.name], "V": [v.name]}
    if attn_bias is not None:
        inputs["BiasQK"] = [attn_bias.name]
    attrs = {"causal": causal, "dropout_prob": dropout_prob,
             "is_test": is_test}
    if num_heads is not None:
        attrs["num_heads"] = int(num_heads)
    helper.append_op(type="flash_attention", inputs=inputs,
                     outputs={"Out": [out.name]}, attrs=attrs)
    return out


def flash_attention_sparse(q: Variable, k: Variable, v: Variable,
                           num_heads: int, q_seg: Variable, k_seg: Variable,
                           causal: bool = False, dropout_prob: float = 0.0,
                           is_test: bool = False, name=None) -> Variable:
    """Block-sparse packed-segment attention on [B, T, H·D] rows.

    Instead of a dense additive [B, 1, Tq, Tk] mask this takes the packed
    segment-id rows themselves (reader.pack_by_tokens layout: 1-based
    contiguous ids, 0 = pad tail); visibility is carried as a compact
    per-row key-range descriptor and fully masked key tiles are skipped by
    the forward and backward Hopper kernels (their plain versions on the
    CPU). See ops/kernels/flash_attention_sparse.py."""
    helper = LayerHelper("flash_attention_sparse", name=name)
    out = helper.create_variable_for_type_inference(q.dtype, shape=q.shape)
    helper.append_op(
        type="flash_attention_sparse",
        inputs={"Q": [q.name], "K": [k.name], "V": [v.name],
                "QSeg": [q_seg.name], "KSeg": [k_seg.name]},
        outputs={"Out": [out.name]},
        attrs={"num_heads": int(num_heads), "causal": causal,
               "dropout_prob": dropout_prob, "is_test": is_test})
    return out


def moe_ffn(input: Variable, num_experts: int, hidden_size: int, k: int = 2,
            capacity_factor: float = 1.25, act: str = "gelu",
            ep_axis: str = "ep", param_attr=None, name=None):
    """Mixture-of-Experts feed-forward block (the JAX package's layer; no
    reference analog). Top-k routed, static-capacity dispatch; on a mesh
    whose data axis is `ep_axis` the tokens travel to their experts by
    all-to-all (expert parallelism, ``parallel/moe.py``), otherwise the
    dense path runs. Returns (out, aux_loss): add `aux_loss` (the Switch
    load-balance term, scaled by your coefficient) to the training loss."""
    import copy

    from ..param_attr import ParamAttr

    helper = LayerHelper("moe_ffn", name=name)
    d = input.shape[-1]

    def _attr(suffix):
        # five distinct parameters: a copy of the user's attr each (one
        # shared ParamAttr would be renamed on first use and alias them)
        a = copy.copy(ParamAttr._to_attr(param_attr))
        if a.name is not None:
            a.name = f"{a.name}.{suffix}"
        return a

    gate = helper.create_parameter(_attr("gate"), shape=[d, num_experts],
                                   dtype=input.dtype)
    w1 = helper.create_parameter(_attr("w1"),
                                 shape=[num_experts, d, hidden_size],
                                 dtype=input.dtype)
    b1 = helper.create_parameter(_attr("b1"), shape=[num_experts, hidden_size],
                                 dtype=input.dtype, is_bias=True)
    w2 = helper.create_parameter(_attr("w2"),
                                 shape=[num_experts, hidden_size, d],
                                 dtype=input.dtype)
    b2 = helper.create_parameter(_attr("b2"), shape=[num_experts, d],
                                 dtype=input.dtype, is_bias=True)
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    shape=input.shape)
    aux = helper.create_variable_for_type_inference(input.dtype, shape=())
    helper.append_op(
        type="moe_ffn",
        inputs={"X": [input.name], "GateW": [gate.name], "W1": [w1.name],
                "B1": [b1.name], "W2": [w2.name], "B2": [b2.name]},
        outputs={"Out": [out.name], "AuxLoss": [aux.name]},
        attrs={"k": k, "capacity_factor": capacity_factor, "act": act,
               "ep_axis": ep_axis})
    return out, aux


def softmax_with_cross_entropy(logits: Variable, label: Variable,
                               soft_label: bool = False, ignore_index: int = -100,
                               return_softmax: bool = False, axis: int = -1):
    helper = LayerHelper("softmax_with_cross_entropy")
    loss = helper.create_variable_for_type_inference(logits.dtype)
    sm = helper.create_variable_for_type_inference(logits.dtype)
    helper.append_op(type="softmax_with_cross_entropy",
                     inputs={"Logits": [logits.name], "Label": [label.name]},
                     outputs={"Loss": [loss.name], "Softmax": [sm.name]},
                     attrs={"soft_label": soft_label, "ignore_index": ignore_index,
                            "axis": axis})
    if return_softmax:
        return loss, sm
    return loss


def mean(x: Variable, name=None) -> Variable:
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, shape=())
    helper.append_op(type="mean", inputs={"X": [x.name]}, outputs={"Out": [out.name]}, attrs={})
    return out


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100, name=None,
                                      normalize=False) -> Variable:
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="sigmoid_cross_entropy_with_logits",
                     inputs={"X": [x.name], "Label": [label.name]},
                     outputs={"Out": [out.name]},
                     attrs={"ignore_index": ignore_index,
                            "normalize": normalize})
    return out


def square_error_cost(input: Variable, label: Variable) -> Variable:
    helper = LayerHelper("square_error_cost")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="square_error_cost",
                     inputs={"X": [input.name], "Label": [label.name]},
                     outputs={"Out": [out.name]}, attrs={})
    return out
