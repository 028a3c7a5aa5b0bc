"""Layers DSL — the subset of ``paddle_tpu.layers.nn`` the BERT serving and
training slices use, emitting the same ops, attrs and var descs (reference
``python/paddle/fluid/layers/nn.py``)."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..core.dtypes import convert_dtype
from ..core.program import Variable, default_main_program
from ..initializer import ConstantInitializer, XavierInitializer
from ..layer_helper import LayerHelper


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
              param_attr=None, dtype="float32", name=None) -> Variable:
    """layers/nn.py embedding → lookup_table op (dense table)."""
    helper = LayerHelper("embedding", name=name)
    attrs = {"padding_idx": -1 if padding_idx is None else padding_idx,
             "is_sparse": is_sparse, "is_distributed": is_distributed}
    w = helper.create_parameter(param_attr, shape=list(size), dtype=dtype,
                                default_initializer=XavierInitializer())
    out_shape = None
    if input.shape is not None:
        ids_shape = input.shape[:-1] if input.shape[-1] == 1 else input.shape
        out_shape = tuple(ids_shape) + (size[-1],)
    out = helper.create_variable_for_type_inference(dtype, out_shape)
    helper.append_op(
        type="lookup_table", inputs={"W": [w.name], "Ids": [input.name]},
        outputs={"Out": [out.name]}, attrs=attrs)
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
