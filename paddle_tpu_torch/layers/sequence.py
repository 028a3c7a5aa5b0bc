"""Sequence layers over the padded-dense + length representation (the
port's copy of ``paddle_tpu.layers.sequence``).

Reference analog: the sequence_* layers of python/paddle/fluid/layers/nn.py
operating on LoDTensors. As in the JAX package, tensors are padded dense
[batch, max_len, ...] and the ops take an explicit integer `length`
Variable (see ``ops/sequence_ops.py``).
"""
from __future__ import annotations

from ..layer_helper import LayerHelper


def sequence_mask(x, maxlen: int, dtype="int64", name=None):
    helper = LayerHelper("sequence_mask", name=name)
    shape = None
    if x.shape is not None:
        shape = tuple(x.shape) + (maxlen,) if len(x.shape) == 1 else None
    out = helper.create_variable_for_type_inference(dtype, shape, stop_gradient=True)
    helper.append_op(type="sequence_mask", inputs={"X": [x.name]},
                     outputs={"Y": [out.name]},
                     attrs={"maxlen": maxlen, "out_dtype": dtype})
    return out


def sequence_pool(input, pool_type: str, length=None, is_test=False):
    helper = LayerHelper("sequence_pool")
    shape = None
    if input.shape is not None and len(input.shape) >= 2:
        shape = (input.shape[0],) + tuple(input.shape[2:])  # [B,T,...] -> [B,...]
    out = helper.create_variable_for_type_inference(input.dtype, shape)
    ins = {"X": [input.name]}
    if length is not None:
        ins["Length"] = [length.name]
    else:
        raise ValueError(
            "sequence_pool needs an explicit `length` Variable (the "
            "LoD metadata of the reference is carried as a dense tensor here)")
    helper.append_op(type="sequence_pool", inputs=ins, outputs={"Out": [out.name]},
                     attrs={"pooltype": pool_type.upper()})
    return out


def sequence_softmax(input, length, name=None):
    helper = LayerHelper("sequence_softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op(type="sequence_softmax",
                     inputs={"X": [input.name], "Length": [length.name]},
                     outputs={"Out": [out.name]}, attrs={})
    return out


def sequence_reverse(x, length=None, name=None):
    helper = LayerHelper("sequence_reverse", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    ins = {"X": [x.name]}
    if length is not None:
        ins["Length"] = [length.name]
    helper.append_op(type="sequence_reverse", inputs=ins, outputs={"Y": [out.name]}, attrs={})
    return out


def sequence_concat(input, name=None):
    helper = LayerHelper("sequence_concat", name=name)
    out = helper.create_variable_for_type_inference(input[0].dtype)
    helper.append_op(type="sequence_concat", inputs={"X": [v.name for v in input]},
                     outputs={"Out": [out.name]}, attrs={})
    return out


def sequence_pad(x, pad_value, length, maxlen=None, name=None):
    """Re-pad [B, T, ...] to `maxlen` steps, filling past each length with
    pad_value. Returns (out, out_length) like the reference sequence_pad."""
    helper = LayerHelper("sequence_pad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    out_len = helper.create_variable_for_type_inference(length.dtype,
                                                        stop_gradient=True)
    helper.append_op(type="sequence_pad",
                     inputs={"X": [x.name], "PadValue": [pad_value.name],
                             "Length": [length.name]},
                     outputs={"Out": [out.name], "Length": [out_len.name]},
                     attrs={"padded_length": -1 if maxlen is None else maxlen})
    return out, out_len


def sequence_unpad(x, length, name=None):
    helper = LayerHelper("sequence_unpad", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(type="sequence_unpad",
                     inputs={"X": [x.name], "Length": [length.name]},
                     outputs={"Out": [out.name]}, attrs={})
    return out


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding_start=None, length=None, param_attr=None,
                  bias_attr=None, act=None, name=None):
    """Context-window projection along time (reference layers/nn.py
    sequence_conv)."""
    helper = LayerHelper("sequence_conv", name=name)
    d = input.shape[-1]
    filt = helper.create_parameter(
        param_attr, shape=[filter_size * d, num_filters], dtype=input.dtype)
    out = helper.create_variable_for_type_inference(
        input.dtype,
        tuple(input.shape[:-1]) + (num_filters,) if input.shape else None)
    ins = {"X": [input.name], "Filter": [filt.name]}
    if length is not None:
        ins["Length"] = [length.name]
    start = (-((filter_size - 1) // 2) if padding_start is None
             else padding_start)
    helper.append_op(type="sequence_conv", inputs=ins,
                     outputs={"Out": [out.name]},
                     attrs={"contextLength": filter_size,
                            "contextStride": filter_stride,
                            "contextStart": start})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, shape=[num_filters],
                                    dtype=input.dtype, is_bias=True)
        tmp = helper.create_variable_for_type_inference(input.dtype, out.shape)
        helper.append_op(type="elementwise_add",
                         inputs={"X": [out.name], "Y": [b.name]},
                         outputs={"Out": [tmp.name]}, attrs={"axis": -1})
        out = tmp
    return helper.append_activation(out, act)


def sequence_slice(input, offset, length, name=None):
    helper = LayerHelper("sequence_slice", name=name)
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op(type="sequence_slice",
                     inputs={"X": [input.name], "Offset": [offset.name],
                             "Length": [length.name]},
                     outputs={"Out": [out.name]}, attrs={})
    return out


def sequence_erase(x, tokens, length=None, name=None):
    """Remove tokens in `tokens`, left-compacting; returns (out, new_len)."""
    helper = LayerHelper("sequence_erase", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    out_len = helper.create_variable_for_type_inference(
        length.dtype if length is not None else "int32", stop_gradient=True)
    ins = {"X": [x.name]}
    if length is not None:
        ins["Length"] = [length.name]
    helper.append_op(type="sequence_erase", inputs=ins,
                     outputs={"Out": [out.name], "Length": [out_len.name]},
                     attrs={"tokens": list(tokens)})
    return out, out_len


def sequence_expand_as(x, y, length=None, name=None):
    helper = LayerHelper("sequence_expand_as", name=name)
    out = helper.create_variable_for_type_inference(x.dtype)
    ins = {"X": [x.name], "Y": [y.name]}
    if length is not None:
        ins["Length"] = [length.name]
    helper.append_op(type="sequence_expand_as", inputs=ins,
                     outputs={"Out": [out.name]}, attrs={})
    return out


def sequence_enumerate(input, win_size, pad_value=0, length=None, name=None):
    helper = LayerHelper("sequence_enumerate", name=name)
    out = helper.create_variable_for_type_inference(input.dtype,
                                                    stop_gradient=True)
    ins = {"X": [input.name]}
    if length is not None:
        ins["Length"] = [length.name]
    helper.append_op(type="sequence_enumerate", inputs=ins,
                     outputs={"Out": [out.name]},
                     attrs={"win_size": win_size, "pad_value": pad_value})
    return out


def sequence_reshape(input, new_dim, length=None, name=None):
    helper = LayerHelper("sequence_reshape", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    outs = {"Out": [out.name]}
    ins = {"X": [input.name]}
    if length is not None:
        ins["Length"] = [length.name]
        out_len = helper.create_variable_for_type_inference(
            length.dtype, stop_gradient=True)
        outs["Length"] = [out_len.name]
    helper.append_op(type="sequence_reshape", inputs=ins, outputs=outs,
                     attrs={"new_dim": new_dim})
    return out


def sequence_scatter(input, ids, updates, length=None, name=None):
    helper = LayerHelper("sequence_scatter", name=name)
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    ins = {"X": [input.name], "Ids": [ids.name], "Updates": [updates.name]}
    if length is not None:
        ins["Length"] = [length.name]
    helper.append_op(type="sequence_scatter", inputs=ins,
                     outputs={"Out": [out.name]}, attrs={})
    return out


def sequence_topk_avg_pooling(input, topks, length=None, name=None):
    helper = LayerHelper("sequence_topk_avg_pooling", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    ins = {"X": [input.name]}
    if length is not None:
        ins["Length"] = [length.name]
    helper.append_op(type="sequence_topk_avg_pooling", inputs=ins,
                     outputs={"Out": [out.name]}, attrs={"topks": list(topks)})
    return out
