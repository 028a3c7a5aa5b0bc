"""Tensor-manipulation layers — the subset of ``paddle_tpu.layers.tensor``
the ported models and the control-flow layers use (reference
python/paddle/fluid/layers/tensor.py)."""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..core.dtypes import convert_dtype, dtype_str
from ..core.program import Variable
from ..layer_helper import LayerHelper


def cast(x: Variable, dtype) -> Variable:
    helper = LayerHelper("cast")
    out = helper.create_variable_for_type_inference(dtype, x.shape)
    helper.append_op(type="cast", inputs={"X": [x.name]}, outputs={"Out": [out.name]},
                     attrs={"out_dtype": dtype_str(convert_dtype(dtype)),
                            "in_dtype": dtype_str(x.dtype)})
    return out


def concat(input: Sequence[Variable], axis: int = 0, name=None) -> Variable:
    helper = LayerHelper("concat", name=name)
    shape = None
    if all(v.shape is not None for v in input):
        shape = list(input[0].shape)
        ax = axis if axis >= 0 else len(shape) + axis
        if all(v.shape[ax] is not None and v.shape[ax] >= 0 for v in input):
            shape[ax] = sum(v.shape[ax] for v in input)
        else:
            shape[ax] = -1
    out = helper.create_variable_for_type_inference(input[0].dtype, shape)
    helper.append_op(type="concat", inputs={"X": [v.name for v in input]},
                     outputs={"Out": [out.name]}, attrs={"axis": axis})
    return out


def slice(input: Variable, axes, starts, ends, name=None) -> Variable:
    helper = LayerHelper("slice", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="slice", inputs={"Input": [input.name]},
                     outputs={"Out": [out.name]},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends)})
    return out


def split(input: Variable, num_or_sections, dim: int = -1, name=None) -> List[Variable]:
    helper = LayerHelper("split", name=name)
    if isinstance(num_or_sections, int):
        n = num_or_sections
        attrs = {"num": n, "axis": dim}
        sections = None
    else:
        n = len(num_or_sections)
        sections = list(num_or_sections)
        attrs = {"sections": sections, "axis": dim}
    shapes = [None] * n
    if input.shape is not None:
        ax = dim if dim >= 0 else len(input.shape) + dim
        base = list(input.shape)
        if sections is None and base[ax] > 0:
            sections = [base[ax] // n] * n
        if sections is not None:
            shapes = []
            for s in sections:
                sh = list(base)
                sh[ax] = s
                shapes.append(tuple(sh))
    outs = [helper.create_variable_for_type_inference(input.dtype, shapes[i])
            for i in range(n)]
    helper.append_op(type="split", inputs={"X": [input.name]},
                     outputs={"Out": [o.name for o in outs]}, attrs=attrs)
    return outs


def reshape(x: Variable, shape: Sequence[int], actual_shape=None, act=None,
            inplace: bool = False, name=None) -> Variable:
    helper = LayerHelper("reshape", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, tuple(shape))
    helper.append_op(type="reshape", inputs={"X": [x.name]}, outputs={"Out": [out.name]},
                     attrs={"shape": list(shape)})
    return helper.append_activation(out, act)


def transpose(x: Variable, perm: Sequence[int], name=None) -> Variable:
    helper = LayerHelper("transpose", name=name)
    shape = tuple(x.shape[p] for p in perm) if x.shape else None
    out = helper.create_variable_for_type_inference(x.dtype, shape)
    helper.append_op(type="transpose", inputs={"X": [x.name]}, outputs={"Out": [out.name]},
                     attrs={"axis": list(perm)})
    return out


def unsqueeze(input: Variable, axes: Sequence[int], name=None) -> Variable:
    helper = LayerHelper("unsqueeze", name=name)
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="unsqueeze", inputs={"X": [input.name]},
                     outputs={"Out": [out.name]}, attrs={"axes": list(axes)})
    return out


def gather(input: Variable, index: Variable, overwrite: bool = True) -> Variable:
    helper = LayerHelper("gather")
    out = helper.create_variable_for_type_inference(input.dtype)
    helper.append_op(type="gather", inputs={"X": [input.name], "Index": [index.name]},
                     outputs={"Out": [out.name]}, attrs={})
    return out


def assign(input, output: Optional[Variable] = None) -> Variable:
    """A numpy array becomes an assign_value op (the values ride in the
    attrs); a Variable is copied by an assign op."""
    helper = LayerHelper("assign")
    if isinstance(input, np.ndarray):
        if output is None:
            output = helper.create_variable_for_type_inference(input.dtype, input.shape)
        helper.append_op(type="assign_value", outputs={"Out": [output.name]},
                         attrs={"values": input.reshape(-1).tolist(),
                                "shape": list(input.shape), "dtype": str(input.dtype)})
        return output
    if output is None:
        output = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op(type="assign", inputs={"X": [input.name]},
                     outputs={"Out": [output.name]}, attrs={})
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None, name=None) -> Variable:
    helper = LayerHelper("fill_constant", name=name)
    if out is None:
        out = helper.create_variable_for_type_inference(dtype, tuple(shape))
    helper.append_op(type="fill_constant", outputs={"Out": [out.name]},
                     attrs={"shape": list(shape), "dtype": dtype_str(convert_dtype(dtype)),
                            "value": float(value)})
    return out


def fill_constant_batch_size_like(input, shape, dtype, value, input_dim_idx=0,
                                  output_dim_idx=0) -> Variable:
    helper = LayerHelper("fill_constant_batch_size_like")
    out = helper.create_variable_for_type_inference(dtype)
    helper.append_op(type="fill_constant_batch_size_like",
                     inputs={"Input": [input.name]}, outputs={"Out": [out.name]},
                     attrs={"shape": list(shape),
                            "dtype": dtype_str(convert_dtype(dtype)),
                            "value": float(value),
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx})
    return out


def increment(x: Variable, value: float = 1.0, in_place: bool = True) -> Variable:
    """x + value; in place by default (the op writes x's own name: the
    executor rebinds the name to a new tensor)."""
    helper = LayerHelper("increment")
    out = x if in_place else helper.create_variable_for_type_inference(x.dtype)
    helper.append_op(type="increment", inputs={"X": [x.name]},
                     outputs={"Out": [out.name]}, attrs={"step": value})
    return out


def stack(x: Sequence[Variable], axis: int = 0) -> Variable:
    helper = LayerHelper("stack")
    out = helper.create_variable_for_type_inference(x[0].dtype)
    helper.append_op(type="stack", inputs={"X": [v.name for v in x]},
                     outputs={"Y": [out.name]}, attrs={"axis": axis})
    return out
