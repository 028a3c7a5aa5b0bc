"""Recurrent layers (counterpart of ``paddle_tpu.layers.rnn``; reference
``python/paddle/fluid/layers/nn.py`` dynamic_lstm, dynamic_gru, gru_unit,
lstm_unit, lstm (cudnn) and the ``layers/control_flow.py`` beam_search /
beam_search_decode wrappers).

The reference consumes LoD-packed inputs; here sequences are padded
``[B, T, ...]`` with an optional ``length [B]`` var (see ops/rnn_ops.py);
the beams are dense (ops/beam_ops.py)."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = [
    "dynamic_lstm", "dynamic_gru", "gru_unit", "lstm_unit", "lstm",
    "beam_search", "beam_search_decode",
]


def dynamic_lstm(input, size: int, length=None, h_0=None, c_0=None,
                 param_attr=None, bias_attr=None, use_peepholes: bool = True,
                 is_reverse: bool = False, gate_activation: str = "sigmoid",
                 cell_activation: str = "tanh",
                 candidate_activation: str = "tanh", dtype="float32",
                 name=None, return_last=False):
    """input: [B, T, 4*hidden] pre-projected (reference contract: fc of 4*size
    comes before dynamic_lstm — nn.py dynamic_lstm docstring). size = 4*hidden.
    Returns (hidden [B,T,H], cell [B,T,H])."""
    helper = LayerHelper("lstm", name=name)
    H = size // 4
    weight = helper.create_parameter(param_attr, shape=[H, 4 * H], dtype=dtype)
    bias_size = 7 * H if use_peepholes else 4 * H
    bias = helper.create_parameter(bias_attr, shape=[bias_size], dtype=dtype,
                                   is_bias=True)
    seq_shape = None
    last_shape = None
    if input.shape is not None:
        seq_shape = (input.shape[0], input.shape[1], H)
        last_shape = (input.shape[0], H)
    hidden = helper.create_variable_for_type_inference(dtype, seq_shape)
    cell = helper.create_variable_for_type_inference(dtype, seq_shape)
    last_h = helper.create_variable_for_type_inference(dtype, last_shape)
    last_c = helper.create_variable_for_type_inference(dtype, last_shape)
    inputs = {"Input": [input.name], "Weight": [weight.name],
              "Bias": [bias.name]}
    if length is not None:
        inputs["Length"] = [length.name]
    if h_0 is not None:
        inputs["H0"] = [h_0.name]
    if c_0 is not None:
        inputs["C0"] = [c_0.name]
    helper.append_op(
        type="lstm", inputs=inputs,
        outputs={"Hidden": [hidden.name], "Cell": [cell.name],
                 "LastH": [last_h.name], "LastC": [last_c.name]},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation})
    if return_last:  # length-aware final states from the op itself
        return hidden, cell, last_h, last_c
    return hidden, cell


def dynamic_gru(input, size: int, length=None, h_0=None, param_attr=None,
                bias_attr=None, is_reverse: bool = False,
                gate_activation: str = "sigmoid", candidate_activation: str = "tanh",
                origin_mode: bool = False, dtype="float32", name=None,
                return_last=False):
    """input: [B, T, 3*size] pre-projected. Returns hidden [B, T, size]."""
    helper = LayerHelper("gru", name=name)
    weight = helper.create_parameter(param_attr, shape=[size, 3 * size], dtype=dtype)
    bias = helper.create_parameter(bias_attr, shape=[3 * size], dtype=dtype,
                                   is_bias=True)
    seq_shape = last_shape = None
    if input.shape is not None:
        seq_shape = (input.shape[0], input.shape[1], size)
        last_shape = (input.shape[0], size)
    hidden = helper.create_variable_for_type_inference(dtype, seq_shape)
    last_h = helper.create_variable_for_type_inference(dtype, last_shape)
    inputs = {"Input": [input.name], "Weight": [weight.name], "Bias": [bias.name]}
    if length is not None:
        inputs["Length"] = [length.name]
    if h_0 is not None:
        inputs["H0"] = [h_0.name]
    helper.append_op(
        type="gru", inputs=inputs,
        outputs={"Hidden": [hidden.name], "LastH": [last_h.name]},
        attrs={"is_reverse": is_reverse, "gate_activation": gate_activation,
               "activation": candidate_activation, "origin_mode": origin_mode})
    if return_last:
        return hidden, last_h
    return hidden


def gru_unit(input, hidden, size: int, param_attr=None, bias_attr=None,
             activation: str = "tanh", gate_activation: str = "sigmoid",
             origin_mode: bool = False, dtype="float32", name=None):
    """One GRU step: input [B, 3*H] projected, hidden [B, H]. size = 3*H
    (reference gru_unit signature). Returns (new_hidden, reset_hidden, gate)."""
    helper = LayerHelper("gru_unit", name=name)
    H = size // 3
    weight = helper.create_parameter(param_attr, shape=[H, 3 * H], dtype=dtype)
    bias = helper.create_parameter(bias_attr, shape=[3 * H], dtype=dtype,
                                   is_bias=True)
    hp_shape = hidden.shape
    new_h = helper.create_variable_for_type_inference(dtype, hp_shape)
    gate = helper.create_variable_for_type_inference(
        dtype, (hp_shape[0], 2 * H) if hp_shape else None)
    reset_h = helper.create_variable_for_type_inference(dtype, hp_shape)
    helper.append_op(
        type="gru_unit",
        inputs={"Input": [input.name], "HiddenPrev": [hidden.name],
                "Weight": [weight.name], "Bias": [bias.name]},
        outputs={"Hidden": [new_h.name], "Gate": [gate.name],
                 "ResetHiddenPrev": [reset_h.name]},
        attrs={"activation": activation, "gate_activation": gate_activation,
               "origin_mode": origin_mode})
    return new_h, reset_h, gate


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias: float = 0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM step from raw x_t [B, D]: projects [x_t, h_prev] to 4H gates
    with an fc then applies the cell (reference nn.py lstm_unit)."""
    from . import nn as nn_layers
    from . import tensor as tensor_layers
    helper = LayerHelper("lstm_unit", name=name)
    H = hidden_t_prev.shape[-1]
    concat_in = tensor_layers.concat([x_t, hidden_t_prev], axis=1)
    gates = nn_layers.fc(concat_in, size=4 * H, param_attr=param_attr,
                         bias_attr=bias_attr)
    c = helper.create_variable_for_type_inference(x_t.dtype, cell_t_prev.shape)
    h = helper.create_variable_for_type_inference(x_t.dtype, hidden_t_prev.shape)
    helper.append_op(
        type="lstm_unit",
        inputs={"X": [gates.name], "C_prev": [cell_t_prev.name]},
        outputs={"C": [c.name], "H": [h.name]},
        attrs={"forget_bias": forget_bias})
    return h, c


def lstm(input, init_h=None, init_c=None, max_len=None, hidden_size: int = None,
         num_layers: int = 1, length=None, dropout_prob: float = 0.0,
         is_bidirec: bool = False, dtype="float32", name=None):
    """Multi-layer (optionally bidirectional) LSTM over raw input [B, T, D]
    (reference nn.py lstm — the cudnn_lstm path). Returns (out, last_h, last_c).
    """
    helper = LayerHelper("cudnn_lstm", name=name)
    H = hidden_size
    num_dirs = 2 if is_bidirec else 1
    D = input.shape[-1]
    wx_names, wh_names, b_names = [], [], []
    for layer in range(num_layers):
        din = D if layer == 0 else H * num_dirs
        for d in range(num_dirs):
            wx = helper.create_parameter(None, shape=[din, 4 * H], dtype=dtype)
            wh = helper.create_parameter(None, shape=[H, 4 * H], dtype=dtype)
            b = helper.create_parameter(None, shape=[4 * H], dtype=dtype,
                                        is_bias=True)
            wx_names.append(wx.name)
            wh_names.append(wh.name)
            b_names.append(b.name)
    out_shape = lasts_shape = None
    if input.shape is not None:
        out_shape = (input.shape[0], input.shape[1], H * num_dirs)
        lasts_shape = (num_layers * num_dirs, input.shape[0], H)
    out = helper.create_variable_for_type_inference(dtype, out_shape)
    last_h = helper.create_variable_for_type_inference(dtype, lasts_shape)
    last_c = helper.create_variable_for_type_inference(dtype, lasts_shape)
    inputs = {"Input": [input.name], "WeightX": wx_names,
              "WeightH": wh_names, "Bias": b_names}
    if length is not None:
        inputs["Length"] = [length.name]
    helper.append_op(
        type="cudnn_lstm", inputs=inputs,
        outputs={"Out": [out.name], "LastH": [last_h.name],
                 "LastC": [last_c.name]},
        attrs={"num_layers": num_layers, "is_bidirec": is_bidirec,
               "hidden_size": H, "dropout_prob": dropout_prob})
    return out, last_h, last_c


def beam_search(pre_ids, pre_scores, scores, beam_size: int, end_id: int,
                pre_finished=None, name=None):
    """One beam expansion step over dense [batch, beam, vocab] log-probs
    (reference beam_search_op.cc; LoD beams → dense beams, see ops/beam_ops).
    Returns (selected_ids, selected_scores, parent_idx, finished)."""
    helper = LayerHelper("beam_search", name=name)
    ids = helper.create_variable_for_type_inference("int64")
    sel_scores = helper.create_variable_for_type_inference(scores.dtype)
    parent = helper.create_variable_for_type_inference("int64")
    finished = helper.create_variable_for_type_inference("bool")
    inputs = {"Scores": [scores.name], "PreScores": [pre_scores.name]}
    if pre_finished is not None:
        inputs["PreFinished"] = [pre_finished.name]
    helper.append_op(
        type="beam_search", inputs=inputs,
        outputs={"SelectedIds": [ids.name], "SelectedScores": [sel_scores.name],
                 "ParentIdx": [parent.name], "Finished": [finished.name]},
        attrs={"beam_size": beam_size, "end_id": end_id})
    return ids, sel_scores, parent, finished


def beam_search_decode(ids, parent_idx, scores, beam_size: int = None,
                       end_id: int = None, name=None):
    """Backtrack stored [T, batch, beam] steps into [batch, beam, T] token
    sequences (reference beam_search_decode_op.cc)."""
    helper = LayerHelper("beam_search_decode", name=name)
    sentences = helper.create_variable_for_type_inference("int64")
    sent_scores = helper.create_variable_for_type_inference(scores.dtype)
    helper.append_op(
        type="beam_search_decode",
        inputs={"Ids": [ids.name], "ParentIdx": [parent_idx.name],
                "Scores": [scores.name]},
        outputs={"SentenceIds": [sentences.name],
                 "SentenceScores": [sent_scores.name]},
        attrs={})
    return sentences, sent_scores
