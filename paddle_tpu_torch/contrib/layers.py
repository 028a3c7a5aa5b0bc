"""contrib layers — basic RNN units and stacks (counterpart of
``paddle_tpu.contrib.layers``; reference
``python/paddle/fluid/contrib/layers/rnn_impl.py``).

BasicGRUUnit and BasicLSTMUnit are dygraph ``Layer``s whose steps are
traced ops; basic_gru / basic_lstm are static-graph stacks of one
``dynamic_gru`` / ``dynamic_lstm`` a layer and direction (fc projection
first), with the reference's output contract: rnn_out [B, T, H·dirs],
last hidden (and cell) [layers·dirs, B, H] from each op's length-aware
final state."""
from __future__ import annotations

from ..dygraph.layers import Layer
from ..dygraph.tracer import trace_op
from ..layers import rnn as rnn_layers
from ..layers import nn as nn_layers
from ..layers import tensor as tensor_layers


class BasicGRUUnit(Layer):
    """One GRU step (rnn_impl.py BasicGRUUnit) over [B, H] states."""

    def __init__(self, name_scope=None, hidden_size=None, param_attr=None,
                 bias_attr=None, gate_activation=None, activation=None,
                 dtype="float32"):
        super().__init__()
        if hidden_size is None:  # (name_scope, hidden) or (hidden,)
            hidden_size = name_scope
        h = int(hidden_size)
        self._hidden = h
        self._gate_act = gate_activation or "sigmoid"
        self._act = activation or "tanh"
        self.gate_weight = self.create_parameter([2 * h, 2 * h], param_attr,
                                                 dtype)
        self.gate_bias = self.create_parameter([2 * h], bias_attr, dtype,
                                               is_bias=True)
        self.candidate_weight = self.create_parameter([2 * h, h], param_attr,
                                                      dtype)
        self.candidate_bias = self.create_parameter([h], bias_attr, dtype,
                                                    is_bias=True)

    def forward(self, input, pre_hidden):
        concat = trace_op("concat", {"X": [input, pre_hidden]},
                          {"axis": 1})["Out"][0]
        g = trace_op("matmul", {"X": [concat], "Y": [self.gate_weight]},
                     {})["Out"][0]
        g = trace_op("elementwise_add", {"X": [g], "Y": [self.gate_bias]},
                     {"axis": -1})["Out"][0]
        g = trace_op(self._gate_act, {"X": [g]}, {})["Out"][0]
        h = self._hidden
        r = trace_op("slice", {"Input": [g]},
                     {"axes": [1], "starts": [0], "ends": [h]})["Out"][0]
        u = trace_op("slice", {"Input": [g]},
                     {"axes": [1], "starts": [h], "ends": [2 * h]})["Out"][0]
        rh = r * pre_hidden
        cand_in = trace_op("concat", {"X": [input, rh]}, {"axis": 1})["Out"][0]
        c = trace_op("matmul", {"X": [cand_in], "Y": [self.candidate_weight]},
                     {})["Out"][0]
        c = trace_op("elementwise_add", {"X": [c], "Y": [self.candidate_bias]},
                     {"axis": -1})["Out"][0]
        c = trace_op(self._act, {"X": [c]}, {})["Out"][0]
        return u * pre_hidden + (c - u * c)


class BasicLSTMUnit(Layer):
    """One LSTM step (rnn_impl.py BasicLSTMUnit) over [B, H] states."""

    def __init__(self, name_scope=None, hidden_size=None, param_attr=None,
                 bias_attr=None, gate_activation=None, activation=None,
                 forget_bias=1.0, dtype="float32"):
        super().__init__()
        if hidden_size is None:
            hidden_size = name_scope
        h = int(hidden_size)
        self._hidden = h
        self._forget_bias = float(forget_bias)
        self._gate_act = gate_activation or "sigmoid"
        self._act = activation or "tanh"
        self.weight = self.create_parameter([2 * h, 4 * h], param_attr, dtype)
        self.bias = self.create_parameter([4 * h], bias_attr, dtype,
                                          is_bias=True)

    def forward(self, input, pre_hidden, pre_cell):
        concat = trace_op("concat", {"X": [input, pre_hidden]},
                          {"axis": 1})["Out"][0]
        g = trace_op("matmul", {"X": [concat], "Y": [self.weight]},
                     {})["Out"][0]
        g = trace_op("elementwise_add", {"X": [g], "Y": [self.bias]},
                     {"axis": -1})["Out"][0]
        h = self._hidden

        def _sl(a, b):
            return trace_op("slice", {"Input": [g]},
                            {"axes": [1], "starts": [a], "ends": [b]})["Out"][0]
        i, j, f, o = _sl(0, h), _sl(h, 2 * h), _sl(2 * h, 3 * h), \
            _sl(3 * h, 4 * h)
        sig = lambda v: trace_op(self._gate_act, {"X": [v]}, {})["Out"][0]
        act = lambda v: trace_op(self._act, {"X": [v]}, {})["Out"][0]
        fb = trace_op("scale", {"X": [f]},
                      {"scale": 1.0, "bias": self._forget_bias})["Out"][0]
        new_cell = pre_cell * sig(fb) + sig(i) * act(j)
        new_hidden = act(new_cell) * sig(o)
        return new_hidden, new_cell


def basic_gru(input, init_hidden, hidden_size, num_layers=1,
              sequence_length=None, dropout_prob=0.0, bidirectional=False,
              batch_first=True, param_attr=None, bias_attr=None,
              gate_activation=None, activation=None, dtype="float32",
              name="basic_gru"):
    """rnn_impl.py basic_gru: stacked (optionally bidirectional) GRU.
    Returns (rnn_out [B, T, H·dirs], last_hidden [layers·dirs, B, H])."""
    if not batch_first:
        input = tensor_layers.transpose(input, [1, 0, 2])
    x = input
    lasts = []
    dirs_n = 2 if bidirectional else 1

    def _init_for(idx):
        # init_hidden: [layers·dirs, B, H] → this (layer, dir)'s [B, H]
        if init_hidden is None:
            return None
        h = tensor_layers.slice(init_hidden, axes=[0], starts=[idx],
                                ends=[idx + 1])
        return tensor_layers.reshape(h, [-1, hidden_size])

    for layer in range(num_layers):
        size = 3 * hidden_size
        outs, last_states = [], []
        for d, rev in enumerate([False, True] if bidirectional else [False]):
            proj = nn_layers.fc(x, size, num_flatten_dims=2,
                                bias_attr=False, param_attr=param_attr)
            h, last = rnn_layers.dynamic_gru(
                proj, hidden_size, length=sequence_length,
                h_0=_init_for(layer * dirs_n + d), param_attr=param_attr,
                bias_attr=bias_attr, is_reverse=rev, return_last=True)
            outs.append(h)
            last_states.append(last)
        x = outs[0] if len(outs) == 1 else tensor_layers.concat(outs, axis=2)
        if dropout_prob:
            x = nn_layers.dropout(x, dropout_prob)
        lasts.extend(last_states)
    # [layers·dirs, B, H] — the op's length-aware final states
    last_hidden = tensor_layers.stack(lasts, axis=0)
    if not batch_first:
        x = tensor_layers.transpose(x, [1, 0, 2])
    return x, last_hidden


def basic_lstm(input, init_hidden, init_cell, hidden_size, num_layers=1,
               sequence_length=None, dropout_prob=0.0, bidirectional=False,
               batch_first=True, param_attr=None, bias_attr=None,
               gate_activation=None, activation=None, forget_bias=1.0,
               dtype="float32", name="basic_lstm"):
    """rnn_impl.py basic_lstm: stacked (optionally bidirectional) LSTM.
    Returns (rnn_out, last_hidden, last_cell)."""
    if not batch_first:
        input = tensor_layers.transpose(input, [1, 0, 2])
    x = input
    lasts_h, lasts_c = [], []
    dirs_n = 2 if bidirectional else 1

    def _init_for(src, idx):
        if src is None:
            return None
        h = tensor_layers.slice(src, axes=[0], starts=[idx],
                                ends=[idx + 1])
        return tensor_layers.reshape(h, [-1, hidden_size])

    for layer in range(num_layers):
        hs = []
        for d, rev in enumerate([False, True] if bidirectional else [False]):
            idx = layer * dirs_n + d
            proj = nn_layers.fc(x, 4 * hidden_size, num_flatten_dims=2,
                                bias_attr=False, param_attr=param_attr)
            h, c, lh, lc = rnn_layers.dynamic_lstm(
                proj, 4 * hidden_size, length=sequence_length,
                h_0=_init_for(init_hidden, idx),
                c_0=_init_for(init_cell, idx), param_attr=param_attr,
                bias_attr=bias_attr, is_reverse=rev, return_last=True)
            hs.append(h)
            lasts_h.append(lh)
            lasts_c.append(lc)
        x = hs[0] if len(hs) == 1 else tensor_layers.concat(hs, axis=2)
        if dropout_prob:
            x = nn_layers.dropout(x, dropout_prob)
    stackl = lambda vs: tensor_layers.stack(vs, axis=0)  # [L·dirs, B, H]
    if not batch_first:
        x = tensor_layers.transpose(x, [1, 0, 2])
    return x, stackl(lasts_h), stackl(lasts_c)
