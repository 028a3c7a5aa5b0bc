"""Recurrent-network ops: LSTM and GRU over padded batches (counterpart of
``paddle_tpu.ops.rnn_ops``; reference lstm_op.cc, gru_op.cc,
gru_unit_op.cc, lstm_unit_op.cc, cudnn_lstm_op.cu.cc).

Sequences are padded ``[B, T, ...]`` with an optional ``Length [B]``; a
step past a row's length keeps that row's carry (``_mask_carry``), so the
last states are each row's state at its last valid step. The JAX package
computes each op as a ``lax.scan`` of plain ops, not a Pallas kernel; the
port runs the same step as a Python loop over T of eager ops and autograd
gives the backward. The loop reads nothing back to the host (T comes from
the input's shape), so the work of a step is a fixed list of launches.

Gate layouts follow the reference's weight packing: LSTM columns
``[i, f, c, o]`` (lstm_op.cc W [H, 4H]; with peepholes the bias is
``[7H]``: the gate bias, then w_ic, w_fc, w_oc), GRU weight ``[H, 3H]``
(update and reset gates, then the candidate).
"""
from __future__ import annotations

import torch

from ..core.registry import register_op
from .common import act_map, opt_input

_ACTS = act_map()


def length_mask(length, B: int, T: int, device) -> torch.Tensor:
    """[B, T] bool: t < length[b] (all true without a length)."""
    if length is None:
        return torch.ones(B, T, dtype=torch.bool, device=device)
    steps = torch.arange(T, device=length.device)
    return steps[None, :] < length.reshape(-1, 1)


def _mask_carry(new, old, mask_t):
    """`new` where the step lies inside the row's sequence, else `old`."""
    return torch.where(mask_t.reshape(-1, 1), new, old)


def _order(T: int, reverse: bool):
    return range(T - 1, -1, -1) if reverse else range(T)


@register_op("lstm", nondiff_inputs=["Length"])
def _lstm(ctx, inputs, attrs):
    """dynamic_lstm: Input [B, T, 4H] (already projected), Weight [H, 4H],
    Bias [4H] or [7H] with peepholes, optional H0/C0 [B, H], Length [B].
    Outputs Hidden, Cell [B, T, H]; LastH, LastC [B, H]."""
    (x,) = inputs["Input"]
    (w,) = inputs["Weight"]
    bias = opt_input(inputs, "Bias")
    length = opt_input(inputs, "Length")
    h = opt_input(inputs, "H0")
    c = opt_input(inputs, "C0")
    B, T, four_h = x.shape
    H = four_h // 4
    gate_act = _ACTS[attrs.get("gate_activation", "sigmoid")]
    cell_act = _ACTS[attrs.get("cell_activation", "tanh")]
    cand_act = _ACTS[attrs.get("candidate_activation", "tanh")]
    peep = (attrs.get("use_peepholes", False) and bias is not None
            and bias.shape[-1] == 7 * H)
    if h is None:
        h = x.new_zeros(B, H)
    if c is None:
        c = x.new_zeros(B, H)
    mask = length_mask(length, B, T, x.device)
    if bias is not None:
        b = bias.reshape(-1)
        b_gates = b[:4 * H]
        if peep:
            w_ic, w_fc, w_oc = b[4 * H:5 * H], b[5 * H:6 * H], b[6 * H:]
    hs, cs = [None] * T, [None] * T
    for t in _order(T, attrs.get("is_reverse", False)):
        gates = x[:, t] + h @ w
        if bias is not None:
            gates = gates + b_gates
        gi, gf, gc, go = gates.chunk(4, dim=-1)
        if peep:
            gi = gi + c * w_ic
            gf = gf + c * w_fc
        c_new = gate_act(gf) * c + gate_act(gi) * cand_act(gc)
        if peep:
            go = go + c_new * w_oc
        h_new = gate_act(go) * cell_act(c_new)
        h = _mask_carry(h_new, h, mask[:, t])
        c = _mask_carry(c_new, c, mask[:, t])
        hs[t], cs[t] = h, c
    return {"Hidden": [torch.stack(hs, dim=1)],
            "Cell": [torch.stack(cs, dim=1)], "LastH": [h], "LastC": [c]}


@register_op("gru", nondiff_inputs=["Length"])
def _gru(ctx, inputs, attrs):
    """dynamic_gru: Input [B, T, 3H] projected, Weight [H, 3H], Bias [3H],
    optional H0, Length. Outputs Hidden [B, T, H], LastH [B, H]."""
    (x,) = inputs["Input"]
    (w,) = inputs["Weight"]
    bias = opt_input(inputs, "Bias")
    length = opt_input(inputs, "Length")
    h = opt_input(inputs, "H0")
    B, T, three_h = x.shape
    H = three_h // 3
    gate_act = _ACTS[attrs.get("gate_activation", "sigmoid")]
    cand_act = _ACTS[attrs.get("activation", "tanh")]
    origin = attrs.get("origin_mode", False)
    w_gates, w_cand = w[:, :2 * H], w[:, 2 * H:]
    if h is None:
        h = x.new_zeros(B, H)
    mask = length_mask(length, B, T, x.device)
    b = None if bias is None else bias.reshape(-1)
    hs = [None] * T
    for t in _order(T, attrs.get("is_reverse", False)):
        xg, xc = x[:, t, :2 * H], x[:, t, 2 * H:]
        if b is not None:
            xg = xg + b[:2 * H]
            xc = xc + b[2 * H:]
        u, r = gate_act(xg + h @ w_gates).chunk(2, dim=-1)
        cand = cand_act(xc + (r * h) @ w_cand)
        if origin:   # h = u·h_prev + (1 − u)·c (Cho et al.)
            h_new = u * h + (1.0 - u) * cand
        else:        # the reference's default: h = (1 − u)·h_prev + u·c
            h_new = (1.0 - u) * h + u * cand
        h = _mask_carry(h_new, h, mask[:, t])
        hs[t] = h
    return {"Hidden": [torch.stack(hs, dim=1)], "LastH": [h]}


@register_op("gru_unit")
def _gru_unit(ctx, inputs, attrs):
    """One GRU step (gru_unit_op.cc): Input [B, 3H] projected, HiddenPrev
    [B, H], Weight [H, 3H], Bias [3H]."""
    (x,) = inputs["Input"]
    (h_prev,) = inputs["HiddenPrev"]
    (w,) = inputs["Weight"]
    bias = opt_input(inputs, "Bias")
    H = h_prev.shape[-1]
    gate_act = _ACTS[attrs.get("gate_activation", "sigmoid")]
    cand_act = _ACTS[attrs.get("activation", "tanh")]
    xg, xc = x[:, :2 * H], x[:, 2 * H:]
    if bias is not None:
        b = bias.reshape(-1)
        xg = xg + b[:2 * H]
        xc = xc + b[2 * H:]
    u, r = gate_act(xg + h_prev @ w[:, :2 * H]).chunk(2, dim=-1)
    cand = cand_act(xc + (r * h_prev) @ w[:, 2 * H:])
    h_new = (1.0 - u) * h_prev + u * cand
    return {"Hidden": [h_new], "Gate": [torch.cat([u, r], dim=-1)],
            "ResetHiddenPrev": [r * h_prev]}


@register_op("lstm_unit")
def _lstm_unit(ctx, inputs, attrs):
    """One LSTM step on projected gates (lstm_unit_op.cc): X [B, 4H],
    C_prev [B, H]; gate order [i, f, c, o]."""
    (gates,) = inputs["X"]
    (c_prev,) = inputs["C_prev"]
    gi, gf, gc, go = gates.chunk(4, dim=-1)
    c = (torch.sigmoid(gf + attrs.get("forget_bias", 0.0)) * c_prev
         + torch.sigmoid(gi) * torch.tanh(gc))
    return {"C": [c], "H": [torch.sigmoid(go) * torch.tanh(c)]}


@register_op("cudnn_lstm", nondiff_inputs=["Length"])
def _multilayer_lstm(ctx, inputs, attrs):
    """Multi-layer, optionally bidirectional LSTM over raw Input [B, T, D]
    (cudnn_lstm_op.cu.cc): one `lstm` a layer and direction on the input
    projected by WeightX [Din, 4H], WeightH [H, 4H], Bias [4H] (layer-major,
    forward then reverse); inter-layer dropout draws from the run's
    generator. Outputs Out [B, T, H·dirs], LastH/LastC [layers·dirs, B, H]."""
    (x,) = inputs["Input"]
    wxs, whs = inputs["WeightX"], inputs["WeightH"]
    biases = inputs.get("Bias") or [None] * len(wxs)
    length = opt_input(inputs, "Length")
    layers = attrs.get("num_layers", 1)
    dirs = 2 if attrs.get("is_bidirec", False) else 1
    p = attrs.get("dropout_prob", 0.0)
    cur, last_h, last_c = x, [], []
    for layer in range(layers):
        outs = []
        for d in range(dirs):
            k = layer * dirs + d
            out = _lstm(ctx, {
                "Input": [torch.einsum("btd,dh->bth", cur, wxs[k])],
                "Weight": [whs[k]],
                "Bias": [biases[k]] if biases[k] is not None else [],
                "Length": [length] if length is not None else []},
                {"is_reverse": d == 1})
            outs.append(out["Hidden"][0])
            last_h.append(out["LastH"][0])
            last_c.append(out["LastC"][0])
        cur = torch.cat(outs, dim=-1) if dirs == 2 else outs[0]
        if p > 0.0 and not ctx.is_test and layer < layers - 1:
            keep = 1.0 - p
            draw = torch.rand(cur.shape, generator=ctx.rng(),
                              device=cur.device)
            cur = cur * (draw < keep).to(cur.dtype) / keep
    return {"Out": [cur], "LastH": [torch.stack(last_h)],
            "LastC": [torch.stack(last_c)]}
