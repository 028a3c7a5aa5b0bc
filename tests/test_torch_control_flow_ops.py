"""The 25 ops the port registers since its control-flow slice, each against
the JAX package's op on the same numpy inputs: every forward output, and,
where the op is differentiable, the input gradients of a random cotangent
on its float outputs (``jax.vjp`` against ``torch.autograd.grad``), rtol
1e-5 plus atol 1e-6 (a gradient: plus 1e-6 of its largest magnitude).
The block ops (``while``, ``static_rnn``, ``cond``, ``switch``) get their
sub-blocks from one small program built in each package. The cases cover
the tensor arrays' index wrap and clamp (i = max_len + 3, i = −1),
``chunk_eval`` in its four schemes and ``crf_decoding``'s ties."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import registry as jreg
from paddle_tpu.core import unique_name as jnames
from paddle_tpu.core.executor import ExecContext as JaxCtx
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core import unique_name as tnames
from paddle_tpu_torch.core.dtypes import to_numpy
from paddle_tpu_torch.core.executor import ExecContext as TorchCtx

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _r(*shape, seed=0, scale=1.0):
    return np.asarray(np.random.RandomState(seed).randn(*shape) * scale,
                      np.float32)


def _pos(*shape, seed=0):
    return (np.random.RandomState(seed).rand(*shape) + 0.5).astype(np.float32)


def _i64(*vals):
    return np.asarray(vals, np.int64)


# -- the block ops: (fl) -> (inputs by slot, attrs) of the op in a program ---

def _block_op(fl, build, op_type):
    main, startup = fl.Program(), fl.Program()
    names = jnames if fl is jfluid else tnames
    with names.guard(), fl.program_guard(main, startup):
        values = build(fl)
    (op,) = [o for o in main.global_block().ops if o.type == op_type]
    return ({s: [values[n] for n in ns] for s, ns in op.inputs.items()},
            op.attrs)


def _while_prog(bounded):
    def build(fl):
        L = fl.layers
        x = L.data("x", [2, 3], append_batch_size=False)
        acc = L.assign(x)
        i = L.fill_constant([1], "int64", 0)
        n = L.fill_constant([1], "int64", 3)
        cond = L.less_than(i, n)
        with L.While(cond, max_iters=5 if bounded else None):
            L.assign(L.elementwise_mul(acc, L.tanh(acc)), acc)
            L.assign(L.increment(i, value=1), i)
            L.assign(L.less_than(i, n), cond)
        return {acc.name: _r(2, 3, seed=4), i.name: _i64(0),
                n.name: _i64(3), cond.name: np.array([True])}
    return lambda fl: _block_op(fl, build, "while")


def _static_rnn_prog(fl):
    def build(fl):
        L = fl.layers
        x = L.data("x", [2, 4, 3], append_batch_size=False)
        h0 = L.data("h0", [2, 5], append_batch_size=False)
        rnn = L.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            h = rnn.memory(init=h0)
            nh = L.fc(L.concat([xt, h], axis=1), size=5, act="tanh",
                      param_attr=fl.ParamAttr(name="rw"),
                      bias_attr=fl.ParamAttr(name="rb"))
            rnn.update_memory(h, nh)
            rnn.output(nh)
        rnn()
        return {x.name: _r(2, 4, 3, seed=1), h0.name: _r(2, 5, seed=2),
                "rw": _r(8, 5, seed=3, scale=0.5), "rb": _r(5, seed=4)}
    return _block_op(fl, build, "static_rnn")


def _cond_prog(flag):
    def build(fl):
        L = fl.layers
        x = L.data("x", [4], append_batch_size=False)
        p = L.data("p", [1], dtype="bool", append_batch_size=False)
        L.cond(p, lambda: L.scale(x, scale=2.0, bias=1.0),
               lambda: L.elementwise_mul(x, x))
        return {x.name: _r(4, seed=5), p.name: np.array([flag])}
    return lambda fl: _block_op(fl, build, "cond")


def _switch_prog(step):
    def build(fl):
        L = fl.layers
        s = L.data("s", [1], append_batch_size=False)
        lr = L.fill_constant([1], "float32", 0.0)
        b1 = L.fill_constant([1], "float32", 5.0)
        b2 = L.fill_constant([1], "float32", 10.0)
        c1, c2 = L.less_than(s, b1), L.less_than(s, b2)
        with L.Switch() as sw:
            with sw.case(c1):
                L.assign(L.fill_constant([1], "float32", 0.1), lr)
            with sw.case(c2):
                L.assign(L.scale(s, scale=0.01), lr)
            with sw.default():
                L.assign(L.fill_constant([1], "float32", 0.001), lr)
        v = np.array([step], np.float32)
        return {s.name: v, lr.name: np.zeros(1, np.float32),
                c1.name: v < 5.0, c2.name: v < 10.0}
    return lambda fl: _block_op(fl, build, "switch")


_TIES = np.zeros((2, 4, 3), np.float32)   # every path scores the same
_TAGS_IOB = np.array([[0, 1, 1, 6, 2, 3, 4, 0, 6, 5],
                      [2, 3, 6, 6, 0, 0, 1, 4, 5, 5]], np.int64)
_TAGS_IOB_INF = np.array([[0, 1, 6, 6, 2, 3, 4, 0, 6, 5],
                          [2, 3, 6, 6, 0, 1, 1, 4, 5, 4]], np.int64)
_TAGS_IOBES = np.array([[0, 1, 2, 3, 8, 4, 5, 6, 7, 8],
                        [3, 7, 0, 2, 8, 8, 4, 6, 0, 1]], np.int64)
_TAGS_IOBES_INF = np.array([[0, 1, 2, 3, 8, 4, 5, 5, 7, 8],
                            [3, 7, 0, 2, 8, 8, 4, 6, 0, 2]], np.int64)
_LEN10 = np.array([10, 8], np.int64)

# (case id, op type, inputs (or (fl) -> (inputs, attrs)), attrs,
#  diff input slots)
OP_CASES = [
    ("increment_int", "increment", {"X": [_i64(4)]}, {"step": 1}, ()),
    ("increment_float", "increment", {"X": [_r(3)]}, {"step": 2.5}, ()),
    ("fill_constant_batch_size_like", "fill_constant_batch_size_like",
     {"Input": [_r(3, 4)]},
     {"shape": [-1, 5], "dtype": "float32", "value": 1.5}, ()),
    ("fill_constant_batch_size_like_dims", "fill_constant_batch_size_like",
     {"Input": [_r(3, 4)]},
     {"shape": [2, -1], "dtype": "int64", "value": 7.0, "input_dim_idx": 1,
      "output_dim_idx": 1}, ()),
    ("stack", "stack", {"X": [_r(2, 3), _r(2, 3, seed=1), _r(2, 3, seed=2)]},
     {"axis": 1}, ("X",)),
    ("reduce_max", "reduce_max", {"X": [_r(2, 3, 4)]}, {"dim": [1]}, ("X",)),
    ("reduce_max_ties_all", "reduce_max",
     {"X": [np.array([[1.0, 3.0, 3.0], [2.0, 3.0, 0.5]], np.float32)]},
     {"reduce_all": True}, ("X",)),
    ("reduce_min_keep", "reduce_min", {"X": [_r(2, 3, 4)]},
     {"dim": [0, 2], "keep_dim": True}, ("X",)),
    ("reduce_prod", "reduce_prod", {"X": [_pos(2, 3, 4)]}, {"dim": [1, 2]},
     ("X",)),
    ("reduce_any", "reduce_any", {"X": [_r(3, 4) > 0.8]}, {"dim": [1]}, ()),
    ("reduce_all", "reduce_all", {"X": [_r(3, 4) > -1.5]},
     {"reduce_all": True, "keep_dim": True}, ()),
    ("max_sequence_len", "max_sequence_len",
     {"RankTable": [_i64(3, 7, 2, 5)]}, {}, ()),
    ("while_unbounded", "while", _while_prog(False), None, ()),
    ("while_bounded", "while", _while_prog(True), None, ("X",)),
    ("static_rnn", "static_rnn", _static_rnn_prog, None,
     ("State", "Seq", "Param")),
    ("cond_true", "cond", _cond_prog(True), None, ()),
    ("cond_false", "cond", _cond_prog(False), None, ()),
    ("switch_first", "switch", _switch_prog(3.0), None, ()),
    ("switch_second", "switch", _switch_prog(7.0), None, ()),
    ("switch_default", "switch", _switch_prog(50.0), None, ()),
    ("select", "select",
     {"Cond": [np.array([[True], [False], [True], [False]])],
      "X": [_r(4, 3)], "Y": [_r(4, 3, seed=1)]}, {}, ("X", "Y")),
    ("array_write", "array_write",
     {"Array": [_r(5, 3)], "I": [_i64(2)], "X": [_r(3, seed=1)],
      "Length": [_i64(1)]}, {}, ("Array", "X")),
    ("array_write_past_end", "array_write",
     {"Array": [_r(5, 3)], "I": [_i64(8)], "X": [_r(3, seed=1)],
      "Length": [_i64(1)]}, {}, ("Array", "X")),
    ("array_write_negative", "array_write",
     {"Array": [_r(5, 3)], "I": [_i64(-1)], "X": [_r(3, seed=1)],
      "Length": [_i64(2)]}, {}, ("Array", "X")),
    ("array_read", "array_read", {"Array": [_r(5, 3)], "I": [_i64(3)]}, {},
     ("Array",)),
    ("array_read_past_end", "array_read",
     {"Array": [_r(5, 3)], "I": [_i64(8)]}, {}, ("Array",)),
    ("array_read_negative", "array_read",
     {"Array": [_r(5, 3)], "I": [_i64(-1)]}, {}, ("Array",)),
    ("array_length", "array_length", {"Length": [_i64(4)]}, {}, ()),
    ("lstm", "lstm",
     {"Input": [_r(2, 4, 12, scale=0.5)], "Weight": [_r(3, 12, seed=1)],
      "Bias": [_r(12, seed=2)], "Length": [np.array([3, 4], np.int32)]},
     {"use_peepholes": False}, ("Input", "Weight", "Bias")),
    ("lstm_peepholes_reverse_relu", "lstm",
     {"Input": [_r(2, 4, 12, scale=0.5)], "Weight": [_r(3, 12, seed=1)],
      "Bias": [_r(21, seed=2)], "Length": [np.array([4, 2], np.int32)],
      "H0": [_r(2, 3, seed=3)], "C0": [_r(2, 3, seed=4)]},
     {"use_peepholes": True, "is_reverse": True,
      "candidate_activation": "relu", "cell_activation": "sigmoid"},
     ("Input", "Weight", "Bias", "H0", "C0")),
    ("gru", "gru",
     {"Input": [_r(2, 3, 12, scale=0.5)], "Weight": [_r(4, 12, seed=1)],
      "Bias": [_r(12, seed=2)], "Length": [np.array([3, 2], np.int32)]},
     {}, ("Input", "Weight", "Bias")),
    ("gru_origin_reverse_h0", "gru",
     {"Input": [_r(2, 3, 12, scale=0.5)], "Weight": [_r(4, 12, seed=1)],
      "H0": [_r(2, 4, seed=3)]},
     {"origin_mode": True, "is_reverse": True, "activation": "relu"},
     ("Input", "Weight", "H0")),
    ("gru_unit", "gru_unit",
     {"Input": [_r(2, 12)], "HiddenPrev": [_r(2, 4, seed=1)],
      "Weight": [_r(4, 12, seed=2)], "Bias": [_r(12, seed=3)]}, {},
     ("Input", "HiddenPrev", "Weight", "Bias")),
    ("lstm_unit", "lstm_unit",
     {"X": [_r(2, 16)], "C_prev": [_r(2, 4, seed=1)]},
     {"forget_bias": 1.0}, ("X", "C_prev")),
    ("cudnn_lstm_bidirec", "cudnn_lstm",
     {"Input": [_r(2, 5, 6)],
      "WeightX": [_r(6, 16, seed=1, scale=0.4), _r(6, 16, seed=2, scale=0.4),
                  _r(8, 16, seed=3, scale=0.4), _r(8, 16, seed=4, scale=0.4)],
      "WeightH": [_r(4, 16, seed=5, scale=0.4) for _ in range(4)],
      "Bias": [_r(16, seed=6 + k) for k in range(4)],
      "Length": [np.array([5, 3], np.int32)]},
     {"num_layers": 2, "is_bidirec": True, "hidden_size": 4},
     ("Input", "WeightX", "WeightH", "Bias")),
    ("linear_chain_crf", "linear_chain_crf",
     {"Emission": [_r(2, 4, 3)], "Transition": [_r(5, 3, seed=1)],
      "Label": [np.random.RandomState(2).randint(0, 3, (2, 4))],
      "Length": [np.array([3, 4], np.int32)]}, {},
     ("Emission", "Transition")),
    ("linear_chain_crf_label3d_nolength", "linear_chain_crf",
     {"Emission": [_r(2, 4, 3)], "Transition": [_r(5, 3, seed=1)],
      "Label": [np.random.RandomState(2).randint(0, 3, (2, 4, 1))]}, {},
     ("Emission", "Transition")),
    ("crf_decoding", "crf_decoding",
     {"Emission": [_r(3, 5, 4)], "Transition": [_r(6, 4, seed=1)],
      "Length": [np.array([5, 2, 4], np.int32)]}, {}, ()),
    ("crf_decoding_ties", "crf_decoding",
     {"Emission": [_TIES], "Transition": [np.zeros((5, 3), np.float32)],
      "Length": [np.array([4, 3], np.int32)]}, {}, ()),
    ("crf_decoding_label", "crf_decoding",
     {"Emission": [_r(3, 5, 4)], "Transition": [_r(6, 4, seed=1)],
      "Length": [np.array([5, 2, 4], np.int32)],
      "Label": [np.random.RandomState(3).randint(0, 4, (3, 5))]}, {}, ()),
    ("chunk_eval_iob", "chunk_eval",
     {"Inference": [_TAGS_IOB_INF], "Label": [_TAGS_IOB],
      "Length": [_LEN10]}, {"chunk_scheme": "IOB", "num_chunk_types": 3},
     ()),
    ("chunk_eval_ioe", "chunk_eval",
     {"Inference": [_TAGS_IOB_INF], "Label": [_TAGS_IOB]},
     {"chunk_scheme": "IOE", "num_chunk_types": 3}, ()),
    ("chunk_eval_iobes", "chunk_eval",
     {"Inference": [_TAGS_IOBES_INF], "Label": [_TAGS_IOBES],
      "Length": [_LEN10]}, {"chunk_scheme": "IOBES", "num_chunk_types": 2},
     ()),
    ("chunk_eval_plain", "chunk_eval",
     {"Inference": [_TAGS_IOB_INF[..., None]], "Label": [_TAGS_IOB[..., None]],
      "Length": [_LEN10]}, {"chunk_scheme": "plain", "num_chunk_types": 6},
     ()),
]

# the 25 (tests/test_torch_ops.py's coverage reads this list)
CONTROL_FLOW_SLICE_OPS = (
    "increment", "fill_constant_batch_size_like", "stack", "reduce_max",
    "reduce_min", "reduce_prod", "reduce_any", "reduce_all",
    "max_sequence_len", "while", "static_rnn", "cond", "switch", "select",
    "array_write", "array_read", "array_length", "lstm", "gru", "gru_unit",
    "lstm_unit", "cudnn_lstm", "linear_chain_crf", "crf_decoding",
    "chunk_eval")


def test_the_25_ops_are_registered_and_cased():
    assert len(set(CONTROL_FLOW_SLICE_OPS)) == 25
    assert set(CONTROL_FLOW_SLICE_OPS) <= set(treg.registered_ops())
    assert {c[1] for c in OP_CASES} == set(CONTROL_FLOW_SLICE_OPS)


def _inputs(case, fl):
    _, _, inputs, attrs, _ = case
    if callable(inputs):
        return inputs(fl)
    return inputs, attrs


def _cmp(got, want, tol_scale=False, what=""):
    g, w = to_numpy(got), np.asarray(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    # ints: the JAX package narrows int64 to int32, the port keeps it
    assert g.dtype.kind == w.dtype.kind, (what, g.dtype, w.dtype)
    if w.dtype.kind in "iub":
        np.testing.assert_array_equal(g, w, err_msg=what)
    else:
        atol = ATOL * (1.0 + np.abs(w).max()) if tol_scale else ATOL
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=atol, err_msg=what)


@pytest.mark.parametrize("case", OP_CASES, ids=[c[0] for c in OP_CASES])
def test_op_forward_and_gradient_match_jax(case):
    _, op_type, _, _, diff = case
    jins_np, jattrs = _inputs(case, jfluid)
    tins_np, tattrs = _inputs(case, tfluid)
    jfn, tfn = jreg.get_op(op_type).fn, treg.get_op(op_type).fn
    flat = [(s, i) for s in diff for i in range(len(jins_np[s]))
            if np.asarray(jins_np[s][i]).dtype.kind == "f"]

    def jrun(*vals):
        ins = {s: [jnp.asarray(a) for a in v] for s, v in jins_np.items()}
        for (s, i), v in zip(flat, vals):
            ins[s][i] = v
        return jfn(JaxCtx(None, is_test=True), ins, jattrs)

    leaves = [torch.from_numpy(np.array(tins_np[s][i])).requires_grad_()
              for s, i in flat]
    tins = {s: [torch.from_numpy(np.array(a)) for a in v]
            for s, v in tins_np.items()}
    for (s, i), t in zip(flat, leaves):
        tins[s][i] = t
    got = tfn(TorchCtx("cpu", is_test=True), tins, tattrs)
    want = jrun(*[jnp.asarray(jins_np[s][i]) for s, i in flat])
    assert sorted(got) == sorted(want)
    for slot in want:
        assert len(got[slot]) == len(want[slot]), slot
        for g, w in zip(got[slot], want[slot]):
            _cmp(g.detach(), w, what=slot)
    if not flat:
        return
    # a random cotangent on every float output
    outs = [(s, k) for s in sorted(want) for k in range(len(want[s]))
            if jnp.issubdtype(want[s][k].dtype, jnp.floating)]
    cots = [_r(*want[s][k].shape, seed=9 + n) for n, (s, k) in
            enumerate(outs)]

    def jflat(*vals):
        o = jrun(*vals)
        return [o[s][k] for s, k in outs]

    _, vjp = jax.vjp(jflat, *[jnp.asarray(jins_np[s][i]) for s, i in flat])
    want_grads = vjp([jnp.asarray(c) for c in cots])
    total = sum((got[s][k] * torch.from_numpy(c)).sum()
                for (s, k), c in zip(outs, cots))
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    for (s, i), leaf, g, w in zip(flat, leaves, grads, want_grads):
        _cmp(torch.zeros_like(leaf) if g is None else g, w, tol_scale=True,
             what=f"d{s}[{i}]")
