"""The quantization ops (``ops/quant_ops.py``) against the JAX package's on
the same numpy inputs: the seven fake-quant ops' forwards (rtol 1e-6,
atol 1e-7) and their gradients through a program (the straight-through
estimator where the JAX package has one; equal), ``quantized_fc`` (its
int32 accumulators bitwise; its outputs within rtol 1e-6 plus an absolute
1e-6 of the largest output, since torch's and jax's tanh-form gelu differ
by an ulp or two near zero) and ``quantized_lookup_table`` (bitwise)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import registry as jreg
from paddle_tpu.core import unique_name as jnames
from paddle_tpu.core.executor import ExecContext as JaxCtx
from paddle_tpu.ops import quant_ops as jq
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.dtypes import to_numpy
from paddle_tpu_torch.core.executor import ExecContext as TorchCtx
from paddle_tpu_torch.ops import quant_ops as tq

from _torch_twin import fresh_port_state

# One intra-op thread: tier-1 runs several xdist workers, and a second
# torch worker thread, started beside JAX's runtime in the same process, was
# seen to compute some batches of a CPU matmul ~1e-4 off.
torch.set_num_threads(1)

FWD_TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(autouse=True)
def _fresh_port_state():
    yield from fresh_port_state()


def _r(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


SCALE1 = np.array([1.7], np.float32)

FAKE_CASES = [
    ("abs_max", "fake_quantize_abs_max", {"X": [_r(3, 4)]},
     {"bit_length": 8}, False),
    ("abs_max_4bit", "fake_quantize_abs_max", {"X": [_r(3, 4, seed=1)]},
     {"bit_length": 4}, False),
    ("channel_wise", "fake_channel_wise_quantize_abs_max",
     {"X": [_r(3, 2, 4)]}, {"bit_length": 8}, False),
    ("moving_average_train", "fake_quantize_moving_average_abs_max",
     {"X": [_r(3, 4)], "InScale": [SCALE1]},
     {"bit_length": 8, "moving_rate": 0.9}, False),
    ("moving_average_test", "fake_quantize_moving_average_abs_max",
     {"X": [_r(3, 4)], "InScale": [SCALE1]},
     {"bit_length": 8, "moving_rate": 0.9, "is_test": True}, True),
    ("range_train", "fake_quantize_range_abs_max",
     {"X": [_r(3, 4, scale=3.0)], "InScale": [SCALE1]},
     {"bit_length": 8}, False),
    ("range_test", "fake_quantize_range_abs_max",
     {"X": [_r(3, 4, scale=3.0)], "InScale": [SCALE1]},
     {"bit_length": 8, "is_test": True}, True),
    ("ma_scale", "moving_average_abs_max_scale",
     {"X": [_r(3, 4)], "InScale": [SCALE1]}, {"moving_rate": 0.8}, False),
    ("dequantize", "fake_dequantize_max_abs",
     {"X": [_r(3, 4, scale=60.0)], "Scale": [SCALE1]},
     {"max_range": 127.0}, False),
    ("channel_wise_dequantize", "fake_channel_wise_dequantize_max_abs",
     {"X": [_r(3, 4, scale=60.0)], "Scales": [np.abs(_r(3, seed=2))]},
     {"quant_bits": [8]}, False),
]

FAKE_OPS = {c[1] for c in FAKE_CASES}


def _outputs(op_type):
    return ("Out",) if op_type in ("fake_dequantize_max_abs",
                                   "fake_channel_wise_dequantize_max_abs") \
        else ("Out", "OutScale")


def _run_both(op_type, inputs, attrs, is_test=True):
    want = jreg.get_op(op_type).fn(
        JaxCtx(None, is_test=is_test),
        {s: [jnp.asarray(a) for a in v] for s, v in inputs.items()}, attrs)
    got = treg.get_op(op_type).fn(
        TorchCtx("cpu", is_test=is_test),
        {s: [torch.from_numpy(np.array(a)) for a in v]
         for s, v in inputs.items()}, attrs)
    return want, got


def test_the_nine_ops_are_registered():
    assert FAKE_OPS | {"quantized_fc", "quantized_lookup_table"} <= set(
        treg.registered_ops())
    assert len(FAKE_OPS) == 7
    for op in FAKE_OPS:
        jdef, tdef = jreg.get_op(op), treg.get_op(op)
        assert (jdef.grad_fn is None) == (tdef.grad_fn is None), op
        assert jdef.differentiable == tdef.differentiable, op


@pytest.mark.parametrize("case", FAKE_CASES, ids=[c[0] for c in FAKE_CASES])
def test_fake_op_forward_matches_jax(case):
    _, op_type, inputs, attrs, is_test = case
    want, got = _run_both(op_type, inputs, attrs, is_test)
    assert sorted(got) == sorted(want)
    for slot in want:
        for g, w in zip(got[slot], want[slot]):
            g, w = to_numpy(g), np.asarray(w)
            assert g.shape == w.shape, (slot, g.shape, w.shape)
            np.testing.assert_allclose(g, w, err_msg=slot, **FWD_TOL)


def _grad_of(fluid, names, case, through_scale):
    """d/dX of sum(op(X)·C) through a program, X fed directly (the op's
    grad_fn hook) or as scale(X, 2) (autograd through the op)."""
    _, op_type, inputs, attrs, is_test = case
    L = fluid.layers
    with names.guard():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            blk = main.global_block()
            ins = {}
            for slot, arrs in inputs.items():
                ins[slot] = []
                for i, a in enumerate(arrs):
                    n = f"{slot.lower()}{i}"
                    L.data(n, list(a.shape), dtype=str(a.dtype),
                           append_batch_size=False)
                    ins[slot].append(n)
            x = blk.var("x0")
            src = L.scale(x, 2.0) if through_scale else x
            ins["X"] = [src.name]
            outs = {}
            for slot in _outputs(op_type):
                v = blk.create_var(name=f"q_{slot.lower()}", dtype="float32")
                outs[slot] = [v.name]
            blk.append_op(op_type, ins, outs, attrs)
            c = L.data("c", list(inputs["X"][0].shape),
                       append_batch_size=False)
            loss = L.reduce_sum(L.elementwise_mul(blk.var("q_out"), c))
            (gx,) = fluid.gradients([loss], [x])
    feed = {f"{s.lower()}{i}": a for s, arrs in inputs.items()
            for i, a in enumerate(arrs)}
    feed["c"] = _r(*inputs["X"][0].shape, seed=9)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        (g,) = exe.run(main, feed=feed, fetch_list=[gx])
    return np.asarray(g), feed["c"]


@pytest.mark.parametrize("through_scale", [False, True],
                         ids=["grad_fn", "autograd"])
@pytest.mark.parametrize("case", [c for c in FAKE_CASES if not c[4]],
                         ids=[c[0] for c in FAKE_CASES if not c[4]])
def test_fake_op_gradient_matches_jax(case, through_scale):
    want, c = _grad_of(jfluid, jnames, case, through_scale)
    from paddle_tpu_torch.core import unique_name as tnames
    got, _ = _grad_of(tfluid, tnames, case, through_scale)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if treg.get_op(case[1]).grad_fn is not None:
        # straight through: exactly the cotangent (times scale's 2)
        np.testing.assert_array_equal(got, c * (2.0 if through_scale
                                                else 1.0))


FC_CASES = [
    ("bias_relu", _r(5, 16), {"Bias": [_r(8, seed=3)]},
     {"in_num_col_dims": 1, "activation_type": "relu", "act_scale": 2.7}),
    ("no_bias", _r(5, 16), {}, {"in_num_col_dims": 1, "act_scale": 3.1}),
    ("num_col_dims_2", _r(2, 3, 16), {"Bias": [_r(8, seed=3)]},
     {"in_num_col_dims": 2, "activation_type": "gelu", "act_scale": 2.9}),
    ("matmul_form", _r(2, 3, 16), {},
     {"in_num_col_dims": -1, "activation_type": "", "act_scale": 3.3}),
    ("tanh_clipped", _r(4, 16, scale=2.0), {"Bias": [_r(8, seed=4)]},
     {"in_num_col_dims": 1, "activation_type": "tanh", "act_scale": 1.5}),
]


def _int8_weight(k, n, seed=5):
    w = _r(k, n, seed=seed)
    s = np.maximum(np.abs(w).max(0), 1e-8).astype(np.float32)
    q = np.clip(np.round(w / s * 127.0), -127, 127).astype(np.int8)
    return q, s


@pytest.mark.parametrize("case", FC_CASES, ids=[c[0] for c in FC_CASES])
def test_quantized_fc_matches_jax(case):
    _, x, extra, attrs = case
    q, s = _int8_weight(16, 8)
    inputs = {"Input": [x], "W": [q], "WScale": [s], **extra}
    want, got = _run_both("quantized_fc", inputs, attrs)
    w, g = np.asarray(want["Out"][0]), to_numpy(got["Out"][0])
    assert g.shape == w.shape and g.dtype == np.float32
    np.testing.assert_allclose(g, w, rtol=1e-6,
                               atol=1e-6 * float(np.abs(w).max()))
    # the int32 accumulators: bitwise
    x2 = x.reshape(-1, 16)
    jacc = jnp.matmul(jq._quantize_act(jnp.asarray(x2), attrs["act_scale"]),
                      jnp.asarray(q), preferred_element_type=jnp.int32)
    tacc = tq.int8_matmul(tq.quantize_act(torch.from_numpy(x2),
                                          attrs["act_scale"]),
                          torch.from_numpy(q))
    assert tacc.dtype == torch.int32
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))


def test_quantize_act_rounds_half_to_even_and_clips():
    x = np.array([[0.5, 1.5, 2.5, -0.5, -2.5, 300.0, -300.0, 0.0]],
                 np.float32)
    got = tq.quantize_act(torch.from_numpy(x), 127.0).numpy()
    want = np.asarray(jq._quantize_act(jnp.asarray(x), 127.0))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, :5], [0, 2, 2, 0, -2])


LOOKUP_CASES = [
    ("v2", np.array([[1, 0, 5], [3, 3, 7]], np.int64),
     {"table_scale": 1.9, "padding_idx": -1, "squeeze_last": False}),
    ("padding_idx", np.array([[1, 0, 5], [3, 3, 7]], np.int64),
     {"table_scale": 1.9, "padding_idx": 3, "squeeze_last": False}),
    ("squeeze_last", np.array([[[1], [0]], [[5], [7]]], np.int64),
     {"table_scale": 2.3, "padding_idx": 0, "squeeze_last": True}),
]


@pytest.mark.parametrize("case", LOOKUP_CASES,
                         ids=[c[0] for c in LOOKUP_CASES])
def test_quantized_lookup_table_matches_jax(case):
    _, ids, attrs = case
    w = np.random.RandomState(6).randint(-127, 128, (8, 4)).astype(np.int8)
    want, got = _run_both("quantized_lookup_table",
                          {"W": [w], "Ids": [ids]}, attrs)
    w_, g = np.asarray(want["Out"][0]), to_numpy(got["Out"][0])
    assert g.shape == w_.shape
    np.testing.assert_array_equal(g, w_)
