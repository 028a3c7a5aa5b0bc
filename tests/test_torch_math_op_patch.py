"""Operators on the port's Variable (layers/math_op_patch.py) against the
JAX package's: every operator with Variable and scalar operands, the
reflected forms, unary minus, `@` and the comparisons, on the same numpy
feeds (negative operands for `%` and `//`); values within rtol 1e-6 (atol
1e-7), booleans and integers equal, and the static dtype and shape of each
result the JAX package's. The promotion rule (core.dtypes.promote_types)
is held to jnp.promote_types over every pair of the port's dtypes.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from _torch_twin import fresh_port_state, run_both
from paddle_tpu.core import unique_name as jnames
from paddle_tpu.core.dtypes import convert_dtype as jconvert
from paddle_tpu.core.dtypes import dtype_str as jdtype_str
from paddle_tpu_torch.core.dtypes import dtype_str, promote_types

torch.set_num_threads(1)

DTYPES = ["float16", "bfloat16", "float32", "float64", "int8", "int16",
          "int32", "int64", "uint8", "uint16", "bool"]


@pytest.fixture(autouse=True)
def _fresh_port_state():
    yield from fresh_port_state()


EXPRS = {
    "add": lambda x, y, i, j, w: x + y,
    "sub": lambda x, y, i, j, w: x - y,
    "mul": lambda x, y, i, j, w: x * y,
    "div": lambda x, y, i, j, w: x / y,
    "pow": lambda x, y, i, j, w: (x * x + 0.5) ** y,
    "mod": lambda x, y, i, j, w: x % y,
    "floordiv": lambda x, y, i, j, w: x // y,
    "add_scalar": lambda x, y, i, j, w: x + 2.5,
    "radd": lambda x, y, i, j, w: 2.5 + x,
    "rsub": lambda x, y, i, j, w: 1.5 - x,
    "rmul": lambda x, y, i, j, w: 3 * x,
    "rdiv": lambda x, y, i, j, w: 1.0 / y,
    "rpow": lambda x, y, i, j, w: 2.0 ** x,
    "pow_scalar": lambda x, y, i, j, w: (x * x) ** 0.5,
    "mod_scalar": lambda x, y, i, j, w: x % 1.5,
    "rmod": lambda x, y, i, j, w: 7.0 % y,
    "floordiv_scalar": lambda x, y, i, j, w: x // 0.75,
    "rfloordiv": lambda x, y, i, j, w: 5.0 // y,
    "neg": lambda x, y, i, j, w: -x,
    "matmul": lambda x, y, i, j, w: x @ w,
    "lt": lambda x, y, i, j, w: x < y,
    "le": lambda x, y, i, j, w: x <= 0.25,
    "gt": lambda x, y, i, j, w: x > y,
    "ge": lambda x, y, i, j, w: y >= x,
    "int_add": lambda x, y, i, j, w: i + j,
    "int_mod": lambda x, y, i, j, w: i % j,
    "int_floordiv": lambda x, y, i, j, w: i // j,
    "int_rfloordiv": lambda x, y, i, j, w: 7 // j,
    "int_div_int": lambda x, y, i, j, w: i / j,
    "int_div_scalar": lambda x, y, i, j, w: i / 2,
    "int_times_float": lambda x, y, i, j, w: i * 0.5,
    "int_plus_float_var": lambda x, y, i, j, w: i + x,
    "int_lt_scalar": lambda x, y, i, j, w: i < 1,
    "chain": lambda x, y, i, j, w: (x - y) * 2.0 / (y * y + 1.0) - -x,
}


def _build(name):
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", [3])
            y = fluid.layers.data("y", [3])
            i = fluid.layers.data("i", [3], dtype="int64")
            j = fluid.layers.data("j", [3], dtype="int64")
            w = fluid.layers.data("w", [3, 2], append_batch_size=False)
            out = EXPRS[name](x, y, i, j, w)
        build.out = out
        return main, startup, [out]
    return build


def _feed(_):
    rng = np.random.RandomState(5)
    y = rng.uniform(0.5, 2.0, (4, 3)) * np.sign(rng.randn(4, 3))
    j = rng.randint(1, 4, (4, 3)) * np.sign(rng.randn(4, 3))
    return {"x": rng.uniform(-3, 3, (4, 3)).astype("float32"),
            "y": y.astype("float32"),
            "i": rng.randint(-9, 9, (4, 3)).astype("int64"),
            "j": j.astype("int64"),
            "w": rng.randn(3, 2).astype("float32")}


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_operator_matches_jax(name):
    build = _build(name)
    (jouts, touts), _, _ = run_both(build, _feed, 1)
    (j,), (t,) = jouts[0], touts[0]
    tvar = build.out
    assert t.shape == j.shape
    assert t.dtype.kind == j.dtype.kind, (t.dtype, j.dtype)
    if j.dtype.kind == "f":
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7)
    else:
        np.testing.assert_array_equal(t, j)
    # the static dtype and shape: the JAX package's for the same expression
    with jnames.guard():
        build(jfluid)
    jvar = build.out
    assert dtype_str(tvar.dtype) == jdtype_str(jvar.dtype), name
    assert tvar.shape == jvar.shape, name


def test_eq_and_ne_stay_identity():
    """__eq__/__ne__ are Python identity: Variables stay hashable."""
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        x = tfluid.layers.data("x", [3])
        y = tfluid.layers.data("y", [3])
    assert (x == x) is True and (x == y) is False and (x != y) is True
    assert len({x: 1, y: 2}) == 2
    assert not main.global_block().ops


def test_operators_go_to_the_current_block():
    """Inside a ConditionalBlock the operator's op lands in the sub-block."""
    main = tfluid.Program()
    with tfluid.program_guard(main, tfluid.Program()):
        x = tfluid.layers.data("x", [3])
        c = tfluid.layers.data("c", [1], dtype="bool")
        with tfluid.layers.ConditionalBlock(c):
            x * 2.0
    sub = main.blocks[1]
    assert [op.type for op in sub.ops] == ["fill_constant", "elementwise_mul"]


@pytest.mark.parametrize("a,b", list(itertools.product(DTYPES, DTYPES)))
def test_promote_types_matches_jnp(a, b):
    want = jdtype_str(jnp.promote_types(jconvert(a), jconvert(b)))
    assert dtype_str(promote_types(a, b)) == want
