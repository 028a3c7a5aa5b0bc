"""Twins of tests/test_control_flow_rnn.py's control-flow tests on the port
(While, the tensor arrays, Switch, cond, IfElse, StaticRNN, DynamicRNN,
the bounded differentiable While), on the CPU: each builds the JAX test's
program in both packages, starts the port from the JAX package's
initialized scope and compares every fetch (rtol 1e-5, atol 1e-6; ints
and bools equal), and keeps the JAX test's own numpy check."""
import numpy as np
import pytest
import torch

from _torch_twin import fresh_port_state, run_both

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _fresh_port_state():
    yield from fresh_port_state()


def _data(fl, name, shape, dtype="float32"):
    return fl.layers.data(name=name, shape=shape, dtype=dtype,
                          append_batch_size=False)


def _close(jouts, touts, rtol=RTOL, atol=ATOL):
    """Every fetch of every step: the port's within rtol/atol of JAX's."""
    assert len(jouts) == len(touts)
    for js, ts in zip(jouts, touts):
        assert len(js) == len(ts)
        for j, t in zip(js, ts):
            j, t = np.asarray(j), np.asarray(t)
            assert j.shape == t.shape, (j.shape, t.shape)
            if j.dtype.kind in "iub":
                np.testing.assert_array_equal(t, j)
            else:
                np.testing.assert_allclose(t, j, rtol=rtol, atol=atol)


def _twin(build, feeds, **kw):
    """Run `build` in both packages over `feeds` (one step each) and hold
    the port to JAX; returns the port's fetches of each step."""
    (jouts, touts), _, _ = run_both(build, lambda i: feeds[i], len(feeds))
    _close(jouts, touts, **kw)
    return touts


# ---------------------------------------------------------------------------
# While
# ---------------------------------------------------------------------------

def test_while_loop_sum():
    def build(fl):
        L = fl.layers
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            i = L.fill_constant([1], "int64", 0)
            limit = L.fill_constant([1], "int64", 10)
            acc = L.fill_constant([1], "float32", 0.0)
            cond = L.less_than(i, limit)
            with L.While(cond):
                acc2 = L.elementwise_add(acc, L.fill_constant([1], "float32",
                                                              2.0))
                L.assign(acc2, acc)
                L.increment(i, value=1)
                L.less_than(i, limit, cond=cond)
        return main, startup, [acc, i]

    ((acc, i),) = _twin(build, [{}])
    assert np.allclose(acc, [20.0]) and i.tolist() == [10]


def test_while_with_array_write():
    def build(fl):
        L = fl.layers
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            i = L.fill_constant([1], "int64", 0)
            limit = L.fill_constant([1], "int64", 5)
            x = L.fill_constant([3], "float32", 1.0)
            arr = L.create_array("float32", element_shape=[3], max_len=5)
            cond = L.less_than(i, limit)
            with L.While(cond):
                val = L.scale(x, scale=2.0)
                L.array_write(val, i, arr)
                L.increment(i, value=1)
                L.less_than(i, limit, cond=cond)
            n = L.array_length(arr)
        return main, startup, [arr, n]

    ((buf, n),) = _twin(build, [{}])
    assert buf.shape == (5, 3) and np.allclose(buf, 2.0)
    assert n.tolist() == [5]


# ---------------------------------------------------------------------------
# Switch / cond / IfElse
# ---------------------------------------------------------------------------

def test_switch_first_match():
    def build(fl):
        L = fl.layers
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            step = _data(fl, "step", [1])
            lr = L.fill_constant([1], "float32", 0.0)
            b1 = L.fill_constant([1], "float32", 5.0)
            b2 = L.fill_constant([1], "float32", 10.0)
            with L.Switch() as sw:
                with sw.case(L.less_than(step, b1)):
                    L.assign(L.fill_constant([1], "float32", 0.1), lr)
                with sw.case(L.less_than(step, b2)):
                    L.assign(L.fill_constant([1], "float32", 0.01), lr)
                with sw.default():
                    L.assign(L.fill_constant([1], "float32", 0.001), lr)
        return main, startup, [lr]

    cases = [(3.0, 0.1), (7.0, 0.01), (50.0, 0.001)]
    outs = _twin(build, [{"step": np.array([s], "float32")}
                         for s, _ in cases])
    for (s, expect), (lr,) in zip(cases, outs):
        assert np.allclose(lr, [expect]), (s, lr)


def _cond_build(true_fn, false_fn, n):
    def build(fl):
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            x = _data(fl, "x", [n])
            flag = _data(fl, "flag", [1], "bool")
            out = fl.layers.cond(flag, lambda: true_fn(fl, x),
                                 lambda: false_fn(fl, x))
        return main, startup, [out]
    return build


def test_functional_cond():
    xv = np.arange(4, dtype="float32")
    build = _cond_build(lambda fl, x: fl.layers.scale(x, scale=2.0),
                        lambda fl, x: fl.layers.scale(x, scale=-1.0), 4)
    (r_t,), (r_f,) = _twin(build, [{"x": xv, "flag": np.array([True])},
                                   {"x": xv, "flag": np.array([False])}])
    assert np.allclose(r_t, xv * 2) and np.allclose(r_f, -xv)


def test_cond_branch_returning_parent_var():
    xv = np.arange(3, dtype="float32")
    build = _cond_build(lambda fl, x: x,
                        lambda fl, x: fl.layers.scale(x, scale=-1.0), 3)
    (r_t,), (r_f,) = _twin(build, [{"x": xv, "flag": np.array([True])},
                                   {"x": xv, "flag": np.array([False])}])
    assert np.allclose(r_t, xv) and np.allclose(r_f, -xv)


def test_ifelse_rowwise():
    def build(fl):
        L = fl.layers
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            x = _data(fl, "x", [4, 2])
            c = _data(fl, "c", [4, 1], "bool")
            ie = L.IfElse(c)
            with ie.true_block():
                ie.output(L.scale(ie.input(x), scale=3.0))
            with ie.false_block():
                ie.output(L.scale(ie.input(x), scale=0.5))
            merged = ie()[0]
        return main, startup, [merged]

    xv = np.arange(8, dtype="float32").reshape(4, 2)
    cv = np.array([[True], [False], [True], [False]])
    ((out,),) = _twin(build, [{"x": xv, "c": cv}])
    assert np.allclose(out, np.where(cv, xv * 3.0, xv * 0.5))


# ---------------------------------------------------------------------------
# StaticRNN / DynamicRNN
# ---------------------------------------------------------------------------

def _cumsum_build(B, T, D, by_shape=False):
    def build(fl):
        L = fl.layers
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            x = _data(fl, "x", [B, T, D])
            h0 = None if by_shape else L.fill_constant([B, D], "float32", 0.0)
            rnn = L.StaticRNN()
            with rnn.step():
                xt = rnn.step_input(x)
                h = (rnn.memory(shape=[B, D], value=0.0) if by_shape
                     else rnn.memory(init=h0))
                nh = L.elementwise_add(h, xt)
                rnn.update_memory(h, nh)
                rnn.output(nh)
            out = rnn()
        return main, startup, [out]
    return build


@pytest.mark.parametrize("by_shape", [False, True],
                         ids=["memory_init", "memory_by_shape"])
def test_static_rnn_cumsum(by_shape):
    B, T, D = 2, 5 if not by_shape else 3, 3 if not by_shape else 4
    xv = np.random.RandomState(0).randn(B, T, D).astype("float32")
    ((res,),) = _twin(_cumsum_build(B, T, D, by_shape), [{"x": xv}])
    assert np.allclose(res, np.cumsum(xv, axis=1), atol=1e-5)


def _rnn_train_build(B, T, D, H, dynamic, lr, named=False, seed=None):
    def build(fl):
        L = fl.layers
        main, startup = fl.Program(), fl.Program()
        if seed is not None:
            main.random_seed = startup.random_seed = seed
        with fl.program_guard(main, startup):
            x = _data(fl, "x", [B, T, D])
            y = _data(fl, "y", [B, H])
            h0 = L.fill_constant([B, H], "float32", 0.0)
            kw = ({"param_attr": fl.ParamAttr(name="w"),
                   "bias_attr": fl.ParamAttr(name="b")} if named else {})
            if dynamic:
                length = L.fill_constant([B], "int64", T)
                rnn = L.DynamicRNN()
                guard = rnn.block()
            else:
                rnn = L.StaticRNN()
                guard = rnn.step()
            with guard:
                xt = (rnn.step_input(x, length=length) if dynamic
                      else rnn.step_input(x))
                h = rnn.memory(init=h0)
                nh = L.fc(L.concat([xt, h], axis=1), size=H, act="tanh",
                          **kw)
                rnn.update_memory(h, nh)
                rnn.output(nh)
            out = rnn()
            last = L.reshape(L.slice(out, axes=[1], starts=[T - 1],
                                     ends=[T]), [B, H])
            loss = L.mean(L.square_error_cost(last, y))
            fl.optimizer.SGD(learning_rate=lr).minimize(loss)
        return main, startup, [loss]
    return build


def test_static_rnn_with_fc_params_trains():
    B, T, D, H = 4, 6, 5, 8
    rng = np.random.RandomState(1)
    feed = {"x": rng.randn(B, T, D).astype("float32"),
            "y": rng.randn(B, H).astype("float32")}
    (jouts, touts), (jfinal, tfinal), _ = run_both(
        _rnn_train_build(B, T, D, H, False, 0.5), lambda i: feed, 12)
    _close(jouts, touts)
    losses = [float(o[0]) for o in touts]
    assert losses[-1] < losses[0] * 0.7, losses
    for n in jfinal:
        np.testing.assert_allclose(tfinal[n], jfinal[n], rtol=RTOL,
                                   atol=ATOL, err_msg=n)


def test_dynamic_rnn_masks_by_length():
    B, T, D = 3, 6, 2

    def build(fl):
        L = fl.layers
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            x = _data(fl, "x", [B, T, D])
            length = _data(fl, "len", [B], "int32")
            h0 = L.fill_constant([B, D], "float32", 0.0)
            drnn = L.DynamicRNN()
            with drnn.block():
                xt = drnn.step_input(x, length=length)
                h = drnn.memory(init=h0)
                nh = L.elementwise_add(h, xt)
                drnn.update_memory(h, nh)
                drnn.output(nh)
            out = drnn()
        return main, startup, [out]

    lv = np.array([2, 4, 6], "int32")
    ((res,),) = _twin(build, [{"x": np.ones((B, T, D), "float32"),
                               "len": lv}])
    for b, L in enumerate(lv):
        assert np.allclose(res[b, L - 1], float(L)), res[b]
        assert np.allclose(res[b, L:], 0.0), res[b]


def test_dynamic_rnn_trains_matching_static_rnn():
    """Both packages, both builders: the four loss curves agree (the port
    to JAX within rtol 1e-5; static to dynamic within the JAX test's
    1e-4)."""
    B, T, D, H = 4, 5, 3, 6
    rng = np.random.RandomState(3)
    feed = {"x": rng.randn(B, T, D).astype("float32"),
            "y": rng.randn(B, H).astype("float32")}
    curves = {}
    for dynamic in (False, True):
        (jouts, touts), _, _ = run_both(
            _rnn_train_build(B, T, D, H, dynamic, 0.3, named=True, seed=7),
            lambda i: feed, 8)
        _close(jouts, touts)
        curves[dynamic] = [float(o[0]) for o in touts]
    np.testing.assert_allclose(curves[False], curves[True], rtol=1e-4)
    assert curves[True][-1] < curves[True][0] * 0.8


# ---------------------------------------------------------------------------
# the bounded, differentiable While
# ---------------------------------------------------------------------------

def _doubling_build(B, D, N, bounded, direct):
    def build(fl):
        L = fl.layers
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            x = _data(fl, "x", [B, D])
            acc = L.elementwise_add(L.fill_constant([B, D], "float32", 0.0),
                                    x)
            i = L.fill_constant([1], "int64", 0)
            n = L.fill_constant([1], "int64", N)
            cond = L.less_than(i, n)
            with L.While(cond, max_iters=N if bounded else None):
                L.assign(L.scale(acc, scale=2.0), acc)
                L.assign(L.increment(i, value=1), i)
                L.assign(L.less_than(i, n), cond)
            loss = L.reduce_sum(acc)
            if direct:  # a differentiable path beside the loop
                loss = L.elementwise_add(loss, L.reduce_sum(x))
            (gx,) = fl.gradients([loss], [x])
        return main, startup, [loss, gx]
    return build


def test_bounded_while_differentiable():
    B, D, N = 2, 3, 4
    xv = np.ones((B, D), np.float32)
    ((lv, gv),) = _twin(_doubling_build(B, D, N, True, False), [{"x": xv}])
    # acc = x·2^N → loss = sum(x)·16, dloss/dx = 16
    assert abs(float(lv) - 2 ** N * B * D) < 1e-4
    np.testing.assert_allclose(gv, np.full((B, D), 2.0 ** N), rtol=1e-6)


def test_unbounded_while_passes_no_gradient():
    """Without max_iters the loop is registered not differentiable in both
    packages. In the port nothing passes through it: x's gradient is its
    direct path's alone (1). The JAX package's tape is keyed by var name
    and the loop writes its carried names in place, so there the loop's
    output cotangent lands on the same name before the loop, an identity
    (1 more), never the loop's true 2^N: a designed divergence."""
    B, D, N = 2, 3, 4
    xv = np.ones((B, D), np.float32)
    (jouts, touts), _, _ = run_both(_doubling_build(B, D, N, False, True),
                                    lambda i: {"x": xv}, 1)
    ((jl, jg),), ((tl, tg),) = jouts, touts
    assert abs(float(tl) - (2 ** N + 1) * B * D) < 1e-4
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tg, np.ones((B, D), np.float32))
    np.testing.assert_array_equal(jg, np.full((B, D), 2.0, np.float32))
