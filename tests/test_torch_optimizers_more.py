"""The port's remaining optimizers against the JAX package's: LarsMomentum,
DecayedAdagrad, Adadelta, RMSProp (plain and centered), Adamax and Ftrl
(lr_power -0.5 and a general power) on the `_mlp` program of
tests/test_strategy_knobs.py:11 from the JAX package's initialized scope.
One step: every parameter and accumulator within 1e-5 relative (atol 1e-7;
LARS's two norms are sums whose order differs from XLA's, within the same
bound). Four steps: the losses within 1e-5 relative.

GradientMergeOptimizer and LookaheadOptimizer (a `conditional_block` the
port runs only on the steps that apply) against the JAX package's, twins of
tests/test_strategy_knobs.py::test_gradient_merge_optimizer and
tests/test_api_parity.py::test_lookahead_optimizer_trains with their own
assertions and tolerances, update fusion inside the sub-block bitwise equal
to the per-op path, ExponentialMovingAverage apply and restore, and the
registry check.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from _torch_twin import (assert_states_close, fresh_port_state, run_both,
                         run_jax, run_port)
from paddle_tpu.core import registry as jreg
from paddle_tpu_torch.core import registry as treg

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_port_state():
    yield from fresh_port_state()


OPTIMIZERS = {
    "lars_momentum": lambda O: O.LarsMomentum(0.1, 0.9),
    "lars_momentum_coeff": lambda O: O.LarsMomentumOptimizer(
        0.05, 0.8, lars_coeff=0.01, lars_weight_decay=0.001),
    "decayed_adagrad": lambda O: O.DecayedAdagrad(0.05),
    "adadelta": lambda O: O.Adadelta(1.0, epsilon=1e-6, rho=0.9),
    "rmsprop": lambda O: O.RMSProp(0.01, momentum=0.5),
    "rmsprop_centered": lambda O: O.RMSPropOptimizer(
        0.01, rho=0.9, momentum=0.5, centered=True),
    "adamax": lambda O: O.Adamax(0.05),
    "ftrl": lambda O: O.Ftrl(0.1, l1=1e-3, l2=1e-3),
    "ftrl_power": lambda O: O.FtrlOptimizer(0.1, l1=1e-3, l2=1e-3,
                                            lr_power=-0.3),
}


def _mlp(fluid, opt, seed=9):
    """tests/test_strategy_knobs.py:11's program with `opt(fluid)`."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [8])
        y = fluid.layers.data("y", [1])
        w = np.random.RandomState(seed).rand(8, 4).astype("float32") * 0.2
        h = fluid.layers.fc(
            x, 4, act="tanh", param_attr=fluid.ParamAttr(
                name="w0",
                initializer=fluid.initializer.NumpyArrayInitializer(w)))
        pred = fluid.layers.fc(h, 1, param_attr=fluid.ParamAttr(name="w1"),
                               bias_attr=fluid.ParamAttr(name="b1"))
        loss = fluid.layers.reduce_mean(
            fluid.layers.square_error_cost(pred, y))
        opt(fluid).minimize(loss)
    return main, startup, [loss]


def _feed(i):
    rng = np.random.RandomState(0)
    return {"x": rng.rand(16, 8).astype("float32"),
            "y": rng.rand(16, 1).astype("float32")}


def _build(name):
    return lambda fluid: _mlp(fluid, lambda f: OPTIMIZERS[name](f.optimizer))


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_update_op_one_step_matches_jax(name):
    (jouts, touts), (jfinal, tfinal), _ = run_both(_build(name), _feed, 1)
    assert_states_close(jfinal, tfinal, rtol=1e-5, atol=1e-7)
    # the optimizer's accumulators were written
    accs = [n for n in tfinal if "Optimizer_" in n]
    assert accs and any(np.any(tfinal[n] != 0) for n in accs)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_four_steps_losses_match_jax(name):
    (jouts, touts), _, _ = run_both(_build(name), _feed, 4)
    jl = np.ravel([o[0] for o in jouts])
    tl = np.ravel([o[0] for o in touts])
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0] or name == "adadelta"   # adadelta starts slowly


def test_accumulator_names_match_jax():
    """Accumulators are named as in the JAX package, so
    io.load_params_from_numpy carries their state across one to one."""
    for name in OPTIMIZERS:
        with jfluid.unique_name.guard():
            jmain, _, _ = _build(name)(jfluid)
        with tfluid.unique_name.guard():
            tmain, _, _ = _build(name)(tfluid)
        assert ({v.name for v in jmain.list_vars() if v.persistable}
                == {v.name for v in tmain.list_vars() if v.persistable}), name


def _gm(fluid, inner="sgd", k=2):
    # the counter's name numbers instances per process; start both packages
    # at the same number so their programs name it alike
    fluid.optimizer.GradientMergeOptimizer._uid = 0

    def opt(f):
        base = (f.optimizer.SGD(0.1) if inner == "sgd"
                else f.optimizer.Momentum(0.1, 0.9) if inner == "momentum"
                else f.optimizer.Adam(0.05))
        return f.optimizer.GradientMergeOptimizer(base, k_steps=k)
    return _mlp(fluid, opt)


@pytest.mark.parametrize("inner", ["sgd", "adam"])
def test_gradient_merge_matches_jax(inner):
    """4 steps at k=2: losses and every persistable (parameters, inner
    accumulators, @GradientMerge buffers, the counter) within 1e-5."""
    (jouts, touts), (jfinal, tfinal), _ = run_both(
        lambda f: _gm(f, inner), _feed, 4)
    np.testing.assert_allclose(np.ravel([o[0] for o in touts]),
                               np.ravel([o[0] for o in jouts]), rtol=1e-5)
    assert_states_close(jfinal, tfinal, rtol=1e-5, atol=1e-7)
    assert any(n.endswith("@GradientMerge") for n in tfinal)


def test_gradient_merge_optimizer():
    """Twin of tests/test_strategy_knobs.py::test_gradient_merge_optimizer:
    k=2 over a fixed feed equals stepping every 2nd iteration with the same
    gradient (rtol 1e-5)."""
    fluid = tfluid
    main, startup, (loss,) = _gm(fluid)
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        merged_losses = [float(exe.run(main, feed=_feed(0),
                                       fetch_list=[loss])[0])
                         for _ in range(4)]
    # constant feed: loss stays flat within a merge window and drops after
    # the apply at the end of each window
    assert merged_losses[0] == merged_losses[1]
    assert merged_losses[2] < merged_losses[1]
    assert merged_losses[2] == merged_losses[3]

    main2, startup2, (loss2,) = _mlp(fluid, lambda f: f.optimizer.SGD(0.1))
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup2)
        plain = [float(exe.run(main2, feed=_feed(0), fetch_list=[loss2])[0])
                 for _ in range(2)]
    np.testing.assert_allclose(merged_losses[1], plain[0], rtol=1e-5)
    np.testing.assert_allclose(merged_losses[2], plain[1], rtol=1e-5)


def test_gradient_merge_skip_steps_leave_state_bitwise():
    """On the steps that do not apply, the conditional block does not run:
    parameters and inner accumulators are bitwise unchanged, the
    @GradientMerge buffers and the counter advance."""
    fluid = tfluid
    main, startup, (loss,) = _gm(fluid, "adam")
    params = [p.name for p in main.all_parameters()]
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        names = [v.name for v in main.list_vars() if v.persistable]
        snaps = [{n: scope.find_np(n).copy() for n in names}]
        for _ in range(4):
            exe.run(main, feed=_feed(0), fetch_list=[loss])
            snaps.append({n: scope.find_np(n).copy() for n in names})
    snaps = snaps[1:] + snaps[:1]   # snaps[-1]: the initial state
    adam = [n for n in names if "_AdamOptimizer_" in n]
    merge = [n for n in names if n.endswith("@GradientMerge")]
    counter = [n for n in names if n.startswith("gradient_merge_step_")]
    assert len(adam) == 4 * len(params) and merge and len(counter) == 1
    for prev, cur in ((-1, 0), (1, 2)):      # steps 1 and 3 skip
        for n in params + adam:
            assert snaps[cur][n].tobytes() == snaps[prev][n].tobytes(), n
    for prev, cur in ((0, 1), (2, 3)):       # steps 2 and 4 apply
        for n in params + adam:
            assert not np.array_equal(snaps[cur][n], snaps[prev][n]), n
    assert [int(s[counter[0]][0]) for s in snaps[:4]] == [1, 0, 1, 0]
    for n in merge:   # reset when applied, a gradient sum otherwise
        assert not snaps[1][n].any() and not snaps[3][n].any(), n
        assert snaps[0][n].any() and snaps[2][n].any(), n


def test_gradient_merge_fused_momentum_bitwise(monkeypatch):
    """PDTPU_FUSE_UPDATES=1: the momentum updates inside the conditional
    block fuse (the sub-block's own schedule, flushed before it returns)
    and equal the per-op path bit for bit."""
    from paddle_tpu_torch.observability import get_registry

    init = run_jax(lambda f: _gm(f, "momentum"), _feed, 0)[1]
    runs = {}
    ops = get_registry().counter("executor/fused_update_ops")
    for mode in ("0", "1"):
        monkeypatch.setenv("PDTPU_FUSE_UPDATES", mode)
        before = ops.value
        outs, final, _ = run_port(lambda f: _gm(f, "momentum"), _feed, 4,
                                  init)
        runs[mode] = (outs, final, ops.value - before)
    # the four parameters' updates fuse once, when the sub-block's schedule
    # is decided on its first run
    assert runs["0"][2] == 0 and runs["1"][2] == 4
    assert [o[0].tobytes() for o in runs["0"][0]] == [
        o[0].tobytes() for o in runs["1"][0]]
    for n, v in runs["0"][1].items():
        assert v.tobytes() == runs["1"][1][n].tobytes(), n


def _lookahead(fluid):
    fluid.optimizer.LookaheadOptimizer._uid = 0
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [4])
        y = fluid.layers.data("y", [1])
        pred = fluid.layers.fc(x, 1, bias_attr=False)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        opt = fluid.optimizer.LookaheadOptimizer(
            fluid.optimizer.SGD(0.1), alpha=0.5, k=3)
        opt.minimize(loss)
    return main, startup, [loss]


def _lookahead_feed(i):
    rng = np.random.RandomState(0)
    w_true = rng.rand(4, 1).astype("float32")
    xv = rng.rand(16, 4).astype("float32")
    return {"x": xv, "y": xv @ w_true}


def test_lookahead_optimizer_trains():
    """Twin of tests/test_api_parity.py::test_lookahead_optimizer_trains."""
    fluid = tfluid
    main, startup, (loss,) = _lookahead(fluid)
    with fluid.scope_guard(fluid.Scope()):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        losses = [float(exe.run(main, feed=_lookahead_feed(0),
                                fetch_list=[loss])[0])
                  for _ in range(12)]
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])


def test_lookahead_matches_jax():
    """12 steps (four syncs at k=3): losses and every persistable (the
    @SLOW copies seeded in the startup program included) within 1e-5."""
    (jouts, touts), (jfinal, tfinal), _ = run_both(_lookahead,
                                                   _lookahead_feed, 12)
    np.testing.assert_allclose(np.ravel([o[0] for o in touts]),
                               np.ravel([o[0] for o in jouts]), rtol=1e-5)
    assert_states_close(jfinal, tfinal, rtol=1e-5, atol=1e-7)
    slow = [n for n in tfinal if n.endswith("@SLOW")]
    assert slow
    # step 12 synced: the fast weights are the slow ones
    for n in slow:
        np.testing.assert_array_equal(tfinal[n], tfinal[n[:-len("@SLOW")]])


def test_conditional_block_keeps_carried_values_when_false():
    """A ConditionalBlock whose condition is false passes its carried
    values through; true runs the body."""
    fluid = tfluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [3])
        flag = fluid.layers.data("flag", [1], dtype="bool")
        y = fluid.layers.scale(x, scale=1.0)
        with fluid.layers.ConditionalBlock(flag):
            fluid.layers.assign(fluid.layers.scale(x, scale=3.0), y)
    exe = fluid.Executor(fluid.CPUPlace())
    xv = np.arange(6, dtype="float32").reshape(2, 3)
    for f, want in ((False, xv), (True, 3 * xv)):
        (got,) = exe.run(main, feed={"x": xv, "flag": np.array([[f]])},
                         fetch_list=[y])
        np.testing.assert_array_equal(got, want)
    (op,) = [o for o in main.global_block().ops
             if o.type == "conditional_block"]
    assert op.attrs["sub_block"].idx == 1


def test_exponential_moving_average_apply_and_restore():
    """EMA.update() keeps ema = decay·ema + (1 − decay)·p every step (as
    the JAX package); apply() swaps the EMA values into the scope and
    restores the parameters on exit."""
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", [4])
            loss = fluid.layers.mean(fluid.layers.fc(x, 2))
            fluid.optimizer.SGD(0.1).minimize(loss)
            ema = fluid.optimizer.ExponentialMovingAverage(0.9)
            ema.update()
        build.ema = ema
        return main, startup, [loss]

    feed = (lambda i: {"x": np.random.RandomState(i).rand(3, 4).astype(
        "float32")})
    (jouts, touts), (jfinal, tfinal), _ = run_both(build, feed, 3)
    assert_states_close(jfinal, tfinal, rtol=1e-5, atol=1e-7)
    ema = build.ema
    scope = tfluid.Scope()
    for n, v in tfinal.items():
        scope.set_var(n, torch.from_numpy(v.copy()))
    with tfluid.scope_guard(scope):
        params = {n: scope.find_np(n) for n in ema._ema_vars}
        with ema.apply():
            for n, v in ema._ema_vars.items():
                np.testing.assert_array_equal(scope.find_np(n),
                                              tfinal[v.name])
        for n, v in params.items():
            np.testing.assert_array_equal(scope.find_np(n), v)
        with ema.apply(need_restore=False):
            pass
        for n, v in ema._ema_vars.items():
            np.testing.assert_array_equal(scope.find_np(n), tfinal[v.name])


def test_model_average_is_the_reference_stub():
    """ModelAverage is the JAX package's stub: apply() is a no-op context
    and minimize() raises TypeError."""
    ma = tfluid.optimizer.ModelAverage(0.15)
    with ma.apply():
        pass
    ma.restore()
    with pytest.raises(TypeError):
        ma.minimize(None)


NEW_OPS = ("lr_schedule", "lars_momentum", "adamax", "decayed_adagrad",
           "adadelta", "rmsprop", "ftrl", "auc", "conditional_block")


def test_registry_new_ops_registered_in_both():
    """The slice's ops are registered in the port and in the JAX package,
    and the port registers no op the JAX package lacks."""
    ported = set(treg.registered_ops())
    assert set(NEW_OPS) <= ported
    assert set(NEW_OPS) <= set(jreg.registered_ops())
    assert ported <= set(jreg.registered_ops())
