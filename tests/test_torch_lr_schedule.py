"""The port's learning-rate schedules (layers/learning_rate_scheduler.py, the
`lr_schedule` op) against the JAX package's: every kind over 12 steps of a
small SGD program from the same initial state, the lr sequence within
rtol 1e-6 (float32 arithmetic in both; exp, cos and pow may differ in the
last bit). Twins of tests/test_aux.py's test_lr_scheduler_piecewise and
test_lr_scheduler_noam_shape, with their assertions and tolerance.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from _torch_twin import fresh_port_state, run_both

torch.set_num_threads(1)

STEPS = 12


@pytest.fixture(autouse=True)
def _fresh_port_state():
    yield from fresh_port_state()


def _simple_net(fluid, lr):
    x = fluid.layers.data("x", [4])
    y = fluid.layers.fc(x, 1, bias_attr=False)
    loss = fluid.layers.mean(y)
    fluid.optimizer.SGD(lr).minimize(loss)
    return loss


SCHEDULES = {
    "noam": lambda L: L.noam_decay(d_model=64, warmup_steps=4,
                                   learning_rate=2.0),
    "exponential": lambda L: L.exponential_decay(0.1, 3, 0.5),
    "exponential_staircase": lambda L: L.exponential_decay(0.1, 3, 0.5,
                                                           staircase=True),
    "natural_exp": lambda L: L.natural_exp_decay(0.1, 3, 0.5),
    "natural_exp_staircase": lambda L: L.natural_exp_decay(
        0.1, 3, 0.5, staircase=True),
    "inverse_time": lambda L: L.inverse_time_decay(0.1, 3, 0.5),
    "inverse_time_staircase": lambda L: L.inverse_time_decay(
        0.1, 3, 0.5, staircase=True),
    "polynomial": lambda L: L.polynomial_decay(0.1, 8, 1e-3, power=2.0),
    "polynomial_linear": lambda L: L.polynomial_decay(0.1, 8),
    "polynomial_cycle": lambda L: L.polynomial_decay(0.1, 5, 1e-3, power=2.0,
                                                     cycle=True),
    "piecewise": lambda L: L.piecewise_decay([3, 7], [0.1, 0.01, 0.001]),
    "cosine": lambda L: L.cosine_decay(0.1, step_each_epoch=3, epochs=5),
    "warmup_constant": lambda L: L.linear_lr_warmup(0.05, 4, 0.0, 0.1),
    "warmup_over_polynomial": lambda L: L.linear_lr_warmup(
        L.polynomial_decay(0.1, 8, 1e-4, power=2.0), 3, 0.0, 0.1),
    "warmup_over_noam": lambda L: L.linear_lr_warmup(
        L.noam_decay(64, 4), 2, 0.001, 0.01),
}


def _build(kind):
    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            lr = SCHEDULES[kind](fluid.layers)
            loss = _simple_net(fluid, lr)
        return main, startup, [lr, loss]
    return build


def _feed(i):
    return {"x": np.random.RandomState(i).rand(2, 4).astype("float32")}


@pytest.mark.parametrize("kind", sorted(SCHEDULES))
def test_schedule_matches_jax(kind):
    (jouts, touts), (jfinal, tfinal), _ = run_both(_build(kind), _feed, STEPS)
    jlr = np.array([o[0] for o in jouts]).reshape(-1)
    tlr = np.array([o[0] for o in touts]).reshape(-1)
    assert tlr.dtype == np.float32
    np.testing.assert_allclose(tlr, jlr, rtol=1e-6)
    np.testing.assert_allclose(np.ravel([o[1] for o in touts]),
                               np.ravel([o[1] for o in jouts]), rtol=1e-5)
    # every schedule op's counter advanced once a step, int64 in the port
    counters = [n for n in tfinal if n.startswith("@LR_DECAY_COUNTER@")]
    assert counters and all(tfinal[n].dtype == np.int64 for n in counters)
    assert all(int(tfinal[n][0]) == STEPS == int(jfinal[n][0])
               for n in counters)


def test_piecewise_constants_built_once_per_device():
    """piecewise's boundaries/values and warmup's after-rate are cached
    device tensors, not rebuilt each step."""
    from paddle_tpu_torch.layers import learning_rate_scheduler as lrs

    lrs._CONSTS.clear()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        a = tfluid.layers.piecewise_decay([2, 4], [0.1, 0.01, 0.001])
        b = tfluid.layers.linear_lr_warmup(0.05, 3, 0.0, 0.1)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        exe.run(main, fetch_list=[a, b])
        cached = {k: v for k, v in lrs._CONSTS.items()}
        for _ in range(3):
            exe.run(main, fetch_list=[a, b])
    assert len(cached) == 3
    assert all(lrs._CONSTS[k] is v for k, v in cached.items())


def test_lr_scheduler_piecewise():
    """Twin of tests/test_aux.py::test_lr_scheduler_piecewise (rtol 1e-6)."""
    fluid = tfluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        lr = fluid.layers.piecewise_decay([2, 4], [0.1, 0.01, 0.001])
        loss = _simple_net(fluid, lr)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        xv = np.ones((2, 4), dtype="float32")
        lrs = []
        for _ in range(6):
            exe.run(main, feed={"x": xv}, fetch_list=[loss])
            lrs.append(float(fluid.global_scope().find_np(lr.name)[0]))
    np.testing.assert_allclose(lrs, [0.1, 0.1, 0.01, 0.01, 0.001, 0.001],
                               rtol=1e-6)


def test_lr_scheduler_noam_shape():
    """Twin of tests/test_aux.py::test_lr_scheduler_noam_shape."""
    fluid = tfluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        lr = fluid.layers.noam_decay(d_model=64, warmup_steps=4,
                                     learning_rate=1.0)
        loss = _simple_net(fluid, lr)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        xv = np.ones((2, 4), dtype="float32")
        lrs = []
        for _ in range(6):
            exe.run(main, feed={"x": xv}, fetch_list=[loss])
            lrs.append(fluid.global_scope().find_np(lr.name).item())
    # noam: rising through warmup (4 steps), then decaying
    assert lrs[1] > lrs[0] and lrs[2] > lrs[1]
    assert lrs[5] < lrs[3]
