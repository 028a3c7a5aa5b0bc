"""The port's update-group fusion (PDTPU_FUSE_UPDATES) against its per-op
path and against the JAX package's fusion (tests/test_update_fusion.py).

A fused group runs sgd or momentum over tensor lists (torch._foreach_*) in
the per-op function's operation order, so the port's fused and per-op
steps are held BITWISE equal (losses, parameters, velocities). The JAX
twins hold the port's fused losses to the JAX package's fused losses at
that file's rtol=1e-6, atol=1e-7. The flag is read when a plan is
prepared, so each run builds a fresh program and executor.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as jnames
from paddle_tpu_torch.core import executor as texec
from paddle_tpu_torch.core import unique_name as tnames
from paddle_tpu_torch.observability import get_registry

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_port_state():
    from paddle_tpu_torch.core import program as prog_mod
    from paddle_tpu_torch.core import scope as scope_mod

    old = (prog_mod._main_program, prog_mod._startup_program,
           scope_mod._global_scope, scope_mod._current_scope)
    prog_mod._main_program = prog_mod.Program()
    prog_mod._startup_program = prog_mod.Program()
    scope_mod._global_scope = scope_mod._current_scope = scope_mod.Scope()
    with tnames.guard():
        yield
    (prog_mod._main_program, prog_mod._startup_program,
     scope_mod._global_scope, scope_mod._current_scope) = old


def _set_fuse(monkeypatch, mode):
    if mode is None:
        monkeypatch.delenv("PDTPU_FUSE_UPDATES", raising=False)
    else:
        monkeypatch.setenv("PDTPU_FUSE_UPDATES", mode)


def _mlp(fluid, opt="momentum", widths=(8,), din=6):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", [din])
        label = fluid.layers.data("label", [1], dtype="int64")
        h = x
        for w in widths:
            h = fluid.layers.fc(h, w, act="relu")
        logits = fluid.layers.fc(h, 3)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        if opt == "momentum":
            fluid.optimizer.Momentum(0.1, 0.9).minimize(loss)
        elif opt == "nesterov":
            fluid.optimizer.Momentum(0.1, 0.9,
                                     use_nesterov=True).minimize(loss)
        elif opt == "sgd":
            fluid.optimizer.SGD(0.1).minimize(loss)
        else:
            fluid.optimizer.Adam(0.01).minimize(loss)
    return main, startup, loss


def _feed(din=6, n=16):
    rng = np.random.RandomState(0)
    return {"x": rng.randn(n, din).astype("float32"),
            "label": rng.randint(0, 3, (n, 1)).astype("int64")}


_INIT = {}


def _jax_init(opt, widths, din):
    """The JAX package's startup state for `_mlp` (one per config)."""
    key = (opt, widths, din)
    if key not in _INIT:
        with jnames.guard():
            main, startup, _ = _mlp(jfluid, opt, widths, din)
        scope = jfluid.Scope()
        with jfluid.scope_guard(scope):
            main.random_seed = 3
            jfluid.Executor(jfluid.TPUPlace()).run(startup)
            _INIT[key] = {v.name: np.asarray(scope.find_var(v.name))
                          for v in main.list_vars() if v.persistable
                          and scope.find_var(v.name) is not None}
    return _INIT[key]


def _train_port(opt="momentum", steps=4, widths=(8,), din=6):
    """(losses, final state) of `steps` port steps from the JAX init."""
    with tnames.guard():
        main, startup, loss = _mlp(tfluid, opt, widths, din)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(scope):
        exe.run(startup)
        tfluid.io.load_params_from_numpy(_jax_init(opt, widths, din),
                                         scope=scope)
        feed = _feed(din)
        losses = [exe.run(main, feed=feed, fetch_list=[loss])[0]
                  for _ in range(steps)]
        state = {v.name: scope.find_np(v.name) for v in main.list_vars()
                 if v.persistable and scope.find_var(v.name) is not None}
    return losses, state, exe, main


def _train_jax(steps=4):
    with jnames.guard():
        main, startup, loss = _mlp(jfluid)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.TPUPlace())
        exe.run(startup)
        for n, v in _jax_init("momentum", (8,), 6).items():
            scope.set_var(n, v)
        feed = _feed()
        return [float(exe.run(main, feed=feed, fetch_list=[loss])[0])
                for _ in range(steps)]


def test_fused_updates_match_per_op_path(monkeypatch):
    """Twin of tests/test_update_fusion.py: fused against per-op, and the
    port's fused losses against the JAX package's fused losses."""
    _set_fuse(monkeypatch, None)
    ref, _, _, _ = _train_port()
    _set_fuse(monkeypatch, "1")
    fused, _, _, _ = _train_port()
    np.testing.assert_allclose(np.ravel(ref), np.ravel(fused), rtol=1e-6,
                               atol=1e-7)
    jax_fused = _train_jax()
    np.testing.assert_allclose(np.ravel(fused), jax_fused, rtol=1e-6,
                               atol=1e-7)


def test_fused_updates_flush_on_same_param(monkeypatch):
    """Two updates of the SAME param must stay ordered (the flush-on-conflict
    rule): sgd twice with lr=0.5 on p with grad fixed at 1 → p -= 1.0."""
    _set_fuse(monkeypatch, "1")
    from paddle_tpu_torch.core.program import Operator

    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", [4])
        h = tfluid.layers.fc(x, 4, bias_attr=False,
                             param_attr=tfluid.ParamAttr(name="w"))
        loss = tfluid.layers.mean(h)
    blk = main.global_block()
    blk.create_var(name="lr_const", shape=[1], dtype="float32",
                   persistable=True)
    blk.create_var(name="g_const", shape=[4, 4], dtype="float32",
                   persistable=True)
    for _ in range(2):
        blk.ops.append(Operator(
            blk, "sgd",
            {"Param": ["w"], "Grad": ["g_const"], "LearningRate": ["lr_const"]},
            {"ParamOut": ["w"]}, {}))
    main._bump_version()
    scope = tfluid.Scope()
    with tfluid.scope_guard(scope):
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        scope.set_var("lr_const", torch.tensor([0.5]))
        scope.set_var("g_const", torch.ones(4, 4))
        w0 = scope.find_np("w").copy()
        exe.run(main, feed={"x": np.zeros((2, 4), "float32")},
                fetch_list=[loss])
        w1 = scope.find_np("w")
    np.testing.assert_allclose(w1, w0 - 1.0, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("opt", ["momentum", "nesterov", "sgd"])
@pytest.mark.parametrize("mode", ["1", "auto"])
def test_fused_bitwise_equal_to_per_op(monkeypatch, opt, mode):
    """Losses, parameters and velocities of the fused steps are the per-op
    steps' bit for bit."""
    _set_fuse(monkeypatch, "0")
    ref_l, ref_s, _, _ = _train_port(opt, widths=(8, 8))
    _set_fuse(monkeypatch, mode)
    got_l, got_s, _, _ = _train_port(opt, widths=(8, 8))
    assert [a.tobytes() for a in got_l] == [a.tobytes() for a in ref_l]
    assert sorted(got_s) == sorted(ref_s)
    for n in ref_s:
        assert got_s[n].tobytes() == ref_s[n].tobytes(), n


def _fused_items(exe, main):
    (plan,) = [p for k, p in exe._cache.items() if k[0] == id(main)]
    return plan.schedule


def test_auto_leaves_large_parameter_per_op(monkeypatch):
    """"auto" fuses only parameters of at most 65536 elements: the
    [300, 300] weight's momentum runs per-op, the small ones fuse."""
    _set_fuse(monkeypatch, "auto")
    _, _, exe, main = _train_port("momentum", steps=1, widths=(300, 300),
                                  din=300)
    sched = _fused_items(exe, main)
    fused = [op.inputs["Param"][0] for kind, ops in sched if kind == "fused"
             for op in ops]
    single = [p.inputs["Param"][0] for kind, p in sched
              if kind == "op" and p.type == "momentum"]
    sizes = {p.name: int(np.prod(p.shape)) for p in main.all_parameters()}
    assert single and all(sizes[n] > 65536 for n in single)
    assert fused and all(sizes[n] <= 65536 for n in fused)
    assert sorted(single + fused) == sorted(sizes)


def test_adam_and_sparse_grads_stay_per_op(monkeypatch):
    """Adam is not fusable (per-parameter Beta*Pow state), and a
    SelectedRows gradient (an is_sparse embedding) takes the per-op path;
    the dense sgd updates beside it fuse."""
    _set_fuse(monkeypatch, "1")
    _, _, exe, main = _train_port("adam", steps=1)
    assert not [k for k, _ in _fused_items(exe, main) if k == "fused"]

    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        ids = tfluid.layers.data("ids", [4, 1], dtype="int64")
        emb = tfluid.layers.embedding(ids, size=[50, 8], is_sparse=True)
        h = tfluid.layers.fc(tfluid.layers.reduce_sum(emb, dim=1), 4)
        loss = tfluid.layers.mean(tfluid.layers.fc(h, 1))
        tfluid.optimizer.SGD(0.1).minimize(loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(startup)
        exe.run(main, feed={"ids": np.arange(8).reshape(2, 4, 1)},
                fetch_list=[loss])
    sched = _fused_items(exe, main)
    emb_w = [p.name for p in main.all_parameters() if p.shape[0] == 50]
    fused = [op.inputs["Param"][0] for kind, ops in sched if kind == "fused"
             for op in ops]
    single = [p.inputs["Param"][0] for kind, p in sched
              if kind == "op" and p.type == "sgd"]
    assert single == emb_w
    assert len(fused) == len(main.all_parameters()) - 1


def test_fusion_counters_count_once_per_plan(monkeypatch):
    """The fusion counters move while a plan's schedule is decided (the
    JAX package counts once per compiled signature), not on every step."""
    _set_fuse(monkeypatch, "1")
    reg = get_registry()
    names = ("executor/update_flushes", "executor/fused_update_groups",
             "executor/fused_update_ops")
    before = [reg.counter(n).value for n in names]
    _train_port("momentum", steps=1, widths=(8, 8))
    assert [reg.counter(n).value - b for n, b in zip(names, before)] \
        == [1, 1, 6]  # one flush, one group of the six parameters
    _train_port("momentum", steps=4, widths=(8, 8))
    assert [reg.counter(n).value - b for n, b in zip(names, before)] \
        == [2, 2, 12]
    assert "momentum" in texec._FUSABLE_UPDATES
