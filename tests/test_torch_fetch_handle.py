"""Executor.run(return_handle=True) and the port's FetchHandle (twin of
the JAX package's dataio/handle.py surface, tests/test_dataio.py).

Results through a handle are held BITWISE equal to return_numpy=True, on a
tiny training program through the plain executor and through a one-device
CompiledProgram. On the CPU a handle carries no CUDA event: `is_ready()` is
True at once and `block_until_ready()` returns without a wait; the
fetch-wait metrics are recorded all the same."""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import unique_name as tnames
from paddle_tpu_torch.dataio import FetchHandle
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


def _build():
    x = tfluid.layers.data("x", [4])
    h = tfluid.layers.fc(x, 8, act="relu")
    y = tfluid.layers.fc(h, 3)
    loss = tfluid.layers.mean(y)
    tfluid.optimizer.Momentum(0.1, 0.9).minimize(loss)
    return loss, y


def _batches(n, batch=2, dim=4, seed=0):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(batch, dim).astype("float32")} for _ in range(n)]


@pytest.mark.parametrize("compiled", [False, True])
def test_handle_results_bitwise_equal_to_numpy(compiled):
    loss, y = _build()
    main = tfluid.default_main_program()
    prog = (tfluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name) if compiled else main)
    exe = tfluid.Executor(tfluid.CPUPlace())
    feeds = _batches(4)
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(tfluid.default_startup_program())
        sync = [exe.run(prog, feed=f, fetch_list=[loss, y]) for f in feeds]
    with tfluid.scope_guard(tfluid.Scope()):
        exe.run(tfluid.default_startup_program())
        handles = [exe.run(prog, feed=f, fetch_list=[loss, y],
                           return_handle=True) for f in feeds]
        got = [h.numpy() for h in handles]
    for a, b in zip(sync, got):
        for u, v in zip(a, b):
            assert u.dtype == v.dtype and u.tobytes() == v.tobytes()


def test_fetch_handle_protocol():
    loss, y = _build()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    h = exe.run(feed=_batches(1)[0], fetch_list=[loss, y],
                return_handle=True)
    assert isinstance(h, FetchHandle)
    assert len(h) == 2 and h.names == [loss.name, y.name]
    assert repr(h) == f"FetchHandle(2 fetches [{loss.name}, {y.name}], " \
        "pending)"
    assert h.is_ready() and h.block_until_ready() is h
    ts = h.tensors()
    assert all(isinstance(t, torch.Tensor) and not t.requires_grad
               for t in ts)
    first = h.numpy()
    assert h.numpy() is first  # cached: one wait
    assert repr(h).endswith("materialized)")
    assert [a.tobytes() for a in h] == [a.tobytes() for a in first]
    assert h[1].shape == (2, 3) and h[1].tobytes() == first[1].tobytes()
    many = FetchHandle([f"f{i}" for i in range(6)], [torch.zeros(1)] * 6)
    assert repr(many) == "FetchHandle(6 fetches [f0, f1, f2, f3, ...], " \
        "pending)"
    # a fetch-less step still returns a handle to wait on
    empty = exe.run(feed=_batches(1)[0], fetch_list=[], return_handle=True)
    assert len(empty) == 0 and empty.is_ready() and empty.numpy() == []


def test_fetch_wait_metrics_recorded():
    loss, _ = _build()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    reg = get_registry()
    n0 = reg.histogram("executor/fetch_wait_ms").count
    reg.gauge("executor/last_fetch_wait_ms").set(-1.0)
    h = exe.run(feed=_batches(1)[0], fetch_list=[loss], return_handle=True)
    h.numpy()
    h.numpy()  # cached: no second observation
    assert reg.histogram("executor/fetch_wait_ms").count - n0 == 1
    assert reg.gauge("executor/last_fetch_wait_ms").value >= 0.0
    h.block_until_ready()
    assert reg.histogram("executor/fetch_wait_ms").count - n0 == 2
