"""The port's flag tree (paddle_tpu_torch.flags) and FLAGS_check_nan_inf.

Twins of tests/test_aux.py::test_check_nan_inf_flag, of
tests/test_dataio.py's TestCheckNanInf (both tests) and of its
test_env_aliases_bootstrap; the NaN feed is also run through the JAX
package, and both must raise FloatingPointError with the same message.
tests/test_dataio.py's test_compile_cache_enable_records_entry_count has
no twin: it tests jax's persistent compilation cache, and the port's
compile_cache_dir is inert (the port compiles only its kernels, whose
builds have their own cache).

matmul_precision maps onto torch's TF32 switches; the flag alone sets
them, and `cuda_device()` (every Executor and Predictor on the card) no
longer touches them, which is tested here with torch.cuda's availability
and device count stubbed."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu_torch import flags as flags_mod
from paddle_tpu_torch.core import unique_name as tnames

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
    old_flags = dict(flags_mod._FLAGS)
    with tnames.guard():
        yield
    flags_mod._FLAGS.update(old_flags)
    flags_mod._apply_precision(flags_mod._FLAGS["matmul_precision"])
    (prog_mod._main_program, prog_mod._startup_program,
     scope_mod._global_scope, scope_mod._current_scope) = old


def _nan_log_error(fluid):
    """The error a NaN raises under FLAGS_check_nan_inf (test_aux.py takes
    log(-1); the port has no log layer yet, so this takes sqrt(-1))."""
    fluid.set_flags({"FLAGS_check_nan_inf": True})
    try:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", [2])
            y = fluid.layers.sqrt(x)  # sqrt(-1) = nan
            exe = fluid.Executor(fluid.CPUPlace())
            with pytest.raises(FloatingPointError) as err:
                exe.run(main, feed={"x": -np.ones((1, 2), "float32")},
                        fetch_list=[y])
        return str(err.value)
    finally:
        fluid.set_flags({"FLAGS_check_nan_inf": False})


def test_check_nan_inf_flag():
    assert _nan_log_error(tfluid) == _nan_log_error(jfluid)


def test_nan_feed_raises_with_name():
    x = tfluid.layers.data("x", [4])
    loss = tfluid.layers.mean(tfluid.layers.fc(x, 3))
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    tfluid.set_flags({"check_nan_inf": True})
    try:
        with pytest.raises(FloatingPointError, match="NaN/Inf") as err:
            exe.run(feed={"x": np.full((2, 4), np.nan, "float32")},
                    fetch_list=[loss])
        assert repr(loss.name) in str(err.value)
    finally:
        tfluid.set_flags({"check_nan_inf": False})


def test_finite_run_passes():
    x = tfluid.layers.data("x", [4])
    h = tfluid.layers.fc(x, 8, act="relu")
    loss = tfluid.layers.mean(tfluid.layers.fc(h, 3))
    tfluid.optimizer.SGD(0.1).minimize(loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tfluid.default_startup_program())
    tfluid.set_flags({"check_nan_inf": True})
    try:
        feed = {"x": np.random.RandomState(0).randn(2, 4).astype("float32")}
        out = exe.run(feed=feed, fetch_list=[loss])
        assert np.isfinite(out[0]).all()
    finally:
        tfluid.set_flags({"check_nan_inf": False})


def test_nan_in_updated_state_is_named():
    """A NaN that reaches only the state (not the fetch) is found in the
    updated state vars, named, and the slow path reads only on a trip."""
    from paddle_tpu_torch.core.executor import _check_finite

    vals = [("a", torch.ones(5)), ("b", torch.zeros(3, dtype=torch.bfloat16)),
            ("c", torch.tensor([1.0, float("inf"), 2.0]))]
    with pytest.raises(FloatingPointError, match="'c'"):
        _check_finite(vals)
    _check_finite(vals[:2] + [("ids", torch.arange(3))])


def test_env_aliases_bootstrap(monkeypatch):
    old = dict(flags_mod._FLAGS)
    monkeypatch.setenv("PDTPU_MAX_INFLIGHT_STEPS", "4")
    monkeypatch.setenv("PDTPU_COMPILE_CACHE_DIR", "/tmp/xyz")
    monkeypatch.setenv("FLAGS_check_nan_inf", "1")
    try:
        flags_mod._bootstrap_from_env()
        assert flags_mod.flag("max_inflight_steps") == 4
        assert flags_mod.flag("compile_cache_dir") == "/tmp/xyz"
        assert flags_mod.flag("check_nan_inf") is True
    finally:
        flags_mod._FLAGS.update(old)


def test_unknown_flag_and_bad_precision_raise():
    with pytest.raises(KeyError, match="no_such_flag"):
        tfluid.set_flags({"FLAGS_no_such_flag": 1})
    with pytest.raises(ValueError, match="matmul_precision"):
        tfluid.set_flags({"FLAGS_matmul_precision": "float16"})
    assert tfluid.get_flags("FLAGS_matmul_precision") == {
        "FLAGS_matmul_precision": "default"}


@pytest.mark.parametrize("value,tf32,matmul", [
    ("float32", True, "high"), ("bfloat16", True, "medium"),
    ("highest", False, "highest"), ("default", False, "highest")])
def test_matmul_precision_sets_the_tf32_switches(value, tf32, matmul):
    tfluid.set_flags({"FLAGS_matmul_precision": value})
    assert torch.backends.cuda.matmul.allow_tf32 is tf32
    assert torch.backends.cudnn.allow_tf32 is tf32
    assert torch.get_float32_matmul_precision() == matmul
    tfluid.set_flags({"FLAGS_matmul_precision": "default"})
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_cuda_device_leaves_the_tf32_switches_alone(monkeypatch):
    from paddle_tpu_torch.core.executor import cuda_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    tfluid.set_flags({"FLAGS_matmul_precision": "float32"})
    assert cuda_device(0) == torch.device("cuda", 0)
    assert torch.backends.cuda.matmul.allow_tf32 is True
    assert torch.backends.cudnn.allow_tf32 is True
    with pytest.raises(RuntimeError, match="CUDA device 1"):
        cuda_device(1)
