"""The port executor's telemetry and its prepared-plan cache: twins of
tests/test_observability.py's test_executor_cache_and_compile_metrics,
test_watchdog_silent_on_steady_shapes and
test_executor_run_feeds_step_profiler, plus the plan's invalidation on a
program edit (`_bump_version`) and on a change of the scope's key set.

A plan-cache miss is the port's "compile": the executor prepares the step
(sorted state, read set, autodiff targets, remat regions, fusion
schedule) and counts it in executor/cache_misses and
executor/compile_ms{sig=}; a hit replays it and counts
executor/cache_hits and executor/execute_ms, as the JAX package counts its
jit cache."""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.core import unique_name as tnames
from paddle_tpu_torch.observability import get_registry
from paddle_tpu_torch.observability import flight, watchdog
from paddle_tpu_torch.observability.steps import get_step_profiler
from paddle_tpu_torch.observability.tracer import get_tracer

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
    tracer = get_tracer()
    tracer.clear()
    tracer.enabled = True
    with tnames.guard():
        yield
    tracer.enabled = False
    tracer.clear()
    (prog_mod._main_program, prog_mod._startup_program,
     scope_mod._global_scope, scope_mod._current_scope) = old


def _tiny_program():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", [3])
        y = tfluid.layers.fc(x, 2)
    return main, startup, y


def test_executor_cache_and_compile_metrics():
    reg = get_registry()
    hits0 = reg.counter("executor/cache_hits").value
    miss0 = reg.counter("executor/cache_misses").value
    exec0 = reg.histogram("executor/execute_ms").count

    main, startup, y = _tiny_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    feed = {"x": np.zeros((2, 3), np.float32)}
    exe.run(main, feed=feed, fetch_list=[y])   # prepare
    exe.run(main, feed=feed, fetch_list=[y])   # hit
    exe.run(main, feed=feed, fetch_list=[y])   # hit

    assert reg.counter("executor/cache_misses").value - miss0 == 2
    assert reg.counter("executor/cache_hits").value - hits0 == 2
    assert reg.histogram("executor/execute_ms").count - exec0 == 2
    snap = reg.snapshot()
    compile_keys = [k for k in snap if k.startswith("executor/compile_ms")]
    assert compile_keys, "per-signature prepare histograms missing"
    names = [e["name"] for e in get_tracer().export_chrome_trace()[
        "traceEvents"] if e.get("ph") in ("B", "E")]
    assert "executor/compile+run" in names and "executor/run" in names


def test_watchdog_silent_on_steady_shapes():
    wd = watchdog.get_watchdog()
    old_threshold = wd.threshold
    wd.threshold = 1  # as twitchy as possible: any re-prepare would warn
    try:
        main, startup, y = _tiny_program()
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        reg = get_registry()
        hits0 = reg.counter("executor/cache_hits").value
        feed = {"x": np.zeros((4, 3), np.float32)}
        with warnings.catch_warnings():
            warnings.simplefilter("error", watchdog.RecompileWarning)
            for _ in range(6):  # steady shape: one prepare, then hits
                exe.run(main, feed=feed, fetch_list=[y])
        assert reg.counter("executor/cache_hits").value - hits0 == 5
    finally:
        wd.threshold = old_threshold


def test_watchdog_names_a_drifting_feed():
    wd = watchdog.get_watchdog()
    old_threshold = wd.threshold
    wd.threshold = 3
    try:
        main, startup, y = _tiny_program()
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        with pytest.warns(watchdog.RecompileWarning) as rec:
            for n in range(1, 7):  # a new batch size every step
                exe.run(main, feed={"x": np.zeros((n, 3), np.float32)},
                        fetch_list=[y])
        msgs = [str(w.message) for w in rec
                if issubclass(w.category, watchdog.RecompileWarning)]
        assert len(msgs) == 1 and "'x'" in msgs[0]
        assert "recompiled 4 times" in msgs[0]
    finally:
        wd.threshold = old_threshold


def test_executor_run_feeds_step_profiler():
    prof = get_step_profiler()
    step0 = prof.step
    main, startup, y = _tiny_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    feed = {"x": np.zeros((2, 3), np.float32)}
    exe.run(main, feed=feed, fetch_list=[y])
    exe.run(main, feed=feed, fetch_list=[y])
    recs = prof.records()
    assert prof.step >= step0 + 3   # startup + prepare + hit
    new = [r for r in recs if r["step"] > step0]
    assert any(r["compile"] for r in new)
    assert any(not r["compile"] for r in new)
    assert all("wall_ms" in r and "sig" in r for r in new)
    assert flight.get_flight_recorder().contents()["steps"][-1] == new[-1]


def _plans(exe, main):
    return [p for k, p in exe._cache.items() if k[0] == id(main)]


def test_plan_invalidated_by_a_program_edit():
    main, startup, y = _tiny_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    feed = {"x": np.ones((2, 3), np.float32)}
    a = exe.run(main, feed=feed, fetch_list=[y])[0]
    with tfluid.program_guard(main, startup):
        z = tfluid.layers.scale(y, scale=2.0)   # appending bumps _version
    b, c = exe.run(main, feed=feed, fetch_list=[y, z])
    assert len(_plans(exe, main)) == 2
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(c, 2 * a)
    main._bump_version()
    exe.run(main, feed=feed, fetch_list=[y, z])
    assert len(_plans(exe, main)) == 3


def test_plan_invalidated_by_a_scope_key_set_change():
    """The state names are part of the plan key, recomputed only when a
    scope in the lookup chain gains or loses a name; a value replaced in
    place keeps the plan."""
    main, startup, y = _tiny_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    feed = {"x": np.ones((2, 3), np.float32)}
    with tfluid.scope_guard(scope):
        exe.run(startup)
        exe.run(main, feed=feed, fetch_list=[y])
        w = [p.name for p in main.all_parameters()][0]
        gen = scope._keyset_gen
        scope.set_var(w, scope.find_var(w) * 0)  # a value, not a key
        assert scope._keyset_gen == gen
        exe.run(main, feed=feed, fetch_list=[y])
        assert len(_plans(exe, main)) == 1
        child = tfluid.Scope(parent=scope)
        bias = [p.name for p in main.all_parameters()][1]
        scope.erase(bias)
        assert scope._keyset_gen == gen + 1
        with pytest.raises(KeyError):
            exe.run(main, feed=feed, fetch_list=[y], scope=child)
        assert len(_plans(exe, main)) == 2
        scope.set_var(bias, torch.zeros(2))
        out = exe.run(main, feed=feed, fetch_list=[y], scope=child)[0]
        np.testing.assert_array_equal(out, np.zeros((2, 2), np.float32))
        assert len(_plans(exe, main)) == 2  # the first plan's key again


def test_trace_span_decorates_and_instant_marks():
    from paddle_tpu_torch.observability.tracer import trace_span

    @trace_span("obs/decorated", tag=3)
    def f(x):
        return x + 1

    assert f(1) == 2 and f.__name__ == "f"
    get_tracer().instant("obs/mark", {"k": 1})
    evs = [e for e in get_tracer().export_chrome_trace()["traceEvents"]
           if e["name"] in ("obs/decorated", "obs/mark")]
    assert [e["ph"] for e in evs] == ["B", "E", "i"]
    assert evs[0]["args"] == {"tag": 3}


def test_flight_guard_dumps_on_an_oom_in_run_and_reraises(monkeypatch,
                                                           tmp_path):
    """An out-of-memory error inside Executor.run leaves a post-mortem
    (step records, registry snapshot, the executor's resident plan keys)
    and propagates unchanged."""
    from paddle_tpu_torch.core import executor as texec

    monkeypatch.setenv("PDTPU_FLIGHT_DIR", str(tmp_path))
    rec = flight.get_flight_recorder()
    rec.reset()
    main, startup, y = _tiny_program()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    feed = {"x": np.zeros((2, 3), np.float32)}
    exe.run(main, feed=feed, fetch_list=[y])
    boom = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate")

    def oom(*a, **k):
        raise boom

    monkeypatch.setattr(texec, "_run_block", oom)
    with pytest.raises(torch.OutOfMemoryError) as err:
        exe.run(main, feed=feed, fetch_list=[y])
    assert err.value is boom
    dump = rec.last_dump
    assert dump["exception"]["type"] == "OutOfMemoryError"
    assert dump["context"]["where"] == "Executor.run"
    assert dump["steps"] and "executor/cache_hits" in dump["registry"]
    assert any(k["program"] == f"0x{id(main):x}"
               for k in dump["sections"]["compiled_signatures"])
    assert rec.last_dump_path and rec.last_dump_path.startswith(str(tmp_path))
    assert not flight.is_oom(ValueError("shape mismatch"))
