"""Shared helpers of the port's twin tests (tests/test_torch_*.py): build one
program in both packages, start both from the JAX package's initialized
scope, and step both on the same numpy feeds.

`build(fluid)` returns (main, startup, fetch_vars) and is called once per
package under a fresh unique-name guard, so both programs name their vars
alike; `feed(i)` gives step i's numpy feed dict.
"""
import numpy as np

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as jnames
from paddle_tpu_torch.core import unique_name as tnames
from paddle_tpu_torch.core.dtypes import dtype_str


def fresh_port_state():
    """A generator for an autouse fixture: fresh default programs, scope
    and unique names of the port for each test."""
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


def _state(main, read):
    out = {}
    for v in main.list_vars():
        if v.persistable:
            a = read(v.name)
            if a is not None:
                out[v.name] = a
    return out


def run_jax(build, feed, steps, seed=3, names=()):
    """(fetches of each step, initial state, final state, extra[name] of
    each step) of the JAX package."""
    with jnames.guard():
        main, startup, fetch = build(jfluid)
    main.random_seed = startup.random_seed = seed
    scope = jfluid.Scope()

    def read(n):
        v = scope.find_var(n)
        return None if v is None else np.array(v)

    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        init = _state(main, read)
        outs, extra = [], []
        for i in range(steps):
            outs.append([np.array(o) for o in exe.run(
                main, feed=feed(i), fetch_list=fetch)])
            extra.append({n: read(n) for n in names})
        final = _state(main, read)
    return outs, init, final, extra


def _port_ints(main, init):
    """`init` with integer state in the port's declared dtype (the JAX
    package keeps an int64 counter as int32; the port keeps int64)."""
    out = dict(init)
    for v in main.list_vars():
        if v.name in out and np.asarray(out[v.name]).dtype.kind in "iu":
            out[v.name] = np.asarray(out[v.name]).astype(dtype_str(v.dtype))
    return out


def run_port(build, feed, steps, init, names=(), exe=None):
    """The port's counterpart of `run_jax`, started from `init` (the JAX
    package's initialized scope)."""
    with tnames.guard():
        main, startup, fetch = build(tfluid)
    scope = tfluid.Scope()

    def read(n):
        return scope.find_np(n) if scope.has_var(n) else None

    with tfluid.scope_guard(scope):
        exe = exe or tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup)
        tfluid.io.load_params_from_numpy(_port_ints(main, init), scope=scope)
        outs, extra = [], []
        for i in range(steps):
            outs.append(exe.run(main, feed=feed(i), fetch_list=fetch))
            extra.append({n: read(n) for n in names})
        final = _state(main, read)
    return outs, final, extra


def run_both(build, feed, steps, seed=3, names=()):
    """JAX and port runs of `build` from the same initial state:
    ((jax fetches, port fetches), (jax final state, port final state),
    (jax extra, port extra))."""
    jouts, init, jfinal, jextra = run_jax(build, feed, steps, seed, names)
    touts, tfinal, textra = run_port(build, feed, steps, init, names)
    return (jouts, touts), (jfinal, tfinal), (jextra, textra)


def assert_states_close(jstate, tstate, rtol, atol=0.0, skip=()):
    """Every persistable of the JAX run within rtol/atol in the port's;
    integer state (counters: int32 in the JAX package, int64 in the port)
    equal."""
    assert sorted(jstate) == sorted(tstate)
    for n in jstate:
        if n in skip:
            continue
        j, t = np.asarray(jstate[n]), np.asarray(tstate[n])
        assert j.shape == t.shape, (n, j.shape, t.shape)
        if j.dtype.kind in "iub":
            np.testing.assert_array_equal(t, j, err_msg=n)
        else:
            np.testing.assert_allclose(t.astype(np.float64), j, rtol=rtol,
                                       atol=atol, err_msg=n)


def alarm_timeout(seconds: int):
    """A generator for an autouse fixture: a test that starts a thread or
    a process fails with TimeoutError after `seconds` instead of hanging
    the suite (SIGALRM in the main thread, where pytest runs tests; a
    blocked queue or join wakes up to it). Leaves every running loader
    closed."""
    import signal

    from paddle_tpu_torch.dataio import close_all_loaders

    def fire(signum, frame):
        raise TimeoutError(f"test exceeded its {seconds} s limit")

    old = signal.signal(signal.SIGALRM, fire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
        close_all_loaders()
