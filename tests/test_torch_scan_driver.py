"""The port's multi-step drivers (``Executor.run_batched`` /
``train_scanned`` / ``_run_scan``) on the CPU: twins of
``tests/test_scan_driver.py``.

Contract: driving an epoch as K-step drains — feeds staged through
``DeviceLoader.peek_many``'s device-resident ``[K, ...]`` buffer, the
steps run through the plain run's prepared plan over its views — is a
pure dispatch-strategy change: losses and final state are BITWISE equal
to K plain ``run`` calls, for dense optimizers (with dropout on) and for
the packed sparse-row path. Against the JAX package's ``run_batched`` the
port holds its executor-parity tolerance (rtol 1e-5, atol 1e-6, as the
port's small-program twins state). The deferred-row mode and its fold
epilogues come with ROADMAP A5: a program that carries epilogues is
refused."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as fluid
from _torch_twin import alarm_timeout, fresh_port_state
from paddle_tpu.core import unique_name as jnames
from paddle_tpu_torch.core import unique_name as tnames
from paddle_tpu_torch.dataio.loader import DeviceLoader
from paddle_tpu_torch.ops.kernels import sparse_adagrad as fsa

torch.set_num_threads(1)
CPU = fluid.CPUPlace()
V, D, B, F = 50, 4, 4, 3


@pytest.fixture(autouse=True)
def _fresh_port_state():
    yield from fresh_port_state()


@pytest.fixture(autouse=True)
def _time_limit():
    """train_scanned and peek_many run a loader thread."""
    yield from alarm_timeout(90)


def _dense_feeds(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"x": rng.randn(8, 4).astype("float32"),
             "y": rng.randn(8, 1).astype("float32")} for _ in range(n)]


def _build_dense(pkg, opt_name, dropout=0.25):
    layers = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = 5
    with pkg.program_guard(main, startup):
        x = layers.data("x", [4], dtype="float32")
        y = layers.data("y", [1], dtype="float32")
        h = layers.fc(x, size=8, act="relu")
        if dropout:
            h = layers.dropout(h, dropout,
                               dropout_implementation="upscale_in_train")
        p = layers.fc(h, size=1)
        loss = layers.reduce_mean(layers.square_error_cost(p, y))
        opt = (pkg.optimizer.SGD(0.1) if opt_name == "sgd"
               else pkg.optimizer.Adagrad(0.1))
        opt.minimize(loss)
    return main, startup, loss


def _build_packed(pkg=fluid):
    """Embedding + Adagrad on the packed-table path (row 12's op)."""
    layers = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        ids = layers.data("ids", [F], dtype="int64")
        emb = layers.embedding(
            ids, [V, 2 * D], is_sparse=True, row_pack=True,
            param_attr=pkg.ParamAttr(
                name="tb", initializer=pkg.initializer.RowPackInitializer(
                    D, 2 * D, -1.0, 1.0)))
        emb = layers.slice(emb, axes=[2], starts=[0], ends=[D])
        loss = layers.reduce_sum(layers.square(emb))
        pkg.optimizer.Adagrad(
            0.05, packed_rows={"rows_per_step": B * F}).minimize(loss)
    return main, startup, loss


def _build_deferred(pkg=fluid, segments=16):
    """Embedding + Adagrad on the deferred-row log (the fold epilogue
    every `segments` steps)."""
    layers = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        ids = layers.data("ids", [F], dtype="int64")
        emb = layers.embedding(ids, [V, 2 * D], is_sparse=True,
                               param_attr=pkg.ParamAttr(name="tb"))
        emb = layers.slice(emb, axes=[2], starts=[0], ends=[D])
        loss = layers.reduce_sum(layers.square(emb))
        pkg.optimizer.Adagrad(0.05, deferred_rows={
            "rows_per_step": B * F, "segments": segments}).minimize(loss)
    return main, startup, loss


def _sparse_feeds(n, seed=1):
    rng = np.random.RandomState(seed)
    return [{"ids": rng.randint(0, V, (B, F)).astype("int64")}
            for _ in range(n)]


def _final_state(prog, sc):
    return [sc.find_np(v.name)
            for v in sorted(prog.list_vars(), key=lambda v: v.name)
            if v.persistable and sc.find_var(v.name) is not None]


def _train(build, feeds, mode, scan_steps=None):
    """Warm with feeds[0] via a plain run, then drive feeds[1:] per step
    ("plain"), through train_scanned ("scanned") or run_batched
    ("batched"). Returns (losses, final persistable state)."""
    with tnames.guard():
        main, startup, loss = build()
    exe = fluid.Executor(CPU)
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        (lv,) = exe.run(main, feed=feeds[0], fetch_list=[loss])
        losses = [np.asarray(lv).ravel()]
        if mode == "scanned":
            out = exe.train_scanned(main, reader=lambda: iter(feeds[1:]),
                                    scan_steps=scan_steps,
                                    fetch_list=[loss])
            losses.append(out[0].ravel())
        elif mode == "batched":
            out = exe.run_batched(main, feeds[1:], fetch_list=[loss])
            losses.append(out[0].ravel())
        else:
            for f in feeds[1:]:
                (lv,) = exe.run(main, feed=f, fetch_list=[loss])
                losses.append(np.asarray(lv).ravel())
        return np.concatenate(losses), _final_state(main,
                                                    fluid.global_scope())


def _assert_bitwise(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    assert len(a[1]) == len(b[1])
    for x, y in zip(a[1], b[1]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("opt_name", ["sgd", "adagrad"])
def test_train_scanned_bitwise_dense(opt_name):
    """13 steps as 5+5+3 drains (an uneven tail) == 13 plain runs,
    bitwise, losses AND state, with dropout on (the generator walks the
    same stream)."""
    feeds = _dense_feeds(14)
    plain = _train(lambda: _build_dense(fluid, opt_name), feeds, "plain")
    _assert_bitwise(plain, _train(lambda: _build_dense(fluid, opt_name),
                                  feeds, "scanned", 5))
    _assert_bitwise(plain, _train(lambda: _build_dense(fluid, opt_name),
                                  feeds, "batched"))


@pytest.mark.parametrize("mode", ["deferred", "packed"])
def test_train_scanned_bitwise_sparse(mode):
    """The sparse-row paths scan bitwise too: the in-place packed Adagrad
    update (row 12's op) and the deferred-row log, whose 16-segment log
    fires no fold inside the 13-step window (a fold's timing depends on
    the drain grouping, see the cadence test below)."""
    build = _build_packed if mode == "packed" else _build_deferred
    feeds = _sparse_feeds(13)
    plain = _train(build, feeds, "plain")
    _assert_bitwise(plain, _train(build, feeds, "scanned", 4))
    _assert_bitwise(plain, _train(build, feeds, "batched"))


def test_train_scanned_rejects_scan_over_fold_cadence():
    """A drain longer than the fold interval would overflow the log
    mid-drain: refused with the JAX package's ValueError."""
    feeds = _sparse_feeds(13)
    with pytest.raises(ValueError, match="epilogue interval"):
        _train(lambda: _build_deferred(segments=4), feeds, "scanned", 5)


@pytest.mark.parametrize("opt_name", ["sgd", "adagrad"])
def test_run_batched_matches_the_jax_package(opt_name):
    """The port's run_batched against the JAX package's, from the JAX
    package's initialized scope, dropout 0: within the executor parity
    tolerance."""
    feeds = _dense_feeds(6, seed=3)
    with jnames.guard():
        jmain, jstartup, jloss = _build_dense(jfluid, opt_name, dropout=0)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jsc = jfluid.Scope()
    with jfluid.scope_guard(jsc):
        jexe.run(jstartup)
        init = {v.name: np.array(jsc.find_var(v.name))
                for v in jmain.list_vars()
                if v.persistable and jsc.find_var(v.name) is not None}
        (jl,) = jexe.run_batched(jmain, feeds, fetch_list=[jloss])
        jfinal = {n: np.array(jsc.find_var(n)) for n in init}
    with tnames.guard():
        tmain, tstartup, tloss = _build_dense(fluid, opt_name, dropout=0)
    texe = fluid.Executor(CPU)
    tsc = fluid.Scope()
    with fluid.scope_guard(tsc):
        texe.run(tstartup)
        fluid.io.load_params_from_numpy(init, scope=tsc)
        (tl,) = texe.run_batched(tmain, feeds, fetch_list=[tloss])
        tfinal = {n: tsc.find_np(n) for n in init}
    assert tl.shape == np.asarray(jl).shape
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-5, atol=1e-6)
    for n in init:
        np.testing.assert_allclose(tfinal[n], jfinal[n], rtol=1e-5,
                                   atol=1e-6, err_msg=n)


def test_run_batched_packed_matches_the_jax_package():
    """The packed sparse-row path through both packages' run_batched from
    the JAX package's initialized table (its Pallas kernel under the
    interpreter): losses and the table's f32 payload within the parity
    tolerance."""
    from paddle_tpu.ops.pallas_kernels import sparse_adagrad as jfsa

    feeds = _sparse_feeds(6, seed=5)
    old = jfsa.FORCE_PALLAS_INTERPRET
    jfsa.FORCE_PALLAS_INTERPRET = True
    try:
        with jnames.guard():
            jmain, jstartup, jloss = _build_packed(jfluid)
        jexe = jfluid.Executor(jfluid.CPUPlace())
        jsc = jfluid.Scope()
        with jfluid.scope_guard(jsc):
            jexe.run(jstartup)
            init = np.array(jsc.find_var("tb"))
            (jl,) = jexe.run_batched(jmain, feeds, fetch_list=[jloss])
            jtb = np.array(jsc.find_var("tb"))
    finally:
        jfsa.FORCE_PALLAS_INTERPRET = old
    with tnames.guard():
        tmain, tstartup, tloss = _build_packed()
    texe = fluid.Executor(CPU)
    tsc = fluid.Scope()
    with fluid.scope_guard(tsc):
        texe.run(tstartup)
        fluid.io.load_params_from_numpy({"tb": init}, scope=tsc)
        (tl,) = texe.run_batched(tmain, feeds, fetch_list=[tloss])
        ttb = tsc.find_var("tb")
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-5, atol=1e-6)

    def payload(u16):
        t = torch.from_numpy(np.ascontiguousarray(u16).view(np.int16))
        return fsa.unpack_rows(t.view(torch.uint16), 2 * D).numpy()

    np.testing.assert_allclose(payload(ttb.view(torch.int16).numpy()),
                               payload(jtb), rtol=1e-5, atol=1e-6)


def test_train_scanned_rejects_programs_with_epilogues():
    """A drain longer than a program's maintenance-epilogue interval is
    refused with the JAX package's ValueError (one within it runs); so are
    scan_steps < 1, a missing reader and missing state."""
    feeds = _dense_feeds(4)
    main, startup, loss = _build_dense(fluid, "sgd")
    exe = fluid.Executor(CPU)
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        main._epilogue_programs = [(3, fluid.Program(), None)]
        with pytest.raises(ValueError, match="epilogue interval 3"):
            exe.run_batched(main, feeds, fetch_list=[loss])
        (ys,) = exe.run_batched(main, feeds[:3], fetch_list=[loss])
        assert ys.shape[0] == 3
        del main._epilogue_programs
        with pytest.raises(ValueError, match="scan_steps"):
            exe.train_scanned(main, reader=lambda: iter(feeds),
                              scan_steps=0)
        with pytest.raises(ValueError, match="reader"):
            exe.train_scanned(main, scan_steps=2)
    with fluid.scope_guard(fluid.Scope()):
        with pytest.raises(ValueError, match="every persistable"):
            exe.run_batched(main, feeds, fetch_list=[loss])


def test_train_scanned_donation_across_scan():
    """Steady-state drains warn nothing, and the state the scope holds
    after them is the last step's, carried on the device between drains
    without a host copy."""
    feeds = _dense_feeds(18)
    main, startup, loss = _build_dense(fluid, "sgd")
    exe = fluid.Executor(CPU)
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        exe.run(main, feed=feeds[0], fetch_list=[loss])
        exe.train_scanned(main, reader=lambda: iter(feeds[1:9]),
                          scan_steps=4, fetch_list=[loss])
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            exe.train_scanned(main, reader=lambda: iter(feeds[9:17]),
                              scan_steps=4, fetch_list=[loss])
        assert not caught, [str(w.message) for w in caught]
        for v in main.list_vars():
            if v.persistable:
                assert isinstance(fluid.global_scope().find_var(v.name),
                                  torch.Tensor)


def test_train_scanned_no_fetch_returns_step_count():
    feeds = _dense_feeds(10)
    main, startup, loss = _build_dense(fluid, "sgd")
    exe = fluid.Executor(CPU)
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        exe.run(main, feed=feeds[0])
        assert exe.train_scanned(main, reader=lambda: iter(feeds[1:]),
                                 scan_steps=4) == 9


def test_drain_records_one_step_record_a_drain():
    from paddle_tpu_torch.observability.steps import get_step_profiler

    feeds = _dense_feeds(9)
    main, startup, loss = _build_dense(fluid, "sgd")
    exe = fluid.Executor(CPU)
    prof = get_step_profiler()
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        exe.run(main, feed=feeds[0])
        # the records the drains add, by identity: the profiler keeps a
        # rolling window, which earlier tests in the process may have
        # filled (then its length no longer grows)
        before = prof.records()
        seen = {id(r) for r in before}
        exe.train_scanned(main, reader=lambda: iter(feeds[1:]),
                          scan_steps=4, fetch_list=[loss])
        recs = [r for r in prof.records() if id(r) not in seen]
    assert [r.get("steps_in_dispatch", 1) for r in recs] == [4, 4]


def test_run_batched_rejects_key_drift():
    feeds = _dense_feeds(3)
    feeds[2] = {"x": feeds[2]["x"], "z": feeds[2]["y"]}
    main, startup, loss = _build_dense(fluid, "sgd")
    exe = fluid.Executor(CPU)
    with fluid.scope_guard(fluid.Scope()):
        exe.run(startup)
        with pytest.raises(ValueError,
                           match=r"step 2 .*extra keys \['z'\].*missing "
                                 r"keys \['y'\]"):
            exe.run_batched(main, feeds, fetch_list=[loss])
        with pytest.raises(ValueError, match="empty"):
            exe.run_batched(main, [], fetch_list=[loss])


# -- DeviceLoader.peek_many -------------------------------------------------

def test_peek_many_stacks_and_tail():
    feeds = _dense_feeds(7)
    loader = DeviceLoader(lambda: iter(feeds), capacity=3, place=CPU)
    loader.start()
    try:
        stacked, m = loader.peek_many(3)
        assert m == 3 and tuple(stacked["x"].shape) == (3, 8, 4)
        np.testing.assert_array_equal(
            stacked["y"].numpy(), np.stack([f["y"] for f in feeds[:3]]))
        _, m2 = loader.peek_many(3)
        assert m2 == 3
        tail, m3 = loader.peek_many(3)
        assert m3 == 1 and tuple(tail["x"].shape) == (1, 8, 4)
        assert loader.peek_many(3) == ({}, 0)
        assert not loader.running
    finally:
        loader.close()


def test_peek_many_reraises_worker_error():
    def bad_reader():
        yield {"x": np.ones((2, 2), np.float32)}
        raise RuntimeError("reader exploded")

    loader = DeviceLoader(bad_reader, capacity=2, place=CPU)
    loader.start()
    try:
        with pytest.raises(RuntimeError, match="reader exploded"):
            loader.peek_many(4)
        assert not loader.running
    finally:
        loader.close()


def test_peek_many_after_close_returns_empty():
    loader = DeviceLoader(lambda: iter(_dense_feeds(3)), capacity=2,
                          place=CPU)
    loader.start()
    loader.close()
    assert loader.peek_many(2) == ({}, 0)


def test_peek_many_rejects_key_drift():
    batches = [{"x": np.ones((2,), np.float32)},
               {"z": np.ones((2,), np.float32)}]
    loader = DeviceLoader(lambda: iter(batches), capacity=2, place=CPU)
    loader.start()
    try:
        with pytest.raises(ValueError, match="key set"):
            loader.peek_many(2)
    finally:
        loader.close()


def test_jax_and_port_peek_many_agree():
    """Both packages' peek_many stack the same batches into the same
    ``[m, ...]`` buffer."""
    from paddle_tpu.dataio.loader import DeviceLoader as JLoader

    feeds = _dense_feeds(5, seed=9)
    jl = JLoader(lambda: iter(feeds), capacity=3)
    tl = DeviceLoader(lambda: iter(feeds), capacity=3, place=CPU)
    jl.start()
    tl.start()
    try:
        for k in (2, 3):
            js, jm = jl.peek_many(k)
            ts, tm = tl.peek_many(k)
            assert jm == tm
            for n in js:
                np.testing.assert_array_equal(ts[n].numpy(),
                                              np.asarray(jnp.asarray(js[n])))
    finally:
        jl.close()
        tl.close()
