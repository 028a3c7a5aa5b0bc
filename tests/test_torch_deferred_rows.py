"""The port's deferred-row log (``ops/deferred_rows.py``: ``lookup_join``,
the ``*_row_deferred`` ops, ``deferred_fold``; the optimizers'
``deferred_rows=``; the executor's maintenance epilogues) against its own
dense path and against the JAX package, on the CPU.

Twins of the deferred tests of ``tests/test_sparse_row_updates.py`` and of
``tests/test_sparse_embedding.py::test_sparse_embedding_million_vocab_step``,
plus a JAX scope taken mid-window that resumes in the port, and the
epilogue counter's purge.

Tolerances. In f64 the deferred path equals the dense path to 1e-9
(relative; the fold is a pure representation change). In f32 the port's
deferred path is held to the JAX package's within rtol 1e-5: both fold
base + Σraw against the accumulated cum, and the port sums an id's logged
deltas in log order before one add where the JAX package adds them one by
one (observed ~2e-7). Inside the port, a restored scope resumes bitwise.
"""
import gc

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as jnames
from paddle_tpu.models import deepfm as jdeepfm
from paddle_tpu.ops import deferred_rows as jdr
from paddle_tpu_torch.core import unique_name as tnames
from paddle_tpu_torch.models import deepfm as tdeepfm
from paddle_tpu_torch.ops import deferred_rows as tdr

from _torch_twin import fresh_port_state, run_both

torch.set_num_threads(1)

V, D, B, F = 50, 4, 4, 3
MULT = {"sgd": 1, "adagrad": 2, "adam": 3}
CPU = tfluid.CPUPlace()


@pytest.fixture(autouse=True)
def _fresh_port_state():
    yield from fresh_port_state()


def _feeds(n, vocab=V, batch=B, rng_seed=1):
    rng = np.random.RandomState(rng_seed)
    return [{"ids": rng.randint(0, vocab, (batch, F)).astype("int64")}
            for _ in range(n)]


def _build(pkg, opt_name, mode, dtype="float32", segments=3, lr=0.1,
           vocab=V, batch=B):
    """An embedding whose rows are squared and summed, on `opt_name`, in
    mode "dense" (is_sparse, the plain update) or "deferred"."""
    mult = MULT[opt_name] if mode == "deferred" else 1
    layers = pkg.layers
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        ids = layers.data("ids", [F], dtype="int64")
        emb = layers.embedding(
            ids, [vocab, D * mult], is_sparse=True, dtype=dtype,
            param_attr=pkg.ParamAttr(
                name="tb",
                initializer=pkg.initializer.UniformInitializer(-1.0, 1.0)))
        if mult > 1:
            emb = layers.slice(emb, axes=[2], starts=[0], ends=[D])
        loss = layers.reduce_sum(layers.square(emb))
        kw = {}
        if mode == "deferred":
            kw["deferred_rows"] = {"rows_per_step": batch * F,
                                   "segments": segments}
        opt = {"sgd": pkg.optimizer.SGD, "adagrad": pkg.optimizer.Adagrad,
               "adam": pkg.optimizer.Adam}[opt_name](lr, **kw)
        opt.minimize(loss)
    return main, startup, loss


def _visible_init(w, dtype, vocab=V):
    """The same visible columns in every mode and width (state columns
    keep what the startup program wrote)."""
    w = np.array(w, copy=True)
    w[:, :D] = np.random.RandomState(7).uniform(-1, 1, (vocab, D)).astype(
        dtype)
    return w


def _train_port(opt_name, mode, feeds, dtype="float32", segments=3,
                exe=None, prog=lambda m: m):
    with tnames.guard():
        main, startup, loss = _build(tfluid, opt_name, mode, dtype,
                                     segments)
    exe = exe or tfluid.Executor(CPU)
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    tfluid.io.load_params_from_numpy(
        {"tb": _visible_init(scope.find_np("tb"), dtype)}, scope=scope)
    losses = [float(exe.run(prog(main), feed=f, fetch_list=[loss],
                            scope=scope)[0]) for f in feeds]
    return np.array(losses), scope


def _train_jax(opt_name, feeds, segments=3):
    import jax.numpy as jnp

    with jnames.guard():
        main, startup, loss = _build(jfluid, opt_name, "deferred",
                                     segments=segments)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        scope.set_var("tb", jnp.asarray(
            _visible_init(scope.find_var("tb"), "float32")))
        losses = [float(np.asarray(exe.run(main, feed=f,
                                           fetch_list=[loss])[0]))
                  for f in feeds]
    return np.array(losses), scope


@pytest.mark.parametrize("opt_name", ["sgd", "adagrad", "adam"])
def test_deferred_exact_vs_dense_f64(opt_name):
    """20 steps with a fold every 3 (duplicates included): the port's
    deferred path equals its dense path to 1e-9 in f64, and its f32
    deferred path equals the JAX package's within rtol 1e-5."""
    feeds = _feeds(20)
    ref, _ = _train_port(opt_name, "dense", feeds, "float64")
    dfr, scope = _train_port(opt_name, "deferred", feeds, "float64")
    rel = np.abs((ref - dfr) / np.maximum(np.abs(ref), 1e-12)).max()
    assert rel < 1e-9, (opt_name, rel)
    # 20 steps, folds after steps 3, 6, ..., 18: two steps pending
    assert int(scope.find_np("tb@log_count")[0]) == 2 * B * F
    t32, tscope = _train_port(opt_name, "deferred", feeds)
    j32, jscope = _train_jax(opt_name, feeds)
    np.testing.assert_allclose(t32, j32, rtol=1e-5)
    for name in ("tb@pending_pos", "tb@log_ids", "tb@log_count"):
        got, want = tscope.find_np(name), np.asarray(jscope.find_var(name))
        assert got.dtype == want.dtype == np.int32, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in ("tb", "tb@log_raw", "tb@log_cum"):
        got, want = tscope.find_np(name), np.asarray(jscope.find_var(name))
        assert got.shape == want.shape and got.dtype == want.dtype, name
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_deferred_checkpoint_mid_window():
    """The pending state is ordinary persistables: a scope snapshot taken
    mid-window (step 5 of a 4-step fold cadence) restored into a fresh
    scope resumes bitwise — the counter reseeds itself from the restored
    count."""
    feeds = _feeds(9)
    with tnames.guard():
        main, startup, loss = _build(tfluid, "adagrad", "deferred",
                                     segments=4, lr=0.05)
    exe = tfluid.Executor(CPU)
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    run1, snap = [], {}
    for i, f in enumerate(feeds):
        run1.append(exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0])
        if i == 4:
            snap = {n: scope.find_np(n) for n in scope.var_names()
                    if n != "@RNG_STATE@"}
    assert int(snap["tb@log_count"][0]) == B * F  # one step pending
    fresh = tfluid.Scope()
    tfluid.io.load_params_from_numpy(snap, scope=fresh)
    out = [exe.run(main, feed=f, fetch_list=[loss], scope=fresh)[0]
           for f in feeds[5:]]
    np.testing.assert_array_equal(np.array(out), np.array(run1[5:]))
    for n in snap:
        np.testing.assert_array_equal(fresh.find_np(n), scope.find_np(n),
                                      err_msg=n)


def _deepfm_feeds(n, vocab=1000, batch=8):
    rng = np.random.RandomState(0)
    return [{"sparse_ids": rng.randint(0, vocab, (batch, 26)).astype("int64"),
             "dense": rng.rand(batch, 13).astype("float32"),
             "label": rng.randint(0, 2, (batch, 1)).astype("float32")}
            for _ in range(n)]


def _build_deepfm(pkg):
    deepfm = jdeepfm if pkg is jfluid else tdeepfm
    main, startup, _, loss, _ = deepfm.build_train_program(
        vocab_size=1000, lr=0.01, is_sparse=True,
        embedding_optimizer="adagrad", fused_table=True,
        deferred_rows={"rows_per_step": 8 * 26, "segments": 4})
    return main, startup, [loss]


def test_run_batched_matches_per_step():
    """run_batched (drains of 4 over a 4-step cadence, so each drain
    pre-folds) matches plain runs within rtol 1e-5, and both match the
    JAX package's plain run from its initialized scope."""
    feeds = _deepfm_feeds(13)
    (jouts, touts), _, _ = run_both(_build_deepfm, lambda i: feeds[i], 13)
    plain = np.array([float(o[0]) for o in touts])
    np.testing.assert_allclose(plain, [float(o[0]) for o in jouts],
                               rtol=1e-5, atol=1e-7)
    with jnames.guard():
        jmain, jstartup, _ = _build_deepfm(jfluid)
    jmain.random_seed = jstartup.random_seed = 3
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(jstartup)
    init = {v.name: np.array(jscope.find_var(v.name))
            for v in jmain.list_vars()
            if v.persistable and jscope.find_var(v.name) is not None}
    with tnames.guard():
        main, startup, (loss,) = _build_deepfm(tfluid)
    exe = tfluid.Executor(CPU)
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    tfluid.io.load_params_from_numpy(init, scope=scope)
    batched = [float(exe.run(main, feed=feeds[0], fetch_list=[loss],
                             scope=scope)[0])]
    for i in (1, 5, 9):
        (ys,) = exe.run_batched(main, feeds[i:i + 4], fetch_list=[loss],
                                scope=scope)
        batched.extend(np.asarray(ys).ravel().tolist())
    np.testing.assert_allclose(batched, plain, rtol=1e-5, atol=1e-7)


def test_deferred_rejects_bad_configs():
    with pytest.raises(ValueError, match="rows_per_step"):
        tfluid.optimizer.SGD(0.1, deferred_rows={"segments": 4})
    with pytest.raises(ValueError, match="is_sparse"):
        tdeepfm.build_train_program(vocab_size=100, is_sparse=False,
                                    embedding_optimizer="adagrad",
                                    deferred_rows={"rows_per_step": 10})
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", [4])
        loss = tfluid.layers.mean(tfluid.layers.fc(x, 1))
        with pytest.raises(ValueError, match="no parameter has an is_sparse"):
            tfluid.optimizer.SGD(0.1, deferred_rows={
                "rows_per_step": 4}).minimize(loss)


def test_deferred_fold_fires_under_compiled_program():
    """The fold epilogue fires on the one-device CompiledProgram path too:
    losses equal the plain run's across fold boundaries, and after 9 steps
    at a 3-step cadence the log's count is back to 0."""
    bb = 8
    rng = np.random.RandomState(1)
    feeds = [{"ids": rng.randint(0, V, (bb, F)).astype("int64")}
             for _ in range(9)]

    def run(compiled):
        with tnames.guard():
            main, startup, loss = _build(tfluid, "adagrad", "deferred",
                                         segments=3, lr=0.05, batch=bb)
        exe = tfluid.Executor(CPU)
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        prog = (tfluid.CompiledProgram(main).with_data_parallel()
                if compiled else main)
        out = [float(exe.run(prog, feed=f, fetch_list=[loss],
                             scope=scope)[0]) for f in feeds]
        assert int(scope.find_np("tb@log_count")[0]) == 0, "no fold"
        return np.array(out), scope.find_np("tb")

    (pl, pt), (cl, ct) = run(False), run(True)
    np.testing.assert_array_equal(pl, cl)
    np.testing.assert_array_equal(pt, ct)


def test_row_pack_table_rejects_deferred_rows():
    """deferred_rows= on a row_pack table fails at minimize() with the
    JAX package's ValueError."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        ids = tfluid.layers.data("ids", [F], dtype="int64")
        emb = tfluid.layers.embedding(
            ids, [V, D], is_sparse=True, row_pack=True,
            param_attr=tfluid.ParamAttr(
                name="tb", initializer=tfluid.initializer.RowPackInitializer(
                    D, D, -1.0, 1.0)))
        loss = tfluid.layers.reduce_sum(tfluid.layers.square(emb))
        opt = tfluid.optimizer.SGD(0.1,
                                   deferred_rows={"rows_per_step": B * F})
        with pytest.raises(ValueError, match=r"row_pack=True.*packed_rows"):
            opt.minimize(loss)


def test_lookup_join_hits_misses_and_projection():
    """Misses (postab == -1) pass the base rows through with zero cum;
    hits add the logged cum row; a lane-padded log (Lw > Dt) narrows
    exactly — bitwise the JAX package's join (its 0/1 projection dot)."""
    import jax.numpy as jnp

    rng = np.random.RandomState(4)
    vocab, c = 10, 3
    for lw in (D, 128):
        postab = np.full((vocab,), -1, np.int32)
        postab[2], postab[7] = 0, 2
        log = np.zeros((c, lw), np.float32)
        log[:, :D] = rng.randn(c, D)
        q = np.array([2, 5, 7, 2], np.int32)
        base = rng.randn(q.size, D).astype("f4")
        cur, cum = tdr.lookup_join(torch.from_numpy(postab),
                                   torch.from_numpy(log),
                                   torch.from_numpy(base),
                                   torch.from_numpy(q))
        want_cum = np.stack([log[0, :D], np.zeros(D, "f4"),
                             log[2, :D], log[0, :D]])
        np.testing.assert_array_equal(cum.numpy(), want_cum)
        np.testing.assert_allclose(cur.numpy(), base + want_cum, rtol=1e-6)
        jcur, jcum = jdr.lookup_join(jnp.asarray(postab), jnp.asarray(log),
                                     jnp.asarray(base), jnp.asarray(q))
        np.testing.assert_array_equal(cum.numpy(), np.asarray(jcum))
        np.testing.assert_array_equal(cur.numpy(), np.asarray(jcur))


def test_fold_sums_shadowed_entries_once_per_id():
    """An id logged three times (two entries shadowed): the fold adds the
    three raw deltas, in log order, to its row once; pads and stale
    SENTINEL rows add nothing; postab and the log are cleared; two folds
    of one state give the same bits."""
    rng = np.random.RandomState(5)
    p = rng.randn(6, D).astype("f4")
    ids = np.array([3, 1, 3, 2**31 - 1, 3, 5, 2**31 - 1, 2**31 - 1],
                   np.int32)
    raw = rng.randn(ids.size, 128).astype("f4")
    inputs = {"Param": [torch.from_numpy(p.copy())],
              "LogIds": [torch.from_numpy(ids.copy())],
              "LogRaw": [torch.from_numpy(raw)],
              "LogCum": [torch.zeros(ids.size, 128)],
              "PendingPos": [torch.zeros(6, dtype=torch.int32)],
              "Count": [torch.tensor([6], dtype=torch.int32)]}
    fold = tfluid.core.registry.get_op("deferred_fold").fn
    out = fold(None, inputs, {})
    want = p.copy()
    want[3] += (raw[0, :D] + raw[2, :D]) + raw[4, :D]
    want[1] += raw[1, :D]
    want[5] += raw[5, :D]
    np.testing.assert_array_equal(out["ParamOut"][0].numpy(), want)
    assert (out["PendingPosOut"][0].numpy() == -1).all()
    assert (out["LogIdsOut"][0].numpy() == 2**31 - 1).all()
    assert int(out["CountOut"][0][0]) == 0


def test_sparse_embedding_million_vocab_step():
    """DeepFM scale: a 1M-row table, two Adam steps through SelectedRows
    (O(batch·dim) gradient work), from the JAX package's initialized
    scope: losses within rtol 1e-6 of the JAX package's, the duplicated
    ids' rows moved, their neighbours untouched."""
    feeds = {"ids": np.array([[5, 99_999, 5, 123], [7, 7, 999_999, 0]],
                             dtype="int64"),
             "y": np.array([[1.0], [0.0]], dtype="float32")}

    def build(pkg):
        layers = pkg.layers
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            ids = layers.data("ids", [4], dtype="int64")
            y = layers.data("y", [1], dtype="float32")
            emb = layers.embedding(
                ids, [1_000_000, 16], is_sparse=True,
                param_attr=pkg.ParamAttr(
                    name="big_table",
                    initializer=pkg.initializer.ConstantInitializer(0.01)))
            pred = layers.fc(layers.reduce_sum(emb, dim=1), 1)
            loss = layers.reduce_mean(layers.square_error_cost(pred, y))
            pkg.optimizer.Adam(0.001).minimize(loss)
        return main, startup, [loss]

    (jouts, touts), (jfinal, tfinal), _ = run_both(build, lambda i: feeds, 2)
    tl = [float(o[0]) for o in touts]
    np.testing.assert_allclose(tl, [float(o[0]) for o in jouts], rtol=1e-6)
    assert np.isfinite(tl).all() and tl[1] != tl[0]
    table = tfinal["big_table"]
    assert np.abs(table[5] - np.float32(0.01)).min() > 1e-6
    assert (table[6] == np.float32(0.01)).all()
    np.testing.assert_allclose(table[[0, 5, 7, 123, 99_999, 999_999]],
                               jfinal["big_table"][[0, 5, 7, 123, 99_999,
                                                    999_999]], rtol=1e-5)


def test_jax_scope_mid_window_resumes_in_port():
    """A JAX run's scope taken mid-window (after step 6 of a 4-step fold
    cadence: two steps pending in the log) loads into the port unchanged
    (widened table, postab, both logs, count: same names, shapes and
    dtypes), and the port's next steps match the JAX run's (rtol 1e-5)
    and keep its fold cadence: the count after each step equals the JAX
    run's."""
    import jax.numpy as jnp

    feeds = _feeds(11, rng_seed=3)
    with jnames.guard():
        jmain, jstartup, jloss = _build(jfluid, "adam", "deferred",
                                        segments=4, lr=0.05)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    jlosses, jcounts, snap = [], [], None
    with jfluid.scope_guard(jscope):
        jexe.run(jstartup)
        jscope.set_var("tb", jnp.asarray(
            _visible_init(jscope.find_var("tb"), "float32")))
        for i, f in enumerate(feeds):
            jlosses.append(float(np.asarray(
                jexe.run(jmain, feed=f, fetch_list=[jloss])[0])))
            jcounts.append(int(np.asarray(
                jscope.find_var("tb@log_count"))[0]))
            if i == 5:
                snap = {v.name: np.array(jscope.find_var(v.name))
                        for v in jmain.list_vars() if v.persistable
                        and jscope.find_var(v.name) is not None}
    assert jcounts[5] == 2 * B * F
    with tnames.guard():
        main, startup, loss = _build(tfluid, "adam", "deferred",
                                     segments=4, lr=0.05)
    for n, a in snap.items():
        v = main.global_block().var(n)
        assert tuple(v.shape) == a.shape, n
        assert tfluid.core.dtypes.dtype_str(v.dtype) == str(a.dtype), n
    exe = tfluid.Executor(CPU)
    scope = tfluid.Scope()
    tfluid.io.load_params_from_numpy(snap, scope=scope)
    losses, counts = [], []
    for f in feeds[6:]:
        losses.append(float(exe.run(main, feed=f, fetch_list=[loss],
                                    scope=scope)[0]))
        counts.append(int(scope.find_np("tb@log_count")[0]))
    np.testing.assert_allclose(losses, jlosses[6:], rtol=1e-5)
    assert counts == jcounts[6:]
    assert 0 in counts  # the fold fired after step 8, on the JAX cadence


def test_epilogue_counter_is_purged_when_its_program_dies():
    """The steps-since-fold counter lives on the scope, keyed by
    (id(program), i), and is purged when the program dies: a new program
    (whatever id it gets, a recycled one included) starts from the
    scope's count, not from a dead program's counter."""
    feeds = _feeds(5)
    exe = tfluid.Executor(CPU)
    scope = tfluid.Scope()

    def build():
        with tnames.guard():
            return _build(tfluid, "sgd", "deferred", segments=4)

    main, startup, loss = build()
    first = tfluid.Executor(CPU)
    first.run(startup, scope=scope)
    for f in feeds[:2]:
        first.run(main, feed=f, fetch_list=[loss], scope=scope)
    dead = id(main)
    assert scope._epilogue_pending == {(dead, 0): 2}
    del main, loss, first, f
    gc.collect()
    assert scope._epilogue_pending == {}
    # the scope's log was folded away by hand, as a restore of a folded
    # checkpoint would leave it: a new program must start from 0
    scope.set_var("tb@log_count", torch.zeros(1, dtype=torch.int32))
    main2, _, loss2 = build()
    exe.run(main2, feed=feeds[2], fetch_list=[loss2], scope=scope)
    assert scope._epilogue_pending == {(id(main2), 0): 1}
    # a stale entry at a recycled id would be inherited without the purge
    pend = scope._epilogue_pending
    pend[(12345, 0)] = 3
    tfluid.core.executor._purge_pending(pend, 12345)
    assert (12345, 0) not in pend and (id(main2), 0) in pend
