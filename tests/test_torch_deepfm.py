"""The port's DeepFM builder, SelectedRows gradients and packed-row
optimizers against the JAX package, on the CPU.

Structure: both DSLs emit the same DeepFM program with the table packed on
exact Adagrad (op types, slots, attrs, var descs, startup ops). Parity: a
narrow DeepFM (vocab 300, 26 fields, hidden 32×32, B = 8, lr 1e-3) trained 4
steps in both packages from the JAX startup scope, the JAX package running
its sparse-Adagrad Pallas kernel under the interpreter: losses within rtol
1e-5; the dense parameters and the touched table payloads (parameter and
accumulator columns, unpacked) within rtol 1e-5 / atol 1e-6 — the gradients
come out of two backprops that sum in different orders, and Adam and
Adagrad divide a near-zero gradient by its own size, so a last-bit
difference there moves a weight by up to ~1e-3 of lr; untouched table rows
and the spare lanes bit for bit. The kernel arithmetic itself is held to
the bit in ``test_torch_sparse_adagrad.py``. Inside the port:
fused = unfused bit for bit, and twins of the JAX package's SelectedRows and
packed-table tests (``tests/test_sparse_row_updates.py``,
``tests/test_sparse_embedding.py``)."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as jnames
from paddle_tpu.models import deepfm as jdeepfm
from paddle_tpu.ops.pallas_kernels import sparse_adagrad as jfsa
from paddle_tpu_torch import layers
from paddle_tpu_torch.core import unique_name as tnames
from paddle_tpu_torch.initializer import (NormalInitializer,
                                          RowPackInitializer,
                                          UniformInitializer)
from paddle_tpu_torch.models import deepfm as tdeepfm
from paddle_tpu_torch.ops import deferred_rows as dr
from paddle_tpu_torch.param_attr import ParamAttr

torch.set_num_threads(1)

VOCAB, BATCH, HIDDEN, LR = 300, 8, (32, 32), 1e-3


@pytest.fixture(autouse=True)
def _fresh_port_state():
    """Fresh default programs, scope and unique names of the port."""
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


@pytest.fixture
def interpret_kernel():
    old = jfsa.FORCE_PALLAS_INTERPRET
    jfsa.FORCE_PALLAS_INTERPRET = True
    yield
    jfsa.FORCE_PALLAS_INTERPRET = old


def _build(deepfm, names, fused=True):
    with names.guard():
        return deepfm.build_train_program(
            vocab_size=VOCAB, is_sparse=True, fused_table=True, lr=LR,
            embedding_optimizer="adagrad", hidden_sizes=HIDDEN,
            packed_rows={"rows_per_step": BATCH * 26, "fused": fused})


def _feeds(n, seed=0, vocab=VOCAB, batch=BATCH):
    rng = np.random.RandomState(seed)
    return [{"sparse_ids": rng.randint(0, vocab, (batch, 26)).astype("int64"),
             "dense": rng.rand(batch, 13).astype("float32"),
             "label": rng.randint(0, 2, (batch, 1)).astype("float32")}
            for _ in range(n)]


def _ops(program):
    return [(op["type"], op["inputs"], op["outputs"], op["attrs"])
            for op in program.to_dict()["blocks"][0]["ops"]]


def test_same_program_as_jax():
    jmain, jstart, jfeeds, jloss, jprob = _build(jdeepfm, jnames)
    tmain, tstart, tfeeds, tloss, tprob = _build(tdeepfm, tnames)
    assert tfeeds == jfeeds and tloss.name == jloss.name
    for jp, tp in ((jmain, tmain), (jstart, tstart)):
        assert _ops(tp) == _ops(jp)
        assert tp.to_dict() == jp.to_dict()
    kinds = [op.type for op in tmain.global_block().ops]
    assert kinds.count("adagrad_row_packed") == 1
    assert tmain.global_block().var("fm_t").shape == (VOCAB, 128)


def test_training_matches_jax(interpret_kernel):
    feeds = _feeds(4)
    results, state = [], None
    for fluid, deepfm, names in ((jfluid, jdeepfm, jnames),
                                 (tfluid, tdeepfm, tnames)):
        main, startup, _, loss, _ = _build(deepfm, names)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(scope):
            if state is None:
                exe.run(startup)
                state = {v.name: np.array(scope.find_var(v.name))
                         for v in main.list_vars() if v.persistable
                         and scope.find_var(v.name) is not None}
            else:
                fluid.io.load_params_from_numpy(state, scope=scope)
            losses = [float(exe.run(main, feed=f, fetch_list=[loss])[0])
                      for f in feeds]
            params = {p.name: np.array(scope.find_var(p.name)) if fluid is
                      jfluid else scope.find_np(p.name)
                      for p in main.all_parameters()}
        results.append((losses, params))
    (jl, jp), (tl, tp) = results
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tp.keys() == jp.keys() and tp["fm_t"].dtype == np.uint16
    for name in jp:
        if name != "fm_t":
            np.testing.assert_allclose(tp[name], jp[name], rtol=1e-5,
                                       atol=1e-6, err_msg=name)
    touched = np.unique(np.concatenate([f["sparse_ids"].ravel()
                                        for f in feeds]))
    untouched = np.setdiff1d(np.arange(VOCAB), touched)
    np.testing.assert_array_equal(tp["fm_t"][untouched],
                                  jp["fm_t"][untouched])
    np.testing.assert_allclose(
        tp["fm_t"][touched, :68].copy().view(np.float32),
        jp["fm_t"][touched, :68].copy().view(np.float32), rtol=1e-5,
        atol=1e-6)
    assert (tp["fm_t"][touched] != state["fm_t"][touched]).any()
    np.testing.assert_array_equal(tp["fm_t"][touched, 68:], 0)


def _train_port(main, startup, loss, feeds, table=None, name="fm_t"):
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    if table is not None:
        tfluid.io.load_params_from_numpy({name: table}, scope=scope)
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0]) for f in feeds]
    return np.array(losses), scope


def test_fused_equals_unfused_bitwise():
    """Twin of test_packed_program_fused_vs_unfused_bitwise: the fused
    branch (row 12's plain version on the CPU) and the unfused
    gather+scatter give the same losses and table bytes, duplicates
    included."""
    feeds = _feeds(5, seed=3, vocab=40)
    out = []
    for fused in (True, False):
        with tnames.guard():
            main, startup, _, loss, _ = tdeepfm.build_train_program(
                vocab_size=40, is_sparse=True, fused_table=True, lr=0.1,
                embedding_optimizer="adagrad", hidden_sizes=(8,),
                packed_rows={"rows_per_step": BATCH * 26, "fused": fused})
        losses, scope = _train_port(main, startup, loss, feeds)
        out.append((losses, scope.find_np("fm_t")))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])


# -- twins of tests/test_sparse_row_updates.py -------------------------------

V, D, B, F = 50, 4, 4, 3
MULT = {"sgd": 1, "adagrad": 2, "adam": 3}
OPTS = {"sgd": tfluid.optimizer.SGD, "adagrad": tfluid.optimizer.Adagrad,
        "adam": tfluid.optimizer.Adam}


def _row_feeds(n, vocab=V, unique=False, seed=1):
    rng = np.random.RandomState(seed)
    return [{"ids": (rng.choice(vocab, (B, F), replace=False) if unique
                     else rng.randint(0, vocab, (B, F))).astype("int64")}
            for _ in range(n)]


def _train_rows(opt_name, packed, feeds, vocab=V, lr=0.1):
    """An is_sparse table trained by `opt_name`, dense f32 or packed;
    the same visible start either way. Returns the losses."""
    mult = MULT[opt_name] if packed else 1
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        ids = layers.data("ids", [F], dtype="int64")
        init = (RowPackInitializer(D, D * mult, -1.0, 1.0) if packed
                else UniformInitializer(-1.0, 1.0))
        emb = layers.embedding(ids, [vocab, D * mult], is_sparse=True,
                               row_pack=packed,
                               param_attr=ParamAttr(name="tb",
                                                    initializer=init))
        if mult > 1:
            emb = layers.slice(emb, axes=[2], starts=[0], ends=[D])
        loss = layers.reduce_sum(layers.square(emb))
        kw = {"packed_rows": {"rows_per_step": B * F}} if packed else {}
        OPTS[opt_name](lr, **kw).minimize(loss)
    vis = np.random.RandomState(7).uniform(-1, 1, (vocab, D)).astype("f4")
    if packed:
        rows = np.zeros((vocab, D * mult), "float32")
        rows[:, :D] = vis
        table = dr.i16(dr.pack_rows(torch.from_numpy(rows))).numpy().view(
            np.uint16)
    else:
        table = vis
    return _train_port(main, startup, loss, feeds, table, "tb")[0]


@pytest.mark.parametrize("opt_name", ["sgd", "adagrad", "adam"])
def test_packed_bitwise_vs_dense(opt_name):
    """Packed row-major table == dense f32 table with SelectedRows grads,
    bit for bit, on duplicate-free batches."""
    feeds = _row_feeds(15, vocab=200, unique=True)
    np.testing.assert_array_equal(
        _train_rows(opt_name, False, feeds, vocab=200),
        _train_rows(opt_name, True, feeds, vocab=200))


def test_packed_duplicate_merge_matches_numpy():
    """Duplicates within a step: sum rows per id, ONE adagrad step per
    unique id with the merged gradient, against a numpy oracle."""
    ids = np.array([[3, 3, 7], [7, 1, 3], [2, 2, 2], [1, 5, 5]], "int64")
    pk = _train_rows("adagrad", True, [{"ids": ids}] * 2, vocab=10, lr=0.1)
    w = np.random.RandomState(7).uniform(-1, 1, (10, D)).astype(
        "float32").astype("float64")
    g_acc = np.zeros_like(w)
    flat = ids.reshape(-1)
    losses = []
    for _ in range(2):
        losses.append(float((w[flat] ** 2).sum()))
        grad = np.zeros_like(w)
        np.add.at(grad, flat, 2 * w[flat])
        touched = np.unique(flat)
        g_acc[touched] += grad[touched] ** 2
        w[touched] -= 0.1 * grad[touched] / (np.sqrt(g_acc[touched]) + 1e-6)
    np.testing.assert_allclose(pk, losses, rtol=1e-5)


def test_packed_deepfm_builder_trains():
    Vv, Bv = 5000, 8
    with tnames.guard():
        main, startup, _, loss, _ = tdeepfm.build_train_program(
            vocab_size=Vv, is_sparse=True, fused_table=True, lr=0.05,
            embedding_optimizer="adagrad",
            packed_rows={"rows_per_step": Bv * 26})
    losses, _ = _train_port(main, startup, loss,
                            _feeds(12, vocab=Vv, batch=Bv))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-4:]) < np.mean(losses[:4])


def test_deferred_rows_raise_not_ported():
    """deferred_rows= is ported: SGD, Adagrad and Adam take it, and the
    deferred DeepFM builder emits the JAX package's program (same ops,
    the rewired lookup site, the state vars' names, shapes and dtypes,
    the fold epilogue's cadence and ops). Misconfigurations raise as in
    the JAX package."""
    for opt in (tfluid.optimizer.SGD, tfluid.optimizer.Adagrad,
                tfluid.optimizer.Adam):
        assert opt(0.1, deferred_rows={"rows_per_step": B * F,
                                       "segments": 3})._deferred_rows == {
            "rows_per_step": B * F, "segments": 3}
    cfg = dict(vocab_size=VOCAB, is_sparse=True, fused_table=True, lr=LR,
               embedding_optimizer="adam", hidden_sizes=HIDDEN,
               deferred_rows={"rows_per_step": BATCH * 26, "segments": 5})
    with jnames.guard():
        jmain, jstart, _, _, _ = jdeepfm.build_train_program(**cfg)
    with tnames.guard():
        tmain, tstart, _, _, _ = tdeepfm.build_train_program(**cfg)
    for jp, tp in ((jmain, tmain), (jstart, tstart)):
        assert _ops(tp) == _ops(jp)
        assert tp.to_dict() == jp.to_dict()
    (jev, jfold, jmeta), = jmain._epilogue_programs
    (tev, tfold, tmeta), = tmain._epilogue_programs
    assert (tev, tmeta) == (jev, jmeta) == (5, {
        "count_vars": ["fm_t@log_count"], "rows_per_step": BATCH * 26})
    assert tfold.to_dict() == jfold.to_dict()
    blk = tmain.global_block()
    assert blk.var("fm_t").shape == (VOCAB, 51)
    assert blk.var("fm_t@log_raw").shape == (5 * BATCH * 26, 128)
    assert [op.type for op in blk.ops].count("adam_row_deferred") == 1
    with pytest.raises(ValueError, match="is_sparse"):
        tdeepfm.build_train_program(vocab_size=100, is_sparse=False,
                                    embedding_optimizer="adagrad",
                                    deferred_rows={"rows_per_step": 10})


# -- twins of tests/test_sparse_embedding.py ---------------------------------

def _embed_model(vocab, dim, is_sparse, opt_factory, width=6):
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        main.random_seed = startup.random_seed = 7
        ids = layers.data("ids", [width], dtype="int64")
        y = layers.data("y", [1], dtype="float32")
        emb = layers.embedding(
            ids, [vocab, dim], is_sparse=is_sparse,
            param_attr=ParamAttr(name="table",
                                 initializer=NormalInitializer(0.0, 0.1)))
        pooled = layers.reduce_sum(emb, dim=1)
        pred = layers.fc(pooled, 1, param_attr=ParamAttr(name="head.w"),
                         bias_attr=ParamAttr(name="head.b"))
        loss = layers.reduce_mean(layers.square_error_cost(pred, y))
        opt_factory().minimize(loss)
    return main, startup, loss


def _train_embed(main, startup, loss, feeds, steps=4):
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    losses = [float(exe.run(main, feed=feeds, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(steps)]
    return losses, scope.find_np("table")


def _embed_feeds(vocab, width=6):
    rng = np.random.RandomState(0)
    return {"ids": rng.randint(0, min(vocab, 50), (8, width)).astype("int64"),
            "y": rng.rand(8, 1).astype("float32")}


def test_sparse_sgd_matches_dense():
    feeds = _embed_feeds(64)
    ref = _train_embed(*_embed_model(64, 8, False,
                                     lambda: tfluid.optimizer.SGD(0.5)), feeds)
    got = _train_embed(*_embed_model(64, 8, True,
                                     lambda: tfluid.optimizer.SGD(0.5)), feeds)
    np.testing.assert_allclose(ref[0], got[0], rtol=1e-5)
    np.testing.assert_allclose(ref[1], got[1], rtol=1e-5, atol=1e-7)


def test_sparse_adam_matches_dense_when_all_rows_touched():
    feeds = {"ids": np.tile(np.arange(10), (8, 1)).astype("int64"),
             "y": np.random.RandomState(0).rand(8, 1).astype("float32")}
    runs = [_train_embed(*_embed_model(
        10, 8, sparse, lambda: tfluid.optimizer.Adam(0.05), width=10), feeds)
        for sparse in (False, True)]
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=2e-5)
    np.testing.assert_allclose(runs[0][1], runs[1][1], rtol=2e-5, atol=1e-6)


def test_sparse_adam_is_lazy_for_untouched_rows():
    feeds = _embed_feeds(100)          # ids only in [0, 50)
    main, startup, loss = _embed_model(100, 8, True,
                                       lambda: tfluid.optimizer.Adam(0.1))
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    before = scope.find_np("table").copy()
    for _ in range(3):
        exe.run(main, feed=feeds, fetch_list=[loss], scope=scope)
    after = scope.find_np("table")
    touched = np.unique(feeds["ids"])
    untouched = np.setdiff1d(np.arange(100), touched)
    np.testing.assert_array_equal(after[untouched], before[untouched])
    assert np.abs(after[touched] - before[touched]).max() > 1e-6


def test_deepfm_trains_with_sparse_grads():
    """Separate fm_w1 / fm_emb tables with SelectedRows gradients on Adam:
    the step trains and no dense [vocab, dim] gradient is made."""
    with tnames.guard():
        main, startup, _, loss, _ = tdeepfm.build_train_program(
            vocab_size=50_000, num_fields=6, num_dense=4, embed_dim=8,
            lr=1e-2, is_sparse=True, hidden_sizes=(32,))
    rng = np.random.RandomState(0)
    feeds = {"sparse_ids": rng.randint(0, 50_000, (16, 6)).astype("int64"),
             "dense": rng.rand(16, 4).astype("float32"),
             "label": rng.randint(0, 2, (16, 1)).astype("float32")}
    losses, _ = _train_port(main, startup, loss, [feeds] * 6)
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
