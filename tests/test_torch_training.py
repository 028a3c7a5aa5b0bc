"""The port's training path against the JAX package's, on the CPU.

Autodiff (append_backward / gradients and the executor's autodiff op), the
optimizers with regularization and clipping, bf16 AMP, and a tiny BERT
pretraining program (2 layers, hidden 64, 2 heads, vocab 128, B=2, T=16,
dropout 0) built with both DSLs: same op sequence, the JAX startup scope
(optimizer state included) copied into the port, then 3 Adam steps.

Tolerances, f32: losses rtol 1e-4; step-1 gradients rtol 1e-4, atol 1e-6
(the two packages sum in other orders). Parameters after 3 Adam steps are
held at rtol 1e-3, atol 1e-5: Adam divides each update by sqrt(v), which
turns a last-bit difference in a near-zero gradient into a visible
difference in the step. bf16 AMP: losses rtol 1e-3; each gradient within
3e-2 · max|gradient| of the JAX one — XLA and PyTorch round to bf16 at
other places in the fused graph.
The `cuda` tests need a card and skip here; chip_smoke.py runs the same
path at full width on the card."""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import paddle_tpu_torch as tfluid
from paddle_tpu.core import unique_name as jnames
from paddle_tpu.models import bert as jbert
from paddle_tpu_torch.core import unique_name as tnames
from paddle_tpu_torch.models import bert as tbert

# One intra-op thread: tier-1 runs several xdist workers, and a second
# torch worker thread, started beside JAX's runtime in the same process, was
# seen to compute some batches of a CPU matmul ~1e-4 off.
torch.set_num_threads(1)

B, T = 2, 16
FEEDS = ["src_ids", "pos_ids", "sent_ids", "input_mask", "mlm_labels"]


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


def _run_both(build, feed, steps=1):
    """Build the same program with each package's DSL (`build(fluid)` returns
    the fetch list), run the JAX startup program, copy every persistable
    into the port's scope, and run `steps` steps of main in both. Returns
    ([jax fetches per step], [port fetches per step], (jax main, port main))."""
    runs, mains, state = [], [], None
    for fluid, names in ((jfluid, jnames), (tfluid, tnames)):
        main, startup = fluid.Program(), fluid.Program()
        with names.guard(), fluid.program_guard(main, startup):
            fetch = build(fluid)
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        with fluid.scope_guard(scope):
            if state is None:
                exe.run(startup)
                state = {v.name: np.asarray(scope.find_var(v.name))
                         for v in main.list_vars() if v.persistable
                         and scope.find_var(v.name) is not None}
            else:
                fluid.io.load_params_from_numpy(state, scope=scope)
            runs.append([exe.run(main, feed=feed, fetch_list=fetch)
                         for _ in range(steps)])
        mains.append(main)
    return runs[0], runs[1], mains


def _assert_same(jax_out, port_out, **tol):
    for j, t in zip(jax_out, port_out):
        np.testing.assert_allclose(np.asarray(t, np.float64),
                                   np.asarray(j, np.float64), **tol)


# -- twins of tests/test_core.py's autodiff tests ---------------------------

def test_append_backward_grads():
    def build(fluid):
        x = fluid.layers.data("x", [4])
        y = fluid.layers.fc(x, 1, bias_attr=False)
        loss = fluid.layers.mean(y)
        params_grads = fluid.append_backward(loss)
        assert len(params_grads) == 1
        return [params_grads[0][1]]

    (jax_out,), (port_out,), _ = _run_both(
        build, {"x": np.ones((8, 4), "float32")})
    # d(mean(xw))/dw = mean over batch of x = ones
    np.testing.assert_allclose(port_out[0], np.ones((4, 1)), rtol=1e-5)
    _assert_same(jax_out, port_out, rtol=1e-6)


def _x123():
    return {"x": np.array([[1.0, 2.0, 3.0]], dtype="float32")}


def test_gradients_api():
    def build(fluid):
        x = fluid.layers.data("x", [3])
        loss = fluid.layers.reduce_sum(fluid.layers.square(x))
        return fluid.gradients([loss], [x])

    (jax_out,), (port_out,), _ = _run_both(build, _x123())
    np.testing.assert_allclose(port_out[0], 2 * _x123()["x"], rtol=1e-6)
    _assert_same(jax_out, port_out, rtol=1e-6)


def test_stop_gradient_blocks_flow():
    def build(fluid):
        x = fluid.layers.data("x", [3])
        x.stop_gradient = False
        frozen = fluid.layers.scale(x, scale=3.0)
        frozen.stop_gradient = True
        y = fluid.layers.elementwise_add(fluid.layers.square(x), frozen)
        return fluid.gradients([fluid.layers.reduce_sum(y)], [x])

    (jax_out,), (port_out,), _ = _run_both(build, _x123())
    # grad flows only through the square branch: 2x (scale branch cut)
    np.testing.assert_allclose(port_out[0], 2 * _x123()["x"], rtol=1e-6)
    _assert_same(jax_out, port_out, rtol=1e-6)


@pytest.mark.parametrize("seeded", [False, True])
def test_gradients_multi_target(seeded):
    """calc_gradient parity (reference backward.py:820): several targets,
    per-target seed cotangents ([1] seed for a scalar target), summed."""
    def build(fluid):
        x = fluid.layers.data("x", [3])
        t1 = fluid.layers.reduce_sum(fluid.layers.square(x))      # 2x
        t2 = fluid.layers.reduce_sum(fluid.layers.scale(x, 3.0))  # 3
        seeds = None
        if seeded:
            seeds = [None, fluid.layers.fill_constant([1], "float32", 10.0)]
        return fluid.gradients([t1, t2], [x], target_gradients=seeds)

    (jax_out,), (port_out,), _ = _run_both(build, _x123())
    want = 2 * _x123()["x"] + (30.0 if seeded else 3.0)
    np.testing.assert_allclose(port_out[0], want, rtol=1e-6)
    _assert_same(jax_out, port_out, rtol=1e-6)


def test_gradients_wrt_intermediate_var():
    """Grad w.r.t. an op OUTPUT (not a leaf)."""
    def build(fluid):
        x = fluid.layers.data("x", [3])
        h = fluid.layers.scale(x, 2.0)
        return fluid.gradients([fluid.layers.reduce_sum(h)], [h])

    (jax_out,), (port_out,), _ = _run_both(
        build, {"x": np.ones((1, 3), "float32")})
    np.testing.assert_allclose(port_out[0], np.ones((1, 3)))
    _assert_same(jax_out, port_out, rtol=1e-6)


def test_unreached_target_gets_zeros():
    def build(fluid):
        x = fluid.layers.data("x", [3])
        y = fluid.layers.data("y", [3])
        loss = fluid.layers.reduce_sum(fluid.layers.square(x))
        return fluid.gradients([loss], [x, y])

    feed = dict(_x123(), y=np.ones((1, 3), "float32"))
    (jax_out,), (port_out,), _ = _run_both(build, feed)
    np.testing.assert_array_equal(port_out[1], np.zeros((1, 3)))
    _assert_same(jax_out, port_out, rtol=1e-6)


# -- optimizers, regularization, clipping ------------------------------------

@pytest.mark.parametrize("opt", ["sgd", "adam", "adamw", "lamb"])
def test_optimizer_steps_match(opt):
    """A two-layer regressor with an L2-regularized layer and a gradient
    clip (by value for SGD, by norm for Adam, by global norm for AdamW and
    Lamb), 3 steps from the same initial state."""
    def build(fluid):
        x = fluid.layers.data("x", [6])
        reg = fluid.regularizer.L2Decay(0.01)
        h = fluid.layers.fc(x, 8, act="tanh",
                            param_attr=fluid.ParamAttr(name="h.w",
                                                       regularizer=reg))
        y = fluid.layers.fc(h, 1, param_attr=fluid.ParamAttr(name="y.w"))
        loss = fluid.layers.mean(fluid.layers.square(y))
        clip = {"sgd": fluid.clip.GradientClipByValue(0.02),
                "adam": fluid.clip.GradientClipByNorm(0.05)}.get(
                    opt, fluid.clip.GradientClipByGlobalNorm(0.05))
        o = {"sgd": lambda: fluid.optimizer.SGD(0.1, grad_clip=clip),
             "adam": lambda: fluid.optimizer.Adam(0.01, grad_clip=clip),
             "adamw": lambda: fluid.optimizer.AdamW(0.01, grad_clip=clip),
             "lamb": lambda: fluid.optimizer.Lamb(0.01, grad_clip=clip)}[opt]
        o().minimize(loss)
        return [loss, "h.w", "y.w"]

    feed = {"x": np.random.RandomState(3).randn(5, 6).astype("float32")}
    jax_runs, port_runs, _ = _run_both(build, feed, steps=3)
    for j, t in zip(jax_runs, port_runs):
        np.testing.assert_allclose(t[0], j[0], rtol=1e-5)
        _assert_same(j[1:], t[1:], rtol=1e-4, atol=1e-6)


def test_float16_dynamic_loss_scaling_matches_jax():
    """decorate(dtype="float16"): the loss is scaled, the grads unscaled and
    checked by update_loss_scaling, which doubles the scale after 2 good
    steps. float16 casts: losses rtol 1e-3, params atol 1e-4."""
    def build(fluid):
        x = fluid.layers.data("x", [6])
        h = fluid.layers.fc(x, 8, act="tanh",
                            param_attr=fluid.ParamAttr(name="h.w"))
        y = fluid.layers.fc(h, 1, param_attr=fluid.ParamAttr(name="y.w"))
        loss = fluid.layers.mean(fluid.layers.square(y))
        fluid.contrib.mixed_precision.decorate(
            fluid.optimizer.SGD(0.1), dtype="float16",
            init_loss_scaling=2.0 ** 10, incr_every_n_steps=2,
            use_dynamic_loss_scaling=True).minimize(loss)
        return [loss, "h.w", "y.w", "loss_scaling"]

    feed = {"x": np.random.RandomState(3).randn(5, 6).astype("float32")}
    jax_runs, port_runs, _ = _run_both(build, feed, steps=3)
    for j, t in zip(jax_runs, port_runs):
        np.testing.assert_allclose(t[0], j[0], rtol=1e-3)
        _assert_same(j[1:3], t[1:3], rtol=1e-3, atol=1e-4)
        np.testing.assert_array_equal(t[3], j[3])
    assert [float(r[3][0]) for r in port_runs] == [1024.0, 2048.0, 2048.0]


def test_sparse_rows_are_not_ported_yet():
    """An is_sparse table trains through SelectedRows gradients (since the
    DeepFM slice): only the looked-up rows move. The deferred-row log is
    ported too: deferred_rows= validates its config as the JAX package
    does (a dict with rows_per_step; segments defaults to 16), and only
    Adam of the Adam family takes it."""
    with pytest.raises(ValueError, match="rows_per_step"):
        tfluid.optimizer.Adam(0.1, deferred_rows={"segments": 4})
    with pytest.raises(ValueError, match="sgd/adagrad/adam only"):
        tfluid.optimizer.AdamW(0.1, deferred_rows={"rows_per_step": 4})
    assert tfluid.optimizer.Adam(0.1, deferred_rows={
        "rows_per_step": 4})._deferred_rows == {"segments": 16,
                                                "rows_per_step": 4}
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        ids = tfluid.layers.data("ids", [3], dtype="int64")
        emb = tfluid.layers.embedding(ids, [10, 4], is_sparse=True)
        loss = tfluid.layers.mean(emb)
        tfluid.optimizer.SGD(0.1).minimize(loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup)
    table = main.global_block().ops[0].inputs["W"][0]
    before = tfluid.global_scope().find_np(table)
    exe.run(main, feed={"ids": np.array([[1, 2, 3]])}, fetch_list=[loss])
    after = tfluid.global_scope().find_np(table)
    np.testing.assert_array_equal(after[[0, 4, 5, 6, 7, 8, 9]],
                                  before[[0, 4, 5, 6, 7, 8, 9]])
    np.testing.assert_allclose(after[1:4], before[1:4] - 0.1 / 12, rtol=1e-6)


def test_softmax_with_cross_entropy_grad_with_ignore_index():
    """Loss and d(loss)/d(logits) of the hard-label CE with ignored rows,
    f32 and bf16 logits, against the JAX op under jax.vjp."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.core import registry as jreg
    from paddle_tpu.core.executor import ExecContext as JaxCtx
    from paddle_tpu_torch.core import registry as treg
    from paddle_tpu_torch.core.executor import ExecContext as TorchCtx

    rng = np.random.RandomState(0)
    logits = (rng.randn(3, 5, 11) * 2).astype("float32")
    labels = rng.randint(0, 11, (3, 5, 1)).astype("int64")
    labels[0, 1, 0] = labels[2, :, 0] = -100
    g = rng.randn(3, 5, 1).astype("float32")
    attrs = {"ignore_index": -100}
    jfn = jreg.get_op("softmax_with_cross_entropy").fn
    tfn = treg.get_op("softmax_with_cross_entropy").fn
    for dt, tol in ((jnp.float32, 1e-6), (jnp.bfloat16, 1e-2)):
        def jloss(lg):
            return jfn(JaxCtx(None), {"Logits": [lg], "Label": [
                jnp.asarray(labels)]}, attrs)["Loss"][0]
        jl, vjp = jax.vjp(jloss, jnp.asarray(logits).astype(dt))
        (jg,) = vjp(jnp.asarray(g))
        tl = torch.tensor(logits).to(
            torch.float32 if dt == jnp.float32 else torch.bfloat16)
        tl.requires_grad_()
        out = tfn(TorchCtx("cpu"), {"Logits": [tl], "Label": [
            torch.tensor(labels)]}, attrs)["Loss"][0]
        (tg,) = torch.autograd.grad(out, tl, torch.tensor(g))
        assert out.dtype == torch.float32 and tg.dtype == tl.dtype
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jl),
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(tg.float().numpy(),
                                   np.asarray(jg.astype(jnp.float32)),
                                   rtol=tol, atol=tol)
        assert np.all(tg.float().numpy()[2] == 0)   # ignored rows: no grad


def test_softmax_output_only_when_read():
    """The full-vocab Softmax output is computed only when a later op or a
    fetch reads it."""
    from paddle_tpu_torch.core.executor import ExecContext
    from paddle_tpu_torch.core.registry import get_op

    x = torch.randn(4, 5)
    lbl = torch.tensor([[0], [1], [2], [4]])
    ctx = ExecContext("cpu", needed={"loss"})
    ctx.out_names = {"Loss": ["loss"], "Softmax": ["sm"]}
    out = get_op("softmax_with_cross_entropy").fn(
        ctx, {"Logits": [x], "Label": [lbl]}, {})
    assert out["Softmax"] == [None] and out["Loss"][0].shape == (4, 1)

    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        xv = tfluid.layers.data("x", [5])
        lv = tfluid.layers.data("lbl", [1], dtype="int64")
        loss, sm = tfluid.layers.softmax_with_cross_entropy(
            xv, lv, return_softmax=True)
        mean = tfluid.layers.mean(loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    feed = {"x": x.numpy(), "lbl": lbl.numpy()}
    (got,) = exe.run(main, feed=feed, fetch_list=[mean])
    (probs,) = exe.run(main, feed=feed, fetch_list=[sm])
    np.testing.assert_allclose(probs, torch.softmax(x, -1).numpy(),
                               rtol=1e-6)


# -- the tiny BERT pretraining program ---------------------------------------

def _bert_cfg(bert, flash, dropout=0.0):
    return bert.BertConfig(vocab_size=128, hidden_size=64, num_layers=2,
                           num_heads=2, ffn_size=128, max_position=T,
                           hidden_dropout=dropout, attn_dropout=dropout,
                           use_flash_attention=flash)


def _bert_feed(seed=0):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 128, (B, T, 1)).astype("int64")
    labels[0, :5] = -100
    mask = np.ones((B, T), "float32")
    mask[1, 12:] = 0.0
    return {"src_ids": rng.randint(0, 128, (B, T)).astype("int64"),
            "pos_ids": np.tile(np.arange(T, dtype="int64"), (B, 1)),
            "sent_ids": (rng.rand(B, T) > 0.5).astype("int64"),
            "input_mask": mask, "mlm_labels": labels}


def _adam_factory(fluid, amp):
    def make():
        opt = fluid.optimizer.Adam(1e-3)
        if amp:
            opt = fluid.contrib.mixed_precision.decorate(
                opt, dtype="bfloat16", use_dynamic_loss_scaling=False)
        return opt
    return make


def _pretrain(fluid, bert, names, flash, amp=False, dropout=0.0):
    with names.guard():
        return bert.build_pretrain_program(
            _bert_cfg(bert, flash, dropout), B, T,
            optimizer_factory=_adam_factory(fluid, amp))


@pytest.mark.parametrize("flash", [True, False])
def test_pretrain_program_same_ops(flash):
    jmain, jstartup, jfeeds, jloss = _pretrain(jfluid, jbert, jnames, flash)
    tmain, tstartup, tfeeds, tloss = _pretrain(tfluid, tbert, tnames, flash)
    assert tfeeds == jfeeds == FEEDS and tloss.name == jloss.name
    for jp, tp in ((jmain, tmain), (jstartup, tstartup)):
        jops = [(o.type, o.inputs, o.outputs, o.attrs)
                for o in jp.global_block().ops]
        tops = [(o.type, o.inputs, o.outputs, o.attrs)
                for o in tp.global_block().ops]
        assert tops == jops
    types = [o.type for o in tmain.global_block().ops]
    assert types.count("autodiff") == 1
    assert types.count("adam") == len(tmain.all_parameters())
    assert ("flash_attention" in types) == flash


_BERT_RUNS = {}


def _bert_runs(flash, amp):
    """3 Adam steps of the tiny BERT in both packages from one initial
    state, fetching the loss, every parameter gradient and the parameters
    (cached: several tests read one run)."""
    key = (flash, amp)
    if key not in _BERT_RUNS:
        def build(fluid):
            bert = jbert if fluid is jfluid else tbert
            cfg = _bert_cfg(bert, flash)
            feeds = [fluid.layers.data(n, [T], dtype=dt) for n, dt in zip(
                FEEDS[:4], ("int64", "int64", "int64", "float32"))]
            labels = fluid.layers.data("mlm_labels", [T, 1], dtype="int64")
            seq = bert.bert_encoder(cfg, *feeds)
            loss = bert.bert_pretrain_loss(cfg, seq, labels, feeds[3])
            _adam_factory(fluid, amp)().minimize(loss)
            params = sorted(p.name for p in
                            fluid.default_main_program().all_parameters())
            return [loss] + [p + "@GRAD" for p in params] + params

        _BERT_RUNS[key] = _run_both(build, _bert_feed(), steps=3)
    return _BERT_RUNS[key]


@pytest.mark.parametrize("flash", [True, False])
def test_pretrain_matches_jax_f32(flash):
    jax_runs, port_runs, (jmain, _) = _bert_runs(flash, amp=False)
    n = len(jmain.all_parameters())
    losses = [[r[0] for r in runs] for runs in (jax_runs, port_runs)]
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)
    assert losses[1][2] < losses[1][0]
    _assert_same(jax_runs[0][1:1 + n], port_runs[0][1:1 + n],
                 rtol=1e-4, atol=1e-6)
    _assert_same(jax_runs[2][1 + n:], port_runs[2][1 + n:],
                 rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("flash", [True, False])
def test_pretrain_matches_jax_bf16_amp(flash):
    jax_runs, port_runs, (jmain, _) = _bert_runs(flash, amp=True)
    n = len(jmain.all_parameters())
    losses = [[r[0] for r in runs] for runs in (jax_runs, port_runs)]
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-3)
    for j, t in zip(jax_runs[0][1:1 + n], port_runs[0][1:1 + n]):
        j = np.asarray(j, np.float64)
        assert np.abs(np.asarray(t, np.float64) - j).max() <= \
            3e-2 * np.abs(j).max()
    # the f32 master weights stay f32 and get f32 grads through the casts
    assert all(np.asarray(g).dtype == np.float32
               for g in port_runs[0][1:1 + n])


def test_pretrain_dropout_is_seeded_and_trains():
    """At dropout 0.1 (hidden and attention) the port's losses depend only
    on the program's seed: two fresh runs agree, another seed differs, and
    the no-dropout loss differs from both. The JAX package draws other
    random bits, so this is not compared with it."""
    def losses(seed, dropout=0.1):
        main, startup, _, loss = _pretrain(tfluid, tbert, tnames, True,
                                           dropout=dropout)
        main.random_seed = startup.random_seed = seed
        exe = tfluid.Executor(tfluid.CPUPlace())
        with tfluid.scope_guard(tfluid.Scope()):
            exe.run(startup)
            return [float(exe.run(main, feed=_bert_feed(),
                                  fetch_list=[loss])[0]) for _ in range(3)]

    a, b, c = losses(11), losses(11), losses(12)
    assert a == b and a != c
    assert all(np.isfinite(a)) and a[-1] < a[0]
    assert losses(11, dropout=0.0)[0] != a[0]


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("amp", [False, True])
def test_cuda_pretrain_step_matches_cpu(amp):
    """One step of the tiny BERT on the card (flash kernels) and on the CPU
    (their plain versions), from the same state, at dropout 0."""
    _cuda_or_skip()
    main, startup, _, loss = _pretrain(tfluid, tbert, tnames, True, amp=amp)
    cpu_scope = tfluid.Scope()
    with tfluid.scope_guard(cpu_scope):
        tfluid.Executor(tfluid.CPUPlace()).run(startup)
    state = {n: cpu_scope.find_np(n) for n in
             (v.name for v in main.list_vars() if v.persistable)
             if cpu_scope.has_var(n)}
    gpu_scope = tfluid.Scope()
    tfluid.io.load_params_from_numpy(state, scope=gpu_scope)
    grads = [p.name + "@GRAD" for p in main.all_parameters()]
    want = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed=_bert_feed(), fetch_list=[loss] + grads, scope=cpu_scope)
    got = tfluid.Executor(tfluid.CUDAPlace(0)).run(
        main, feed=_bert_feed(), fetch_list=[loss] + grads, scope=gpu_scope)
    tol = dict(rtol=1e-3, atol=1e-4) if amp else dict(rtol=1e-4, atol=1e-6)
    _assert_same(want, got, **tol)
