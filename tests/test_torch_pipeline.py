"""The port's pipelines against the JAX package, on the CPU: the port on 4
gloo ranks (one world for this file, ``torch_dist_runner.World`` serving
``torch_pipe_runner``'s cases), the JAX package in this process on the
conftest's 8 virtual devices.

Twins of nine of the ten tests of tests/test_pipeline_optimizer.py (the
tenth, pp2×dp4, is in tests/test_torch_pipeline_composed.py, whose world
has 8 ranks) and of tests/test_parallel.py's two GPipe tests, each at its
JAX test's tolerance. The JAX tests' {"pp": 2, "dp": 4} meshes with
data_axis=None run as {"dp": 2, "pp": 2} here (the dp dim computes
replicated in both packages). Each port run starts from the JAX
startup's parameters; the JAX runs of one program are computed once for
the file. Also the port's own checks:
every replicated persistable bitwise equal across the ranks after every
step, each stage's parameters held by its rank only, Adam on a pp program
equal to the plain run, a pp checkpoint restored into the plain executor
and back, ``io.save_persistables`` after a pp run loaded into the plain
executor, and what the surface refuses.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import torch_dist_runner as R
import torch_pipe_runner as PR

torch.set_num_threads(1)

N = 4
PP2 = {"dp": 2, "pp": 2}   # data_axis None: dp computes replicated
RTOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory):
    """The file's world, started before its first test: the ranks start up
    while the JAX side compiles. The slow twins ``submit`` the port's case
    before they compute the JAX references and ``collect`` it after."""
    tmp = tmp_path_factory.mktemp("pp_world")
    live = {}

    def get():
        w = live.get("w")
        if w is None or not w.alive:
            w = live["w"] = R.World(N, tmp, cases="torch_pipe_runner")
        return w

    get()
    yield get
    if "w" in live:
        live["w"].close()


def _replicated_bitwise(res):
    """Every persistable no axis splits has the same bytes on every rank
    after every step."""
    for step in range(len(res[0]["hashes"])):
        for r in res[1:]:
            assert r["hashes"][step] == res[0]["hashes"][step], step
    assert res[0]["hashes"][0]


def _stages_owned(res, pp_of):
    """Each stage value is held by the ranks of one pp coordinate."""
    staged = res[0]["stages"][0]
    assert staged
    for got in res:
        assert got["stages"][0] == staged
    for name in staged:
        owners = {pp_of(r) for r, got in enumerate(res)
                  if name in got["stages"][1]}
        assert len(owners) == 1, name


def _pp2_rank(r):
    return r % 2    # {"dp": 2, "pp": 2}: rank = 2·dp + pp


_JAX = {}


def _jax(model, feed_fn, axes=None, **kw):
    """PR.jax_run's losses, computed once a (model, mesh, options)."""
    key = (model, feed_fn.__name__, repr(axes), repr(sorted(kw.items())))
    if key not in _JAX:
        _JAX[key] = PR.jax_run(jfluid, model, feed_fn(), axes=axes, **kw)[0]
    return _JAX[key]


def _twin_pp(world, model, feed, jax_axes, rtol=RTOL, atol=1e-6,
             model_kw=None, data_axis=None, **case_kw):
    """(JAX plain losses, JAX pipelined losses, port results): the port's
    every rank within rtol of both."""
    kw = dict(model_kw or {})
    feed_fn = PR.pipe_bert_feed if model == "pipe_bert" else \
        PR.hetero_mlp_feed
    state = PR.jax_state(jfluid, model, **kw)
    w = world()
    w.submit("pipe", dict(model=model, feed=feed, axes=PP2,
                          data_axis=data_axis, state=state, model_kw=kw,
                          **case_kw))
    jref = _jax(model, feed_fn, pp_cut=False)
    jpp = _jax(model, feed_fn, jax_axes, data_axis=data_axis, **kw)
    np.testing.assert_allclose(jref, jpp, rtol=rtol, atol=atol)
    res = w.collect("pipe")
    for r in res:
        np.testing.assert_allclose(r["losses"], jpp, rtol=rtol, atol=atol)
        np.testing.assert_allclose(r["losses"], jref, rtol=rtol, atol=atol)
    return jref, jpp, res


# -- twins of tests/test_pipeline_optimizer.py -------------------------------

def test_pipeline_transform_sequential_fallback():
    """Transformed program == untransformed (plain executor, no pp mesh:
    the op runs its stages one after another)."""
    feed = PR.pipe_bert_feed()
    jref = _jax("pipe_bert", PR.pipe_bert_feed, pp_cut=False)
    jseq = _jax("pipe_bert", PR.pipe_bert_feed, pp_cut=True)
    np.testing.assert_allclose(jref, jseq, rtol=RTOL, atol=1e-6)
    state = PR.jax_state(jfluid, "pipe_bert")
    ref = PR.case_pipe("pipe_bert", feed, state=state,
                       model_kw={"pp_cut": False})
    got = PR.case_pipe("pipe_bert", feed, state=state)
    assert "pipeline" in got["types"]
    np.testing.assert_allclose(got["losses"], jseq, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=RTOL,
                               atol=1e-6)


def test_pipeline_pp2_gpipe_loss_equality(world):
    """PP=2 GPipe == the non-pipelined losses; the stages' parameters live
    on their ranks only and the replicated ones stay bitwise equal."""
    _, _, res = _twin_pp(world, "pipe_bert", PR.pipe_bert_feed(),
                         {"pp": 2})
    _replicated_bitwise(res)
    _stages_owned(res, _pp2_rank)


def test_pipeline_non_isomorphic_stages_lower_to_hetero():
    """Stages that differ (relu vs tanh) lower to the heterogeneous
    per-stage-sub-block pipeline op, in both packages; the plain run
    equals the JAX package's."""
    from paddle_tpu.core import unique_name as jn

    with jn.guard():
        jmain, _, _, _ = PR.build(jfluid, "relu_tanh")
    jtypes = [op.type for op in jmain.global_block().ops]
    assert "pipeline_hetero" in jtypes and "pipeline" not in jtypes
    feed = {"x": np.ones((4, 4), "float32")}
    jl, _ = PR.jax_run(jfluid, "relu_tanh", feed, steps=1)
    got = PR.case_pipe("relu_tanh", feed, steps=1,
                       state=PR.jax_state(jfluid, "relu_tanh"))
    assert got["types"] == jtypes
    assert np.isfinite(got["losses"]).all()
    np.testing.assert_allclose(got["losses"], jl, rtol=1e-5, atol=1e-6)


def test_pipeline_with_dropout_advances_rng(world):
    """Dropout inside pipelined stages draws from the step's generator:
    successive steps see different masks (the loss is not constant under
    fixed feeds with lr=0); every rank draws the same."""
    feed = {"x": np.random.RandomState(0).rand(8, 8).astype("float32")}
    res = world().run("pipe", dict(model="fc_dropout", feed=feed, axes=PP2,
                                   steps=4))
    vals = res[0]["losses"]
    assert np.isfinite(vals).all()
    assert len({round(v, 7) for v in vals}) > 1, vals
    for r in res[1:]:
        assert r["losses"] == vals


def _1f1b_inputs():
    n, m, mb, d = 4, 8, 2, 8
    rng = np.random.RandomState(0)
    W = (rng.randn(n, d, d) * 0.3).astype("float32")
    B = (rng.randn(n, d) * 0.1).astype("float32")
    xs = rng.randn(m, mb, d).astype("float32")
    return W, B, xs


def test_pipeline_1f1b_matches_sequential(world):
    """1F1B schedule (fwd/bwd interleaved, bounded in-flight inputs): loss
    and per-stage grads == the JAX package's pipeline_1f1b and plain
    sequential autodiff; the info reports the bubble fraction."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.parallel import make_mesh
    from paddle_tpu.parallel.pipeline import pipeline_1f1b

    W, B, xs = _1f1b_inputs()
    n, m = W.shape[0], xs.shape[0]
    w = world()
    w.submit("1f1b", dict(w=W, b=B, xs=xs, axes={"pp": n}))
    mesh = make_mesh({"pp": n, "dp": 2})

    def stage_fn(params, payload):
        w, b = params
        (x,) = payload
        return (jnp.tanh(x @ w + b),)

    def loss_fn(out):
        return jnp.mean(out ** 2)

    jl, jg, jinfo = jax.jit(lambda p, x: pipeline_1f1b(
        stage_fn, p, (x,), loss_fn, mesh, "pp"))((jnp.asarray(W),
                                                  jnp.asarray(B)),
                                                 jnp.asarray(xs))

    def ref_loss(params):
        w, b = params
        total = 0.0
        for j in range(m):
            y = jnp.asarray(xs[j])
            for s in range(n):
                y = jnp.tanh(y @ w[s] + b[s])
            total = total + loss_fn(y) / m
        return total

    rl, rg = jax.value_and_grad(ref_loss)((jnp.asarray(W), jnp.asarray(B)))
    res = w.collect("1f1b")
    for r in res:
        s = r["stage"]
        np.testing.assert_allclose(r["loss"], float(rl), rtol=1e-5)
        np.testing.assert_allclose(r["loss"], float(jl), rtol=1e-5)
        for got, j, ref in ((r["dW"], jg[0], rg[0]), (r["dB"], jg[1], rg[1])):
            np.testing.assert_allclose(got, np.asarray(ref)[s], rtol=1e-4,
                                       atol=1e-5)
            np.testing.assert_allclose(got, np.asarray(j)[s], rtol=1e-4,
                                       atol=1e-5)
        for k in ("ticks", "bubble_fraction", "max_inflight_microbatches"):
            assert r["info"][k] == jinfo[k]
        assert r["info"]["held_inputs"] <= 2 * n - 1 < m + 2 * n - 1


def _hetero_inputs():
    m, mb = 4, 2
    rng = np.random.RandomState(1)
    w0 = (rng.randn(8, 12) * 0.3).astype("float32")
    w1 = (rng.randn(12, 6) * 0.3).astype("float32")
    b1 = (rng.randn(6) * 0.1).astype("float32")
    xs = rng.randn(m, mb, 8).astype("float32")
    scale = (rng.rand(m, 1, 1) + 0.5).astype("float32")
    return w0, w1, b1, xs, scale


def test_pipeline_hetero_two_stages(world):
    """Two NON-isomorphic stages (different ops, params, and boundary
    shapes: d=8 -> 12 -> 6) over a pp=2 ring == the JAX package's and the
    sequential run; grads reach both stages' params."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.parallel import make_mesh
    from paddle_tpu.parallel.pipeline import pipeline_hetero

    w0, w1, b1, xs, scale = _hetero_inputs()
    m = xs.shape[0]
    w = world()
    w.submit("hetero", dict(w0=w0, w1=w1, b1=b1, xs=xs, scale=scale,
                            axes=PP2))
    mesh = make_mesh({"pp": 2, "dp": 4})

    def stage0(p, x, cap):
        (s,) = cap
        return jnp.tanh(x @ p) * s

    def stage1(p, x, cap):
        w, b = p
        return jax.nn.relu(x @ w + b) ** 2

    def run(params):
        out = pipeline_hetero([stage0, stage1], params, jnp.asarray(xs),
                              mesh, "pp", caps=((jnp.asarray(scale),), ()))
        return jnp.mean(out ** 2), out

    (jl, jout), jg = jax.jit(jax.value_and_grad(run, has_aux=True))(
        (jnp.asarray(w0), (jnp.asarray(w1), jnp.asarray(b1))))

    def ref(params):
        w0_, (w1_, b1_) = params
        ys = []
        for j in range(m):
            h = jnp.tanh(xs[j] @ w0_) * scale[j]
            ys.append(jax.nn.relu(h @ w1_ + b1_) ** 2)
        out = jnp.stack(ys)
        return jnp.mean(out ** 2), out

    (rl, rout), rg = jax.jit(jax.value_and_grad(ref, has_aux=True))(
        (jnp.asarray(w0), (jnp.asarray(w1), jnp.asarray(b1))))
    jleaves = jax.tree_util.tree_leaves(jg)
    rleaves = jax.tree_util.tree_leaves(rg)
    res = w.collect("hetero")
    for r in res:
        np.testing.assert_allclose(r["out"], np.asarray(jout), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(r["out"], np.asarray(rout), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(r["loss"], float(rl), rtol=1e-6)
        own = jleaves[:1] if r["stage"] == 0 else jleaves[1:]
        ownr = rleaves[:1] if r["stage"] == 0 else rleaves[1:]
        for g, j, ref_g in zip(r["grads"], own, ownr):
            np.testing.assert_allclose(g, np.asarray(j), rtol=1e-4,
                                       atol=1e-6)
            np.testing.assert_allclose(g, np.asarray(ref_g), rtol=1e-4,
                                       atol=1e-6)


def test_pipeline_optimizer_hetero_program(world):
    """PipelineOptimizer with NON-isomorphic stages (different widths, op
    sequences, and boundary shapes) lowers to the pipeline_hetero op and
    matches the non-pipelined program: the sequential path and the pp = 2
    ring, each against the JAX package's."""
    from paddle_tpu.core import unique_name as jn

    feed = PR.hetero_mlp_feed()
    state = PR.jax_state(jfluid, "hetero_mlp")
    w = world()
    w.submit("pipe", dict(model="hetero_mlp", feed=feed, axes=PP2,
                          state=state))
    jref = _jax("hetero_mlp", PR.hetero_mlp_feed, pp_cut=False)
    jseq = _jax("hetero_mlp", PR.hetero_mlp_feed)
    jpp = _jax("hetero_mlp", PR.hetero_mlp_feed, {"pp": 2, "dp": 4})
    np.testing.assert_allclose(jref, jseq, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(jref, jpp, rtol=1e-4, atol=1e-5)
    with jn.guard():
        jmain, _, _, _ = PR.build(jfluid, "hetero_mlp")
    seq = PR.case_pipe("hetero_mlp", feed, state=state)
    assert seq["types"] == [op.type for op in jmain.global_block().ops]
    assert "pipeline_hetero" in seq["types"]
    np.testing.assert_allclose(seq["losses"], jseq, rtol=1e-5, atol=1e-6)
    res = w.collect("pipe")
    for r in res:
        np.testing.assert_allclose(r["losses"], jpp, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(r["losses"], jref, rtol=1e-4, atol=1e-5)
    _replicated_bitwise(res)
    _stages_owned(res, _pp2_rank)


def test_pipeline_hetero_distinct_dropout_per_microbatch(world):
    """Every microbatch draws a fresh dropout mask: with one stage stream
    the mask would repeat across microbatches (identical rows for
    identical inputs)."""
    feed = {"x": np.ones((8, 64), "float32"),
            "label": np.zeros((8, 1), "int64")}
    res = world().run("pipe", dict(model="hetero_dropout", feed=feed,
                                   axes=PP2, steps=1, fetch_other=True))
    out = res[0]["fetched"][0]
    assert not np.array_equal(out[:4], out[4:]), \
        "masks repeat across microbatches"
    frac = (out == 0).mean()
    assert 0.3 < frac < 0.7, frac
    for r in res[1:]:
        assert np.array_equal(r["fetched"][0], out)


def test_pipeline_isomorphic_distinct_dropout_per_microbatch(world):
    """Isomorphic path: each (stage, microbatch) draws its own stream, so
    dropout masks differ across microbatches."""
    feed = {"x": np.ones((8, 64), "float32")}
    res = world().run("pipe", dict(model="iso_dropout", feed=feed,
                                   axes=PP2, steps=1, fetch_other=True))
    assert "pipeline" in res[0]["types"]
    out = res[0]["fetched"][0]
    assert not np.array_equal(out[:4], out[4:]), \
        "masks repeat across microbatches"
    frac = (out == 0).mean()
    assert 0.5 < frac < 0.9, frac  # two dropout layers compose


def test_pipeline_capture_spec_overrides_the_batch_rule(world):
    """A capture whose leading dim equals the batch is microbatched with
    the activations unless capture_spec names it "shared": a [4, 4]
    table at batch 4 then reaches every microbatch whole, and the pp = 2
    losses equal the JAX package's at the same mesh; by the shape rule it
    is cut and the stage's product fails."""
    feed = PR.shared_table_feed()
    jref = _jax("shared_table", PR.shared_table_feed)
    jpp = _jax("shared_table", PR.shared_table_feed, {"pp": 2, "dp": 4})
    np.testing.assert_allclose(jpp, jref, rtol=1e-5, atol=1e-6)
    state = PR.jax_state(jfluid, "shared_table")
    res = world().run("pipe", dict(model="shared_table", feed=feed,
                                   axes=PP2, state=state))
    for r in res:
        np.testing.assert_allclose(r["losses"], jpp, rtol=1e-5, atol=1e-6)
    with pytest.raises(RuntimeError, match="shared_table|matmul|shape|mat"):
        world().run("pipe", dict(model="shared_table", feed=feed, axes=PP2,
                                 model_kw={"spec": False}, steps=1))


# -- twins of tests/test_parallel.py's GPipe tests ---------------------------

def test_gpipe_matches_sequential(world):
    import jax
    import jax.numpy as jnp
    from paddle_tpu.parallel import GPipe as JGPipe
    from paddle_tpu.parallel import make_mesh

    n_stages, m, width = 4, 8, 16
    rng = np.random.RandomState(3)
    w = (rng.randn(n_stages, width, width) * 0.3).astype("float32")
    xs = rng.randn(m, 4, width).astype("float32")
    pw = world()
    pw.submit("gpipe", dict(w=w, xs=xs, axes={"pp": 4}))
    jout = jax.jit(JGPipe(lambda w_, x: jnp.tanh(x @ w_),
                          make_mesh({"pp": 4}), "pp"))(jnp.asarray(w),
                                                       jnp.asarray(xs))
    ref = jnp.asarray(xs)
    for i in range(n_stages):
        ref = jax.vmap(lambda x: jnp.tanh(x @ w[i]))(ref)
    res = pw.collect("gpipe")
    for r in res:
        np.testing.assert_allclose(r["out"], np.asarray(ref), rtol=2e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(r["out"], np.asarray(jout), rtol=2e-4,
                                   atol=1e-5)


def test_gpipe_differentiable(world):
    import jax
    import jax.numpy as jnp
    from paddle_tpu.parallel import GPipe as JGPipe
    from paddle_tpu.parallel import make_mesh

    rng = np.random.RandomState(4)
    w = (rng.randn(2, 8, 8) * 0.3).astype("float32")
    xs = rng.randn(4, 2, 8).astype("float32")
    pw = world()
    pw.submit("gpipe", dict(w=w, xs=xs, axes=PP2, grad=True))
    pipe = JGPipe(lambda w_, x: jnp.tanh(x @ w_), make_mesh({"pp": 2}), "pp")
    jg = jax.jit(jax.grad(lambda w_: jnp.sum(pipe(w_, jnp.asarray(xs))
                                             ** 2)))(jnp.asarray(w))

    def ref_loss(w_):
        out = jnp.asarray(xs)
        for i in range(2):
            out = jnp.tanh(out @ w_[i])
        return jnp.sum(out ** 2)

    rg = jax.jit(jax.grad(ref_loss))(jnp.asarray(w))
    res = pw.collect("gpipe")
    for r in res:
        s = r["stage"]
        np.testing.assert_allclose(r["grad"], np.asarray(rg)[s], rtol=1e-3,
                                   atol=1e-5)
        np.testing.assert_allclose(r["grad"], np.asarray(jg)[s], rtol=1e-3,
                                   atol=1e-5)


# -- the port's own checks ---------------------------------------------------

def test_pipeline_adam_matches_plain_run(world):
    """Adam on a pp = 2 program == the plain run of the same program: a
    rank runs no update of another stage's parameters (Adam's moments
    would move them with a zero gradient), and every stage value's whole
    value (each from its owner) equals the plain run's."""
    feed = PR.pipe_bert_feed()
    kw = {"opt": "adam", "lr": 0.01}
    state = PR.jax_state(jfluid, "pipe_bert", **kw)
    plain = PR.case_pipe("pipe_bert", feed, state=state, model_kw=kw,
                         logical=True)
    res = world().run("pipe", dict(model="pipe_bert", feed=feed, axes=PP2,
                                   state=state, model_kw=kw, logical=True))
    for r in res:
        np.testing.assert_allclose(r["losses"], plain["losses"], rtol=RTOL,
                                   atol=1e-6)
        for name, v in plain["state"].items():
            np.testing.assert_allclose(r["state"][name], v, rtol=1e-5,
                                       atol=1e-6, err_msg=name)
    _replicated_bitwise(res)
    _stages_owned(res, _pp2_rank)
    # a stage's rank holds its half of the stage bytes
    staged = res[0]["stages"]
    assert any("moment" in n for n in staged[0])
    assert 0 < res[0]["stages"][2] and 0 < res[1]["stages"][2]


def test_pipeline_checkpoint_restores_into_plain_executor(world, tmp_path):
    """A pp = 2 run writes each stage's state from its owner; the plain
    executor restores it and its next loss equals the pp run's next one.
    And back: a plain run's checkpoint restored onto pp = 2."""
    feed = PR.pipe_bert_feed()
    kw = {"opt": "adam", "lr": 0.01}
    state = PR.jax_state(jfluid, "pipe_bert", **kw)
    d1 = str(tmp_path / "pp")
    world().run("pipe", dict(model="pipe_bert", feed=feed, axes=PP2,
                             state=state, model_kw=kw, save=d1))
    after = world().run("pipe", dict(model="pipe_bert", feed=feed, axes=PP2,
                                     restore=d1, model_kw=kw, steps=1))
    plain = PR.case_pipe("pipe_bert", feed, restore=d1, model_kw=kw,
                         steps=1)
    assert plain["restored"] == 3
    np.testing.assert_allclose(plain["losses"], after[0]["losses"],
                               rtol=1e-6, atol=1e-7)
    full = PR.case_pipe("pipe_bert", feed, state=state, model_kw=kw,
                        steps=4)
    np.testing.assert_allclose(plain["losses"], full["losses"][3:],
                               rtol=1e-6, atol=1e-7)
    d2 = str(tmp_path / "plain")
    PR.case_pipe("pipe_bert", feed, state=state, model_kw=kw, save=d2)
    back = world().run("pipe", dict(model="pipe_bert", feed=feed, axes=PP2,
                                    restore=d2, model_kw=kw, steps=1))
    for r in back:
        np.testing.assert_allclose(r["losses"], full["losses"][3:],
                                   rtol=1e-6, atol=1e-7)


def test_pipeline_save_persistables_loads_into_plain_executor(world,
                                                             tmp_path):
    """After a pp = 2 run every rank's ``io.save_persistables`` writes the
    whole values, stage values included (each from its owner): the ranks'
    files are equal, and the plain executor that loads them runs the next
    step as the plain run's fourth."""
    import pickle

    feed = PR.pipe_bert_feed()
    kw = {"opt": "adam", "lr": 0.01}
    state = PR.jax_state(jfluid, "pipe_bert", **kw)
    d = tmp_path / "persist"
    res = world().run("pipe", dict(model="pipe_bert", feed=feed, axes=PP2,
                                   state=state, model_kw=kw, persist=str(d)))
    staged = res[0]["stages"][0]
    assert staged
    files = sorted(os.listdir(d / "rank0"))
    assert {n.replace("/", "_") for n in staged} <= set(files)
    for r in range(1, len(res)):
        assert sorted(os.listdir(d / f"rank{r}")) == files
        for f in files:
            a = pickle.loads((d / "rank0" / f).read_bytes())
            b = pickle.loads((d / f"rank{r}" / f).read_bytes())
            for name in a:
                np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    plain = PR.case_pipe("pipe_bert", feed, load=str(d / "rank1"),
                         model_kw=kw, steps=1)
    assert plain["missing"] == []
    full = PR.case_pipe("pipe_bert", feed, state=state, model_kw=kw,
                        steps=4)
    np.testing.assert_allclose(plain["losses"], full["losses"][3:],
                               rtol=1e-6, atol=1e-7)


def test_pipeline_refusals(world):
    """As the JAX package: a cut_list of fewer than three entries, a batch
    that num_microbatches does not divide, a hetero stage that changes
    the microbatch dim or the dtype, seq_axis equal to data_axis raise
    ValueError; a program whose stage count is not the pp axis size
    raises ValueError. An sp dim without seq_axis, an ep dim beside the
    data axis and two model axes that no spec names compute replicated:
    a step on each rank's rows has the plain run's loss."""
    import paddle_tpu_torch as tfluid

    for fluid in (jfluid, tfluid):
        with pytest.raises(ValueError, match="cut_list"):
            fluid.optimizer.PipelineOptimizer(fluid.optimizer.SGD(0.1),
                                              cut_list=[None, None])
    got = world().run("surface", dict(world_axes=PP2))[0]
    assert "not divisible by num_microbatches 3" in got["batch_micro"]
    assert got["stages_axis"].startswith("ValueError")
    assert "2 stages" in got["stages_axis"]
    assert got["seq_is_data"].startswith("ValueError")
    assert "seq_axis and data_axis" in got["seq_is_data"]
    for k in ("sp_without_seq", "ep_not_data", "two_model_axes"):
        assert isinstance(got[k], float), (k, got[k])
        np.testing.assert_allclose(got[k], got["plain"], rtol=1e-6,
                                   atol=1e-7)
    checks = world().run("hetero_checks", dict(axes=PP2))[0]
    assert "changed the microbatch dim" in checks["mb"]
    assert "payload dtype" in checks["dtype"]
