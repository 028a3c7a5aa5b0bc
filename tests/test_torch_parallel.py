"""The port's data and sequence parallelism against the JAX package, on the
CPU: the port on 4 gloo ranks (one world for this file,
``torch_dist_runner.World``), the JAX package in this process on 4 of the
conftest's 8 virtual devices with a mesh of the same shape.

Twins of tests/test_parallel.py's collective, data-parallel and sequence
tests (its tolerances: DP losses rtol 2e-4, atol 1e-5; ring and Ulysses
values rtol 2e-4, atol 2e-5; ring gradients rtol 1e-3, atol 1e-4; the
kernel route against the oracle rtol 1e-5 (values) and 1e-4 (gradients),
atol 1e-5; bf16 inputs rtol 0.1, atol 0.05), plus what the port adds:

- the per-block flash entries (``flash_block_fwd``/``flash_block_bwd``)
  against the JAX package's ``_flash_fwd_dispatch`` and
  ``_flash_bwd_block_dispatch`` (rtol 1e-5, atol 1e-5);
- a tiny conv + batch-norm net (plain BN, the fused-BN kernels' plain
  versions, the fused 1×1 conv + BN, accuracy) and a tiny BERT under dp=4
  against the JAX package at dp=4 and on one device: every reduction over
  the batch must be the global one. Losses and accuracies rtol 1e-5, atol
  1e-6; the BERT's updated parameters rtol 1e-4, atol 1e-6 (the ranks sum
  their parts in another order than one device sums the batch);
- dropout under a data axis: every rank draws its own masks;
- the mesh surface: with_mesh on a dp axis, run_batched with a mesh, the
  dims that compute replicated, the JAX package's own refusals, and the
  parallel module's DGC and local-SGD names;
- ops across the batch dim: a step on each rank's rows equals the plain
  run's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jfluid
import torch_dist_runner as R
from paddle_tpu.core import unique_name as jnames

torch.set_num_threads(1)

N = 4


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Worlds of the port's ranks by size, started on first use and again
    after a case failed (a failed case tears its world down)."""
    tmp = tmp_path_factory.mktemp("worlds")
    live = {}

    def get(n=N):
        w = live.get(n)
        if w is None or not w.alive:
            w = live[n] = R.World(n, tmp)
        return w

    def drop(n):
        w = live.pop(n, None)
        if w is not None:
            w.close()

    get.drop = drop
    yield get
    for w in live.values():
        w.close()


def _jmesh(axes):
    from paddle_tpu.parallel import make_mesh
    return make_mesh(axes)


def _per_rank(fn, n=N):
    return [fn(r) for r in range(n)]


def _losses(res):
    return [float(np.frombuffer(b, "float32")[0]) for b in res["losses"]]


# -- collectives ------------------------------------------------------------

def test_collectives_roundtrip(worlds):
    import jax.numpy as jnp
    from paddle_tpu.parallel import (all_gather, all_reduce, broadcast,
                                     reduce_scatter)

    mesh = _jmesh({"dp": N})
    x = np.arange(8, dtype="float32")
    j_ar = np.asarray(all_reduce(jnp.asarray(x), mesh, "dp", op="sum"))
    j_ag = np.asarray(all_gather(jnp.asarray(x), mesh, "dp"))
    j_bc = np.asarray(broadcast(jnp.asarray(x), mesh, "dp", root=2))
    j_rs = np.asarray(reduce_scatter(jnp.asarray(np.ones(8, "float32")),
                                     mesh, "dp"))
    out = worlds().run("collectives", dict(x=x))
    for r, o in enumerate(out):
        np.testing.assert_allclose(o["all_reduce"], j_ar.reshape(N, 2)[r])
        np.testing.assert_allclose(o["all_gather"], j_ag)
        np.testing.assert_allclose(o["broadcast"], j_bc)
        np.testing.assert_allclose(o["reduce_scatter"], j_rs)
        assert o["axis_index"] == r
        # ppermute i -> i+1: rank r holds rank r-1's x[:2] + (r-1)
        np.testing.assert_allclose(o["ppermute"], x[:2] + (r - 1) % N)
        np.testing.assert_allclose(o["psum"], np.full(2, sum(range(N))))
        # all_to_all: chunk j of every rank's [2N, 1] lands on rank j
        want = np.concatenate([np.arange(2 * r, 2 * r + 2) + 100 * s
                               for s in range(N)]).reshape(-1, 1)
        np.testing.assert_allclose(o["all_to_all"], want)


def test_auto_mesh_shapes(worlds):
    import jax
    from paddle_tpu.parallel import auto_mesh

    devs = jax.devices()[:N]
    want = [dict(auto_mesh(tp=2, devices=devs).shape),
            dict(auto_mesh(tp=2, pp=2, devices=devs).shape)]
    got = worlds().run("mesh_shapes")[0]
    assert got == want
    assert got[0]["tp"] == 2 and got[0]["dp"] == 2
    assert got[1]["dp"] == 1


# -- the data axis ----------------------------------------------------------

def _jax_run(build, feed, steps, data_parallel, fetch_names=None):
    """(state after startup, fetches a step) of the JAX package, on one
    device or over 4 devices."""
    import jax

    with jnames.guard():
        main, startup, *fetch = build(jfluid)
    fetch = fetch_names or fetch
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        state = {v.name: np.asarray(scope.find_var(v.name))
                 for v in main.list_vars() if v.persistable
                 and scope.find_var(v.name) is not None}
        prog = main
        if data_parallel:
            prog = jfluid.CompiledProgram(main).with_data_parallel(
                loss_name=fetch[0], places=jax.devices()[:N])
        outs = [[np.asarray(x) for x in exe.run(prog, feed=feed,
                                                 fetch_list=fetch)]
                for _ in range(steps)]
        final = {v.name: np.asarray(scope.find_var(v.name))
                 for v in main.list_vars() if v.persistable
                 and scope.find_var(v.name) is not None}
    return state, outs, final


def test_data_parallel_matches_single_device(worlds):
    rng = np.random.RandomState(0)
    feed = {"x": rng.rand(32, 16).astype("float32"),
            "y": rng.randint(0, 4, (32, 1)).astype("int64")}
    state, jouts, _ = _jax_run(R.build_ce_fc, feed, 4, False)
    single = [float(o[0]) for o in jouts]
    out = worlds().run("train", _per_rank(lambda r: dict(
        model="ce_fc", feed=R.rows(feed, r, N), state=state)))
    for res in out:
        np.testing.assert_allclose(_losses(res), single, rtol=2e-4,
                                   atol=1e-5)
    assert all(o["losses"] == out[0]["losses"] for o in out)


@pytest.mark.parametrize("bn_mode", ["xla1", "pallas"])
def test_conv_bn_under_dp4_matches_jax_dp4_and_one_device(worlds,
                                                          monkeypatch,
                                                          bn_mode):
    """Batch-norm statistics (plain, or K1/K3's and K4's plain versions),
    their backward sums and accuracy are the whole batch's on 4 ranks."""
    rng = np.random.RandomState(1)
    feed = {"img": rng.rand(16, 4, 8, 8).astype("float32"),
            "label": rng.randint(0, 3, (16, 1)).astype("int64")}
    monkeypatch.setenv("PDTPU_BN_MODE", "xla1")
    state, single, jfinal = _jax_run(R.build_conv_bn, feed, 3, False)
    _, dp4, _ = _jax_run(R.build_conv_bn, feed, 3, True)
    out = worlds().run("train", _per_rank(lambda r: dict(
        model="conv_bn", feed=R.rows(feed, r, N), state=state, steps=3,
        env={"PDTPU_BN_MODE": bn_mode})))
    for ref in (single, dp4):
        for step, (got, want) in enumerate(zip(out[0]["fetches"], ref)):
            np.testing.assert_allclose(got[0], want[0], rtol=1e-5,
                                       atol=1e-6, err_msg=f"loss {step}")
            np.testing.assert_allclose(got[1], want[1], rtol=1e-5,
                                       atol=1e-6, err_msg=f"acc {step}")
    # the parameters and the running statistics are the global batch's too
    stats = [n for n in jfinal if "gvar" in n]
    assert len(stats) == 4
    for name, want in jfinal.items():
        if "batch_norm" in name or "fused_conv_bn" in name:
            np.testing.assert_allclose(out[0]["state"][name], want,
                                       rtol=1e-4, atol=1e-6, err_msg=name)


def test_tiny_bert_under_dp4_matches_jax_dp4_and_one_device(worlds):
    from paddle_tpu.models import bert as jbert

    feed = R.bert_feed(8, 16)

    def build(fluid):
        return R.build_tiny_bert(fluid, jbert, 8, 16)

    state, single, jfinal = _jax_run(build, feed, 3, False)
    _, dp4, _ = _jax_run(build, feed, 3, True)
    out = worlds().run("train", _per_rank(lambda r: dict(
        model="tiny_bert", feed=R.rows(feed, r, N), state=state, steps=3)))
    for ref in (single, dp4):
        np.testing.assert_allclose(_losses(out[0]), [o[0] for o in ref],
                                   rtol=1e-5, atol=1e-6)
    for name, want in jfinal.items():
        if name in out[0]["state"] and want.dtype.kind == "f":
            np.testing.assert_allclose(out[0]["state"][name], want,
                                       rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_dropout_masks_differ_across_ranks(worlds, rate):
    """Every rank fed the same rows: at dropout 0 the ranks' attention
    outputs are equal, at 0.1 each rank's masks (Philox in the flash op,
    the generator in the dropout op) are its own."""
    feed = R.bert_feed(2, 16)
    out = worlds().run("dropout_masks", dict(feed=feed, rate=rate))[0]
    per = out.reshape(N, 2, *out.shape[1:])
    same = [np.array_equal(per[0], per[r]) for r in range(1, N)]
    assert same == ([True] * (N - 1) if rate == 0.0 else [False] * (N - 1))


def test_with_mesh_dp_axis_and_run_batched(worlds):
    """with_mesh(make_mesh({"dp": 4}), strategy) runs the same step as
    with_data_parallel; run_batched and train_scanned with a mesh are
    bitwise the plain runs."""
    feed = R.zero_mlp_feed()
    with jnames.guard():
        main, startup, loss = R.build_zero_mlp(jfluid)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
        state = {v.name: np.asarray(scope.find_var(v.name))
                 for v in main.list_vars() if v.persistable}
    w = worlds()
    dp = w.run("train", _per_rank(lambda r: dict(
        model="zero_mlp", feed=R.rows(feed, r, N), state=state, steps=3,
        stage=1)))
    for stage in (0, 1):
        got = w.run("with_mesh", _per_rank(lambda r: dict(
            feed=R.rows(feed, r, N), state=state, stage=stage)))
        assert got[0][0] == dp[0]["losses"]
        sharded = {n for n, i in got[0][1].items() if i[2] is not None}
        assert bool(sharded) == bool(stage)
    steps = [{"x": np.random.RandomState(s).rand(32, 16).astype("float32"),
              "y": np.random.RandomState(s + 9).rand(32, 1).astype("float32")}
             for s in range(3)]
    got = w.run("run_batched", _per_rank(lambda r: dict(
        feed_list=[R.rows(f, r, N) for f in steps], state=state, stage=2)))
    assert got[0][0] == got[0][1] == got[0][2]


def test_mesh_surface_raises_naming_the_item(worlds):
    """An sp dim without seq_axis, a pp dim without pipeline ops and an ep
    dim beside the data axis compute replicated: a step on each rank's
    rows has the plain run's loss. The JAX package's own refusals raise
    naming the item; ``parallel.top_k_sparsify`` equals the JAX
    package's, ties included."""
    got = worlds().run("surface")[0]
    for label in ("seq_axis", "pp", "ep"):
        assert isinstance(got[label], float), (label, got[label])
        np.testing.assert_allclose(got[label], got["plain"], rtol=1e-6,
                                   atol=1e-7)
    assert "RuntimeError" in got["places"] and "distributed.launch" in got[
        "places"]
    assert "gradient_merge_steps" in got["gm"]
    import jax.numpy as jnp

    from paddle_tpu.parallel import top_k_sparsify as jtop
    from paddle_tpu_torch import parallel

    assert callable(parallel.GPipe)
    # top-k with error feedback, ties at the k-th value to the lower index
    g = np.random.RandomState(4).randn(64).astype("float32")
    g[[3, 17, 40, 41, 50]] = 2.5
    sparse, resid = parallel.top_k_sparsify(torch.from_numpy(g), 0.0625)
    jsparse, jresid = jtop(jnp.asarray(g), 0.0625)
    np.testing.assert_array_equal(sparse.numpy(), np.asarray(jsparse))
    np.testing.assert_array_equal(resid.numpy(), np.asarray(jresid))
    assert callable(parallel.local_sgd_step)


def _zero_mlp_state():
    with jnames.guard():
        main, startup, _ = R.build_zero_mlp(jfluid)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
        return {v.name: np.asarray(scope.find_var(v.name))
                for v in main.list_vars() if v.persistable}


def test_ragged_feed_raises_on_every_rank(worlds):
    """Rank 1 feeds 6 of its 8 rows from the second step on (a ragged last
    batch): every rank raises ValueError at that step, before the step's
    first collective, so no collective is mis-paired and the same world
    then runs whole steps, equal on every rank."""
    feed, state = R.zero_mlp_feed(), _zero_mlp_state()
    w = worlds()
    got = w.run("ragged_feed", _per_rank(lambda r: dict(
        feed=R.rows(feed, r, N), state=state,
        short_rows=6 if r == 1 else None)))
    for losses, error in got:
        assert len(losses) == 1
        assert error is not None and error.startswith("ValueError")
        assert "same number of rows" in error and "[8, 8], [6, 6]" in error
    got = w.run("ragged_feed", _per_rank(lambda r: dict(
        feed=R.rows(feed, r, N), state=state)))
    assert all(g == (got[0][0], None) for g in got) and len(got[0][0]) == 3


@pytest.mark.parametrize("op", ["matmul_transpose_x", "softmax_axis0",
                                "transpose", "sequence_pool"])
def test_op_across_the_batch_dim_raises(worlds, op):
    """An op that works across the batch dim of a batch-sharded value (not
    declared row by row: ``dp`` in core/registry.py) no longer raises: the
    mesh step gathers its rows whole and runs it on the whole batch (rule
    A), and a LoD op works row by row with each rank's lengths; on every
    rank the loss equals the plain run's on the whole batch (rtol 1e-6).
    tests/test_torch_dp_across_batch.py holds each case to the JAX
    package."""
    got = worlds().run("across_batch", dict(op=op))
    for msg, loss, plain in got:
        assert msg is None, msg
        np.testing.assert_allclose(loss, plain, rtol=1e-6, atol=1e-7)


# -- the sequence axis ------------------------------------------------------

def _dense(q, k, v, causal):
    d, t = q.shape[-1], q.shape[2]
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(d)
    if causal:
        s = np.where(np.tril(np.ones((t, t), bool))[None, None], s, -1e9)
    e = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bhqk,bhkd->bhqd", e / e.sum(-1, keepdims=True), v)


def _seq(a, r, n=N):
    t = a.shape[2] // n
    return a[:, :, r * t:(r + 1) * t]


def _ring(worlds, q, k, v, causal, impl="plain", grads=False, n=N,
          world=N, **kw):
    out = worlds(world).run("ring", _per_rank(lambda r: dict(
        q=_seq(q, r % n, n), k=_seq(k, r % n, n), v=_seq(v, r % n, n),
        causal=causal, impl=impl, grads=grads, sp=n, **kw), world))[:n]
    return {key: np.concatenate([o[key] for o in out], axis=2)
            for key in out[0]}


def test_ring_attention_matches_dense(worlds):
    import jax.numpy as jnp
    from paddle_tpu.parallel import ring_self_attention

    mesh = _jmesh({"sp": N})
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(2, 2, 32, 8).astype("float32") for _ in range(3))
    for causal in (False, True):
        got = _ring(worlds, q, k, v, causal)["out"]
        np.testing.assert_allclose(got, _dense(q, k, v, causal), rtol=2e-4,
                                   atol=2e-5, err_msg=f"causal={causal}")
        jax_out = ring_self_attention(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), mesh, "sp",
                                      causal=causal)
        np.testing.assert_allclose(got, np.asarray(jax_out), rtol=2e-4,
                                   atol=2e-5)


def test_ring_attention_grads(worlds):
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(1)
    q, k, v = (rng.randn(1, 1, 16, 4).astype("float32") for _ in range(3))

    def dense_loss(q, k, v):
        s = jnp.einsum("bhqd,bhkd->bhqk", q, k) / 2.0
        s = jnp.where(jnp.tril(jnp.ones((16, 16), bool))[None, None], s,
                      -1e9)
        p = jax.nn.softmax(s, -1)
        return jnp.sum(jnp.einsum("bhqk,bhkd->bhqd", p, v) ** 2)

    want = jax.grad(dense_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = _ring(worlds, q, k, v, True, grads=True)
    for name, w in zip(("dq", "dk", "dv"), want):
        np.testing.assert_allclose(got[name], np.asarray(w), rtol=1e-3,
                                   atol=1e-4, err_msg=name)


def test_ulysses_attention_matches_dense(worlds):
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(1, 4, 16, 8).astype("float32") for _ in range(3))
    got = _ring(worlds, q, k, v, False, n=2, ulysses=True)["out"]
    np.testing.assert_allclose(got, _dense(q, k, v, False), rtol=2e-4,
                               atol=2e-5)


def _jax_normal(seed, shape):
    import jax
    import jax.numpy as jnp

    return [np.asarray(jax.random.normal(kk, shape, jnp.float32))
            for kk in jax.random.split(jax.random.PRNGKey(seed), 3)]


def test_pallas_ring_attention_matches_oracle(worlds):
    """The kernel route (flash per block, f32 lse merge, causal block
    skipping; the kernels' plain versions here) against the oracle, values
    and gradients, causal and dense: the JAX test's inputs on its sp=8
    mesh (8 ranks)."""
    q, k, v = _jax_normal(0, (2, 2, 8 * 64, 64))
    for causal in (False, True):
        ref = _ring(worlds, q, k, v, causal, impl="plain", grads=True, n=8,
                    world=8)
        ker = _ring(worlds, q, k, v, causal, impl="kernel", grads=True,
                    n=8, world=8)
        np.testing.assert_allclose(ker["out"], ref["out"], rtol=1e-5,
                                   atol=1e-5)
        for name in ("dq", "dk", "dv"):
            np.testing.assert_allclose(ker[name], ref[name], rtol=1e-4,
                                       atol=1e-5, err_msg=name)


def test_ring_attention_oracle_f32_accumulators_bf16_inputs(worlds):
    """bf16 inputs accumulate the softmax state in f32: the ring result
    stays close to the f32 dense reference (the JAX test's inputs, sp=8)."""
    import ml_dtypes

    q, k, v = _jax_normal(1, (1, 2, 8 * 16, 32))
    qb, kb, vb = (a.astype(ml_dtypes.bfloat16) for a in (q, k, v))
    got = _ring(worlds, qb, kb, vb, True, impl="plain", n=8,
                world=8)["out"]
    worlds.drop(8)
    np.testing.assert_allclose(got.astype(np.float32),
                               _dense(q, k, v, True), rtol=0.1, atol=0.05)


# -- the per-block flash entries (one process) ------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_flash_block_entries_match_jax_dispatch(causal):
    import importlib

    import jax.numpy as jnp

    from paddle_tpu_torch.ops.kernels import flash_attention as tfa

    jfa = importlib.import_module(
        "paddle_tpu.ops.pallas_kernels.flash_attention")

    rng = np.random.RandomState(5)
    b, h, t, d = 2, 3, 64, 32
    q, k, v, g = (rng.randn(b, h, t, d).astype("float32") for _ in range(4))
    scale = 1.0 / np.sqrt(d)
    fold = (lambda a: jnp.asarray(a.reshape(b * h, t, d)))
    jo, jl = jfa._flash_fwd_dispatch(fold(q), fold(k), fold(v), None, None,
                                     scale, causal, 0.0)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    to, tl = tfa.flash_block_fwd(tq, tk, tv, scale, causal)
    np.testing.assert_allclose(to.numpy().reshape(b * h, t, d),
                               np.asarray(jo), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tl.numpy().reshape(b * h, t),
                               np.asarray(jl).reshape(b * h, t), rtol=1e-5,
                               atol=1e-5)
    jd = jfa._flash_bwd_block_dispatch(fold(q), fold(k), fold(v), fold(g),
                                       jl, jo, scale, causal)
    td = tfa.flash_block_bwd(tq, tk, tv, tg, tl, to, scale, causal)
    for got, want in zip(td, jd):
        np.testing.assert_allclose(got.numpy().reshape(b * h, t, d),
                                   np.asarray(want), rtol=1e-5, atol=1e-5)
